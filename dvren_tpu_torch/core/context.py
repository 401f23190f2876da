"""Execution context: the torch device the renderer runs on.

Counterpart of ``dvren_tpu/core/context.py``. The JAX context pins a JAX
device set; here the context carries one explicit ``torch.device``, and
every tensor the renderer makes lives there. The device is CUDA unless
the caller names another: asking for CUDA, or naming no device, where torch
has no CUDA raises. The port never substitutes the CPU for the card; the
CPU is used only when the caller asks for ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dvren_tpu_torch.core.status import DvrenError
from dvren_tpu_torch.version import VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH


@dataclass(frozen=True)
class ContextOptions:
    """Mirrors ``hp_ctx_desc`` (hp.h:87-91).

    ``preferred_device``: a torch device string ("cuda", "cuda:1", "cpu"),
    or empty for "cuda"."""

    flags: int = 0
    preferred_device: str = ""


def resolve_device(name=None) -> torch.device:
    """The torch device for ``name`` (a device or its string): CUDA when
    ``name`` is None or empty, and a :class:`DvrenError` when CUDA is
    asked for and torch has none (name ``"cpu"`` to run on the CPU).
    Shared by :class:`Context` and the field constructors."""
    name = str(name) if name else "cuda"
    try:
        device = torch.device(name)
    except RuntimeError as exc:
        raise DvrenError.unsupported(
            f"unknown device '{name}': {exc}") from exc
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise DvrenError.unsupported(
                f"device '{name}' was asked for but torch has no CUDA "
                f"(name device='cpu' to run on the CPU)")
        index = device.index if device.index is not None else 0
        if index >= torch.cuda.device_count():
            raise DvrenError.unsupported(
                f"device '{name}' does not exist "
                f"({torch.cuda.device_count()} CUDA devices)")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise DvrenError.unsupported(
            f"device type '{device.type}' is not supported")
    return device


class Context:
    """Immutable owner of runtime facts: the device and the version."""

    def __init__(self, options: ContextOptions | None = None):
        self._options = options or ContextOptions()
        self._device = resolve_device(self._options.preferred_device)

    @staticmethod
    def create(options: ContextOptions | None = None,
               device: str | None = None) -> "Context":
        """``device`` is shorthand for ``ContextOptions(preferred_device=)``."""
        if device is not None:
            options = ContextOptions(
                flags=options.flags if options else 0,
                preferred_device=str(device))
        return Context(options)

    @property
    def options(self) -> ContextOptions:
        return self._options

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def platform(self) -> str:
        """"cuda" or "cpu"."""
        return self._device.type

    @property
    def version(self) -> tuple[int, int, int]:
        return (VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH)
