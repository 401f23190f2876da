"""Hash-MLP field: Instant-NGP-style encoding and two tiny MLP heads.

Counterpart of ``dvren_tpu/fields/hash_mlp.py`` (the original's
``hp_field_create_hash_mlp``). The field is an ``nn.Module`` whose
parameters are an ``nn.ParameterDict`` under the JAX package's keys
(``hash_table`` (L, T, F), ``sigma_w1``, ``sigma_b1``, ``sigma_w2``,
``sigma_b2``, ``color_w1``, ``color_b1``, ``color_w2``, ``color_b2``), so
``field.parameters()`` is what an optimizer trains. The per-ray paths
(``pipeline.render``, the Renderer's streamed and fused modes) evaluate it
at sample planes (:meth:`HashMLPField.packed_eval_planes`). The
constructors put the parameters on CUDA unless the caller names a device
(``device="cpu"`` on the CPU), as :class:`~dvren_tpu_torch.Context` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch
from torch import nn

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops import hashmlp as ops
from dvren_tpu_torch.ops.hashmlp import PARAM_KEYS, HashMLPSpec


@dataclass(frozen=True)
class HashMLPConfig:
    """Construction config; the defaults are the original's hardcoded
    hyperparameters (hash_mlp_cpu.cpp:170-177)."""

    spec: HashMLPSpec = dc_field(default_factory=HashMLPSpec)
    params: np.ndarray | list[float] | None = None  # flat blob, optional


class HashMLPField(nn.Module):
    """params: ``nn.ParameterDict`` with the keys of
    :func:`dvren_tpu_torch.ops.hashmlp.unpack_params`."""

    def __init__(self, params: dict, spec: HashMLPSpec | None = None):
        super().__init__()
        self.spec = spec or HashMLPSpec()
        check(set(params) == set(PARAM_KEYS),
              f"hash-mlp params need the keys {sorted(PARAM_KEYS)}")
        devices = {p.device for p in params.values()}
        check(len(devices) == 1, "hash-mlp params must be on one device")
        self.params = nn.ParameterDict({
            k: v if isinstance(v, nn.Parameter) else nn.Parameter(
                v.to(torch.float32))
            for k, v in params.items()})

    @staticmethod
    def create(config: HashMLPConfig, device=None) -> "HashMLPField":
        """From the original's flat float32 blob (all zeros when None)."""
        spec = config.spec
        if config.params is None:
            flat = np.zeros((spec.param_count,), np.float32)
        else:
            flat = np.asarray(config.params, np.float32).reshape(-1)
        check(flat.size == spec.param_count,
              f"hash-mlp params must have {spec.param_count} elements, "
              f"got {flat.size}")
        params = ops.unpack_params(flat, spec)
        device = resolve_device(device)
        return HashMLPField({k: v.clone().to(device)
                             for k, v in params.items()}, spec)

    @staticmethod
    def init_random(generator: torch.Generator,
                    spec: HashMLPSpec | None = None,
                    table_std: float = 1e-2, device=None) -> "HashMLPField":
        """He-style initialisation for training from scratch, drawn on the
        CPU from ``generator`` (the values differ from the JAX package's
        for the same seed)."""
        spec = spec or HashMLPSpec()
        enc, hid = spec.encoding_dim, spec.hidden_dim

        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32)

        params = dict(
            hash_table=normal(spec.n_levels, spec.table_size,
                              spec.features_per_level) * table_std,
            sigma_w1=normal(hid, enc) * math.sqrt(2.0 / enc),
            sigma_w2=normal(hid) * math.sqrt(2.0 / hid),
            sigma_b1=torch.zeros(hid), sigma_b2=torch.zeros(()),
            color_w1=normal(hid, enc) * math.sqrt(2.0 / enc),
            color_w2=normal(3, hid) * math.sqrt(2.0 / hid),
            color_b1=torch.zeros(hid), color_b2=torch.zeros(3))
        device = resolve_device(device)
        return HashMLPField({k: v.to(device) for k, v in params.items()},
                            spec)

    @staticmethod
    def from_reference_params(params: dict, spec: HashMLPSpec,
                              device=None) -> "HashMLPField":
        """A field from the JAX field's parameters carried across as numpy
        arrays (``{key: np.asarray(jax_field.params[key])}``)."""
        device = resolve_device(device)
        return HashMLPField(
            {k: torch.from_numpy(np.array(v, np.float32)).to(device)
             for k, v in params.items()}, spec)

    @property
    def device(self) -> torch.device:
        return self.params["hash_table"].device

    def flat_params(self) -> torch.Tensor:
        """The original's flat blob (parity view)."""
        return ops.pack_params(dict(self.params), self.spec)

    def with_params(self, params: dict) -> "HashMLPField":
        """A field of the same spec over ``params``; tensors that are
        ``nn.Parameter`` are shared, others become new parameters."""
        return HashMLPField(dict(params), self.spec)

    def sigma_at(self, positions: torch.Tensor) -> torch.Tensor:
        return ops.eval_sigma(positions, dict(self.params), self.spec)

    def color_at(self, positions: torch.Tensor) -> torch.Tensor:
        return ops.eval_color(positions, dict(self.params), self.spec)

    def sigma_at_planes(self, px, py, pz) -> torch.Tensor:
        """Density plane at coordinate planes; differentiable."""
        return ops.eval_planes(px, py, pz, dict(self.params), self.spec)[0]

    def color_at_planes(self, px, py, pz) -> tuple:
        """(r, g, b) planes at coordinate planes; differentiable."""
        return ops.eval_planes(px, py, pz, dict(self.params), self.spec)[1:]

    @property
    def supports_packed_eval(self) -> bool:
        """Sigma and colour in one pass (one shared hash encoding)."""
        return True

    def packed_eval_planes(self, px, py, pz) -> tuple:
        """(sigma, r, g, b) planes, the encoding computed once."""
        return ops.eval_planes(px, py, pz, dict(self.params), self.spec)
