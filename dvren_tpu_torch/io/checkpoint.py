"""Checkpoints of fields, in ``dvren_tpu``'s format.

Counterpart of ``dvren_tpu/io/checkpoint.py``: a plain ``.npz`` holding a
JSON header (format version, kind, static metadata, the caller's
``extra``) beside the arrays, so a file either package writes loads in
the other. The JAX package's train-state pair serialises a JAX pytree
(optimizer state and params by tree structure); it waits for the port's
own resume format (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.plan import InterpMode, OobPolicy
from dvren_tpu_torch.core.status import DvrenError
from dvren_tpu_torch.fields.dense_grid import DenseGridField
from dvren_tpu_torch.fields.hash_mlp import HashMLPField
from dvren_tpu_torch.ops.hashmlp import HashMLPSpec

_FORMAT_VERSION = 1


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _header(data, kind: str) -> dict:
    header = json.loads(str(data["header"]))
    if header.get("kind") != kind:
        raise DvrenError.invalid_argument(
            f"checkpoint kind mismatch: {header.get('kind')}")
    return header


def save_dense_grid(path: str | os.PathLike, field: DenseGridField,
                    extra: dict | None = None) -> None:
    header = dict(
        format=_FORMAT_VERSION, kind="dense_grid",
        bbox_min=list(field.bbox_min), bbox_max=list(field.bbox_max),
        interp=int(field.interp), oob=int(field.oob),
        extra=extra or {},
    )
    np.savez(path, header=json.dumps(header), sigma=_host(field.sigma),
             color=_host(field.color))


def load_dense_grid(path: str | os.PathLike,
                    device=None) -> tuple[DenseGridField, dict]:
    """(field on ``device``, the header's ``extra``); the device defaults
    to CUDA, as the field constructors do."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        header = _header(data, "dense_grid")
        field = DenseGridField(
            torch.from_numpy(np.array(data["sigma"], np.float32)).to(device),
            torch.from_numpy(np.array(data["color"], np.float32)).to(device),
            bbox_min=tuple(header["bbox_min"]),
            bbox_max=tuple(header["bbox_max"]),
            interp=InterpMode(header["interp"]),
            oob=OobPolicy(header["oob"]))
        return field, header.get("extra", {})


def save_hash_mlp(path: str | os.PathLike, field: HashMLPField,
                  extra: dict | None = None) -> None:
    """The JAX format's spec keys; like it, the file does not keep
    ``spec.resolutions``."""
    spec = field.spec
    header = dict(
        format=_FORMAT_VERSION, kind="hash_mlp",
        spec=dict(n_levels=spec.n_levels,
                  features_per_level=spec.features_per_level,
                  table_size=spec.table_size, hidden_dim=spec.hidden_dim,
                  base_resolution=spec.base_resolution,
                  finest_resolution=spec.finest_resolution),
        extra=extra or {},
    )
    arrays = {k: _host(v) for k, v in field.params.items()}
    np.savez(path, header=json.dumps(header), **arrays)


def load_hash_mlp(path: str | os.PathLike,
                  device=None) -> tuple[HashMLPField, dict]:
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        header = _header(data, "hash_mlp")
        spec = HashMLPSpec(**header["spec"])
        params = {k: torch.from_numpy(np.array(data[k], np.float32)).to(device)
                  for k in data.files if k != "header"}
        return HashMLPField(params, spec), header.get("extra", {})
