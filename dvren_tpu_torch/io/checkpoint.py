"""Checkpoints of fields and of training state, in ``dvren_tpu``'s format.

Counterpart of ``dvren_tpu/io/checkpoint.py``: a plain ``.npz`` holding a
JSON header (format version, kind, static metadata, the caller's
``extra``) beside the arrays. A field file either package writes loads in
the other. The train-state pair (:func:`save_train_state`,
:func:`load_train_state`) keeps the JAX format's shape (``kind`` =
"train_state", a JSON header, ``leaf_i`` arrays) over a nested structure
of dicts, lists and tuples of tensors, such as ``{"params":
field.state_dict(), "optim": opt.state_dict()}``; its files do not cross
between the packages, since an optax state and a ``torch.optim`` state
share no structure.
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


def _flatten(x, leaves: list):
    """The structure of ``x`` as JSON-able data, its tensors and arrays
    appended to ``leaves`` in order. Dicts (keys int or str), lists and
    tuples nest; other values (numbers, bools, None, str: an optimizer's
    hyperparameters) are kept in the structure."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        leaves.append(x)
        return {"t": "tensor" if isinstance(x, torch.Tensor) else "array"}
    if isinstance(x, dict):
        for k in x:
            if not isinstance(k, (int, str)) or isinstance(k, bool):
                raise DvrenError.invalid_argument(
                    f"train_state dict keys must be int or str, got {k!r}")
        return {"t": "dict", "items": [[k, _flatten(v, leaves)]
                                       for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {"t": type(x).__name__,
                "items": [_flatten(v, leaves) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"t": "value", "v": x}
    raise DvrenError.invalid_argument(
        f"train_state cannot hold a {type(x).__name__}")


def _count(desc) -> int:
    if desc["t"] in ("tensor", "array"):
        return 1
    if desc["t"] == "dict":
        return sum(_count(v) for _, v in desc["items"])
    if desc["t"] in ("list", "tuple"):
        return sum(_count(v) for v in desc["items"])
    return 0


def _align(saved, like, out: list) -> bool:
    """Walk the saved structure beside ``like``'s, appending per saved
    leaf True where a ``like`` leaf receives it, False where an empty
    container of ``like`` takes the saved subtree as it is. False on a
    mismatch of kinds, dict keys or lengths."""
    kind = saved["t"]
    if like["t"] != kind and not (kind in ("tensor", "array")
                                  and like["t"] in ("tensor", "array")):
        return False
    if kind in ("dict", "list", "tuple"):
        if not like["items"] and saved["items"]:
            out.extend([False] * _count(saved))
            return True
        if len(saved["items"]) != len(like["items"]):
            return False
        if kind == "dict":
            pairs = zip(saved["items"], like["items"])
            if any(a[0] != b[0] for a, b in pairs):
                return False
            return all(_align(a[1], b[1], out)
                       for a, b in zip(saved["items"], like["items"]))
        return all(_align(a, b, out)
                   for a, b in zip(saved["items"], like["items"]))
    if kind in ("tensor", "array"):
        out.append(True)
    return True


def _unflatten(desc, leaves):
    kind = desc["t"]
    if kind in ("tensor", "array"):
        return next(leaves)
    if kind == "value":
        return desc["v"]
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in desc["items"]}
    items = [_unflatten(v, leaves) for v in desc["items"]]
    return tuple(items) if kind == "tuple" else items


def save_train_state(path: str | os.PathLike, state, header: dict) -> None:
    """Save a training state for resume: ``state`` a nested structure of
    dicts, lists and tuples whose leaves are tensors (kept as arrays) or
    plain values (kept in the header), with the caller's ``header``."""
    leaves: list = []
    treedef = _flatten(state, leaves)
    meta = dict(format=_FORMAT_VERSION, kind="train_state",
                treedef=json.dumps(treedef), header=header)
    np.savez(path, header=json.dumps(meta),
             **{f"leaf_{i}": (_host(x) if isinstance(x, torch.Tensor)
                              else np.asarray(x))
                for i, x in enumerate(leaves)})


def load_train_state(path: str | os.PathLike, like):
    """Restore a :func:`save_train_state` file into the structure of
    ``like``: (state, the saved header). The structure (container kinds,
    dict keys and order, lengths), the leaf count and every leaf's shape
    are checked against ``like`` before anything is assigned
    (``DvrenError`` otherwise); each restored tensor lands on the device
    and in the dtype of its ``like`` leaf, and the plain values are the
    saved ones. An empty dict or list in ``like`` takes the saved subtree
    as it is, its tensors on the CPU in their saved dtype: the state of a
    fresh ``torch.optim`` optimizer, which appears at its first step
    (``Optimizer.load_state_dict`` moves it to the parameters' device).
    A file of ``dvren_tpu``'s ``save_train_state`` (an optax state) does
    not load here."""
    with np.load(path, allow_pickle=False) as data:
        meta = _header(data, "train_state")
        like_leaves: list = []
        like_def = json.loads(json.dumps(_flatten(like, like_leaves)))
        try:
            saved_def = json.loads(meta.get("treedef", ""))
        except (TypeError, ValueError):
            saved_def = None
        targets: list = []
        if not isinstance(saved_def, dict) or not _align(saved_def, like_def,
                                                         targets):
            raise DvrenError.invalid_argument(
                "train_state structure mismatch: the checkpoint was saved "
                f"from {meta.get('treedef')}, the restore target is "
                f"{json.dumps(like_def)}")
        saved_n = sum(1 for k in data.files if k.startswith("leaf_"))
        if saved_n != len(targets):
            raise DvrenError.invalid_argument(
                f"train_state leaf count mismatch: {saved_n} saved vs "
                f"{len(targets)} in its structure")
        saved = [data[f"leaf_{i}"] for i in range(saved_n)]
        refs = iter(like_leaves)
        pairs = [(a, next(refs) if hit else None)
                 for a, hit in zip(saved, targets)]
        for i, (a, ref) in enumerate(pairs):
            if ref is not None and tuple(a.shape) != tuple(ref.shape):
                raise DvrenError.invalid_argument(
                    f"train_state leaf {i} shape mismatch: "
                    f"{tuple(a.shape)} saved vs {tuple(ref.shape)} expected")
        restored = []
        for a, ref in pairs:
            if isinstance(ref, torch.Tensor):
                restored.append(torch.from_numpy(np.array(a)).to(
                    device=ref.device, dtype=ref.dtype))
            elif ref is None:
                restored.append(torch.from_numpy(np.array(a)))
            else:
                restored.append(np.array(a, ref.dtype))
        return _unflatten(saved_def, iter(restored)), meta["header"]
