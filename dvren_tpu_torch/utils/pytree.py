"""Nested containers of tensors: map a function over them, move them.

Counterpart of ``dvren_tpu/utils/pytree.py``. JAX registers dataclasses
as pytrees (``pytree_dataclass``) so that its transforms see through
them; torch has no such registry, so the port walks the containers
itself: dataclasses, named tuples, tuples, lists and dicts, down to the
leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _map(tree, is_leaf, fn):
    """``tree`` with every leaf replaced by ``fn(leaf)``; a leaf met twice
    (one object under two names) maps once, so the result shares it as
    the input did."""
    seen: dict[int, object] = {}

    def walk(x):
        if is_leaf(x):
            if id(x) not in seen:
                seen[id(x)] = fn(x)
            return seen[id(x)]
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: walk(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree)


def tree_map(fn, tree):
    """``tree`` with every tensor ``t`` replaced by ``fn(t)``; anything
    that is not a container or a tensor is kept as it is."""
    return _map(tree, lambda x: isinstance(x, torch.Tensor), fn)


def device_put_tree(tree, device):
    """``tree`` with every tensor and numpy array moved to ``device`` (a
    torch device or its name). Leaves that are one object stay one tensor
    on the device, as the JAX package's batched ``device_put`` keeps them
    aliased (a tile group's hostmap and gathermap at pitch 1)."""
    device = torch.device(device)

    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    return _map(tree, lambda x: isinstance(x, (torch.Tensor, np.ndarray)),
                move)
