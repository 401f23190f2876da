"""Stratified-jitter table: exact splitmix64 on the host.

Counterpart of the host half of ``dvren_tpu/ops/rng.py``
(``jitter_table``, ``mix_seed_py``). The reference derives its stratified
sampling jitter from a splitmix64 mix of ``(seed, ray_index, step)``
(``hotpath/src/cpu/samp_cpu.cpp:21-35``). The table is a pure function of
the plan, so it is built once in numpy with true uint64 arithmetic and
handed to the schedule builder. The JAX package's u32-pair emulation of
the same hash exists only because JAX on TPU has no uint64; the port has
no use for it.
"""

from __future__ import annotations

import numpy as np


def jitter_table(seed: int, n_rays: int, n_steps: int,
                 ray_offset: int = 0) -> np.ndarray:
    """(N, K) float32 jitter in [0, 1): exact splitmix64 of
    ``seed ^ (ray << 32) ^ step``, top 52 bits scaled by 2^-52."""
    rays = (np.arange(n_rays, dtype=np.uint64)
            + np.uint64(ray_offset))[:, None]
    steps = np.arange(n_steps, dtype=np.uint64)[None, :]
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF) ^ (rays << np.uint64(32)) ^ steps
    with np.errstate(over="ignore"):
        s = (s ^ (s >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        s = (s ^ (s >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        s = s ^ (s >> np.uint64(31))
    frac = (s & np.uint64(0x000FFFFFFFFFFFFF)).astype(np.float64)
    return (frac / float(0x0010000000000000)).astype(np.float32)


def mix_seed_py(state: int) -> int:
    """Pure-Python splitmix64 finalizer (test oracle)."""
    mask = 0xFFFFFFFFFFFFFFFF
    state &= mask
    state = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & mask
    state = ((state ^ (state >> 27)) * 0x94D049BB133111EB) & mask
    state = state ^ (state >> 31)
    return state
