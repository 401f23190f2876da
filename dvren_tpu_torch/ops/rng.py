"""Stratified jitter: exact splitmix64 on the host table and on the device.

Counterpart of ``dvren_tpu/ops/rng.py``. The reference derives its
stratified sampling jitter from a splitmix64 mix of ``(seed, ray_index,
step)`` (``hotpath/src/cpu/samp_cpu.cpp:21-35``). Two forms:

- :func:`jitter_table`: the (N, K) table in numpy with true uint64
  arithmetic, which the host schedule builders read (and the pure-Python
  oracles :func:`mix_seed_py`, :func:`stratified_jitter_py`);
- :func:`stratified_jitter`: the same values for any (ray, step) tensors,
  computed where the tensors live. On CUDA tensors it launches
  ``csrc/jitter.cu`` (native 64-bit integers); on CPU tensors its plain
  twin :func:`stratified_jitter_plain` runs the hash in int64 torch ops.
  Both equal the table bit for bit; the JAX package's uint32-pair
  emulation (TPUs have no uint64) is within one float32 ulp of them.
"""

from __future__ import annotations

import numpy as np
import torch

from dvren_tpu_torch import _build

_MASK64 = 0xFFFFFFFFFFFFFFFF
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_FRAC_BITS = 0x000FFFFFFFFFFFFF


def jitter_table(seed: int, n_rays: int, n_steps: int,
                 ray_offset: int = 0) -> np.ndarray:
    """(N, K) float32 jitter in [0, 1): exact splitmix64 of
    ``seed ^ (ray << 32) ^ step``, top 52 bits scaled by 2^-52."""
    rays = (np.arange(n_rays, dtype=np.uint64)
            + np.uint64(ray_offset))[:, None]
    steps = np.arange(n_steps, dtype=np.uint64)[None, :]
    s = np.uint64(seed & _MASK64) ^ (rays << np.uint64(32)) ^ steps
    with np.errstate(over="ignore"):
        s = (s ^ (s >> np.uint64(30))) * np.uint64(_M1)
        s = (s ^ (s >> np.uint64(27))) * np.uint64(_M2)
        s = s ^ (s >> np.uint64(31))
    frac = (s & np.uint64(_FRAC_BITS)).astype(np.float64)
    return (frac / float(0x0010000000000000)).astype(np.float32)


def mix_seed_py(state: int) -> int:
    """Pure-Python splitmix64 finalizer (test oracle)."""
    state &= _MASK64
    state = ((state ^ (state >> 30)) * _M1) & _MASK64
    state = ((state ^ (state >> 27)) * _M2) & _MASK64
    state = state ^ (state >> 31)
    return state


def stratified_jitter_py(seed: int, ray_index: int, step: int) -> float:
    """Pure-Python jitter oracle, matching samp_cpu.cpp:28-35 in float64."""
    s = seed & _MASK64
    s ^= (ray_index << 32) & _MASK64
    s ^= step & _MASK64
    s = mix_seed_py(s)
    return float((s & _FRAC_BITS) / float(0x0010000000000000))


def _signed(v: int) -> int:
    """A uint64 constant as the int64 with its bits."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits: the arithmetic shift, masked."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix_seed(state: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer (samp_cpu.cpp:21-26) of int64 tensors
    holding uint64 bits; products wrap modulo 2^64."""
    s = state.to(torch.int64)
    s = (s ^ _shr(s, 30)) * _signed(_M1)
    s = (s ^ _shr(s, 27)) * _signed(_M2)
    return s ^ _shr(s, 31)


def _clamped(x: torch.Tensor, hi: int | None) -> torch.Tensor:
    return x if hi is None else torch.clamp(x, 0, hi)


def _bounds(bounds):
    """(ray_max, step_max) from (n_rays, n_steps), or (None, None)."""
    if bounds is None:
        return None, None
    n_rays, n_steps = (int(v) for v in bounds)
    return n_rays - 1, n_steps - 1


def stratified_jitter_plain(seed: int, ray_index, step,
                            bounds: tuple | None = None) -> torch.Tensor:
    """Plain twin of the jitter kernel: float32 jitter in [0, 1) of
    broadcastable integer tensors, on their device."""
    ray_max, step_max = _bounds(bounds)
    ray = _clamped(torch.as_tensor(ray_index).to(torch.int64), ray_max)
    st = _clamped(torch.as_tensor(step).to(torch.int64), step_max)
    s = (_signed(seed) ^ ((ray & 0xFFFFFFFF) << 32)) ^ (st & 0xFFFFFFFF)
    frac = (mix_seed(s) & _FRAC_BITS).to(torch.float64)
    return (frac * 2.0 ** -52).to(torch.float32)


def _as_2d(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` broadcast to ``shape`` and viewed as (rows, cols); expanded
    axes keep stride 0 where the shape is already 2-D."""
    x = x.expand(shape)
    if len(shape) == 2:
        return x
    cols = shape[-1] if shape else 1
    return x.reshape(-1, cols)


def stratified_jitter(seed: int, ray_index, step,
                      bounds: tuple | None = None) -> torch.Tensor:
    """Jitter in [0, 1) for (seed, ray, step), ``samp_cpu.cpp:28-35``:
    splitmix64 of ``seed ^ (ray << 32) ^ step`` (each index as uint32, as
    JAX keys it), its low 52 bits over 2^52, rounded to float32.

    ``ray_index`` and ``step`` are broadcastable integer tensors on one
    device. ``bounds=(n_rays, n_steps)`` clamps them into [0, n_rays) and
    [0, n_steps) first, the rows and columns of the plan's host table,
    so the values equal ``jitter_table(seed, n_rays, n_steps)[ray,
    step]`` bit for bit. On CUDA tensors the kernel (``csrc/jitter.cu``)
    writes the result; on CPU tensors :func:`stratified_jitter_plain`."""
    ray = torch.as_tensor(ray_index)
    st = torch.as_tensor(step, device=ray.device)
    if ray.device.type == "cpu":
        return stratified_jitter_plain(seed, ray, st, bounds)
    if ray.device.type != "cuda":
        raise ValueError(f"unsupported device {ray.device}")
    if ray.is_floating_point() or st.is_floating_point():
        raise TypeError("stratified_jitter takes integer indices")
    shape = torch.broadcast_shapes(ray.shape, st.shape)
    ray2 = _as_2d(ray.to(torch.int64), shape)
    st2 = _as_2d(st.to(torch.int32), shape)
    rows, cols = (int(v) for v in ray2.shape)
    out = torch.empty((rows, cols), dtype=torch.float32, device=ray.device)
    ray_max, step_max = _bounds(bounds)
    dev = ray.device
    with torch.cuda.device(dev):
        code = _build.library().dvt_stratified_jitter(
            ray2.data_ptr(), ray2.stride(0), ray2.stride(1),
            st2.data_ptr(), st2.stride(0), st2.stride(1), out.data_ptr(),
            rows, cols, -1 if ray_max is None else ray_max,
            -1 if step_max is None else step_max, int(seed) & _MASK64,
            _build.stream_ptr(dev))
    _build.check(code, "dvt_stratified_jitter")
    stratified_jitter.launches += 1
    return out.reshape(shape)


stratified_jitter.launches = 0
