"""The per-ray integrator of the port: K9f / K9b and their autograd node.

Counterpart of ``dvren_tpu/ops/integrate_pallas.py``: radiance,
transmittance, opacity and depth of (N, K) planes of sigma, colour and
dt, with a recompute backward for the radiance head. The TPU kernels take
the prefix sums as triangular matmuls on the MXU; on the card the kernels
(``csrc/integrate.cu``, ``csrc/integrate_bwd.cu``) give each ray a warp
that holds its row in registers (lane j: steps j, j + 32, ...; up to
:data:`REGISTER_CHUNKS` chunks of 32, every load issued before the first
scan), take 32-wide warp scans chunk by chunk, and stop once the
transmittance is spent; a longer row is walked in groups of that many
chunks (:func:`launch_geometry`). K9b reads each input and writes each
output once per step of a row of up to 128 steps.

:func:`integrate_fused` is the port's per-ray integrator: every group of
the windowed path and of the tiled schedule's windowed fallback goes
through it. Its forward launches K9f on CUDA tensors and runs the plain
twin (:func:`dvren_tpu_torch.ops.integrate.integrate`) on CPU tensors; its
backward launches K9b (plain twin :func:`radiance_vjp_plain`) for the
radiance head, and pulls the transmittance, opacity and depth heads back
through the twin's autograd only when their gradients are not None.

Conventions (where the kernels and ``integrate_pallas`` differ):
- the weight uses ``integrate``'s T_before = P_{k-1}, not
  ``exp(od - S_k)``;
- d max(sigma*dt, 0) is 0.5 at sigma*dt == 0, as JAX's autodiff of
  ``integrate`` and the port's K2 take it (``integrate_pallas`` takes 1);
- ``t_origin`` (N,) is where each ray's depth cursor starts; when it is
  None the origin is t_near, as in ``integrate_pallas``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.ops.integrate import (OPACITY_EPS, SCAN_WIDTH,
                                           STOP_THRESHOLD, integrate,
                                           processed_steps, scan_prefix)
from dvren_tpu_torch.utils import trace

WARPS_PER_BLOCK = 4   # rays a block: one warp each (csrc/integrate.cuh)
REGISTER_CHUNKS = 4   # 32-step chunks a ray's warp holds in registers


def launch_geometry(n: int, k: int) -> tuple[int, int]:
    """(chunks, blocks) of a K9f / K9b launch over (n, k) planes.

    Each ray's warp holds ``chunks`` 32-step chunks of its row in
    registers (lane j: steps j, j + 32, ...), the fewest that cover the
    row up to :data:`REGISTER_CHUNKS`; a longer row is walked in groups of
    that many chunks. ``blocks`` of :data:`WARPS_PER_BLOCK` rays cover the
    ``n`` rays."""
    chunks = min(max(-(-k // SCAN_WIDTH), 1), REGISTER_CHUNKS)
    return chunks, -(-n // WARPS_PER_BLOCK)


@functools.lru_cache(maxsize=None)
def _occupancy(k: int, device: int) -> dict:
    lib = _build.library()
    chunks = launch_geometry(1, k)[0]
    out = {}
    for name, fn in (("integrate", lib.dvt_integrate_forward_occupancy),
                     ("integrate_bwd", lib.dvt_integrate_backward_occupancy)):
        vals = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            code = fn(k, chunks, ctypes.cast(vals, ctypes.c_void_p))
        _build.check(code, f"{name} occupancy")
        out[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm"),
                             list(vals)))
    return out


def kernel_occupancy(k: int, device: int | None = None) -> dict:
    """K9f's and K9b's registers, local memory (bytes per thread: stack
    and spills) and resident blocks per SM for rows of ``k`` steps (the
    kernel instance :func:`launch_geometry` picks) on CUDA device
    ``device`` (the current one by default), from the CUDA runtime."""
    if device is None:
        device = torch.cuda.current_device()
    return {name: dict(v) for name, v in _occupancy(k, int(device)).items()}


def _planes(sigma, color_planes, dt, mask, t_origin):
    cr, cg, cb = color_planes
    n, k = sigma.shape
    for name, x in (("cr", cr), ("cg", cg), ("cb", cb), ("dt", dt)):
        if tuple(x.shape) != (n, k) or x.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 ({n}, {k}), got "
                             f"{x.dtype} {tuple(x.shape)}")
    if sigma.dtype != torch.float32:
        raise TypeError(f"sigma: want float32, got {sigma.dtype}")
    if tuple(mask.shape) != (n, k) or mask.dtype != torch.bool:
        raise ValueError(f"mask: want bool ({n}, {k}), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if t_origin is not None and (tuple(t_origin.shape) != (n,)
                                 or t_origin.dtype != torch.float32):
        raise ValueError(f"t_origin: want float32 ({n},)")
    devices = {x.device for x in (sigma, cr, cg, cb, dt, mask)}
    if t_origin is not None:
        devices.add(t_origin.device)
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    return cr, cg, cb


def _contiguous(*xs):
    for x in xs:
        if x is not None and not x.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def integrate_forward_plain(sigma, color_planes, dt, mask, t_near, t_far,
                            t_origin=None) -> torch.Tensor:
    """Plain twin of K9f: (N, 8) float32 rows (r, g, b, T, opacity,
    depth, 0, 0), through :func:`integrate`."""
    intl = integrate(sigma, tuple(color_planes), dt, mask, t_near, t_far,
                     with_aux=False, t_cursor_origin=t_origin)
    z = torch.zeros_like(intl.depth)
    return torch.stack([intl.radiance[:, 0], intl.radiance[:, 1],
                        intl.radiance[:, 2], intl.transmittance,
                        intl.opacity, intl.depth, z, z], dim=1)


def integrate_forward(sigma, color_planes, dt, mask, t_near: float,
                      t_far: float, t_origin=None) -> torch.Tensor:
    """K9f: (N, 8) rows (r, g, b, T, opacity, depth, 0, 0) of the (N, K)
    planes; the plain twin on CPU tensors."""
    cr, cg, cb = _planes(sigma, color_planes, dt, mask, t_origin)
    if sigma.device.type == "cpu":
        return integrate_forward_plain(sigma, (cr, cg, cb), dt, mask, t_near,
                                       t_far, t_origin)
    if sigma.device.type != "cuda":
        raise ValueError(f"unsupported device {sigma.device}")
    _contiguous(sigma, cr, cg, cb, dt, mask, t_origin)
    n, k = (int(v) for v in sigma.shape)
    dev = sigma.device
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    chunks, blocks = launch_geometry(n, k)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_integrate_forward(
            sigma.data_ptr(), cr.data_ptr(), cg.data_ptr(), cb.data_ptr(),
            dt.data_ptr(), mask.data_ptr(),
            t_origin.data_ptr() if t_origin is not None else None,
            out.data_ptr(), n, k, chunks, blocks, float(t_near),
            float(t_far), STOP_THRESHOLD, OPACITY_EPS,
            _build.stream_ptr(dev))
    _build.check(code, "dvt_integrate_forward")
    integrate_forward.launches += 1
    return out


integrate_forward.launches = 0


def _tie(x: torch.Tensor) -> torch.Tensor:
    """d max(x, 0) / dx with JAX's tie value 0.5 at x == 0."""
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    return torch.where(x > 0.0, one, torch.where(x < 0.0, zero, 0.5 * one))


def radiance_vjp_plain(sigma, color_planes, dt, mask, g) -> tuple:
    """Plain twin of K9b: the radiance head's adjoint for ``g`` (N, 3),
    (d_sigma, (d_r, d_g, d_b)), each (N, K):

        dL/dod_j = proc_j * dot_j * P_j - sum_{k>j} dot_k * w_k
        d_sigma_j = dL/dod_j * dt_j * tie(sigma_j * dt_j)   (live j)
        d_c_j     = w_j * g_c

    with dot_k = sum_c g_c * c_k. The suffix sum is a reversed cumulative
    sum, shifted by one step (never a total minus a prefix)."""
    cr, cg, cb = color_planes
    maskf = mask.to(torch.float32)
    sdt = sigma * dt
    od = torch.maximum(sdt, torch.zeros_like(sdt)) * maskf
    p = torch.exp(-scan_prefix(od))
    t_before = torch.cat([torch.ones_like(p[:, :1]), p[:, :-1]], dim=1)
    procf = processed_steps(mask, t_before)
    w = (t_before - p) * procf
    g_r, g_g, g_b = g[:, 0:1], g[:, 1:2], g[:, 2:3]
    dot = cr * g_r + cg * g_g + cb * g_b
    dotw = dot * w
    incl = torch.flip(torch.cumsum(torch.flip(dotw, [1]), dim=1), [1])
    suffix = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], dim=1)
    dl_dod = procf * dot * p - suffix
    d_sigma = dl_dod * dt * _tie(sdt) * maskf
    return d_sigma, (w * g_r, w * g_g, w * g_b)


def radiance_vjp(sigma, color_planes, dt, mask, g) -> tuple:
    """K9b: (d_sigma, (d_r, d_g, d_b)) of the radiance head for ``g``
    (N, 3); the plain twin on CPU tensors."""
    cr, cg, cb = _planes(sigma, color_planes, dt, mask, None)
    n, k = (int(v) for v in sigma.shape)
    if tuple(g.shape) != (n, 3) or g.dtype != torch.float32:
        raise ValueError(f"g: want float32 ({n}, 3), got {g.dtype} "
                         f"{tuple(g.shape)}")
    if sigma.device.type == "cpu":
        return radiance_vjp_plain(sigma, (cr, cg, cb), dt, mask, g)
    if sigma.device.type != "cuda":
        raise ValueError(f"unsupported device {sigma.device}")
    g = g.contiguous()
    _contiguous(sigma, cr, cg, cb, dt, mask)
    dev = sigma.device
    outs = [torch.empty((n, k), dtype=torch.float32, device=dev)
            for _ in range(4)]
    chunks, blocks = launch_geometry(n, k)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_integrate_backward(
            sigma.data_ptr(), cr.data_ptr(), cg.data_ptr(), cb.data_ptr(),
            dt.data_ptr(), mask.data_ptr(), g.data_ptr(),
            *(o.data_ptr() for o in outs), n, k, chunks, blocks,
            STOP_THRESHOLD, _build.stream_ptr(dev))
    _build.check(code, "dvt_integrate_backward")
    radiance_vjp.launches += 1
    return outs[0], tuple(outs[1:])


radiance_vjp.launches = 0


class _IntegrateFused(torch.autograd.Function):
    """(sigma, r, g, b) -> (radiance (N, 3), T, opacity, depth (N,)).
    ``static`` = (dt, mask, t_origin, t_near, t_far): none of them is
    differentiated."""

    @staticmethod
    def forward(ctx, static, sigma, cr, cg, cb):
        dt, mask, t_origin, t_near, t_far = static
        out = integrate_forward(sigma, (cr, cg, cb), dt, mask, t_near, t_far,
                                t_origin)
        ctx.static = static
        ctx.save_for_backward(sigma, cr, cg, cb)
        ctx.set_materialize_grads(False)
        return (out[:, 0:3].contiguous(), out[:, 3].contiguous(),
                out[:, 4].contiguous(), out[:, 5].contiguous())

    @staticmethod
    def backward(ctx, g_rad, g_t, g_op, g_depth):
        dt, mask, t_origin, t_near, t_far = ctx.static
        # read before the mark: a checkpointed windowed group recomputes
        # its forward here, under that forward's own stage marks
        sigma, cr, cg, cb = ctx.saved_tensors
        trace.stage("k9b")
        d_sigma = d_planes = None
        if g_rad is not None:
            d_sigma, d_planes = radiance_vjp(sigma, (cr, cg, cb), dt, mask,
                                             g_rad.contiguous())
        heads = [(g, i) for i, g in enumerate((g_t, g_op, g_depth))
                 if g is not None]
        if heads:
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(True)
                          for x in (sigma, cr, cg, cb)]
                intl = integrate(leaves[0], tuple(leaves[1:]), dt, mask,
                                 t_near, t_far, with_aux=False,
                                 t_cursor_origin=t_origin)
                outs = (intl.transmittance, intl.opacity, intl.depth)
                grads = torch.autograd.grad(
                    [outs[i] for _, i in heads], leaves,
                    [g for g, _ in heads], allow_unused=True)
            grads = [torch.zeros_like(x) if d is None else d
                     for d, x in zip(grads, leaves)]
            if d_sigma is None:
                d_sigma, d_planes = grads[0], tuple(grads[1:])
            else:
                d_sigma = d_sigma + grads[0]
                d_planes = tuple(a + b for a, b in zip(d_planes, grads[1:]))
        if d_sigma is None:
            return None, None, None, None, None
        return (None, d_sigma, *d_planes)


def integrate_fused(sigma: torch.Tensor, color_planes, dt: torch.Tensor,
                    mask: torch.Tensor, t_near: float, t_far: float,
                    t_origin: torch.Tensor | None = None):
    """(radiance (N, 3), transmittance, opacity, depth (N,)) of the (N, K)
    lattice, differentiable in ``sigma`` and the three colour planes.

    K9f / K9b on CUDA tensors, their plain twins on CPU tensors (the plain
    integrator on any device is :func:`integrate`). ``mask`` and ``dt``
    are not differentiated."""
    cr, cg, cb = color_planes
    static = (dt, mask, t_origin, float(t_near), float(t_far))
    return _IntegrateFused.apply(static, sigma, cr, cg, cb)
