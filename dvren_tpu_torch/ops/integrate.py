"""Emission-absorption integration over the dense (N, K) lattice.

Counterpart of ``dvren_tpu/ops/integrate.py``: the per-ray recurrence

    alpha_k = 1 - exp(-sigma_k * dt_k)
    T_{k+1} = T_k * (1 - alpha_k)
    stop once T <= 1e-4

as a cumulative sum in log space. With ``P_k = exp(-sum_{j<=k} od_j)``,
``od = max(sigma * dt, 0)`` on live samples, step k is processed iff it
is live and ``P_{k-1} > 1e-4``; its weight is ``P_{k-1} - P_k``. The
processed steps are a prefix of each ray (the mask is a prefix and P
does not increase), so the final transmittance is P at the last
processed step.

This is the plain twin of the port's per-ray integrator, the CUDA
kernels K9f / K9b of :mod:`dvren_tpu_torch.ops.integrate_fused`, and the
referee for the per-ray paths on the CPU. Its gradient follows JAX's
autodiff of ``integrate`` except at one place: the final transmittance
(and with it opacity and depth) is read at the last processed step
through a one-hot sum, so its gradient is ``-T`` on every processed step,
as the fused tile kernels give it; ``jnp.min`` splits it over steps whose
prefixes tie (exact-zero sigma). ``max(x, 0)`` keeps JAX's tie value 0.5
at x == 0 (``torch.maximum``'s gradient).

The prefix sums are taken in the kernels' order (:func:`scan_prefix`: a
32-wide Hillis-Steele scan per chunk, chunks carried in order), so on the
card the twin's P is the kernels' bit for bit and both take the same
steps: which step is the last processed one never depends on rounding
that differs between the two.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

STOP_THRESHOLD = 1e-4   # int_cpu.cpp:171: stop once T <= this
OPACITY_EPS = 1e-6      # int_cpu.cpp:224: depth only where opacity > this
LOG_T_FLOOR = 1e-30     # int_cpu.cpp:190: floor of log(T_before)


@dataclass(frozen=True)
class Integration:
    """Per-ray outputs; mirrors ``hp_intl_t`` (hp.h:140-146).

    radiance (N, 3); transmittance, opacity, depth (N,); aux (N, K, 4) =
    (alpha, weight, T_before, logT_before) per sample, or None."""

    radiance: torch.Tensor
    transmittance: torch.Tensor
    opacity: torch.Tensor
    depth: torch.Tensor
    aux: torch.Tensor | None


def compute_alpha(sigma: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """alpha(sigma, dt) as int_cpu.cpp:98-109 computes it in float32:
    a second-order Taylor term below optical depth 1e-4, expm1 above."""
    od = sigma * dt
    taylor = od * (1.0 - 0.5 * od)
    full = torch.clamp(-torch.expm1(-torch.clamp_max(od, 88.0)), 0.0, 1.0)
    alpha = torch.where(od < 1e-4, taylor, full)
    return torch.where(od <= 0.0, torch.zeros_like(alpha), alpha)


def color_planes(color):
    """(r, g, b) planes of ``color``: (N, K, 3) or a tuple of three (N, K)."""
    if isinstance(color, (tuple, list)):
        return color[0], color[1], color[2]
    return color[..., 0], color[..., 1], color[..., 2]


SCAN_WIDTH = 32    # a warp: the kernels' chunk of steps


def scan_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along dim 1 of (N, K), in K9's order: per
    32-step chunk a Hillis-Steele scan (lane j adds lane j - off for off
    = 1, 2, 4, 8, 16), then each chunk plus the carried sum of the
    chunks before it. Plain adds, each rounded once, so the result is
    the same on every device."""
    n, k = x.shape
    if k == 0:
        return x
    kp = -(-k // SCAN_WIDTH) * SCAN_WIDTH
    v = torch.nn.functional.pad(x, (0, kp - k)).reshape(n, kp // SCAN_WIDTH,
                                                       SCAN_WIDTH)
    off = 1
    while off < SCAN_WIDTH:
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
        off *= 2
    chunks = []
    carry = None
    for c in range(kp // SCAN_WIDTH):
        s = v[:, c] if carry is None else carry[:, None] + v[:, c]
        chunks.append(s)
        carry = s[:, -1]
    return torch.cat(chunks, dim=1)[:, :k]


def processed_steps(mask: torch.Tensor, t_before: torch.Tensor,
                    stop_threshold: float = STOP_THRESHOLD) -> torch.Tensor:
    """Float (N, K) mask of the processed steps: live, and no step up to
    this one has T_before <= the threshold. A scan's prefixes need not
    grow monotonically (its sums associate differently per step), so P
    may rise by an ulp after it fell to the threshold; the running
    minimum keeps the processed steps a prefix, as K9 does."""
    alive = (t_before > stop_threshold).to(t_before.dtype)
    alive = torch.cummin(alive, dim=1).values
    return mask.to(t_before.dtype) * alive


def _weights(sigma, dt, mask, stop_threshold):
    """(P, T_before, processed mask as float, weights), each (N, K)."""
    maskf = mask.to(sigma.dtype)
    od = torch.maximum(sigma * dt, torch.zeros_like(sigma)) * maskf
    p = torch.exp(-scan_prefix(od))
    t_before = torch.cat([torch.ones_like(p[:, :1]), p[:, :-1]], dim=1)
    procf = processed_steps(mask, t_before.detach(), stop_threshold)
    return p, t_before, procf, (t_before - p) * procf


def final_transmittance(p: torch.Tensor, procf: torch.Tensor) -> torch.Tensor:
    """P at each ray's last processed step (1 where none is processed):
    ``min`` over the processed steps up to rounding, with its gradient on
    that one step (a one-hot sum: no scatter in the backward)."""
    last = procf - torch.cat([procf[:, 1:], torch.zeros_like(procf[:, :1])],
                             dim=1)
    t_last = torch.sum(p * last, dim=1)
    return torch.where(procf[:, 0] > 0, t_last, torch.ones_like(t_last))


def integrate(sigma: torch.Tensor, color, dt: torch.Tensor,
              mask: torch.Tensor, t_near: float, t_far: float,
              stop_threshold: float = STOP_THRESHOLD, with_aux: bool = True,
              t_cursor_origin=None) -> Integration:
    """Integrate radiance along each ray of the lattice.

    sigma, dt (N, K) float32 (dt 0 on masked slots); color (N, K, 3) or a
    tuple of three (N, K) planes; mask (N, K) bool, a prefix per ray.
    ``t_cursor_origin`` (a float or an (N,) tensor) is where the depth
    cursor starts: t_near by default; the windowed path passes
    ``t_near + k_enter * dt``. ``with_aux=False`` skips the (N, K, 4) aux."""
    maskf = mask.to(sigma.dtype)
    p, t_before, procf, weight = _weights(sigma, dt, mask, stop_threshold)
    cr, cg, cb = color_planes(color)
    radiance = torch.stack([torch.sum(weight * cr, dim=1),
                            torch.sum(weight * cg, dim=1),
                            torch.sum(weight * cb, dim=1)], dim=-1)
    t_final = final_transmittance(p, procf)
    opacity = 1.0 - t_final

    origin = t_near if t_cursor_origin is None else t_cursor_origin
    if isinstance(origin, torch.Tensor) and origin.dim() == 1:
        origin = origin[:, None]
    dt_masked = dt * maskf
    t_cursor = origin + scan_prefix(dt_masked) - dt_masked
    segment_mid = t_cursor + 0.5 * dt
    depth_weighted = torch.sum(weight * segment_mid, dim=1)
    depth = torch.where(
        opacity > OPACITY_EPS,
        depth_weighted / torch.clamp_min(opacity, OPACITY_EPS),
        torch.full_like(opacity, float(t_far)))

    aux = None
    if with_aux:
        alpha = compute_alpha(sigma, dt) * maskf
        log_t_before = torch.log(torch.clamp_min(t_before, LOG_T_FLOOR))
        aux = torch.stack([alpha * procf, weight, t_before * procf,
                           log_t_before * procf], dim=-1)
    return Integration(radiance=radiance, transmittance=t_final,
                       opacity=opacity, depth=depth, aux=aux)


def radiance_only(sigma, color, dt, mask,
                  stop_threshold: float = STOP_THRESHOLD) -> torch.Tensor:
    """The radiance head alone, (N, 3): the quantity ``hp_diff``
    differentiates."""
    _, _, _, weight = _weights(sigma, dt, mask, stop_threshold)
    cr, cg, cb = color_planes(color)
    return torch.stack([torch.sum(weight * cr, dim=1),
                        torch.sum(weight * cg, dim=1),
                        torch.sum(weight * cb, dim=1)], dim=-1)
