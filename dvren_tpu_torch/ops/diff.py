"""Backward pass: per-sample and camera gradients from dL/dI.

Counterpart of ``dvren_tpu/ops/diff.py`` (the original's ``hp_diff``,
diff_cpu.cpp:89-197). :func:`per_sample_grads` is the radiance head's
adjoint per sample, the function K9b computes: one K9b launch on CUDA
tensors (:func:`dvren_tpu_torch.ops.integrate_fused.radiance_vjp`), its
plain twin on CPU tensors. Both take JAX's tie value 0.5 of
d max(sigma * dt, 0) at sigma * dt == 0, the tie of JAX's autodiff of
``radiance_only``. Only the radiance head receives an adjoint, as in the
original.

:func:`camera_grads` differentiates the chain raygen -> sampling ->
``sigma_at_planes`` / ``color_at_planes`` -> ``radiance_only`` by autograd
at the plan's camera, over the forward's jitter table, so the sample set
is the one the forward rendered. The original allocates a camera
gradient and never fills it (diff_cpu.cpp:41-47,74).
"""

from __future__ import annotations

import torch

from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.ops.integrate import color_planes, radiance_only
from dvren_tpu_torch.ops.integrate_fused import radiance_vjp
from dvren_tpu_torch.ops.raygen import camera_arrays, generate_rays
from dvren_tpu_torch.ops.sampling import generate_samples


def per_sample_grads(dl_dradiance: torch.Tensor, sigma: torch.Tensor, color,
                     dt: torch.Tensor, mask: torch.Tensor) -> tuple:
    """Per-sample (d_sigma (N, K), d_color (N, K, 3)) for dL/dI (N, 3).

    ``color`` is (N, K, 3) or a tuple of three (N, K) planes."""
    cr, cg, cb = (c.detach().contiguous() for c in color_planes(color))
    d_sigma, d_planes = radiance_vjp(
        sigma.detach().contiguous(), (cr, cg, cb), dt.contiguous(),
        mask.contiguous(),
        dl_dradiance.detach().to(torch.float32).contiguous())
    return d_sigma, torch.stack(d_planes, dim=-1)


def _detached(field):
    """The field over detached copies of its parameters where it can say
    so (``with_params``), so the camera chain records no parameter graph."""
    if hasattr(field, "with_params") and hasattr(field, "sigma") \
            and hasattr(field, "color"):
        return field.with_params(field.sigma.detach(), field.color.detach())
    return field


def camera_grads(plan: Plan, field, dl_dradiance: torch.Tensor,
                 jitter: torch.Tensor | None = None) -> dict:
    """dL/d(camera) through raygen, sampling, the field and the radiance
    head: {"c2w": (3, 4), "k": (3, 3), "ortho_scale": ()} float32, on the
    field's device. ``jitter``: the forward's (N, K) stratified table."""
    dev = field.device
    k0, c2w0, s0 = camera_arrays(plan, dev)
    wrt = (k0.requires_grad_(True), c2w0.requires_grad_(True),
           s0.requires_grad_(True))
    f = _detached(field)
    with torch.enable_grad():
        rays = generate_rays(plan, k=k0, c2w=c2w0, ortho_scale=s0)
        lattice = generate_samples(plan, rays, jitter=jitter)
        px, py, pz = lattice.position_planes
        sig = f.sigma_at_planes(px, py, pz)
        col = f.color_at_planes(px, py, pz)
        rad = radiance_only(sig, col, lattice.dt, lattice.mask)
        grads = torch.autograd.grad(
            rad, wrt, dl_dradiance.detach().to(device=dev,
                                               dtype=torch.float32),
            allow_unused=True)
    dk, dc2w, ds = (torch.zeros_like(x) if g is None else g
                    for g, x in zip(grads, wrt))
    return {"k": dk, "c2w": dc2w, "ortho_scale": ds}
