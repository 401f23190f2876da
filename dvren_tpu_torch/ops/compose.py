"""Image planes and the per-ray compose.

Counterpart of ``dvren_tpu/ops/compose.py`` (``img_generate_cpu``,
img_cpu.cpp:110-188). :class:`ImagePlanes` mirrors ``hp_img_t``
(hp.h:148-154). :func:`compose` places per-ray results at their pixel ids;
a pixel no ray lands on takes the background (image 0, T 1, opacity 0,
depth t_far), and ids at or past width * height (padding rays) are
dropped.

- ``unique_pixels=True`` (generated rays, whose ids enumerate the ROI):
  each hit pixel takes its ray's radiance, transmittance, opacity and
  depth. The placement is an index copy, so its gradient is a gather.
- ``unique_pixels=False`` (override bundles, whose rays may share
  pixels): the first-write / accumulate semantics of the original, as
  the JAX package's segment reductions give them: image the sum of the
  pixel's radiance, T the product of its T, opacity ``1 - T`` where more
  than one ray lands and the ray's own opacity where one does, depth the
  minimum. Each pixel's rays are reduced in ray order (a stable sort by
  pixel id, then ``torch.segment_reduce``, a fixed-order loop per
  segment), as XLA's CPU scatters reduce them: no float atomics, so the
  frame is the same bit for bit from call to call on the card. The
  gradients are JAX's: the image's is a gather, the opacity's reaches a
  ray's opacity only where it lands alone, the depth's is shared equally
  by the rays whose depth equals their pixel's minimum; a gradient that
  per-ray transmittance raises ``NotImplementedError``, as JAX's
  ``jax.grad`` refuses the product of rays that share pixels.

The tiled path places whole tiles
(:func:`dvren_tpu_torch.render.tiled._compose_tiles`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ImagePlanes:
    image: torch.Tensor          # (H, W, 3) float32
    transmittance: torch.Tensor  # (H, W)
    opacity: torch.Tensor        # (H, W)
    depth: torch.Tensor          # (H, W)
    hitmask: torch.Tensor        # (H, W) int32


def place_rays(canvas: torch.Tensor, pixel_ids: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """``canvas`` (P, ...) with row ``pixel_ids[i]`` set to ``values[i]``
    for ids in [0, P); other ids are dropped. Ids must be distinct within
    the canvas. An index copy, out of place: its gradient is a gather."""
    n_px = int(canvas.shape[0])
    pid = pixel_ids.to(torch.int64)
    dst = torch.where((pid >= 0) & (pid < n_px), pid,
                      torch.full_like(pid, n_px))
    ext = torch.cat([canvas,
                     canvas.new_zeros((1,) + tuple(canvas.shape[1:]))])
    return torch.index_put(ext, (dst,), values.to(canvas.dtype))[:n_px]


def compose(pixel_ids: torch.Tensor, radiance: torch.Tensor,
            transmittance: torch.Tensor, opacity: torch.Tensor,
            depth: torch.Tensor, width: int, height: int, t_far: float,
            unique_pixels: bool = True) -> ImagePlanes:
    """Per-ray (N,) results -> (H, W) planes; see the module docstring."""
    n_px = int(width) * int(height)
    hw = (int(height), int(width))
    if not unique_pixels:
        image, trans, opac, dep, hit = _SharedCompose.apply(
            pixel_ids, n_px, float(t_far), radiance, transmittance, opacity,
            depth)
        return ImagePlanes(image=image.reshape(hw + (3,)),
                           transmittance=trans.reshape(hw),
                           opacity=opac.reshape(hw), depth=dep.reshape(hw),
                           hitmask=hit.reshape(hw))

    def plane(values, fill):
        canvas = torch.full((n_px,) + tuple(values.shape[1:]), float(fill),
                            dtype=values.dtype, device=values.device)
        return place_rays(canvas, pixel_ids, values)

    return ImagePlanes(
        image=plane(radiance, 0.0).reshape(hw + (3,)),
        transmittance=plane(transmittance, 1.0).reshape(hw),
        opacity=plane(opacity, 0.0).reshape(hw),
        depth=plane(depth, t_far).reshape(hw),
        hitmask=plane(torch.ones_like(transmittance), 0.0).to(
            torch.int32).reshape(hw))


def _gather_pixels(values: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``values[dst]`` for (P, ...) pixel values, zero where ``dst`` is P
    (a dropped ray)."""
    ext = torch.cat([values,
                     values.new_zeros((1,) + tuple(values.shape[1:]))])
    return ext[dst]


class _SharedCompose(torch.autograd.Function):
    """The compose of rays that may share pixels: (image (P, 3), T,
    opacity, depth (P,), hitmask (P,) int32) from per-ray values."""

    @staticmethod
    def forward(ctx, pixel_ids, n_px, t_far, radiance, transmittance,
                opacity, depth):
        dev = radiance.device
        pid = pixel_ids.to(device=dev, dtype=torch.int64)
        valid = (pid >= 0) & (pid < n_px)
        dst = torch.where(valid, pid, torch.full_like(pid, n_px))
        rows = torch.nonzero(valid).reshape(-1)
        keys, order = torch.sort(pid[rows], stable=True)
        rows = rows[order]
        uniq, counts = torch.unique_consecutive(keys, return_counts=True)

        def reduce(values, how):
            if rows.numel() == 0:
                return values[rows]
            return torch.segment_reduce(values[rows], how, lengths=counts,
                                        axis=0)

        image = radiance.new_zeros((n_px, 3))
        image[uniq] = reduce(radiance, "sum")
        t_seg = reduce(transmittance, "prod")
        trans = transmittance.new_ones(n_px)
        trans[uniq] = t_seg
        opac = opacity.new_zeros(n_px)
        opac[uniq] = torch.where(counts > 1, 1.0 - t_seg,
                                 reduce(opacity, "sum"))
        dep = depth.new_full((n_px,), t_far)
        dep[uniq] = reduce(depth, "min")
        hit = torch.zeros(n_px, dtype=torch.int32, device=dev)
        hit[uniq] = 1
        count = torch.zeros(n_px, dtype=counts.dtype, device=dev)
        count[uniq] = counts
        ctx.save_for_backward(dst, count, depth, dep)
        ctx.mark_non_differentiable(hit)
        ctx.set_materialize_grads(False)
        return image, trans, opac, dep, hit

    @staticmethod
    def backward(ctx, g_image, g_trans, g_opac, g_dep, _g_hit):
        dst, count, depth, dep = ctx.saved_tensors
        if ctx.needs_input_grad[4] and (g_trans is not None
                                        or g_opac is not None):
            raise NotImplementedError(
                "the transmittance of rays that share pixels (a product "
                "per pixel) has no gradient, as JAX's jax.grad of "
                "compose(unique_pixels=False) has none: scatter_mul "
                "gradients need unique indices")
        d_rad = d_op = d_dep = None
        if g_image is not None and ctx.needs_input_grad[3]:
            d_rad = _gather_pixels(g_image, dst)
        if g_opac is not None and ctx.needs_input_grad[5]:
            alone = (_gather_pixels(count, dst) == 1).to(g_opac.dtype)
            d_op = _gather_pixels(g_opac, dst) * alone
        if g_dep is not None and ctx.needs_input_grad[6]:
            # the rays that reach their pixel's minimum share its
            # cotangent equally (JAX's scatter-min rule)
            at_min = depth == _gather_pixels(dep, dst)
            n_px = int(count.shape[0])
            ties = torch.bincount(dst[at_min], minlength=n_px + 1)
            coef = torch.where(at_min, 1.0 / ties[dst].to(g_dep.dtype),
                               torch.zeros_like(depth))
            d_dep = _gather_pixels(g_dep, dst) * coef
        return None, None, None, d_rad, None, d_op, d_dep
