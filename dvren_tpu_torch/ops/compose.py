"""Image planes and the per-ray compose.

Counterpart of ``dvren_tpu/ops/compose.py`` (``img_generate_cpu``,
img_cpu.cpp:110-188). :class:`ImagePlanes` mirrors ``hp_img_t``
(hp.h:148-154). :func:`compose` places per-ray results at their pixel ids
for rays that own their pixels (``unique_pixels=True``: generated rays,
whose ids enumerate the ROI): a pixel hit by a ray takes its radiance,
transmittance, opacity and depth, every other pixel the background (image
0, T 1, opacity 0, depth t_far). Ids at or past width * height (padding
rays) are dropped. The placement is an index copy, so its gradient is a
gather: no scatter-add. The first-write / accumulate semantics of override
bundles whose rays share pixels are not ported (ROADMAP Queue 1, ray
overrides); the tiled path places whole tiles
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
    if not unique_pixels:
        raise NotImplementedError(
            "compose of rays that share pixels (override bundles) is "
            "ROADMAP Queue 1 item 11, ray overrides")
    n_px = int(width) * int(height)

    def plane(values, fill):
        canvas = torch.full((n_px,) + tuple(values.shape[1:]), float(fill),
                            dtype=values.dtype, device=values.device)
        return place_rays(canvas, pixel_ids, values)

    hw = (int(height), int(width))
    return ImagePlanes(
        image=plane(radiance, 0.0).reshape(hw + (3,)),
        transmittance=plane(transmittance, 1.0).reshape(hw),
        opacity=plane(opacity, 0.0).reshape(hw),
        depth=plane(depth, t_far).reshape(hw),
        hitmask=plane(torch.ones_like(transmittance), 0.0).to(
            torch.int32).reshape(hw))
