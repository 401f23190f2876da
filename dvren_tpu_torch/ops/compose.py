"""Image planes: the renderer's output frame.

Counterpart of ``ImagePlanes`` in ``dvren_tpu/ops/compose.py`` (mirrors
``hp_img_t``, hp.h:148-154). The per-ray compose with first-write /
accumulate semantics (override bundles) is not ported yet; the tiled
path places whole tiles (:func:`dvren_tpu_torch.render.tiled._compose_tiles`).
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
