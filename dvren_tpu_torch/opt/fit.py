"""Loss helpers of the training loop.

Counterpart of ``mse`` and ``psnr`` in ``dvren_tpu/opt/fit.py``. The loop
itself is plain PyTorch: render through autograd of
:func:`dvren_tpu_torch.render.tiled.render_tiled`, ``loss.backward()``,
an optimizer step on the field's parameters. ``fit_dense_grid`` waits
for the sub-tile / supercell schedules and multi-view training (ROADMAP
Queue 1 items 10 and 13).
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(loss: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp_min(loss, 1e-12))
