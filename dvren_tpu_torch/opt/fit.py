"""The training loops: losses, per-view plans and the hash-MLP fit.

Counterpart of ``dvren_tpu/opt/fit.py``. A step is plain PyTorch: render
through autograd of a fused tiled path, ``loss.backward()``, an optimizer
step on the field's parameters. :func:`fit_hash_mlp` fits a hash-MLP
field to target views through K7f / K7b with ``torch.optim.Adam``.
``fit_dense_grid`` waits for the sub-tile / supercell schedules and
multi-view training (ROADMAP Queue 1 items 10 and 13).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Callable, Sequence

import torch

from dvren_tpu_torch.core.plan import CameraConfig, Plan


@dataclass
class FitConfig:
    learning_rate: float = 5e-2
    steps: int = 500
    target_psnr: float | None = 35.0
    log_every: int = 50
    sync_every: int = 1          # steps per host copy of the losses; the
    #                              per-step history stays complete and the
    #                              target-PSNR stop is checked per copy


@dataclass
class FitResult:
    field: object
    psnr_history: list[float] = dc_field(default_factory=list)
    loss_history: list[float] = dc_field(default_factory=list)
    steps_run: int = 0
    wall_clock_s: float = 0.0      # includes the schedule build
    schedule_build_s: float = 0.0  # host schedule build + merge + upload
    first_step_s: float = 0.0      # the first step, kernel build included
    steady_step_ms: float = 0.0    # mean of the remaining steps
    reached_target: bool = False
    mode: str = ""


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(loss: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp_min(loss, 1e-12))


def view_plans(plan: Plan, cameras: Sequence[CameraConfig]):
    """Per-view plans: the plan's camera with each view's pose."""
    return [plan.with_camera(replace(plan.camera, c2w=tuple(c.c2w)))
            for c in cameras]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_hash_mlp(plan: Plan, field, cameras: Sequence[CameraConfig],
                 targets, config: FitConfig | None = None,
                 checkpoint_cb: Callable | None = None) -> FitResult:
    """Fit a HashMLPField (hash table and both MLP heads) to target views
    (V, H, W, 3) with Adam through the fused hash kernels.

    The schedule is pure frame layout, built once and uploaded once.
    Exactly ``config.steps`` steps run unless the target PSNR is reached
    at a sync point (every ``sync_every`` steps, where the losses are
    copied to the host). The input field is left as it is; the fitted one
    is ``result.field``. ``steady_step_ms`` is the mean of every step
    after the first, and nonzero whenever more than one step ran."""
    from dvren_tpu_torch.render.hash_tiled import (build_hash_schedule_stack,
                                                   render_hash_tiled_stack)

    config = config or FitConfig()
    dev = field.device
    t_build0 = time.perf_counter()
    stack = build_hash_schedule_stack(view_plans(plan, cameras), device=dev)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    result = FitResult(field=field, mode="hash_tiled")
    result.schedule_build_s = time.perf_counter() - t_build0

    trained = field.with_params(
        {k: v.detach().clone() for k, v in field.params.items()})
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
    optimizer = torch.optim.Adam(trained.parameters(),
                                 lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    k = max(int(config.sync_every), 1)
    pending = []
    ckpts_fired = 0
    t0 = time.perf_counter()
    for i in range(int(config.steps)):
        optimizer.zero_grad(set_to_none=True)
        loss = mse(render_hash_tiled_stack(plan, trained, stack), targets)
        loss.backward()
        optimizer.step()
        pending.append(loss.detach())
        if i == 0:
            _sync(dev)
            result.first_step_s = time.perf_counter() - t0
        if len(pending) < k and i + 1 < config.steps:
            continue
        losses = torch.stack(pending).cpu().tolist()
        pending = []
        ps = [float(psnr(torch.tensor(lf, dtype=torch.float32)))
              for lf in losses]
        result.loss_history.extend(losses)
        result.psnr_history.extend(ps)
        result.steps_run = i + 1
        if checkpoint_cb is not None:
            due = result.steps_run // max(config.log_every, 1)
            if due > ckpts_fired:
                ckpts_fired = due
                # a snapshot, as the JAX fit hands over its immutable params
                checkpoint_cb(trained.with_params(
                    {k: v.detach().clone()
                     for k, v in trained.params.items()}),
                    result.steps_run, ps[-1])
        if config.target_psnr is not None and ps[-1] >= config.target_psnr:
            result.reached_target = True
            break
    _sync(dev)
    steps_s = time.perf_counter() - t0
    result.wall_clock_s = result.schedule_build_s + steps_s
    if result.steps_run > 1:
        result.steady_step_ms = ((steps_s - result.first_step_s)
                                 / (result.steps_run - 1) * 1e3)
    result.field = trained
    return result
