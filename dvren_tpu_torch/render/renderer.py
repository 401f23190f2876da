"""Renderer: the plan-bound entry point of the port.

Counterpart of ``dvren_tpu/render/renderer.py`` for the forward render on
the tiled path: :meth:`Renderer.forward` builds the tile schedule once
per (field bbox, grid shape, pitch) key, keeps it on the context's
device, and replays it every frame (K3 table build, bank gather, one K1
launch per tile group, tile compose).

Every other mode of the JAX Renderer raises ``NotImplementedError``
naming its ROADMAP item: override rays, the hash-MLP, windowed, streamed,
fused and staged paths, graph capture and the backward. Unlike the JAX
package, which picks tiles by default only on a TPU, ``use_tiles=None``
picks them on a CUDA context.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from dvren_tpu_torch.core.context import Context
from dvren_tpu_torch.core.plan import InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops import fused_tiles, packed_transpose
from dvren_tpu_torch.render import tiled as tiled_mod
from dvren_tpu_torch.render.pipeline import plan_jitter_table


@dataclass(frozen=True)
class RenderOptions:
    """Mirrors ``dvren::RenderOptions`` (renderer.hpp:17-21) with the JAX
    package's fields. Only the tiled forward is ported: ``use_tiles`` None
    (tiles on CUDA) or True. ``enable_graph``, ``use_window``,
    ``use_occupancy`` and ``tile_pitch=2`` raise when they would take
    effect; ``capture_stats`` is accepted, and no stage timings are taken
    yet."""

    use_fused_path: bool = True
    enable_graph: bool = False
    capture_stats: bool = True
    streaming: bool | None = None
    streaming_budget: int = 1 << 22
    use_window: bool = False
    use_tiles: bool | None = None
    use_occupancy: bool = False
    tile_pitch: int = 1


@dataclass
class RenderStats:
    """Mirrors ``dvren::RenderStats`` (renderer.hpp:41-48)."""

    total_ms: float = 0.0
    ray_ms: float = 0.0
    sample_ms: float = 0.0
    integrate_ms: float = 0.0
    compose_ms: float = 0.0
    notes: list[str] = dc_field(default_factory=list)


@dataclass
class ForwardResult:
    """Mirrors ``dvren::ForwardResult`` (renderer.hpp:50-59): flat numpy
    buffers in the reference's layouts."""

    image: np.ndarray           # (H*W*3,) float32
    transmittance: np.ndarray   # (H*W,) float32
    opacity: np.ndarray         # (H*W,) float32
    depth: np.ndarray           # (H*W,) float32
    hitmask: np.ndarray         # (H*W,) uint32
    ray_count: int = 0
    sample_count: int = 0
    stats: RenderStats = dc_field(default_factory=RenderStats)


def _launch_counts() -> tuple[int, int]:
    return fused_tiles.tile_forward.launches, packed_transpose.build_rows.launches


class Renderer:
    """Plan-bound renderer that caches the tile schedule on its device."""

    def __init__(self, ctx: Context, plan: Plan,
                 options: RenderOptions | None = None):
        self._ctx = ctx
        self._plan = plan
        self._options = options or RenderOptions()
        self._jitter_host = plan_jitter_table(plan)
        self._tiled_schedule = None
        self._tiled_key = None

    @property
    def plan(self) -> Plan:
        return self._plan

    @property
    def options(self) -> RenderOptions:
        return self._options

    def _analytic_sample_count(self) -> int:
        """Live-sample count for generated rays: every ray marches
        min(max_steps, #k with t_near + k*dt < t_far) steps."""
        plan = self._plan
        span = plan.t_far - plan.t_near
        k_live = int(math.ceil(span / plan.sampling.dt - 1e-9))
        return plan.ray_count * min(plan.sampling.max_steps, max(k_live, 0))

    def forward(self, field, out: ForwardResult | None = None,
                rays=None) -> ForwardResult:
        """Render one frame; analogue of Renderer::Forward (renderer.cpp:232)."""
        if rays is not None:
            raise NotImplementedError(
                "override ray bundles are ROADMAP Queue 1 item 11")
        check(field.sigma.device == self._ctx.device,
              f"field is on {field.sigma.device}, the context on "
              f"{self._ctx.device}: move it with field.to(device)")
        if not self._use_tiles(field):
            raise NotImplementedError(self._untiled_mode())
        if self._options.enable_graph:
            raise NotImplementedError(
                "CUDA graph capture is ROADMAP Queue 1 item 9")
        stats = RenderStats()
        t0 = time.perf_counter()
        launches0 = _launch_counts()
        with torch.no_grad():
            planes = self._forward_tiled(field, stats)
        if self._ctx.device.type == "cuda":
            torch.cuda.synchronize(self._ctx.device)
        stats.total_ms = (time.perf_counter() - t0) * 1e3
        k1, k3 = (b - a for a, b in zip(launches0, _launch_counts()))
        stats.notes.append(f"kernel_launches=fused_tiles:{k1},"
                           f"packed_table:{k3}")
        sample_count = self._analytic_sample_count()
        check(sample_count <= self._plan.max_samples,
              f"sample capacity exceeded: {sample_count} > "
              f"{self._plan.max_samples}")

        result = out or ForwardResult(
            image=np.empty(0), transmittance=np.empty(0),
            opacity=np.empty(0), depth=np.empty(0), hitmask=np.empty(0))

        def host(x, dtype):
            return x.detach().cpu().numpy().astype(dtype).reshape(-1)

        result.image = host(planes.image, np.float32)
        result.transmittance = host(planes.transmittance, np.float32)
        result.opacity = host(planes.opacity, np.float32)
        result.depth = host(planes.depth, np.float32)
        result.hitmask = host(planes.hitmask, np.uint32)
        result.ray_count = self._plan.ray_count
        result.sample_count = sample_count
        result.stats = stats
        return result

    Forward = forward

    def _tile_eligible(self, field) -> bool:
        """Dense OOB_ZERO trilinear grids with all dims >= 2."""
        sigma = getattr(field, "sigma", None)
        return (sigma is not None and sigma.dim() == 3
                and hasattr(field, "color")
                and hasattr(field, "bbox_min") and hasattr(field, "bbox_max")
                and getattr(field, "oob", None) == OobPolicy.ZERO
                and getattr(field, "interp", None) == InterpMode.LINEAR
                and min(int(v) for v in sigma.shape) >= 2)

    def _use_tiles(self, field) -> bool:
        opt = self._options.use_tiles
        if opt is False:
            return False
        if opt is True:
            check(self._tile_eligible(field),
                  "use_tiles requires a dense OOB_ZERO trilinear grid field")
            return True
        return (self._ctx.device.type == "cuda"
                and not self._options.use_window
                and self._tile_eligible(field))

    def _untiled_mode(self) -> str:
        """Why this forward would leave the tiled path, and where the
        mode it would take instead stands in the ROADMAP."""
        opts = self._options
        if opts.use_window:
            mode = "the windowed path"
        elif opts.streaming or (
                opts.streaming is None
                and self._plan.ray_count * self._plan.sampling.max_steps
                > opts.streaming_budget):
            mode = "the streamed path"
        elif opts.use_fused_path:
            mode = "the dense-lattice fused path"
        else:
            mode = "the staged path"
        return (f"this forward would take {mode}, which is ROADMAP Queue 1 "
                f"item 11; only the tiled path is ported (it is the default "
                f"on CUDA, or pass RenderOptions(use_tiles=True) with a "
                f"dense OOB_ZERO trilinear grid)")

    def _tiled_schedule_key(self, field) -> tuple:
        return (tuple(float(v) for v in field.bbox_min),
                tuple(float(v) for v in field.bbox_max),
                tuple(int(v) for v in field.sigma.shape),
                self._options.tile_pitch)

    def _forward_tiled(self, field, stats: RenderStats):
        key = self._tiled_schedule_key(field)
        if self._tiled_schedule is None or self._tiled_key != key:
            t0 = time.perf_counter()
            schedule, _ = tiled_mod.build_tiled_schedule_auto(
                self._plan, field, jitter=self._jitter_host,
                occupancy=self._options.use_occupancy,
                pitch=self._options.tile_pitch)
            self._tiled_schedule = schedule.to(self._ctx.device)
            self._tiled_key = key
            stats.notes.append(
                f"tiled_schedule_build_ms="
                f"{(time.perf_counter() - t0) * 1e3:.3f}")
            stats.notes.append(
                f"tiled_samples={schedule.tiled_samples}"
                f"/{schedule.full_lattice_samples}"
                f" fallback_rays={schedule.fallback_rays}")
        planes = tiled_mod.render_tiled(self._plan, field,
                                        self._tiled_schedule)
        stats.notes.append("tiled_path")
        return planes
