"""Renderer: the plan-bound entry point of the port.

Counterpart of ``dvren_tpu/render/renderer.py`` on its two tiled paths.
On a dense grid or a sparse brick field, :meth:`Renderer.forward` builds
the tile schedule by ``build_tiled_schedule_auto``'s cascade (16, 8 or
4 px tiles, cell or supercell tables) once per (field bbox, packed
dtype, grid shape, pitch; for a sparse field its brick count and
occupancy, compared by contents) key, keeps it on the context's device,
and replays it every frame (the table: K3 for a float32 dense grid on
cell tables, the supercell table on supercell ones, K5a for a 16-bit
grid, the bricks as they are for a sparse field; the bank gather, one K1
launch per tile group, the tile compose); :meth:`Renderer.backward`
differentiates that replay for
``sum(image * dl_image)`` in (sigma, color) or the bricks, ``c2w`` and
``k`` (K2 per group, the gather-plan reduction, then K4 or K5b on a dense
grid). The forward's stats notes count the launches of K1
(``fused_tiles``), K3 (``packed_table``) and K5a (``packed_table16``);
K2, K4 and K5b (``packed_table16_bwd``) launch in the backward.
On a hash-MLP field, the forward builds the frame's hash schedule once
per plan and renders it with one K7f launch (the backward refuses: hash
fields train through autograd of ``render_hash_tiled`` or
``opt.fit.fit_hash_mlp``).

Every other mode of the JAX Renderer raises ``NotImplementedError``
naming its ROADMAP item: override rays, windowed, streamed, fused and
staged paths, and graph capture. Unlike the JAX package, which picks the
tiled paths by default only on a TPU, ``use_tiles=None`` picks them on a
CUDA context.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from dvren_tpu_torch.core.context import Context
from dvren_tpu_torch.core.plan import InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import DvrenError, check
from dvren_tpu_torch.ops import fused_tiles, hash_tiles, packed_transpose
from dvren_tpu_torch.ops.raygen import camera_arrays
from dvren_tpu_torch.render import hash_tiled as hash_mod
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


@dataclass
class BackwardResult:
    """Mirrors ``dvren::BackwardResult`` (renderer.hpp:61-66) plus the
    camera gradients: flat numpy buffers."""

    sigma: np.ndarray           # (voxel_count,) float32, [z][y][x]
    color: np.ndarray           # (3*voxel_count,) float32
    camera: np.ndarray          # (3, 4) float32 = dL/d(c2w)
    camera_k: np.ndarray | None = None   # (3, 3) dL/dK
    sample_count: int = 0
    bricks: np.ndarray | None = None     # sparse fields: dL/d(bricks),
    #                                      (n_bricks, 512, 32) float32;
    #                                      sigma and color are then empty


def _launch_counts() -> tuple[int, int, int]:
    return (fused_tiles.tile_forward.launches,
            packed_transpose.build_rows.launches,
            hash_tiles.hash_tile_forward.launches)


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
        self._hash_schedule = None    # frame layout only: once per plan
        self._last_mode = None        # the mode of the last forward
        self._last_ray_count = 0

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
        if self._use_hash_tiles(field):
            mode, render = "hash_tiled", self._forward_hash_tiled
        elif self._use_tiles(field):
            mode, render = "tiled", self._forward_tiled
        else:
            raise NotImplementedError(self._untiled_mode())
        check(field.device == self._ctx.device,
              f"field is on {field.device}, the context on "
              f"{self._ctx.device}: move it with field.to(device)")
        if self._options.enable_graph:
            raise NotImplementedError(
                "CUDA graph capture is ROADMAP Queue 1 item 9")
        stats = RenderStats()
        t0 = time.perf_counter()
        launches0 = _launch_counts()
        k5a0 = packed_transpose.build_rows16.launches
        with torch.no_grad():
            planes = render(field, stats)
        if self._ctx.device.type == "cuda":
            torch.cuda.synchronize(self._ctx.device)
        stats.total_ms = (time.perf_counter() - t0) * 1e3
        k1, k3, k7 = (b - a for a, b in zip(launches0, _launch_counts()))
        if mode == "hash_tiled":
            stats.notes.append(f"kernel_launches=hash_tiles:{k7}")
        else:
            stats.notes.append(f"kernel_launches=fused_tiles:{k1},"
                               f"packed_table:{k3}")
            stats.notes.append(
                f"kernel_launches=packed_table16:"
                f"{packed_transpose.build_rows16.launches - k5a0}")
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
        self._last_mode = mode
        self._last_ray_count = self._plan.ray_count
        return result

    Forward = forward

    def backward(self, field, dl_di,
                 out: BackwardResult | None = None) -> BackwardResult:
        """Analogue of Renderer::Backward (renderer.cpp:390-446).

        ``dl_di`` is flat (ray_count*3,) or (ray_count, 3): the loss
        gradient with respect to each ray's radiance. Differentiates the
        last forward's mode at its schedule; only the tiled mode is
        ported."""
        if self._last_mode is None:
            raise DvrenError.invalid_argument(
                "Backward requires a prior Forward")
        if not (hasattr(field, "sigma") and hasattr(field, "color")
                or hasattr(field, "bricks")):
            raise DvrenError.unsupported(
                "Renderer.backward targets dense voxel grids (the reference "
                "hp_diff contract) and sparse brick fields; train other "
                "field families through autograd (hash-MLP: "
                "render_hash_tiled / opt.fit.fit_hash_mlp ride the fused "
                "kernel)")
        if self._last_mode != "tiled" or self._tiled_schedule is None:
            raise NotImplementedError(
                f"the {self._last_mode} backward is ROADMAP Queue 1 item 11")
        n = self._last_ray_count
        dl = np.asarray(dl_di, np.float32).reshape(-1)
        check(dl.size == n * 3,
              f"dL/dI must have {n * 3} elements, got {dl.size}")
        check(field.device == self._ctx.device,
              f"field is on {field.device}, the context on "
              f"{self._ctx.device}: move it with field.to(device)")
        return self._backward_tiled(field, dl.reshape(n, 3), out)

    Backward = backward

    def _dl_image(self, dl: np.ndarray) -> torch.Tensor:
        """Per-ray dL/dI (N, 3) placed into the (H, W, 3) image plane on
        the context's device (generated rays own their pixels)."""
        plan = self._plan
        roi = plan.roi
        dl_img = np.zeros((plan.height, plan.width, 3), np.float32)
        ys = roi.y + np.arange(plan.ray_count) // roi.width
        xs = roi.x + np.arange(plan.ray_count) % roi.width
        dl_img[ys, xs] = dl
        return torch.from_numpy(dl_img).to(self._ctx.device)

    def _finish_backward(self, grads, out: BackwardResult | None):
        """``grads`` = (*field params, dc2w, dk): (sigma, color) of a
        dense grid, or (bricks,) of a sparse field (JAX
        ``_finish_backward``)."""
        *params_g, dc2w, dk = (
            g.detach().float().cpu().numpy() for g in grads)
        result = out or BackwardResult(
            sigma=np.empty(0), color=np.empty(0),
            camera=np.zeros((3, 4), np.float32))
        if len(params_g) == 1:      # sparse brick field
            result.bricks = params_g[0]
            result.sigma = np.empty(0, np.float32)
            result.color = np.empty(0, np.float32)
        else:
            result.sigma = params_g[0].reshape(-1)
            result.color = params_g[1].reshape(-1)
        result.camera = dc2w.reshape(3, 4)
        result.camera_k = dk.reshape(3, 3)
        result.sample_count = self._analytic_sample_count()
        return result

    def _backward_tiled(self, field, dl: np.ndarray,
                        out: BackwardResult | None) -> BackwardResult:
        """Differentiate the tiled replay of the last forward: the loss
        ``sum(image * dl_image)`` through :func:`render_tiled` at the
        schedule's camera, in (sigma, color) or the bricks, c2w and k."""
        dev = self._ctx.device
        dl_img = self._dl_image(dl)
        k0, c2w0, _ = camera_arrays(self._plan, dev)
        k0.requires_grad_(True)
        c2w0.requires_grad_(True)
        # the field's values as fresh leaves (``field.with_params``, as
        # in the JAX package): the gradient does not depend on whether
        # the caller's parameters require grad, nor touches their .grad
        if hasattr(field, "bricks"):
            leaf = field.with_params(field.bricks.detach())
            params = (leaf.bricks,)
        else:
            leaf = field.with_params(field.sigma.detach(),
                                     field.color.detach())
            params = (leaf.sigma, leaf.color)
        wrt = params + (c2w0, k0)
        with torch.enable_grad():
            planes = tiled_mod.render_tiled(
                self._plan, leaf, self._tiled_schedule, k=k0, c2w=c2w0)
            loss = torch.sum(planes.image * dl_img)
            # an empty schedule (no ray enters the bbox) renders the
            # background alone: every gradient is zero, as in JAX
            grads = (torch.autograd.grad(loss, wrt, allow_unused=True)
                     if loss.requires_grad else (None,) * len(wrt))
        grads = tuple(torch.zeros_like(x) if g is None else g
                      for g, x in zip(grads, wrt))
        return self._finish_backward(grads, out)

    def _tile_eligible(self, field) -> bool:
        """Dense OOB_ZERO trilinear grids with all dims >= 2, and sparse
        brick fields (trilinear by construction) over such grids."""
        if hasattr(field, "bricks") and hasattr(field, "occupancy"):
            shape = tuple(int(v) for v in field.grid_shape)
            return (getattr(field, "oob", None) == OobPolicy.ZERO
                    and len(shape) == 3 and min(shape) >= 2)
        sigma = getattr(field, "sigma", None)
        return (sigma is not None and sigma.dim() == 3
                and hasattr(field, "color")
                and hasattr(field, "bbox_min") and hasattr(field, "bbox_max")
                and getattr(field, "oob", None) == OobPolicy.ZERO
                and getattr(field, "interp", None) == InterpMode.LINEAR
                and min(int(v) for v in sigma.shape) >= 2)

    def _hash_eligible(self, field) -> bool:
        """Hash-MLP fields ride the slot-free fused kernel
        (ops/hash_tiles.py) when the spec fits it."""
        params = getattr(field, "params", None)
        return (params is not None and hasattr(params, "keys")
                and "hash_table" in params.keys() and hasattr(field, "spec")
                and hash_tiles.fast_path_ok(field.spec))

    def _use_hash_tiles(self, field) -> bool:
        opt = self._options.use_tiles
        if opt is False or not self._hash_eligible(field):
            return False
        if opt is True:
            return True
        return (self._ctx.device.type == "cuda"
                and not self._options.use_window)

    def _forward_hash_tiled(self, field, stats: RenderStats):
        """The fused hash-MLP path (render/hash_tiled.py). The schedule
        is pure frame layout (no field capture): built once per plan."""
        if self._hash_schedule is None:
            t0 = time.perf_counter()
            self._hash_schedule = hash_mod.build_hash_schedule(
                self._plan, jitter=self._jitter_host,
                device=self._ctx.device)
            stats.notes.append(
                f"hash_schedule_build_ms="
                f"{(time.perf_counter() - t0) * 1e3:.3f}")
        planes = hash_mod.render_hash_tiled(self._plan, field,
                                            self._hash_schedule)
        stats.notes.append("hash_tiled_path")
        return planes

    def _use_tiles(self, field) -> bool:
        opt = self._options.use_tiles
        if opt is False:
            return False
        if opt is True:
            check(self._tile_eligible(field),
                  "use_tiles requires a dense OOB_ZERO trilinear grid field "
                  "or a sparse brick field")
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
                f"item 11; only the tiled paths are ported (the default on "
                f"CUDA, or pass RenderOptions(use_tiles=True) with a dense "
                f"OOB_ZERO trilinear grid or a hash-MLP field)")

    def _tiled_schedule_key(self, field) -> tuple:
        """What the schedule depends on. The cascade's choice depends on
        the table's ``packed_dtype`` (supercells only for float32), so the
        key holds it. A sparse schedule's lanes name brick rows resolved
        through the occupancy, so its key holds the brick count and a host
        copy of the occupancy, compared by contents. (The JAX key has
        neither the dtype nor, outside ``use_occupancy``, the occupancy:
        a bfloat16 field after a float32 one of one shape would reuse a
        supercell schedule there, and two sparse fields of one shape and
        bbox a stale one.)"""
        key = (tuple(float(v) for v in field.bbox_min),
               tuple(float(v) for v in field.bbox_max),
               getattr(field, "packed_dtype", "float32"))
        if hasattr(field, "bricks"):
            occ = field.occupancy.cpu().numpy()
            return key + (tuple(int(v) for v in field.grid_shape), True,
                          self._options.tile_pitch,
                          int(field.bricks.shape[0]), occ.shape,
                          occ.tobytes())
        return key + (tuple(int(v) for v in field.sigma.shape), False,
                      self._options.tile_pitch)

    def _forward_tiled(self, field, stats: RenderStats):
        key = self._tiled_schedule_key(field)
        if self._tiled_schedule is None or self._tiled_key != key:
            t0 = time.perf_counter()
            schedule, note = tiled_mod.build_tiled_schedule_auto(
                self._plan, field, jitter=self._jitter_host,
                occupancy=self._options.use_occupancy,
                pitch=self._options.tile_pitch)
            if note:
                stats.notes.append(note)
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
