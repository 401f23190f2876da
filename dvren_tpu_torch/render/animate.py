"""Moving-camera rendering at a fixed per-frame cost on the tile path.

Counterpart of ``dvren_tpu/render/animate.py``. A tile schedule depends on
the camera: its group shapes and slot counts move with every pose. The
JAX package pins them so that one compiled executable replays every
pose; the port has no executable to share, so what it pins is the
schedule's structure, and a frame costs the host build, one upload and
one :func:`~dvren_tpu_torch.render.tiled.render_tiled` call (K3, the bank
gather, one K1 launch, the compose):

- ``build_tiled_schedule(quantize="uniform", uniform_shape=(nc, nb),
  all_tiles=True)`` pins the one group's (chunk count, bank count) and
  puts every image tile in it (a tile without a live ray is fully masked
  and renders the background bit for bit), so every array's shape is a
  function of the plan's geometry alone;
- :func:`canonical_stats` zeroes the camera-dependent statistics and
  drops the backward's gather plan (forward only: training under camera
  motion builds full schedules).

:meth:`MovingCameraRenderer.cache_size` counts the distinct schedule
structures met (group shapes, array shapes and dtypes): 1 while the
camera-stability contract holds, and a pose that would break it raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.render.pipeline import plan_jitter_table
from dvren_tpu_torch.render.tiled import build_tiled_schedule, render_tiled


def canonical_stats(sched):
    """A copy of ``sched`` with the camera-dependent statistics zeroed
    (``tiled_samples``, each group's ``samples``) and without its
    backward gather plan, which only the backward reads."""
    groups = tuple(dataclasses.replace(g, samples=0) for g in sched.groups)
    return dataclasses.replace(sched, groups=groups, tiled_samples=0,
                               gather_plan=None)


def _plan_geometry(plan: Plan) -> tuple:
    roi = plan.roi
    return (plan.width, plan.height, float(plan.t_near), float(plan.t_far),
            float(plan.sampling.dt), int(plan.sampling.max_steps),
            int(plan.sampling.mode), int(plan.seed),
            (roi.x, roi.y, roi.width, roi.height))


def _arrays(x, prefix=""):
    """(name, shape, dtype) of every array a schedule holds."""
    out = []
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return [(prefix, tuple(x.shape), str(x.dtype))]
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            out += _arrays(getattr(x, f.name), f"{prefix}.{f.name}")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            out += _arrays(v, f"{prefix}[{i}]")
    return out


def schedule_structure(sched) -> tuple:
    """What a camera must not change: the group shapes, every array's
    shape and dtype, the tile set's shape classes."""
    return (tuple((g.n_chunks, g.n_tiles, g.banks) for g in sched.groups),
            tuple(_arrays(sched)), sched.pitch, sched.tile_px)


class MovingCameraRenderer:
    """One schedule structure, any camera (see the module docstring).

    ``uniform_shape=(nc, nb)``: the pinned (chunk count, bank count)
    class; by default the base plan's own maxima plus ``headroom`` (one
    chunk and one bank). A pose whose maxima exceed the pin, a plan that
    differs from the base plan beyond its camera, or a pose with
    overflow rays raises.

    >>> r = MovingCameraRenderer(plan0, field)
    >>> planes = r.render(plan_for(pose), field)
    """

    def __init__(self, base_plan: Plan, field, uniform_shape=None,
                 pitch: int = 1, headroom=(1, 1)):
        self._plan = base_plan
        self._geom = _plan_geometry(base_plan)
        self._jitter = plan_jitter_table(base_plan)
        if uniform_shape is None:
            probe = build_tiled_schedule(
                base_plan, field, jitter=self._jitter, quantize="uniform",
                pitch=pitch, build_fallback=False)
            check(probe.fallback_rays == 0,
                  "camera-stable schedules need zero overflow rays at the "
                  "base pose (a finer tile_px or occupancy may help)")
            g = probe.groups[0]
            uniform_shape = (min(g.n_chunks + int(headroom[0]),
                                 -(-base_plan.sampling.max_steps // 8)),
                             g.banks + int(headroom[1]))
        self.uniform_shape = (int(uniform_shape[0]), int(uniform_shape[1]))
        self._pitch = pitch
        self._structures = set()

    def host_schedule(self, plan: Plan, field):
        """The camera-stable schedule for ``plan`` as numpy arrays, its
        statistics canonical. Raises if the plan differs from the base
        plan beyond the camera, if the pose needs more chunks or banks
        than ``uniform_shape``, if any ray overflows, or if the
        structure differs from the one met before."""
        check(_plan_geometry(plan) == self._geom,
              "MovingCameraRenderer: plan differs from the base plan "
              "beyond the camera (rebuild the renderer)")
        sched = build_tiled_schedule(
            plan, field, jitter=self._jitter, quantize="uniform",
            uniform_shape=self.uniform_shape, all_tiles=True,
            pitch=self._pitch)
        check(sched.fallback_rays == 0,
              "camera-stable schedules need zero overflow rays")
        sched = canonical_stats(sched)
        structure = schedule_structure(sched)
        check(not self._structures or structure in self._structures,
              "schedule structure changed across cameras (a tile class "
              "shifted): impossible under all_tiles and a pinned "
              "uniform_shape")
        self._structures.add(structure)
        return sched

    def schedule_for(self, plan: Plan, field):
        """:meth:`host_schedule` moved to the field's device (one upload)."""
        return self.host_schedule(plan, field).to(field.device)

    def render(self, plan: Plan, field):
        """ImagePlanes for ``plan``'s camera: the host build, one upload
        and one ``render_tiled`` call."""
        return render_tiled(self._plan, field, self.schedule_for(plan, field))

    def cache_size(self) -> int:
        """The distinct schedule structures met (1 after the first frame
        while the camera-stability contract holds)."""
        return len(self._structures)
