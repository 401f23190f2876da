"""Render plan: validated, immutable configuration that keys cached schedules.

A copy of ``dvren_tpu/core/plan.py`` (which imports no JAX); only the
status import and this paragraph differ.

Reproduces the defaulting/validation rules of ``hp_plan_create``
(reference ``hotpath/src/runtime/hp_runtime.cpp:45-146``):

- width/height must be positive; t_far > t_near;
- all-zero intrinsics K default to identity with cx = W/2, cy = H/2
  (hp_runtime.cpp:68-78); zero fx/fy individually default to 1;
- all-zero c2w defaults to identity rotation, zero translation (:85-93);
- orthographic ortho_scale <= 0 defaults to 1 (:94-96);
- ROI with zero width/height defaults to the full frame; ROI must fit
  inside the frame (:99-109);
- max_rays == 0 defaults to the ROI area; ROI area must not exceed
  max_rays (:111-118);
- sampling dt <= 0 defaults to span/64 (or 1 if the span is degenerate);
  max_steps == 0 defaults to 64; unknown mode falls back to FIXED (:120-132);
- max_samples == 0 defaults to max_rays * max_steps clamped to uint32;
  max_samples must be >= max_rays (:134-142).

The plan is a frozen, hashable dataclass: it keys the tile schedule
that :mod:`dvren_tpu_torch.render.renderer` builds once and replays (the
role of the reference's CUDA-Graph-per-plan model,
``hotpath/src/cuda/graph_cuda.cu``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace

from dvren_tpu_torch.core.status import check

_UINT32_MAX = 0xFFFFFFFF


class CameraModel(enum.IntEnum):
    """1:1 with ``hp_camera_model`` (hp.h:52-55)."""

    PINHOLE = 0
    ORTHOGRAPHIC = 1


class SamplingMode(enum.IntEnum):
    """1:1 with ``hp_sampling_mode`` (hp.h:57-60)."""

    FIXED = 0
    STRATIFIED = 1


class InterpMode(enum.IntEnum):
    """1:1 with ``hp_interp_mode`` (hp.h:62-65)."""

    NEAREST = 0
    LINEAR = 1


class OobPolicy(enum.IntEnum):
    """1:1 with ``hp_oob_policy`` (hp.h:67-70)."""

    ZERO = 0
    CLAMP = 1


_IDENTITY_C2W = (
    1.0, 0.0, 0.0, 0.0,
    0.0, 1.0, 0.0, 0.0,
    0.0, 0.0, 1.0, 0.0,
)


@dataclass(frozen=True)
class CameraConfig:
    """Mirrors ``hp_camera_desc`` (hp.h:93-98).

    ``k`` is the 3x3 intrinsics row-major; ``c2w`` is the 3x4 camera-to-world
    row-major ``[R | t]``.
    """

    model: CameraModel = CameraModel.PINHOLE
    k: tuple[float, ...] = (0.0,) * 9
    c2w: tuple[float, ...] = (0.0,) * 12
    ortho_scale: float = 0.0


@dataclass(frozen=True)
class Roi:
    """Mirrors ``hp_roi_desc`` (hp.h:100-105)."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0


@dataclass(frozen=True)
class SamplingConfig:
    """Mirrors ``hp_sampling_desc`` (hp.h:72-76)."""

    dt: float = 0.0
    max_steps: int = 0
    mode: SamplingMode = SamplingMode.FIXED


@dataclass(frozen=True)
class PlanConfig:
    """Mirrors ``hp_plan_desc`` (hp.h:107-118). Raw, pre-validation."""

    width: int = 0
    height: int = 0
    t_near: float = 0.0
    t_far: float = 0.0
    max_rays: int = 0
    max_samples: int = 0
    seed: int = 0
    camera: CameraConfig = field(default_factory=CameraConfig)
    roi: Roi = field(default_factory=Roi)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)


@dataclass(frozen=True)
class Plan:
    """A validated plan with all defaults applied.

    Use :meth:`Plan.create` - the analogue of ``hp_plan_create``. All fields
    are plain Python scalars/tuples, so a Plan is hashable and directly usable
    as a jit static argument / executable-cache key.
    """

    width: int
    height: int
    t_near: float
    t_far: float
    max_rays: int
    max_samples: int
    seed: int
    camera: CameraConfig
    roi: Roi
    sampling: SamplingConfig

    @staticmethod
    def create(config: PlanConfig) -> "Plan":
        """Validate and default a :class:`PlanConfig`.

        Raises :class:`DvrenError` with ``INVALID_ARGUMENT`` on the same
        conditions ``hp_plan_create`` rejects (hp_runtime.cpp:45-146).
        """
        check(config.width > 0 and config.height > 0,
              "plan width/height must be positive")
        check(config.t_far > config.t_near,
              "plan t_far must be greater than t_near")

        cam = config.camera
        model = cam.model
        if model not in (CameraModel.PINHOLE, CameraModel.ORTHOGRAPHIC):
            model = CameraModel.PINHOLE

        check(len(cam.k) == 9, "camera.k must have 9 elements")
        check(len(cam.c2w) == 12, "camera.c2w must have 12 elements")
        k = list(float(v) for v in cam.k)
        if all(v == 0.0 for v in k):
            k[0] = 1.0
            k[4] = 1.0
            k[8] = 1.0
            k[2] = float(config.width) * 0.5
            k[5] = float(config.height) * 0.5
        if k[0] == 0.0:
            k[0] = 1.0
        if k[4] == 0.0:
            k[4] = 1.0

        c2w = tuple(float(v) for v in cam.c2w)
        if all(v == 0.0 for v in c2w):
            c2w = _IDENTITY_C2W

        ortho_scale = float(cam.ortho_scale)
        if model == CameraModel.ORTHOGRAPHIC and ortho_scale <= 0.0:
            ortho_scale = 1.0

        camera = CameraConfig(model=model, k=tuple(k), c2w=c2w,
                              ortho_scale=ortho_scale)

        roi = config.roi
        if roi.width == 0 or roi.height == 0:
            roi = Roi(x=0, y=0, width=config.width, height=config.height)
        check(roi.x + roi.width <= config.width
              and roi.y + roi.height <= config.height,
              "roi does not fit inside the frame")

        roi_rays = roi.width * roi.height
        max_rays = config.max_rays
        if max_rays == 0:
            max_rays = min(roi_rays, _UINT32_MAX)
        check(roi_rays <= max_rays, "roi ray count exceeds max_rays")

        sampling = config.sampling
        dt = float(sampling.dt)
        if not dt > 0.0:
            span = config.t_far - config.t_near
            default_dt = span / 64.0 if span > 0.0 else 1.0
            dt = default_dt if default_dt > 0.0 else 1.0
        max_steps = sampling.max_steps
        if max_steps == 0:
            max_steps = 64
        mode = sampling.mode
        if mode not in (SamplingMode.FIXED, SamplingMode.STRATIFIED):
            mode = SamplingMode.FIXED
        sampling = SamplingConfig(dt=dt, max_steps=max_steps, mode=mode)

        max_samples = config.max_samples
        if max_samples == 0:
            suggested = max_rays * max_steps
            bounded = min(suggested, _UINT32_MAX)
            max_samples = max_rays if bounded == 0 else bounded
        check(max_samples >= max_rays, "max_samples must be >= max_rays")

        return Plan(
            width=int(config.width),
            height=int(config.height),
            t_near=float(config.t_near),
            t_far=float(config.t_far),
            max_rays=int(max_rays),
            max_samples=int(max_samples),
            seed=int(config.seed),
            camera=camera,
            roi=roi,
            sampling=sampling,
        )

    # -- derived static quantities ------------------------------------------

    @property
    def ray_count(self) -> int:
        """Number of generated rays: the ROI area (static)."""
        return self.roi.width * self.roi.height

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    @property
    def sample_lattice_shape(self) -> tuple[int, int]:
        """Dense ``(num_rays, max_steps)`` sample-lattice shape.

        The TPU-native replacement for the reference's ragged
        ``ray_offset`` packing (hp.h:135): XLA requires static shapes, so
        every ray owns ``max_steps`` slots and a validity mask marks the
        live samples.
        """
        return (self.ray_count, self.sampling.max_steps)

    def descriptor(self) -> PlanConfig:
        """Return the normalized descriptor (analogue of hp_plan_get_desc)."""
        return PlanConfig(
            width=self.width,
            height=self.height,
            t_near=self.t_near,
            t_far=self.t_far,
            max_rays=self.max_rays,
            max_samples=self.max_samples,
            seed=self.seed,
            camera=self.camera,
            roi=self.roi,
            sampling=self.sampling,
        )

    def with_camera(self, camera: CameraConfig) -> "Plan":
        """Return a plan with replaced (already-validated) camera params."""
        return replace(self, camera=camera)
