from dvren_tpu_torch.core.status import Status, StatusCode, DvrenError, check
from dvren_tpu_torch.core.context import Context, ContextOptions
from dvren_tpu_torch.core.plan import (
    CameraConfig,
    CameraModel,
    InterpMode,
    OobPolicy,
    Plan,
    PlanConfig,
    Roi,
    SamplingConfig,
    SamplingMode,
)

__all__ = [
    "Status",
    "StatusCode",
    "DvrenError",
    "check",
    "Context",
    "ContextOptions",
    "CameraConfig",
    "CameraModel",
    "InterpMode",
    "OobPolicy",
    "Plan",
    "PlanConfig",
    "Roi",
    "SamplingConfig",
    "SamplingMode",
]
