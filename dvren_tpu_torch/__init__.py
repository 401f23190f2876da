"""dvren_tpu_torch: the PyTorch/CUDA port of dvren_tpu.

A second package beside the JAX reference ``dvren_tpu``, with the same
module paths and names. It imports torch and numpy, never jax and never
``dvren_tpu``. Plain tensor code is PyTorch; every Pallas kernel of the
reference becomes a CUDA kernel written by hand for Hopper (``csrc/``,
built at first use by :mod:`dvren_tpu_torch._build`), each with a plain
PyTorch twin that runs on the CPU.

Ported so far: the dense-grid tiled forward render through
:meth:`Renderer.forward` (see ROADMAP.md for what follows).
"""

from dvren_tpu_torch.version import __version__

from dvren_tpu_torch.core.status import Status, StatusCode, DvrenError
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
from dvren_tpu_torch.fields.dense_grid import DenseGridConfig, DenseGridField
from dvren_tpu_torch.render.renderer import (
    ForwardResult,
    Renderer,
    RenderOptions,
    RenderStats,
)

__all__ = [
    "__version__",
    "Status",
    "StatusCode",
    "DvrenError",
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
    "DenseGridConfig",
    "DenseGridField",
    "Renderer",
    "RenderOptions",
    "RenderStats",
    "ForwardResult",
]
