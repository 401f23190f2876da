"""dvren_tpu_torch: the PyTorch/CUDA port of dvren_tpu.

A second package beside the JAX reference ``dvren_tpu``, with the same
module paths and names. It imports torch and numpy, never jax and never
``dvren_tpu``. Plain tensor code is PyTorch; every Pallas kernel of the
reference becomes a CUDA kernel written by hand for Hopper (``csrc/``,
built at first use by :mod:`dvren_tpu_torch._build`), each with a plain
PyTorch twin that runs on the CPU.

Ported: every mode of the JAX package's :class:`Renderer` outside graph
capture. On a CUDA context the tiled paths are the default for the fields
they take (dense grids in float32, bfloat16 or float16 tables, sparse
brick fields, hash-MLP fields); the windowed, streamed, fused and staged
paths over the per-ray integrator, and override ray bundles with the
compose of rays that share pixels, run on any device, with their
gradients (:meth:`Renderer.backward`, :mod:`dvren_tpu_torch.ops.diff`) and
the parity views. Training: autograd of the render functions,
:func:`dvren_tpu_torch.opt.fit.fit_dense_grid`, ``fit_hash_mlp`` and
``render_views``; across devices, :mod:`dvren_tpu_torch.parallel` over
``torch.distributed`` (see ROADMAP.md for what follows).
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
from dvren_tpu_torch.fields.hash_mlp import HashMLPConfig, HashMLPField
from dvren_tpu_torch.fields.sparse_grid import SparseGridField
from dvren_tpu_torch.ops.hashmlp import HashMLPSpec
from dvren_tpu_torch.render.renderer import (
    BackwardResult,
    ForwardResult,
    Renderer,
    RenderOptions,
    RenderStats,
    WorkspaceInfo,
)
from dvren_tpu_torch.render.windowed import (
    WindowedSchedule,
    build_schedule,
    render_windowed,
    render_windowed_traced,
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
    "HashMLPConfig",
    "HashMLPField",
    "SparseGridField",
    "HashMLPSpec",
    "Renderer",
    "RenderOptions",
    "RenderStats",
    "ForwardResult",
    "BackwardResult",
    "WorkspaceInfo",
    "WindowedSchedule",
    "build_schedule",
    "render_windowed",
    "render_windowed_traced",
]
