from dvren_tpu_torch.render.pipeline import RenderOutputs, render, render_image
from dvren_tpu_torch.render.renderer import (
    BackwardResult,
    ForwardResult,
    Renderer,
    RenderOptions,
    RenderStats,
    WorkspaceInfo,
)

__all__ = ["RenderOutputs", "render", "render_image", "Renderer",
           "RenderOptions", "RenderStats", "ForwardResult", "BackwardResult",
           "WorkspaceInfo"]
