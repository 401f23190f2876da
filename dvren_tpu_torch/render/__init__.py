from dvren_tpu_torch.render.renderer import (
    BackwardResult,
    ForwardResult,
    Renderer,
    RenderOptions,
    RenderStats,
)

__all__ = ["Renderer", "RenderOptions", "RenderStats", "ForwardResult",
           "BackwardResult"]
