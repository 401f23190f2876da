from dvren_tpu_torch.ops.compose import ImagePlanes

__all__ = ["ImagePlanes"]
