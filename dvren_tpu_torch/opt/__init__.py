from dvren_tpu_torch.opt.fit import mse, psnr

__all__ = ["mse", "psnr"]
