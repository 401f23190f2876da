from dvren_tpu_torch.opt.fit import (FitConfig, FitResult, fit_dense_grid,
                                    fit_hash_mlp, mse, psnr, view_plans)

__all__ = ["FitConfig", "FitResult", "fit_dense_grid", "fit_hash_mlp", "mse",
           "psnr", "view_plans"]
