from dvren_tpu_torch.opt.fit import (FitConfig, FitResult, fit_dense_grid,
                                    fit_hash_mlp, make_train_step, mse, psnr,
                                    render_views, view_plans)

__all__ = ["FitConfig", "FitResult", "fit_dense_grid", "fit_hash_mlp",
           "make_train_step", "mse", "psnr", "render_views", "view_plans"]
