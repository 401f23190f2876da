from dvren_tpu_torch.fields.dense_grid import DenseGridConfig, DenseGridField

__all__ = ["DenseGridConfig", "DenseGridField"]
