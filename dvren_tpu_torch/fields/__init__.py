from dvren_tpu_torch.fields.dense_grid import DenseGridConfig, DenseGridField
from dvren_tpu_torch.fields.hash_mlp import HashMLPConfig, HashMLPField
from dvren_tpu_torch.fields.sparse_grid import SparseGridField

__all__ = ["DenseGridConfig", "DenseGridField", "HashMLPConfig",
           "HashMLPField", "SparseGridField"]
