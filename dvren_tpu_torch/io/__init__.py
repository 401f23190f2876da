"""Serialisation of fields and training state in the JAX package's
``.npz`` format."""

from dvren_tpu_torch.io.checkpoint import (load_dense_grid, load_hash_mlp,
                                           load_train_state, save_dense_grid,
                                           save_hash_mlp, save_train_state)

__all__ = ["load_dense_grid", "load_hash_mlp", "load_train_state",
           "save_dense_grid", "save_hash_mlp", "save_train_state"]
