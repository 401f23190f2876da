"""Serialisation of fields in the JAX package's ``.npz`` format."""

from dvren_tpu_torch.io.checkpoint import (load_dense_grid, load_hash_mlp,
                                           save_dense_grid, save_hash_mlp)

__all__ = ["load_dense_grid", "load_hash_mlp", "save_dense_grid",
           "save_hash_mlp"]
