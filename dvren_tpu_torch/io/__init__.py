"""Serialisation: fields and training state in the JAX package's ``.npz``
format, the CLI's JSON render config and PPM images."""

from dvren_tpu_torch.io.checkpoint import (load_dense_grid, load_hash_mlp,
                                           load_train_state, save_dense_grid,
                                           save_hash_mlp, save_train_state)
from dvren_tpu_torch.io.config import (RenderConfig, parse_config,
                                       parse_config_file)
from dvren_tpu_torch.io.ppm import read_ppm, write_ppm

__all__ = ["RenderConfig", "parse_config", "parse_config_file", "read_ppm",
           "write_ppm", "load_dense_grid", "load_hash_mlp",
           "load_train_state", "save_dense_grid", "save_hash_mlp",
           "save_train_state"]
