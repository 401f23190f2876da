"""Multi-device rendering and training over ``torch.distributed``: the
counterpart of ``dvren_tpu/parallel/``. One rank is one process and one
device (:mod:`dvren_tpu_torch.parallel.mesh`); the decompositions are in
:mod:`dvren_tpu_torch.parallel.shard`, the multi-device check in
:mod:`dvren_tpu_torch.parallel.dryrun`."""

from dvren_tpu_torch.parallel.mesh import (Mesh, batch_sharded, launch,
                                           make_mesh, replicated)
from dvren_tpu_torch.parallel.shard import (
    fit_dense_grid_dp,
    fit_dense_grid_tile_dp,
    make_dp_train_step,
    make_tile_dp_multiview_step,
    make_tile_dp_train_step,
    merged_global_tile_ids,
    rank_schedule,
    render_sharded,
    render_tiled_sharded,
    render_zsharded,
    shard_tiled_schedule,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "replicated",
    "batch_sharded",
    "launch",
    "render_sharded",
    "make_dp_train_step",
    "fit_dense_grid_dp",
    "render_zsharded",
    "shard_tiled_schedule",
    "rank_schedule",
    "render_tiled_sharded",
    "make_tile_dp_train_step",
    "merged_global_tile_ids",
    "make_tile_dp_multiview_step",
    "fit_dense_grid_tile_dp",
]
