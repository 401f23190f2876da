"""The posed tile schedule's device build in one launch (``csrc/posed_build.cu``).

:func:`posed_build` writes every array of a pose's one-group tile
schedule (the sample words, the cell bases, the ray planes, bank0,
k_enter, the hostmap) and the pin diagnostics from the pose's rays, in
one kernel launch with one block per 16x16 tile. Its plain twin is the
torch build of :class:`~dvren_tpu_torch.render.posed.PosedRenderer`
(``use_kernel=False``, or any CPU field): the kernel's arrays equal the
twin's bit for bit (the kernel's source says how). The kernel runs on
CUDA tensors only; the wrapper raises for anything else.
"""

from __future__ import annotations

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.core.status import check

LANES = 128        # lanes a bank
RAYS = 256         # rays of a 16x16 tile
SMEM_MAX = 232448  # dynamic shared memory a block may use on the H100


def smem_bytes(nc: int, ez: int) -> int:
    """The kernel's dynamic shared memory for ``nc`` chunks of ``ez``
    slices: four words a chunk and five a slice."""
    return (4 * nc + 5 * nc * ez) * 4


def posed_build(origins: torch.Tensor, directions: torch.Tensor,
                jitter: torch.Tensor | None, *, tiles_x: int, n_tiles: int,
                k_max: int, nc: int, nb: int, ez: int, grid: tuple,
                consts: tuple) -> tuple:
    """Build one pose's schedule arrays on the card.

    ``origins`` / ``directions``: (H * W, 3) float32 rays in row-major
    pixel order (any strides); ``jitter``: the (T, K, 256) tile-major
    jitter table, or None for the fixed half-step; ``grid``: (nz, ny,
    nx); ``consts``: (t_near, t_far, dt, nudge, lo (3,), inv (3,)) as
    float32-exact Python floats. Returns (samp (T, nc, 3, 16, 128)
    uint16, base (T, nb, 3, 128) float32, rayt (T, 12, 128) float32,
    bank0 (T, nc, 1) int32, k_enter (T,) int32, hostmap (T * nb * 128,)
    int32, diagnostics (4,) int32)."""
    dev = origins.device
    check(dev.type == "cuda", f"posed_build runs on the card, got {dev}")
    n_rays = n_tiles * RAYS
    for name, x in (("origins", origins), ("directions", directions)):
        check(x.dtype == torch.float32 and x.device == dev
              and tuple(x.shape) == (n_rays, 3),
              f"posed_build: {name} must be ({n_rays}, 3) float32 on {dev}")
    if jitter is not None:
        check(jitter.dtype == torch.float32 and jitter.device == dev
              and tuple(jitter.shape) == (n_tiles, k_max, RAYS)
              and jitter.is_contiguous(),
              f"posed_build: jitter must be ({n_tiles}, {k_max}, {RAYS}) "
              f"contiguous float32 on {dev}")
    check(n_tiles % tiles_x == 0 and k_max % 8 == 0 and nc >= 1
          and nb >= 1 and ez >= 1,
          "posed_build: bad tile, step or pin counts")
    check(smem_bytes(nc, ez) <= SMEM_MAX,
          f"posed_build: nc_pin={nc} x ez_pin={ez} needs "
          f"{smem_bytes(nc, ez)} bytes of shared memory a block, over "
          f"the card's {SMEM_MAX}")
    nz, ny, nx = (int(v) for v in grid)
    t_near, t_far, dt, nudge, lo, inv = consts

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    samp = empty(n_tiles, nc, 3, 16, LANES, dtype=torch.uint16)
    base = empty(n_tiles, nb, 3, LANES, dtype=torch.float32)
    rayt = empty(n_tiles, 12, LANES, dtype=torch.float32)
    bank0 = empty(n_tiles, nc, 1)
    k_enter = empty(n_tiles)
    hostmap = empty(n_tiles * nb * LANES)
    diag = empty(4)
    with torch.cuda.device(dev):
        code = _build.library().dvt_posed_build(
            origins.data_ptr(), origins.stride(0), origins.stride(1),
            directions.data_ptr(), directions.stride(0),
            directions.stride(1),
            None if jitter is None else jitter.data_ptr(),
            samp.data_ptr(), base.data_ptr(), rayt.data_ptr(),
            bank0.data_ptr(), k_enter.data_ptr(), hostmap.data_ptr(),
            diag.data_ptr(), n_tiles, tiles_x, k_max, nc, nb, ez, nx, ny,
            nz, t_near, t_far, dt, nudge, *lo, *inv, _build.stream_ptr(dev))
    _build.check(code, "dvt_posed_build")
    posed_build.launches += 1
    return samp, base, rayt, bank0, k_enter, hostmap, diag


posed_build.launches = 0
