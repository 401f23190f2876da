"""Frozen byte and operation counts of the tile kernels K1 (forward) and K2
(backward) over one launch, from a schedule's shapes alone.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; scratch a kernel writes and reads back (K2's
optical-depth prefixes) is not counted. A launch covers every tile group
of a schedule: ``shapes`` holds each group's (n_tiles, n_chunks, banks),
``subs`` the sub-tiles of a 16 x 16 block and ``cols`` the columns of a
bank row (32 for the cell stencil, 108 for the supercell stencil).

K1 reads the bank blocks (S_b, cols, 128) f32, the sample words
(S_c, 3, 16, 128) u16, the lane bases (S_b, 3, 128) f32, the ray planes
(T, 12, 128) f32, the entry steps (T,) i32, the window banks (S_c * subs,)
i32, the descriptors (T, 4) i32 and the launch order (T,) i32, and writes
five 16 x 16 f32 heads a tile. K2 reads the same and the heads'
cotangent, and writes a slot row of ``cols`` f32 per lane: (S_b * 128,
cols).

Float operations a live sample (a copy of the counts ``chip_smoke.py``
prices K1 and K2 by): the forward's fractions, corner weights, corner
products and recurrence (116), the backward the forward once more and its
adjoint (105), and a supercell sample 3 more adds.
"""

from __future__ import annotations

LANES = 128
CHUNK_ROWS = 3 * 16 * 128        # u16 sample words a chunk
RAYT_ROWS = 12
DESC_WORDS = 4
HEADS = 5
TILE_PIXELS = 256
FWD_OPS = 116
BWD_OPS = FWD_OPS + 105
SUPER_OPS = 3


def _sizes(shapes):
    t = sum(n for n, _, _ in shapes)
    s_c = sum(n * nc for n, nc, _ in shapes)
    s_b = sum(n * nb for n, _, nb in shapes)
    return t, s_c, s_b


def tile_inputs(shapes, subs: int, cols: int) -> int:
    """Bytes of the arrays both tile kernels read."""
    t, s_c, s_b = _sizes(shapes)
    return (s_b * cols * LANES * 4          # bank blocks
            + s_c * CHUNK_ROWS * 2          # sample words
            + s_b * 3 * LANES * 4           # lane bases
            + t * RAYT_ROWS * LANES * 4     # ray planes
            + t * 4                         # entry steps
            + s_c * subs * 4                # window banks
            + t * DESC_WORDS * 4            # descriptors
            + t * 4)                        # launch order


def heads(shapes) -> int:
    """Bytes of K1's output heads (and of K2's cotangent of them)."""
    t, _, _ = _sizes(shapes)
    return t * HEADS * TILE_PIXELS * 4


def k1_bytes(shapes, subs: int, cols: int) -> int:
    return tile_inputs(shapes, subs, cols) + heads(shapes)


def k2_bytes(shapes, subs: int, cols: int) -> int:
    _, _, s_b = _sizes(shapes)
    return (tile_inputs(shapes, subs, cols) + heads(shapes)
            + s_b * LANES * cols * 4)


def step_ops(live_samples: int, supercell: bool) -> int:
    """Float operations of one forward and one backward over
    ``live_samples`` samples."""
    extra = SUPER_OPS if supercell else 0
    return live_samples * (FWD_OPS + BWD_OPS + 2 * extra)
