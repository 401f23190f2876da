"""The packed-table kernels' launch geometry (``packed_transpose.
table_tiling`` for K3 and K5a, ``grad_tiling`` for K4 and
``grad_tiling(..., slot_cols=16)`` for K5b), which the wrappers pass to
the kernels.

On the CPU: every table row (K3, K5a) and every voxel (K4, K5b) falls in
exactly one block; every span a block stages lies where the kernel may
read it; shared memory fits the H100's 227 KB; the headline's 64^3 and
the fine grid's 128^3 give at least two blocks per SM. Then the tables
and their gradients are rebuilt block by block in torch from the spans
and the z-ring the geometry names, as the kernels do (staged planes of
floats or of 16-bit pair words, the ring's two slots of floats or of
pair words, corner sums from 0 in corner order), and compared bit
for bit with the plain twins, in float32, bfloat16 and float16, and, for
one shape, with dvren_tpu (the shift stack and the Pallas transposes in
interpret mode). The kernels themselves are held to the twins on the
card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvren_tpu.ops import grid as j_grid
from dvren_tpu.ops import packed_transpose as j_pt

from dvren_tpu_torch.ops import packed_transpose as p_pt
from dvren_tpu_torch.ops.grid import fullpitch_rows

torch.set_num_threads(1)

# Y = 1, X = 1, X past a run (two spans a slot), ZYX not a multiple of
# the run with a partial last z-chunk (41, 70, 61)
SHAPES = [(1, 1, 1), (2, 2, 2), (1, 1, 2049), (9, 1, 300), (4, 6, 1),
          (5, 7, 9), (3, 17, 40), (41, 70, 61)]
FULL = [(64, 64, 64), (128, 128, 128)]
DTYPES16 = [torch.bfloat16, torch.float16]
K5B_MAX_RUN = 512     # K5b's threads a block (K4's: 256)


def _grid(shape, seed=0):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(-1, 9, shape).astype(np.float32)
    color = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    return torch.from_numpy(sigma), torch.from_numpy(color)


def _planes(sigma, color):
    return [sigma.reshape(-1)] + [color[..., c].reshape(-1)
                                  for c in range(3)]


def _k3_by_blocks(sigma, color):
    """K3 block by block: stage the four (dz, dy) spans as planes
    dy * 8 + ch * 2 + dz, then each row's word q is planes q and 8 + q at
    the row's voxel and the next one."""
    z, y, x = sigma.shape
    n_cells, n_rows = z * y * x, fullpitch_rows(sigma.shape)
    tl = p_pt.table_tiling(sigma.shape)
    planes = _planes(sigma, color)
    out = torch.empty((n_rows, 32), dtype=torch.float32)
    for b in range(tl.blocks):
        stage = torch.zeros((16, tl.stride), dtype=torch.float32)
        for dz in (0, 1):
            for dy in (0, 1):
                src = (tl.span_start(b, dz, dy, y * x, x)
                       + torch.arange(tl.rows + 1))
                ok = src < n_cells
                for ch, plane in enumerate(planes):
                    stage[dy * 8 + ch * 2 + dz, :tl.rows + 1][ok] = \
                        plane[src[ok]]
        v0 = b * tl.rows
        n = min(tl.rows, n_rows - v0)
        for q in range(8):
            for dy in (0, 1):
                for dx in (0, 1):
                    out[v0:v0 + n, 4 * q + dy * 2 + dx] = \
                        stage[dy * 8 + q, dx:dx + n]
    return out


def _k5a_by_blocks(sigma, color, dtype):
    """K5a block by block: stage the four (dz, dy) spans rounded to
    ``dtype`` as 16-bit halves of the pair words of planes dy * 8 + ch * 2
    + dz (value t the low half of word t and the high half of word t - 1,
    in the word before the plane at t = 0), then each row's 16-byte word
    ch is word i of planes 2ch, 8 + 2ch, 2ch + 1 and 9 + 2ch."""
    z, y, x = sigma.shape
    n_cells, n_rows = z * y * x, fullpitch_rows(sigma.shape)
    tl = p_pt.table_tiling(sigma.shape)
    planes = _planes(sigma, color)
    out = torch.empty((n_rows, 16), dtype=torch.int32)
    for b in range(tl.blocks):
        halves = torch.zeros(2 * 16 * tl.stride, dtype=torch.int16)
        for dz in (0, 1):
            for dy in (0, 1):
                src = (tl.span_start(b, dz, dy, y * x, x)
                       + torch.arange(tl.rows + 1))
                ok = src < n_cells
                for ch, plane in enumerate(planes):
                    val = torch.zeros(tl.rows + 1)
                    val[ok] = plane[src[ok]]
                    bits = val.to(dtype).view(torch.int16)
                    dst = (dy * 8 + ch * 2 + dz) * tl.stride + torch.arange(
                        tl.rows + 1)
                    halves[2 * dst] = bits
                    keep = dst > 0
                    halves[2 * dst[keep] - 1] = bits[keep]
        words = halves.view(torch.int32).reshape(16, tl.stride)
        v0 = b * tl.rows
        n = min(tl.rows, n_rows - v0)
        for ch in range(4):
            for k, plane in enumerate((2 * ch, 8 + 2 * ch, 2 * ch + 1,
                                       9 + 2 * ch)):
                out[v0:v0 + n, 4 * ch + k] = words[plane, :n]
    return out


def _ring_by_blocks(tg, shape, tl, stage):
    """K4 / K5b block by block: a ring of two slots marching up z, each
    voxel's corners summed from 0 in corner order from the staged rows;
    ``stage(rows)`` gives the (32, stride) widened values of a slot."""
    z, y, x = shape
    n_cells, yx = z * y * x, y * x
    d_sigma = torch.full((n_cells,), float("nan"))
    d_color = torch.full((n_cells * 3,), float("nan"))

    def stage_slot(p, zi):
        rows = tl.slot_rows(p, zi, yx, x)
        ok = (rows >= 0) & (rows < n_cells)
        return stage(rows, ok)

    for b in range(tl.blocks):
        p, z0, z1 = tl.block_planes(b, z)
        n_valid = min(tl.run, yx - p * tl.run)
        i = torch.arange(n_valid)
        slots = [None, None]
        slots[(z0 + 1) & 1] = stage_slot(p, z0 - 1)
        for zi in range(z0, z1):
            slots[zi & 1] = stage_slot(p, zi)
            cur, prev = slots[zi & 1], slots[(zi + 1) & 1]
            acc = torch.zeros((4, n_valid), dtype=torch.float32)
            for corner in range(8):
                dz, dy, dx = corner >> 2, (corner >> 1) & 1, corner & 1
                ell = (0 if dy else tl.lead) + i + 1 - dx
                src = prev if dz else cur
                acc = acc + src[corner::8][:, ell]
            base = zi * yx + p * tl.run
            d_sigma[base:base + n_valid] = acc[0]
            d_color[3 * base:3 * (base + n_valid)] = acc[1:].T.reshape(-1)
    return d_sigma.reshape(shape), d_color.reshape(shape + (3,))


def _k5b_by_blocks(tg16, shape):
    """K5b block by block: slots of a 16-bit row's 16 pair words as they
    came (word k of channel ch in column ch * 4 + k), a corner widened
    where it is summed (low half for even corners, high for odd)."""
    tl = p_pt.grad_tiling(shape, slot_cols=16)
    pairs = tg16.view(torch.int16).view(torch.int32)     # (R, 16)

    def stage(rows, ok):
        words = torch.zeros((16, tl.stride), dtype=torch.int32)
        words[:, :tl.span][:, ok] = pairs[rows[ok]].T
        lo = (words & 0xFFFF).to(torch.int16)
        hi = ((words >> 16) & 0xFFFF).to(torch.int16)
        # column ch * 8 + corner: word ch * 4 + corner // 2, half corner % 2
        return torch.stack((lo, hi), dim=1).reshape(32, tl.stride).view(
            tg16.dtype).float()

    return _ring_by_blocks(tg16, shape, tl, stage)


def _k4_by_blocks(tg, shape):
    """K4 block by block: a ring of two slots marching up z, each voxel's
    corners summed from 0 in corner order from the staged rows."""
    tl = p_pt.grad_tiling(shape)

    def stage(rows, ok):
        slot = torch.zeros((32, tl.stride), dtype=torch.float32)
        slot[:, :tl.span][:, ok] = tg[rows[ok]].T
        return slot

    return _ring_by_blocks(tg, shape, tl, stage)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k3_blocks_cover_every_row_once(shape):
    tl = p_pt.table_tiling(shape)
    n_rows = fullpitch_rows(shape)
    seen = torch.zeros(n_rows, dtype=torch.int64)
    for b in range(tl.blocks):
        v0 = b * tl.rows
        assert v0 < n_rows
        seen[v0:v0 + tl.rows] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k4_blocks_cover_every_voxel_once(shape):
    z, y, x = shape
    tl = p_pt.grad_tiling(shape)
    assert tl.runs * tl.run >= y * x > (tl.runs - 1) * tl.run
    seen = torch.zeros(z * y * x, dtype=torch.int64)
    for b in range(tl.blocks):
        p, z0, z1 = tl.block_planes(b, z)
        assert z0 < z1 <= z
        n_valid = min(tl.run, y * x - p * tl.run)
        for zi in range(z0, z1):
            base = zi * y * x + p * tl.run
            seen[base:base + n_valid] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k3_spans_in_range(shape):
    """Each (dz, dy) span starts in the grid's flat index range and holds
    every source v + off its block's rows read, at staged index i + dx <=
    rows < stride; the kernel masks the reads past n_cells."""
    z, y, x = shape
    tl = p_pt.table_tiling(shape)
    assert tl.stride >= tl.rows + 1 and tl.stride % 32 == 4
    assert tl.smem_bytes == 16 * tl.stride * 4 <= p_pt.SMEM_LIMIT
    i = torch.arange(tl.rows)
    for b in sorted({0, tl.blocks // 2, tl.blocks - 1}):
        v = b * tl.rows + i
        for dz in (0, 1):
            for dy in (0, 1):
                start = tl.span_start(b, dz, dy, y * x, x)
                assert start >= 0
                for dx in (0, 1):
                    staged = v + dz * y * x + dy * x + dx - start
                    assert int(staged.min()) >= 0
                    assert int(staged.max()) <= tl.rows < tl.stride


@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k4_slots_in_range(shape):
    """Each voxel's staged index holds row v - off, and the index lies in
    the slot; the rows a slot stages from the table lie in it."""
    z, y, x = shape
    n_cells, yx = z * y * x, y * x
    tl = p_pt.grad_tiling(shape)
    assert tl.lead == min(x, tl.run + 1)
    assert tl.span == tl.lead + tl.run + 1 <= tl.stride and tl.stride % 2
    assert tl.smem_bytes == (2 * 32 * tl.stride + 3 * tl.run) * 4
    assert tl.smem_bytes <= p_pt.SMEM_LIMIT
    i = torch.arange(tl.run)
    for b in sorted({0, tl.runs - 1, tl.blocks - 1}):
        p, z0, z1 = tl.block_planes(b, z)
        for zi in (z0, z1 - 1):
            rows = tl.slot_rows(p, zi, yx, x)
            prev = tl.slot_rows(p, zi - 1, yx, x)
            v = zi * yx + p * tl.run + i
            for corner in range(8):
                dz, dy, dx = corner >> 2, (corner >> 1) & 1, corner & 1
                ell = (0 if dy else tl.lead) + i + 1 - dx
                assert int(ell.min()) >= 0 and int(ell.max()) < tl.span
                got = (prev if dz else rows)[ell]
                assert torch.equal(got, v - (dz * yx + dy * x + dx))
            staged = rows[(rows >= 0) & (rows < n_cells)]
            assert staged.numel() == 0 or (int(staged.min()) >= 0 and
                                           int(staged.max()) < n_cells)


@pytest.mark.parametrize("shape", FULL)
def test_full_grids_fill_the_card(shape):
    k3, k4 = p_pt.table_tiling(shape), p_pt.grad_tiling(shape)
    assert k3.blocks >= 2 * p_pt.N_SMS and k4.blocks >= 2 * p_pt.N_SMS
    # the ring reads a row about (run + X + 1) / run times, the chunk's
    # first slot (z_chunk + 1) / z_chunk
    assert k4.z_chunk >= 4 and k4.span / k4.run <= 1.6


def test_partial_shape_is_partial():
    z, y, x = SHAPES[-1]
    tl = p_pt.grad_tiling((z, y, x))
    assert (z * y * x) % tl.run and (y * x) % tl.run
    assert tl.z_chunk > 1 and z % tl.z_chunk
    assert (z * y * x) % p_pt.table_tiling((z, y, x)).rows


@pytest.mark.parametrize("shape", SHAPES)
def test_k3_by_blocks_bit_equal_to_plain(shape):
    sigma, color = _grid(shape, seed=1)
    got = _k3_by_blocks(sigma, color)
    assert torch.equal(_bits(got),
                       _bits(p_pt.build_rows_plain(sigma, color)))


def test_k3_by_blocks_moves_special_values():
    """inf, NaN with payloads and -0.0 pass as 32-bit words."""
    shape = (3, 17, 40)
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, size=4 * 3 * 17 * 40, dtype=np.uint64)
    words = words.astype(np.uint32)
    words[::7] = 0x80000000                     # -0.0
    words[1::11] = 0x7F800000                   # inf
    words[2::13] = 0xFF800000                   # -inf
    words[3::5] = 0x7FC00000 | (np.arange(words[3::5].size) & 0x3FFFFF)
    floats = torch.from_numpy(words.view(np.float32))
    sigma = floats[:3 * 17 * 40].reshape(shape)
    color = floats[3 * 17 * 40:].reshape(shape + (3,))
    got = _k3_by_blocks(sigma, color)
    assert torch.equal(_bits(got),
                       _bits(p_pt.build_rows_plain(sigma, color)))


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_by_blocks_bit_equal_to_plain(shape):
    rows = fullpitch_rows(shape)
    tg = torch.from_numpy(np.random.default_rng(2).normal(
        size=(rows, 32)).astype(np.float32))
    got = _k4_by_blocks(tg, shape)
    want = p_pt.table_grad_to_params_plain(tg, shape)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def test_k3_k4_by_blocks_equal_to_reference():
    """The block-by-block table against JAX's shift stack and
    ``stack_to_u16_rows`` (hi << 16 | lo), and the block-by-block gradient
    against ``stack_plane_grads(u16_rows_to_stack(.))``, both Pallas
    kernels interpreted."""
    shape = (5, 7, 9)
    sigma, color = _grid(shape, seed=3)
    rows = j_grid.fullpitch_rows(shape)
    t16 = np.asarray(j_pt.stack_to_u16_rows(j_grid._shift_stack_fullpitch(
        sigma.numpy(), color.numpy(), rows)))
    ref = ((t16[:, :32].astype(np.uint32) << np.uint32(16))
           | t16[:, 32:].astype(np.uint32))
    got = _k3_by_blocks(sigma, color).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)
    x = np.random.default_rng(5).normal(size=(rows, 32)).astype(np.float32)
    want = j_grid.stack_plane_grads(
        j_pt.u16_rows_to_stack(j_grid._split_u16(jnp.asarray(x))), shape)
    for a, b in zip(_k4_by_blocks(torch.from_numpy(x), shape), want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))


# ------------------------------------------------ K5a / K5b (16-bit)

@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k5b_blocks_cover_every_voxel_once(shape):
    z, y, x = shape
    tl = p_pt.grad_tiling(shape, slot_cols=16)
    assert tl.runs * tl.run >= y * x > (tl.runs - 1) * tl.run
    seen = torch.zeros(z * y * x, dtype=torch.int64)
    for b in range(tl.blocks):
        p, z0, z1 = tl.block_planes(b, z)
        assert z0 < z1 <= z
        n_valid = min(tl.run, y * x - p * tl.run)
        for zi in range(z0, z1):
            base = zi * y * x + p * tl.run
            seen[base:base + n_valid] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k5a_pair_words_in_range(shape):
    """K5a's pair word i of a plane holds staged values i and i + 1 <=
    rows < stride; value 0's high-half write lands in the word before its
    plane, the previous plane's padding (stride - 1 >= rows), never in a
    word a row reads; a warp's reads (8 rows x 4 channels) of one (dz, dy)
    hit 32 banks; the stage fits."""
    tl = p_pt.table_tiling(shape)
    assert tl.rows + 1 <= tl.stride and tl.stride % 32 == 4
    assert tl.smem_bytes == 16 * tl.stride * 4 <= p_pt.SMEM_LIMIT
    read = torch.zeros(16 * tl.stride, dtype=torch.bool)
    for plane in range(16):
        read[plane * tl.stride:plane * tl.stride + tl.rows] = True
    pad = torch.arange(1, 16) * tl.stride - 1      # t = 0's high halves
    assert not bool(read[pad].any())
    f = torch.arange(32)                           # a warp's 16-byte words
    for lo in (0, 8 * tl.stride, tl.stride, 9 * tl.stride):
        bank = (lo + (f & 3) * 2 * tl.stride + (f >> 2)) % 32
        assert bank.unique().numel() == 32


@pytest.mark.parametrize("shape", SHAPES + FULL)
def test_k5b_slots_in_range(shape):
    """As K4's slots, with K5b's 16-bit rows: each voxel's staged index
    holds row v - off inside the slot; the stride keeps a warp's
    transposing stores (4 lanes a row, 8 rows) and its sums' reads on 32
    banks; shared memory fits."""
    z, y, x = shape
    n_cells, yx = z * y * x, y * x
    tl = p_pt.grad_tiling(shape, slot_cols=16)
    assert tl.run <= K5B_MAX_RUN and tl.lead == min(x, tl.run + 1)
    assert tl.span == tl.lead + tl.run + 1 <= tl.stride
    assert tl.stride % 4 == 2
    assert tl.smem_bytes == (2 * 16 * tl.stride + 3 * tl.run) * 4
    assert tl.smem_bytes <= p_pt.SMEM_LIMIT
    lane = torch.arange(32)
    piece, ell = lane & 3, lane >> 2
    # store instruction k: column piece * 4 + k, row ell
    bank = (piece * 4 * tl.stride + ell) % 32
    assert bank.unique().numel() == 32
    i = torch.arange(tl.run)
    for b in sorted({0, tl.runs - 1, tl.blocks - 1}):
        p, z0, z1 = tl.block_planes(b, z)
        for zi in (z0, z1 - 1):
            rows = tl.slot_rows(p, zi, yx, x)
            prev = tl.slot_rows(p, zi - 1, yx, x)
            v = zi * yx + p * tl.run + i
            for corner in range(8):
                dz, dy, dx = corner >> 2, (corner >> 1) & 1, corner & 1
                ell = (0 if dy else tl.lead) + i + 1 - dx
                assert int(ell.min()) >= 0 and int(ell.max()) < tl.span
                got = (prev if dz else rows)[ell]
                assert torch.equal(got, v - (dz * yx + dy * x + dx))
            staged = rows[(rows >= 0) & (rows < n_cells)]
            assert staged.numel() == 0 or int(staged.max()) < n_cells


@pytest.mark.parametrize("shape", FULL)
def test_full_grids_fill_the_card_16(shape):
    """K5a's and K5b's launches at 64^3 and 128^3: at least two blocks an
    SM; K5b's 16-bit slots leave room for 4 blocks an SM."""
    k5a, k5b = (p_pt.table_tiling(shape),
                p_pt.grad_tiling(shape, slot_cols=16))
    assert k5a.blocks >= 2 * p_pt.N_SMS and k5b.blocks >= 2 * p_pt.N_SMS
    assert 4 * k5b.smem_bytes <= p_pt.SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES16)
@pytest.mark.parametrize("shape", SHAPES)
def test_k5a_by_blocks_bit_equal_to_plain(shape, dtype):
    sigma, color = _grid(shape, seed=1)
    sigma = sigma * 40.0          # past bfloat16's 8 bits of mantissa
    got = _k5a_by_blocks(sigma, color, dtype)
    want = p_pt.build_rows16_plain(sigma, color, dtype)
    assert torch.equal(got, want.view(torch.int16).view(torch.int32))


@pytest.mark.parametrize("dtype", DTYPES16)
def test_k5a_by_blocks_rounds_special_values(dtype):
    """inf, -0.0, NaN, float16 overflow and subnormals, exact ties."""
    shape = (3, 17, 40)
    n = 3 * 17 * 40
    rng = np.random.default_rng(4)
    v = rng.normal(scale=4.0, size=4 * n).astype(np.float32)
    words = v.view(np.uint32)
    words[::7] = 0x80000000                          # -0.0
    words[1::11] = 0x7F800000                        # inf
    words[2::13] = 0xFFC00001                        # NaN
    words[3::17] = 0x3F808000                        # bfloat16 tie
    v[4::19] = 1.0 + 2.0 ** -11                      # float16 tie
    v[5::23] = 70000.0                               # float16 overflow
    v[6::29] = 3e-6                                  # float16 subnormal
    floats = torch.from_numpy(v)
    sigma = floats[:n].reshape(shape)
    color = floats[n:].reshape(shape + (3,))
    got = _k5a_by_blocks(sigma, color, dtype)
    want = p_pt.build_rows16_plain(sigma, color, dtype)
    assert torch.equal(got, want.view(torch.int16).view(torch.int32))


@pytest.mark.parametrize("dtype", DTYPES16)
@pytest.mark.parametrize("shape", SHAPES)
def test_k5b_by_blocks_bit_equal_to_plain(shape, dtype):
    rows = fullpitch_rows(shape)
    tg16 = torch.from_numpy(np.random.default_rng(2).normal(
        size=(rows, 32)).astype(np.float32)).to(dtype)
    got = _k5b_by_blocks(tg16, shape)
    want = p_pt.table16_grad_to_params_plain(tg16, shape)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES16)
def test_k5a_k5b_by_blocks_equal_to_reference(dtype):
    """The block-by-block 16-bit table against JAX's shift stack cast to
    the type and ``stack_to_rows``, and the block-by-block gradient
    against ``stack_plane_grads(rows_to_stack(ct.astype(float32)))``,
    both Pallas kernels interpreted."""
    shape = (5, 7, 9)
    jdt = jnp.dtype(str(dtype).replace("torch.", ""))
    sigma, color = _grid(shape, seed=3)
    rows = j_grid.fullpitch_rows(shape)
    stack = j_grid._shift_stack_fullpitch(sigma.numpy(), color.numpy(), rows)
    ref = np.asarray(j_pt.stack_to_rows(stack.astype(jdt))).view(np.uint16)
    got = _k5a_by_blocks(sigma, color, dtype).numpy().view(np.uint16)
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)
    ct = np.random.default_rng(5).normal(size=(rows, 32)).astype(np.float32)
    ct16 = jnp.asarray(ct).astype(jdt)
    want = j_grid.stack_plane_grads(
        j_pt.rows_to_stack(ct16.astype(jnp.float32)), shape)
    tg16 = torch.from_numpy(ct).to(dtype)
    assert np.array_equal(tg16.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(ct16).view(np.uint16))
    for a, b in zip(_k5b_by_blocks(tg16, shape), want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))
