"""K3, the packed-stencil table build, against dvren_tpu.

The port writes the (R, 32) float32 table that the JAX package carries as
u16 hi/lo rows (``packed_transpose.stack_to_u16_rows``, Pallas interpret
mode on the CPU): after ``hi << 16 | lo`` the two must be equal bit for
bit. The CUDA kernel is held to the plain twin on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from dvren_tpu.ops import grid as j_grid
from dvren_tpu.ops import packed_transpose as j_pt

from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.ops import packed_transpose as p_pt

torch.set_num_threads(1)

SHAPES = [(8, 8, 8), (5, 7, 9), (2, 2, 2), (3, 17, 40), (16, 16, 16)]


def _grid(shape, seed=0):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(-1, 9, shape).astype(np.float32)
    color = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    return sigma, color


def _reference_rows(sigma, color) -> np.ndarray:
    rows = j_grid.fullpitch_rows(sigma.shape)
    t16 = np.asarray(j_pt.stack_to_u16_rows(
        j_grid._shift_stack_fullpitch(sigma, color, rows)))
    hi = t16[:, :32].astype(np.uint32) << np.uint32(16)
    return (hi | t16[:, 32:].astype(np.uint32)).view(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_table_bit_equal_to_reference(shape):
    sigma, color = _grid(shape)
    ref = _reference_rows(sigma, color)
    got = p_pt.build_rows_plain(torch.from_numpy(sigma),
                                torch.from_numpy(color)).numpy()
    assert got.shape == ref.shape == (p_grid.fullpitch_rows(shape), 32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_shift_stack_equal_to_reference(shape):
    sigma, color = _grid(shape, seed=1)
    rows = p_grid.fullpitch_rows(shape)
    assert rows == j_grid.fullpitch_rows(shape)
    ref = np.asarray(j_grid._shift_stack_fullpitch(sigma, color, rows))
    got = p_grid._shift_stack_fullpitch(
        torch.from_numpy(sigma), torch.from_numpy(color), rows).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrapper_takes_plain_twin_on_cpu():
    sigma, color = _grid((4, 5, 6))
    before = p_pt.build_rows.launches
    got = p_pt.build_rows(torch.from_numpy(sigma), torch.from_numpy(color))
    assert p_pt.build_rows.launches == before
    assert torch.equal(got, p_pt.build_rows_plain(torch.from_numpy(sigma),
                                                  torch.from_numpy(color)))


def test_wrapper_rejects_bad_inputs():
    sigma = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError):
        p_pt.build_rows(sigma, torch.zeros((4, 4, 4, 2)))
    with pytest.raises(TypeError):
        p_pt.build_rows(sigma.double(), torch.zeros((4, 4, 4, 3)).double())
