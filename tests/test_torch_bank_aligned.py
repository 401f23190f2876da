"""``build_tiled_schedule(bank_aligned=True)`` against dvren_tpu, on the CPU.

A run that would straddle a bank boundary starts at the next bank
(``dvren_tpu/render/tiled.py:871-890``). Same seeded inputs through both
packages (tests/test_tiled.py's scene, 48x32 over 8^3, stratified). Held:

- the schedule equal to JAX's array for array, bank0's ALIGNED bit (30)
  included, at 16 and 8 px cells, 16 px supercells, pitch 2 and quantized
  shapes;
- the packing moves runs (the lane maps differ; as many runs or more
  carry the bit);
- the frame, the grid gradients and the camera gradients through
  ``render_tiled`` (the K1 / K2 twins here) equal the dense packing's bit
  for bit.

tests/test_torch_cuda.py holds K1 / K2 on the card to the same equality.
"""

import functools

import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

from dvren_tpu_torch.ops.raygen import camera_arrays
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

FORMS = {
    "cell16": dict(),
    "cell8": dict(tile_px=8),
    "super16": dict(cell_scale=2),
    "pitch2": dict(pitch=2),
    "quant": dict(quantize=True),
}


@functools.lru_cache(maxsize=None)
def inputs():
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED)
    return plan, field, port_plan(plan), port_field(field)


@functools.lru_cache(maxsize=None)
def schedules(form):
    """(JAX's aligned, the port's aligned, the port's dense) schedules."""
    plan, field, pp, pf = inputs()
    jitter = plan_jitter_table(plan)
    kw = FORMS[form]
    ref = j_tiled.build_tiled_schedule(plan, field, jitter=jitter,
                                       device=False, bank_aligned=True, **kw)
    got = p_tiled.build_tiled_schedule(pp, pf, bank_aligned=True, **kw)
    dense = p_tiled.build_tiled_schedule(pp, pf, **kw)
    return ref, got, dense


def bank0_of(sched):
    return np.concatenate([np.asarray(g.bank0).reshape(-1)
                           for g in sched.groups])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_schedule_equals_jax(form):
    ref, got, _ = schedules(form)
    assert_schedules_equal(ref, got)
    np.testing.assert_array_equal(bank0_of(got), bank0_of(ref))


@pytest.mark.parametrize("form", ["cell16", "cell8", "pitch2"])
def test_packing_moves_runs(form):
    """Runs move to bank starts (the lane maps differ from the dense
    packing's), and at least as many runs carry the ALIGNED bit."""
    _, got, dense = schedules(form)
    assert not np.array_equal(got.hostmap_all, dense.hostmap_all)
    aligned = ((bank0_of(got) >> 30) & 1).sum()
    assert aligned > 0
    assert aligned >= ((bank0_of(dense) >> 30) & 1).sum()


def frame_and_grads(sched):
    _, _, pp, pf = inputs()
    f = pf.with_params(pf.sigma.detach().clone().requires_grad_(),
                       pf.color.detach().clone().requires_grad_())
    k, c2w, _ = camera_arrays(pp, "cpu")
    k.requires_grad_(True)
    c2w.requires_grad_(True)
    planes = p_tiled.render_tiled(pp, f, sched.to("cpu"), k=k, c2w=c2w)
    img = planes.image
    loss = torch.sum(img * 0.001 + img ** 2 * 0.01)
    grads = torch.autograd.grad(loss, (f.sigma, f.color, c2w, k))
    return (planes.image.detach(), planes.transmittance.detach(),
            planes.opacity.detach(), planes.depth.detach()) + grads


@pytest.mark.parametrize("form", sorted(FORMS))
def test_frame_and_gradients_equal_the_dense_packing(form):
    _, got, dense = schedules(form)
    a, b = frame_and_grads(got), frame_and_grads(dense)
    names = ("image", "T", "opacity", "depth", "d_sigma", "d_color",
             "d_c2w", "d_k")
    for name, x, y in zip(names, a, b):
        assert torch.equal(x, y), name
    assert float(a[4].abs().max()) > 0.0
