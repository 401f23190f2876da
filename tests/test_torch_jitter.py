"""The stratified jitter hashed on the lattice's device, against dvren_tpu,
on the CPU.

``dvren_tpu_torch.ops.rng.stratified_jitter`` (the jitter kernel on CUDA
tensors; here its plain twin) against JAX's host table
(``rng.jitter_table``), its pure-Python oracle (``stratified_jitter_py``)
and its in-graph uint32 emulation (``stratified_jitter``). Held:

- the twin equal to the host table bit for bit, for seeds past 2^63 too;
- equal to ``np.float32(stratified_jitter_py(...))`` bit for bit;
- within one float32 ulp of JAX's ``stratified_jitter``;
- ``generate_samples(jitter=None)`` bit-equal to the table route, with
  ray offsets, a window's step offsets and the clamp of pad rays and
  steps past the table (tests/test_windowed.py's stratified scene);
- ``pipeline.render``, ``render_streamed`` and ``render_windowed`` with no
  table bit-equal to their table routes, and within 5e-6 of JAX's.

tests/test_torch_cuda.py holds the kernel to the twin on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.ops import rng as j_rng
from dvren_tpu.render import pipeline as j_pipe
from tests.test_torch_core import port_field, port_plan
from tests.test_windowed import scene as windowed_scene

from dvren_tpu_torch.ops import rng as p_rng
from dvren_tpu_torch.ops.raygen import generate_rays
from dvren_tpu_torch.ops.sampling import generate_samples
from dvren_tpu_torch.render import pipeline as p_pipe
from dvren_tpu_torch.render import windowed as p_win

torch.set_num_threads(1)

TOL = 5e-6
SEEDS = (0, 3, 12345, 2 ** 63 + 7, 2 ** 64 - 1)


def grid(n_rays, n_steps, ray0=0):
    rays = torch.arange(ray0, ray0 + n_rays, dtype=torch.int64)[:, None]
    steps = torch.arange(n_steps, dtype=torch.int32)[None, :]
    return rays, steps


@pytest.mark.parametrize("seed", SEEDS)
def test_twin_equals_the_host_table(seed):
    rays, steps = grid(300, 70, ray0=11)
    got = p_rng.stratified_jitter(seed, rays, steps)
    want = j_rng.jitter_table(seed, 300, 70, ray_offset=11)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), p_rng.jitter_table(seed, 300, 70, ray_offset=11))


@pytest.mark.parametrize("seed", SEEDS)
def test_twin_equals_the_python_oracle(seed):
    rng = np.random.default_rng(seed % 1000)
    ray = rng.integers(0, 2 ** 31, 64)
    step = rng.integers(0, 2 ** 31, 64)
    got = p_rng.stratified_jitter(seed, torch.from_numpy(ray),
                                  torch.from_numpy(step)).numpy()
    want = np.array([j_rng.stratified_jitter_py(seed, int(r), int(s))
                     for r, s in zip(ray, step)], np.float32)
    np.testing.assert_array_equal(got, want)
    own = np.array([p_rng.stratified_jitter_py(seed, int(r), int(s))
                    for r, s in zip(ray, step)], np.float32)
    np.testing.assert_array_equal(own, want)


@pytest.mark.parametrize("seed", (0, 3, 12345))
def test_twin_within_one_ulp_of_jax_emulation(seed):
    rays, steps = grid(200, 64)
    got = p_rng.stratified_jitter(seed, rays, steps).numpy()
    emu = np.asarray(j_rng.stratified_jitter(
        seed, jnp.asarray(rays.numpy().astype(np.int32)),
        jnp.asarray(steps.numpy())))
    ulp = np.spacing(np.maximum(np.abs(got), np.float32(2 ** -24)))
    assert np.all(np.abs(got - emu) <= ulp)
    assert np.mean(got == emu) > 0.5


def test_mix_seed_matches_the_oracle():
    states = [0, 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1, 0x123456789ABCDEF0]
    signed = [s - 2 ** 64 if s >= 2 ** 63 else s for s in states]
    got = p_rng.mix_seed(torch.tensor(signed, dtype=torch.int64))
    want = [j_rng.mix_seed_py(s) for s in states]
    assert [int(v) & (2 ** 64 - 1) for v in got] == want


def test_bounds_clamp_into_the_table():
    """Rows past the table and negative or late steps take the clamped
    row and column, as the table gather clips them."""
    table = p_rng.jitter_table(9, 10, 6)
    ray = torch.tensor([[-3], [4], [10], [25]])
    step = torch.tensor([[-1, 0, 5, 6, 40]], dtype=torch.int32)
    got = p_rng.stratified_jitter(9, ray, step, bounds=(10, 6)).numpy()
    rows = np.clip(ray.numpy(), 0, 9)
    cols = np.clip(step.numpy(), 0, 5)
    np.testing.assert_array_equal(got, table[rows, cols])


def test_twin_broadcasts_and_keeps_shapes():
    got = p_rng.stratified_jitter(5, torch.tensor(7), torch.arange(12))
    assert got.shape == (12,)
    np.testing.assert_array_equal(got.numpy(),
                                  p_rng.jitter_table(5, 8, 12)[7])
    got3 = p_rng.stratified_jitter(5, torch.arange(4)[:, None, None],
                                   torch.arange(6).reshape(1, 2, 3))
    assert got3.shape == (4, 2, 3)
    np.testing.assert_array_equal(got3.reshape(4, 6).numpy(),
                                  p_rng.jitter_table(5, 4, 6))


def stratified():
    plan, field = windowed_scene(mode=J.SamplingMode.STRATIFIED)
    return plan, field, port_plan(plan), port_field(field)


def lattices_equal(a, b):
    for key in ("t", "dt", "mask", "px", "py", "pz"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key


@pytest.mark.parametrize("form", ["whole", "offset", "window"])
def test_generate_samples_without_table_is_the_table_route(form):
    _, _, pp, _ = stratified()
    table = torch.from_numpy(np.array(p_pipe.plan_jitter_table(pp)))
    n, k = pp.ray_count, pp.sampling.max_steps
    if form == "whole":
        rays = generate_rays(pp, device="cpu")
        got = generate_samples(pp, rays)
        want = generate_samples(pp, rays, jitter=table)
    elif form == "offset":
        rays = generate_rays(pp, start=40, count=64, device="cpu")
        got = generate_samples(pp, rays, ray_index_offset=40)
        rows = torch.clamp(torch.arange(40, 104), max=n - 1)
        want = generate_samples(pp, rays, jitter=table[rows])
    else:   # a window: ids past the frame, steps past max_steps
        ids = torch.tensor([3, 17, n - 1, n + 5, n + 9], dtype=torch.int64)
        ke = torch.tensor([0, 12, k - 4, 0, 7], dtype=torch.int32)
        rays = generate_rays(pp, ids=ids)
        offset = ids - torch.arange(5)
        got = generate_samples(pp, rays, ray_index_offset=offset,
                               step_offset=ke, num_steps=32)
        cols = torch.clamp(ke[:, None] + torch.arange(32)[None, :],
                           max=k - 1)
        rows = torch.clamp(ids, max=n - 1)[:, None]
        want = generate_samples(pp, rays, jitter=table[rows, cols],
                                step_offset=ke, num_steps=32)
    lattices_equal(got, want)


def test_pipeline_render_without_table_matches():
    plan, field, pp, pf = stratified()
    table = p_pipe.plan_jitter_table(pp)
    with torch.no_grad():
        got = p_pipe.render(pp, pf).planes
        want = p_pipe.render(pp, pf, jitter=table).planes
    for key in ("image", "transmittance", "opacity", "depth"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    ref = j_pipe.render(plan, field,
                        jitter=j_pipe.plan_jitter_table(plan)).planes
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image),
                               atol=TOL, rtol=0)


def test_render_streamed_without_table_matches():
    _, _, pp, pf = stratified()
    table = p_pipe.plan_jitter_table(pp)
    tile = 100      # the last block runs past the frame
    with torch.no_grad():
        got = p_pipe.render_streamed(pp, pf, ray_tile=tile)
        want = p_pipe.render_streamed(pp, pf, ray_tile=tile, jitter=table)
    for key in ("image", "transmittance", "opacity", "depth"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key


def test_render_windowed_without_rows_matches():
    """A schedule built without the table hashes each group's jitter on
    the device: the frame and its gradients equal those of the schedule
    that carries the table's rows."""
    plan, field, pp, pf = stratified()
    table = p_pipe.plan_jitter_table(pp)
    bare = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                block=64, device="cpu")
    rows = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                block=64, jitter=table, device="cpu")
    assert all(g[3] is None for g in bare.groups)
    out = []
    for sched in (bare, rows):
        f = pf.with_params(pf.sigma.detach().clone().requires_grad_(),
                           pf.color.detach().clone().requires_grad_())
        img = p_win.render_windowed(pp, f, sched).image
        out.append((img.detach(),) + torch.autograd.grad(
            torch.mean(img ** 2), (f.sigma, f.color)))
    for a, b in zip(*out):
        assert torch.equal(a, b)
