"""The samples K7f and K7b process, counted on the CPU.

``chip_smoke.py`` bounds K7f and K7b by the samples they process: each
ray's steps before its stop (transmittance at most ``stop``) or the end
of its live lattice. ``hash_tiles.processed_steps`` counts them from the
sigma head's optical-depth prefix (K7b's pass-1 bound); the plain twin of
K7f counts the steps whose weight its recurrence takes. The two agree ray
for ray on the small hash scenes (``tests/test_hash_tiled.py``'s plans),
also where rays stop early, and ``chip_smoke.hash_processed`` sums the
first. ``chip_smoke.live_samples`` counts the mask bits of the dense
path's u16 sample blocks and refuses the hash schedule's float32 sample
depths, which carry no mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
import dvren_tpu_torch as P
from dvren_tpu_torch.ops import hash_tiles
from dvren_tpu_torch.render import hash_tiled

SCENES = ("fixed", "stratified", "roi", "l8", "opaque")


def hash_scene(name):
    """24x20 plans, 24 steps (the ROI case 40x24), a seeded field;
    "l8" the L=8 / T=128 spec, "opaque" stops its rays early."""
    spec = (P.HashMLPSpec(n_levels=8, table_size=128, base_resolution=2.0,
                          finest_resolution=48.0)
            if name == "l8" else P.HashMLPSpec())
    width, height, roi = 24, 20, P.Roi()
    if name == "roi":
        width, height, roi = 40, 24, P.Roi(x=3, y=2, width=21, height=17)
    mode = (P.SamplingMode.FIXED if name in ("fixed", "roi")
            else P.SamplingMode.STRATIFIED)
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.2, t_far=1.8, seed=11, roi=roi,
        sampling=P.SamplingConfig(dt=0.05, max_steps=24, mode=mode)))
    flat = np.random.default_rng(5).uniform(
        -0.5, 0.5, spec.param_count).astype(np.float32)
    if name == "opaque":
        flat[spec.hash_table_size + spec.sigma_weights_size
             + spec.hidden_dim] = 60.0          # sigma_b2
    field = P.HashMLPField.create(P.HashMLPConfig(spec=spec, params=flat),
                                  device="cpu")
    sched = hash_tiled.build_hash_schedule(plan, device="cpu")
    prm = hash_tiles.hash_tile_params(plan, spec, sched.n_chunks)
    params = dict(field.params)
    return plan, (sched.samp, sched.rayt,
                  params["hash_table"].detach().contiguous(),
                  hash_tiles.pack_mlp_scalars(params, spec).detach(), prm)


@pytest.mark.parametrize("name", SCENES)
def test_processed_count_equals_the_twins(name):
    plan, args = hash_scene(name)
    with torch.no_grad():
        counts = hash_tiles.processed_steps(*args)
        out, twin = hash_tiles.hash_tile_forward_plain(*args,
                                                       return_counts=True)
    assert torch.equal(counts, twin)
    assert torch.equal(out, hash_tiles.hash_tile_forward_plain(*args))
    assert cs.hash_processed(hash_tiles, *args) == int(twin.sum())
    lattice = args[0].shape[0] * 256 * plan.sampling.max_steps
    total = int(counts.sum())
    if name == "opaque":
        assert 0 < total < lattice // 4
    else:
        assert total == lattice          # no ray stops early
    assert int(counts.max()) <= plan.sampling.max_steps


def test_processed_count_stops_where_the_twin_stops():
    """A ray's count is its first step with T <= stop: the twin's
    processed optical depth (head 4) is the sum over exactly those
    steps."""
    _, (samp, rayt, table, sc, prm) = hash_scene("opaque")
    with torch.no_grad():
        counts = hash_tiles.processed_steps(samp, rayt, table, sc, prm)
        no_stop = hash_tiles.processed_steps(
            samp, rayt, table, sc, dataclasses.replace(prm, stop=0.0))
    assert bool((counts < no_stop).any())
    assert bool((counts <= no_stop).all())


def test_live_samples_refuses_float_blocks():
    _, (samp, *_rest) = hash_scene("fixed")
    assert samp.dtype == torch.float32
    with pytest.raises(TypeError):
        cs.live_samples(samp)
    with pytest.raises(TypeError):
        cs.live_samples(samp.view(torch.int16))
    block = torch.zeros((2, 1, 3, 16, 128), dtype=torch.int16)
    block[0, 0, 2, 3, :5] = -1          # bit 15 of the lane plane
    block[1, 0, 1, 0, :7] = -1          # another plane: not counted
    assert cs.live_samples(block.view(torch.uint16)) == 5
