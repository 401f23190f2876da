"""The K-step fit block (``make_train_block_scheduled``) against dvren_tpu's,
on the CPU.

JAX scans k optimizer steps in one executable and returns the k losses;
the port runs them in a Python loop and returns them as one tensor. Same
seeded inputs as tests/test_torch_fit.py (its "fit" scene: four 12^2
views of an 8^3 blob, Adam lr 5e-2 from a flat 0.5 field). Held:

- one block of k = 4 in tiled and windowed modes: the four losses within
  rtol 1e-4 of JAX's block and the fitted grids within 1e-4
  (tests/test_torch_fit.py's fit tolerances);
- a block of k steps equals k single steps bit for bit;
- ``fit_dense_grid`` (tiled, windowed, plain) and ``fit_hash_mlp`` with
  ``sync_every=4, steps=10`` sync where JAX's blocks of 4, 4 and 2 end:
  the histories reach the host, and a checkpoint every step fires, at
  steps 4, 8 and 10 only.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dvren_tpu.opt import fit as j_fit
from tests.test_torch_fit import (FIELD_TOL, LOSS_RTOL, fit_config,
                                  flat_init, scene, targets_for)

import dvren_tpu_torch as P
from dvren_tpu_torch.opt import fit as p_fit

torch.set_num_threads(1)

K = 4
LR = 5e-2


def adam(f):
    return torch.optim.Adam(f.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8)


def fresh(pinit):
    return pinit.with_params(pinit.sigma.detach().clone(),
                             pinit.color.detach().clone())


@pytest.mark.parametrize("mode", ["tiled", "windowed"])
def test_block_matches_jax_block(mode):
    plan, _, cams, pplan, _, pcams = scene("fit")
    jinit, pinit = flat_init("fit")
    targets = targets_for("fit", seed=1)
    opt = optax.adam(LR)
    params = (jinit.sigma, jinit.color)
    jblock = j_fit.make_train_block_scheduled(plan, list(cams), jinit, opt,
                                              K, mode=mode)
    params, _, jlosses = jblock(params, jinit, opt.init(params),
                                jnp.asarray(targets))
    trained = fresh(pinit)
    block = p_fit.make_train_block_scheduled(pplan, list(pcams), trained,
                                             adam(trained), K, mode=mode)
    losses = block(trained, torch.from_numpy(targets))
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(trained.sigma.detach().numpy(),
                               np.asarray(params[0]), atol=FIELD_TOL)
    np.testing.assert_allclose(trained.color.detach().numpy(),
                               np.asarray(params[1]), atol=FIELD_TOL)


def test_block_equals_its_steps():
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    _, pinit = flat_init("fit")
    targets = torch.from_numpy(targets_for("fit", seed=1))
    views = p_fit._scheduled_views(pplan, list(pcams), pinit, "windowed")
    a, b = fresh(pinit), fresh(pinit)
    block = p_fit.make_train_block_scheduled(pplan, list(pcams), a, adam(a),
                                             3, mode="windowed", views=views)
    step = p_fit.make_train_step_scheduled(pplan, list(pcams), b, adam(b),
                                           mode="windowed", views=views)
    losses = block(a, targets)
    singles = torch.stack([step(b, targets) for _ in range(3)])
    assert torch.equal(losses, singles)
    assert torch.equal(a.sigma, b.sigma) and torch.equal(a.color, b.color)


def sync_points():
    """A checkpoint callback due every step (``log_every=1``) fires at
    every sync point: (the steps run there, the losses then on the host)."""
    seen = []

    def cb(field, steps, psnr_db):
        seen.append(steps)

    return seen, cb


@pytest.mark.parametrize("mode", ["tiled", "windowed", "plain"])
def test_fit_runs_blocks_of_sync_every(mode):
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    _, pinit = flat_init("fit")
    seen, cb = sync_points()
    res = p_fit.fit_dense_grid(
        pplan, pinit, list(pcams), targets_for("fit", seed=1),
        p_fit.FitConfig(**fit_config(steps=10, sync_every=4, log_every=1)),
        mode=mode, checkpoint_cb=cb)
    assert seen == [4, 8, 10]
    assert res.steps_run == 10 and len(res.loss_history) == 10
    assert res.first_step_s > 0.0 and res.steady_step_ms > 0.0


def test_hash_fit_runs_blocks_of_sync_every():
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    field = P.HashMLPField.init_random(
        torch.Generator().manual_seed(0), spec=P.HashMLPSpec(),
        device="cpu")
    seen, cb = sync_points()
    res = p_fit.fit_hash_mlp(
        pplan, field, list(pcams), targets_for("fit", seed=1),
        p_fit.FitConfig(learning_rate=8e-3, steps=10, sync_every=4,
                        log_every=1, target_psnr=None), checkpoint_cb=cb)
    assert seen == [4, 8, 10]
    assert res.steps_run == 10 and len(res.loss_history) == 10
