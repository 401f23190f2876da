"""The hash grid path's 4 px sub-tiles (K8 at subs 16) of dvren_tpu_torch
against dvren_tpu's interpreted Pallas kernel, on the CPU.

The 24^2 / 24-step scene of tests/test_torch_grid_subtiles.py, where the
cascade picks 4 px. JAX's interpreted kernel at subs 16 expands every
table column once per sub-tile, so its one compile takes about a minute
here; this file holds it apart from the other sub-tile checks. Held: the
port's planes on the one-group uniform schedule within 5e-6 (depth 1e-4)
of JAX's ``render_hash_grid_tiled``; marked ``slow`` (``jax.grad``
through the interpreted kernels compiles for about 14 minutes on the
CPU, 2 with JAX's compile cache warm): the hash-table and MLP gradients
within 2e-5 x scale of JAX's.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from dvren_tpu.render import hash_tiled as j_hash
from tests.test_torch_grid_subtiles import (TWIN_TOL, case, j_schedule,
                                            jax_forward_check, p_schedule,
                                            port_grads, rel_close)

torch.set_num_threads(1)


def test_forward_matches_interpreted_jax():
    """K8f's twin at subs 16 against JAX's Pallas kernel in interpret
    mode."""
    assert p_schedule("4px", quantize="uniform").tile_px == 4
    jax_forward_check("4px")


@pytest.mark.slow
def test_gradients_match_interpreted_jax():
    """Port gradients on the uniform schedule against jax.grad of JAX's
    interpreted render on its uniform schedule."""
    plan, jf, _, _ = case("4px")
    sched = j_schedule("4px", quantize="uniform", device=True)
    target = jnp.full((plan.height, plan.width, 3), 0.25, jnp.float32)

    def loss(params):
        img = j_hash.render_hash_grid_tiled(plan, jf.with_params(params),
                                            sched).image
        return jnp.mean((img - target) ** 2)

    want = jax.grad(loss)(jf.params)
    got = port_grads("4px", p_schedule("4px", quantize="uniform"))
    for k in sorted(want):
        rel_close(got[k].numpy(), want[k], TWIN_TOL)
