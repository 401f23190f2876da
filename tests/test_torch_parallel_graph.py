"""The sharded training steps recorded as CUDA graphs, and the sharded
paths' jitter hashed on the device, on the CPU.

On a CUDA mesh over NCCL, ``parallel/shard.py``'s tile-DP, multi-view
tile-DP and view-DP steps (and the two sharded fits that run them) are
recorded once as CUDA graphs and replayed, their all-reduces inside the
graph: the port's counterpart of JAX's jitted steps. On a gloo mesh they
run eagerly. The CPU has no graph, so the recording path is held here
through the stand-in of tests/torch_graph_standin.py (a replay reruns
the recorded function; the recorded run may not upload the plan's camera
nor read the host jitter table), installed in each spawned rank of
tests/torch_parallel_ranks.py::graph_cases: one spawn of gloo CPU ranks
at D = 1 and one at D = 2. Held:

- each step's replays equal its eager body bit for bit over 3 steps
  (losses, parameters, Adam's state), one recording each, and a new
  shards object or c2ws tensor records anew;
- the graphed fits equal the eager fits bit for bit, one recording each,
  and at D = 2 stay within rtol 1e-4 of JAX's ``fit_dense_grid_tile_dp``
  and ``fit_dense_grid_dp`` on a 2-device mesh over JAX's first two steps
  (its interpreted tile kernels take about 25 s a step on the CPU);
- a non-capturable Adam raises ``DvrenError`` on the recorded path;
- the record-or-eager rule on fake meshes, and on the gloo mesh itself
  every step eager (``graph`` None) and equal to its body;
- the ray-sharded frame, its lattice, the view-DP step and the z-sharded
  frame read no host jitter table and equal the table route bit for bit
  (the view-DP step's gradient at D = 2 within the rtol 1e-4 / atol 1e-6
  of tests/test_torch_parallel.py);
- the launch counters list the jitter kernel.

tests/test_torch_cuda.py holds the recorded tile-DP step on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.parallel import mesh as j_mesh
from dvren_tpu.parallel import shard as j_shard
from tests import torch_graph_standin as standin
from tests import torch_parallel_ranks as R

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import raygen as p_raygen
from dvren_tpu_torch.parallel import Mesh, launch, shard
from dvren_tpu_torch.render import graph as p_graph

torch.set_num_threads(1)

RANKS = (1, 2)
STEPS = ("tile", "multiview", "view_dp")


@functools.lru_cache(maxsize=None)
def graph_run(n_dev):
    """Every recorded-step case at ``n_dev`` gloo CPU ranks, run once."""
    return launch(R.graph_cases, n_dev, backend="gloo", device="cpu")


@pytest.mark.parametrize("n_dev", RANKS)
@pytest.mark.parametrize("name", STEPS)
def test_replays_equal_the_eager_body(n_dev, name):
    r = graph_run(n_dev)[name]
    assert r["recordings"] == 1 and r["graph_is_the_recording"]
    assert r["losses_equal"] and r["state_equal"] and r["distinct"]
    assert r["losses"][-1] < r["losses"][0]


@pytest.mark.parametrize("n_dev", RANKS)
@pytest.mark.parametrize("name", STEPS)
def test_new_inputs_record_anew(n_dev, name):
    assert graph_run(n_dev)[name]["new_inputs_record"]


def test_the_recorded_run_uploads_nothing():
    """The ranks' recordings ran with the plan's camera and the host
    jitter table refused (any call fails the rank): here, the stand-in
    refuses both while it records and lets the warm-up upload."""
    from dvren_tpu_torch.render import pipeline

    plan = R.z_scene(P, mode="STRATIFIED", device="cpu")[0]
    for read, what in ((lambda: p_raygen.camera_arrays(plan, "cpu"),
                        "camera uploaded"),
                       (lambda: pipeline.plan_jitter_table(plan),
                        "jitter table read")):
        with standin.installed():
            with pytest.raises(AssertionError, match=what):
                p_graph.capture(read, "cpu")
    for n_dev in RANKS:
        assert graph_run(n_dev)["tile"]["recordings"] == 1


@pytest.mark.parametrize("n_dev", RANKS)
def test_graphed_fits_equal_eager_fits(n_dev):
    out = graph_run(n_dev)
    assert out["fit_recordings"] == 2 and out["fits_equal_eager"]
    assert out["tile_fit"].shape == out["dp_fit"].shape == (R.FIT_STEPS,)
    assert out["tile_fit"][-1] < out["tile_fit"][0]
    assert out["dp_fit"][-1] < out["dp_fit"][0]


JAX_FIT_STEPS = 2   # JAX's interpreted tile kernels take ~25 s a step here


@functools.lru_cache(maxsize=None)
def jax_fits():
    """JAX's sharded fits on a 2-device mesh from the ranks' starts and
    targets, JAX_FIT_STEPS each: (tile-DP losses, view-DP losses)."""
    out = graph_run(2)
    mesh = j_mesh.make_mesh(2)
    jp, jf, jc = R.multiview_scene(J)
    flat = jf.with_params(jnp.full_like(jf.sigma, 1.0),
                          jnp.full_like(jf.color, 0.5))
    _, tile = j_shard.fit_dense_grid_tile_dp(
        jp, flat, list(jc), out["fit_targets"], mesh, steps=JAX_FIT_STEPS)
    vp, vf = R.z_scene(J, mode="STRATIFIED")
    vflat = vf.with_params(jnp.full_like(vf.sigma, 1.0),
                           jnp.full_like(vf.color, 0.5))
    cams = [J.CameraConfig(c2w=tuple(float(v) for v in p))
            for p in R.dp_poses(4)]
    _, dp = j_shard.fit_dense_grid_dp(vp, vflat, cams,
                                      out["dp_fit_targets"], mesh,
                                      steps=JAX_FIT_STEPS)
    return np.asarray(tile), np.asarray(dp)


def test_graphed_fits_match_jax_sharded_fits():
    """The graphed fits at D = 2 against JAX's sharded fits (the bound of
    tests/test_torch_parallel.py's tile-DP fit), over JAX's steps: the
    first losses of the port's fits, whose history does not depend on
    the step count."""
    out = graph_run(2)
    tile, dp = jax_fits()
    n = JAX_FIT_STEPS
    assert tile.shape == dp.shape == (n,)
    np.testing.assert_allclose(out["tile_fit"][:n], tile, rtol=1e-4)
    np.testing.assert_allclose(out["dp_fit"][:n], dp, rtol=1e-4)


@pytest.mark.parametrize("n_dev", RANKS)
def test_non_capturable_adam_raises_on_the_recorded_path(n_dev):
    out = graph_run(n_dev)
    assert out["noncapturable_raises"] and out["noncapturable_untouched"]


@pytest.mark.parametrize("backend, device, records", [
    ("nccl", "cuda:0", True), ("gloo", "cpu", False),
    ("gloo", "cuda:0", False), ("nccl", "cpu", False)])
def test_record_or_eager_rule(backend, device, records):
    """Record where the mesh's device is CUDA and its backend NCCL; gloo
    sums on the host, which no graph records."""
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device(device),
                backend=backend)
    assert p_graph.available(mesh.device, mesh.backend) == records
    assert shard.record_device(mesh) == (mesh.device if records else None)


@pytest.mark.parametrize("n_dev", RANKS)
def test_gloo_mesh_steps_run_eagerly(n_dev):
    out = graph_run(n_dev)
    assert out["record_device"] is None
    assert out["gloo_eager"] == {name: True for name in STEPS}


@pytest.mark.parametrize("n_dev", RANKS)
def test_sharded_jitter_reads_no_host_table(n_dev):
    """The ray-sharded frame, the rank's lattice and the z-sharded frame
    (default argument) hash the jitter: no call to ``plan_jitter_table``,
    bit-equal to the table route."""
    out = graph_run(n_dev)
    assert out["ray_table_bit_equal"] and out["lattice_table_bit_equal"]
    assert out["z_table_bit_equal"]


@pytest.mark.parametrize("n_dev", RANKS)
def test_view_dp_step_reads_no_host_table(n_dev):
    """The view-DP step with the host table refused against autograd
    through ``pipeline.render`` with the table on one device: bit for bit
    at D = 1, within tests/test_torch_parallel.py's bounds at D = 2."""
    out = graph_run(n_dev)
    assert out["dp_loss"] == pytest.approx(out["dp_ref_loss"], rel=1e-5)
    for got, ref in zip(out["dp_summed_grads"], out["dp_ref_grads"]):
        assert np.abs(ref).max() > 0
        if n_dev == 1:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_launch_counts_include_the_jitter_kernel():
    """``launch_counts`` (and so a recording's ``launches``) lists the
    jitter kernel; ``reset_launch_counts`` zeroes it. On the card,
    tests/test_torch_cuda.py records it in a stratified frame."""
    from dvren_tpu_torch.ops import rng

    before = rng.stratified_jitter.launches
    try:
        rng.stratified_jitter.launches = 5
        assert p_graph.launch_counts()["stratified_jitter"] == 5
        p_graph.reset_launch_counts()
        assert rng.stratified_jitter.launches == 0
    finally:
        rng.stratified_jitter.launches = before
