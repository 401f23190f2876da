"""The hash grid path's 8 px sub-tiles (K8 at subs 4) and the 16 -> 8 -> 4
px cascade of dvren_tpu_torch against dvren_tpu, on the CPU.

Same seeded inputs through both packages: the grid spec L=4 / F=2 /
T=4096 / hidden 8 on the 2-4-8-16 ladder, the field from the JAX
package's seeded initialisation carried across as numpy, seen by view 0
of tools/fit_benchmark.py's camera (k = 1.2 w, the translation orbit;
t 0.2-2.2, dt = 2 / steps). Two scenes: 48^2 with 32 steps, where 16 px
tiles overflow 1536 of 2304 rays and the cascade picks 8 px, and 24^2
with 24 steps, where 8 px still overflows 128 rays and the cascade picks
4 px (tests/test_torch_grid_subtiles_4px.py holds its kernels). Held:

- schedules at 16, 8 and 4 px and the cascade's, plain and quantized,
  equal to JAX's ``build_hash_grid_schedule`` array for array; the
  refusal of a scene that overflows even 4 px, with JAX's message;
- planes of the port's plain path (K8f's twin at subs 4) within 5e-6
  (depth 1e-4) of JAX's ``render_hash_grid_tiled`` with its Pallas
  kernel in interpret mode, on the one-group uniform schedule (one
  interpreted compile, about 25 s); the frame equal bit for bit across
  the cascade's schedule, its uniform form and 4 px sub-tiles;
- every parameter's gradient within 5e-3 relative of ``jax.grad`` of the
  masked streamed referee (tests/test_hash_grid.py's bound), and K8b's
  twin within 2e-5 x scale of autograd of K8f's twin, at subs 4 and 16.
  ``jax.grad`` through JAX's interpreted kernels is held at subs 16 only
  (tests/test_torch_grid_subtiles_4px.py): at subs 4 it did not finish
  within 45 minutes on the CPU, even on a 32^2 / 16-step scene.

tests/test_torch_cuda.py holds the CUDA kernels to these twins on the card.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.hash_mlp import HashMLPField as JField
from dvren_tpu.ops.hashmlp import HashMLPSpec as JSpec
from dvren_tpu.render import hash_tiled as j_hash
from dvren_tpu.render.pipeline import plan_jitter_table
from dvren_tpu.render.pipeline import render as j_render
from tests.test_hash_grid import _MaskedHash
from tests.test_torch_core import port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal
from tests.test_torch_hash_grid import port_grid_field

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import hash_grid as p_hg
from dvren_tpu_torch.ops import hash_tiles as p_ht
from dvren_tpu_torch.render import hash_tiled as p_hash
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
REF_GRAD_TOL = 5e-3   # relative to max |reference|
TWIN_TOL = 2e-5       # x max |reference|

SPEC = dict(n_levels=4, features_per_level=2, table_size=4096, hidden_dim=8,
            base_resolution=2.0, finest_resolution=16.0,
            resolutions=(2, 4, 8, 16))
# scene -> (width, steps, the cascade's tile_px)
SCENES = {"8px": (48, 32, 8), "4px": (24, 24, 4)}


def make_plan(width, steps, view=0, views=8):
    """tools/fit_benchmark.py's camera for one view of its orbit."""
    ang = 2 * math.pi * view / views
    return J.Plan.create(J.PlanConfig(
        width=width, height=width, t_near=0.2, t_far=2.2,
        camera=J.CameraConfig(
            k=(width * 1.2, 0, width / 2, 0, width * 1.2, width / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5 + 0.25 * math.sin(ang), 0, 1, 0,
                 0.5 + 0.15 * math.cos(ang), 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=2.0 / steps, max_steps=steps)))


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX plan, JAX field, port plan, port field) of one scene."""
    width, steps, _ = SCENES[name]
    plan = make_plan(width, steps)
    jf = JField.init_random(jax.random.PRNGKey(0), JSpec(**SPEC),
                            table_std=0.5)
    return plan, jf, port_plan(plan), port_grid_field(jf, P.HashMLPSpec(**SPEC))


@functools.lru_cache(maxsize=None)
def j_schedule(name, tile_px=None, quantize=False, device=False):
    plan, jf, _, _ = case(name)
    return j_hash.build_hash_grid_schedule(
        plan, jf, jitter=plan_jitter_table(plan), tile_px=tile_px,
        quantize=quantize, device=device)


@functools.lru_cache(maxsize=None)
def p_schedule(name, tile_px=None, quantize=False):
    _, _, pplan, pf = case(name)
    return p_hash.build_hash_grid_schedule(pplan, pf, tile_px=tile_px,
                                           quantize=quantize, device="cpu")


def rel_close(got, ref, tol):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale)


def assert_planes_close(got, want):
    for key in ("image", "opacity", "transmittance"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)), atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=TOL_DEPTH)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(want.hitmask))
    assert float(got.opacity.max()) > 0.0


def port_forward(name, sched):
    _, _, pplan, pf = case(name)
    with torch.no_grad():
        return p_hash.render_hash_grid_tiled(pplan, pf, sched)


def jax_forward_check(name):
    """The port's frame on the uniform schedule against JAX's interpreted
    render on its uniform schedule (one group, one compile)."""
    plan, jf, _, _ = case(name)
    want = j_hash.render_hash_grid_tiled(
        plan, jf, j_schedule(name, quantize="uniform", device=True))
    sched = p_schedule(name, quantize="uniform")
    assert len(sched.groups) == 1
    assert_planes_close(port_forward(name, sched), want)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("quantize", [False, "uniform"])
@pytest.mark.parametrize("tile_px", [16, 8, 4, None])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_schedule_equal(name, tile_px, quantize):
    """Explicit sizes (16 px keeps its overflow count, as JAX's) and the
    cascade, whose choice is JAX's."""
    ref = j_schedule(name, tile_px, quantize)
    _, _, pplan, pf = case(name)
    got = p_hash.build_hash_grid_schedule(pplan, pf, tile_px=tile_px,
                                          quantize=quantize)
    assert got.device is None
    assert_schedules_equal(ref, got)
    gr, gp = ref.gather_plan, got.gather_plan
    assert gp.meta == tuple(gr.meta)
    for key in ("all_idx", "inv_map"):
        np.testing.assert_array_equal(getattr(gp, key),
                                      np.asarray(getattr(gr, key)))
    if tile_px is None:
        assert got.tile_px == SCENES[name][2] and got.fallback_rays == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cascade_needs_subtiles(name):
    """16 px overflows on both scenes; the 24^2 scene overflows 8 px too."""
    px = SCENES[name][2]
    assert p_schedule(name, 16).fallback_rays > 0
    assert p_schedule(name, px).fallback_rays == 0
    if px == 4:
        assert p_schedule(name, 8).fallback_rays > 0


def test_over_4px_refusal_matches_jax(monkeypatch):
    """4 px sub-tiles hold at most 128 samples per run and so never
    overflow; a builder that reports overflow at every size makes both
    cascades refuse, with the same message."""
    import dataclasses

    from dvren_tpu.render import tiled as j_tiled

    def overflowing(build):
        def wrapped(*args, **kw):
            return dataclasses.replace(build(*args, **kw), fallback_rays=1)
        return wrapped

    monkeypatch.setattr(j_tiled, "build_tiled_schedule",
                        overflowing(j_tiled.build_tiled_schedule))
    monkeypatch.setattr(p_tiled, "build_tiled_schedule",
                        overflowing(p_tiled.build_tiled_schedule))
    plan, jf, pplan, pf = case("8px")
    with pytest.raises(J.DvrenError) as want:
        j_hash.build_hash_grid_schedule(plan, jf, device=False)
    with pytest.raises(P.DvrenError) as got:
        p_hash.build_hash_grid_schedule(pplan, pf)
    assert str(got.value) == str(want.value)
    assert "overflows even 4px sub-tiles" in str(got.value)


def test_overflowing_schedule_is_not_rendered():
    _, _, pplan, pf = case("8px")
    sched = p_schedule("8px", 16)
    assert sched.fallback_rays > 0
    with pytest.raises(P.DvrenError, match="zero overflow rays"):
        p_hash.render_hash_grid_tiled(pplan, pf, sched)


@pytest.mark.parametrize("subs", [0, 2, 8])
def test_grid_op_params_refuses_other_subs(subs):
    _, _, pplan, pf = case("8px")
    with pytest.raises(ValueError, match="subs"):
        p_hg.grid_op_params(pplan, pf.spec, 4, 2, subs)


# --------------------------------------------------------------- forward


def test_forward_matches_interpreted_jax():
    """K8f's twin at subs 4 against JAX's Pallas kernel in interpret
    mode."""
    jax_forward_check("8px")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frames_equal_across_forms(name):
    """The cascade's schedule, its uniform form and 4 px sub-tiles render
    one frame bit for bit: a sample's window slot names the same table
    row and cell base in every form."""
    ref = port_forward(name, p_schedule(name))
    others = [p_schedule(name, quantize="uniform"), p_schedule(name, 4)]
    for sched in others:
        got = port_forward(name, sched)
        for key in ("image", "transmittance", "opacity", "depth"):
            assert torch.equal(getattr(got, key), getattr(ref, key)), key


# ------------------------------------------------------------- gradients


def port_grads(name, sched, target=0.25):
    _, _, pplan, pf = case(name)
    leaf = pf.with_params({k: v.detach().clone()
                           for k, v in pf.params.items()})
    img = p_hash.render_hash_grid_tiled(pplan, leaf, sched).image
    loss = torch.mean((img - target) ** 2)
    keys = sorted(leaf.params)
    return dict(zip(keys, torch.autograd.grad(
        loss, [leaf.params[k] for k in keys])))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_gradients_match_masked_streamed_referee(name):
    """Autograd through K8b's twin at the cascade's subs, the slot
    reduction and the table adjoint against jax.grad of the streamed
    referee under the grid path's zero-outside-the-cube semantic."""
    plan, jf, _, _ = case(name)
    target = jnp.full((plan.height, plan.width, 3), 0.25, jnp.float32)

    def loss_ref(params):
        img = j_render(plan, _MaskedHash(jf.with_params(params))).planes.image
        return jnp.mean((img - target) ** 2)

    want = jax.jit(jax.grad(loss_ref))(jf.params)
    got = port_grads(name, p_schedule(name))
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) / scale < REF_GRAD_TOL, k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_twin_adjoint_matches_autograd_of_twin_forward(name):
    """K8b's plain twin (the adjoint written out, sub-tile windows
    included) against torch autograd of K8f's plain twin, per group, on
    the field with seeded biases: the initialisation's zero biases put
    every sample whose hidden units are all off on the heads' ties, where
    torch's relu and clamp backward differ from JAX's 0.5."""
    _, _, pplan, pf = case(name)
    rng = np.random.default_rng(1)
    pf = pf.with_params({
        k: v.detach() + (torch.from_numpy(rng.normal(
            0.0, 0.3, tuple(v.shape)).astype(np.float32))
            if k.endswith(("_b1", "_b2")) else 0.0)
        for k, v in pf.params.items()})
    sched = p_schedule(name)
    subs = (16 // sched.tile_px) ** 2
    assert subs in (4, 16)
    table = p_hg.build_hash_grid_table(dict(pf.params), pf.spec).detach()
    tabs = p_tiled._gather_bank_tables(
        table, sched.gathermap_all,
        [(g.n_tiles, g.banks) for g in sched.groups])
    sc0 = p_ht.pack_mlp_scalars(dict(pf.params), pf.spec).detach()
    for gi, g in enumerate(sched.groups):
        prm = p_hg.grid_op_params(pplan, pf.spec, g.banks, g.n_chunks, subs)
        t = tabs[gi].clone().requires_grad_(True)
        sc = sc0.clone().requires_grad_(True)
        args = (g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1))
        raw = p_hg.hash_grid_forward_plain(t, *args, sc, prm)
        gs = torch.from_numpy(rng.normal(size=tuple(raw.shape)).astype(
            np.float32))
        want_t, want_sc = torch.autograd.grad((raw * gs).sum(), (t, sc))
        got_rows, got_sc = p_hg.hash_grid_backward(tabs[gi], *args, sc0, gs,
                                                   prm)
        rel_close(got_rows.numpy(), want_t.transpose(2, 3).numpy(), TWIN_TOL)
        rel_close(got_sc.numpy(), want_sc.numpy(), TWIN_TOL)
