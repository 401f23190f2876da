"""Gradients of the hash-MLP fused path and fit_hash_mlp, dvren_tpu_torch
against dvren_tpu on the CPU.

The port's gradients run through autograd of ``render_hash_tiled``
(``_HashGroup``, whose backward is K7b's plain twin on the CPU); the
referee is ``jax.grad`` of the JAX pipeline (``pipeline.render``), as
tests/test_hash_tiled.py holds the JAX kernel. Every params key within
2e-5 x scale, the all-zero field included (every pre-activation on a
tie, and a field whose hidden pre-activations and colour clamps sit on
their ties); a directional finite difference at 2e-3. The fit's loss history is
held to a JAX loop of ``jax.value_and_grad`` over ``pipeline.render``
with ``optax.adam`` within 1e-5 relative, and one torch Adam step to
optax's within 1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.hash_mlp import HashMLPField as JField
from dvren_tpu.opt.fit import view_plans as j_view_plans
from dvren_tpu.render.pipeline import render as j_render
from tests.test_torch_core import port_plan
from tests.test_torch_hash import make_plan, port_hash_field

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import hash_tiles as p_ht
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import hash_tiled as p_hash

torch.set_num_threads(1)

GRAD_TOL = 2e-5     # x max |reference|: tests/test_hash_tiled.py:114
FD_TOL = 2e-3


def _tie_blob(spec):
    """Every hidden pre-activation exactly 0 (first-layer weights and
    biases 0: ReLU ties), sigma > 0, and the colour biases on both ends
    of the clamp (0 and 1) and inside it."""
    from tests.test_torch_hash import blob
    from dvren_tpu.ops.hashmlp import unpack_params, pack_params

    p = {k: np.array(v) for k, v in
         unpack_params(jnp.asarray(blob(spec, 3)), spec).items()}
    for k in ("sigma_w1", "sigma_b1", "color_w1", "color_b1"):
        p[k][...] = 0.0
    p["sigma_b2"] = np.float32(2.0)
    p["color_b2"][:] = (0.0, 1.0, 0.5)
    return np.asarray(pack_params({k: jnp.asarray(v) for k, v in p.items()},
                                  spec))


@functools.lru_cache(maxsize=None)
def _grad_case(name):
    """(JAX plan, JAX field, port plan, port field, target image) for a
    16x16 stratified frame (tests/test_hash_tiled.py:88-114)."""
    from tests.test_torch_hash import JConfig, blob, j_spec, p_spec

    flat = {"random": lambda: blob(j_spec(), 2),
            "ties": lambda: _tie_blob(j_spec()),
            "zeros": lambda: None}[name]()
    jf = JField.create(JConfig(params=flat))
    plan = make_plan(w=16, h=16, mode=J.SamplingMode.STRATIFIED, seed=3)
    tgt = np.random.default_rng(9).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    return plan, jf, port_plan(plan), port_hash_field(jf, p_spec()), tgt


def _port_grads(name, opacity_weight):
    _, _, pplan, pf, tgt = _grad_case(name)
    leaf = pf.with_params({k: v.detach().clone()
                           for k, v in pf.params.items()})
    sched = p_hash.build_hash_schedule(pplan, device="cpu")
    out = p_hash.render_hash_tiled(pplan, leaf, sched)
    loss = (torch.mean((out.image - torch.from_numpy(tgt)) ** 2)
            + opacity_weight * torch.mean(out.opacity))
    keys = sorted(leaf.params)
    grads = torch.autograd.grad(loss, [leaf.params[k] for k in keys])
    return dict(zip(keys, grads))


@functools.lru_cache(maxsize=None)
def _jax_grads(name, opacity_weight):
    plan, jf, _, _, tgt = _grad_case(name)

    def loss_ref(params):
        out = j_render(plan, JField(spec=jf.spec, params=params))
        return (jnp.mean((out.planes.image - tgt) ** 2)
                + opacity_weight * jnp.mean(out.planes.opacity))

    return {k: np.asarray(v)
            for k, v in jax.jit(jax.grad(loss_ref))(jf.params).items()}


# the all-zero field's loss has no opacity term: at exact-zero sigma the
# JAX pipeline's transmittance min over tied prefixes splits its gradient,
# where the JAX kernel (and the port) do not (ROADMAP Queue 3);
# test_zero_field_opacity_gradient holds that term to its closed form
@pytest.mark.parametrize("name,opacity_weight",
                         [("random", 0.25), ("ties", 0.25), ("zeros", 0.0)])
def test_gradients_match_jax_grad(name, opacity_weight):
    want = _jax_grads(name, opacity_weight)
    got = _port_grads(name, opacity_weight)
    assert set(got) == set(want)
    for k in sorted(want):
        scale = max(float(np.abs(want[k]).max()), 1e-8)
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k],
                                   atol=GRAD_TOL * scale, err_msg=k)
    if name == "ties":
        # only the 0.5 tie values carry these (torch's relu backward
        # gives 0 at 0)
        for k in ("sigma_b1", "sigma_w1", "color_b1", "color_w1"):
            assert float(got[k].abs().max()) > 0.0, k


def test_zero_field_opacity_gradient():
    """All-zero field: sigma = max(0, 0) and od = max(0 * dt, 0) sit on
    their ties, so d mean(opacity) / d sigma_b2 = 0.5 * 0.5 * sum of the
    live dt over the lattice (1.2 here): what the JAX kernel's backward
    gives (0.025 for an 8-step lattice of dt 0.05, interpret mode)."""
    got = _port_grads("zeros", 1.0)
    assert float(got["sigma_b2"]) == pytest.approx(0.25 * 1.2, rel=1e-6)
    for k, g in got.items():
        if k != "sigma_b2":
            assert float(g.abs().max()) == 0.0, k


def test_twin_adjoint_matches_autograd_of_twin_forward():
    """K7b's plain twin (the adjoint written out) against torch autograd
    of K7f's plain twin (a random field: no pre-activation on a tie)."""
    _, _, pplan, pf, _ = _grad_case("random")
    sched = p_hash.build_hash_schedule(pplan, device="cpu")
    prm = p_ht.hash_tile_params(pplan, pf.spec, sched.n_chunks)
    table = pf.params["hash_table"].detach().clone().requires_grad_(True)
    sc = p_ht.pack_mlp_scalars(dict(pf.params), pf.spec).detach() \
        .clone().requires_grad_(True)
    raw = p_ht.hash_tile_forward_plain(sched.samp, sched.rayt, table, sc,
                                       prm)
    gs = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(raw.shape)).astype(np.float32))
    want_tab, want_sc = torch.autograd.grad((raw * gs).sum(), (table, sc))
    before = p_ht.hash_tile_backward.launches
    got_tab, got_sc = p_ht.hash_tile_backward(
        sched.samp, sched.rayt, table.detach(), sc.detach(), gs, prm)
    assert p_ht.hash_tile_backward.launches == before   # the CPU twin
    for got, want in ((got_tab, want_tab), (got_sc, want_sc)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= GRAD_TOL * scale


def test_gradient_finite_difference():
    """Directional finite difference of the port's own loss
    (tests/test_hash_tiled.py:117-141)."""
    from tests.test_torch_hash import JConfig, blob, j_spec, p_spec

    jf = JField.create(JConfig(params=blob(j_spec(), 4)))
    pf = port_hash_field(jf, p_spec())
    pplan = port_plan(make_plan(w=16, h=16))
    sched = p_hash.build_hash_schedule(pplan, device="cpu")

    def loss(f):
        out = p_hash.render_hash_tiled(pplan, f, sched)
        return torch.mean(out.image) + 0.25 * torch.mean(out.opacity)

    base = {k: v.detach().clone() for k, v in pf.params.items()}
    f0 = pf.with_params(base)
    keys = sorted(base)
    g = torch.autograd.grad(loss(f0), [f0.params[k] for k in keys])
    rng = np.random.default_rng(13)
    v = {k: torch.from_numpy(np.asarray(rng.normal(
        size=tuple(base[k].shape)), np.float32)) for k in keys}
    eps = 3e-3
    with torch.no_grad():
        plus = float(loss(pf.with_params(
            {k: base[k] + eps * v[k] for k in keys})))
        minus = float(loss(pf.with_params(
            {k: base[k] - eps * v[k] for k in keys})))
    fd = (plus - minus) / (2 * eps)
    an = float(sum((gk * v[k]).sum() for gk, k in zip(g, keys)))
    assert abs(fd - an) <= FD_TOL * max(abs(fd), abs(an), 1e-6), (fd, an)


# ----------------------------------------------------------------------- fit


def _fit_case():
    """2 views at 16^2, 16 steps, the default spec, random targets."""
    from tests.test_torch_hash import JConfig, blob, j_spec, p_spec

    w = 16
    plan = J.Plan.create(J.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=J.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=2.0 / 16, max_steps=16)))
    cams = [J.CameraConfig(k=plan.camera.k, c2w=c2w) for c2w in (
        (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0),
        (0, 0, -1, 2.0, 0, 1, 0, 0.5, 1, 0, 0, 0.5))]
    jf = JField.create(JConfig(params=blob(j_spec(), 12)))
    tgt = np.random.default_rng(2).uniform(0, 1, (2, w, w, 3)).astype(
        np.float32)
    return plan, cams, jf, port_hash_field(jf, p_spec()), tgt


def test_fit_hash_mlp_matches_jax_adam_loop():
    plan, cams, jf, pf, tgt = _fit_case()
    lr, steps = 8e-3, 3
    plans = j_view_plans(plan, cams)
    optimizer = optax.adam(lr)

    def loss_fn(params):
        f = JField(spec=jf.spec, params=params)
        imgs = jnp.stack([j_render(pv, f).planes.image for pv in plans])
        return jnp.mean((imgs - tgt) ** 2)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = optimizer.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    params, state, want = jf.params, optimizer.init(jf.params), []
    for _ in range(steps):
        params, state, loss = step(params, state)
        want.append(float(loss))

    before = {k: v.detach().clone() for k, v in pf.params.items()}
    res = p_fit.fit_hash_mlp(
        port_plan(plan), pf, [P.CameraConfig(k=c.k, c2w=c.c2w) for c in cams],
        tgt, p_fit.FitConfig(learning_rate=lr, steps=steps, sync_every=2,
                             target_psnr=None))
    assert res.steps_run == steps and len(res.loss_history) == steps
    np.testing.assert_allclose(res.loss_history, want, rtol=1e-5)
    assert len(res.psnr_history) == steps
    assert res.mode == "hash_tiled" and res.steady_step_ms > 0.0
    assert res.first_step_s > 0.0 and res.wall_clock_s >= res.first_step_s
    for k, v in pf.params.items():           # the input field is untouched
        assert torch.equal(v.detach(), before[k]), k
    moved = max(float((res.field.params[k].detach() - before[k]).abs().max())
                for k in before)
    assert moved > 0.0


def test_fit_hash_mlp_target_stop_and_checkpoints():
    plan, cams, _, pf, tgt = _fit_case()
    seen = []
    res = p_fit.fit_hash_mlp(
        port_plan(plan), pf, [P.CameraConfig(k=c.k, c2w=c.c2w) for c in cams],
        tgt, p_fit.FitConfig(learning_rate=8e-3, steps=4, sync_every=2,
                             target_psnr=-100.0, log_every=1),
        checkpoint_cb=lambda f, n, p: seen.append(n))
    # the target is checked at the first sync point (after 2 steps)
    assert res.reached_target and res.steps_run == 2 == len(res.loss_history)
    assert seen == [2]
    assert res.steady_step_ms > 0.0


def test_torch_adam_step_matches_optax():
    """One step from the same parameters (the blobs' scale) for gradients
    of three scales."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 16, 2), "b": (8,), "c": ()}
    params = {k: np.asarray(rng.uniform(-0.5, 0.5, size=s), np.float32)
              for k, s in shapes.items()}
    lr = 8e-3
    optimizer = optax.adam(lr)
    for scale in (1.0, 1e-3, 1e-7):
        g = {k: np.asarray(rng.normal(size=s) * scale, np.float32)
             for k, s in shapes.items()}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        updates, _ = optimizer.update({k: jnp.asarray(v) for k, v in g.items()},
                                      optimizer.init(jp), jp)
        want = optax.apply_updates(jp, updates)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in params.items()}
        opt = torch.optim.Adam(tp.values(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(want[k]), atol=1e-7,
                                       rtol=0)
