"""The NGP-scale hash grid path of dvren_tpu_torch against dvren_tpu, on
the CPU: gating, the packed multi-level table and its adjoint, the bank
gather at C columns and its transpose, the schedule, the forward (K8f's
plain twin) and the gradients (K8b's).

Same inputs through both packages: fields from the JAX package's seeded
initialisation (tests/test_hash_grid.py's spec, L=3 / F=2 / T=4096 /
resolutions (2, 4, 8)) carried across as numpy. The JAX side runs as its
own suite runs it on the CPU: ``render_hash_grid_tiled`` with its Pallas
kernel in interpret mode, and ``jax.grad`` of the masked streamed referee
(``pipeline.render`` of tests/test_hash_grid.py's ``_MaskedHash``), never
``jax.grad`` of the interpreted grid path (minutes on the CPU).
Tolerances: the table bit-equal, its adjoint and the gather transpose
within 1e-6 x scale, schedules array-equal, planes 5e-6 (depth 1e-4),
gradients within 5e-3 relative of the streamed referee (the JAX package's
bound, tests/test_hash_grid.py:195), K8b's twin within 2e-5 x scale of
autograd of K8f's twin, a directional finite difference at 2e-3.
tests/test_torch_cuda.py holds the CUDA kernels to the twins on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.hash_mlp import HashMLPField as JField
from dvren_tpu.ops import hash_grid as j_hg
from dvren_tpu.ops.hashmlp import HashMLPSpec as JSpec
from dvren_tpu.render import hash_tiled as j_hash
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from dvren_tpu.render.pipeline import render as j_render
from tests.test_hash_grid import _MaskedHash
from tests.test_torch_core import port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import gather_plan as p_gp
from dvren_tpu_torch.ops import hash_grid as p_hg
from dvren_tpu_torch.ops import hash_tiles as p_ht
from dvren_tpu_torch.render import hash_tiled as p_hash
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
ADJ_TOL = 1e-6        # x max |reference|
REF_GRAD_TOL = 5e-3   # relative to max |reference|
TWIN_TOL = 2e-5       # x max |reference|
FD_TOL = 2e-3

SPECS = {
    "test": dict(n_levels=3, features_per_level=2, table_size=4096,
                 hidden_dim=8, base_resolution=2.0, finest_resolution=8.0,
                 resolutions=(2, 4, 8)),
    # tools/hashmlp_bench.py's grid spec
    "bench": dict(n_levels=4, features_per_level=2, table_size=4096,
                  hidden_dim=8, base_resolution=4.0, finest_resolution=32.0,
                  resolutions=(4, 8, 16, 32)),
    # a table size that is not a power of two (the build hashes with % T)
    "odd": dict(n_levels=2, features_per_level=3, table_size=3001,
                hidden_dim=5, resolutions=(2, 8)),
}


def specs(name="test"):
    return JSpec(**SPECS[name]), P.HashMLPSpec(**SPECS[name])


def make_plan(w=32, steps=16, mode=J.SamplingMode.FIXED):
    """tests/test_hash_grid.py::_plan."""
    return J.Plan.create(J.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=J.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=mode)))


def port_grid_field(jf, spec) -> "P.HashMLPField":
    return P.HashMLPField.from_reference_params(
        {k: np.asarray(v) for k, v in jf.params.items()}, spec,
        device="cpu")


# (plan kwargs, field seed)
CASES = {
    "fixed": (dict(), 0),
    "stratified": (dict(mode=J.SamplingMode.STRATIFIED), 1),
    "referee": (dict(), 4),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX plan, JAX field, port plan, port field) of one case."""
    plan_kw, seed = CASES[name]
    js, ps = specs()
    plan = make_plan(**plan_kw)
    jf = JField.init_random(jax.random.PRNGKey(seed), js, table_std=0.5)
    return plan, jf, port_plan(plan), port_grid_field(jf, ps)


@functools.lru_cache(maxsize=None)
def j_schedule(name, device=False):
    plan, jf, _, _ = case(name)
    return j_hash.build_hash_grid_schedule(
        plan, jf, jitter=plan_jitter_table(plan), device=device)


@functools.lru_cache(maxsize=None)
def p_schedule(name):
    _, _, pplan, pf = case(name)
    return p_hash.build_hash_grid_schedule(pplan, pf, device="cpu")


def rel_close(got, ref, tol):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale)


def random_field(seed, spec, table_std=0.5):
    return P.HashMLPField.init_random(torch.Generator().manual_seed(seed),
                                      spec=spec, table_std=table_std,
                                      device="cpu")


# ------------------------------------------------------------ host half


@pytest.mark.parametrize("kw", [
    SPECS["test"], SPECS["bench"], SPECS["odd"],
    dict(),                                            # no explicit ladder
    dict(n_levels=3, resolutions=(2, 5, 8)),           # non-pow2 ratio
    dict(n_levels=3, resolutions=(2.5, 4, 8)),         # non-integer
    dict(n_levels=3, resolutions=(2, 4, 128)),         # finest > 64
    dict(n_levels=2, resolutions=(8, 4)),              # not ascending
    dict(n_levels=2, hidden_dim=9, resolutions=(4, 8)),
    dict(n_levels=2, resolutions=(4,)),                # wrong length
])
def test_grid_path_ok_equal(kw):
    assert p_hg.grid_path_ok(P.HashMLPSpec(**kw)) == \
        j_hg.grid_path_ok(JSpec(**kw))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_grid_shape_and_vertex_maps_equal(name):
    js, ps = specs(name)
    assert p_hg.grid_shape(ps) == j_hg.grid_shape(js)
    assert p_hg.packed_cols(ps) == j_hg.packed_cols(js)
    assert p_hg._level_ratios(ps) == j_hg._level_ratios(js)
    want, got = j_hg._vertex_maps(js), p_hg._vertex_maps(ps)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_params(name, seed):
    js, _ = specs(name)
    return JField.init_random(jax.random.PRNGKey(seed), js,
                              table_std=0.5).params


@pytest.mark.parametrize("name", ["test", "odd"])
def test_packed_table_bit_equal(name):
    js, ps = specs(name)
    jp = _jax_params(name, 2)
    want = np.asarray(j_hg.build_hash_grid_table(jp, js))
    got = p_hg.build_hash_grid_table(
        {"hash_table": torch.from_numpy(np.array(jp["hash_table"]))}, ps)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["test", "bench", "odd"])
def test_table_adjoint_matches_jax_vjp(name):
    js, ps = specs(name)
    jp = _jax_params(name, 3)
    packed, vjp = jax.vjp(lambda t: j_hg.build_hash_grid_table(
        {"hash_table": t}, js), jp["hash_table"])
    ct = np.random.default_rng(4).normal(size=packed.shape).astype(
        np.float32)
    (want,) = vjp(jnp.asarray(ct))
    got = p_hg.hash_grid_table_grad(torch.from_numpy(ct), ps)
    assert tuple(got.shape) == want.shape
    rel_close(got.numpy(), want, ADJ_TOL)


def test_bank_gather_and_transpose_match_jax():
    """The C-column bank gather (w = 48) and its planned transpose against
    ``_gather_banks_f32`` and its VJP."""
    ref, got = j_schedule("fixed"), p_schedule("fixed")
    n_rows = int(ref.gather_plan.inv_map.shape[0])
    rng = np.random.default_rng(5)
    table = rng.normal(size=(n_rows, 48)).astype(np.float32)
    static = (48, tuple((g.n_tiles, g.banks) for g in ref.groups))
    want, vjp = jax.vjp(
        lambda t: j_tiled._gather_banks_f32(
            t, jnp.asarray(ref.gathermap_all), ref.gather_plan, static),
        jnp.asarray(table))
    tabs = p_tiled._gather_bank_tables(
        torch.from_numpy(table), got.gathermap_all,
        [(g.n_tiles, g.banks) for g in got.groups])
    for a, b in zip(tabs, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cts = [rng.normal(size=w.shape).astype(np.float32) for w in want]
    (d_want,) = vjp(tuple(jnp.asarray(c) for c in cts))
    rows = torch.cat([torch.from_numpy(c).transpose(2, 3).reshape(-1, 48)
                      for c in cts])
    d_got = p_gp.slot_rows_to_table(rows, got.gather_plan, n_rows)
    rel_close(d_got.numpy(), d_want, ADJ_TOL)


@pytest.mark.parametrize("name", ["fixed", "stratified"])
def test_schedule_equal(name):
    ref, got = j_schedule(name), p_hash.build_hash_grid_schedule(
        case(name)[2], case(name)[3])
    assert got.device is None and got.fallback_rays == 0
    assert got.tiled_samples > 0
    assert_schedules_equal(ref, got)
    gr, gp = ref.gather_plan, got.gather_plan
    assert gp.meta == tuple(gr.meta)
    for key in ("all_idx", "inv_map"):
        a, b = np.asarray(getattr(gr, key)), getattr(gp, key)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=key)


def test_overflowing_scene_names_subtile_item():
    """A close-up 16x16 frame over a 65^3 point lattice: a chunk's samples
    touch more than 256 cells, which needs 8 or 4 px sub-tiles. The
    cascade builds them; 16 px tiles keep their overflow rays, which the
    render refuses (the grid path has no windowed fallback)."""
    spec = P.HashMLPSpec(n_levels=3, table_size=4096,
                         resolutions=(16, 32, 64))
    plan = P.Plan.create(P.PlanConfig(
        width=16, height=16, t_near=0.1, t_far=3.1, seed=17,
        camera=P.CameraConfig(k=(16.0, 0, 8.0, 0, 16.0, 8.0, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.1)),
        sampling=P.SamplingConfig(dt=0.05, max_steps=60)))
    field = random_field(0, spec)
    sched = p_hash.build_hash_grid_schedule(plan, field)
    assert sched.tile_px < 16 and sched.fallback_rays == 0
    coarse = p_hash.build_hash_grid_schedule(plan, field, tile_px=16,
                                             device="cpu")
    assert coarse.fallback_rays > 0
    with pytest.raises(P.DvrenError, match="zero overflow rays"):
        p_hash.render_hash_grid_tiled(plan, field, coarse)


def test_refused_spec_raises():
    _, _, pplan, _ = case("fixed")
    toy = P.HashMLPField.create(P.HashMLPConfig(),     # no explicit ladder
                                device="cpu")
    with pytest.raises(P.DvrenError, match="grid path"):
        p_hash.build_hash_grid_schedule(pplan, toy)
    with pytest.raises(P.DvrenError, match="grid path"):
        p_hash.render_hash_grid_tiled(pplan, toy, p_schedule("fixed"))


def test_field_carries_grid_spec():
    """init_random and from_reference_params hold a grid spec (T = 4096,
    explicit resolutions); the weights carried across are the JAX
    field's, bit for bit."""
    js, ps = specs("bench")
    pf = random_field(1, ps, table_std=1.0)
    assert pf.spec == ps and p_hg.grid_path_ok(pf.spec)
    assert tuple(pf.params["hash_table"].shape) == (4, 4096, 2)
    assert tuple(pf.params["sigma_w1"].shape) == (8, 8)
    assert 0.5 < float(pf.params["hash_table"].detach().std()) < 1.5
    jf = JField.init_random(jax.random.PRNGKey(7), js, table_std=0.5)
    carried = port_grid_field(jf, ps)
    assert carried.spec.resolutions == (4, 8, 16, 32)
    for k, v in jf.params.items():
        np.testing.assert_array_equal(carried.params[k].detach().numpy(),
                                      np.asarray(v), err_msg=k)


# ------------------------------------------------------------- forward


@functools.lru_cache(maxsize=None)
def j_forward(name):
    plan, jf, _, _ = case(name)
    return j_hash.render_hash_grid_tiled(plan, jf, j_schedule(name, True))


def port_forward(name, use_kernel=True):
    _, _, pplan, pf = case(name)
    with torch.no_grad():
        return p_hash.render_hash_grid_tiled(pplan, pf, p_schedule(name),
                                             use_kernel=use_kernel)


@pytest.mark.parametrize("name", ["fixed", "stratified"])
def test_forward_matches_reference(name):
    """K8f's plain twin, composed, against JAX's render_hash_grid_tiled
    (its Pallas kernel in interpret mode)."""
    got, want = port_forward(name), j_forward(name)
    for key in ("image", "opacity", "transmittance"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)), atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=TOL_DEPTH)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(want.hitmask))
    assert float(got.opacity.max()) > 0.0


def test_wrapper_on_cpu_is_the_plain_twin():
    before = (p_hg.hash_grid_forward.launches,
              p_hg.hash_grid_backward.launches)
    a, b = port_forward("fixed"), port_forward("fixed", use_kernel=False)
    for key in ("image", "opacity", "transmittance", "depth"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    _port_grads("fixed")
    assert (p_hg.hash_grid_forward.launches,
            p_hg.hash_grid_backward.launches) == before


def test_kernel_inputs_checked():
    _, _, pplan, pf = case("fixed")
    sched = p_schedule("fixed")
    g = sched.groups[0]
    prm = p_hg.grid_op_params(pplan, pf.spec, g.banks, g.n_chunks)
    table = p_hg.build_hash_grid_table(dict(pf.params), pf.spec).detach()
    tabs = p_tiled._gather_bank_tables(table, sched.gathermap_all,
                                       [(g.n_tiles, g.banks)])[0]
    sc = p_ht.pack_mlp_scalars(dict(pf.params), pf.spec).detach()
    args = [tabs, g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1), sc]
    with pytest.raises(ValueError):
        p_hg.hash_grid_forward(tabs[:, :, :32], *args[1:], prm)
    with pytest.raises(TypeError):
        p_hg.hash_grid_forward(*args[:6], sc.double(), prm)
    with pytest.raises(ValueError):
        p_hg.hash_grid_backward(*args, torch.zeros((1, 5, 16, 16)), prm)
    with pytest.raises(P.DvrenError):          # still numpy: not on a device
        p_hash.render_hash_grid_tiled(
            pplan, pf, p_hash.build_hash_grid_schedule(pplan, pf))


# ----------------------------------------------------------- gradients


def _port_grads(name, target=0.25):
    _, _, pplan, pf = case(name)
    leaf = pf.with_params({k: v.detach().clone()
                           for k, v in pf.params.items()})
    img = p_hash.render_hash_grid_tiled(pplan, leaf, p_schedule(name)).image
    loss = torch.mean((img - target) ** 2)
    keys = sorted(leaf.params)
    return dict(zip(keys, torch.autograd.grad(
        loss, [leaf.params[k] for k in keys])))


def test_gradients_match_masked_streamed_referee():
    """Autograd through K8b's twin, the slot reduction and the table
    adjoint against jax.grad of the streamed referee under the grid
    path's zero-outside-the-cube semantic (tests/test_hash_grid.py:169-195),
    every params key."""
    plan, jf, _, _ = case("referee")
    target = jnp.full((plan.height, plan.width, 3), 0.25, jnp.float32)

    def loss_ref(params):
        f = jf.with_params(params)
        img = j_render(plan, _MaskedHash(f)).planes.image
        return jnp.mean((img - target) ** 2)

    want = jax.jit(jax.grad(loss_ref))(jf.params)
    got = _port_grads("referee")
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) / scale < REF_GRAD_TOL, k


def test_twin_adjoint_matches_autograd_of_twin_forward():
    """K8b's plain twin (the adjoint written out) against torch autograd of
    K8f's plain twin, on a field off the ties (random weights: no
    pre-activation or colour on a tie)."""
    _, _, pplan, pf = case("stratified")
    sched = p_schedule("stratified")
    table = p_hg.build_hash_grid_table(dict(pf.params), pf.spec).detach()
    tabs = p_tiled._gather_bank_tables(
        table, sched.gathermap_all,
        [(g.n_tiles, g.banks) for g in sched.groups])
    sc0 = p_ht.pack_mlp_scalars(dict(pf.params), pf.spec).detach()
    rng = np.random.default_rng(1)
    checked = 0
    for gi, g in enumerate(sched.groups):
        prm = p_hg.grid_op_params(pplan, pf.spec, g.banks, g.n_chunks)
        t = tabs[gi].clone().requires_grad_(True)
        sc = sc0.clone().requires_grad_(True)
        args = (g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1))
        raw = p_hg.hash_grid_forward_plain(t, *args, sc, prm)
        gs = torch.from_numpy(rng.normal(size=tuple(raw.shape)).astype(
            np.float32))
        want_t, want_sc = torch.autograd.grad((raw * gs).sum(), (t, sc))
        got_rows, got_sc = p_hg.hash_grid_backward(
            tabs[gi], *args, sc0, gs, prm)
        rel_close(got_rows.numpy(), want_t.transpose(2, 3).numpy(), TWIN_TOL)
        rel_close(got_sc.numpy(), want_sc.numpy(), TWIN_TOL)
        checked += 1
    assert checked == len(sched.groups) >= 1


def test_zero_field_tie_gradients():
    """All-zero field: every pre-activation, sigma and od = max(0 * dt, 0)
    sit on their ties, so only sigma_b2 gets a gradient: d mean(opacity)
    / d sigma_b2 = 0.5 (sigma's tie) * 0.5 (od's tie) * dt * (masked-in
    samples) / pixels. torch's relu and clamp backward would give 0."""
    _, _, pplan, pf = case("fixed")
    zero = pf.with_params({k: torch.zeros_like(v.detach())
                           for k, v in pf.params.items()})
    sched = p_schedule("fixed")
    out = p_hash.render_hash_grid_tiled(pplan, zero, sched)
    keys = sorted(zero.params)
    grads = dict(zip(keys, torch.autograd.grad(
        torch.mean(out.opacity), [zero.params[k] for k in keys])))
    want = 0.25 * pplan.sampling.dt * sched.tiled_samples / pplan.ray_count
    assert float(grads["sigma_b2"]) == pytest.approx(want, rel=1e-5)
    for k, v in grads.items():
        if k != "sigma_b2":
            assert float(v.abs().max()) == 0.0, k


def test_gradient_finite_difference():
    """Directional finite difference of the port's own loss."""
    _, _, pplan, pf = case("stratified")
    sched = p_schedule("stratified")

    def loss(f):
        out = p_hash.render_hash_grid_tiled(pplan, f, sched)
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


def test_backward_graph_has_no_accumulating_scatter():
    """No node of the grid path's backward graph is a traced gather or
    scatter (their backwards add with float atomics on CUDA)."""
    _, _, pplan, pf = case("fixed")
    out = p_hash.render_hash_grid_tiled(pplan, pf, p_schedule("fixed"))
    loss = torch.mean(out.image ** 2) + torch.mean(out.depth)
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    names = {type(n).__name__ for n in seen}
    assert "_HashGridGroupsetBackward" in names
    bad = {n for n in names if n.startswith(("Index", "Gather", "Scatter",
                                             "Put", "MaskedSelect"))}
    assert not bad, bad
