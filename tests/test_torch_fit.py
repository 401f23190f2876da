"""Multi-view training of dvren_tpu_torch against dvren_tpu, on the CPU:
quantized schedules, merged view schedules, the stack renderer,
``fit_dense_grid`` and the ``.npz`` checkpoints.

Same seeded inputs through both packages: tests/test_fit.py's scene (12^2
views of an 8^3 blob, 25 fixed steps, four views on a translation row)
and tests/test_tiled.py::scene (48x32 over 8^3 in a bbox, 60 stratified
steps) seen from three views. The JAX side runs its numpy schedule
builder, its reference consumer (``render_tiled_stack(use_kernel=False)``)
and ``jax.grad`` of it; its ``fit_dense_grid(mode="tiled")`` runs the
Pallas kernels in interpret mode, as its own suite runs them on the CPU.
Held:

- quantized schedules (``quantize=True``, ``"uniform"``, ``uniform_shape``)
  equal to JAX's array for array, at 16 px cells and 8 px supercells, and
  rendering the unquantized frame bit for bit;
- ``_scheduled_views``' merged schedule (cascade, uniform shapes, global
  rebuild, merge) and a many-group merge equal to JAX's, ``view_slices``
  and ``view_cams`` included;
- ``render_tiled_stack`` within 5e-6 of JAX's, its grid gradients within
  2e-6 x scale of ``jax.grad``, and each view equal to its own frame;
- ``fit_dense_grid(mode="tiled")``: the loss history within rtol 1e-4 of
  JAX's over 5 Adam steps and the fitted grids within 1e-4; ``sync_every``
  changes nothing; the projection holds; the auto mode chooses as JAX's;
  what is not ported raises ``NotImplementedError`` naming its item;
- checkpoints written by either package load in the other.

tests/test_torch_cuda.py runs the stack and the fit on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.hash_mlp import HashMLPField as JHash
from dvren_tpu.io import checkpoint as j_ckpt
from dvren_tpu.ops.hashmlp import HashMLPSpec as JSpec
from dvren_tpu.opt import fit as j_fit
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests import test_fit
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.io import checkpoint as p_ckpt
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
GRID_TOL = 2e-6       # x max |reference|
LOSS_RTOL = 1e-4
FIELD_TOL = 1e-4
FIT_STEPS = 5


def port_cameras(cams):
    return [P.CameraConfig(c2w=tuple(c.c2w)) for c in cams]


@functools.lru_cache(maxsize=None)
def scene(name):
    """(JAX plan, JAX field, JAX cameras, port plan, port field, port
    cameras) of one multi-view scene."""
    if name == "fit":
        plan, field, cams = (test_fit.make_plan(), test_fit.truth_field(),
                             test_fit.cameras())
    else:
        plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED)
        cams = [J.CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.55, 0, 0,
                                    1, -1.1)) for dx in (-0.1, 0.0, 0.1)]
    return (plan, field, tuple(cams), port_plan(plan), port_field(field),
            tuple(port_cameras(cams)))


def both_plans(name):
    plan, _, cams, pplan, _, pcams = scene(name)
    return j_fit.view_plans(plan, cams), p_fit.view_plans(pplan, pcams)


def rel_close(got, ref, tol):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale)


def targets_for(name, seed=0):
    plan, _, cams, _, _, _ = scene(name)
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (len(cams), plan.height, plan.width, 3)
                       ).astype(np.float32)


# ------------------------------------------------------ quantized shapes


def _quant_kwargs(kind, plan, field, form):
    """The builder keywords of one quantization kind; ``"shape"`` pins a
    class above the uniform schedule's maxima."""
    if kind == "true":
        return dict(quantize=True)
    if kind == "uniform":
        return dict(quantize="uniform")
    u = j_tiled.build_tiled_schedule(
        plan, field, tile_px=form[0], cell_scale=form[1], quantize="uniform",
        device=False, build_fallback=False)
    g = u.groups[0]
    return dict(quantize="uniform", uniform_shape=(g.n_chunks + 1,
                                                   g.banks + 2))


@pytest.mark.parametrize("form", [(16, 1), (8, 2)])
@pytest.mark.parametrize("kind", ["true", "uniform", "shape"])
@pytest.mark.parametrize("name", ["fit", "tiled"])
def test_quantized_schedule_equal(name, kind, form):
    jplans, pplans = both_plans(name)
    _, field, _, _, pfield, _ = scene(name)
    plan, pplan = jplans[1], pplans[1]
    kw = _quant_kwargs(kind, plan, field, form)
    ref = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), tile_px=form[0],
        cell_scale=form[1], device=False, build_fallback=False, **kw)
    got = p_tiled.build_tiled_schedule(pplan, pfield, tile_px=form[0],
                                       cell_scale=form[1], **kw)
    assert got.fallback_rays == 0 and got.groups
    assert_schedules_equal(ref, got)
    if kind != "true":
        assert len({(g.n_chunks, g.banks) for g in got.groups}) == 1
    if kind == "shape":
        assert (got.groups[0].n_chunks, got.groups[0].banks) == \
            kw["uniform_shape"]


@pytest.mark.parametrize("form", [(16, 1), (8, 2)])
@pytest.mark.parametrize("kind", ["true", "uniform", "shape"])
def test_quantized_frame_bit_equal(kind, form):
    """Padded chunks hold masked samples and padded banks are never read:
    the quantized schedule renders the unquantized frame bit for bit."""
    jplans, pplans = both_plans("tiled")
    _, field, _, _, pfield, _ = scene("tiled")
    kw = _quant_kwargs(kind, jplans[0], field, form)
    plain = p_tiled.build_tiled_schedule(pplans[0], pfield, tile_px=form[0],
                                         cell_scale=form[1]).to("cpu")
    quant = p_tiled.build_tiled_schedule(pplans[0], pfield, tile_px=form[0],
                                         cell_scale=form[1], **kw).to("cpu")
    with torch.no_grad():
        a = p_tiled.render_tiled(pplans[0], pfield, plain)
        b = p_tiled.render_tiled(pplans[0], pfield, quant)
    for key in ("image", "transmittance", "opacity", "depth"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert float(a.opacity.max()) > 0.0


def test_uniform_shape_below_maximum_raises():
    _, pplans = both_plans("tiled")
    pfield = scene("tiled")[4]
    with pytest.raises(P.DvrenError, match="uniform_shape"):
        p_tiled.build_tiled_schedule(pplans[0], pfield, uniform_shape=(1, 1))


@pytest.mark.parametrize("kw, item", [(dict(all_tiles=True), "item 15"),
                                      (dict(bank_aligned=True), "on purpose")])
def test_unported_schedule_options_raise(kw, item):
    _, pplans = both_plans("fit")
    with pytest.raises(NotImplementedError, match=item):
        p_tiled.build_tiled_schedule(pplans[0], scene("fit")[4], **kw)


# ---------------------------------------------------------- merged views


@functools.lru_cache(maxsize=None)
def views(name):
    """(JAX _scheduled_views, port _scheduled_views) for mode "tiled"."""
    plan, field, cams, pplan, pfield, pcams = scene(name)
    return (j_fit._scheduled_views(plan, list(cams), field, "tiled"),
            p_fit._scheduled_views(pplan, list(pcams), pfield, "tiled"))


def assert_merged_equal(ref, got):
    assert_schedules_equal(ref.sched, got.sched)
    for key in ("all_idx", "inv_map"):
        np.testing.assert_array_equal(
            getattr(got.sched.gather_plan, key),
            np.asarray(getattr(ref.sched.gather_plan, key)), err_msg=key)
    assert got.sched.gather_plan.meta == tuple(ref.sched.gather_plan.meta)
    assert got.view_slices == ref.view_slices
    assert got.n_views == ref.n_views
    assert got.view_cams == ref.view_cams
    assert all(f is None for f in ref.view_fallbacks)
    assert got.view_fallbacks == (None,) * got.n_views


@pytest.mark.parametrize("name", ["fit", "tiled"])
def test_scheduled_views_merge_equal(name):
    """View 0 through the cascade with uniform shapes, the others at its
    form, all at the global (nc, nb) maxima, merged into one group."""
    (_, ref, _), (_, got, _) = views(name)
    assert len(got.sched.groups) == 1
    assert got.sched.device == torch.device("cpu")
    assert_merged_equal(ref, _host(got))


def _host(merged):
    """A merged schedule's arrays back as numpy, for comparison."""
    return p_tiled.MergedViewSchedule(
        sched=_sched_host(merged.sched), view_fallbacks=merged.view_fallbacks,
        view_slices=merged.view_slices, n_views=merged.n_views,
        view_cams=merged.view_cams)


def _sched_host(sched):
    def np_(x):
        return x.numpy() if isinstance(x, torch.Tensor) else x

    groups = tuple(dataclasses.replace(g, **{
        f.name: np_(getattr(g, f.name)) for f in dataclasses.fields(g)})
        for g in sched.groups)
    gp = sched.gather_plan
    gp = dataclasses.replace(gp, **{
        f.name: np_(getattr(gp, f.name)) for f in dataclasses.fields(gp)})
    return dataclasses.replace(sched, groups=groups,
                               hostmap_all=np_(sched.hostmap_all),
                               gathermap_all=np_(sched.gathermap_all),
                               gather_plan=gp)


def test_many_group_merge_equal():
    """Views quantized by class (not uniform) merge by (nc, nb) key: groups
    of several views, view-major slices, the gather plan over the
    concatenated hostmaps."""
    jplans, pplans = both_plans("tiled")
    _, field, _, _, pfield, _ = scene("tiled")
    ref = j_tiled.merge_view_schedules(
        [j_tiled.build_tiled_schedule(p, field, quantize=True, device=False,
                                      build_fallback=False)
         for p in jplans], plans=jplans)
    got = p_tiled.merge_view_schedules(
        [p_tiled.build_tiled_schedule(p, pfield, quantize=True)
         for p in pplans], plans=pplans)
    assert len(got.sched.groups) > 1
    assert any(len(s) > 1 for s in got.view_slices)
    assert_merged_equal(ref, got)


def test_merge_refuses_fallback_view():
    """A view whose tiles overflow (16 px over 128^3) needs the windowed
    fallback."""
    n = 128
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n, n, n), sigma=np.ones(n ** 3), color=np.ones(3 * n ** 3)),
        device="cpu")
    plan = P.Plan.create(P.PlanConfig(
        width=16, height=16, t_near=0.1, t_far=3.1, seed=17,
        camera=P.CameraConfig(k=(16.0, 0, 8.0, 0, 16.0, 8.0, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.1)),
        sampling=P.SamplingConfig(dt=0.05, max_steps=60)))
    sched = p_tiled.build_tiled_schedule(plan, field)
    assert sched.fallback_rays > 0
    with pytest.raises(NotImplementedError, match="item 11"):
        p_tiled.merge_view_schedules([sched])


# ------------------------------------------------------- stack renderer


@functools.lru_cache(maxsize=None)
def jax_stack(name):
    """JAX's reference stack and ``jax.grad`` of the MSE against
    ``targets_for(name)`` in (sigma, color), in one trace."""
    plan, field, _, _, _, _ = scene(name)
    (_, merged, _), _ = views(name)
    target = jnp.asarray(targets_for(name))

    def loss(sigma, color):
        img = j_tiled.render_tiled_stack(
            plan, field.with_params(sigma, color), merged, use_kernel=False)
        return jnp.mean((img - target) ** 2), img

    (_, img), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        field.sigma, field.color)
    return np.asarray(img), tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("name", ["fit", "tiled"])
def test_render_tiled_stack_matches_jax(name):
    pfield = scene(name)[4]
    _, (_, merged, render_stack) = views(name)
    want, _ = jax_stack(name)
    with torch.no_grad():
        got = render_stack(pfield, merged)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert float(got.max()) > 0.0


@pytest.mark.parametrize("name", ["fit", "tiled"])
def test_render_tiled_stack_gradients_match_jax(name):
    pplan, pfield = scene(name)[3:5]
    _, (_, merged, _) = views(name)
    _, want = jax_stack(name)
    leaf = pfield.with_params(pfield.sigma.detach().clone(),
                              pfield.color.detach().clone())
    img = p_tiled.render_tiled_stack(pplan, leaf, merged)
    loss = torch.mean((img - torch.from_numpy(targets_for(name))) ** 2)
    got = torch.autograd.grad(loss, (leaf.sigma, leaf.color))
    for a, b in zip(got, want):
        assert float(np.abs(b).max()) > 0.0
        rel_close(a.numpy(), b, GRID_TOL)


@pytest.mark.parametrize("name", ["fit", "tiled"])
def test_stack_views_equal_their_frames(name):
    """Each view of the stack equals its own frame through the same
    schedule form: merging moves no sample."""
    _, pplans = both_plans(name)
    pfield = scene(name)[4]
    _, (_, merged, render_stack) = views(name)
    sched = merged.sched
    with torch.no_grad():
        stack = render_stack(pfield, merged)
        for v, pv in enumerate(pplans):
            own = p_tiled.build_tiled_schedule(
                pv, pfield, tile_px=sched.tile_px,
                cell_scale=sched.cell_scale).to("cpu")
            frame = p_tiled.render_tiled(pv, pfield, own).image
            np.testing.assert_allclose(stack[v].numpy(), frame.numpy(),
                                       atol=TOL)


def test_stack_kernel_flag_and_device_checks():
    pplan, pfield = scene("fit")[3:5]
    _, (_, merged, _) = views("fit")
    with torch.no_grad():
        a = p_tiled.render_tiled_stack(pplan, pfield, merged)
        b = p_tiled.render_tiled_stack(pplan, pfield, merged,
                                       use_kernel=False)
    assert torch.equal(a, b)
    host = _host(merged)
    with pytest.raises(P.DvrenError, match="merged schedule"):
        p_tiled.render_tiled_stack(pplan, pfield, host)


# ------------------------------------------------------------- the fit


def fit_config(**kw):
    base = dict(learning_rate=5e-2, steps=FIT_STEPS, target_psnr=None)
    base.update(kw)
    return base


def flat_init(name):
    """tests/test_fit.py's starting point: sigma and colour at 0.5."""
    _, field, _, _, pfield, _ = scene(name)
    jinit = field.with_params(jnp.full_like(field.sigma, 0.5),
                              jnp.full_like(field.color, 0.5))
    pinit = pfield.with_params(torch.full_like(pfield.sigma, 0.5),
                               torch.full_like(pfield.color, 0.5))
    return jinit, pinit


@functools.lru_cache(maxsize=None)
def fits(name, **kw):
    plan, _, cams, pplan, _, pcams = scene(name)
    jinit, pinit = flat_init(name)
    targets = targets_for(name, seed=1)
    cfg = fit_config(**kw)
    ref = j_fit.fit_dense_grid(plan, jinit, list(cams), targets,
                               j_fit.FitConfig(**cfg), mode="tiled")
    got = p_fit.fit_dense_grid(pplan, pinit, list(pcams), targets,
                               p_fit.FitConfig(**cfg), mode="tiled")
    return ref, got


def test_fit_dense_grid_matches_jax():
    ref, got = fits("fit")
    assert got.mode == ref.mode == "tiled"
    assert got.steps_run == ref.steps_run == FIT_STEPS
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.psnr_history, ref.psnr_history,
                               rtol=LOSS_RTOL)
    assert got.loss_history[-1] < got.loss_history[0]
    np.testing.assert_allclose(got.field.sigma.detach().numpy(),
                               np.asarray(ref.field.sigma), atol=FIELD_TOL)
    np.testing.assert_allclose(got.field.color.detach().numpy(),
                               np.asarray(ref.field.color), atol=FIELD_TOL)
    assert got.schedule_build_s > 0.0 and got.first_step_s > 0.0
    assert got.steady_step_ms > 0.0
    assert got.wall_clock_s >= got.schedule_build_s


def test_fit_leaves_input_field():
    _, got = fits("fit")
    _, pinit = flat_init("fit")
    assert got.field is not pinit
    sigma = pinit.sigma.detach()
    assert float(sigma.min()) == float(sigma.max()) == 0.5


def test_fit_sync_every_changes_nothing():
    """Steps run one by one either way: sync_every=4 only batches the host
    copies of the losses (10 steps: two full blocks and a remainder)."""
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    _, pinit = flat_init("fit")
    targets = targets_for("fit", seed=1)
    a = p_fit.fit_dense_grid(pplan, pinit, list(pcams), targets,
                             p_fit.FitConfig(**fit_config(steps=10)),
                             mode="tiled")
    ckpts = []
    b = p_fit.fit_dense_grid(
        pplan, pinit, list(pcams), targets,
        p_fit.FitConfig(**fit_config(steps=10, sync_every=4, log_every=5)),
        mode="tiled", checkpoint_cb=lambda f, s, p: ckpts.append(
            (s, float(f.sigma.detach().sum()))))
    assert b.steps_run == 10 and len(b.loss_history) == 10
    assert b.loss_history == a.loss_history
    assert torch.equal(b.field.sigma, a.field.sigma)
    assert torch.equal(b.field.color, a.field.color)
    # the JAX fit's cadence in steps: at the sync points past 5 and 10
    assert [s for s, _ in ckpts] == [8, 10]


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_fit_projection_holds(target):
    """After every step sigma >= sigma_min and colour in [0, 1]: at a
    large rate toward a black (white) target the lower (upper) bounds
    bind."""
    plan, pcams = scene("fit")[3], scene("fit")[5]
    _, pinit = flat_init("fit")
    targets = np.full((len(pcams), plan.height, plan.width, 3), target,
                      np.float32)
    res = p_fit.fit_dense_grid(
        plan, pinit, list(pcams), targets,
        p_fit.FitConfig(**fit_config(learning_rate=2.0, steps=3,
                                     sigma_min=0.1)), mode="tiled")
    sigma, color = res.field.sigma.detach(), res.field.color.detach()
    assert float(sigma.min()) >= np.float32(0.1)
    assert float(color.min()) >= 0.0 and float(color.max()) <= 1.0
    if target == 0.0:
        assert float(sigma.min()) == np.float32(0.1)
        assert float(color.min()) == 0.0
    else:
        assert float(color.max()) == 1.0


def test_fit_target_psnr_stops():
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    _, pinit = flat_init("fit")
    res = p_fit.fit_dense_grid(
        pplan, pinit, list(pcams), targets_for("fit", seed=1),
        p_fit.FitConfig(**fit_config(steps=10, target_psnr=-100.0)),
        mode="tiled")
    assert res.reached_target and res.steps_run == 1


@pytest.mark.parametrize("name", ["fit", "tiled"])
def test_auto_mode_choice_equal(name):
    """The auto mode's choice (tiled, or windowed when the merged tables'
    weighted slots outnumber the views' sample lattice) as JAX's; the
    port raises for the windowed choice. Zero steps: the choice alone."""
    plan, field, cams, pplan, pfield, pcams = scene(name)
    targets = targets_for(name)
    ref = j_fit.fit_dense_grid(plan, field, list(cams), targets,
                               j_fit.FitConfig(steps=0))
    assert p_fit.scheduled_mode_for(pfield) == j_fit.scheduled_mode_for(
        field) == "tiled"
    if ref.mode == "tiled":
        got = p_fit.fit_dense_grid(pplan, pfield, list(pcams), targets,
                                   p_fit.FitConfig(steps=0))
        assert got.mode == "tiled" and got.steps_run == 0
    else:
        assert ref.mode == "windowed"
        with pytest.raises(NotImplementedError, match="item 11"):
            p_fit.fit_dense_grid(pplan, pfield, list(pcams), targets,
                                 p_fit.FitConfig(steps=0))


def test_auto_mode_covers_both_choices():
    """The two scenes take both branches of the table-economy check."""
    modes = set()
    for name in ("fit", "tiled"):
        plan, field, cams = scene(name)[:3]
        modes.add(j_fit.fit_dense_grid(plan, field, list(cams),
                                       targets_for(name),
                                       j_fit.FitConfig(steps=0)).mode)
    assert modes == {"tiled", "windowed"}


@pytest.mark.parametrize("mode, item", [("windowed", "item 11"),
                                        ("plain", "item 4")])
def test_unported_fit_modes_raise(mode, item):
    pplan, pfield, pcams = scene("fit")[3:]
    with pytest.raises(NotImplementedError, match=item):
        p_fit.fit_dense_grid(pplan, pfield, list(pcams), targets_for("fit"),
                             p_fit.FitConfig(steps=1), mode=mode)


def test_scheduled_mode_for_rules():
    pfield = scene("fit")[4]
    assert p_fit.scheduled_mode_for(pfield) == "tiled"
    nearest = P.DenseGridField(pfield.sigma, pfield.color,
                               interp=P.InterpMode.NEAREST)
    assert p_fit.scheduled_mode_for(nearest) == "windowed"
    clamp = P.DenseGridField(pfield.sigma, pfield.color,
                             oob=P.OobPolicy.CLAMP)
    assert p_fit.scheduled_mode_for(clamp) is None
    hashed = P.HashMLPField.create(P.HashMLPConfig(), device="cpu")
    assert p_fit.scheduled_mode_for(hashed) is None


# ---------------------------------------------------------- checkpoints


def test_dense_checkpoint_crosses_packages(tmp_path):
    _, field, _, _, pfield, _ = scene("tiled")
    j_ckpt.save_dense_grid(tmp_path / "j.npz", field, extra={"step": 7})
    got, extra = p_ckpt.load_dense_grid(tmp_path / "j.npz", device="cpu")
    assert extra == {"step": 7}
    np.testing.assert_array_equal(got.sigma.detach().numpy(),
                                  np.asarray(field.sigma))
    np.testing.assert_array_equal(got.color.detach().numpy(),
                                  np.asarray(field.color))
    assert (got.bbox_min, got.bbox_max) == (field.bbox_min, field.bbox_max)
    assert int(got.interp) == int(field.interp)
    assert int(got.oob) == int(field.oob)

    p_ckpt.save_dense_grid(tmp_path / "p.npz", pfield, extra={"psnr": 30.5})
    back, extra = j_ckpt.load_dense_grid(tmp_path / "p.npz")
    assert extra == {"psnr": 30.5}
    np.testing.assert_array_equal(np.asarray(back.sigma),
                                  pfield.sigma.detach().numpy())
    np.testing.assert_array_equal(np.asarray(back.color),
                                  pfield.color.detach().numpy())
    assert back.bbox_min == pfield.bbox_min
    assert back.bbox_max == pfield.bbox_max


def test_hash_checkpoint_crosses_packages(tmp_path):
    kw = dict(n_levels=3, features_per_level=2, table_size=4096,
              hidden_dim=8, base_resolution=2.0, finest_resolution=8.0)
    jf = JHash.init_random(jax.random.PRNGKey(3), JSpec(**kw))
    j_ckpt.save_hash_mlp(tmp_path / "j.npz", jf, extra={"step": 3})
    got, extra = p_ckpt.load_hash_mlp(tmp_path / "j.npz", device="cpu")
    assert extra == {"step": 3} and got.spec == P.HashMLPSpec(**kw)
    assert set(got.params) == set(jf.params)
    for k, v in jf.params.items():
        np.testing.assert_array_equal(got.params[k].detach().numpy(),
                                      np.asarray(v), err_msg=k)

    pf = P.HashMLPField.init_random(torch.Generator().manual_seed(4),
                                    spec=P.HashMLPSpec(**kw), device="cpu")
    p_ckpt.save_hash_mlp(tmp_path / "p.npz", pf)
    back, extra = j_ckpt.load_hash_mlp(tmp_path / "p.npz")
    assert extra == {} and back.spec == JSpec(**kw)
    for k, v in pf.params.items():
        np.testing.assert_array_equal(np.asarray(back.params[k]),
                                      v.detach().numpy(), err_msg=k)


def test_checkpoint_kind_checked(tmp_path):
    pfield = scene("fit")[4]
    p_ckpt.save_dense_grid(tmp_path / "g.npz", pfield)
    with pytest.raises(P.DvrenError, match="kind"):
        p_ckpt.load_hash_mlp(tmp_path / "g.npz", device="cpu")
