"""The fits' recorded steps (``opt/fit.py::_GraphedStep``,
``render/graph.py::capture_step``) on the CPU.

On a CUDA field a training step is recorded once as a CUDA graph and
replayed: the port's ``jax.jit`` of the step, and, replayed k times, of
its ``lax.scan`` block. On the CPU there is no graph to record, so a CPU
field's steps run eagerly; the recording path is held here through a
stand-in for the graph (tests/torch_graph_standin.py: a replay reruns
the recorded function, as tests/test_torch_graph.py's ``fake_graphs``
does). The inputs are
tests/test_torch_fit.py's "fit" scene (four 12^2 views of an 8^3 blob,
Adam lr 5e-2 from a flat 0.5 field) in the tiled, windowed and plain
modes, and a hash-MLP field over the same views (Adam lr 8e-3). Held:

- ``snapshot_step`` / ``restore_step``: a step, the restore, then n steps
  equal n steps of a fresh field and Adam bit for bit (losses,
  parameters, Adam's state), from a fresh Adam and from one two steps in;
- a CPU field's steps, blocks and fits record no graph and equal the
  eager body bit for bit;
- through the stand-in: the graphed step, block and fit equal the eager
  ones bit for bit, one recording per (parameters, targets), its warm-up
  undone; the recorded run uploads no camera and takes the capture-safe
  forms (``ops/grid.py::recording``), with the same bits; a new targets
  tensor or field records anew;
- ``check_capturable`` refuses an Adam that keeps its step count on the
  host, naming the fix;
- ``render_tiled_stack`` reads its fallback views' cameras from the
  tensors ``MergedViewSchedule.to`` uploaded once.

The JAX parity of the fits stays with tests/test_torch_fit.py and
tests/test_torch_fit_block.py; tests/test_torch_cuda.py holds the
recorded steps against the eager capturable ones on the card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import dvren_tpu as J
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests import torch_graph_standin as standin
from tests.test_torch_fit import flat_init, scene, targets_for

import dvren_tpu_torch as P
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import graph as p_graph
from dvren_tpu_torch.render import tiled as p_tiled
from dvren_tpu_torch.render.pipeline import plan_jitter_table

torch.set_num_threads(1)

MODES = ("tiled", "windowed", "plain", "hash")
LR = {"tiled": 5e-2, "windowed": 5e-2, "plain": 5e-2, "hash": 8e-3}
STEPS = 3


@functools.lru_cache(maxsize=None)
def views(mode):
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    return p_fit._scheduled_views(pplan, list(pcams), flat_init("fit")[1],
                                  mode)


def fresh(mode):
    """A new field at the mode's starting point."""
    if mode == "hash":
        return P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                          spec=P.HashMLPSpec(), device="cpu")
    pinit = flat_init("fit")[1]
    return pinit.with_params(pinit.sigma.detach().clone(),
                             pinit.color.detach().clone())


def adam(mode, f):
    return torch.optim.Adam(f.parameters(), lr=LR[mode], betas=(0.9, 0.999),
                            eps=1e-8)


def make(mode, f, opt):
    """The mode's training step over ``f``."""
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    if mode == "plain":
        return p_fit.make_train_step(pplan, list(pcams), f, opt)
    if mode == "hash":
        from dvren_tpu_torch.render.hash_tiled import build_hash_schedule_stack

        stack = build_hash_schedule_stack(p_fit.view_plans(pplan, pcams),
                                          device="cpu")
        return p_fit._hash_train_step(pplan, stack, opt)
    return p_fit.make_train_step_scheduled(pplan, list(pcams), f, opt,
                                           mode=mode, views=views(mode))


def targets():
    return torch.from_numpy(targets_for("fit", seed=1))


def run_fit(mode, steps=STEPS, **kw):
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    config = p_fit.FitConfig(learning_rate=LR[mode], steps=steps,
                             target_psnr=None, **kw)
    if mode == "hash":
        return p_fit.fit_hash_mlp(pplan, fresh(mode), list(pcams),
                                  targets_for("fit", seed=1), config)
    return p_fit.fit_dense_grid(pplan, fresh(mode), list(pcams),
                                targets_for("fit", seed=1), config,
                                mode=mode)


def words(t):
    return t.detach().contiguous().reshape(-1).view(torch.int32)


def assert_same(fa, opt_a, fb, opt_b, la=(), lb=()):
    """Losses, parameters and optimizer state equal bit for bit."""
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert torch.equal(words(a), words(b))
    pa, pb = list(fa.parameters()), list(fb.parameters())
    for a, b in zip(pa, pb):
        assert torch.equal(words(a), words(b))
    for a, b in zip(pa, pb):
        sa, sb = opt_a.state[a], opt_b.state[b]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(words(sa[k].float()), words(sb[k].float())), k


# -------------------------------------------------- snapshot and restore


@pytest.mark.parametrize("before", [0, 2])
@pytest.mark.parametrize("mode", MODES)
def test_restore_undoes_a_step(mode, before):
    """``before`` steps, a snapshot, a step (the warm-up), the restore,
    then STEPS steps: equal to ``before`` + STEPS steps of a fresh field
    and Adam, bit for bit."""
    t = targets()
    fa, fb = fresh(mode), fresh(mode)
    opt_a, opt_b = adam(mode, fa), adam(mode, fb)
    step_a, step_b = make(mode, fa, opt_a), make(mode, fb, opt_b)
    for _ in range(before):
        step_a.body(fa, t)
        step_b.body(fb, t)
    params = list(fa.parameters())
    snap = p_graph.snapshot_step(params, opt_a)
    warm = step_a.body(fa, t)
    moved = list(fa.parameters())[0].detach().clone()
    p_graph.restore_step(snap, params, opt_a)
    assert not torch.equal(moved, params[0].detach())
    la = [step_a.body(fa, t) for _ in range(STEPS)]
    lb = [step_b.body(fb, t) for _ in range(STEPS)]
    assert torch.equal(words(warm), words(la[0]))
    assert_same(fa, opt_a, fb, opt_b, la, lb)


# ------------------------------------------------ a CPU field: no graph


@pytest.fixture
def no_capture(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU field's step recorded a graph")

    monkeypatch.setattr(p_graph, "capture_step", refuse)
    monkeypatch.setattr(p_graph, "capture", refuse)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_steps_run_eagerly(no_capture, mode):
    """A CPU field's steps are the eager body's, bit for bit; no graph."""
    t = targets()
    fa, fb = fresh(mode), fresh(mode)
    opt_a, opt_b = adam(mode, fa), adam(mode, fb)
    step_a, step_b = make(mode, fa, opt_a), make(mode, fb, opt_b)
    la = [step_a(fa, t) for _ in range(STEPS)]
    lb = [step_b.body(fb, t) for _ in range(STEPS)]
    assert step_a.graph is None
    assert_same(fa, opt_a, fb, opt_b, la, lb)


@pytest.mark.parametrize("mode", ["tiled", "windowed"])
def test_cpu_block_runs_eagerly(no_capture, mode):
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    t = targets()
    fa, fb = fresh(mode), fresh(mode)
    opt_a, opt_b = adam(mode, fa), adam(mode, fb)
    block = p_fit.make_train_block_scheduled(pplan, list(pcams), fa, opt_a,
                                             STEPS, mode=mode,
                                             views=views(mode))
    step = make(mode, fb, opt_b)
    losses = block(fa, t)
    assert losses.shape == (STEPS,) and block.step.graph is None
    assert_same(fa, opt_a, fb, opt_b, losses,
                [step.body(fb, t) for _ in range(STEPS)])


@pytest.mark.parametrize("mode", MODES)
def test_cpu_fit_records_nothing(no_capture, mode):
    res = run_fit(mode)
    assert res.steps_run == STEPS and res.recorded_launches == {}
    assert res.capture_ms == 0.0


# ------------------------------------------- the recording, stood in for


@pytest.fixture
def fake_graphs():
    """Graphs on the CPU through the stand-in of
    tests/torch_graph_standin.py: the graphs recorded so far. The
    recorded run (and so every replay) may not upload the plan's camera,
    and it takes the capture-safe forms (``ops/grid.py::recording`` is
    true), as on the card. The CPU Adam keeps its step count on the host,
    which a rerun reads anew, so ``check_capturable`` stands aside here."""
    with standin.installed() as captured:
        yield captured


@pytest.mark.parametrize("mode", MODES)
def test_graphed_steps_equal_eager(fake_graphs, mode):
    """The recorded step's replays are the eager steps, bit for bit: the
    first replay is step 1 (the warm-up undone), one recording serves
    every step, each step's loss its own tensor. The windowed step's
    recording takes ``accumulate_rows``' fixed form."""
    t = targets()
    fa, fb = fresh(mode), fresh(mode)
    opt_a, opt_b = adam(mode, fa), adam(mode, fb)
    step_a, step_b = make(mode, fa, opt_a), make(mode, fb, opt_b)
    la = [step_a(fa, t) for _ in range(STEPS)]
    lb = [step_b.body(fb, t) for _ in range(STEPS)]
    assert len(fake_graphs) == 1 and step_a.graph is fake_graphs[0]
    assert len({x.data_ptr() for x in la}) == STEPS
    assert_same(fa, opt_a, fb, opt_b, la, lb)
    assert (len(fake_graphs.fixed_forms) > 0) == (mode in ("windowed",
                                                          "plain"))


@pytest.mark.parametrize("mode", ["tiled", "windowed"])
def test_graphed_block_equals_steps(fake_graphs, mode):
    """A block of k replays of the one recording equals k steps."""
    pplan, pcams = scene("fit")[3], scene("fit")[5]
    t = targets()
    fa, fb = fresh(mode), fresh(mode)
    opt_a, opt_b = adam(mode, fa), adam(mode, fb)
    block = p_fit.make_train_block_scheduled(pplan, list(pcams), fa, opt_a,
                                             STEPS, mode=mode,
                                             views=views(mode))
    step = make(mode, fb, opt_b)
    first = block(fa, t)
    singles = [step.body(fb, t) for _ in range(STEPS)]
    assert first.shape == (STEPS,) and len(fake_graphs) == 1
    assert_same(fa, opt_a, fb, opt_b, first, singles)
    again = block(fa, t)
    assert len(fake_graphs) == 1
    assert_same(fa, opt_a, fb, opt_b, again,
                [step.body(fb, t) for _ in range(STEPS)])


@pytest.mark.parametrize("mode", MODES)
def test_graphed_fit_equals_eager_fit(fake_graphs, mode):
    """A fit of 10 steps in blocks of 4, 4 and 2 records one graph and
    gives the eager fit's histories and field bit for bit."""
    got = run_fit(mode, steps=10, sync_every=4)
    assert len(fake_graphs) == 1
    with pytest.MonkeyPatch.context() as m:
        m.setattr(p_graph, "available", lambda device: False)
        want = run_fit(mode, steps=10, sync_every=4)
    assert got.loss_history == want.loss_history and got.steps_run == 10
    for a, b in zip(got.field.parameters(), want.field.parameters()):
        assert torch.equal(words(a), words(b))


def test_new_inputs_record_anew(fake_graphs):
    """A graph is keyed on the field's parameters and the targets: the
    same tensors replay, a new targets tensor or field records anew."""
    mode = "tiled"
    t = targets()
    fa = fresh(mode)
    step = make(mode, fa, adam(mode, fa))
    step(fa, t)
    step(fa, t)
    assert len(fake_graphs) == 1
    step(fa, t.clone())
    assert len(fake_graphs) == 2
    fb = fa.with_params(fa.sigma.detach().clone(), fa.color.detach().clone())
    step(fb, t)
    assert len(fake_graphs) == 3


# ------------------------------------------------------- the optimizer


def test_check_capturable():
    f = fresh("tiled")
    with pytest.raises(P.DvrenError, match="capturable=True"):
        p_graph.check_capturable(adam("tiled", f))
    p_graph.check_capturable(torch.optim.Adam(f.parameters(),
                                              capturable=True))
    p_graph.check_capturable(torch.optim.SGD(f.parameters(), lr=1e-3))


def test_fits_build_adam_by_device():
    """The fits' Adam keeps optax's defaults; capturable only on CUDA
    (this torch refuses it on the CPU)."""
    opt = p_fit._adam(fresh("tiled"), 5e-2)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["lr"] == 5e-2 and group["capturable"] is False


# ------------------------------------------ the stack's fallback cameras


def test_stack_fallback_cameras_uploaded_once(monkeypatch):
    """``render_tiled_stack`` on merged views with fallback rays reads each
    view's camera from ``view_cam_tensors``, uploaded once by ``.to``
    (tests/test_torch_fallback.py holds the stack to JAX's), and refuses
    a merged schedule without them."""
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED, n=32)
    pplan, pfield = port_plan(plan), port_field(field)
    cams = [P.CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.55, 0, 0, 1,
                                -1.1)) for dx in (0.0, 0.15)]
    pplans = p_fit.view_plans(pplan, cams)
    jitter = plan_jitter_table(pplan)
    scheds = [p_tiled.build_tiled_schedule(p, pfield, jitter=jitter,
                                           tile_px=16, quantize=True)
              for p in pplans]
    assert any(s.fallback_rays > 0 for s in scheds)
    merged = p_tiled.merge_view_schedules(scheds, plans=pplans).to("cpu")
    for (k, c2w, ortho), p in zip(merged.view_cam_tensors, pplans):
        np.testing.assert_array_equal(k.numpy().reshape(-1),
                                      np.asarray(p.camera.k, np.float32))
        np.testing.assert_array_equal(c2w.numpy().reshape(-1),
                                      np.asarray(p.camera.c2w, np.float32))
        assert float(ortho) == np.float32(p.camera.ortho_scale)

    def render(m):
        leaf = pfield.with_params(pfield.sigma.detach().clone(),
                                  pfield.color.detach().clone())
        stack = p_tiled.render_tiled_stack(pplan, leaf, m)
        torch.autograd.grad(torch.mean(stack ** 2), (leaf.sigma, leaf.color))
        return stack

    with monkeypatch.context() as m:
        m.setattr(p_tiled, "_view_cam_tensors", lambda *a, **k: pytest.fail(
            "a view's camera uploaded at render time"))
        assert torch.isfinite(render(merged)).all()
    bare = dataclasses.replace(merged, view_cam_tensors=None)
    with pytest.raises(P.DvrenError, match="to\\(device\\)"):
        render(bare)
