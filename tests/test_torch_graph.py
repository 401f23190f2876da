"""``enable_graph`` and the tiled stage timings of dvren_tpu_torch's Renderer
on a CPU context, and the helpers CUDA graph capture leans on.

- ``enable_graph`` on a CPU context: there is no CUDA graph to record, so
  every mode renders eagerly, its frame (and the tiled, windowed and
  streamed backward) bit for bit the frame without the option, with the
  note ``graph_capture=none:cpu`` and no ``graph_executed``. (The JAX
  package AOT-compiles on its CPU too; on the card the port records and
  replays, ``tests/test_torch_cuda.py``.)
- ``capture_stats`` on the tiled path fills ``sample_ms``,
  ``integrate_ms`` and ``compose_ms`` from the stage clock of the frame
  it renders, above 0 and cached per (schedule, field metadata), with
  JAX's note (JAX's
  ``tests/test_renderer_streaming.py::test_tiled_stage_stats_fill``),
  and leaves that frame bit for bit the frame rendered without it.
- The host steps a graph cannot record are kept out of the paths it
  records: under a capture ``accumulate_rows`` takes its fixed-shape
  form, bit-equal to the sort / unique / segment sums it runs eagerly;
  the Renderer uploads its camera once and passes it to its paths.
- A graph's recorded function holds its schedule: a schedule rebuilt
  between frames records anew (a stand-in for the graph on the CPU).
- ``graph.capture`` refuses a CPU device; ``tensor_key`` and
  ``clone_outputs``.
"""

import functools
import weakref

import numpy as np
import pytest
import torch

import dvren_tpu as J
from tests.test_tiled import scene
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.ops import raygen as p_raygen
from dvren_tpu_torch.render import graph as p_graph
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

STAGE_NOTE = ("stage_ms=decomposed_replay(sample=tables,integrate=kernel,"
              "compose=compose)")
MODES = {
    "tiled": dict(use_tiles=True),
    "windowed": dict(use_window=True),
    "streamed": dict(streaming=True),
    "fused": dict(use_tiles=False),
}


@functools.lru_cache(maxsize=None)
def small_scene(mode="fixed"):
    plan, field = scene(mode=(J.SamplingMode.STRATIFIED
                              if mode == "stratified"
                              else J.SamplingMode.FIXED))
    return plan, field


def renderer(plan, **options):
    return P.Renderer(P.Context.create(device="cpu"), port_plan(plan),
                      P.RenderOptions(**options))


@pytest.mark.parametrize("sampling", ["fixed", "stratified"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_enable_graph_on_the_cpu_runs_eagerly(mode, sampling):
    plan, field = small_scene(sampling)
    pf = port_field(field)
    graphed = renderer(plan, enable_graph=True, **MODES[mode])
    eager = renderer(plan, **MODES[mode])
    got, want = graphed.forward(pf), eager.forward(pf)
    assert graphed._last_mode == eager._last_mode == mode
    assert "graph_capture=none:cpu" in got.stats.notes
    assert "graph_executed" not in got.stats.notes
    assert not any(n.startswith("graph_captured") for n in got.stats.notes)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    if mode == "fused":
        return
    dl = np.random.default_rng(4).normal(
        size=(plan.ray_count, 3)).astype(np.float32)
    g_got, g_want = graphed.backward(pf, dl), eager.backward(pf, dl)
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(g_got, key),
                                      getattr(g_want, key), err_msg=key)


def test_enable_graph_on_the_cpu_hash_field():
    from tests.test_torch_hash import case
    _, _, pplan, pf = case("fixed")
    got = P.Renderer(P.Context.create(device="cpu"), pplan, P.RenderOptions(
        use_tiles=True, enable_graph=True)).forward(pf)
    want = P.Renderer(P.Context.create(device="cpu"), pplan,
                      P.RenderOptions(use_tiles=True)).forward(pf)
    assert "graph_capture=none:cpu" in got.stats.notes
    np.testing.assert_array_equal(got.image, want.image)


@functools.lru_cache(maxsize=None)
def jax_stage_notes():
    plan, field = small_scene()
    fr = J.Renderer(J.Context.create(), plan, J.RenderOptions(
        use_tiles=True, capture_stats=True)).forward(field)
    return fr.stats


def test_tiled_stage_stats_fill():
    """JAX's ``test_tiled_stage_stats_fill`` on the port: the note, every
    stage above 0, the second forward reusing the cached times."""
    plan, field = small_scene()
    pf = port_field(field)
    r = renderer(plan, use_tiles=True, capture_stats=True)
    fr = r.forward(pf)
    assert "tiled_path" in fr.stats.notes
    assert STAGE_NOTE in fr.stats.notes
    assert STAGE_NOTE in jax_stage_notes().notes
    assert fr.stats.sample_ms > 0 and fr.stats.integrate_ms > 0 \
        and fr.stats.compose_ms > 0
    assert fr.stats.ray_ms == 0.0 == jax_stage_notes().ray_ms
    fr2 = r.forward(pf)
    assert (fr2.stats.sample_ms, fr2.stats.integrate_ms,
            fr2.stats.compose_ms) == (fr.stats.sample_ms,
                                      fr.stats.integrate_ms,
                                      fr.stats.compose_ms)
    # a field with other metadata measures again; without capture_stats
    # nothing is measured
    fr3 = r.forward(pf.with_packed_dtype("bfloat16"))
    assert STAGE_NOTE in fr3.stats.notes and fr3.stats.sample_ms > 0
    quiet = renderer(plan, use_tiles=True, capture_stats=False).forward(pf)
    assert STAGE_NOTE not in quiet.stats.notes
    assert quiet.stats.integrate_ms == 0.0


@pytest.mark.parametrize("form", ["f32", "bfloat16", "sparse", "supercell",
                                  "fallback"])
def test_capture_stats_leaves_the_tiled_frame(form, monkeypatch):
    """The frame ``capture_stats`` times is the frame the Renderer renders
    without it, bit for bit, in every table route and with the windowed
    fallback, and each of its stages took time."""
    if form == "fallback":
        from tests.test_torch_fallback import partial_scene
        plan, field = partial_scene()
    else:
        plan, field = small_scene("stratified")
    pf = port_field(field)
    kw = {}
    if form == "bfloat16":
        pf = pf.with_packed_dtype("bfloat16")
    elif form == "sparse":
        pf = P.SparseGridField.from_dense(pf, threshold=0.0, device="cpu")
    elif form == "supercell":
        kw = dict(cell_scale=2)
    elif form == "fallback":
        kw = dict(tile_px=8)    # the scene's 8 px tiles partly overflow
    monkeypatch.setattr(
        p_tiled, "build_tiled_schedule_auto",
        lambda plan, field, **opts: (p_tiled.build_tiled_schedule(
            plan, field, **opts, **kw), None))
    timed = renderer(plan, use_tiles=True, capture_stats=True)
    got = timed.forward(pf)
    want = renderer(plan, use_tiles=True, capture_stats=False).forward(pf)
    assert (timed._tiled_schedule.fallback_rays > 0) == (form == "fallback")
    assert timed._tiled_schedule.cell_scale == (2 if form == "supercell"
                                                else 1)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    assert min(got.stats.sample_ms, got.stats.integrate_ms,
               got.stats.compose_ms) > 0


def test_accumulate_rows_fixed_equals_the_segment_sums():
    """``accumulate_rows_fixed``, the form a CUDA graph records, gives the
    bits of ``accumulate_rows``' sort, ``unique_consecutive`` and segment
    sums (spelled out here as the reference)."""
    def reference(dst, idx, rows):
        keys, order = torch.sort(idx, stable=True)
        uniq, counts = torch.unique_consecutive(keys, return_counts=True)
        dst[uniq] += torch.segment_reduce(rows[order], "sum",
                                          lengths=counts, axis=0)
        return dst

    gen = torch.Generator().manual_seed(7)
    for n_dst, n, cols in ((50, 400, 7), (3, 1, 2), (9, 64, 32)):
        idx = torch.randint(0, n_dst, (n,), generator=gen)
        rows = torch.randn((n, cols), generator=gen) * 1e3
        dst = torch.randn((n_dst, cols), generator=gen)
        want = reference(dst.clone(), idx, rows)
        assert torch.equal(p_grid.accumulate_rows_fixed(dst.clone(), idx,
                                                        rows), want)
        assert torch.equal(p_grid.accumulate_rows(dst.clone(), idx, rows),
                           want)
    empty = torch.zeros((4, 2))
    for fn in (p_grid.accumulate_rows, p_grid.accumulate_rows_fixed):
        assert torch.equal(fn(empty.clone(), torch.zeros(0, dtype=torch.int64),
                              torch.zeros((0, 2))), empty)


def test_renderer_uploads_its_camera_once(monkeypatch):
    """The Renderer hands its paths the plan's camera as tensors uploaded
    once, and ``generate_rays`` given all three uploads nothing (a CUDA
    graph cannot record an upload)."""
    plan, field = small_scene()
    r = renderer(plan, use_window=True)
    cam = r._camera()
    assert r._camera() is cam
    pplan = port_plan(plan)
    np.testing.assert_array_equal(
        cam[0].numpy(), np.asarray(pplan.camera.k, np.float32).reshape(3, 3))
    np.testing.assert_array_equal(
        cam[1].numpy(), np.asarray(pplan.camera.c2w, np.float32).reshape(3, 4))
    assert float(cam[2]) == pplan.camera.ortho_scale
    want = r.forward(port_field(field)).image

    def no_upload(*args, **kwargs):
        raise AssertionError("camera uploaded")

    monkeypatch.setattr(p_raygen, "camera_arrays", no_upload)
    rays = p_raygen.generate_rays(pplan, *cam)
    assert rays.origins.shape == (pplan.ray_count, 3)
    np.testing.assert_array_equal(r.forward(port_field(field)).image, want)


class _Rerun:
    """A stand-in for a recorded graph on the CPU: a replay runs the
    recorded function again, reading what it closes over, as a graph
    reads the addresses it recorded. The recorded run may not upload the
    plan's camera, as a CUDA graph may not."""

    def __init__(self, fn):
        self.fn, self.owner = fn, None

    def replay(self):
        self.owner.outputs = self.fn()


@pytest.fixture
def fake_graphs(monkeypatch):
    """Graph mode on the CPU through :class:`_Rerun`: the list of the
    graphs recorded so far."""
    captured = []

    def no_upload(*args, **kwargs):
        raise AssertionError("the plan's camera uploaded while recording")

    def fake_capture(fn, device):
        fn()                                  # the warm-up may upload
        with monkeypatch.context() as m:
            m.setattr(p_raygen, "camera_arrays", no_upload)
            outputs = fn()
        g = _Rerun(fn)
        cg = p_graph.CapturedGraph(graph=g, outputs=outputs, launches={},
                                   capture_ms=0.0, fn=fn)
        g.owner = cg
        captured.append(cg)
        return cg

    monkeypatch.setattr(p_graph, "available", lambda device: True)
    monkeypatch.setattr(p_graph, "capture", fake_capture)
    return captured


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recorded_paths_upload_nothing(fake_graphs, mode):
    """Every mode's recorded forward (and backward) reads the Renderer's
    camera and uploads none; its replays give the eager frame and
    gradients bit for bit."""
    plan, field = small_scene("stratified")
    pf = port_field(field)
    r = renderer(plan, enable_graph=True, **MODES[mode])
    eager = renderer(plan, **MODES[mode])
    r.forward(pf)
    got, want = r.forward(pf), eager.forward(pf)
    assert "graph_executed" in got.stats.notes and r._last_mode == mode
    assert len(fake_graphs) == (1 if mode == "fused" else 2)
    np.testing.assert_array_equal(got.image, want.image)
    if mode == "fused":
        return
    dl = np.random.default_rng(6).normal(
        size=(plan.ray_count, 3)).astype(np.float32)
    g_got, g_want = r.backward(pf, dl), eager.backward(pf, dl)
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(g_got, key),
                                      getattr(g_want, key), err_msg=key)


def test_graph_keeps_its_schedule(fake_graphs):
    """A graph's recorded function holds the schedule it renders, so a
    schedule rebuilt between frames (here: ``use_occupancy`` after an
    in-place edit of sigma, which keeps every address and the field's
    metadata) cannot take the freed one's id and replay the old graph:
    the old graph still renders its own schedule (the new field values),
    the next frame records anew, and its frame and gradients are the
    eager ones."""
    captured = fake_graphs
    plan, field = small_scene()
    pf = port_field(field)
    opts = dict(use_tiles=True, use_occupancy=True)
    r = renderer(plan, enable_graph=True, **opts)
    first = r.forward(pf)
    assert "graph_executed" in first.stats.notes
    assert len(captured) == 2            # the forward and its backward
    old = weakref.ref(r._tiled_schedule)
    with torch.no_grad():
        pf.sigma[: pf.sigma.shape[0] // 2] = 0.0
    r._forward_tiled(pf, P.RenderStats())   # rebuilds, then records anew
    assert r._tiled_schedule is not old() and old() is not None
    with torch.no_grad():
        old_frame = captured[0].fn()
        want_old = p_tiled.render_tiled(r.plan, pf, old())
    assert torch.equal(old_frame.image, want_old.image)
    assert len(captured) == 4
    got = r.forward(pf)
    assert len(captured) == 4 and "graph_executed" in got.stats.notes
    eager = renderer(plan, **opts)
    want = eager.forward(pf)
    np.testing.assert_array_equal(got.image, want.image)
    assert not np.array_equal(got.image, first.image)
    dl = np.random.default_rng(5).normal(
        size=(plan.ray_count, 3)).astype(np.float32)
    g_got, g_want = r.backward(pf, dl), eager.backward(pf, dl)
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(g_got, key),
                                      getattr(g_want, key), err_msg=key)


def test_graph_helpers():
    with pytest.raises(ValueError, match="CUDA"):
        p_graph.capture(lambda: torch.zeros(1), "cpu")
    a, b = torch.zeros(3), torch.ones((2, 2), dtype=torch.int32)
    key = p_graph.tensor_key(a, b)
    assert key == p_graph.tensor_key(a, b)
    assert key != p_graph.tensor_key(a.clone(), b)
    assert key[1][1:] == ((2, 2), "torch.int32", "cpu")
    tree = {"x": (a, [b]), "n": 3}
    out = p_graph.clone_outputs(tree)
    assert out["n"] == 3 and torch.equal(out["x"][0], a)
    assert out["x"][0].data_ptr() != a.data_ptr()
    assert set(p_graph.launch_counts()) >= {"fused_tiles", "packed_table",
                                            "integrate", "hash_tiles"}
