"""The native scheduler core (``dvren_tpu_torch/native``) and the schedule
matrix, against ``dvren_tpu``.

With the native core and with ``DVREN_NATIVE_SCHED=0`` (the numpy
builder) every schedule of ``tools/sched_hash.py``'s matrix, and the
forms it leaves out (fixed sampling, supercells, an odd dense grid,
``all_tiles``), equals the JAX package's ``build_tiled_schedule`` array
for array; the port's two builders equal each other byte for byte, the
gather plan and the canonical tile order included. The variable is read
by both packages at each build, so each case runs both on the same path.
A core that cannot be built raises, naming the variable.
"""

import dataclasses
import functools

import numpy as np
import pytest

import dvren_tpu as J
from bench import _scene
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch import native
from dvren_tpu_torch.render import tiled as p_tiled
from dvren_tpu_torch.render.pipeline import plan_jitter_table as p_jitter_table

# name: (width, grid, steps, schedule options, sparse, sampling mode);
# the first seven are tools/sched_hash.py's matrix
MATRIX = {
    "16px": (96, 16, 64, dict(tile_px=16), False, "stratified"),
    "16px_pitch2": (96, 16, 64, dict(tile_px=16, pitch=2), False,
                    "stratified"),
    "8px": (96, 32, 64, dict(tile_px=8), False, "stratified"),
    "8px_pitch2_occupancy": (96, 32, 64, dict(tile_px=8, pitch=2,
                                              occupancy=True), False,
                             "stratified"),
    "4px_quantized": (96, 32, 64, dict(tile_px=4, quantize=True), False,
                      "stratified"),
    "sparse_8px_pitch2": (64, 20, 48, dict(tile_px=8, pitch=2), True,
                          "stratified"),
    "sparse_odd21_8px": (64, 21, 48, dict(tile_px=8), True, "stratified"),
    "fixed_8px_pitch2": (96, 32, 64, dict(tile_px=8, pitch=2), False,
                         "fixed"),
    "fixed_16px_occupancy": (96, 16, 64, dict(occupancy=True), False,
                             "fixed"),
    "supercell_8px": (96, 32, 64, dict(tile_px=8, cell_scale=2), False,
                      "stratified"),
    "supercell_16px_pitch2": (96, 32, 64, dict(cell_scale=2, pitch=2),
                              False, "stratified"),
    "odd21_16px_occupancy": (96, 21, 64, dict(occupancy=True), False,
                             "stratified"),
    "sparse_8px_occupancy_pitch2": (64, 20, 48, dict(
        tile_px=8, occupancy=True, pitch=2), True, "stratified"),
    "uniform_all_tiles": (96, 16, 64, dict(quantize="uniform",
                                           all_tiles=True), False,
                          "stratified"),
}


@functools.lru_cache(maxsize=None)
def matrix_case(name):
    """(JAX plan, JAX field, port plan, port field) of one matrix entry."""
    width, grid, steps, _, sparse, mode = MATRIX[name]
    plan, field = _scene(width, width, grid, steps)
    if mode == "fixed":
        cfg = plan.descriptor()
        plan = J.Plan.create(dataclasses.replace(
            cfg, sampling=dataclasses.replace(cfg.sampling,
                                              mode=J.SamplingMode.FIXED)))
    if sparse:
        field = JSparse.from_dense(field, threshold=0.0)
        pfield = P.SparseGridField.from_reference(
            np.asarray(field.bricks), np.asarray(field.occupancy),
            field.grid_shape, field.bbox_min, field.bbox_max, device="cpu")
    else:
        pfield = port_field(field)
    return plan, field, port_plan(plan), pfield


def build_both(name):
    plan, field, pplan, pfield = matrix_case(name)
    kw = MATRIX[name][3]
    ref = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), device=False, **kw)
    return ref, p_tiled.build_tiled_schedule(pplan, pfield, **kw)


@pytest.mark.parametrize("core", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(MATRIX))
def test_schedule_matrix_equals_reference(name, core, monkeypatch):
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "1" if core == "native" else "0")
    ref, got = build_both(name)
    assert got.tiled_samples > 0
    assert_schedules_equal(ref, got)


def _leaves(x, prefix=""):
    if isinstance(x, np.ndarray):
        return [(prefix, x)]
    if dataclasses.is_dataclass(x):
        return sum((_leaves(getattr(x, f.name), f"{prefix}.{f.name}")
                    for f in dataclasses.fields(x)), [])
    if isinstance(x, tuple):
        return sum((_leaves(v, f"{prefix}[{i}]") for i, v in enumerate(x)),
                   [])
    return [(prefix, np.asarray(repr(x)))]


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_native_and_numpy_builders_byte_equal(name, monkeypatch):
    """Every leaf of the schedule, the gather plan, the tile set and the
    canonical tile order included, byte for byte."""
    _, _, pplan, pfield = matrix_case(name)
    kw = MATRIX[name][3]
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv("DVREN_NATIVE_SCHED", flag)
        out.append(_leaves(p_tiled.build_tiled_schedule(pplan, pfield, **kw)))
    assert [k for k, _ in out[0]] == [k for k, _ in out[1]]
    for (key, a), (_, b) in zip(*out):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def _flat_rows(seed):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 300, size=(12, 512)).astype(np.int64)
    flat[rng.random(flat.shape) < 0.4] = p_tiled._SENTINEL
    flat[3] = p_tiled._SENTINEL                       # an empty run
    flat[4] = rng.integers(0, 100, 512)               # no sentinel
    flat[5] = 2 * rng.integers(0, 60, 512) + 1        # odd cells only
    return flat


@pytest.mark.parametrize("pitch", [1, 2])
def test_pack_runs_native_equals_numpy_and_reference(pitch):
    flat = _flat_rows(pitch)
    got = native.pack_runs(flat, pitch, int(p_tiled._SENTINEL), 257, 129)
    want = p_tiled._pack_runs_numpy(flat, 257, pitch, 129)
    ref = j_tiled._pack_runs_numpy(flat, pitch, 257, 129)
    for a, b, c in zip(got, want, ref):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("name", ["8px_pitch2_occupancy",
                                  "fixed_16px_occupancy",
                                  "odd21_16px_occupancy"])
def test_tightened_windows_native_equal_numpy(name, monkeypatch):
    """The trimmed windows of the native scan and of the numpy form, for
    every ray with a window left (a ray without one is (0, 0) in both)."""
    _, _, pplan, pfield = matrix_case(name)
    from dvren_tpu_torch.render import windowed
    o, d = windowed._host_rays(pplan)
    bbox = (tuple(pfield.bbox_min), tuple(pfield.bbox_max))
    ke, cnt = windowed._windows(pplan, *bbox)
    jitter = p_jitter_table(pplan)
    empty = p_tiled._empty_cells(pfield.sigma)
    out = []
    for flag in ("1", "0"):
        monkeypatch.setenv("DVREN_NATIVE_SCHED", flag)
        out.append(p_tiled._tighten_windows_by_occupancy(
            pplan, o, d, ke.astype(np.int64), cnt.astype(np.int64), jitter,
            *bbox, tuple(int(v) for v in pfield.sigma.shape), empty))
    (ke_n, cnt_n), (ke_p, cnt_p) = out
    np.testing.assert_array_equal(cnt_n, cnt_p)
    np.testing.assert_array_equal(ke_n[cnt_n > 0], ke_p[cnt_p > 0])
    assert 0 < int((cnt_n > 0).sum()) and (cnt_n <= cnt).all()
    assert int(cnt_n.sum()) < int(cnt.sum())


def test_selection_reads_the_variable(monkeypatch):
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "0")
    assert not native.enabled()
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "1")
    assert native.enabled()
    monkeypatch.delenv("DVREN_NATIVE_SCHED")
    assert native.enabled()


def test_missing_compiler_raises(monkeypatch):
    """No silent fall back to numpy: a core that cannot be built raises,
    naming the variable that selects the numpy builder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compiler", "/nonexistent/g++")
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "1")
    _, _, pplan, pfield = matrix_case("16px")
    with pytest.raises(RuntimeError, match="DVREN_NATIVE_SCHED=0"):
        p_tiled.build_tiled_schedule(pplan, pfield)
    # the numpy builder never touches the core
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "0")
    assert p_tiled.build_tiled_schedule(pplan, pfield).tiled_samples > 0


def test_compile_error_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int dvn_abi_version(void) { return }\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_OUT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_keyed_by_source(monkeypatch, tmp_path):
    """The built library's name carries a hash of the source and flags:
    an edited source builds a library of its own."""
    monkeypatch.setattr(native, "_OUT", tmp_path)
    first = native._build()
    src = tmp_path / "edited.cpp"
    src.write_text(native._SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "_SRC", src)
    second = native._build()
    assert first != second and first.exists() and second.exists()
    assert first.parent == tmp_path
    assert not list(tmp_path.glob(".tmp_*"))


def test_gather_plan_keys_keep_reference_order():
    """At pitch 1 the canonical slot keys rise with the slot index: the
    plan built with them is the reference's (stable by slot)."""
    from dvren_tpu_torch.ops.gather_plan import build_gather_plan
    _, got = build_both("8px")
    plain = build_gather_plan(got.hostmap_all,
                              int(got.gather_plan.inv_map.shape[0]))
    assert plain.meta == got.gather_plan.meta
    np.testing.assert_array_equal(plain.all_idx, got.gather_plan.all_idx)
    np.testing.assert_array_equal(plain.inv_map, got.gather_plan.inv_map)
    # pitch 1: the kept tiles in schedule order, the pad tiles left out
    order = got.tile_order
    assert 0 < order.size < sum(g.n_tiles for g in got.groups)
    assert (np.diff(order) > 0).all()
