"""The packed-stencil evaluation kernels' CPU side (``ops/packed_eval.py``).

The kernels (``csrc/packed_eval.cu``) run only on the card, where
``tests/test_torch_cuda.py`` holds them to their twin and to the JAX
package's numbers in :data:`REFERENCE`. Here, on the CPU:

- a CPU field takes the twin (``eval_packed_trilinear``'s torch code),
  bit for bit the same as ``use_kernel=False``, and leaves the counter
  ``dense.kernel_evals`` at 0; the counter is documented where the field
  documents its stages and in README's Tracing list;
- the bounds step's rule, stated in plain torch (:func:`segment_bounds`),
  on hand-made sorted keys (segments start and end where a key differs
  from its neighbour, the sentinel and rows no key names read (0, 0)) and
  against ``searchsorted`` on random keys;
- the kernels' weight arithmetic, written out in numpy float32 in the
  kernel's order over the constants ``geometry`` hands it, equals the
  twin's ``trilinear_fractions`` bit for bit (outside the bbox, on its
  upper faces, clamped, a zero-extent axis), and their position adjoint,
  written out the same way, the twin's autograd to 2e-6 of the largest;
- :data:`REFERENCE`, the JAX package's ``eval_packed_trilinear`` and its
  VJP into the table and the positions for float32, bfloat16 and float16
  tables under both OOB policies, is what JAX computes now, and the
  kernels' position adjoint in numpy matches it (JAX's ``clip`` passes
  half a cotangent at a local of exactly 0 or 1, torch's ``clamp`` and
  the kernels all of it);
- each C entry point of ``csrc/packed_eval.cu`` has as many parameters as
  its ctypes signature in ``_build.py``.

``python tests/test_torch_packed_eval.py`` writes :data:`REFERENCE` anew
(with JAX on the CPU).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch import _build
from dvren_tpu_torch.fields import dense_grid
from dvren_tpu_torch.ops import grid as grid_ops
from dvren_tpu_torch.ops import packed_eval
from dvren_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = Path(__file__).with_name("packed_eval_jax_reference.npz")


@pytest.fixture
def tracing():
    trace.enable(True)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def positions(n=4000, bbox=((-0.5, 0.2, 0.1), (1.5, 0.9, 2.0)), seed=0):
    """Samples over the bbox and 15 % past it, and every combination of
    its lower face, middle and upper face."""
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(v, np.float64) for v in bbox)
    u = rng.uniform(-0.15, 1.15, (n, 3))
    faces = np.stack(np.meshgrid(*[[0.0, 0.5, 1.0]] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    pos = (lo + np.concatenate([u, faces]) * (hi - lo)).astype(np.float32)
    return tuple(torch.from_numpy(pos[:, a].copy()) for a in range(3))


# ------------------------------------------------------------ the route


def test_cpu_field_takes_the_twin(tracing):
    field = P.DenseGridField(torch.rand((5, 6, 7)), torch.rand((5, 6, 7, 3)),
                             bbox_min=(-0.5, 0.2, 0.1),
                             bbox_max=(1.5, 0.9, 2.0))
    pts = positions()
    packed = grid_ops.build_packed_stencil(field.sigma, field.color)
    assert not packed_eval.routes(packed)
    got = field.packed_eval_planes(*pts)
    want = grid_ops.eval_packed_trilinear(packed, field.grid_shape, *pts,
                                          field.bbox_min, field.bbox_max,
                                          use_kernel=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.autograd.grad(sum(p.sum() for p in got), field.sigma)
    assert trace.snapshot()["counters"].get("dense.kernel_evals", 0) == 0


def test_counter_is_documented():
    doc = dense_grid.DenseGridField.packed_eval_planes.__doc__
    assert "dense.kernel_evals" in doc
    readme = (ROOT / "README.md").read_text()
    tracing_section = readme.split("### Tracing", 1)[1]
    counters = tracing_section.split("- **Counters**", 1)[1].split("\n\n")[0]
    assert "dense.kernel_evals" in counters


# ----------------------------------------------------------- the bounds


def segment_bounds(keys: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The rule ``packed_eval_bounds_kernel`` applies, in plain torch:
    (n_rows, 2) int32, each row's [start, end) in the sorted ``keys``. A
    segment starts where a key differs from its left neighbour (or at 0)
    and ends after a key that differs from its right one (or at the end);
    a row no key names, and the sentinel n_rows (samples outside the
    bbox), get nothing, so an empty row reads (0, 0)."""
    k = keys.reshape(-1).to(torch.int64)
    seg = torch.zeros((n_rows, 2), dtype=torch.int32)
    n = k.numel()
    if n == 0:
        return seg
    i = torch.arange(n, dtype=torch.int64)
    differs = k[1:] != k[:-1]
    first = torch.cat([differs.new_ones(1), differs])
    last = torch.cat([differs, differs.new_ones(1)])
    live = k < n_rows
    s, e = first & live, last & live
    seg[k[s], 0] = i[s].to(torch.int32)
    seg[k[e], 1] = (i[e] + 1).to(torch.int32)
    return seg


HAND = [
    # sorted keys, rows, (row, start, end) of every non-empty row
    ([0, 0, 2, 2, 2, 5], 6, [(0, 0, 2), (2, 2, 5), (5, 5, 6)]),
    ([3], 4, [(3, 0, 1)]),
    ([1, 1, 1, 1], 4, [(1, 0, 4)]),
    ([0, 1, 2, 3], 4, [(0, 0, 1), (1, 1, 2), (2, 2, 3), (3, 3, 4)]),
    ([0, 2, 4, 4, 4, 4], 4, [(0, 0, 1), (2, 1, 2)]),        # 4: sentinel
    ([4, 4], 4, []),
    ([], 3, []),
]


@pytest.mark.parametrize("keys, rows, segs", HAND)
def test_bounds_rule_on_hand_made_keys(keys, rows, segs):
    got = segment_bounds(
        torch.tensor(keys, dtype=torch.int32), rows)
    want = torch.zeros((rows, 2), dtype=torch.int32)
    for r, s, e in segs:
        want[r] = torch.tensor([s, e], dtype=torch.int32)
    assert torch.equal(got, want)


def test_bounds_twin_matches_searchsorted():
    rows = 500
    keys = torch.sort(torch.randint(0, rows + 1, (20_000,),
                                    generator=torch.Generator()
                                    .manual_seed(2)))[0].to(torch.int32)
    seg = segment_bounds(keys, rows)
    edges = torch.searchsorted(keys, torch.arange(rows + 1,
                                                  dtype=torch.int32))
    length = edges[1:] - edges[:-1]
    hit = length > 0
    assert torch.equal(seg[hit, 0], edges[:-1][hit].to(torch.int32))
    assert torch.equal(seg[hit, 1], edges[1:][hit].to(torch.int32))
    assert not bool(seg[~hit].any())
    assert int((seg[:, 1] - seg[:, 0]).sum()) == int(
        (keys < rows).sum())


def test_sort_bits_cover_the_sentinel():
    assert packed_eval.sort_bits(63 ** 3) == 18
    for rows in (1, 2, 3, 4, 480, 2 ** 18 - 1, 2 ** 18):
        assert rows < 2 ** packed_eval.sort_bits(rows)


# ------------------------------------------------------ the arithmetic


def kernel_locate(shape, pts, bbox, oob):
    """``csrc/packed_eval.cu``'s locate in numpy float32, step for step:
    (base cells (3, S), fractions (3, S), inside (S,) as 0 / 1, pass bits
    (3, S))."""
    nx, ny, nz, *rest = packed_eval.geometry(shape, *bbox, oob)
    lo, inv, degenerate, clamp = rest[0:3], rest[3:6], rest[6], rest[7]
    f32 = np.float32
    outside = np.zeros(pts[0].shape, bool)
    locals_, passes = [], []
    for a, p in enumerate(pts):
        p = p.numpy()
        if (degenerate >> a) & 1:
            local = np.zeros_like(p)
        else:
            local = (p - f32(lo[a])) * f32(inv[a])
        outside |= (local < 0) | (local > 1)
        passes.append(np.zeros(p.shape, bool) if (degenerate >> a) & 1
                      else (local >= 0) & (local <= 1) if clamp
                      else np.ones(p.shape, bool))
        if clamp:
            local = np.where(np.isnan(local), local,
                             np.minimum(np.maximum(local, f32(0)), f32(1)))
        locals_.append(local)
    inside = (np.ones(pts[0].shape, np.float32) if clamp
              else (~outside).astype(np.float32))
    bases, fracs = [], []
    for local, n in zip(locals_, (nx, ny, nz)):
        f = local * f32(n - 1)
        fl = np.floor(f)
        base = np.where(~(fl >= 0), 0, np.where(fl > n - 2, n - 2, fl))
        bases.append(base.astype(np.int64))
        fracs.append(f - base.astype(np.float32))
    return np.stack(bases), np.stack(fracs), inside, np.stack(passes)


def kernel_weights(shape, pts, bbox, oob):
    """``csrc/packed_eval.cu``'s locate and corner_weights in numpy
    float32: (base cell (3, S), weights (S, 8))."""
    bases, fracs, inside, _ = kernel_locate(shape, pts, bbox, oob)
    wx, wy, wz = ((np.float32(1) - t, t) for t in fracs)
    w = np.stack([((wz[k >> 2] * wy[(k >> 1) & 1]) * wx[k & 1]) * inside
                  for k in range(8)], axis=-1)
    return bases, w


def kernel_position_grads(shape, pts, bbox, oob, table, grads):
    """``csrc/packed_eval.cu``'s position_adjoint in numpy float32, step
    for step, at the (R, 32) float32 ``table`` and the four (S,) plane
    cotangents: (3, S)."""
    nz, ny, nx = shape
    inv = np.asarray(packed_eval.geometry(shape, *bbox, oob)[6:9],
                     np.float32)
    bases, fracs, inside, passes = kernel_locate(shape, pts, bbox, oob)
    ix, iy, iz = bases
    v = table[(iz * (ny - 1) + iy) * (nx - 1) + ix]
    g = [np.asarray(x, np.float32) for x in grads]
    wx, wy, wz = ((np.float32(1) - t, t) for t in fracs)
    dt = np.zeros((3,) + fracs.shape[1:], np.float32)
    for k in range(8):
        bx, by, bz = k & 1, (k >> 1) & 1, k >> 2
        gw = g[0] * v[:, 4 * k]
        for ch in range(1, 4):
            gw = gw + g[ch] * v[:, 4 * k + ch]
        ex = gw * (wz[bz] * wy[by])
        gx = gw * wx[bx]
        for a, (e, b) in enumerate(((ex, bx), (gx * wz[bz], by),
                                    (gx * wy[by], bz))):
            dt[a] = dt[a] + e if b else dt[a] - e
    sizes = np.asarray([nx - 1, ny - 1, nz - 1], np.float32)[:, None]
    d = (dt * sizes) * inv[:, None]
    return np.where(passes & (inside > 0), d, np.float32(0))


CASES = [
    ((9, 7, 11), ((-0.5, 0.2, 0.1), (1.5, 0.9, 2.0))),
    ((4, 4, 4), ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))),
    ((5, 6, 7), ((0.0, 0.3, 0.0), (1.0, 0.3, 1.0))),        # zero extent
    ((2, 3, 2), ((0.1, -2.0, 0.7), (0.3, 5.0, 0.71))),
]


@pytest.mark.parametrize("oob", [P.OobPolicy.ZERO, P.OobPolicy.CLAMP])
@pytest.mark.parametrize("shape, bbox", CASES)
def test_kernel_weight_arithmetic_equals_twin(shape, bbox, oob):
    pts = positions(bbox=bbox, seed=sum(shape))
    bases, w = kernel_weights(shape, pts, bbox, oob)
    (ix, iy, iz), w_twin = grid_ops.trilinear_fractions(shape, *pts, *bbox,
                                                        oob)
    assert np.array_equal(w.view(np.int32), w_twin.numpy().view(np.int32))
    assert np.array_equal(bases, np.stack([ix.numpy(), iy.numpy(),
                                           iz.numpy()]))


@pytest.mark.parametrize("oob", [P.OobPolicy.ZERO, P.OobPolicy.CLAMP])
@pytest.mark.parametrize("shape, bbox", CASES)
def test_kernel_position_adjoint_matches_twin_autograd(shape, bbox, oob):
    """The kernels' position cotangent, in numpy float32, against the
    twin's autograd through ``eval_packed_trilinear``: within 2e-6 of the
    largest (the twin sums its adjoint in autograd's order); zero on a
    zero-extent axis and outside the bbox under OOB_ZERO."""
    pts = positions(bbox=bbox, seed=sum(shape) + 1)
    rng = np.random.default_rng(len(shape) + sum(shape))
    nz, ny, nx = shape
    table = rng.uniform(-1, 2, ((nz - 1) * (ny - 1) * (nx - 1), 32)) \
        .astype(np.float32)
    grads = [rng.standard_normal(pts[0].shape).astype(np.float32)
             for _ in range(4)]
    got = kernel_position_grads(shape, pts, bbox, oob, table, grads)
    leaves = [p.clone().requires_grad_(True) for p in pts]
    planes = grid_ops.eval_packed_trilinear(
        torch.from_numpy(table), shape, *leaves, *bbox, oob,
        use_kernel=False)
    want = torch.autograd.grad(
        planes, leaves, [torch.from_numpy(g) for g in grads],
        allow_unused=True)
    want = np.stack([np.zeros(pts[0].shape, np.float32) if w is None
                     else w.numpy() for w in want])
    scale = float(np.abs(want).max())
    assert scale > 0.0
    assert float(np.abs(got - want).max()) <= 2e-6 * scale
    assert not np.any(got[want == 0] != 0)


def test_upper_faces_select_the_last_cell_exactly():
    shape, bbox = (4, 4, 4), ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    one = (torch.ones(1),) * 3
    bases, w = kernel_weights(shape, one, bbox, P.OobPolicy.ZERO)
    assert bases.ravel().tolist() == [2, 2, 2]
    assert w.ravel().tolist() == [0.0] * 7 + [1.0]


# ------------------------------------------------- the JAX package's numbers

REF_SHAPE = (4, 5, 6)                          # (Z, Y, X)
REF_BBOX = ((-0.5, 0.2, 0.1), (1.5, 0.9, 2.0))
REF_DTYPES = ("float32", "bfloat16", "float16")
REF_OOBS = ("zero", "clamp")


def reference_inputs(n=485, seed=29):
    """The reference's grid, positions (over the bbox and 15 % past it,
    and every combination of its lower face, middle and upper face) and
    plane cotangents (a third zero, as masked slots), as float32 numpy."""
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0, 12, REF_SHAPE).astype(np.float32)
    color = rng.uniform(0, 1, REF_SHAPE + (3,)).astype(np.float32)
    lo, hi = (np.asarray(v, np.float64) for v in REF_BBOX)
    u = rng.uniform(-0.15, 1.15, (n, 3))
    faces = np.stack(np.meshgrid(*[[0.0, 0.5, 1.0]] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    pos = (lo + np.concatenate([u, faces]) * (hi - lo)).astype(np.float32)
    keep = rng.uniform(0, 1, len(pos)) > 0.33
    grads = (rng.standard_normal((4, len(pos))) * keep).astype(np.float32)
    return {"sigma": sigma, "color": color, "positions": pos.T.copy(),
            "grads": grads}


def jax_reference(inputs, dtype: str, oob: str) -> dict:
    """The JAX package's planes (4, S), table cotangent (R, 32, as
    float32) and position cotangent (3, S) at ``inputs``."""
    import jax
    import jax.numpy as jnp

    from dvren_tpu.core.plan import OobPolicy
    from dvren_tpu.ops import grid as j_grid

    policy = OobPolicy.CLAMP if oob == "clamp" else OobPolicy.ZERO
    packed = j_grid.build_packed_stencil(
        jnp.asarray(inputs["sigma"]), jnp.asarray(inputs["color"]),
        dtype=j_grid.table_dtype(dtype)).reshape(-1, 32)

    def planes(table, px, py, pz):
        return jnp.stack(j_grid.eval_packed_trilinear(
            table, REF_SHAPE, px, py, pz, *REF_BBOX, policy))

    out, vjp = jax.vjp(jax.jit(planes), packed,
                       *map(jnp.asarray, inputs["positions"]))
    d_table, *d_pos = vjp(jnp.asarray(inputs["grads"]))
    return {"planes": np.asarray(out),
            "table_grad": np.asarray(d_table.astype(jnp.float32)),
            "position_grad": np.stack([np.asarray(d) for d in d_pos])}


def write_reference(path=REFERENCE) -> None:
    inputs = reference_inputs()
    arrays = dict(inputs)
    for dtype in REF_DTYPES:
        for oob in REF_OOBS:
            for name, a in jax_reference(inputs, dtype, oob).items():
                arrays[f"{dtype}.{oob}.{name}"] = a
    np.savez_compressed(path, **arrays)


def clip_ties(positions, oob: str):
    """(3, S) bool: where a local is exactly 0 or 1 under OOB_CLAMP, the
    ties at which JAX's ``clip`` passes half a cotangent."""
    ties = np.zeros(positions.shape, bool)
    if oob != "clamp":
        return ties
    for a in range(3):
        local, _ = grid_ops._axis_local(torch.from_numpy(positions[a]),
                                        REF_BBOX[0][a], REF_BBOX[1][a])
        ties[a] = (local == 0).numpy() | (local == 1).numpy()
    return ties


@pytest.mark.parametrize("oob", REF_OOBS)
@pytest.mark.parametrize("dtype", REF_DTYPES)
def test_reference_is_what_jax_computes(dtype, oob):
    """:data:`REFERENCE` holds the inputs :func:`reference_inputs` makes
    and what the JAX package computes at them now; the kernels' position
    adjoint in numpy matches JAX's, where a clamped local is exactly 0 or
    1 at twice JAX's."""
    ref = np.load(REFERENCE)
    inputs = reference_inputs()
    for name, a in inputs.items():
        assert np.array_equal(ref[name], a), name
    want = jax_reference(inputs, dtype, oob)
    for name, a in want.items():
        b = ref[f"{dtype}.{oob}.{name}"]
        assert b.shape == a.shape and b.dtype == np.float32, name
        assert float(np.abs(b - a).max()) <= 1e-6 * float(
            np.abs(a).max()), name
    policy = P.OobPolicy.CLAMP if oob == "clamp" else P.OobPolicy.ZERO
    table = grid_ops.build_packed_stencil(
        torch.from_numpy(inputs["sigma"]), torch.from_numpy(inputs["color"]),
        getattr(torch, dtype)).float().reshape(-1, 32).numpy()
    pts = tuple(torch.from_numpy(p) for p in inputs["positions"])
    got = kernel_position_grads(REF_SHAPE, pts, REF_BBOX, policy, table,
                                inputs["grads"])
    jax_dp = want["position_grad"]
    ties = clip_ties(inputs["positions"], oob)
    assert ties.any() == (oob == "clamp")
    got = np.where(ties, got * np.float32(0.5), got)
    assert float(np.abs(got - jax_dp).max()) <= 2e-6 * float(
        np.abs(jax_dp).max())


# ------------------------------------------------------ the entry points


def _entry_points() -> dict:
    src = (ROOT / "dvren_tpu_torch" / "csrc" / "packed_eval.cu").read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def test_entry_points_match_their_signatures():
    entries = _entry_points()
    assert set(entries) == {"dvt_packed_eval_forward",
                            "dvt_packed_eval_sort_bytes",
                            "dvt_packed_eval_backward"}
    for name, count in entries.items():
        argtypes, _ = _build._SIGNATURES[name]
        assert len(argtypes) == count, name


if __name__ == "__main__":
    write_reference()
