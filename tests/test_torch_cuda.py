"""dvren_tpu_torch's CUDA kernels against their plain PyTorch twins.

Every test here launches a kernel and skips where torch has no CUDA
device. The file imports no JAX, so it also runs where JAX is absent;
tests/conftest.py does import JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The twins are held to dvren_tpu on the CPU by the other test_torch_*
files; here the kernels are held to the twins: K3 and K4 bit for bit as
32-bit words from 1^3 to 128^3 (K3 also on inf, NaN payloads and -0.0),
K1 and the whole forward within 5e-6 (depth 1e-4), K2 within 2e-6 x scale
on d(table) and 1e-5 x scale on d(rayt), the backward on the card within
2e-6 x scale of the CPU's (camera rtol 2e-3 / atol 1e-4), and every
kernel's repeat runs bit for bit. The hash-MLP kernels: K7f and the hash
Renderer.forward within 5e-6 (depth 1e-4), K7b within 2e-5 x scale (the
JAX package's bound for its own kernel, tests/test_hash_tiled.py:114),
fit_hash_mlp's losses on the card within 1e-5 relative of the CPU's;
both at the edges of the specs fast_path_ok admits (L*F 2 to 64, F 1 to
8, hidden 1, 3, 8, T 1, 16, 128) on a scene with pad tiles, and on the
fit's four-view stack with an opaque teacher whose rays stop early.
The hash-grid kernels: K8f within 5e-6 (depth 1e-4), K8b within 2e-5 x
scale on its slot rows and MLP gradients, repeat runs and two backwards
of render_hash_grid_tiled under torch.use_deterministic_algorithms bit
for bit, and the card's render and gradients within those bounds of the
CPU twins'; in their one-launch form, over every group of a ragged
schedule at subs 1, 4 and 16 and at the widest spec grid_path_ok admits,
K8f bit for bit and K8b within 2e-5 x scale of the twins, once per
render_hash_grid_tiled forward and backward. The 16-bit tables and sparse fields: K5a and K5b bit for bit
from 1^3 to 128^3 (K5a also on inf, -0.0, NaN, float16 overflow, subnormals and ties; K5b's repeats),
the 16-bit and sparse renders on the card within 5e-6 (depth 1e-4) of the
CPU's, their gradients within 2e-6 x scale (float32 bricks) or c * ulp x
scale (16-bit tables: c the largest slot class, ulp 2^-8 bfloat16, 2^-11
float16; the K2 kernel and its twin differ in the last f32 bits, which
can move a 16-bit rounding by one ulp), repeat backwards bit for bit; K7b
trains L*F = 64 within 2e-5 x scale. K1 and K2 in their sub-tiled (8 and
4 px) and supercell forms, on every group of tests/test_supercell.py's
scene: bit for bit against their twins; the Renderer's cascade on that
scene (float32: 8 px supercells; bfloat16: 4 px cells): the frame within
the bounds above of the CPU's (depth where opacity exceeds 1e-3: its rays
end just above OPACITY_EPS, where wd / opacity magnifies the last bit of
exp), the backward equal to the plain path on the card; and an empty
schedule's planes on the card, with zero gradients. The per-ray
integrator: K9f and K9b against their twins at
tests/test_pallas_parity.py's bounds (radiance rtol 1e-5 / atol 1e-6, T
and opacity 1e-5 / 1e-7, depth 1e-5 / 1e-5, d_sigma 1e-4 / 1e-6, d_colour
1e-4 / 1e-7), repeats bit for bit, at rows of 1 to 256 steps (the
register path's one to four chunks and the grouped walk past them) and
1, 5 and 9,216 rays, with masked rows, rows that stop in their first
chunk and exact-zero sigma; the windowed Renderer, the tiled
schedule's fallback and the windowed and plain fits on the card against
the CPU (planes 5e-6, depth 1e-4, gradients 2e-6 x scale, losses 1e-5
relative), with K9's launch counts. The split backward: K6 equal to its
twin word for word on random 32-bit words (B = 1, 8 and the headline's
5,104 blocks), K2's bank form equal to its rows form transposed and to
its twin's bank form at subs 1, 4 and 16, and the sparse and stack routes'
gradients under BWD_SPLIT "pallas" equal to "xla"'s, with K6 once per
group. The schedule's last options: K1 and K2 bit for bit against their
twins on pitch-2, occupancy-trimmed and ``all_tiles`` schedules (dense
float32, bfloat16 and sparse); the pair gather of a 16-bit table equal to
the pitch-1 gather on every used lane; the Renderer at pitch 2 bit-equal
to pitch 1 on the card, frame and gradients; ``use_occupancy`` on the
card within 5e-6 of the CPU's frame and 2e-6 x scale of its gradients;
the moving-camera renderer bit-equal to each pose's own schedule. The
general paths: the Renderer's fused, staged and streamed modes on the
card within the bounds above of the CPU's (K9f and K9b launched, repeat
backwards bit for bit), ``ops.diff.per_sample_grads`` one K9b launch, and
the compose of rays that share pixels the same bit for bit from call to
call. The stratified jitter: the jitter kernel bit for bit against its
twin and the host table (strides, broadcasts, bounds, seeds past 2^63),
``generate_samples(jitter=None)`` hashing it on the card with no host
round trip (under ``torch.cuda.set_sync_debug_mode("error")``), equal to
the table route; bank-aligned schedules' K1 / K2 frames and gradients
bit-equal to the dense packing's; ``utils/timing.time_calls`` on a
closure over card tensors. ``render/graph.capture`` records while a
dead reference cycle that holds another graph would be collected. The
tile-DP step at D = 1 over NCCL, recorded as a CUDA graph with its
all-reduce, equal to its eager capturable body bit for bit, and a
stratified ``pipeline.render``'s recording listing the jitter kernel.
The posed build kernel: every schedule array and the diagnostics bit for
bit against the torch twin on tests/test_posed.py's scene (base, three
orbit poses, the fixed mode), at all 120 poses of the benchmark's 512^2
blob64 orbit with a repeat build, and past each pin (the same refusal);
graph mode's planes bit-equal to the twin's schedule through the same
kernels, one build launch in the recording, ``posed.kernel_frames``
counting the replays. The packed-stencil evaluation (csrc/packed_eval.cu):
the forward kernel's corner weights, read through one-hot tables, bit for
bit against the twin's ``trilinear_fractions`` (float32, bfloat16 and
float16 tables, OOB zero and clamp, samples outside the bbox and on its
upper faces, a zero-extent axis) and its planes within 1e-6 x scale; the
backward's row cotangents within 1e-6 x the largest of the twin's (16-bit
tables: within one rounding of the float32 sums), with a third of the
cotangents zero and with every sample in one cell, the same bits with the
position cotangent asked for too, and that within 2e-6 x the largest of
the twin's autograd; S = 0; two backwards and a recorded graph's replays
bit for bit; a card field routed through the kernels
(``dense.kernel_evals``), positions that carry a gradient included; and
the kernels against the JAX package's numbers at the same points
(``tests/packed_eval_jax_reference.npz``, held to JAX on the CPU by
``tests/test_torch_packed_eval.py``): planes, the position cotangent (JAX's
``clip`` passes half at a local of exactly 0 or 1) and the table's, a
16-bit table's within one rounding of the exact sums and, from JAX's,
within the roundings JAX takes summing in the table's type.
"""

import dataclasses
import gc
import pathlib

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch import _build
from dvren_tpu_torch.ops import (fused_tiles, hash_grid, hash_tiles,
                                 integrate_fused, packed_transpose)
from dvren_tpu_torch.ops.grid import build_supercell_stencil
from dvren_tpu_torch.opt import fit
from dvren_tpu_torch.render import graph as graph_mod
from dvren_tpu_torch.render import hash_tiled, tiled

pytestmark = pytest.mark.cuda

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6       # x max |twin|
CAM_TOL = 1e-5        # x max |twin|, d(rayt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def scene(name):
    """tests/test_tiled.py::scene in the port's terms (48x32 rays over an
    8^3 grid), plus an opaque variant whose rays stop early."""
    width, height, n = 48, 32, 8
    roi = P.Roi()
    mode = (P.SamplingMode.FIXED if name == "fixed"
            else P.SamplingMode.STRATIFIED)
    if name == "roi":
        width, height, roi = 50, 38, P.Roi(x=3, y=5, width=41, height=27)
    rng = np.random.default_rng(3)
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.1, t_far=3.1, seed=17,
        camera=P.CameraConfig(
            k=(width * 1.25, 0, width / 2, 0, width * 1.25, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.55, 0, 0, 1, -1.1)),
        roi=roi, sampling=P.SamplingConfig(dt=0.05, max_steps=60, mode=mode)))
    sigma = rng.uniform(0.5, 8.0, n ** 3) * (25.0 if name == "opaque"
                                            else 1.0)
    config = P.DenseGridConfig(
        resolution=(n, n, n), sigma=sigma,
        color=rng.uniform(0, 1, 3 * n ** 3),
        bbox_min=(0.3, 0.3, 0.2), bbox_max=(0.8, 0.9, 0.7))
    return plan, config


SCENES = ("fixed", "stratified", "roi", "opaque")


def test_library_builds_once(cuda_device):
    lib = _build.library()
    assert _build.library() is lib
    report = _build.ptxas_report()
    for kernel in ("tile_forward_kernel", "packed_table_kernel",
                   "tile_backward_kernel", "packed_table_grad_kernel",
                   "hash_forward_kernel", "hash_backward_kernel",
                   "hash_grid_forward_kernel", "hash_grid_backward_kernel",
                   "packed_table16_kernel",
                   "integrate_forward_kernel", "integrate_backward_kernel",
                   "stratified_jitter_kernel"):
        assert kernel in report


# K3's and K4's shapes: Y = 1, X = 1, X past a run, a partial last
# z-chunk (tests/test_torch_packed_tiling.py), the headline's and the fine
# grid's
PACKED_SHAPES = [(1, 1, 1), (2, 2, 2), (1, 1, 2049), (9, 1, 300), (4, 6, 1),
                 (5, 7, 9), (3, 17, 40), (41, 70, 61), (64, 64, 64),
                 (128, 128, 128)]


def _words(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_table_bit_equal_to_plain(cuda_device, shape):
    rng = np.random.default_rng(2)
    sigma = torch.from_numpy(
        rng.uniform(-1, 9, shape).astype(np.float32)).to(cuda_device)
    color = torch.from_numpy(
        rng.uniform(0, 1, shape + (3,)).astype(np.float32)).to(cuda_device)
    before = packed_transpose.build_rows.launches
    got = packed_transpose.build_rows(sigma, color)
    torch.cuda.synchronize()
    assert packed_transpose.build_rows.launches == before + 1
    assert torch.equal(_words(got), _words(
        packed_transpose.build_rows_plain(sigma, color)))


def test_packed_table_moves_special_values(cuda_device):
    """inf, NaN with payloads and -0.0 reach the table as 32-bit words."""
    shape = (5, 7, 9)
    n = 5 * 7 * 9
    words = np.random.default_rng(4).integers(
        0, 2 ** 32, size=4 * n, dtype=np.uint64).astype(np.uint32)
    words[::7] = 0x80000000
    words[1::11] = 0x7F800000
    words[2::13] = 0xFF800000
    words[3::5] = 0x7FC00000 | (np.arange(words[3::5].size) & 0x3FFFFF)
    floats = torch.from_numpy(words.view(np.float32)).to(cuda_device)
    sigma = floats[:n].reshape(shape)
    color = floats[n:].reshape(shape + (3,))
    got = packed_transpose.build_rows(sigma, color)
    torch.cuda.synchronize()
    assert torch.equal(_words(got), _words(
        packed_transpose.build_rows_plain(sigma, color)))


def test_packed_table_rejects_strided_input(cuda_device):
    sigma = torch.zeros((4, 4, 8), device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError):
        packed_transpose.build_rows(sigma, torch.zeros((4, 4, 4, 3),
                                                       device=cuda_device))


def set_args(plan, sched, table, stencil="cell"):
    """K1's one-launch arguments (flat bank tables, tile set, TileParams):
    first over the whole schedule, then over each group alone (a set of
    one shape)."""
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    tabs = tiled._gather_banks_flat(table, sched.gathermap_all, sched.pitch)
    out = [(tabs, sched.tiles,
            fused_tiles.tiles_op_params(plan, geom, sched.tiles, stencil))]
    for g, views in zip(sched.groups, sched.tiles.group_views(tabs)):
        tiles = fused_tiles.tile_set([g], sched.subs)
        out.append((views[0].reshape((-1,) + tuple(tabs.shape[1:])), tiles,
                    fused_tiles.tiles_op_params(plan, geom, tiles, stencil)))
    return out


def _group_args(name, device):
    plan, config = scene(name)
    field = P.DenseGridField.create(config, device=device)
    sched = tiled.build_tiled_schedule(plan, field).to(device)
    table = packed_transpose.build_rows_plain(field.sigma.detach(),
                                              field.color.detach())
    return plan, set_args(plan, sched, table)


@pytest.mark.parametrize("name", SCENES)
def test_fused_tiles_matches_plain(cuda_device, name):
    """K1 over the whole schedule in one launch, and over each group
    alone, equals its twin run group by group, bit for bit."""
    plan, groups = _group_args(name, cuda_device)
    for args in groups:
        before = fused_tiles.tile_forward.launches
        out = fused_tiles.tile_forward(*args)
        torch.cuda.synchronize()
        assert fused_tiles.tile_forward.launches == before + 1
        plain = fused_tiles.tile_forward_set_plain(*args)
        assert bool(torch.isfinite(out).all()) and torch.equal(out, plain)
        (r, g, b), t, o, d = fused_tiles.finalize_heads(plan, out)
        (r2, g2, b2), t2, o2, d2 = fused_tiles.finalize_heads(plan, plain)
        for x, y in ((r, r2), (g, g2), (b, b2), (t, t2), (o, o2)):
            assert float((x - y).abs().max()) <= TOL
        assert float((d - d2).abs().max()) <= TOL_DEPTH


@pytest.mark.parametrize("px,scale", [(16, 1), (8, 2), (4, 1)])
def test_one_launch_equals_launches_per_group(cuda_device, px, scale):
    """K1 and K2 (rows, bank form, d(rayt)) in one launch over every group
    of a two-view merged schedule equal their launches group by group,
    bit for bit, in the schedule's order of tiles and in group order."""
    plan, config = scene("stratified")
    field = P.DenseGridField.create(config, device=cuda_device)
    cams = [P.CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1,
                                -1.0)) for dx in (0.0, 0.1)]
    plans = fit.view_plans(plan, cams)
    merged = tiled.merge_view_schedules(
        [tiled.build_tiled_schedule(p, field, tile_px=px, cell_scale=scale)
         for p in plans], plans=plans).to(cuda_device)
    sigma, color = field.sigma.detach(), field.color.detach()
    table = (build_supercell_stencil(sigma, color) if scale == 2
             else packed_transpose.build_rows(sigma, color))
    whole, *groups = set_args(plan, merged.sched, table,
                              "super" if scale == 2 else "cell")
    assert len(groups) > 1
    tabs, tiles, prm = whole
    gs = torch.randn((tiles.n_tiles, 5, 16, 16), device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(px))
    in_order = dataclasses.replace(tiles, order=torch.arange(
        tiles.n_tiles, dtype=torch.int32, device=cuda_device))
    for t in (tiles, in_order):
        out = fused_tiles.tile_forward(tabs, t, prm)
        rows, d_rayt = fused_tiles.tile_backward(tabs, t, gs, prm, cam=True)
        parts = [fused_tiles.tile_forward(*g) for g in groups]
        g_bwd = []
        t0 = 0
        for g_tabs, g_tiles, g_prm in groups:
            n = g_tiles.n_tiles
            g_bwd.append(fused_tiles.tile_backward(
                g_tabs, g_tiles, gs[t0:t0 + n].contiguous(), g_prm, cam=True))
            t0 += n
        torch.cuda.synchronize()
        assert torch.equal(out, torch.cat(parts))
        assert torch.equal(rows, torch.cat([r for r, _ in g_bwd]))
        assert torch.equal(d_rayt, torch.cat([d for _, d in g_bwd]))
        if scale == 1:
            banks, _ = fused_tiles.tile_backward(tabs, t, gs, prm,
                                                 emit="banks")
            assert torch.equal(banks, rows.transpose(1, 2))


def test_fused_tiles_rejects_strided_input(cuda_device):
    _, groups = _group_args("fixed", cuda_device)
    tabs, tiles, prm = groups[0]
    strided = torch.empty((tabs.shape[0] * 2,) + tabs.shape[1:],
                          device=cuda_device)[::2]
    strided.copy_(tabs)
    with pytest.raises(ValueError):
        fused_tiles.tile_forward(strided, tiles, prm)


@pytest.mark.parametrize("name", SCENES)
def test_forward_on_the_card_matches_cpu(cuda_device, name):
    plan, config = scene(name)
    k1, k3 = fused_tiles.tile_forward.launches, \
        packed_transpose.build_rows.launches
    got = P.Renderer(P.Context.create(device="cuda"), plan).forward(
        P.DenseGridField.create(config, device=cuda_device))
    assert fused_tiles.tile_forward.launches > k1
    assert packed_transpose.build_rows.launches > k3
    ref = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True)).forward(
        P.DenseGridField.create(config, device="cpu"))
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL)
    np.testing.assert_allclose(got.depth, ref.depth, atol=TOL_DEPTH)
    np.testing.assert_array_equal(got.hitmask, ref.hitmask)


def _close(got, ref, tol):
    scale = max(float(ref.abs().max()), 1e-12)
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("name", SCENES)
def test_tile_backward_matches_plain(cuda_device, name):
    _, groups = _group_args(name, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for tabs, tiles, prm in groups:
        gs = torch.randn((tiles.n_tiles, 5, 16, 16), generator=gen,
                         device=cuda_device)
        before = fused_tiles.tile_backward.launches
        rows, d_rayt = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                 cam=True)
        torch.cuda.synchronize()
        assert fused_tiles.tile_backward.launches == before + 1
        p_rows, p_rayt = fused_tiles.tile_backward_set_plain(
            tabs, tiles, gs, prm, cam=True)
        assert bool(torch.isfinite(rows).all())
        assert torch.equal(rows, p_rows) and torch.equal(d_rayt, p_rayt)
        tiles64 = dataclasses.replace(tiles, base=tiles.base.double(),
                                      rayt=tiles.rayt.double())
        rows64, rayt64 = fused_tiles.tile_backward_set_plain(
            tabs.double(), tiles64, gs.double(), prm, cam=True)
        _close(rows.double(), rows64, GRID_TOL)
        _close(d_rayt.double(), rayt64, CAM_TOL)
        rows2, d_rayt2 = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                   cam=True)
        assert torch.equal(rows2, rows) and torch.equal(d_rayt2, d_rayt)
        rows_nc, none = fused_tiles.tile_backward(tabs, tiles, gs, prm)
        assert none is None and torch.equal(rows_nc, rows)


def test_tile_backward_rejects_strided_input(cuda_device):
    _, groups = _group_args("fixed", cuda_device)
    tabs, tiles, prm = groups[0]
    gs = torch.zeros((tiles.n_tiles * 2, 5, 16, 16), device=cuda_device)[::2]
    with pytest.raises(ValueError):
        fused_tiles.tile_backward(tabs, tiles, gs, prm)


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_table_grad_bit_equal_to_plain(cuda_device, shape):
    rows = packed_transpose.fullpitch_rows(shape)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    tg = torch.randn((rows, 32), generator=gen, device=cuda_device)
    before = packed_transpose.table_grad_to_params.launches
    got = packed_transpose.table_grad_to_params(tg, shape)
    torch.cuda.synchronize()
    assert packed_transpose.table_grad_to_params.launches == before + 1
    want = packed_transpose.table_grad_to_params_plain(tg, shape)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_words(a), _words(b))


def test_packed_table_grad_repeats_bit_for_bit(cuda_device):
    shape = (41, 70, 61)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    tg = torch.randn((packed_transpose.fullpitch_rows(shape), 32),
                     generator=gen, device=cuda_device)
    first = packed_transpose.table_grad_to_params(tg, shape)
    again = packed_transpose.table_grad_to_params(tg, shape)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(_words(a), _words(b))


def test_packed_table_grad_rejects_strided_input(cuda_device):
    rows = packed_transpose.fullpitch_rows((4, 4, 4))
    tg = torch.zeros((rows, 64), device=cuda_device)[:, ::2]
    with pytest.raises(ValueError):
        packed_transpose.table_grad_to_params(tg, (4, 4, 4))


@pytest.mark.parametrize("name", SCENES)
def test_backward_on_the_card_matches_cpu(cuda_device, name):
    plan, config = scene(name)
    dl = np.random.default_rng(3).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    launches = (fused_tiles.tile_backward.launches,
                packed_transpose.table_grad_to_params.launches)
    card = P.Renderer(P.Context.create(device="cuda"), plan)
    field = P.DenseGridField.create(config, device=cuda_device)
    card.forward(field)
    got = card.backward(field, dl)
    assert fused_tiles.tile_backward.launches > launches[0]
    assert packed_transpose.table_grad_to_params.launches > launches[1]
    cpu = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True))
    cpu_field = P.DenseGridField.create(config, device="cpu")
    cpu.forward(cpu_field)
    ref = cpu.backward(cpu_field, dl)
    for key in ("sigma", "color"):
        _close(torch.from_numpy(getattr(got, key)),
               torch.from_numpy(getattr(ref, key)), GRID_TOL)
    np.testing.assert_allclose(got.camera, ref.camera, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got.camera_k, ref.camera_k, rtol=2e-3,
                               atol=1e-4)
    again = card.backward(field, dl)
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(again, key), getattr(got, key))


# ------------------------------------------------------------ hash-MLP (K7)

HASH_GRAD_TOL = 2e-5    # x max |twin|
HASH_SCENES = ("fixed", "stratified", "roi", "l8", "zeros", "opaque")


def hash_scene(name, device="cpu"):
    """tests/test_hash_tiled.py's plans (24x20, 24 steps; the ROI case
    40x24) and a field from a seeded blob: "l8" is the L=8 / T=128 spec,
    "zeros" the all-zero blob, "opaque" stops its rays early."""
    spec = (P.HashMLPSpec(n_levels=8, table_size=128, base_resolution=2.0,
                          finest_resolution=48.0)
            if name == "l8" else P.HashMLPSpec())
    width, height, roi = 24, 20, P.Roi()
    if name == "roi":
        width, height, roi = 40, 24, P.Roi(x=3, y=2, width=21, height=17)
    mode = (P.SamplingMode.FIXED if name in ("fixed", "roi")
            else P.SamplingMode.STRATIFIED)
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.2, t_far=1.8, seed=11, roi=roi,
        sampling=P.SamplingConfig(dt=0.05, max_steps=24, mode=mode)))
    flat = np.random.default_rng(5).uniform(
        -0.5, 0.5, spec.param_count).astype(np.float32)
    if name == "zeros":
        flat = None
    elif name == "opaque":
        flat[spec.hash_table_size + spec.sigma_weights_size
             + spec.hidden_dim] = 60.0          # sigma_b2
    field = P.HashMLPField.create(P.HashMLPConfig(spec=spec, params=flat),
                                  device=device)
    return plan, field


def _hash_args(name, device):
    plan, field = hash_scene(name, device)
    sched = hash_tiled.build_hash_schedule(plan, device=device)
    prm = hash_tiles.hash_tile_params(plan, field.spec, sched.n_chunks)
    sc = hash_tiles.pack_mlp_scalars(dict(field.params), field.spec).detach()
    return plan, (sched.samp, sched.rayt,
                  field.params["hash_table"].detach().contiguous(), sc, prm)


@pytest.mark.parametrize("name", HASH_SCENES)
def test_hash_forward_matches_plain(cuda_device, name):
    plan, args = _hash_args(name, cuda_device)
    before = hash_tiles.hash_tile_forward.launches
    out = hash_tiles.hash_tile_forward(*args)
    torch.cuda.synchronize()
    assert hash_tiles.hash_tile_forward.launches == before + 1
    plain = hash_tiles.hash_tile_forward_plain(*args)
    assert bool(torch.isfinite(out).all())
    (r, g, b), t, o, d = fused_tiles.finalize_heads(plan, out)
    (r2, g2, b2), t2, o2, d2 = fused_tiles.finalize_heads(plan, plain)
    for x, y in ((r, r2), (g, g2), (b, b2), (t, t2), (o, o2)):
        assert float((x - y).abs().max()) <= TOL
    assert float((d - d2).abs().max()) <= TOL_DEPTH


@pytest.mark.parametrize("name", HASH_SCENES)
def test_hash_backward_matches_plain(cuda_device, name):
    _, args = _hash_args(name, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    gs = torch.randn((args[0].shape[0], 5, 16, 16), generator=gen,
                     device=cuda_device)
    before = hash_tiles.hash_tile_backward.launches
    d_tab, d_sc = hash_tiles.hash_tile_backward(*args[:4], gs, args[4])
    torch.cuda.synchronize()
    assert hash_tiles.hash_tile_backward.launches == before + 1
    p_tab, p_sc = hash_tiles.hash_tile_backward_plain(*args[:4], gs, args[4])
    for got, want in ((d_tab, p_tab), (d_sc, p_sc)):
        assert bool(torch.isfinite(got).all())
        _close(got, want, HASH_GRAD_TOL)
    again = hash_tiles.hash_tile_backward(*args[:4], gs, args[4])
    assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_sc)


def test_hash_kernels_reject_strided_input(cuda_device):
    _, (samp, rayt, table, sc, prm) = _hash_args("fixed", cuda_device)
    strided = torch.empty((samp.shape[0] * 2,) + samp.shape[1:],
                          device=cuda_device)[::2]
    strided.copy_(samp)
    with pytest.raises(ValueError):
        hash_tiles.hash_tile_forward(strided, rayt, table, sc, prm)
    gs = torch.zeros((samp.shape[0] * 2, 5, 16, 16), device=cuda_device)[::2]
    with pytest.raises(ValueError):
        hash_tiles.hash_tile_backward(samp, rayt, table, sc, gs, prm)


@pytest.mark.parametrize("n_levels", [16, 17, 32])
def test_hash_backward_shared_memory_limit(cuda_device, n_levels):
    """K7b trains every spec fast_path_ok admits: at T=128, F=2 and
    hidden 8, L*F = 32 keeps one d(table) copy per warp, 34 and 64 share
    copies between warps. Each is within 2e-5 x scale of the float64
    twin, and repeat runs are equal bit for bit."""
    plan, _ = hash_scene("fixed")
    spec = P.HashMLPSpec(n_levels=n_levels, table_size=128)
    assert hash_tiles.fast_path_ok(spec)
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                       spec=spec, device=cuda_device)
    sched = hash_tiled.build_hash_schedule(plan, device=cuda_device)
    prm = hash_tiles.hash_tile_params(plan, spec, sched.n_chunks)
    args = (sched.samp, sched.rayt,
            field.params["hash_table"].detach().contiguous(),
            hash_tiles.pack_mlp_scalars(dict(field.params), spec).detach())
    assert bool(torch.isfinite(hash_tiles.hash_tile_forward(*args, prm)).all())
    gs = torch.randn((sched.n_tiles, 5, 16, 16), device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(5))
    d_tab, d_sc = hash_tiles.hash_tile_backward(*args, gs, prm)
    p_tab, p_sc = hash_tiles.hash_tile_backward_plain(*args, gs, prm)
    for got, want in ((d_tab, p_tab), (d_sc, p_sc)):
        assert bool(torch.isfinite(got).all())
        _close(got, want, HASH_GRAD_TOL)
    assert float(d_tab.abs().max()) > 0.0
    again = hash_tiles.hash_tile_backward(*args, gs, prm)
    assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_sc)


# (n_levels, features_per_level, table_size, hidden_dim): the edges of
# what fast_path_ok admits, L*F 2, 16, 33, 34 and 64 (F 1, 2, 3, 4, 8),
# hidden 1, 3 and 8, T 1, 16 and 128
EDGE_SPECS = ((2, 1, 1, 1), (1, 2, 16, 3), (8, 2, 128, 8), (11, 3, 128, 8),
              (33, 1, 16, 3), (17, 2, 128, 8), (32, 2, 128, 8),
              (8, 8, 128, 1), (16, 4, 1, 3))


def _check_k7(plan, spec, sched, params, gen, opaque_rays=False):
    """K7f and K7b against their twins on one schedule (every tile, pad
    tiles too), repeats bit for bit; returns the rays that stop early."""
    prm = hash_tiles.hash_tile_params(plan, spec, sched.n_chunks)
    args = (sched.samp, sched.rayt, params["hash_table"].detach().contiguous(),
            hash_tiles.pack_mlp_scalars(params, spec).detach())
    out = hash_tiles.hash_tile_forward(*args, prm)
    plain = hash_tiles.hash_tile_forward_plain(*args, prm)
    assert bool(torch.isfinite(out).all())
    (r, g, b), t, o, d = fused_tiles.finalize_heads(plan, out)
    (r2, g2, b2), t2, o2, d2 = fused_tiles.finalize_heads(plan, plain)
    for x, y in ((r, r2), (g, g2), (b, b2), (t, t2), (o, o2)):
        assert float((x - y).abs().max()) <= TOL
    assert float((d - d2).abs().max()) <= TOL_DEPTH
    assert torch.equal(hash_tiles.hash_tile_forward(*args, prm), out)
    gs = torch.randn((sched.samp.shape[0], 5, 16, 16), generator=gen,
                     device=sched.samp.device)
    d_tab, d_sc = hash_tiles.hash_tile_backward(*args, gs, prm)
    p_tab, p_sc = hash_tiles.hash_tile_backward_plain(*args, gs, prm)
    for got, want in ((d_tab, p_tab), (d_sc, p_sc)):
        assert bool(torch.isfinite(got).all())
        _close(got, want, HASH_GRAD_TOL)
    assert float(d_tab.abs().max()) > 0.0
    again = hash_tiles.hash_tile_backward(*args, gs, prm)
    assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_sc)
    no_stop = hash_tiles.hash_tile_forward_plain(
        *args, dataclasses.replace(prm, stop=0.0))
    return int((plain[:, 4] < no_stop[:, 4]).sum())


@pytest.mark.parametrize("dims", EDGE_SPECS)
def test_hash_kernels_at_the_spec_edges(cuda_device, dims):
    """K7f within 5e-6 of its twin (depth 1e-4) and K7b within 2e-5 x
    scale of its float64 twin at every edge of the specs fast_path_ok
    admits, on the 24x20 stratified scene (4 tiles and 4 pad tiles), the
    field a seeded uniform blob with positive first-layer biases, sigma_w2
    and sigma_b2 (so neither head is dead and every gradient is nonzero);
    repeats equal bit for bit."""
    n_levels, n_feat, t_size, hidden = dims
    spec = P.HashMLPSpec(n_levels=n_levels, features_per_level=n_feat,
                         table_size=t_size, hidden_dim=hidden)
    assert hash_tiles.fast_path_ok(spec)
    plan, _ = hash_scene("stratified")
    flat = np.random.default_rng(n_levels * 100 + n_feat).uniform(
        -0.5, 0.5, spec.param_count).astype(np.float32)
    field = P.HashMLPField.create(P.HashMLPConfig(spec=spec, params=flat),
                                  device=cuda_device)
    params = {k: v.detach().clone() for k, v in field.params.items()}
    for key in ("sigma_b1", "color_b1", "sigma_b2"):
        params[key] = params[key].abs() + 0.5
    params["sigma_w2"] = params["sigma_w2"].abs()
    sched = hash_tiled.build_hash_schedule(plan, device=cuda_device)
    pads = int((sched.tile_ids == hash_tiled._DROP_TILE).sum())
    assert pads > 0
    _check_k7(plan, spec, sched, params,
              torch.Generator(device=cuda_device).manual_seed(5))


def test_hash_kernels_on_the_fit_stack(cuda_device):
    """The fit's four-view stack (chip_smoke.py phase 14 at 32^2), for an
    opaque teacher (table std 1, sigma_b2 + 5): rays stop early; K7f and
    K7b against their twins on every tile, repeats bit for bit."""
    import chip_smoke as cs

    f_plan, cams = cs.hash_fit_setup(P, width=32)
    spec = P.HashMLPSpec(n_levels=8, table_size=128, base_resolution=2.0,
                         finest_resolution=48.0)
    stack = hash_tiled.build_hash_schedule_stack(
        fit.view_plans(f_plan, cams), device=cuda_device)
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, table_std=1.0,
                                         device=cuda_device)
    opaque = {k: v.detach().clone() for k, v in teacher.params.items()}
    opaque["sigma_b2"] += cs.OPAQUE_BIAS
    early = _check_k7(f_plan, spec, stack, opaque,
                      torch.Generator(device=cuda_device).manual_seed(9))
    assert early > 0


@pytest.mark.parametrize("name", ["stratified", "roi", "l8"])
def test_hash_forward_on_the_card_matches_cpu(cuda_device, name):
    plan, field = hash_scene(name, cuda_device)
    before = hash_tiles.hash_tile_forward.launches
    got = P.Renderer(P.Context.create(device="cuda"), plan).forward(field)
    assert hash_tiles.hash_tile_forward.launches == before + 1
    assert "hash_tiled_path" in got.stats.notes
    ref = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True)).forward(
        hash_scene(name)[1])
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL)
    np.testing.assert_allclose(got.depth, ref.depth, atol=TOL_DEPTH)
    np.testing.assert_array_equal(got.hitmask, ref.hitmask)


def test_fit_hash_mlp_on_the_card_matches_cpu(cuda_device):
    plan, field = hash_scene("stratified")
    cams = [P.CameraConfig(k=plan.camera.k, c2w=c2w) for c2w in (
        (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0),
        (0, 0, -1, 2.0, 0, 1, 0, 0.5, 1, 0, 0, 0.5))]
    tgt = np.random.default_rng(2).uniform(
        0, 1, (2, plan.height, plan.width, 3)).astype(np.float32)
    config = fit.FitConfig(learning_rate=8e-3, steps=3, sync_every=2,
                           target_psnr=None)
    graph_mod.reset_launch_counts()
    got = fit.fit_hash_mlp(plan, field.to(cuda_device), cams, tgt, config)
    assert got.recorded_launches == {"hash_tiles": 1, "hash_tiles_bwd": 1}
    assert _moved() == _twice(got.recorded_launches)
    want = fit.fit_hash_mlp(plan, hash_scene("stratified")[1], cams, tgt,
                            config)
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-5)
    assert got.steady_step_ms > 0.0


# -------------------------------------------------------- hash grid (K8)

GRID_SPECS = {
    # tests/test_hash_grid.py's spec: C = 48
    "test": dict(n_levels=3, features_per_level=2, table_size=4096,
                 resolutions=(2, 4, 8)),
    # encoding_dim 64, C = 512: the widest grid_path_ok admits (K8b takes
    # one step per staged group and eight column panels)
    "wide": dict(n_levels=8, features_per_level=8, table_size=4096,
                 resolutions=(1, 1, 2, 2, 4, 4, 8, 8)),
}
GRID_SCENES = ("fixed", "stratified", "opaque", "wide")


def grid_scene(name, device=None):
    """tests/test_hash_grid.py's plan (32^2, 16 steps) and a field from a
    seeded generator (table std 0.5); "opaque" adds 30 to sigma_b2, so
    rays stop early."""
    spec = P.HashMLPSpec(**GRID_SPECS["wide" if name == "wide" else "test"])
    w, steps = 32, 16
    mode = (P.SamplingMode.FIXED if name == "fixed"
            else P.SamplingMode.STRATIFIED)
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0,
                                 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=mode)))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(4),
                                       spec=spec, table_std=0.5,
                                       device="cpu")
    if name == "opaque":
        with torch.no_grad():
            field.params["sigma_b2"] += 30.0
    return plan, field.to(device) if device is not None else field


def _group_tiles_args(plan, field, sched):
    """Per tile group, the one-launch wrappers' arguments over that group
    alone (a one-shape TileSet): (flat bank tables, tiles, sc, params)."""
    subs = (16 // sched.tile_px) ** 2
    table = hash_grid.build_hash_grid_table(dict(field.params), field.spec)
    tabs = tiled._gather_banks_flat(table, sched.gathermap_all)
    sc = hash_tiles.pack_mlp_scalars(dict(field.params), field.spec)
    args, b0 = [], 0
    for g in sched.groups:
        tiles = fused_tiles.tile_set([g], subs)
        n_b = g.n_tiles * g.banks
        args.append((tabs[b0:b0 + n_b], tiles, sc,
                     hash_grid.tiles_op_params(plan, field.spec, tiles)))
        b0 += n_b
    return args


def _grid_args(name, device):
    plan, field = grid_scene(name, device)
    field.requires_grad_(False)
    sched = hash_tiled.build_hash_grid_schedule(plan, field, device=device)
    return plan, _group_tiles_args(plan, field, sched)


@pytest.mark.parametrize("name", GRID_SCENES)
def test_hash_grid_forward_matches_plain(cuda_device, name):
    plan, args = _grid_args(name, cuda_device)
    for a in args:
        before = hash_grid.hash_grid_forward_tiles.launches
        out = hash_grid.hash_grid_forward_tiles(*a)
        torch.cuda.synchronize()
        assert hash_grid.hash_grid_forward_tiles.launches == before + 1
        plain = hash_grid.hash_grid_forward_tiles_plain(*a)
        assert bool(torch.isfinite(out).all())
        (r, g, b), t, o, d = fused_tiles.finalize_heads(plan, out)
        (r2, g2, b2), t2, o2, d2 = fused_tiles.finalize_heads(plan, plain)
        for x, y in ((r, r2), (g, g2), (b, b2), (t, t2), (o, o2)):
            assert float((x - y).abs().max()) <= TOL
        assert float((d - d2).abs().max()) <= TOL_DEPTH
    if name == "opaque":   # some ray stops early
        a = args[0]
        no_stop = hash_grid.hash_grid_forward_tiles_plain(
            *a[:3], dataclasses.replace(a[3], stop=0.0))
        assert bool((hash_grid.hash_grid_forward_tiles_plain(*a)[:, 4]
                     < no_stop[:, 4]).any())


@pytest.mark.parametrize("name", GRID_SCENES)
def test_hash_grid_backward_matches_plain(cuda_device, name):
    _, args = _grid_args(name, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for a in args:
        gs = torch.randn((a[1].n_tiles, 5, 16, 16), generator=gen,
                         device=cuda_device)
        before = hash_grid.hash_grid_backward_tiles.launches
        d_rows, d_sc = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
        torch.cuda.synchronize()
        assert hash_grid.hash_grid_backward_tiles.launches == before + 1
        p_rows, p_sc = hash_grid.hash_grid_backward_tiles_plain(*a[:3], gs,
                                                                a[3])
        for got, want in ((d_rows, p_rows), (d_sc, p_sc)):
            assert bool(torch.isfinite(got).all())
            _close(got, want, HASH_GRAD_TOL)
        again = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
        assert torch.equal(again[0], d_rows) and torch.equal(again[1], d_sc)


def test_hash_grid_kernels_reject_strided_input(cuda_device):
    _, args = _grid_args("fixed", cuda_device)
    tabs = args[0][0]
    strided = torch.empty((tabs.shape[0] * 2,) + tabs.shape[1:],
                          device=cuda_device)[::2]
    strided.copy_(tabs)
    with pytest.raises(ValueError):
        hash_grid.hash_grid_forward_tiles(strided, *args[0][1:])


@pytest.mark.parametrize("name", ["stratified", "opaque"])
def test_render_hash_grid_on_the_card_matches_cpu(cuda_device, name):
    """render_hash_grid_tiled and its gradients through autograd on the
    card against the CPU twins; under torch.use_deterministic_algorithms
    two backwards are equal bit for bit."""
    def run(device):
        plan, field = grid_scene(name, device)
        sched = hash_tiled.build_hash_grid_schedule(plan, field,
                                                    device=device)
        out = hash_tiled.render_hash_grid_tiled(plan, field, sched)
        loss = torch.mean(out.image ** 2) + 0.25 * torch.mean(out.opacity)
        keys = sorted(field.params)
        grads = torch.autograd.grad(loss, [field.params[k] for k in keys])
        return out, dict(zip(keys, grads))

    launches = (hash_grid.hash_grid_forward_tiles.launches,
                hash_grid.hash_grid_backward_tiles.launches)
    torch.use_deterministic_algorithms(True)
    try:
        got, g1 = run(cuda_device)
        _, g2 = run(cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    # one K8f and one K8b launch per render and backward
    assert hash_grid.hash_grid_forward_tiles.launches == launches[0] + 2
    assert hash_grid.hash_grid_backward_tiles.launches == launches[1] + 2
    want, gw = run("cpu")
    for key in ("image", "transmittance", "opacity"):
        assert float((getattr(got, key).cpu() - getattr(want, key))
                     .abs().max()) <= TOL
    assert float((got.depth.cpu() - want.depth).abs().max()) <= TOL_DEPTH
    for k in gw:
        assert torch.equal(g1[k], g2[k]), k
        _close(g1[k].cpu(), gw[k], HASH_GRAD_TOL)


# ------------------------------------------ 16-bit tables and sparse (K5)

ULP16 = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
DTYPES16 = (torch.bfloat16, torch.float16)


@pytest.mark.parametrize("dtype", DTYPES16)
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_table16_bit_equal_to_plain(cuda_device, dtype, shape):
    rng = np.random.default_rng(2)
    sigma = torch.from_numpy(
        rng.uniform(-1, 300, shape).astype(np.float32)).to(cuda_device)
    color = torch.from_numpy(
        rng.uniform(0, 1, shape + (3,)).astype(np.float32)).to(cuda_device)
    before = packed_transpose.build_rows16.launches
    got = packed_transpose.build_rows16(sigma, color, dtype)
    torch.cuda.synchronize()
    assert packed_transpose.build_rows16.launches == before + 1
    want = packed_transpose.build_rows16_plain(sigma, color, dtype)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # a row's 16-byte words as 32-bit pair words, as the kernel stores them
    assert torch.equal(_words(got), _words(want))


def _special_grid16(shape, seed):
    """Float32 values that exercise the round to 16 bits: +-inf, -0.0,
    NaN with payloads and signs, values past float16's range, float16
    subnormals, and exact ties of both types (halfway between two
    neighbours, odd and even below)."""
    n = int(np.prod(shape)) * 4
    rng = np.random.default_rng(seed)
    v = rng.normal(scale=4.0, size=n).astype(np.float32)
    words = v.view(np.uint32)
    words[0::17] = 0x80000000                              # -0.0
    words[1::19] = 0x7F800000                              # inf
    words[2::23] = 0xFF800000                              # -inf
    nan = np.arange(words[3::13].size, dtype=np.uint32)
    words[3::13] = 0x7F800001 + (nan * 0x9E3779) % 0x7FFFFF  # NaN payloads
    words[4::29] = 0xFFC00000 | (nan[:words[4::29].size] & 0x3FFFFF)
    v[5::11] = rng.uniform(65520.0, 1e6, v[5::11].size)   # float16 inf
    v[6::11] = rng.uniform(-1e6, -65520.0, v[6::11].size)
    v[7::11] = rng.uniform(-6e-5, 6e-5, v[7::11].size)    # f16 subnormals
    m = np.arange(v[8::11].size, dtype=np.uint32)
    words[8::11] = (0x3F800000 + (m % 255) * 0x10000) | 0x8000  # bf16 ties
    v[9::11] = (1.0 + (2 * (m[:v[9::11].size] % 1023) + 1) * 2.0 ** -11)
    v[10::11] = 2.0 ** -14 * (m[:v[10::11].size] % 1024 + 0.5) * 2.0 ** -10
    return torch.from_numpy(v)


@pytest.mark.parametrize("dtype", DTYPES16)
def test_packed_table16_special_values(cuda_device, dtype):
    """The round to nearest even on the card against the twin's cast on
    the card: infinities, -0.0, overflow to inf (float16), subnormals
    and ties, word for word; NaN too (both casts give the card's NaN)."""
    shape = (5, 7, 9)
    n = 5 * 7 * 9
    floats = _special_grid16(shape, 4).to(cuda_device)
    sigma = floats[:n].reshape(shape)
    color = floats[n:].reshape(shape + (3,))
    got = packed_transpose.build_rows16(sigma, color, dtype)
    want = packed_transpose.build_rows16_plain(sigma, color, dtype)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want.float()).any())
    assert bool(torch.isinf(want.float()).any())
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype", DTYPES16)
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_table16_grad_bit_equal_to_plain(cuda_device, dtype, shape):
    rows = packed_transpose.fullpitch_rows(shape)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    tg = torch.randn((rows, 32), generator=gen, device=cuda_device).to(dtype)
    before = packed_transpose.table16_grad_to_params.launches
    got = packed_transpose.table16_grad_to_params(tg, shape)
    torch.cuda.synchronize()
    assert packed_transpose.table16_grad_to_params.launches == before + 1
    want = packed_transpose.table16_grad_to_params_plain(tg, shape)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_words(a), _words(b))


@pytest.mark.parametrize("dtype", DTYPES16)
def test_packed_table16_grad_repeats_bit_for_bit(cuda_device, dtype):
    shape = (41, 70, 61)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    tg = torch.randn((packed_transpose.fullpitch_rows(shape), 32),
                     generator=gen, device=cuda_device).to(dtype)
    first = packed_transpose.table16_grad_to_params(tg, shape)
    again = packed_transpose.table16_grad_to_params(tg, shape)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(_words(a), _words(b))


def test_packed_table16_rejects_strided_input(cuda_device):
    sigma = torch.zeros((4, 4, 8), device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError):
        packed_transpose.build_rows16(
            sigma, torch.zeros((4, 4, 4, 3), device=cuda_device),
            torch.bfloat16)
    rows = packed_transpose.fullpitch_rows((4, 4, 4))
    tg = torch.zeros((rows, 64), dtype=torch.bfloat16,
                     device=cuda_device)[:, ::2]
    with pytest.raises(ValueError):
        packed_transpose.table16_grad_to_params(tg, (4, 4, 4))


def _field(config, device, kind):
    """The scene's dense field with a 16-bit table (kind a torch dtype),
    or its sparse bricks at threshold 0 (kind "sparse" / "sparse16")."""
    dense = P.DenseGridField.create(config, device="cpu")
    if kind in ("sparse", "sparse16"):
        dtype = "bfloat16" if kind == "sparse16" else "float32"
        return P.SparseGridField.from_dense(dense, dtype=dtype, device=device)
    return dense.with_packed_dtype(str(kind).replace("torch.", "")).to(
        device)


def _grad_tol(renderer, kind):
    if kind == "sparse":
        return GRID_TOL
    c = max(c_k for _, _, c_k in renderer._tiled_schedule.gather_plan.meta)
    return c * ULP16[torch.bfloat16 if kind == "sparse16" else kind]


@pytest.mark.parametrize("kind", [torch.bfloat16, torch.float16, "sparse",
                                  "sparse16"])
def test_tables_on_the_card_match_cpu(cuda_device, kind):
    """Renderer.forward and .backward on a 16-bit dense field (K5a, K1,
    K2, K5b) and on a sparse field (K1, K2) against the CPU's, and two
    backwards under torch.use_deterministic_algorithms equal bit for
    bit."""
    plan, config = scene("stratified")
    dl = np.random.default_rng(3).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    counts = (packed_transpose.build_rows16.launches,
              packed_transpose.table16_grad_to_params.launches,
              packed_transpose.build_rows.launches,
              fused_tiles.tile_backward.launches)
    card = P.Renderer(P.Context.create(device="cuda"), plan)
    field = _field(config, cuda_device, kind)
    got = card.forward(field)
    torch.use_deterministic_algorithms(True)
    try:
        g1 = card.backward(field, dl)
        g2 = card.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    sparse = kind in ("sparse", "sparse16")
    k5 = (packed_transpose.build_rows16.launches - counts[0],
          packed_transpose.table16_grad_to_params.launches - counts[1])
    assert k5 == ((0, 0) if sparse else (3, 2))   # backwards rebuild
    assert packed_transpose.build_rows.launches == counts[2]
    assert fused_tiles.tile_backward.launches > counts[3]
    cpu = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True))
    cpu_field = _field(config, "cpu", kind)
    ref = cpu.forward(cpu_field)
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL)
    np.testing.assert_allclose(got.depth, ref.depth, atol=TOL_DEPTH)
    want = cpu.backward(cpu_field, dl)
    keys = ("bricks",) if sparse else ("sigma", "color")
    for key in keys:
        a, b = getattr(g1, key), getattr(want, key)
        assert np.isfinite(a).all() and np.abs(a).max() > 0
        _close(torch.from_numpy(a), torch.from_numpy(b),
               _grad_tol(card, kind))
    for key in keys + ("camera", "camera_k"):
        np.testing.assert_array_equal(getattr(g2, key), getattr(g1, key))


# ------------------------------------------- sub-tiles and supercells (K1, K2)

VARIANTS = ((16, 2), (8, 1), (8, 2), (4, 1), (4, 2))   # (tile_px, cell_scale)


def super_scene():
    """tests/test_supercell.py::scene in the port's terms: 48^2 rays over
    a 32^3 Gaussian blob, 32 stratified steps (16 px cell tables overflow
    every tile; the cascade lands on 8 px supercells)."""
    n, wh, steps = 32, 48, 32
    zs, ys, xs = np.meshgrid(*[np.linspace(0, 1, n)] * 3, indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * np.exp(-r2 / 0.05)).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], -1).astype(np.float32)
    plan = P.Plan.create(P.PlanConfig(
        width=wh, height=wh, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(wh * 1.2, 0, wh / 2, 0, wh * 1.2, wh / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    config = P.DenseGridConfig(resolution=(n,) * 3, sigma=sigma.reshape(-1),
                               color=color.reshape(-1))
    return plan, config


def _variant_args(px, scale, device):
    """The supercell scene's (px, scale) schedule, overflow or not, as
    K1's one-launch arguments on ``device``: the whole schedule, then
    each group alone."""
    plan, config = super_scene()
    field = P.DenseGridField.create(config, device=device)
    sched = tiled.build_tiled_schedule(plan, field, tile_px=px,
                                       cell_scale=scale).to(device)
    sigma, color = field.sigma.detach(), field.color.detach()
    table = (build_supercell_stencil(sigma, color) if scale == 2
             else packed_transpose.build_rows_plain(sigma, color))
    return set_args(plan, sched, table, "super" if scale == 2 else "cell")


@pytest.mark.parametrize("px,scale", VARIANTS)
def test_tile_variants_bit_equal_to_plain(cuda_device, px, scale):
    """K1 and K2 in their sub-tiled and supercell forms: equal to their
    twins bit for bit (heads, d(table) rows, d(rayt)), repeat runs too."""
    groups = _variant_args(px, scale, cuda_device)
    assert groups
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    for tabs, tiles, prm in groups:
        assert tabs.shape[1] == (108 if scale == 2 else 32)
        before = (fused_tiles.tile_forward.launches,
                  fused_tiles.tile_backward.launches)
        out = fused_tiles.tile_forward(tabs, tiles, prm)
        gs = torch.randn((tiles.n_tiles, 5, 16, 16), generator=gen,
                         device=cuda_device)
        rows, d_rayt = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                 cam=True)
        torch.cuda.synchronize()
        assert (fused_tiles.tile_forward.launches,
                fused_tiles.tile_backward.launches) == (before[0] + 1,
                                                        before[1] + 1)
        assert torch.equal(out, fused_tiles.tile_forward_set_plain(
            tabs, tiles, prm))
        p_rows, p_rayt = fused_tiles.tile_backward_set_plain(
            tabs, tiles, gs, prm, cam=True)
        assert bool(torch.isfinite(rows).all())
        assert torch.equal(rows, p_rows) and torch.equal(d_rayt, p_rayt)
        rows2, d_rayt2 = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                   cam=True)
        assert torch.equal(rows2, rows) and torch.equal(d_rayt2, d_rayt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cascade_on_the_card_matches_cpu(cuda_device, dtype):
    """The supercell scene through the Renderer's cascade (float32: 8 px
    supercells; bfloat16: 4 px cells): the frame on the card against the
    CPU's; the backward against the plain path on the card (the kernels
    equal their twins, so bit for bit) and, under deterministic
    algorithms, against itself."""
    plan, config = super_scene()
    dl = np.random.default_rng(4).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    card = P.Renderer(P.Context.create(device="cuda"), plan)
    field = P.DenseGridField.create(config, device=cuda_device)
    field = field.with_packed_dtype(dtype)
    got = card.forward(field)
    ref = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True)).forward(
        P.DenseGridField.create(config, device="cpu").with_packed_dtype(dtype))
    note = ("tiled_supercell_8px" if dtype == "float32"
            else "tiled_subtiled_4px")
    assert note in got.stats.notes and note in ref.stats.notes
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL)
    # depth = wd / opacity: rays of this scene end just above OPACITY_EPS,
    # where the quotient turns the last bit of exp (the card's and the
    # CPU's differ) into 1e-4; compare it where opacity is not that small
    seen = ref.opacity > 1e-3
    np.testing.assert_allclose(got.depth[seen], ref.depth[seen],
                               atol=TOL_DEPTH)
    torch.use_deterministic_algorithms(True)
    try:
        g1 = card.backward(field, dl)
        g2 = card.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    from dvren_tpu_torch.ops.raygen import camera_arrays

    leaf = field.with_params(field.sigma.detach().clone(),
                             field.color.detach().clone())
    k, c2w, _ = camera_arrays(plan, cuda_device)
    img = tiled.render_tiled(plan, leaf, card._tiled_schedule,
                             use_kernel=False, k=k.requires_grad_(True),
                             c2w=c2w.requires_grad_(True)).image
    dl_img = card._dl_image(dl.reshape(-1, 3))
    want = torch.autograd.grad(torch.sum(img * dl_img),
                               (leaf.sigma, leaf.color))
    for key, w in zip(("sigma", "color"), want):
        x = getattr(g1, key)
        assert np.isfinite(x).all() and np.abs(x).max() > 0
        np.testing.assert_array_equal(x, w.cpu().numpy().reshape(-1))
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(g2, key), getattr(g1, key))


def test_empty_schedule_stays_on_the_card(cuda_device):
    """No ray enters the bbox: the planes are the background, built on the
    card, and the backward gives zero gradients."""
    plan, config = scene("stratified")
    config = dataclasses.replace(config, bbox_min=(50.0, 50.0, 50.0),
                                 bbox_max=(51.0, 51.0, 51.0))
    field = P.DenseGridField.create(config, device=cuda_device)
    sched = tiled.build_tiled_schedule(plan, field).to(cuda_device)
    assert not sched.groups
    planes = tiled.render_tiled(plan, field, sched)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert getattr(planes, key).device.type == "cuda", key
    assert bool(torch.all(planes.transmittance == 1.0))
    r = P.Renderer(P.Context.create(device="cuda"), plan)
    r.forward(field)
    g = r.backward(field, np.ones(plan.ray_count * 3, np.float32))
    for key in ("sigma", "color", "camera", "camera_k"):
        assert not np.any(getattr(g, key))


# ------------------------------ grid sub-tiles (K8 at subs 4 and 16)

GRID_SUB_SPEC = dict(n_levels=4, features_per_level=2, table_size=4096,
                     base_resolution=2.0, finest_resolution=16.0,
                     resolutions=(2, 4, 8, 16))
GRID_SUB_SCENES = {"8px": (48, 32, 8), "4px": (24, 24, 4)}


def grid_sub_scene(name, device):
    """tests/test_torch_grid_subtiles.py's scenes: view 0 of
    tools/fit_benchmark.py's camera at 48^2 / 32 steps (the cascade picks
    8 px) and 24^2 / 24 steps (4 px), a seeded field (table std 0.5)."""
    w, steps, _ = GRID_SUB_SCENES[name]
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2,
        camera=P.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.65, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    field = P.HashMLPField.init_random(
        torch.Generator().manual_seed(0), spec=P.HashMLPSpec(**GRID_SUB_SPEC),
        table_std=0.5, device="cpu")
    return plan, field.to(device)


@pytest.mark.parametrize("name", sorted(GRID_SUB_SCENES))
def test_hash_grid_subtiles_match_plain(cuda_device, name):
    """K8f at subs 4 / 16 equal to its twin bit for bit on every group of
    the cascade's schedule; K8b within 2e-5 x scale of its twin, and its
    repeat runs bit for bit."""
    plan, field = grid_sub_scene(name, cuda_device)
    field.requires_grad_(False)
    sched = hash_tiled.build_hash_grid_schedule(plan, field,
                                                device=cuda_device)
    assert sched.tile_px == GRID_SUB_SCENES[name][2]
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for a in _group_tiles_args(plan, field, sched):
        assert a[3].subs == (16 // sched.tile_px) ** 2
        before = (hash_grid.hash_grid_forward_tiles.launches,
                  hash_grid.hash_grid_backward_tiles.launches)
        out = hash_grid.hash_grid_forward_tiles(*a)
        gs = torch.randn((a[1].n_tiles, 5, 16, 16), generator=gen,
                         device=cuda_device)
        d_rows, d_sc = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
        torch.cuda.synchronize()
        assert (hash_grid.hash_grid_forward_tiles.launches,
                hash_grid.hash_grid_backward_tiles.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(out, hash_grid.hash_grid_forward_tiles_plain(*a))
        p_rows, p_sc = hash_grid.hash_grid_backward_tiles_plain(*a[:3], gs,
                                                                a[3])
        for got, want in ((d_rows, p_rows), (d_sc, p_sc)):
            assert bool(torch.isfinite(got).all())
            _close(got, want, HASH_GRAD_TOL)
        again = hash_grid.hash_grid_backward_tiles(*a[:3], gs, a[3])
        assert torch.equal(again[0], d_rows) and torch.equal(again[1], d_sc)


# ------------------------------------------ merged views and the fit

FIT_N = 8


def fit_scene(device):
    """tests/test_fit.py's scene in the port's terms: 12^2 views of an 8^3
    blob (25 fixed steps) from four cameras on a translation row."""
    n, w = FIT_N, 12
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.3, t_far=2.3,
        camera=P.CameraConfig(k=(14.0, 0, w / 2, 0, 14.0, w / 2, 0, 0, 1)),
        sampling=P.SamplingConfig(dt=0.08, max_steps=25)))
    cams = [P.CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1,
                                -1.0)) for dx in (-0.15, 0.0, 0.15, 0.3)]
    rng = np.random.default_rng(0)
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.5) ** 2
    sigma = (10.0 * np.exp(-r2 / 0.07)).astype(np.float32)
    color = rng.uniform(0.2, 0.9, (n, n, n, 3)).astype(np.float32)
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device=device)
    return plan, cams, field


def test_render_tiled_stack_matches_plain(cuda_device):
    """One merged group: K1 once and K2 once for the whole stack; the
    stack and its grid gradients within 5e-6 / 2e-6 x scale of the plain
    path on the card."""
    plan, cams, field = fit_scene(cuda_device)
    _, merged, render_stack = fit._scheduled_views(plan, cams, field, "tiled")
    assert len(merged.sched.groups) == 1 and merged.n_views == len(cams)
    target = torch.rand((len(cams), plan.height, plan.width, 3),
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(3), device=cuda_device)

    def run(use_kernel):
        leaf = field.with_params(field.sigma.detach().clone(),
                                 field.color.detach().clone())
        img = tiled.render_tiled_stack(plan, leaf, merged,
                                       use_kernel=use_kernel)
        grads = torch.autograd.grad(fit.mse(img, target),
                                    (leaf.sigma, leaf.color))
        return img.detach(), grads

    before = (fused_tiles.tile_forward.launches,
              fused_tiles.tile_backward.launches)
    img, grads = run(True)
    torch.cuda.synchronize()
    assert (fused_tiles.tile_forward.launches,
            fused_tiles.tile_backward.launches) == (before[0] + 1,
                                                    before[1] + 1)
    img_p, grads_p = run(False)
    assert float((img - img_p).abs().max()) <= TOL
    for a, b in zip(grads, grads_p):
        assert float(b.abs().max()) > 0.0
        _close(a, b, GRID_TOL)


def _moved() -> dict:
    """The launch counters that moved since ``reset_launch_counts``."""
    return {k: v for k, v in graph_mod.launch_counts().items() if v}


def _twice(recorded: dict) -> dict:
    """The counts a recorded step moves the counters by: its warm-up and
    its recording each launch every kernel once through its wrapper; the
    replays launch none."""
    return {k: 2 * v for k, v in recorded.items()}


def test_fit_dense_grid_on_the_card(cuda_device):
    """Three steps of fit_dense_grid: one K1 and one K2 launch recorded in
    the step's graph over the merged groups, the counters moved by the
    warm-up and the recording only (the replays launch through no
    wrapper); the losses within 1e-5 relative of the CPU's fit."""
    plan, cams, truth = fit_scene(cuda_device)
    with torch.no_grad():
        _, merged, render_stack = fit._scheduled_views(plan, cams, truth,
                                                       "tiled")
        targets = render_stack(truth, merged).cpu().numpy()

    def flat(device):
        f = fit_scene(device)[2]
        return f.with_params(torch.full_like(f.sigma, 0.5),
                             torch.full_like(f.color, 0.5))

    config = fit.FitConfig(learning_rate=5e-2, steps=3, sync_every=2,
                           target_psnr=None)
    graph_mod.reset_launch_counts()
    got = fit.fit_dense_grid(plan, flat(cuda_device), cams, targets, config,
                             mode="tiled")
    assert got.steps_run == 3
    rec = got.recorded_launches
    assert rec["fused_tiles"] == 1 and rec["fused_tiles_bwd"] == 1
    assert _moved() == _twice(rec)
    want = fit.fit_dense_grid(plan, flat("cpu"), cams, targets, config,
                              mode="tiled")
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-5)
    assert got.loss_history[-1] < got.loss_history[0]
    assert float(got.field.sigma.min()) >= 0.0
    assert float(got.field.color.max()) <= 1.0
    assert got.steady_step_ms > 0.0


# ---------------------------------------------------------------- K9


def integrate_scene(device, n=40, k=50, seed=0, hi=4.0, zeros=False,
                    masked_rows=False):
    """tests/test_pallas_parity.py's lattice: sigma in [0, hi), ragged
    live prefixes; ``zeros`` sets a third of sigma to exactly 0,
    ``masked_rows`` masks every seventh row whole."""
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0.0, hi, (n, k)).astype(np.float32)
    if zeros:
        sigma[rng.uniform(size=(n, k)) < 0.3] = 0.0
    color = rng.uniform(0, 1, (3, n, k)).astype(np.float32)
    dt = np.full((n, k), 0.05, np.float32)
    mask = np.ones((n, k), bool)
    for i, length in enumerate(rng.integers(k // 2, k + 1, n)):
        mask[i, length:] = False
        dt[i, length:] = 0.0
    if masked_rows:
        mask[3::7] = False
        dt[3::7] = 0.0
    origin = (0.3 + rng.integers(0, 5, n) * 0.05).astype(np.float32)
    g = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    t = [torch.from_numpy(x).to(device)
         for x in (sigma, dt, mask, origin, g)]
    planes = tuple(torch.from_numpy(c).to(device) for c in color)
    return t[0], planes, t[1], t[2], t[3], t[4]


# (n, k, hi, zeros): tests/test_pallas_parity.py's lattices, then every row
# length around the register path's chunks (1 to 4 of 32 steps) and the
# grouped walk past 128 steps, at 1, 5 and 9,216 rays (a 96^2 view), each
# with ragged rows (every seventh masked whole), rows that stop in their
# first chunk (hi 40) and a third of sigma exactly 0 (the 0.5 tie)
K9_CASES = [(40, 50, 4.0, False), (40, 50, 40.0, False),
            (16, 200, 4.0, False), (300, 96, 4.0, True)] + [
    (n, k, hi, zeros)
    for k in (1, 31, 32, 33, 96, 128, 129, 200, 256)
    for n in (1, 5, 9216)
    for hi, zeros in ((4.0, False), (40.0, False), (4.0, True))]


def k9_case_id(case):
    n, k, hi, zeros = case
    return f"{n}x{k}-hi{hi:g}" + ("-tie" if zeros else "")


@pytest.mark.parametrize("n,k,hi,zeros", K9_CASES,
                         ids=[k9_case_id(c) for c in K9_CASES])
@pytest.mark.parametrize("with_origin", [False, True])
def test_integrate_forward_matches_plain(cuda_device, n, k, hi, zeros,
                                         with_origin):
    sigma, planes, dt, mask, origin, _ = integrate_scene(
        cuda_device, n, k, hi=hi, zeros=zeros, masked_rows=True)
    origin = origin if with_origin else None
    before = integrate_fused.integrate_forward.launches
    got = integrate_fused.integrate_forward(sigma, planes, dt, mask, 0.3,
                                            2.8, origin)
    again = integrate_fused.integrate_forward(sigma, planes, dt, mask, 0.3,
                                              2.8, origin)
    torch.cuda.synchronize()
    assert integrate_fused.integrate_forward.launches == before + 2
    assert torch.equal(got, again)
    want = integrate_fused.integrate_forward_plain(sigma, planes, dt, mask,
                                                   0.3, 2.8, origin)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got[:, 5], want[:, 5],
                               rtol=1e-4 if k >= 128 else 1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,hi,zeros", K9_CASES,
                         ids=[k9_case_id(c) for c in K9_CASES])
def test_integrate_backward_matches_plain(cuda_device, n, k, hi, zeros):
    sigma, planes, dt, mask, _, g = integrate_scene(
        cuda_device, n, k, hi=hi, zeros=zeros, masked_rows=True)
    before = integrate_fused.radiance_vjp.launches
    ds, dc = integrate_fused.radiance_vjp(sigma, planes, dt, mask, g)
    ds2, dc2 = integrate_fused.radiance_vjp(sigma, planes, dt, mask, g)
    torch.cuda.synchronize()
    assert integrate_fused.radiance_vjp.launches == before + 2
    assert torch.equal(ds, ds2)
    assert all(torch.equal(a, b) for a, b in zip(dc, dc2))
    ps, pc = integrate_fused.radiance_vjp_plain(sigma, planes, dt, mask, g)
    np.testing.assert_allclose(ds.cpu().numpy(), ps.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    for a, b in zip(dc, pc):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-7)


def test_integrate_fused_autograd_on_the_card(cuda_device):
    """The autograd node on the card: radiance through K9f / K9b, the
    other heads through the twin; the same gradients as on the CPU."""
    def grads(device):
        sigma, planes, dt, mask, origin, g = integrate_scene(device, 64, 70)
        sigma.requires_grad_(True)
        planes = tuple(p.clone().requires_grad_(True) for p in planes)
        rad, t, op, depth = integrate_fused.integrate_fused(
            sigma, planes, dt, mask, 0.3, 2.8, origin)
        loss = (rad * g).sum() + (0.3 * t + 0.2 * op + 0.1 * depth).sum()
        return [x.detach().cpu().numpy()
                for x in torch.autograd.grad(loss, (sigma,) + planes)]

    before = (integrate_fused.integrate_forward.launches,
              integrate_fused.radiance_vjp.launches)
    got = grads(cuda_device)
    assert (integrate_fused.integrate_forward.launches,
            integrate_fused.radiance_vjp.launches) == (before[0] + 1,
                                                       before[1] + 1)
    for a, b in zip(got, grads("cpu")):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_integrate_kernels_reject_strided_input(cuda_device):
    sigma, planes, dt, mask, _, g = integrate_scene(cuda_device, 8, 64)
    with pytest.raises(ValueError):
        integrate_fused.integrate_forward(sigma[:, ::2], tuple(
            p[:, ::2] for p in planes), dt[:, ::2], mask[:, ::2], 0.3, 2.8)


# --------------------------------------------- the windowed path on the card


def window_renderers(name, device):
    plan, config = scene(name)
    field = P.DenseGridField.create(config, device=device)
    if name == "nearest":
        field = P.DenseGridField(field.sigma, field.color,
                                 bbox_min=field.bbox_min,
                                 bbox_max=field.bbox_max,
                                 interp=P.InterpMode.NEAREST)
    r = P.Renderer(P.Context.create(device=str(device)), plan,
                   P.RenderOptions(use_window=True))
    return plan, field, r


def _k9_counts():
    return (integrate_fused.integrate_forward.launches,
            integrate_fused.radiance_vjp.launches)


@pytest.mark.parametrize("name", ["fixed", "stratified", "opaque"])
def test_windowed_renderer_on_the_card_matches_cpu(cuda_device, name):
    """Renderer(use_window=True) on the card: K9f once per group forward,
    K9b once per group backward; planes within 5e-6 (depth 1e-4) and
    gradients within 2e-6 x scale (camera rtol 2e-3 / atol 1e-4) of the
    CPU's; two deterministic backwards bit for bit."""
    plan, field, r = window_renderers(name, cuda_device)
    _, cpu_field, r_cpu = window_renderers(name, "cpu")
    before = _k9_counts()
    got = r.forward(field)
    n_groups = len(r._window_schedule.groups)
    assert _k9_counts() == (before[0] + n_groups, before[1])
    want = r_cpu.forward(cpu_field)
    for k in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   atol=TOL)
    np.testing.assert_allclose(got.depth, want.depth, atol=TOL_DEPTH)
    assert np.array_equal(got.hitmask, want.hitmask)
    dl = np.random.default_rng(4).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    before = _k9_counts()
    torch.use_deterministic_algorithms(True)
    try:
        g1 = r.backward(field, dl)
        g2 = r.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    assert _k9_counts()[1] == before[1] + 2 * n_groups
    gw = r_cpu.backward(cpu_field, dl)
    for k in ("sigma", "color", "camera", "camera_k"):
        assert np.array_equal(getattr(g1, k), getattr(g2, k))
    for k in ("sigma", "color"):
        ref = getattr(gw, k)
        np.testing.assert_allclose(getattr(g1, k), ref, rtol=0,
                                   atol=GRID_TOL * np.abs(ref).max())
    for k in ("camera", "camera_k"):
        np.testing.assert_allclose(getattr(g1, k), getattr(gw, k),
                                   rtol=2e-3, atol=1e-4)


def test_windowed_backward_repeats_without_the_flag(cuda_device):
    """The grid gradient's row sums (``take_rows``' backward) are
    deterministic with torch's deterministic mode off too."""
    plan, field, r = window_renderers("stratified", cuda_device)
    r.forward(field)
    dl = np.random.default_rng(5).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    g1 = r.backward(field, dl)
    g2 = r.backward(field, dl)
    assert np.array_equal(g1.sigma, g2.sigma)
    assert np.array_equal(g1.color, g2.color)
    assert not torch.are_deterministic_algorithms_enabled()


def partial_fallback_scene(device):
    """tests/test_tiled.py::test_subtiled_partial_fallback's scene in the
    port's terms: 32^2 over a 20^3 blob; at 8 px, 64 rays fall back."""
    n, w = 20, 32
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.6,
        camera=P.CameraConfig(
            k=(w * 1.25, 0, w / 2, 0, w * 1.25, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.3, 0, 1, 0, 0.3, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=0.04, max_steps=60)))
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r2 = (xs - 0.3) ** 2 + (ys - 0.3) ** 2 + (zs - 0.3) ** 2
    sigma = 15.0 * np.exp(-r2 / 0.1)
    sigma[sigma < 1e-3] = 0.0
    color = np.stack([xs, ys, zs], axis=-1)
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.astype(np.float32).reshape(-1),
        color=color.astype(np.float32).reshape(-1)), device=device)
    return plan, field


@pytest.mark.parametrize("tile_px", [8, 16])
def test_fallback_on_the_card_matches_cpu(cuda_device, tile_px):
    """render_tiled with fallback rays on the card: K1 once over the tile
    groups, K9f per fallback group; the frame within 5e-6 (depth 1e-4) of the
    CPU's, the grid gradients within 2e-6 x scale, repeats bit for bit."""
    def run(device):
        plan, field = partial_fallback_scene(device)
        sched = tiled.build_tiled_schedule(plan, field, tile_px=tile_px)
        assert sched.fallback_rays > 0
        sched = sched.to(device)
        leaf = field.with_params(field.sigma.detach().clone(),
                                 field.color.detach().clone())
        planes = tiled.render_tiled(plan, leaf, sched)
        grads = torch.autograd.grad(torch.sum(planes.image ** 2),
                                    (leaf.sigma, leaf.color))
        return planes, grads, len(sched.fallback.groups), len(sched.groups)

    before = (fused_tiles.tile_forward.launches, _k9_counts())
    got, g1, n_fb, n_t = run(cuda_device)
    assert n_t > 0 and fused_tiles.tile_forward.launches == before[0] + 1
    assert _k9_counts() == (before[1][0] + n_fb, before[1][1] + n_fb)
    _, g2, _, _ = run(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    want, gw, _, _ = run("cpu")
    for k in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, k).detach().cpu().numpy(),
                                   getattr(want, k).detach().numpy(),
                                   atol=TOL)
    np.testing.assert_allclose(got.depth.detach().cpu().numpy(),
                               want.depth.detach().numpy(), atol=TOL_DEPTH)
    for a, b in zip(g1, gw):
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=0,
                                   atol=GRID_TOL * np.abs(b).max())


@pytest.mark.parametrize("mode", ["windowed", "plain"])
def test_fit_modes_on_the_card(cuda_device, mode):
    """fit_dense_grid's windowed and plain modes on the card: K9f / K9b
    per stack group (windowed) or per view (plain) recorded in the step's
    graph, the counters moved by the warm-up and the recording only; the
    losses within 1e-5 relative of the CPU's."""
    plan, cams, truth = fit_scene(cuda_device)
    with torch.no_grad():
        targets = windowed_targets(plan, cams, truth)

    def flat(device):
        f = fit_scene(device)[2]
        return f.with_params(torch.full_like(f.sigma, 0.5),
                             torch.full_like(f.color, 0.5))

    config = fit.FitConfig(learning_rate=5e-2, steps=3, target_psnr=None)
    graph_mod.reset_launch_counts()
    got = fit.fit_dense_grid(plan, flat(cuda_device), cams, targets, config,
                             mode=mode)
    per_step = len(cams) if mode == "plain" else 1
    rec = got.recorded_launches
    assert rec["integrate_bwd"] == per_step and rec["integrate"] >= per_step
    assert _moved() == _twice(rec)
    want = fit.fit_dense_grid(plan, flat("cpu"), cams, targets, config,
                              mode=mode)
    assert got.mode == want.mode == mode
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-5)
    assert got.loss_history[-1] < got.loss_history[0]


# ------------------------------------------- the fits' recorded steps


GRAPH_MODES = ("tiled", "windowed", "plain", "hash")
GRAPH_STEPS = 5


def graph_case(mode, device):
    """(make(f, opt) -> step, fresh() -> field, targets, lr) of one fit
    mode: fit_scene's tiled, windowed and plain steps toward its own
    frames, and hash_scene("stratified")'s hash step toward random
    views."""
    if mode == "hash":
        plan, _ = hash_scene("stratified")
        cams = [P.CameraConfig(k=plan.camera.k, c2w=c2w) for c2w in (
            (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0),
            (0, 0, -1, 2.0, 0, 1, 0, 0.5, 1, 0, 0, 0.5))]
        stack = hash_tiled.build_hash_schedule_stack(
            fit.view_plans(plan, cams), device=device)
        targets = torch.from_numpy(np.random.default_rng(2).uniform(
            0, 1, (2, plan.height, plan.width, 3)).astype(np.float32)).to(
            device)
        return (lambda f, opt: fit._hash_train_step(plan, stack, opt),
                lambda: hash_scene("stratified", device)[1], targets, 8e-3)
    plan, cams, truth = fit_scene(device)
    views = (None if mode == "plain"
             else fit._scheduled_views(plan, cams, truth, mode))
    with torch.no_grad():
        targets = (windowed_targets(plan, cams, truth) if mode != "tiled"
                   else views[2](truth, views[1]).cpu().numpy())
    targets = torch.from_numpy(targets).to(device)

    def make(f, opt):
        if mode == "plain":
            return fit.make_train_step(plan, cams, f, opt)
        return fit.make_train_step_scheduled(plan, cams, f, opt, mode=mode,
                                             views=views)

    def fresh():
        return truth.with_params(torch.full_like(truth.sigma, 0.5),
                                 torch.full_like(truth.color, 0.5))

    return make, fresh, targets, 5e-2


def _capturable_adam(f, lr, capturable=True):
    return torch.optim.Adam(f.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, capturable=capturable)


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.int32)


def _assert_steps_equal(fa, opt_a, fb, opt_b, la, lb):
    """Losses, parameters and Adam's state equal bit for bit."""
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(la, lb))
    pa, pb = list(fa.parameters()), list(fb.parameters())
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(pa, pb))
    for a, b in zip(pa, pb):
        for k in opt_a.state[a]:
            assert torch.equal(_bits(opt_a.state[a][k].float()),
                               _bits(opt_b.state[b][k].float())), k


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_graphed_step_bit_equal_to_eager_on_the_card(cuda_device, mode):
    """The recorded step, replayed GRAPH_STEPS times, equals the eager
    capturable body bit for bit in losses, parameters and Adam's state;
    the counters move by the warm-up and the recording only."""
    make, fresh, targets, lr = graph_case(mode, cuda_device)
    fa, fb = fresh(), fresh()
    opt_a, opt_b = _capturable_adam(fa, lr), _capturable_adam(fb, lr)
    step_a, step_b = make(fa, opt_a), make(fb, opt_b)
    graph_mod.reset_launch_counts()
    la = [step_a(fa, targets) for _ in range(GRAPH_STEPS)]
    lb = [step_b.body(fb, targets) for _ in range(GRAPH_STEPS)]
    torch.cuda.synchronize()
    rec = step_a.graph.launches
    assert rec and _moved() == {k: 2 * v + v * GRAPH_STEPS
                                for k, v in rec.items()}
    _assert_steps_equal(fa, opt_a, fb, opt_b, la, lb)
    assert float(la[-1]) < float(la[0])


@pytest.mark.parametrize("mode", ["tiled", "windowed"])
def test_graphed_block_equals_replayed_steps_on_the_card(cuda_device, mode):
    """A block of k replays equals k replayed steps bit for bit."""
    plan, cams, _ = fit_scene(cuda_device)
    make, fresh, targets, lr = graph_case(mode, cuda_device)
    fa, fb = fresh(), fresh()
    opt_a, opt_b = _capturable_adam(fa, lr), _capturable_adam(fb, lr)
    views = fit._scheduled_views(plan, cams, fa, mode)
    block = fit.make_train_block_scheduled(plan, cams, fa, opt_a, 4,
                                           mode=mode, views=views)
    step = make(fb, opt_b)
    losses = block(fa, targets)
    singles = [step(fb, targets) for _ in range(4)]
    assert losses.shape == (4,)
    _assert_steps_equal(fa, opt_a, fb, opt_b, losses, singles)


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_graphed_fits_byte_equal_on_the_card(cuda_device, mode):
    """Two graphed fits from the same start are byte-equal; the fit's
    counters move by the warm-up and the recording only."""
    make, fresh, targets, lr = graph_case(mode, cuda_device)
    plan, cams, _ = fit_scene(cuda_device)
    config = fit.FitConfig(learning_rate=lr, steps=6, sync_every=4,
                           target_psnr=None)

    def run():
        if mode == "hash":
            hplan, _ = hash_scene("stratified")
            hcams = [P.CameraConfig(k=hplan.camera.k, c2w=c2w) for c2w in (
                (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0),
                (0, 0, -1, 2.0, 0, 1, 0, 0.5, 1, 0, 0, 0.5))]
            return fit.fit_hash_mlp(hplan, fresh(), hcams, targets, config)
        return fit.fit_dense_grid(plan, fresh(), cams, targets, config,
                                  mode=mode)

    graph_mod.reset_launch_counts()
    a = run()
    assert a.recorded_launches and _moved() == _twice(a.recorded_launches)
    assert a.capture_ms > 0.0 and a.first_step_s > 0.0
    b = run()
    assert a.loss_history == b.loss_history and a.steps_run == 6
    for x, y in zip(a.field.parameters(), b.field.parameters()):
        assert torch.equal(_bits(x), _bits(y))


def test_non_capturable_adam_raises_on_the_card(cuda_device):
    """A CUDA step given an Adam that keeps its step count on the host
    raises, naming the fix, and leaves the field as it was."""
    make, fresh, targets, lr = graph_case("tiled", cuda_device)
    f = fresh()
    step = make(f, _capturable_adam(f, lr, capturable=False))
    before = f.sigma.detach().clone()
    with pytest.raises(P.DvrenError, match="capturable=True"):
        step(f, targets)
    assert torch.equal(f.sigma.detach(), before)


def windowed_targets(plan, cams, field):
    from dvren_tpu_torch.render import windowed

    stack = windowed.build_stack_schedule(fit.view_plans(plan, cams),
                                          field.bbox_min, field.bbox_max,
                                          device=field.device)
    return windowed.render_windowed_stack(plan, field, stack).cpu().numpy()


# ------------------------------------------ the split backward (K6, K2)


@pytest.mark.parametrize("n_blocks", [1, 8, 5104])
def test_banks_to_rows_bit_equal_to_plain(cuda_device, n_blocks):
    """K6 on random 32-bit words (NaN payloads, -0.0, subnormals and
    infinities among them): equal to its twin word for word."""
    gen = torch.Generator(device=cuda_device).manual_seed(n_blocks)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (n_blocks, 32, 128),
                         generator=gen, dtype=torch.int32, device=cuda_device)
    banks = bits.view(torch.float32)
    before = packed_transpose.banks_to_rows.launches
    rows = packed_transpose.banks_to_rows(banks)
    torch.cuda.synchronize()
    assert packed_transpose.banks_to_rows.launches == before + 1
    want = packed_transpose.banks_to_rows_plain(banks)
    assert rows.shape == (n_blocks * 128, 32)
    assert torch.equal(rows.view(torch.int32), want.view(torch.int32))


def test_banks_to_rows_rejects_bad_input(cuda_device):
    banks = torch.zeros((4, 128, 32), device=cuda_device)
    with pytest.raises(ValueError):
        packed_transpose.banks_to_rows(banks.transpose(1, 2))
    with pytest.raises(ValueError):
        packed_transpose.banks_to_rows(banks)
    with pytest.raises(TypeError):
        packed_transpose.banks_to_rows(banks.transpose(1, 2).contiguous()
                                       .double())


@pytest.mark.parametrize("px", [16, 8, 4])
def test_tile_backward_banks_equal_rows(cuda_device, px):
    """K2's bank form against its rows form, transposed, bit for bit, with
    and without the camera adjoint; and against its twin's bank form."""
    groups = _variant_args(px, 1, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(px)
    for tabs, tiles, prm in groups:
        gs = torch.randn((tiles.n_tiles, 5, 16, 16), generator=gen,
                         device=cuda_device)
        for cam in (False, True):
            rows, rayt_r = fused_tiles.tile_backward(tabs, tiles, gs, prm,
                                                     cam=cam)
            before = fused_tiles.tile_backward.launches
            banks, rayt_b = fused_tiles.tile_backward(
                tabs, tiles, gs, prm, cam=cam, emit="banks")
            torch.cuda.synchronize()
            assert fused_tiles.tile_backward.launches == before + 1
            assert banks.shape == (tiles.n_bank_rows, 32, 128)
            assert torch.equal(banks, rows.transpose(1, 2))
            assert not cam or torch.equal(rayt_b, rayt_r)
        p_banks, _ = fused_tiles.tile_backward_set_plain(
            tabs, tiles, gs, prm, emit="banks")
        assert torch.equal(banks, p_banks)


@pytest.mark.parametrize("route", ["sparse", "stack"])
def test_split_routes_equal_on_the_card(cuda_device, route, monkeypatch):
    """Under BWD_SPLIT "pallas" the sparse float32 render_tiled and the
    dense render_tiled_stack give the "xla" route's gradients bit for bit,
    with K6 launched once over every group; the single-view dense route
    stays off the flag."""
    plan, config = scene("stratified")
    field = P.DenseGridField.create(config, device=cuda_device)
    if route == "sparse":
        field = P.SparseGridField.from_dense(field, threshold=0.0,
                                             device=cuda_device)
        sched = tiled.build_tiled_schedule(plan, field).to(cuda_device)
        groups = sched.groups
    else:
        cams = [P.CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0,
                                    1, -1.0)) for dx in (0.0, 0.1)]
        plans = fit.view_plans(plan, cams)
        sched = tiled.merge_view_schedules(
            [tiled.build_tiled_schedule(p, field, quantize=True)
             for p in plans], plans=plans).to(cuda_device)
        groups = sched.sched.groups

    def grads():
        if route == "sparse":
            leaf = field.with_params(field.bricks.detach().clone())
            params = (leaf.bricks,)
            img = tiled.render_tiled(plan, leaf, sched).image
        else:
            leaf = field.with_params(field.sigma.detach().clone(),
                                     field.color.detach().clone())
            params = (leaf.sigma, leaf.color)
            img = tiled.render_tiled_stack(plan, leaf, sched)
        return torch.autograd.grad(torch.sum(img ** 2), params)

    monkeypatch.setattr(tiled, "BWD_SPLIT", "xla")
    before = packed_transpose.banks_to_rows.launches
    xla = grads()
    assert packed_transpose.banks_to_rows.launches == before
    monkeypatch.setattr(tiled, "BWD_SPLIT", "pallas")
    split = grads()
    torch.cuda.synchronize()
    assert len(groups) > 0
    assert packed_transpose.banks_to_rows.launches == before + 1
    for a, b in zip(split, xla):
        assert float(b.abs().max()) > 0.0
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if route == "stack":
        one = tiled.build_tiled_schedule(plan, field).to(cuda_device)
        leaf = field.with_params(field.sigma.detach().clone(),
                                 field.color.detach().clone())
        img = tiled.render_tiled(plan, leaf, one).image
        torch.autograd.grad(torch.sum(img ** 2), (leaf.sigma, leaf.color))
        torch.cuda.synchronize()
        assert packed_transpose.banks_to_rows.launches == before + 1


# ------------------------- one launch per schedule (K8f / K8b over groups)

GROUPED_SCENES = {
    # tests/test_torch_grid_grouped.py's scenes: (width, steps, spec,
    # camera position, tile_px); "wide" is enc 64 / hidden 8 at 16 px
    "16px": (64, 48, GRID_SPECS["test"], (0.3, 0.6, -0.6), 16),
    "8px": (48, 40, GRID_SUB_SPEC, (0.3, 0.6, -0.6), 8),
    "4px": (24, 24, GRID_SUB_SPEC, (0.5, 0.65, -1.0), 4),
    "wide": (32, 16, GRID_SPECS["wide"], (0.5, 0.5, -1.0), 16),
}


def grouped_scene(name, device):
    w, steps, spec, (x, y, z), px = GROUPED_SCENES[name]
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, x, 0, 1, 0, y, 0, 0, 1, z)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    field = P.HashMLPField.init_random(
        torch.Generator().manual_seed(0), spec=P.HashMLPSpec(**spec),
        table_std=0.5, device="cpu").to(device)
    sched = hash_tiled.build_hash_grid_schedule(plan, field, tile_px=px,
                                                device=device)
    return plan, field, sched


@pytest.mark.parametrize("name", sorted(GROUPED_SCENES))
def test_hash_grid_one_launch_matches_plain(cuda_device, name):
    """One K8f and one K8b launch over every group: K8f equal to its
    twins group by group bit for bit, K8b's slot rows and MLP gradients
    within 2e-5 x scale, repeats bit for bit."""
    plan, field, sched = grouped_scene(name, cuda_device)
    if name != "wide":
        assert len(sched.groups) > 1
    field.requires_grad_(False)
    tiles = sched.tiles
    table = hash_grid.build_hash_grid_table(dict(field.params), field.spec)
    tabs = tiled._gather_banks_flat(table, sched.gathermap_all)
    sc = hash_tiles.pack_mlp_scalars(dict(field.params), field.spec)
    prm = hash_grid.tiles_op_params(plan, field.spec, tiles)
    assert prm.subs == (16 // GROUPED_SCENES[name][4]) ** 2
    gs = torch.randn((tiles.n_tiles, 5, 16, 16),
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(7), device=cuda_device)
    before = (hash_grid.hash_grid_forward_tiles.launches,
              hash_grid.hash_grid_backward_tiles.launches)
    out = hash_grid.hash_grid_forward_tiles(tabs, tiles, sc, prm)
    rows, d_sc = hash_grid.hash_grid_backward_tiles(tabs, tiles, sc, gs, prm)
    torch.cuda.synchronize()
    assert (hash_grid.hash_grid_forward_tiles.launches,
            hash_grid.hash_grid_backward_tiles.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(out, hash_grid.hash_grid_forward_tiles_plain(
        tabs, tiles, sc, prm))
    p_rows, p_sc = hash_grid.hash_grid_backward_tiles_plain(tabs, tiles, sc,
                                                            gs, prm)
    for got, want in ((rows, p_rows), (d_sc, p_sc)):
        assert bool(torch.isfinite(got).all())
        _close(got, want, HASH_GRAD_TOL)
    again = hash_grid.hash_grid_backward_tiles(tabs, tiles, sc, gs, prm)
    assert torch.equal(again[0], rows) and torch.equal(again[1], d_sc)
    assert torch.equal(hash_grid.hash_grid_forward_tiles(tabs, tiles, sc,
                                                         prm), out)


@pytest.mark.parametrize("name", ["8px", "4px", "wide"])
def test_render_hash_grid_launches_once_per_schedule(cuda_device, name):
    """render_hash_grid_tiled launches K8f once and its backward K8b once,
    however many groups; the frame and gradients match the plain path on
    the card."""
    plan, field, sched = grouped_scene(name, cuda_device)

    def run(use_kernel):
        leaf = field.with_params({k: v.detach().clone().requires_grad_(True)
                                  for k, v in field.params.items()})
        out = hash_tiled.render_hash_grid_tiled(plan, leaf, sched,
                                                use_kernel=use_kernel)
        loss = torch.mean(out.image ** 2) + 0.25 * torch.mean(out.opacity)
        keys = sorted(leaf.params)
        return out, dict(zip(keys, torch.autograd.grad(
            loss, [leaf.params[k] for k in keys])))

    before = (hash_grid.hash_grid_forward_tiles.launches,
              hash_grid.hash_grid_backward_tiles.launches)
    got, g_got = run(True)
    torch.cuda.synchronize()
    assert (hash_grid.hash_grid_forward_tiles.launches,
            hash_grid.hash_grid_backward_tiles.launches) == (
        before[0] + 1, before[1] + 1)
    want, g_want = run(False)
    for key in ("image", "transmittance", "opacity"):
        assert float((getattr(got, key) - getattr(want, key))
                     .abs().max()) <= TOL
    assert float((got.depth - want.depth).abs().max()) <= TOL_DEPTH
    for k in g_want:
        _close(g_got[k], g_want[k], HASH_GRAD_TOL)


def test_hash_grid_occupancy_report(cuda_device):
    """The occupancy query answers for every form: at the grid spec K8b
    keeps two blocks per SM."""
    spec = P.HashMLPSpec(n_levels=4, features_per_level=2, table_size=4096,
                         resolutions=(4, 8, 16, 32))
    for subs in (1, 4, 16):
        occ = hash_grid.kernel_occupancy(spec, subs)
        for name in ("hash_grid", "hash_grid_bwd"):
            assert occ[name]["registers"] > 0
            assert occ[name]["blocks_per_sm"] >= 1
        assert occ["hash_grid_bwd"]["blocks_per_sm"] == 2
        assert occ["hash_grid_bwd"]["g"] >= 1
    wide = hash_grid.kernel_occupancy(P.HashMLPSpec(**GRID_SPECS["wide"]), 16)
    assert wide["hash_grid_bwd"]["blocks_per_sm"] >= 1


# ----------------------------------------- pitch 2, occupancy, all_tiles


def _shell_config(n=12):
    """A shell of sigma 20 (|r - 0.33| < 0.1) with exact zeros around and
    inside it, over tests/test_tiled.py's bbox."""
    lin = np.linspace(0, 1, n)
    zs, ys, xs = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt((xs - .5) ** 2 + (ys - .5) ** 2 + (zs - .5) ** 2)
    rng = np.random.default_rng(4)
    return P.DenseGridConfig(
        resolution=(n, n, n),
        sigma=np.where(np.abs(r - 0.33) < 0.1, 20.0, 0.0).reshape(-1),
        color=rng.uniform(0, 1, 3 * n ** 3),
        bbox_min=(0.3, 0.3, 0.2), bbox_max=(0.8, 0.9, 0.7))


def _option_field(kind, device, config=None):
    plan, cfg = scene("stratified")
    field = P.DenseGridField.create(config or cfg, device=device)
    if kind == "bfloat16":
        field = field.with_packed_dtype("bfloat16")
    elif kind == "sparse":
        field = P.SparseGridField.from_dense(field, threshold=0.0,
                                             device=device)
    return plan, field


def _table(field):
    if hasattr(field, "bricks"):
        return field.bricks.reshape(-1, 32)
    sigma, color = field.sigma.detach(), field.color.detach()
    if field.packed_dtype == "float32":
        return packed_transpose.build_rows(sigma, color)
    return packed_transpose.build_rows16(sigma, color, torch.bfloat16)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "sparse"])
@pytest.mark.parametrize("options", ["pitch2_16px", "pitch2_8px",
                                     "occupancy_8px", "all_tiles"])
def test_new_schedules_k1_k2_equal_twins(cuda_device, kind, options):
    """K1 and K2 (rows and d(rayt)) in one launch over every group of a
    pitch-2, an occupancy-trimmed or an all_tiles schedule, bit for bit
    against their twins."""
    kw = {"pitch2_16px": dict(pitch=2), "pitch2_8px": dict(pitch=2,
                                                           tile_px=8),
          "occupancy_8px": dict(occupancy=True, tile_px=8),
          "all_tiles": dict(quantize="uniform", all_tiles=True)}[options]
    config = _shell_config() if options == "occupancy_8px" else None
    plan, field = _option_field(kind, cuda_device, config)
    sched = tiled.build_tiled_schedule(plan, field, **kw)
    assert sched.fallback_rays == 0 and sched.tiled_samples > 0
    whole = set_args(plan, sched.to(cuda_device), _table(field))[0]
    tabs, tiles, prm = whole
    gs = torch.randn((tiles.n_tiles, 5, 16, 16), device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(11))
    out = fused_tiles.tile_forward(tabs, tiles, prm)
    rows, d_rayt = fused_tiles.tile_backward(tabs, tiles, gs, prm, cam=True)
    torch.cuda.synchronize()
    assert torch.equal(out, fused_tiles.tile_forward_set_plain(tabs, tiles,
                                                               prm))
    p_rows, p_rayt = fused_tiles.tile_backward_set_plain(tabs, tiles, gs,
                                                         prm, cam=True)
    assert torch.equal(rows, p_rows) and torch.equal(d_rayt, p_rayt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_gather_on_the_card(cuda_device, dtype):
    plan, field = _option_field("float32", cuda_device)
    sched = tiled.build_tiled_schedule(plan, field, pitch=2).to(cuda_device)
    table = packed_transpose.build_rows(field.sigma.detach(),
                                        field.color.detach()).to(dtype)
    pair = tiled._gather_banks_flat(table, sched.gathermap_all, 2)
    single = tiled._gather_banks_flat(table, sched.hostmap_all, 1)
    used = (sched.hostmap_all >= 0).reshape(-1, 128)[:, None, :].expand_as(
        pair)
    assert torch.equal(pair[used], single[used])
    assert torch.equal(pair.cpu(), tiled._gather_banks_flat(
        table.cpu(), sched.gathermap_all.cpu(), 2))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "sparse"])
def test_renderer_pitch2_bit_equal_on_the_card(cuda_device, kind):
    plan, field = _option_field(kind, cuda_device)
    ctx = P.Context.create(device="cuda")
    r1 = P.Renderer(ctx, plan)
    r2 = P.Renderer(ctx, plan, P.RenderOptions(tile_pitch=2))
    a, b = r1.forward(field), r2.forward(field)
    assert r2._tiled_schedule.pitch == 2
    for key in ("image", "transmittance", "opacity", "depth"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    dl = np.random.default_rng(5).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    g1, g2 = r1.backward(field, dl), r2.backward(field, dl)
    keys = (("bricks",) if kind == "sparse" else ("sigma", "color")) + (
        "camera", "camera_k")
    for key in keys:
        np.testing.assert_array_equal(getattr(g1, key), getattr(g2, key))


def test_renderer_occupancy_on_the_card_matches_cpu(cuda_device):
    plan, config = scene("stratified")
    config = _shell_config()
    out = {}
    for dev in ("cpu", "cuda"):
        field = P.DenseGridField.create(config, device=dev)
        r = P.Renderer(P.Context.create(device=dev), plan,
                       P.RenderOptions(use_tiles=True, use_occupancy=True))
        res = r.forward(field)
        dl = np.random.default_rng(6).uniform(
            -1, 1, plan.ray_count * 3).astype(np.float32)
        out[dev] = (res, r.backward(field, dl))
    (a, ga), (b, gb) = out["cpu"], out["cuda"]
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(b, key), getattr(a, key),
                                   atol=TOL, rtol=0)
    for key in ("sigma", "color"):
        ref = getattr(ga, key)
        np.testing.assert_allclose(getattr(gb, key), ref, rtol=0,
                                   atol=GRID_TOL * float(np.abs(ref).max()))
    np.testing.assert_allclose(gb.camera, ga.camera, rtol=2e-3, atol=1e-4)


def test_moving_camera_on_the_card(cuda_device):
    from dvren_tpu_torch.render import animate

    plan, config = scene("stratified")
    field = P.DenseGridField.create(config, device=cuda_device)
    mover = animate.MovingCameraRenderer(plan, field)
    for dx in (0.0, 0.03, 0.6):
        p = fit.view_plans(plan, [P.CameraConfig(
            k=plan.camera.k, c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.55, 0, 0, 1,
                                  -1.1))])[0]
        with torch.no_grad():
            got = mover.render(p, field)
            ref = tiled.render_tiled(p, field, tiled.build_tiled_schedule(
                p, field).to(cuda_device))
        for key in ("image", "transmittance", "opacity", "depth"):
            assert torch.equal(getattr(got, key), getattr(ref, key))
    assert mover.cache_size() == 1


# ------------------------------------------------ the general paths (K9)

GENERAL_MODES = {"fused": dict(use_tiles=False, streaming=False),
                 "staged": dict(use_tiles=False, streaming=False,
                                use_fused_path=False),
                 "streamed": dict(use_tiles=False, streaming=True)}


@pytest.mark.parametrize("mode", sorted(GENERAL_MODES))
def test_general_modes_on_the_card_match_cpu(cuda_device, mode):
    """The fused, staged and streamed modes on the card (K9f in the
    forward, K9b in the backward) against the CPU's twins: planes 5e-6
    (depth 1e-4), gradients 2e-6 x scale, camera rtol 2e-3 / atol 1e-4;
    two backwards on the card bit for bit."""
    plan, config = scene("stratified")
    dl = np.random.default_rng(8).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        field = P.DenseGridField.create(config, device=dev)
        r = P.Renderer(P.Context.create(device=dev), plan,
                       P.RenderOptions(**GENERAL_MODES[mode]))
        f0 = integrate_fused.integrate_forward.launches
        res = r.forward(field)
        b0 = integrate_fused.radiance_vjp.launches
        grads = r.backward(field, dl)
        launches = (integrate_fused.integrate_forward.launches - f0,
                    integrate_fused.radiance_vjp.launches - b0)
        again = r.backward(field, dl) if dev == "cuda" else None
        out[dev] = (res, grads, again, launches)
    (a, ga, _, cpu_launches), (b, gb, gb2, launches) = out["cpu"], out["cuda"]
    assert cpu_launches == (0, 0)
    assert launches[0] >= 1 and launches[1] >= 1
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(b, key), getattr(a, key),
                                   atol=TOL, rtol=0)
    np.testing.assert_allclose(b.depth, a.depth, atol=TOL_DEPTH, rtol=0)
    np.testing.assert_array_equal(b.hitmask, a.hitmask)
    for key in ("sigma", "color"):
        ref = getattr(ga, key)
        np.testing.assert_allclose(getattr(gb, key), ref, rtol=0,
                                   atol=GRID_TOL * float(np.abs(ref).max()))
        np.testing.assert_array_equal(getattr(gb2, key), getattr(gb, key))
    np.testing.assert_allclose(gb.camera, ga.camera, rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(gb2.camera, gb.camera)


def test_per_sample_grads_is_one_k9b_launch(cuda_device):
    from dvren_tpu_torch.ops import diff

    sigma, planes, dt, mask, _, g = integrate_scene(cuda_device, 300, 96,
                                                    hi=4.0, zeros=True)
    before = integrate_fused.radiance_vjp.launches
    ds, dc = diff.per_sample_grads(g, sigma, planes, dt, mask)
    assert integrate_fused.radiance_vjp.launches == before + 1
    # K9b's bounds against its twin on the same device
    # (test_integrate_backward_matches_plain)
    ref_s, ref_c = integrate_fused.radiance_vjp_plain(sigma, planes, dt,
                                                      mask, g)
    np.testing.assert_allclose(ds.cpu().numpy(), ref_s.cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dc.cpu().numpy(),
                               torch.stack(ref_c, dim=-1).cpu().numpy(),
                               rtol=1e-4, atol=1e-7)


def test_shared_compose_is_bit_identical_on_the_card(cuda_device):
    """The compose of rays that share pixels: the same frame bit for bit
    from call to call on the card (no float atomics), and the CPU's."""
    from dvren_tpu_torch.ops.compose import compose

    rng = np.random.default_rng(12)
    n, w, h = 400_000, 300, 200
    host = [rng.integers(0, w * h + 50, n).astype(np.int32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(0.05, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0.2, 3, n).astype(np.float32)]
    card = [torch.from_numpy(x).to(cuda_device) for x in host]
    a = compose(*card, w, h, 3.5, unique_pixels=False)
    b = compose(*card, w, h, 3.5, unique_pixels=False)
    c = compose(*map(torch.from_numpy, host), w, h, 3.5, unique_pixels=False)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
        np.testing.assert_allclose(getattr(a, key).cpu().numpy(),
                                   getattr(c, key).numpy(), atol=TOL,
                                   rtol=0, err_msg=key)
    assert torch.equal(a.hitmask.cpu(), c.hitmask)


# ------------------------------ posed schedules, graph capture and the CLI


def _lookat(eye, ctr=(0.5, 0.5, 0.5), up=(0, 1, 0)):
    eye, ctr, up = (np.array(v, float) for v in (eye, ctr, up))
    f = ctr - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    return tuple(np.concatenate([np.stack([r, u, f], 1), eye[:, None]],
                                1).reshape(-1))


def posed_scene(c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)):
    """tests/test_posed.py's scene: a 16^3 blob under 128^2 rays, 32
    stratified steps."""
    g, w, steps = 16, 128, 32
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, g)] * 3), indexing="ij")
    sigma = 10.0 * np.exp(-((xs - 0.5) ** 2 + (ys - 0.5) ** 2
                            + (zs - 0.45) ** 2) / 0.06)
    config = P.DenseGridConfig(
        resolution=(g,) * 3, sigma=sigma.astype(np.float32).reshape(-1),
        color=np.stack([xs, ys, 1 - zs], -1).astype(np.float32).reshape(-1))
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0,
                                 1), c2w=c2w),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    return plan, config


POSED_ORBIT = [_lookat((1.6, 0.8, 0.3)), _lookat((-0.6, 0.2, 1.3)),
               _lookat((0.5, 1.7, 0.45))]


def test_posed_split_graph_and_twin_on_the_card(cuda_device):
    """The split mode on the card against its twin (5e-6, depth 1e-4) and
    the host-built frame (1e-5); graph mode and the sweep bit-equal to
    the split mode; one graph for the orbit; repeats bit for bit."""
    from dvren_tpu_torch.render import posed

    base, config = posed_scene()
    field = P.DenseGridField.create(config, device=cuda_device)
    plans = [posed_scene(c)[0] for c in POSED_ORBIT]
    split = posed.PosedRenderer(base, field, fused=False, probe_plans=plans)
    pins = dict(nc_pin=split.nc_pin, nb_pin=split.nb_pin,
                ez_pin=split.ez_pin)
    graphed = posed.PosedRenderer(base, field, **pins)
    twin = posed.PosedRenderer(base, field, use_kernel=False, fused=False,
                               **pins)
    frames = []
    for p in [base] + plans:
        k1 = fused_tiles.tile_forward.launches
        a = split.render(p, field)
        assert fused_tiles.tile_forward.launches == k1 + 1
        b = twin.render(p, field)
        for key in ("image", "transmittance", "opacity"):
            torch.testing.assert_close(getattr(a, key), getattr(b, key),
                                       atol=TOL, rtol=0)
        torch.testing.assert_close(a.depth, b.depth, atol=TOL_DEPTH, rtol=0)
        with torch.no_grad():
            host = tiled.render_tiled(p, field, tiled.build_tiled_schedule(
                p, field).to(cuda_device))
        assert float((a.image - host.image).abs().max()) < 1e-5
        g = graphed.render(p, field)
        for key in ("image", "transmittance", "opacity", "depth"):
            assert torch.equal(getattr(g, key), getattr(a, key)), key
        assert torch.equal(split.render(p, field).image, a.image)
        frames.append(a.image)
    assert graphed.cache_size() == 1
    images, diags = graphed.render_sweep([base] + plans, field)
    assert images.shape == (4, 128, 128, 3) and diags.shape == (4, 4)
    for got, want in zip(images, frames):
        assert torch.equal(got, want)


POSED_ARRAYS = ("samp", "base", "rayt", "bank0", "k_enter", "hostmap")


def _posed_pair(base, field, **kw):
    """(kernel renderer, twin renderer) over one field with one set of
    pins, both in the split mode; ``kw`` pins or probe plans."""
    from dvren_tpu_torch.render import posed

    kern = posed.PosedRenderer(base, field, fused=False, **kw)
    pins = dict(nc_pin=kern.nc_pin, nb_pin=kern.nb_pin, ez_pin=kern.ez_pin)
    twin = posed.PosedRenderer(base, field, fused=False, use_kernel=False,
                               **pins)
    assert kern.kernel_build and not twin.kernel_build
    return kern, twin


def _posed_builds_equal(kern, twin, plan):
    """The kernel's and the twin's schedule at ``plan``'s camera: every
    array and the diagnostics bit for bit, and one launch; returns the
    kernel's (schedule, diagnostics)."""
    from dvren_tpu_torch.ops import posed_build

    cam = kern._cam_arrays(plan)
    n = posed_build.posed_build.launches
    with torch.no_grad():
        got, got_diag = kern._build_schedule(*cam)
        want, want_diag = twin._build_schedule(*cam)
    assert posed_build.posed_build.launches == n + 1
    for name in POSED_ARRAYS:
        a = getattr(got.groups[0], name)
        b = getattr(want.groups[0], name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    assert torch.equal(got_diag, want_diag), (got_diag, want_diag)
    return got, got_diag


def _long_run_scene(device):
    """tests/test_torch_posed.py's long runs: rays along +z through a 2 x
    2 x 64 grid, a chunk crossing about 60 z-slices; (plan, field)."""
    nz = 64
    zs = np.linspace(0, 1, nz)[:, None, None] * np.ones((nz, 2, 2))
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(2, 2, nz),
        sigma=(1.0 + zs).astype(np.float32).reshape(-1),
        color=np.ones((nz, 2, 2, 3), np.float32).reshape(-1)), device=device)
    plan = P.Plan.create(P.PlanConfig(
        width=128, height=16, t_near=0.9, t_far=2.1, seed=3,
        camera=P.CameraConfig(k=(2000.0, 0, 64, 0, 2000.0, 8, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.0)),
        sampling=P.SamplingConfig(dt=0.125, max_steps=16,
                                  mode=P.SamplingMode.STRATIFIED)))
    return plan, field


@pytest.mark.parametrize("pose", ["base", "orbit0", "orbit1", "orbit2",
                                  "fixed", "ortho", "long_run"])
def test_posed_kernel_build_equals_twin(cuda_device, pose):
    """tests/test_posed.py's scene at 128^2: the build kernel's schedule
    and diagnostics equal the torch twin's bit for bit at the base pose,
    the three orbit poses, in the fixed sampling mode and through an
    orthographic camera; and on runs of about 60 z-slices (ez_pin 64:
    the slices' scan takes two warp passes)."""
    base, config = posed_scene()
    kw = {}
    if pose == "long_run":
        base, field = _long_run_scene(cuda_device)
        plan = base
        kw = dict(nc_pin=2, nb_pin=4, ez_pin=64)
    else:
        field = P.DenseGridField.create(config, device=cuda_device)
    if pose == "fixed":
        fixed = dataclasses.replace(base.sampling, mode=P.SamplingMode.FIXED)
        base = dataclasses.replace(base, sampling=fixed)
        plan = dataclasses.replace(base, camera=posed_scene(
            POSED_ORBIT[2])[0].camera)
    elif pose == "ortho":
        cam = dataclasses.replace(base.camera, ortho_scale=1.0,
                                  model=P.CameraModel.ORTHOGRAPHIC)
        base = plan = dataclasses.replace(base, camera=cam)
    elif pose.startswith("orbit") or pose == "base":
        plan = base if pose == "base" else posed_scene(
            POSED_ORBIT[int(pose[-1])])[0]
    kern, twin = _posed_pair(base, field, **(kw or dict(probe_plans=[plan])))
    _, diag = _posed_builds_equal(kern, twin, plan)
    if pose == "long_run":
        assert int(diag[2]) > 32


def _orbit_c2w(i, n=120, amp_x=0.1, amp_y=0.05, tz=-1.0):
    """Pose ``i`` of the benchmark's translation orbit
    (bench_port/reference/dense_grid.py::orbit_c2w)."""
    ang = 2.0 * np.pi * i / n
    return (1.0, 0.0, 0.0, 0.5 + amp_x * np.sin(ang), 0.0, 1.0, 0.0,
            0.5 + amp_y * np.cos(ang), 0.0, 0.0, 1.0, tz)


def blob64_orbit(device, poses=range(120)):
    """The benchmark's blob64 orbit: a 64^3 blob under 512^2 rays, 128
    stratified steps, jitter seed 3; (field, plans of ``poses``)."""
    n, w, steps = 64, 512, 128
    ax = torch.linspace(0.0, 1.0, n, dtype=torch.float64)
    zs, ys, xs = torch.meshgrid(ax, ax, ax, indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * torch.exp(-r2 / 0.05)).to(torch.float32)
    color = torch.stack([xs, ys, 1.0 - zs], dim=-1).to(torch.float32)
    field = P.DenseGridField(sigma.to(device), color.to(device),
                             bbox_min=(0.0, 0.0, 0.0),
                             bbox_max=(1.0, 1.0, 1.0))
    plans = [P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(k=(1.2 * w, 0.0, w / 2, 0.0, 1.2 * w, w / 2,
                                 0.0, 0.0, 1.0), c2w=_orbit_c2w(i)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=P.SamplingMode.STRATIFIED)))
        for i in poses]
    return field, plans


def test_posed_kernel_build_equals_twin_over_the_blob64_orbit(cuda_device):
    """The benchmark's 512^2 orbit, pins probed over all 120 poses: at
    every pose the kernel's schedule and diagnostics equal the twin's bit
    for bit, and a repeat build the same bits."""
    field, plans = blob64_orbit(cuda_device)
    kern, twin = _posed_pair(plans[0], field, probe_plans=plans)
    for plan in plans:
        got, diag = _posed_builds_equal(kern, twin, plan)
        kern._check_diag(diag)
    with torch.no_grad():
        again, again_diag = kern._build_schedule(*kern._cam_arrays(plans[0]))
        first, first_diag = kern._build_schedule(*kern._cam_arrays(plans[0]))
    assert torch.equal(again_diag, first_diag)
    for name in POSED_ARRAYS:
        a, b = getattr(again.groups[0], name), getattr(first.groups[0], name)
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.float32 else b), name


@pytest.mark.parametrize("pin", ["nc_pin", "nb_pin", "ez_pin"])
def test_posed_kernel_build_refuses_past_each_pin(cuda_device, pin):
    """A pose past one pin: the kernel's diagnostics equal the twin's and
    the render refuses it with the twin's message."""
    base, config = posed_scene()
    field = P.DenseGridField.create(config, device=cuda_device)
    plan = posed_scene(POSED_ORBIT[0])[0]
    probe, _ = _posed_pair(base, field, probe_plans=[plan])
    pins = dict(nc_pin=probe.nc_pin, nb_pin=probe.nb_pin,
                ez_pin=probe.ez_pin)
    pins[pin] = {"nc_pin": 1, "nb_pin": 1, "ez_pin": 1}[pin]
    kern, twin = _posed_pair(base, field, **pins)
    _, diag = _posed_builds_equal(kern, twin, plan)
    errors = []
    for r in (kern, twin):
        with pytest.raises(P.DvrenError, match=pin) as info:
            r.render(plan, field)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_posed_graph_mode_kernel_planes_equal_split_twin(cuda_device):
    """Graph mode (the kernel build recorded with K3, the gather, K1 and
    the compose) renders the planes of the twin's schedule rendered by
    the same kernels, bit for bit; the recording holds one build launch,
    and ``posed.kernel_frames`` counts the replays."""
    from dvren_tpu_torch.render import posed
    from dvren_tpu_torch.utils import trace

    base, config = posed_scene()
    field = P.DenseGridField.create(config, device=cuda_device)
    plans = [base] + [posed_scene(c)[0] for c in POSED_ORBIT]
    graphed = posed.PosedRenderer(base, field, probe_plans=plans)
    twin = posed.PosedRenderer(base, field, fused=False, use_kernel=False,
                               nc_pin=graphed.nc_pin, nb_pin=graphed.nb_pin,
                               ez_pin=graphed.ez_pin)
    trace.reset()
    trace.enable(True)
    try:
        for p in plans:
            got = graphed.render(p, field)
            with torch.no_grad():
                want = tiled.render_tiled(p, field, twin.schedule_for(p))
            for key in ("image", "transmittance", "opacity", "depth"):
                assert torch.equal(getattr(got, key), getattr(want, key)), key
        graphed.render_sweep(plans, field)
        counters = trace.snapshot()["counters"]
    finally:
        trace.enable(False)
        trace.reset()
    assert graphed.cache_size() == 1
    assert graphed.captured.launches.get("posed_build") == 1
    assert counters.get("posed.kernel_frames") == 2 * len(plans)


def _graph_renderer(options, device, graph):
    return P.Renderer(P.Context.create(device=device), posed_scene()[0],
                      P.RenderOptions(enable_graph=graph, **options))


@pytest.mark.parametrize("mode", ["tiled", "windowed", "streamed", "fused"])
def test_enable_graph_bit_equal_to_eager(cuda_device, mode):
    """Each mode's replayed frame, and the tiled, windowed and streamed
    backward, bit-equal to eager on the card; the notes say what ran."""
    options = {"tiled": dict(use_tiles=True), "windowed": dict(
        use_window=True), "streamed": dict(use_tiles=False, streaming=True),
               "fused": dict(use_tiles=False, streaming=False)}[mode]
    _, config = posed_scene()
    field = P.DenseGridField.create(config, device=cuda_device)
    dl = np.random.default_rng(2).uniform(
        -1, 1, 128 * 128 * 3).astype(np.float32)
    torch.use_deterministic_algorithms(True)
    try:
        out = {}
        for graph in (False, True):
            r = _graph_renderer(options, cuda_device, graph)
            first = r.forward(field)
            again = r.forward(field)
            grads = None if mode == "fused" else r.backward(field, dl)
            out[graph] = (first, again, grads, r)
    finally:
        torch.use_deterministic_algorithms(False)
    (e, _, ge, _), (g, g2, gg, r) = out[False], out[True]
    assert r._last_mode == mode
    assert "graph_executed" in g.stats.notes
    assert any(n.startswith("graph_captured_aot_compile_ms=")
               for n in g.stats.notes)
    assert not any(n.startswith("graph_captured") for n in g2.stats.notes)
    assert "kernel_launches=captured_in_graph" in g2.stats.notes
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(g, key), getattr(e, key))
        np.testing.assert_array_equal(getattr(g2, key), getattr(e, key))
    if ge is not None:
        for key in ("sigma", "color", "camera", "camera_k"):
            np.testing.assert_array_equal(getattr(gg, key), getattr(ge, key))


def test_capture_survives_a_dead_graph_cycle(cuda_device):
    """A captured graph whose owner died in a reference cycle is freed by
    the cycle collector; ``capture`` collects before it records, so a
    collection during the recording finds no graph to destroy."""
    from dvren_tpu_torch.render import graph as graph_mod

    x = torch.arange(8, dtype=torch.float32, device=cuda_device)
    calls = []

    def dead_cycle():
        owner = {}
        owner["graph"] = graph_mod.capture(lambda: x * 2.0, cuda_device)
        owner["self"] = owner

    def fn():
        calls.append(1)
        if len(calls) == 1:
            dead_cycle()       # during the eager warm-up
        else:
            gc.collect()       # while the graph records
        return x + 1.0

    captured = graph_mod.capture(fn, cuda_device)
    x.add_(10.0)
    captured.replay()
    assert torch.equal(captured.outputs, x + 1.0)
    assert gc.isenabled()


def test_enable_graph_recaptures_on_a_new_field(cuda_device):
    """A new field object records a new graph; an in-place edit of the
    same tensors replays the graph and renders the edited values."""
    _, config = posed_scene()
    field = P.DenseGridField.create(config, device=cuda_device)
    r = _graph_renderer(dict(use_tiles=True), cuda_device, True)
    eager = _graph_renderer(dict(use_tiles=True), cuda_device, False)
    r.forward(field)
    other = P.DenseGridField.create(config, device=cuda_device)
    res = r.forward(other)
    assert any(n.startswith("graph_captured_aot") for n in res.stats.notes)
    with torch.no_grad():
        other.sigma.mul_(2.0)
    res = r.forward(other)
    assert not any(n.startswith("graph_captured") for n in res.stats.notes)
    np.testing.assert_array_equal(res.image, eager.forward(other).image)


@pytest.mark.parametrize("config", ["simple_volume", "smoke_volume"])
def test_cli_on_the_card(cuda_device, config, tmp_path, monkeypatch):
    """The CLI renders on the card by default; its image within 5e-6 of
    the CPU run's before the bytes, its PPM byte-equal."""
    import pathlib

    from dvren_tpu_torch import cli

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / (
        config + ".json")
    images = {}
    real = cli.write_ppm

    def keep(p, image):
        images[str(p)] = np.asarray(image)
        real(p, image)

    monkeypatch.setattr(cli, "write_ppm", keep)
    card, host = tmp_path / "card.ppm", tmp_path / "cpu.ppm"
    assert cli.main([str(path), str(card)]) == 0
    assert cli.main([str(path), str(host)], device="cpu") == 0
    np.testing.assert_allclose(images[str(card)], images[str(host)],
                               atol=5e-6, rtol=0)
    assert card.read_bytes() == host.read_bytes()


def test_tile_dp_step_on_the_card_matches_render_tiled(cuda_device):
    """dvren_tpu_torch.parallel at D = 1 over NCCL on the card: the
    tile-sharded frame bit-equal to render_tiled, one tile-DP step's
    summed gradients within 2e-6 x scale of autograd through render_tiled
    (K3, K1, K2, K4 on the rank's schedule), a repeat step bit for bit."""
    import torch_parallel_ranks as ranks     # tests/, on pytest's path

    from dvren_tpu_torch.parallel import launch

    _build.library()          # built before the rank starts; it loads it
    out = launch(ranks.tile_dp_case, 1)
    assert out["device"] == "cuda:0" and out["backend"] == "nccl"
    assert out["frame_bit_equal"]
    for got, again, ref in zip(out["grads"], out["repeat_grads"],
                               out["ref_grads"]):
        np.testing.assert_array_equal(got, again)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=GRID_TOL * np.abs(ref).max())


def test_tile_dp_step_recorded_on_the_card_equals_eager(cuda_device):
    """dvren_tpu_torch.parallel at D = 1 over NCCL on the card: the
    tile-DP step recorded once as a CUDA graph (its all-reduce inside)
    and replayed equals its eager capturable body bit for bit over 5
    steps (losses, parameters, Adam's state); the recording holds K3, K1,
    K2 and K4 once each, and the counters move by the warm-up and the
    recording only."""
    import torch_parallel_ranks as ranks     # tests/, on pytest's path

    from dvren_tpu_torch.parallel import launch

    _build.library()          # built before the rank starts; it loads it
    out = launch(ranks.tile_dp_graph_case, 1)
    assert out["device"] == "cuda:0" and out["backend"] == "nccl"
    rec = out["recorded"]
    assert rec == {"fused_tiles": 1, "fused_tiles_bwd": 1,
                   "packed_table": 1, "packed_table_bwd": 1}
    assert out["moved"] == {k: 2 * v for k, v in rec.items()}
    assert out["state_equal"]
    assert out["losses"][-1] < out["losses"][0]


def test_graph_records_the_jitter_kernel(cuda_device):
    """A recording of a stratified ``pipeline.render`` with no jitter
    table lists the jitter kernel among its launches (beside the packed
    evaluation and K9f), and its replay is the eager frame bit for
    bit."""
    from dvren_tpu_torch.ops.raygen import camera_arrays
    from dvren_tpu_torch.render import pipeline

    plan, config = scene("stratified")
    field = P.DenseGridField.create(config, device=cuda_device)
    k, c2w, ortho = camera_arrays(plan, cuda_device)

    def frame():
        with torch.no_grad():
            return pipeline.render(plan, field, k=k, c2w=c2w,
                                   ortho_scale=ortho).planes.image

    g = graph_mod.capture(frame, cuda_device)
    assert g.launches == {"stratified_jitter": 1, "packed_eval": 1,
                          "integrate": 1}
    assert torch.equal(g.replay(), frame())


JITTER_SEEDS = (0, 17, 2 ** 63 + 5)


@pytest.mark.parametrize("seed", JITTER_SEEDS)
def test_jitter_kernel_bit_equal_to_twin(cuda_device, seed):
    from dvren_tpu_torch.ops import rng

    rays = torch.arange(5, 1005, device=cuda_device)[:, None]
    steps = torch.arange(70, dtype=torch.int32, device=cuda_device)
    cases = [
        (rays, steps[None, :], None),
        (rays, (steps[None, :] + torch.arange(1000, dtype=torch.int32,
                                              device=cuda_device)[:, None]
                - 40), (900, 64)),
        (rays.reshape(-1), torch.tensor(3, device=cuda_device), None),
        (rays[::3], steps[None, ::2], (600, 70)),
        (rays[:, :, None], steps.reshape(1, 7, 10), None),
    ]
    for ray, step, bounds in cases:
        before = rng.stratified_jitter.launches
        got = rng.stratified_jitter(seed, ray, step, bounds=bounds)
        torch.cuda.synchronize()
        assert rng.stratified_jitter.launches == before + 1
        want = rng.stratified_jitter_plain(seed, ray.cpu(), step.cpu(),
                                           bounds)
        assert got.shape == want.shape
        assert torch.equal(got.cpu(), want)
    table = rng.jitter_table(seed, 1000, 70, ray_offset=5)
    got = rng.stratified_jitter(seed, rays, steps[None, :])
    assert np.array_equal(got.cpu().numpy(), table)


def test_generate_samples_hashes_jitter_on_the_card(cuda_device):
    from dvren_tpu_torch.ops import rng
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.ops.sampling import generate_samples
    from dvren_tpu_torch.render.pipeline import plan_jitter_table

    plan, _ = scene("stratified")
    rays = generate_rays(plan, device=cuda_device)
    table = torch.from_numpy(np.array(plan_jitter_table(plan))).to(
        cuda_device)
    want = generate_samples(plan, rays, jitter=table)
    torch.cuda.synchronize()
    before = rng.stratified_jitter.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = generate_samples(plan, rays)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rng.stratified_jitter.launches == before + 1
    for key in ("t", "dt", "mask", "px", "py", "pz"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key


@pytest.mark.parametrize("form", [dict(), dict(tile_px=8), dict(pitch=2)])
def test_bank_aligned_k1_k2_bit_equal_to_dense(cuda_device, form):
    from dvren_tpu_torch.ops.raygen import camera_arrays

    plan, config = scene("stratified")
    field = P.DenseGridField.create(config, device=cuda_device)
    out = []
    for aligned in (True, False):
        sched = tiled.build_tiled_schedule(plan, field, bank_aligned=aligned,
                                           **form).to(cuda_device)
        f = field.with_params(field.sigma.detach().clone().requires_grad_(),
                              field.color.detach().clone().requires_grad_())
        k, c2w, _ = camera_arrays(plan, cuda_device)
        k.requires_grad_(True)
        c2w.requires_grad_(True)
        before = (fused_tiles.tile_forward.launches,
                  fused_tiles.tile_backward.launches)
        planes = tiled.render_tiled(plan, f, sched, k=k, c2w=c2w)
        img = planes.image
        grads = torch.autograd.grad(torch.sum(img * 0.001 + img ** 2 * 0.01),
                                    (f.sigma, f.color, c2w, k))
        torch.cuda.synchronize()
        assert fused_tiles.tile_forward.launches > before[0]
        assert fused_tiles.tile_backward.launches > before[1]
        out.append((planes.image.detach(), planes.transmittance.detach(),
                    planes.opacity.detach(), planes.depth.detach()) + grads)
    for x, y in zip(*out):
        assert torch.equal(x, y)


def test_time_calls_times_card_closures(cuda_device):
    """``utils/timing.time_calls`` on a closure over card tensors (as
    chip_smoke's ``event_times`` calls it): one time per call, in seconds
    between CUDA events, ordered median between least and largest."""
    from dvren_tpu_torch.utils import timing

    x = torch.randn(1 << 20, device=cuda_device)
    calls = []

    def fn():
        calls.append(1)
        return torch.cumsum(x, 0)

    stats = timing.time_calls(fn, [()], 4, warmup=1, cuda=True)
    assert len(calls) == 5 and len(stats["per_call_s"]) == 4
    assert 0.0 < stats["min_s"] <= stats["median_s"] <= stats["max_s"] < 1.0


# ------------------------------------- the packed-stencil evaluation kernels

PE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
PE_TOL = 1e-6          # x max |twin|: the 8-term sums in another order
PE_POS_TOL = 2e-6      # x max |twin|: the position adjoint, autograd's order
PE_REFERENCE = pathlib.Path(__file__).with_name(
    "packed_eval_jax_reference.npz")


def pe_case(device, dtype=torch.float32, shape=(9, 7, 11), n=20_000,
            bbox=((-0.5, 0.2, 0.1), (1.5, 0.9, 2.0)), seed=0, one_cell=False):
    """A packed stencil of a random (Z, Y, X) grid in ``dtype`` and
    sample positions: random ones over the bbox and 15 % past it on each
    side, then every combination of the bbox's lower and upper faces and
    its middle (the upper faces exactly: base n-2, t = 1); ``one_cell``
    puts every sample inside cell (1, 1, 1)."""
    from dvren_tpu_torch.ops import grid as grid_ops

    rng = np.random.default_rng(seed)
    sigma = torch.from_numpy(rng.uniform(0, 12, shape).astype(np.float32))
    color = torch.from_numpy(rng.uniform(0, 1, shape + (3,))
                             .astype(np.float32))
    packed = grid_ops.build_packed_stencil(sigma, color, dtype).to(device)
    lo, hi = (np.asarray(v, np.float64) for v in bbox)
    if one_cell:
        cells = np.asarray(shape[::-1], np.float64) - 1.0
        u = (1.0 + rng.uniform(0.05, 0.95, (n, 3))) / cells
    else:
        u = rng.uniform(-0.15, 1.15, (n, 3))
        faces = np.stack(np.meshgrid(*[[0.0, 0.5, 1.0]] * 3,
                                     indexing="ij"), -1).reshape(-1, 3)
        u = np.concatenate([u, faces])
    pos = (lo + u * (hi - lo)).astype(np.float32)
    px, py, pz = (torch.from_numpy(pos[:, a].copy()).to(device)
                  for a in range(3))
    return packed, (px, py, pz), bbox


def pe_twin(packed, shape, pts, bbox, oob, grads=None, positions=False):
    """The twin (use_kernel=False) on the same tensors: planes, and for
    ``grads`` the table's cotangent, or with ``positions`` the table's and
    the positions' (zeros where autograd gives none)."""
    from dvren_tpu_torch.ops import grid as grid_ops

    leaf = packed.detach().requires_grad_(grads is not None)
    pts = tuple(p.detach().requires_grad_(positions) for p in pts)
    with torch.set_grad_enabled(grads is not None):
        planes = grid_ops.eval_packed_trilinear(
            leaf, shape, *pts, *bbox, oob, use_kernel=False)
        if grads is None:
            return planes, None
        wrt = (leaf,) + (pts if positions else ())
        got = torch.autograd.grad(planes, wrt, grads, allow_unused=True)
    got = tuple(torch.zeros_like(x) if d is None else d
                for d, x in zip(got, wrt))
    return planes, got if positions else got[0]


def pe_weights(shape, pts, geom, dtype):
    """The forward kernel's (S, 8) corner weights, read through two
    one-hot tables: plane ch of table h is the weight of corner 4h + ch
    plus exact zeros (a weight of -0.0 reads +0.0)."""
    from dvren_tpu_torch.ops import packed_eval

    nz, ny, nx = shape
    rows = (nz - 1) * (ny - 1) * (nx - 1)
    out = []
    for h in (0, 1):
        table = torch.zeros((rows, 32), dtype=dtype, device=pts[0].device)
        for ch in range(4):
            table[:, 4 * (4 * h + ch) + ch] = 1.0
        out += packed_eval.packed_eval_forward(table, *pts, geom)
    return torch.stack(out, dim=1)


def pe_bits(x):
    """float32 bits, -0.0 as +0.0."""
    return (x + 0.0).view(torch.int32)


@pytest.mark.parametrize("oob", [P.OobPolicy.ZERO, P.OobPolicy.CLAMP])
@pytest.mark.parametrize("dtype", PE_DTYPES)
def test_packed_eval_forward_matches_twin(cuda_device, dtype, oob):
    """The forward kernel's corner weights equal the twin's
    (``trilinear_fractions``) bit for bit, and its planes are within 1e-6
    x scale of the twin's, samples outside the bbox and on its upper faces
    included; one launch."""
    from dvren_tpu_torch.ops import grid as grid_ops
    from dvren_tpu_torch.ops import packed_eval

    shape = (9, 7, 11)
    packed, pts, bbox = pe_case(cuda_device, dtype, shape)
    geom = packed_eval.geometry(shape, *bbox, oob)
    before = packed_eval.packed_eval_forward.launches
    planes = packed_eval.packed_eval_forward(packed, *pts, geom)
    assert packed_eval.packed_eval_forward.launches == before + 1
    w = pe_weights(shape, pts, geom, dtype)
    _, w_twin = grid_ops.trilinear_fractions(shape, *pts, *bbox, oob)
    assert torch.equal(pe_bits(w), pe_bits(w_twin))
    want, _ = pe_twin(packed, shape, pts, bbox, oob)
    scale = float(packed.float().abs().max())
    for a, b in zip(planes, want):
        assert float((a - b).abs().max()) <= PE_TOL * scale
    if oob == P.OobPolicy.ZERO:
        outside = (w_twin == 0).all(dim=1)
        assert bool(outside.any())
        assert all(float(p[outside].abs().max()) == 0.0 for p in planes)


def test_packed_eval_degenerate_axis_matches_twin(cuda_device):
    """A zero-extent bbox axis: its local is 0, as the twin's; the
    position cotangent along it is 0, as the twin's autograd gives."""
    from dvren_tpu_torch.ops import grid as grid_ops
    from dvren_tpu_torch.ops import packed_eval

    shape = (5, 6, 7)
    bbox = ((0.0, 0.3, 0.0), (1.0, 0.3, 1.0))
    oob = P.OobPolicy.CLAMP
    packed, pts, _ = pe_case(cuda_device, torch.float32, shape, bbox=bbox)
    geom = packed_eval.geometry(shape, *bbox, oob)
    w = pe_weights(shape, pts, geom, torch.float32)
    _, w_twin = grid_ops.trilinear_fractions(shape, *pts, *bbox, oob)
    assert torch.equal(pe_bits(w), pe_bits(w_twin))
    grads = tuple(torch.ones_like(pts[0]) for _ in range(4))
    _, dpx, dpy, dpz = packed_eval.packed_eval_backward(
        *pts, grads, packed, geom, table_grad=False, position_grad=True)
    _, (_, *want) = pe_twin(packed, shape, pts, bbox, oob, grads, True)
    assert not bool(dpy.any()) and not bool(want[1].any())
    scale = float(max(d.abs().max() for d in want))
    for a, b in zip((dpx, dpz), (want[0], want[2])):
        assert float((a - b).abs().max()) <= PE_POS_TOL * scale


@pytest.mark.parametrize("one_cell", [False, True], ids=["spread", "one"])
@pytest.mark.parametrize("oob", [P.OobPolicy.ZERO, P.OobPolicy.CLAMP])
@pytest.mark.parametrize("dtype", PE_DTYPES)
def test_packed_eval_backward_matches_twin(cuda_device, dtype, oob,
                                           one_cell):
    """The table's cotangent through the kernels' sort, bounds and
    segment sums: float32 within 1e-6 x the largest of the twin's; a 16-bit
    table within one of its roundings (plus 1e-6 x the largest) of the
    twin's float32 sums, which the kernel rounds once (the twin rounds
    each sample's row to 16 bits before it sums). A third of the samples
    carry a zero cotangent (masked slots); ``one`` puts every sample in
    one cell, the longest segment. One forward and one backward launch.
    With the positions' cotangent asked for too, the table's keeps its
    bits, and the positions' is within 2e-6 x the largest of the twin's
    autograd."""
    from dvren_tpu_torch.ops import packed_eval

    shape = (9, 7, 11)
    packed, pts, bbox = pe_case(cuda_device, dtype, shape, seed=3,
                                one_cell=one_cell)
    n = pts[0].numel()
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    keep = (torch.rand(n, generator=gen, device=cuda_device) > 0.33)
    grads = tuple(torch.randn(n, generator=gen, device=cuda_device) * keep
                  for _ in range(4))
    leaf = packed.detach().requires_grad_(True)
    before = (packed_eval.packed_eval_forward.launches,
              packed_eval.packed_eval_backward.launches)
    planes = packed_eval.eval_planes(leaf, shape, *pts, *bbox, oob)
    (got,) = torch.autograd.grad(planes, leaf, grads)
    assert (packed_eval.packed_eval_forward.launches,
            packed_eval.packed_eval_backward.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert got.dtype == dtype and got.shape == packed.shape
    _, want32 = pe_twin(packed.float(), shape, pts, bbox, oob, grads)
    scale = float(want32.abs().max())
    assert scale > 0.0
    if dtype == torch.float32:
        assert float((got - want32).abs().max()) <= PE_TOL * scale
    else:
        bound = ULP16[dtype] * want32.abs() + PE_TOL * scale
        assert bool(((got.float() - want32).abs() <= bound).all())
    if one_cell:
        rows = got.reshape(-1, 32).float().abs().amax(dim=1)
        assert int((rows > 0).sum()) == 1

    moving = tuple(p.clone().requires_grad_(True) for p in pts)
    planes = packed_eval.eval_planes(leaf, shape, *moving, *bbox, oob)
    again, *dp = torch.autograd.grad(planes, (leaf,) + moving, grads)
    assert torch.equal(again, got)
    _, (_, *want_dp) = pe_twin(packed, shape, pts, bbox, oob, grads, True)
    pos_scale = float(max(d.abs().max() for d in want_dp))
    assert pos_scale > 0.0
    for a, b in zip(dp, want_dp):
        assert float((a - b).abs().max()) <= PE_POS_TOL * pos_scale


def test_packed_eval_empty_and_repeat(cuda_device):
    """S = 0: empty planes, an all-zero table cotangent and empty position
    cotangents. Two backwards of one forward, and a recorded CUDA graph's
    replays of the backward, give the same bits as the eager one, with
    and without the position cotangent."""
    from dvren_tpu_torch.ops import packed_eval

    shape = (9, 7, 11)
    packed, pts, bbox = pe_case(cuda_device, torch.float32, shape)
    geom = packed_eval.geometry(shape, *bbox, P.OobPolicy.ZERO)
    empty = tuple(p[:0] for p in pts)
    planes = packed_eval.packed_eval_forward(packed, *empty, geom)
    assert all(p.shape == (0,) for p in planes)
    d0, *dp0 = packed_eval.packed_eval_backward(
        *empty, (empty[0],) * 4, packed, geom, position_grad=True)
    assert d0.shape == (8 * 6 * 10, 32) and not bool(d0.any())
    assert all(d.shape == (0,) for d in dp0)

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    grads = tuple(torch.randn(pts[0].numel(), generator=gen,
                              device=cuda_device) for _ in range(4))
    leaf = packed.detach().requires_grad_(True)
    moving = tuple(p.clone().requires_grad_(True) for p in pts)
    planes = packed_eval.eval_planes(leaf, shape, *moving, *bbox,
                                     P.OobPolicy.ZERO)
    g1 = torch.autograd.grad(planes, (leaf,) + moving, grads,
                             retain_graph=True)
    g2 = torch.autograd.grad(planes, (leaf,) + moving, grads)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))

    for position_grad in (False, True):
        def backward():
            return packed_eval.packed_eval_backward(
                *pts, grads, packed, geom, position_grad=position_grad)

        eager = backward()
        assert torch.equal(eager[0].reshape(g1[0].shape), g1[0])
        if position_grad:
            assert all(torch.equal(a, b) for a, b in zip(eager[1:], g1[1:]))
        captured = graph_mod.capture(
            lambda: tuple(x for x in backward() if x is not None),
            cuda_device)
        assert captured.launches == {"packed_eval_bwd": 1}
        want = tuple(x for x in eager if x is not None)
        for _ in range(2):
            out = captured.replay()
            torch.cuda.synchronize(cuda_device)
            assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_packed_eval_routes_the_card_field(cuda_device):
    """A dense field on the card evaluates through the kernels (counted
    in ``dense.kernel_evals``) for each table type, with or without a
    recorded gradient, and with positions that carry one, whose
    cotangent is the twin's to 2e-6 of the largest; ``use_kernel=False``
    is the twin."""
    from dvren_tpu_torch.ops import grid as grid_ops
    from dvren_tpu_torch.ops import packed_eval
    from dvren_tpu_torch.utils import trace

    _, pts, bbox = pe_case(cuda_device, torch.float32, (5, 6, 7),
                           bbox=((0, 0, 0), (1, 1, 1)))
    field = P.DenseGridField(
        torch.rand((5, 6, 7), device=cuda_device),
        torch.rand((5, 6, 7, 3), device=cuda_device))
    trace.reset()
    trace.enable(True)
    try:
        before = packed_eval.packed_eval_forward.launches
        for dtype in ("float32", "bfloat16", "float16"):
            f = field.with_packed_dtype(dtype)
            f.packed_eval_planes(*pts)
            with torch.no_grad():
                f.packed_eval_planes(*pts)
        assert packed_eval.packed_eval_forward.launches == before + 6
        moving = tuple(p.clone().requires_grad_(True) for p in pts)
        sigma = field.packed_eval_planes(*moving)[0]
        (d_px,) = torch.autograd.grad(sigma.sum(), moving[0])
        assert packed_eval.packed_eval_forward.launches == before + 7
        assert trace.snapshot()["counters"]["dense.kernel_evals"] == 7
    finally:
        trace.enable(False)
        trace.reset()
    packed = grid_ops.build_packed_stencil(field.sigma, field.color)
    twin = tuple(p.clone().requires_grad_(True) for p in pts)
    s_twin = grid_ops.eval_packed_trilinear(
        packed, field.grid_shape, *twin, field.bbox_min, field.bbox_max,
        field.oob, use_kernel=False)[0]
    (want,) = torch.autograd.grad(s_twin.sum(), twin[0])
    scale = float(want.abs().max())
    assert scale > 0.0
    assert float((d_px - want).abs().max()) <= PE_POS_TOL * scale


@pytest.mark.parametrize("oob", ["zero", "clamp"])
@pytest.mark.parametrize("dtype", PE_DTYPES, ids=str)
def test_packed_eval_matches_jax_reference(cuda_device, dtype, oob):
    """The kernels at the points of ``tests/packed_eval_jax_reference.npz``
    against the JAX package's ``eval_packed_trilinear`` and its VJP there
    (JAX on the CPU wrote them; ``tests/test_torch_packed_eval.py`` holds
    the file to JAX): the planes within 1e-6 x the table's largest; the
    position cotangent within 2e-6 x JAX's largest, at twice JAX's where a
    clamped local is exactly 0 or 1 (JAX's ``clip`` passes half there,
    torch's ``clamp`` and the kernels all); the table's cotangent in
    float32 within 1e-6 x JAX's largest. A 16-bit table's: within one
    rounding to its type (plus 1e-6 x the largest) of the exact sums,
    float64 over the twin's weights; and from JAX's, which rounds each
    sample's row to the table's type and sums in it, within that rounding
    and (count + 1) of JAX's roundings of the row's sum of magnitudes."""
    from dvren_tpu_torch.ops import grid as grid_ops
    from dvren_tpu_torch.ops import packed_eval

    ref = np.load(PE_REFERENCE)
    key = f"{str(dtype).split('.')[-1]}.{oob}"
    shape = tuple(ref["sigma"].shape)
    bbox = ((-0.5, 0.2, 0.1), (1.5, 0.9, 2.0))
    policy = P.OobPolicy.CLAMP if oob == "clamp" else P.OobPolicy.ZERO
    packed = grid_ops.build_packed_stencil(
        torch.from_numpy(ref["sigma"]), torch.from_numpy(ref["color"]),
        dtype).reshape(-1, 32).to(cuda_device)
    leaf = packed.detach().requires_grad_(True)
    pts = tuple(torch.from_numpy(p).to(cuda_device).requires_grad_(True)
                for p in ref["positions"])
    grads = torch.from_numpy(ref["grads"]).to(cuda_device)
    planes = packed_eval.eval_planes(leaf, shape, *pts, *bbox, policy)
    d_table, *d_pos = torch.autograd.grad(planes, (leaf,) + pts,
                                          tuple(grads))
    got = torch.stack(planes).detach().cpu().numpy()
    scale = float(packed.float().abs().max())
    assert np.abs(got - ref[f"{key}.planes"]).max() <= PE_TOL * scale

    dp = torch.stack(d_pos).cpu().numpy()
    ties = np.zeros(dp.shape, bool)
    if oob == "clamp":
        for a in range(3):
            local, _ = grid_ops._axis_local(
                torch.from_numpy(ref["positions"][a]), bbox[0][a],
                bbox[1][a])
            ties[a] = (local == 0).numpy() | (local == 1).numpy()
        assert ties.any()
    dp = np.where(ties, dp * np.float32(0.5), dp)
    want_dp = ref[f"{key}.position_grad"]
    assert np.abs(dp - want_dp).max() <= PE_POS_TOL * np.abs(want_dp).max()

    d_table = d_table.float().cpu().numpy().astype(np.float64)
    want = ref[f"{key}.table_grad"].astype(np.float64)
    t_scale = np.abs(want).max()
    assert t_scale > 0.0
    if dtype == torch.float32:
        assert np.abs(d_table - want).max() <= PE_TOL * t_scale
        return
    cpu_pts = tuple(torch.from_numpy(p) for p in ref["positions"])
    (ix, iy, iz), w = grid_ops.trilinear_fractions(shape, *cpu_pts, *bbox,
                                                   policy)
    nz, ny, nx = shape
    row = ((iz * (ny - 1) + iy) * (nx - 1) + ix).numpy()
    terms = (w.numpy().astype(np.float64)[:, :, None]
             * ref["grads"].T.astype(np.float64)[:, None, :]).reshape(-1, 32)
    exact = np.zeros(want.shape)
    mag = np.zeros(want.shape)
    np.add.at(exact, row, terms)
    np.add.at(mag, row, np.abs(terms))
    count = np.bincount(row[(w.numpy() != 0).any(axis=1)],
                        minlength=want.shape[0])[:, None]
    u = ULP16[dtype]
    one = u * np.abs(exact) + PE_TOL * t_scale
    assert np.all(np.abs(d_table - exact) <= one)
    assert np.all(np.abs(d_table - want) <= one + (count + 1) * u * mag)
