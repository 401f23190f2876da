"""dvren_tpu_torch's CUDA kernels against their plain PyTorch twins.

Every test here launches a kernel and skips where torch has no CUDA
device. The file imports no JAX, so it also runs where JAX is absent;
tests/conftest.py does import JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The twins are held to dvren_tpu on the CPU by the other test_torch_*
files; here the kernels are held to the twins: K3 and K4 bit for bit, K1
and the whole forward within 5e-6 (depth 1e-4), K2 within 2e-6 x scale
on d(table) and 1e-5 x scale on d(rayt), the backward on the card within
2e-6 x scale of the CPU's (camera rtol 2e-3 / atol 1e-4), and every
kernel's repeat runs bit for bit. The hash-MLP kernels: K7f and the hash
Renderer.forward within 5e-6 (depth 1e-4), K7b within 2e-5 x scale (the
JAX package's bound for its own kernel, tests/test_hash_tiled.py:114),
fit_hash_mlp's losses on the card within 1e-5 relative of the CPU's.
The hash-grid kernels: K8f within 5e-6 (depth 1e-4), K8b within 2e-5 x
scale on its slot rows and MLP gradients, repeat runs and two backwards
of render_hash_grid_tiled under torch.use_deterministic_algorithms bit
for bit, and the card's render and gradients within those bounds of the
CPU twins'. The 16-bit tables and sparse fields: K5a and K5b bit for bit,
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
schedule's planes on the card, with zero gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch import _build
from dvren_tpu_torch.ops import (fused_tiles, hash_grid, hash_tiles,
                                 packed_transpose)
from dvren_tpu_torch.ops.grid import build_supercell_stencil
from dvren_tpu_torch.opt import fit
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
                   "packed_table16_kernel", "packed_table16_grad_kernel"):
        assert kernel in report


@pytest.mark.parametrize("shape", [(2, 2, 2), (5, 7, 9), (3, 17, 40),
                                   (64, 64, 64)])
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
    assert torch.equal(got, packed_transpose.build_rows_plain(sigma, color))


def test_packed_table_rejects_strided_input(cuda_device):
    sigma = torch.zeros((4, 4, 8), device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError):
        packed_transpose.build_rows(sigma, torch.zeros((4, 4, 4, 3),
                                                       device=cuda_device))


def _group_args(name, device):
    plan, config = scene(name)
    field = P.DenseGridField.create(config, device=device)
    sched = tiled.build_tiled_schedule(plan, field).to(device)
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    table = packed_transpose.build_rows_plain(field.sigma.detach(),
                                              field.color.detach())
    tabs = tiled._gather_bank_tables(
        table, sched.gathermap_all, [(g.n_tiles, g.banks)
                                     for g in sched.groups])
    return plan, [(tabs[i], g.samp, g.base, g.rayt, g.k_enter,
                   g.bank0.reshape(-1),
                   fused_tiles.tile_op_params(plan, geom, g.banks,
                                              g.n_chunks))
                  for i, g in enumerate(sched.groups)]


@pytest.mark.parametrize("name", SCENES)
def test_fused_tiles_matches_plain(cuda_device, name):
    plan, groups = _group_args(name, cuda_device)
    for args in groups:
        before = fused_tiles.tile_forward.launches
        out = fused_tiles.tile_forward(*args)
        torch.cuda.synchronize()
        assert fused_tiles.tile_forward.launches == before + 1
        plain = fused_tiles.tile_forward_plain(*args)
        assert bool(torch.isfinite(out).all())
        (r, g, b), t, o, d = fused_tiles.finalize_heads(plan, out)
        (r2, g2, b2), t2, o2, d2 = fused_tiles.finalize_heads(plan, plain)
        for x, y in ((r, r2), (g, g2), (b, b2), (t, t2), (o, o2)):
            assert float((x - y).abs().max()) <= TOL
        assert float((d - d2).abs().max()) <= TOL_DEPTH


def test_fused_tiles_rejects_strided_input(cuda_device):
    _, groups = _group_args("fixed", cuda_device)
    tabs, samp, base, rayt, ke, bank0, prm = groups[0]
    strided = torch.empty((tabs.shape[0] * 2,) + tabs.shape[1:],
                          device=cuda_device)[::2]
    strided.copy_(tabs)
    with pytest.raises(ValueError):
        fused_tiles.tile_forward(strided, samp, base, rayt, ke, bank0, prm)


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
    for args in groups:
        gs = torch.randn((args[0].shape[0], 5, 16, 16), generator=gen,
                         device=cuda_device)
        before = fused_tiles.tile_backward.launches
        rows, d_rayt = fused_tiles.tile_backward(*args[:6], gs, args[6],
                                                 cam=True)
        torch.cuda.synchronize()
        assert fused_tiles.tile_backward.launches == before + 1
        p_rows, p_rayt = fused_tiles.tile_backward_plain(*args[:6], gs,
                                                         args[6], cam=True)
        assert bool(torch.isfinite(rows).all())
        _close(rows, p_rows, GRID_TOL)
        _close(d_rayt, p_rayt, CAM_TOL)
        rows2, d_rayt2 = fused_tiles.tile_backward(*args[:6], gs, args[6],
                                                   cam=True)
        assert torch.equal(rows2, rows) and torch.equal(d_rayt2, d_rayt)
        rows_nc, none = fused_tiles.tile_backward(*args[:6], gs, args[6])
        assert none is None and torch.equal(rows_nc, rows)


def test_tile_backward_rejects_strided_input(cuda_device):
    _, groups = _group_args("fixed", cuda_device)
    tabs, samp, base, rayt, ke, bank0, prm = groups[0]
    gs = torch.zeros((tabs.shape[0] * 2, 5, 16, 16), device=cuda_device)[::2]
    with pytest.raises(ValueError):
        fused_tiles.tile_backward(tabs, samp, base, rayt, ke, bank0, gs, prm)


@pytest.mark.parametrize("shape", [(2, 2, 2), (5, 7, 9), (3, 17, 40),
                                   (64, 64, 64)])
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
        assert a.shape == b.shape and torch.equal(a, b)


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
    launches = (hash_tiles.hash_tile_forward.launches,
                hash_tiles.hash_tile_backward.launches)
    got = fit.fit_hash_mlp(plan, field.to(cuda_device), cams, tgt, config)
    assert hash_tiles.hash_tile_forward.launches == launches[0] + 3
    assert hash_tiles.hash_tile_backward.launches == launches[1] + 3
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


def _grid_args(name, device):
    plan, field = grid_scene(name, device)
    field.requires_grad_(False)
    sched = hash_tiled.build_hash_grid_schedule(plan, field, device=device)
    table = hash_grid.build_hash_grid_table(dict(field.params), field.spec)
    tabs = tiled._gather_bank_tables(
        table, sched.gathermap_all,
        [(g.n_tiles, g.banks) for g in sched.groups])
    sc = hash_tiles.pack_mlp_scalars(dict(field.params), field.spec)
    args = []
    for gi, g in enumerate(sched.groups):
        prm = hash_grid.grid_op_params(plan, field.spec, g.banks, g.n_chunks)
        args.append((tabs[gi], g.samp, g.base, g.rayt, g.k_enter,
                     g.bank0.reshape(-1), sc, prm))
    return plan, args


@pytest.mark.parametrize("name", GRID_SCENES)
def test_hash_grid_forward_matches_plain(cuda_device, name):
    plan, args = _grid_args(name, cuda_device)
    for a in args:
        before = hash_grid.hash_grid_forward.launches
        out = hash_grid.hash_grid_forward(*a)
        torch.cuda.synchronize()
        assert hash_grid.hash_grid_forward.launches == before + 1
        plain = hash_grid.hash_grid_forward_plain(*a)
        assert bool(torch.isfinite(out).all())
        (r, g, b), t, o, d = fused_tiles.finalize_heads(plan, out)
        (r2, g2, b2), t2, o2, d2 = fused_tiles.finalize_heads(plan, plain)
        for x, y in ((r, r2), (g, g2), (b, b2), (t, t2), (o, o2)):
            assert float((x - y).abs().max()) <= TOL
        assert float((d - d2).abs().max()) <= TOL_DEPTH
    if name == "opaque":   # some ray stops early
        a = args[0]
        no_stop = hash_grid.hash_grid_forward_plain(
            *a[:7], dataclasses.replace(a[7], stop=0.0))
        assert bool((hash_grid.hash_grid_forward_plain(*a)[:, 4]
                     < no_stop[:, 4]).any())


@pytest.mark.parametrize("name", GRID_SCENES)
def test_hash_grid_backward_matches_plain(cuda_device, name):
    _, args = _grid_args(name, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for a in args:
        gs = torch.randn((a[0].shape[0], 5, 16, 16), generator=gen,
                         device=cuda_device)
        before = hash_grid.hash_grid_backward.launches
        d_rows, d_sc = hash_grid.hash_grid_backward(*a[:7], gs, a[7])
        torch.cuda.synchronize()
        assert hash_grid.hash_grid_backward.launches == before + 1
        p_rows, p_sc = hash_grid.hash_grid_backward_plain(*a[:7], gs, a[7])
        for got, want in ((d_rows, p_rows), (d_sc, p_sc)):
            assert bool(torch.isfinite(got).all())
            _close(got, want, HASH_GRAD_TOL)
        again = hash_grid.hash_grid_backward(*a[:7], gs, a[7])
        assert torch.equal(again[0], d_rows) and torch.equal(again[1], d_sc)


def test_hash_grid_kernels_reject_strided_input(cuda_device):
    _, args = _grid_args("fixed", cuda_device)
    tabs = args[0][0]
    strided = torch.empty((tabs.shape[0] * 2,) + tabs.shape[1:],
                          device=cuda_device)[::2]
    strided.copy_(tabs)
    with pytest.raises(ValueError):
        hash_grid.hash_grid_forward(strided, *args[0][1:])


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

    launches = (hash_grid.hash_grid_forward.launches,
                hash_grid.hash_grid_backward.launches)
    torch.use_deterministic_algorithms(True)
    try:
        got, g1 = run(cuda_device)
        _, g2 = run(cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    assert hash_grid.hash_grid_forward.launches > launches[0]
    assert hash_grid.hash_grid_backward.launches > launches[1]
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
@pytest.mark.parametrize("shape", [(2, 2, 2), (5, 7, 9), (3, 17, 40),
                                   (64, 64, 64)])
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


@pytest.mark.parametrize("dtype", DTYPES16)
@pytest.mark.parametrize("shape", [(2, 2, 2), (5, 7, 9), (3, 17, 40),
                                   (64, 64, 64)])
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
        assert a.shape == b.shape and torch.equal(a, b)


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
    """Every group of the supercell scene's (px, scale) schedule, overflow
    or not, as K1's arguments on ``device``."""
    plan, config = super_scene()
    field = P.DenseGridField.create(config, device=device)
    sched = tiled.build_tiled_schedule(plan, field, tile_px=px,
                                       cell_scale=scale).to(device)
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    sigma, color = field.sigma.detach(), field.color.detach()
    table = (build_supercell_stencil(sigma, color) if scale == 2
             else packed_transpose.build_rows_plain(sigma, color))
    tabs = tiled._gather_bank_tables(
        table, sched.gathermap_all, [(g.n_tiles, g.banks)
                                     for g in sched.groups])
    subs, stencil = (16 // px) ** 2, ("super" if scale == 2 else "cell")
    return [(tabs[i], g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1),
             fused_tiles.tile_op_params(plan, geom, g.banks, g.n_chunks, subs,
                                        stencil))
            for i, g in enumerate(sched.groups)]


@pytest.mark.parametrize("px,scale", VARIANTS)
def test_tile_variants_bit_equal_to_plain(cuda_device, px, scale):
    """K1 and K2 in their sub-tiled and supercell forms: equal to their
    twins bit for bit (heads, d(table) rows, d(rayt)), repeat runs too."""
    groups = _variant_args(px, scale, cuda_device)
    assert groups
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    for args in groups:
        assert args[0].shape[2] == (108 if scale == 2 else 32)
        before = (fused_tiles.tile_forward.launches,
                  fused_tiles.tile_backward.launches)
        out = fused_tiles.tile_forward(*args)
        gs = torch.randn((args[0].shape[0], 5, 16, 16), generator=gen,
                         device=cuda_device)
        rows, d_rayt = fused_tiles.tile_backward(*args[:6], gs, args[6],
                                                 cam=True)
        torch.cuda.synchronize()
        assert (fused_tiles.tile_forward.launches,
                fused_tiles.tile_backward.launches) == (before[0] + 1,
                                                        before[1] + 1)
        assert torch.equal(out, fused_tiles.tile_forward_plain(*args))
        p_rows, p_rayt = fused_tiles.tile_backward_plain(*args[:6], gs,
                                                         args[6], cam=True)
        assert bool(torch.isfinite(rows).all())
        assert torch.equal(rows, p_rows) and torch.equal(d_rayt, p_rayt)
        rows2, d_rayt2 = fused_tiles.tile_backward(*args[:6], gs, args[6],
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
    subs = (16 // sched.tile_px) ** 2
    table = hash_grid.build_hash_grid_table(dict(field.params), field.spec)
    tabs = tiled._gather_bank_tables(
        table, sched.gathermap_all,
        [(g.n_tiles, g.banks) for g in sched.groups])
    sc = hash_tiles.pack_mlp_scalars(dict(field.params), field.spec)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for gi, g in enumerate(sched.groups):
        prm = hash_grid.grid_op_params(plan, field.spec, g.banks, g.n_chunks,
                                       subs)
        a = (tabs[gi], g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1),
             sc, prm)
        before = (hash_grid.hash_grid_forward.launches,
                  hash_grid.hash_grid_backward.launches)
        out = hash_grid.hash_grid_forward(*a)
        gs = torch.randn((g.n_tiles, 5, 16, 16), generator=gen,
                         device=cuda_device)
        d_rows, d_sc = hash_grid.hash_grid_backward(*a[:7], gs, prm)
        torch.cuda.synchronize()
        assert (hash_grid.hash_grid_forward.launches,
                hash_grid.hash_grid_backward.launches) == (before[0] + 1,
                                                           before[1] + 1)
        assert torch.equal(out, hash_grid.hash_grid_forward_plain(*a))
        p_rows, p_sc = hash_grid.hash_grid_backward_plain(*a[:7], gs, prm)
        for got, want in ((d_rows, p_rows), (d_sc, p_sc)):
            assert bool(torch.isfinite(got).all())
            _close(got, want, HASH_GRAD_TOL)
        again = hash_grid.hash_grid_backward(*a[:7], gs, prm)
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


def test_fit_dense_grid_on_the_card(cuda_device):
    """Three steps of fit_dense_grid: one K1 and one K2 launch per merged
    group per step; the losses within 1e-5 relative of the CPU's fit."""
    plan, cams, truth = fit_scene(cuda_device)
    with torch.no_grad():
        _, merged, render_stack = fit._scheduled_views(plan, cams, truth,
                                                       "tiled")
        targets = render_stack(truth, merged).cpu().numpy()
    n_groups = len(merged.sched.groups)

    def flat(device):
        f = fit_scene(device)[2]
        return f.with_params(torch.full_like(f.sigma, 0.5),
                             torch.full_like(f.color, 0.5))

    config = fit.FitConfig(learning_rate=5e-2, steps=3, sync_every=2,
                           target_psnr=None)
    before = (fused_tiles.tile_forward.launches,
              fused_tiles.tile_backward.launches)
    got = fit.fit_dense_grid(plan, flat(cuda_device), cams, targets, config,
                             mode="tiled")
    assert got.steps_run == 3
    assert (fused_tiles.tile_forward.launches,
            fused_tiles.tile_backward.launches) == (
                before[0] + 3 * n_groups, before[1] + 3 * n_groups)
    want = fit.fit_dense_grid(plan, flat("cpu"), cams, targets, config,
                              mode="tiled")
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-5)
    assert got.loss_history[-1] < got.loss_history[0]
    assert float(got.field.sigma.min()) >= 0.0
    assert float(got.field.color.max()) <= 1.0
    assert got.steady_step_ms > 0.0
