"""dvren_tpu_torch's CUDA kernels against their plain PyTorch twins.

Every test here launches a kernel and skips where torch has no CUDA
device. The file imports no JAX, so it also runs where JAX is absent;
tests/conftest.py does import JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The twins are held to dvren_tpu on the CPU by the other test_torch_*
files; here the kernels are held to the twins: K3 bit for bit, K1 and
the whole forward within 5e-6 (depth 1e-4).
"""

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch import _build
from dvren_tpu_torch.ops import fused_tiles, packed_transpose
from dvren_tpu_torch.render import tiled

pytestmark = pytest.mark.cuda

TOL = 5e-6
TOL_DEPTH = 1e-4


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
    assert "tile_forward_kernel" in _build.ptxas_report()


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
        P.DenseGridField.create(config))
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL)
    np.testing.assert_allclose(got.depth, ref.depth, atol=TOL_DEPTH)
    np.testing.assert_array_equal(got.hitmask, ref.hitmask)
