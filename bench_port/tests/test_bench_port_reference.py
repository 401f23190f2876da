"""The plain reference against the port's CPU path at a small size: ray
generation, the jitter, one render and one Adam step. The test imports
both; the reference imports nothing of the port."""

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import raygen, rng
from dvren_tpu_torch.render.pipeline import render

from bench_port.lib import scene as S
from bench_port.reference import dense_grid as ref

SEED = 2 ** 31 + 4099
W, H, K, N = 32, 24, 40, 12


@pytest.fixture(scope="module")
def case():
    sc = ref.Scene(W, H, 1.2 * W, 0.2, 2.2, K, SEED)
    c2w = ref.orbit_c2w(1, 4, 0.25, 0.15)
    plan = S.plan(P, sc, c2w)
    sigma, color = ref.blob_grid(N, 12.0, 0.05, (0.5, 0.5, 0.45), "cpu")
    return sc, c2w, plan, sigma, color


def test_rays(case):
    sc, c2w, plan, _, _ = case
    rays = raygen.generate_rays(plan, device="cpu")
    origin, dirs = ref._rays(sc, c2w, 0, sc.rays, "cpu")
    torch.testing.assert_close(dirs, rays.directions, rtol=0, atol=2e-7)
    torch.testing.assert_close(origin.expand(sc.rays, 3), rays.origins,
                               rtol=0, atol=0)


def test_jitter(case):
    sc = case[0]
    table = rng.jitter_table(SEED, sc.rays, K)
    mine = ref.jitter(SEED, torch.arange(sc.rays)[:, None],
                      torch.arange(K)[None, :])
    np.testing.assert_array_equal(mine.numpy(), table)


def test_render(case):
    sc, c2w, plan, sigma, color = case
    field = P.DenseGridField(sigma.clone(), color.clone())
    out = render(plan, field, use_kernel=False).planes
    img, op = ref.render_view(sigma, color, sc, c2w)
    assert float(img.abs().max()) > 0.05
    torch.testing.assert_close(img, out.image, rtol=0, atol=1e-6)
    torch.testing.assert_close(op, out.opacity, rtol=0, atol=1e-6)


def test_adam_step(case):
    """One Adam step of the reference equals autograd through the port's
    render and torch's Adam, from the same start and targets."""
    sc, c2w, plan, sigma, color = case
    targets = ref.render_view(sigma, color, sc, c2w)[0][None]
    s0 = torch.full_like(sigma, 0.5)
    c0 = torch.full_like(color, 0.5)
    r = ref.adam_fit(s0, c0, sc, [c2w], targets, 0.05, 1)
    field = P.DenseGridField(s0.clone(), c0.clone())
    opt = torch.optim.Adam(field.parameters(), lr=0.05, betas=(0.9, 0.999),
                           eps=1e-8)
    loss = torch.mean((render(plan, field, use_kernel=False).planes.image
                       - targets[0]) ** 2)
    loss.backward()
    torch.testing.assert_close(r["grads"][0], field.sigma.grad, rtol=1e-4,
                               atol=1e-9)
    torch.testing.assert_close(r["grads"][1], field.color.grad, rtol=1e-4,
                               atol=1e-9)
    opt.step()
    with torch.no_grad():
        field.sigma.clamp_(min=0.0)
        field.color.clamp_(0.0, 1.0)
    assert r["losses"][0] == pytest.approx(float(loss.detach()), rel=1e-6)
    # Adam's first step is lr g / (|g| + eps): where |g| is near eps (1e-8)
    # a gradient's rounding (1e-12) moves the step by lr / (4 eps) times
    # as much, 1e-5
    torch.testing.assert_close(r["params"][0], field.sigma.detach(),
                               rtol=0, atol=2e-5)
    torch.testing.assert_close(r["params"][1], field.color.detach(),
                               rtol=0, atol=2e-5)


def test_bfloat16_control_departs(case):
    sc, c2w, _, sigma, color = case
    f32 = ref.render_view(sigma, color, sc, c2w)
    bf16 = ref.render_view(sigma, color, sc, c2w, dtype=torch.bfloat16)
    assert float((f32[0] - bf16[0]).abs().max()) > 1e-3
