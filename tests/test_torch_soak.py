"""The reference-scale soak suites on the port: tests/test_soak.py for
dvren_tpu_torch.

- 120 frames at 24x18 over a 10^3 blob through one Renderer, the field
  made anew every frame (``utils/scenes.blob_sigma``), the per-frame
  invariants on each and the scalar oracle on frames 0, 29, 59, 89 and 119
  (image 4e-3, depth 1e-2);
- 320x240 over the 48^3 shell through the windowed path against the
  oracle on 16 pixels (image 3e-3), and 960x720 over 64^3 when
  ``DVREN_SOAK=1`` (``chip_smoke.py --only soak`` runs it on the card).
"""

import os

import numpy as np
import pytest

from tests.test_torch_scenes import renderer, subset_oracle_check

from dvren_tpu_torch.utils.scenes import (blob_color, blob_sigma,
                                          dense_field, grid_coords, make_plan,
                                          sphere_shell_volume)

SOAK = os.environ.get("DVREN_SOAK", "") not in ("", "0")
CPU = "cpu"


def test_animation_120_frames():
    plan = make_plan(24, 18, dt=0.0625, max_steps=32)
    r = renderer(plan)
    coords = grid_coords(10, CPU)
    color = blob_color(coords)
    color_np = color.numpy()
    prev_img = None
    rng_pix = np.random.default_rng(7)
    frames = 120
    oracle_frames = {0, 29, 59, 89, 119}
    for frame in range(frames):
        sigma = blob_sigma(coords, frame / float(frames))
        field = dense_field(sigma.numpy(), color_np, CPU)
        fr = r.forward(field)
        img = fr.image.reshape(18, 24, 3)
        assert np.isfinite(img).all(), frame
        assert fr.opacity.max() <= 1.0 + 1e-6, frame
        assert fr.transmittance.min() >= -1e-6, frame
        assert fr.opacity.min() >= -1e-6, frame
        if frame in oracle_frames:
            pixels = list(zip(rng_pix.integers(0, 24, 5),
                              rng_pix.integers(0, 18, 5)))
            subset_oracle_check(plan, fr, sigma.numpy(), color_np, pixels,
                                img_tol=4e-3)
        if prev_img is not None:
            assert np.abs(img - prev_img).max() > 1e-6, frame
        prev_img = img


@pytest.mark.parametrize("w,h,grid", [
    pytest.param(320, 240, 48, id="320x240"),
    pytest.param(960, 720, 64, id="960x720-soak",
                 marks=pytest.mark.skipif(
                     not SOAK, reason="set DVREN_SOAK=1 for the full-scale "
                     "run (chip_smoke.py --only soak runs it on the card)")),
])
def test_highres_windowed_subset_oracle(w, h, grid):
    sigma, color = sphere_shell_volume(grid, radius=0.3, width=0.05)
    plan = make_plan(w, h, dt=2.0 / 64, max_steps=64)
    fr = renderer(plan, use_window=True).forward(
        dense_field(sigma, color, CPU))
    assert "windowed_path" in " ".join(fr.stats.notes)
    img = fr.image.reshape(h, w, 3)
    assert np.isfinite(img).all()
    assert img.std() > 0.01
    assert fr.hitmask.sum() == w * h
    rng = np.random.default_rng(3)
    pixels = list(zip(rng.integers(0, w, 16), rng.integers(0, h, 16)))
    subset_oracle_check(plan, fr, sigma, color, pixels)
