"""The scenes of the contract's scene and soak suites.

The SDF sphere shell (density concentrated where ``|r - R|`` is small),
the pinhole plan the suites render it with, and the moving Gaussian blob
of the 120-frame animation. The shell is built in numpy, as the scalar
oracle reads it; the blob is built in torch on the device the caller
names, so a frame's field is made where it is rendered.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.plan import (CameraConfig, Plan, PlanConfig,
                                       SamplingConfig)
from dvren_tpu_torch.fields.dense_grid import DenseGridConfig, DenseGridField


def sphere_shell_volume(n: int = 32, radius: float = 0.35,
                        width: float = 0.03) -> tuple:
    """(sigma (n, n, n), color (n, n, n, 3)) float32 on the unit cube:
    sigma = 25 exp(-(r - radius)^2 / (2 width^2)) around its centre."""
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r = np.sqrt((xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.5) ** 2)
    sigma = 25.0 * np.exp(-((r - radius) ** 2) / (2 * width ** 2))
    color = np.stack([np.full_like(xs, 0.9), 0.6 + 0.4 * zs, 0.4 + 0.6 * ys],
                     axis=-1)
    return sigma.astype(np.float32), color.astype(np.float32)


def make_plan(w: int, h: int, focal_scale: float = 1.2,
              dt: float = 0.03125, max_steps: int = 64) -> Plan:
    """A w x h pinhole looking down +z at the unit cube from z = -1,
    t in [0.2, 2.2]."""
    return Plan.create(PlanConfig(
        width=w, height=h, t_near=0.2, t_far=2.2,
        camera=CameraConfig(
            k=(w * focal_scale, 0, w / 2, 0, w * focal_scale, h / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(dt=dt, max_steps=max_steps)))


def dense_field(sigma: np.ndarray, color: np.ndarray,
                device=None) -> DenseGridField:
    """A dense field over the unit cube from (Z, Y, X) sigma and
    (Z, Y, X, 3) color arrays, on ``device`` (CUDA when None, as every
    constructor of the port)."""
    return DenseGridField.create(DenseGridConfig(
        resolution=sigma.shape[::-1], sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device=device)


def grid_coords(n: int, device=None) -> torch.Tensor:
    """(3, n, n, n) float32: x, y, z of an n^3 lattice over the unit
    cube, indexed [z][y][x]."""
    axis = torch.linspace(0.0, 1.0, n, dtype=torch.float64)
    zs, ys, xs = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([xs, ys, zs]).to(torch.float32).to(
        resolve_device(device))


def blob_color(coords: torch.Tensor) -> torch.Tensor:
    """(n, n, n, 3): red rising with x, green falling, blue 0.5."""
    xs = coords[0]
    return torch.stack([xs, 1.0 - xs, torch.full_like(xs, 0.5)], dim=-1)


def blob_sigma(coords: torch.Tensor, t: float) -> torch.Tensor:
    """The animation's frame at time t in [0, 1]: a Gaussian blob whose
    centre moves from x = 0.3 to 0.7 and whose peak breathes between 6
    and 10."""
    xs, ys, zs = coords
    r2 = (xs - (0.3 + 0.4 * t)) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    return (8.0 + 2.0 * math.sin(6.28 * t)) * torch.exp(-r2 / 0.05)
