"""Frozen byte counts of the per-ray integrator K9f (forward) and K9b
(backward) over one step of a windowed schedule, from the schedule alone,
and the kernels' symbols (``dvren_tpu_torch/csrc``), which the readers key
on.

The rule is the one the K9 rows of ``PERF.md`` §6 use (``chip_smoke.py::
k9_bounds``), and like them it counts processed steps only: each
processed step's sigma, dt, three colours (float32) and mask byte read
once, 21 bytes; K9f also reads each ray's depth origin (4 bytes) and
writes its row of 8 floats (32 bytes); K9b also reads each ray's radiance
cotangent (12 bytes) and writes four (M, budget) float32 planes over
every slot of its groups, 16 bytes a slot. Rays and slots are the
launches' own: a group's pad rays are launched too.

A processed step is a live step (its global step below the lattice's
``max_steps`` and its base depth below the ray's ``t_far``, as
``ops/sampling.py::generate_samples`` masks it) before the ray's
transmittance falls to 1e-4. The count takes every live step of each
ray's window, which is the processed count for a field through which no
ray's transmittance reaches 1e-4: ``blob64``'s densest ray has an optical
depth of about 12 sqrt(0.05 pi) = 4.75 (T 8.7e-3), and the fit starts from
0.5. On a field that stops rays early it is an upper bound.

K9f runs once a group in the forward and once more in the backward where
the groups are recomputed (``render/windowed.py::_remat``): ``passes``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

K9F = "integrate_forward_kernel"     # csrc/integrate.cu
K9B = "integrate_backward_kernel"    # csrc/integrate_bwd.cu

STEP_READ = 5 * 4 + 1      # sigma, dt, r, g, b (float32) and the mask byte
K9F_RAY = 4 + 8 * 4        # the depth origin; the output row
K9B_RAY = 3 * 4            # the radiance cotangent
K9B_SLOT = 4 * 4           # d_sigma, d_r, d_g, d_b


@dataclass(frozen=True)
class Steps:
    """A schedule's launches: processed (live) steps, rays (pads
    included) and slots (rays times their group's budget)."""

    processed: int
    rays: int
    slots: int


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def live_end(t_near: float, t_far: float, dt: float, max_steps: int) -> int:
    """The number of global steps whose float32 base depth ``t_near + s
    dt`` lies below ``t_far``, up to ``max_steps``: the depth grows with
    the step, so the live steps of a full ray are the first this many."""
    s = np.arange(max_steps, dtype=np.float32)
    base = np.float32(t_near) + s * np.float32(dt)
    return int(np.count_nonzero(base < np.float32(t_far)))


def schedule_steps(groups, t_near: float, t_far: float, dt: float,
                   max_steps: int) -> Steps:
    """:class:`Steps` of ``groups``, a ``WindowedStackSchedule``'s
    (budget, ids, k_enter, jitter rows, origins, directions, t_far) per
    group, as numpy arrays or tensors. A ray is real where its ``t_far``
    lies past ``t_near`` (pads have ``t_far == t_near``)."""
    end = live_end(t_near, t_far, dt, max_steps)
    processed = rays = slots = 0
    for budget, ids, ke, _, _, _, tf in groups:
        ke = _host(ke).astype(np.int64)
        real = _host(tf) > np.float32(t_near)
        live = np.clip(np.minimum(ke + int(budget), end) - ke, 0, None)
        processed += int(live[real].sum())
        rays += int(_host(ids).shape[0])
        slots += int(_host(ids).shape[0]) * int(budget)
    return Steps(processed, rays, slots)


def k9f_bytes(s: Steps, passes: int = 1) -> int:
    """K9f's bytes over ``passes`` launches of every group."""
    return passes * (s.processed * STEP_READ + s.rays * K9F_RAY)


def k9b_bytes(s: Steps) -> int:
    """K9b's bytes over one launch of every group."""
    return s.processed * STEP_READ + s.rays * K9B_RAY + s.slots * K9B_SLOT
