"""Plan-level helpers shared by the render paths.

Counterpart of ``plan_jitter_table`` in ``dvren_tpu/render/pipeline.py``.
The dense-lattice ``render`` and ``render_streamed`` paths are not ported
yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import functools

import numpy as np

from dvren_tpu_torch.core.plan import Plan, SamplingMode
from dvren_tpu_torch.ops import rng


def plan_jitter_table(plan: Plan) -> np.ndarray | None:
    """Host stratified jitter (N, K) for a plan; None for FIXED mode.

    Cached on (seed, rays, steps): the table does not depend on the
    camera. The cached array is read-only; copy before mutating."""
    if plan.sampling.mode != SamplingMode.STRATIFIED:
        return None
    return _jitter_table_cached(plan.seed, plan.ray_count,
                                plan.sampling.max_steps)


@functools.lru_cache(maxsize=2)
def _jitter_table_cached(seed: int, n_rays: int, n_steps: int):
    table = rng.jitter_table(seed, n_rays, n_steps)
    table.setflags(write=False)
    return table
