"""Whole runs of each driver at a small size on the CPU, past the
harness's look for a chip: a sound run comes out correct under the cell's
limits, and a run with the timed path broken underneath does not, once
for each fault the cell can have (a step that leaves its state unchanged,
half of the batch left out with the mean over the rest, an answer altered
where it is produced; one chip, so no exchange to leave out). The
control, the reference in bfloat16 in the program's place, and the
training faults planted in the reference do not come out correct
either."""

import pytest
import torch

import dvren_tpu_torch.opt.fit as fit_mod
import dvren_tpu_torch.render.tiled as tiled_mod
from dvren_tpu_torch.render.posed import PosedRenderer

from bench_port.lib import checks, harness
from bench_port.tools import limits

SEED = 2 ** 31 + 613
ALTERED = limits.ALTERED_RAYS


def small(cell: str) -> dict:
    spec = harness.workload(cell)
    spec["config_spec"]["grid"]["n"] = 12
    if spec["driver"] == "fit":
        spec["traffic"].update(width=24, height=24, steps=32, sync_every=4)
        spec["traffic"]["orbit"]["count"] = 2
    else:
        spec["traffic"].update(width=64, height=64, steps=32,
                               check_every=1, check_frames=3,
                               traced_frames=2)
        spec["traffic"]["orbit"]["count"] = 6
        spec["traffic"]["orbit"]["of"] = 6
    return spec


def correct(cell: str, spec: dict, seconds: float = 0.05) -> bool:
    out = harness.local_run(cell, spec, SEED, seconds, "cpu",
                            log=lambda *a: None)
    ok, _ = checks.verdict(out.gaps, spec["limits"])
    return ok and out.failed == 0 and out.attempted > 0


FIT_CELLS = ["blob64.fit4x512", "blob128.fit2x512", "blob64.fit8x96"]
ORBIT_CELLS = ["blob64.orbit512"]


def _zero_rays(image, width):
    """``image`` (V, H, W, 3) with 256 rays of view 0 from its middle row
    set to zero."""
    flat = image.reshape(image.shape[0], -1, 3)
    first = (image.shape[1] // 2) * width
    keep = torch.ones_like(flat)
    keep[0, first:first + ALTERED] = 0
    return (flat * keep).reshape(image.shape)


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_sound(cell):
    assert correct(cell, small(cell))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fit_faults(fault, monkeypatch):
    cell = FIT_CELLS[0]
    spec = small(cell)
    if fault == "unchanged":
        step = torch.optim.Adam.step

        def still(self, closure=None):
            saved = [p.detach().clone() for g in self.param_groups
                     for p in g["params"]]
            step(self, closure)
            with torch.no_grad():
                for p, s in zip((p for g in self.param_groups
                                 for p in g["params"]), saved):
                    p.copy_(s)

        monkeypatch.setattr(torch.optim.Adam, "step", still)
    elif fault == "half_batch":
        def half(pred, target):
            n = pred.shape[0] // 2
            return torch.mean((pred[:n] - target[:n]) ** 2)

        monkeypatch.setattr(fit_mod, "mse", half)
    else:
        render = tiled_mod.render_tiled_stack
        width = spec["traffic"]["width"]

        def altered(*args, **kwargs):
            return _zero_rays(render(*args, **kwargs), width)

        monkeypatch.setattr(tiled_mod, "render_tiled_stack", altered)
    assert not correct(cell, spec)


@pytest.mark.parametrize("cell", ORBIT_CELLS)
def test_orbit_sound(cell):
    assert correct(cell, small(cell), seconds=0.5)


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
def test_orbit_faults(fault, monkeypatch):
    cell = ORBIT_CELLS[0]
    spec = small(cell)
    render = PosedRenderer.render
    width = spec["traffic"]["width"]
    last = {}

    def broken(self, plan, field, check_diag=True):
        planes = render(self, plan, field, check_diag)
        if fault == "stale":
            planes, last["p"] = last.get("p", planes), planes
            return planes
        img = planes.image.clone()
        if fault == "half_batch":
            img[img.shape[0] // 2:] = 0
        else:
            img = _zero_rays(img[None], width)[0]
        return type(planes)(image=img, transmittance=planes.transmittance,
                            opacity=planes.opacity, depth=planes.depth,
                            hitmask=planes.hitmask)

    monkeypatch.setattr(PosedRenderer, "render", broken)
    assert not correct(cell, spec, seconds=0.5)


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_control_and_planted_faults(cell):
    spec = small(cell)
    got = limits.fit_controls(spec, SEED, torch.device("cpu"))
    for name, gaps in got.items():
        ok, _ = checks.verdict(gaps, spec["limits"])
        assert not ok, name


@pytest.mark.parametrize("cell", ORBIT_CELLS)
def test_orbit_control(cell):
    spec = small(cell)
    got = limits.frame_controls(spec, SEED, torch.device("cpu"))
    ok, _ = checks.verdict(got["control"], spec["limits"])
    assert not ok
