"""dvren_tpu_torch's CLI, JSON config, PPM files and ``device_put_tree``
against dvren_tpu's (``tests/test_cli.py``'s cases through the port).

The port's CLI renders on the card; ``main(argv, device="cpu")`` renders
on the CPU (for these tests: the command line has no such flag). Without
CUDA the CLI exits 1 with the ``DvrenError`` message, as on a config
error. ``parse_config`` fills the port's PlanConfig, DenseGridConfig and
RenderOptions field for field as JAX's fills its own; the PPM bytes of
one image are equal; the CLI's two summary lines are JAX's (the time
aside; under ``enable_graph`` JAX's scratch count is its XLA executable's
temp size, the port's its analytic count), and its image within 5e-6 of
JAX's CLI image before the bytes.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dvren_tpu.cli import main as j_main
from dvren_tpu.io.config import parse_config as j_parse_config
from dvren_tpu.io.ppm import write_ppm as j_write_ppm

import dvren_tpu_torch as P
from dvren_tpu_torch.cli import main
from dvren_tpu_torch.io import (parse_config, parse_config_file, read_ppm,
                                write_ppm)
from dvren_tpu_torch.utils.pytree import device_put_tree, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLE = os.path.join(REPO, "examples/simple_volume.json")
SMOKE = os.path.join(REPO, "examples/smoke_volume.json")


def run(argv, capsys):
    rc = main(argv, device="cpu")
    return rc, capsys.readouterr()


# ------------------------------------------------ JAX's test_cli.py cases


def test_parse_example_config():
    cfg = parse_config_file(SIMPLE)
    assert cfg.plan.width == 4 and cfg.plan.height == 4
    assert cfg.plan.sampling.dt == pytest.approx(0.1)
    assert cfg.plan.sampling.max_steps == 16
    assert cfg.plan.sampling.mode == P.SamplingMode.FIXED
    assert cfg.grid.resolution == (2, 2, 2)
    assert len(np.asarray(cfg.grid.sigma)) == 8
    assert cfg.grid.interp == P.InterpMode.LINEAR
    assert cfg.grid.oob == P.OobPolicy.ZERO
    assert cfg.options.use_fused_path
    assert cfg.output_path == "simple.ppm"


def test_color_defaults_to_grayscale_density(tmp_path):
    config = {"render": {"width": 2, "height": 2, "t_far": 1.0, "dt": 0.25,
                         "max_steps": 4},
              "volume": {"size": [2, 2, 2], "density": [0.1] * 8}}
    p = tmp_path / "c.json"
    p.write_text(json.dumps(config))
    color = np.asarray(parse_config_file(p).grid.color).reshape(-1, 3)
    np.testing.assert_allclose(color, np.float32(0.1))


def test_cli_end_to_end(tmp_path, capsys):
    out = tmp_path / "out.ppm"
    rc, captured = run([SIMPLE, str(out)], capsys)
    assert rc == 0
    assert "Forward stats: rays=16" in captured.out
    assert "Workspace bytes total=" in captured.out
    img = read_ppm(out)
    assert img.shape == (4, 4, 3) and img.max() > 0


def test_cli_procedural_volume(tmp_path, capsys):
    out = tmp_path / "smoke.ppm"
    rc, _ = run([SMOKE, str(out)], capsys)
    assert rc == 0
    img = read_ppm(out)
    assert img.shape == (64, 64, 3) and img.std() > 0.01


def test_cli_missing_config(capsys):
    rc, captured = run(["/nonexistent/config.json"], capsys)
    assert rc == 1 and "error:" in captured.err


def test_cli_usage(capsys):
    assert main([], device="cpu") == 2
    assert main(["a", "b", "c"], device="cpu") == 2
    assert "usage:" in capsys.readouterr().err


def test_ppm_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(
        np.float32)
    p = tmp_path / "x.ppm"
    write_ppm(p, img)
    back = read_ppm(p)
    assert back.shape == (5, 7, 3)
    assert np.abs(back - np.clip(img, 0, 1)).max() <= 0.5 / 255 + 1e-6


def test_bad_config_raises(tmp_path):
    with pytest.raises(P.DvrenError):
        parse_config_file("/nonexistent.json")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(P.DvrenError):
        parse_config_file(bad)
    missing = tmp_path / "missing.json"
    missing.write_text(json.dumps({"render": {"width": 2, "height": 2},
                                   "volume": {"size": [2, 2, 2]}}))
    with pytest.raises(P.DvrenError, match="missing config key"):
        parse_config_file(missing)


def test_cli_use_window_option_matches_default(tmp_path, capsys):
    base = json.load(open(SIMPLE))
    base.setdefault("render", {}).setdefault("options", {})[
        "use_window"] = True
    cfg_path = tmp_path / "win.json"
    cfg_path.write_text(json.dumps(base))
    out_win, out_ref = tmp_path / "win.ppm", tmp_path / "ref.ppm"
    assert run([str(cfg_path), str(out_win)], capsys)[0] == 0
    assert run([SIMPLE, str(out_ref)], capsys)[0] == 0
    np.testing.assert_array_equal(read_ppm(out_win), read_ppm(out_ref))


# --------------------------------------------------- against the JAX package


def _values(x):
    """A config dataclass as plain values: enums as ints, arrays as
    lists, nested dataclasses recursively."""
    if dataclasses.is_dataclass(x):
        return {f.name: _values(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (np.ndarray, list, tuple)):
        return [_values(v) for v in np.asarray(x).tolist()] \
            if isinstance(x, np.ndarray) else [_values(v) for v in x]
    if hasattr(x, "value") and not isinstance(x, (int, float)):
        return int(x.value)
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    return x


FULL_CONFIG = {
    "render": {
        "width": 40, "height": 24, "t_near": 0.1, "t_far": 2.5, "dt": 0.03,
        "max_steps": 80, "sampling_mode": "stratified", "seed": 11,
        "roi": {"x": 3, "y": 2, "width": 30, "height": 20},
        "camera": {"model": "orthographic",
                   "K": [30.0, 0.0, 20.0, 0.0, 30.0, 12.0, 0.0, 0.0, 1.0],
                   "c2w": [1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1],
                   "ortho_scale": 0.02},
        "options": {"use_fused_path": False, "enable_graph": True,
                    "capture_stats": False, "use_window": True,
                    "use_tiles": True, "use_occupancy": True,
                    "tile_pitch": 2}},
    "volume": {"procedural": "sdf_sphere_shell", "size": [6, 5, 4],
               "bbox_min": [-1, -1, -1], "bbox_max": [1, 2, 1],
               "interp": "nearest", "oob": "clamp",
               "table_precision": "bfloat16"},
    "output": {"path": "full.ppm"},
}


@pytest.mark.parametrize("name", ["simple", "smoke", "full"])
def test_parse_config_equals_jax(name):
    root = (FULL_CONFIG if name == "full"
            else json.load(open(SIMPLE if name == "simple" else SMOKE)))
    got, want = parse_config(root), j_parse_config(root)
    assert _values(got.plan) == _values(want.plan)
    assert _values(got.grid) == _values(want.grid)
    assert _values(got.options) == {
        k: v for k, v in _values(want.options).items()
        if k in {f.name for f in dataclasses.fields(got.options)}}
    assert (got.output_path, got.table_precision) == (want.output_path,
                                                      want.table_precision)


@pytest.mark.parametrize("bad", [
    {"render": {"sampling_mode": "random"}},
    {"volume": {"interp": "cubic"}},
    {"volume": {"oob": "wrap"}},
    {"volume": {"table_precision": "float64"}},
    {"volume": {"procedural": "torus"}},
    {"volume": {"size": [2, 2]}},
])
def test_config_errors_equal_jax(bad):
    root = json.loads(json.dumps(FULL_CONFIG))
    for node, values in bad.items():
        root[node].update(values)
    with pytest.raises(P.DvrenError) as got:
        parse_config(root)
    from dvren_tpu.core.status import DvrenError as JError
    with pytest.raises(JError) as want:
        j_parse_config(root)
    assert got.value.status.to_string() == want.value.status.to_string()


def test_write_ppm_bytes_equal_jax(tmp_path):
    img = np.random.default_rng(3).uniform(-0.2, 1.2, (9, 11, 3)).astype(
        np.float32)
    img[0, 0] = (0.5 / 255, 1.5 / 255, 254.5 / 255)   # rounding ties
    ours, theirs = tmp_path / "a.ppm", tmp_path / "b.ppm"
    write_ppm(ours, torch.from_numpy(img))
    j_write_ppm(theirs, img)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("config", ["simple", "smoke"])
def test_cli_equals_jax_cli(config, tmp_path, capsys, monkeypatch):
    path = SIMPLE if config == "simple" else SMOKE
    ours, theirs = tmp_path / "a.ppm", tmp_path / "b.ppm"
    images = {}
    import dvren_tpu.cli as j_cli
    import dvren_tpu_torch.cli as p_cli
    monkeypatch.setattr(p_cli, "write_ppm", lambda p, im: (
        images.__setitem__("port", np.asarray(im)), write_ppm(p, im)))
    monkeypatch.setattr(j_cli, "write_ppm", lambda p, im: (
        images.__setitem__("jax", np.asarray(im)), j_write_ppm(p, im)))
    assert main([path, str(ours)], device="cpu") == 0
    port_out = capsys.readouterr().out.splitlines()
    assert j_main([path, str(theirs)]) == 0
    jax_out = capsys.readouterr().out.splitlines()
    assert port_out[0].split(" total_ms=")[0] == \
        jax_out[0].split(" total_ms=")[0]
    if config == "simple":
        assert port_out[1] == jax_out[1]
    else:
        # enable_graph: JAX's scratch is its AOT executable's XLA temp size,
        # which has no torch counterpart; the port counts it analytically
        # (as JAX does without an executable). Every other family is equal.
        def families(line):
            return [f for f in line.split()[2:]
                    if not f.startswith(("total=", "scratch="))]
        assert families(port_out[1]) == families(jax_out[1])
    np.testing.assert_allclose(images["port"], images["jax"], atol=5e-6,
                               rtol=0)
    a, b = read_ppm(ours), read_ppm(theirs)
    assert np.abs(a - b).max() <= 1.0 / 255 + 1e-7


def test_cli_without_cuda_exits_1(tmp_path):
    """The CLI runs on the card; without CUDA it exits 1 with the
    DvrenError message and never renders on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour without CUDA "
                    "(tests/test_torch_cuda.py runs the CLI on the card)")
    out = tmp_path / "out.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "dvren_tpu_torch.cli", SIMPLE, str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert proc.stderr.startswith("error: unsupported:")
    assert "CUDA" in proc.stderr and not out.exists()
    assert main([SIMPLE, str(out)]) == 1 and not out.exists()


# ------------------------------------------------------- device_put_tree


@dataclasses.dataclass(frozen=True)
class _Node:
    a: object
    b: object
    name: str = "n"


def test_device_put_tree():
    shared = np.arange(6, dtype=np.int32)
    t = torch.ones(3)
    tree = {"node": _Node(a=shared, b=(shared, [t, 2.5])), "t": t,
            "none": None}
    out = device_put_tree(tree, "cpu")
    node = out["node"]
    assert isinstance(node, _Node) and node.name == "n"
    assert isinstance(node.a, torch.Tensor) and node.a.dtype == torch.int32
    np.testing.assert_array_equal(node.a.numpy(), shared)
    assert node.b[0] is node.a              # one array, one tensor
    assert node.b[1][0] is out["t"] and node.b[1][1] == 2.5
    assert out["none"] is None
    doubled = tree_map(lambda x: x * 2, {"x": (t, t)})
    assert doubled["x"][0] is doubled["x"][1]
    assert torch.equal(doubled["x"][0], t * 2)


def test_device_put_tree_moves_a_schedule():
    """A numpy tile schedule moved whole: its arrays become tensors, a
    group's hostmap and gathermap (one array at pitch 1) stay one tensor,
    and it renders the frame of ``TiledSchedule.to``."""
    from tests.test_tiled import scene
    from tests.test_torch_core import port_field, port_plan
    from dvren_tpu_torch.render import tiled as p_tiled
    plan, field = scene()
    pplan, pf = port_plan(plan), port_field(field)
    host = p_tiled.build_tiled_schedule(pplan, pf)
    g = host.groups[0]
    assert g.hostmap is g.gathermap
    moved = device_put_tree(host, "cpu")
    mg = moved.groups[0]
    assert isinstance(mg.samp, torch.Tensor) and mg.hostmap is mg.gathermap
    with torch.no_grad():
        a = p_tiled.render_tiled(pplan, pf, moved).image
        b = p_tiled.render_tiled(pplan, pf, host.to("cpu")).image
    assert torch.equal(a, b)
