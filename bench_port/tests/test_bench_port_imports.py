"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``dvren_tpu_torch`` is the port, ``dvren_tpu``
the JAX package), and the plain reference imports nothing of the port:
over the sources' syntax trees and over ``sys.modules`` after a dry pass
of both drivers on the CPU. ``run.py`` without a card exits non-zero and
prints no result."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH).parts)


def imported(path: Path) -> set:
    """Top-level names of every absolute import in a source file."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_compare():
    assert harness.forbidden_modules(
        ["dvren_tpu_torch", "dvren_tpu_torch.ops", "jaxtyping",
         "flaxen.x"]) == []
    assert harness.forbidden_modules(["dvren_tpu.ops.grid"]) == ["dvren_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = imported(path)
        assert "dvren_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "dataclasses", "torch"}, path


DRY = """
import json, sys
sys.path.insert(0, {root!r})
from bench_port.lib import harness
for cell in ("blob64.fit8x96", "blob64.orbit512"):
    spec = harness.workload(cell)
    spec["config_spec"]["grid"]["n"] = 8
    spec["traffic"].update(width=16, height=16, steps=16, sync_every=2,
                           check_every=1, check_frames=1, traced_frames=1)
    if cell.endswith("orbit512"):
        spec["traffic"].update(width=64, height=32)
        spec["traffic"]["orbit"].update(count=3, of=3)
    else:
        spec["traffic"]["orbit"]["count"] = 2
    harness.local_run(cell, spec, 2 ** 31 + 1, 0.01, "cpu",
                      log=lambda *a: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_modules_after_a_dry_pass():
    out = subprocess.run([sys.executable, "-c", DRY.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True, cwd=ROOT)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "dvren_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "blob64.fit8x96", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_cell():
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "no.such",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
