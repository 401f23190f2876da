"""The port's contract manifest against the JAX package's.

``tests/manifest_torch.yaml`` names the cases of ``tests/manifest.yaml``
in the same order, each at a node of a ``tests/test_torch_*.py`` file that
exists (one ``pytest --collect-only`` over the nodes, parametrised ids
included), covers every case of ``tools/validate_gates.py``'s four case
gates, maps at most five cases to card-only nodes (each named in the
manifest's comments), and a scoreboard of that manifest with every case
passing passes the contract, gradient, stability, determinism and
artifacts gates, with performance skipped. The tools are loaded from their
files (they import only the standard library); nothing here runs a case,
calls ``validate_gates.main`` or reads a bench result.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_MANIFEST = ROOT / "tests" / "manifest.yaml"
PORT_MANIFEST = ROOT / "tests" / "manifest_torch.yaml"
CARD_ONLY_FILE = "tests/test_torch_cuda.py"
MAX_CARD_ONLY = 5


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_contract_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


run_manifest = load_tool("run_manifest")
validate_gates = load_tool("validate_gates")
JAX_CASES = run_manifest.load_manifest(str(JAX_MANIFEST))
PORT_CASES = run_manifest.load_manifest(str(PORT_MANIFEST))


def test_same_names_in_the_same_order():
    assert len(JAX_CASES) == 114
    assert [c["name"] for c in PORT_CASES] == [c["name"] for c in JAX_CASES]


def test_every_node_is_a_port_test():
    for case in PORT_CASES:
        path = case["test"].split("::")[0]
        assert path.startswith("tests/test_torch_") and path.endswith(".py"), \
            case
        assert (ROOT / path).is_file(), case


def test_every_node_exists():
    nodes = sorted({c["test"] for c in PORT_CASES})
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-o", "addopts=", "-p", "no:cacheprovider", "-p", "no:randomly",
         *nodes], cwd=ROOT, capture_output=True, text=True, timeout=300)
    collected = {line.strip() for line in proc.stdout.splitlines()
                 if "::" in line}
    missing = [n for n in nodes if n not in collected]
    assert not missing, (missing, proc.stdout[-2000:], proc.stderr[-2000:])


def test_gate_cases_are_mapped():
    names = {c["name"] for c in PORT_CASES}
    gated = [n for cases in validate_gates.GATE_CASES.values() for n in cases]
    assert len(gated) == 39
    assert not [n for n in gated if n not in names]


def test_card_only_cases_are_few_and_named():
    card = [c["name"] for c in PORT_CASES
            if c["test"].startswith(CARD_ONLY_FILE + "::")]
    assert len(card) <= MAX_CARD_ONLY, card
    comments = "".join(line.split("#", 1)[1] for line in
                       PORT_MANIFEST.read_text().splitlines() if "#" in line)
    for name in card:
        assert name in comments, name


@pytest.mark.parametrize("status", ["pass", "skip"])
def test_passing_scoreboard_passes_the_case_gates(status):
    """Every case at ``status`` (a card-only case skips on the CPU): the
    four case gates and the artifacts gate pass, performance is
    skipped without a bench result."""
    cases = [{"name": c["name"], "status": "pass", "message": "",
              "seconds": 0.0} for c in PORT_CASES]
    for case, src in zip(cases, PORT_CASES):
        if src["test"].startswith(CARD_ONLY_FILE + "::"):
            case["status"] = status
    scoreboard = run_manifest.build_scoreboard(cases, 1.0)
    report = validate_gates.validate(scoreboard, None, {})
    gates = report["gates"]
    for gate in ("contract", "gradient", "stability", "determinism"):
        assert gates[gate]["pass"], (gate, gates[gate])
        assert not gates[gate]["missing_cases"]
    assert gates["artifacts"]["pass"]
    assert gates["performance"]["pass"] and "skipped" in gates["performance"]
    assert report["all_pass"]


def test_a_failed_gate_case_fails_its_gate():
    cases = [{"name": c["name"], "status": "pass", "message": "",
              "seconds": 0.0} for c in PORT_CASES]
    for case in cases:
        if case["name"] == "diff_grid_fd":
            case["status"] = "fail"
    report = validate_gates.validate(
        run_manifest.build_scoreboard(cases, 1.0), None, {})
    assert not report["gates"]["gradient"]["pass"]
    assert report["gates"]["gradient"]["failed_cases"] == ["diff_grid_fd"]
    assert not report["all_pass"]
