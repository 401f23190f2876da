"""BENCHMARK.json and the benchmark's files: every name resolves, and the
file keeps to the contract's shape (keys, names, units, bounds, cells)."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_command_names_files_under_paths_only():
    for word in SPEC["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (ROOT / word).is_file()


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench_port/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    configs = {c["name"] for c in SPEC["configs"]}
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(CELLS) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert cell["chips"] == w["chips"]
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
        if cell["driver"] == "fit":
            step = [m for m in SPEC["end_to_end"]
                    if m["name"] == cell["step_metric"]]
            assert step and w["name"] in step[0]["workloads"]


def test_metric_entries():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports(cell):
    """setup_s, another end-to-end metric and a per-layer metric; each of
    its per-layer metrics moves an end-to-end metric it reports."""
    e2e = {m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", CELLS)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"]
             if cell in m.get("workloads", CELLS if m["moves"] in e2e
                              else [])]
    assert layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_limits(cell):
    """Every number the cell's driver compares has a limit."""
    data = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    wanted = {"fit": {"loss_gap", "grad_gap", "change_gap"},
              "orbit": {"image_rms", "opacity_rms"}}[data["driver"]]
    assert set(data["limits"]) == wanted
    assert all(v > 0 for v in data["limits"].values())


def test_files_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_check_fits_in_its_time():
    """A full check of 24 cells at this run length fits in 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
