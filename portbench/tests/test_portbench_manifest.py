"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert cmd[1].startswith(SPEC["paths"][0] + "/")
    assert (ROOT / cmd[1]).is_file()
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        # The harness reads a per-layer metric in the cells it lists, and
        # only there.
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    spec = json.loads((ROOT / "portbench" / "workloads"
                       / f"{w['traffic']}.json").read_text())
    assert spec["config"] == w["config"] and spec["chips"] == w["chips"]
    assert spec["why"] == w["why"]
    assert (ROOT / "portbench" / "drivers" / f"{spec['driver']}.py").is_file()
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    cfile = json.loads((ROOT / conf["file"]).read_text())
    assert cfile["name"] == conf["name"] and cfile["source"] == conf["source"]
    assert cfile["reduced"] == conf["reduced"]
    assert (ROOT / "portbench" / cfile["reference"]).is_file()
    assert spec["limits"], "every cell holds its output check's limits"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; each per-layer metric's ``moves`` is one of the
    cell's end-to-end metrics, and its reader file exists."""
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
