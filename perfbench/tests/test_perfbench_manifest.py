"""``BENCHMARK.json`` against the benchmark's contract, and every file it names."""

import json
import re
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in MANIFEST["paths"])
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (key, e[key])


def test_metric_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_names_files_that_exist():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        route = f"{cfg['product']['kind']}_{traffic['engine']}"
        assert (PKG / "routes" / f"{route}.py").is_file()
        assert (PKG / "work" / f"{route}.py").is_file()
        assert json.loads((PKG / "limits" / f"{w['name']}.json").read_text())["limits"]
    assert {w["config"] for w in MANIFEST["workloads"]} == set(configs)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and str(path.relative_to(ROOT)).startswith("perfbench/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"] == []
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    sys.path.insert(0, str(ROOT))
    try:
        from perfbench import run
    finally:
        sys.path.remove(str(ROOT))
    for w in MANIFEST["workloads"]:
        cell = run.Cell(MANIFEST, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
