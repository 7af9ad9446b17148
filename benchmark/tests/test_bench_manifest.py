"""BENCHMARK.json and every file the harness finds by name in it."""
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_budget():
    assert set(MANIFEST) == KEYS
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    cells = [w["name"] for w in MANIFEST["workloads"]]
    assert len(set(cells)) == len(cells)


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.config["task"] in ("stream", "simulate")
    assert harness.load_task(c.config["task"]).Task
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    e2e = {m["name"] for m in c.end_to_end}
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric, each per-layer metric one this cell reports
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["end_to_end"]
                                    + MANIFEST["per_layer"]])
def test_metric_file(metric):
    m = next(x for x in MANIFEST["end_to_end"] + MANIFEST["per_layer"]
             if x["name"] == metric)
    mod = harness.load_metric(metric)
    assert mod.UNIT == m["unit"]
    if "layer" in m:
        assert mod.LAYER == m["layer"]
        assert mod.MOVES == m["moves"]


def test_layers_named_alike():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    text = (ROOT / "PERF.md").read_text()
    for layer in by_layer:
        assert layer in text, f"PERF.md's list of layers lacks {layer!r}"
