"""BENCHMARK.json against the contract's form, and every file a cell
needs found by its name."""

import importlib
import json
import re

from conftest import ROOT

from portbench import run

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_names_units_and_entries():
    names = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        names.add(c["name"])
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MANIFEST["workloads"])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}


def test_each_cell_finds_its_files_and_reports_what_it_must():
    for w in MANIFEST["workloads"]:
        cell = run.load_cell(w["name"])
        wl = cell.workload
        importlib.import_module(f"portbench.systems.{wl['entry']}")
        importlib.import_module(f"portbench.work.{wl['entry']}")
        importlib.import_module(f"portbench.reference.{cell.config.get('reference', 'classical')}")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(run.reader(m["name"]))
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        for key in ("batch", "channels", "size"):
            assert cell.config.get(key, cell.mix[key]) == cell.mix[key]
