"""Every cell, configuration, traffic mix and metric is found by name, and
the benchmark's file keeps to the contract's shapes."""

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench(path):
    with open(path) as f:
        return json.load(f)


def test_top_level_keys(bench):
    b = _bench(bench)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert bench.stat().st_size <= 64 * 1024


def test_names_and_units(bench):
    b = _bench(bench)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert 1 <= len(c["source"]) <= 200 and "\t" not in c["source"]
        assert PATH.match(c["file"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_metric_shapes(bench):
    b = _bench(bench)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert {"name", "unit", "better", "bound", "source"} <= set(m)
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert {"name", "unit", "better", "source", "layer",
                "moves"} <= set(m)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(harness.__file__.rsplit("/", 2)[0] + "/BENCHMARK.json"))
    ["workloads"]])
def test_every_cell_is_found_by_name(bench, cell):
    c = harness.load_cell(bench, cell)
    root = bench.parent
    assert c.traffic.batch > 0 and c.traffic.campaign_n % c.traffic.batch == 0
    for metric in c.end_to_end + c.per_layer:
        assert callable(harness.reader(root, metric))
    region = harness.reference_region(c.config)
    assert region.name == c.config["reference"]["name"]
    low = harness.reference_region(c.config, c.config["control_precision"])
    assert low.nominal_steps == region.nominal_steps


def test_a_cell_added_as_files_runs_without_edits(bench, tmp_path):
    """A new traffic file and a new entry in BENCHMARK.json are all a new
    cell needs: no file of the harness changes."""
    shutil.copytree(bench.parent / "perfbench", tmp_path / "perfbench")
    b = _bench(bench)
    (tmp_path / "perfbench" / "traffic" / "burst-test.json").write_text(
        json.dumps({"fault_model": {"kind": "multibit", "k": 2},
                    "batch": 128, "campaign_n": 256, "collect": "dense",
                    "schedules": 1}))
    b["workloads"].append({"name": "mm9-tmr-fused.added",
                           "config": "mm9-tmr-fused",
                           "traffic": "burst-test", "chips": 1,
                           "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out, info = harness.run_cell(tmp_path / "BENCHMARK.json",
                                 "mm9-tmr-fused.added", 3, 0.2, False,
                                 device="cpu")
    assert out["correct"] is True
    assert out["attempted"] == 256 * info["campaigns"]
