"""Every cell, configuration, mix and metric of BENCHMARK.json resolves by
name to files of its own, and the file keeps to the benchmark's
contract."""
import json
import re

import pytest

from bench_port import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.workload["config"] == entry["config"]
    assert cell.workload["traffic"] == entry["traffic"]
    assert cell.workload["chips"] == entry["chips"] == 1
    assert cell.workload["why"] == entry["why"]
    assert len(entry["why"]) <= 200
    assert cell.clients == cell.batch_slots
    mix = cell.traffic
    assert mix["prompt"]["max"] + mix["output"]["max"] <= cell.max_len
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert cell.workload["check"]["limits"]["logit_gap"] > 0


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_keeps_the_ports_widths(entry):
    cfg_file = json.loads((spec.ROOT / entry["file"]).read_text())
    assert spec.config_problems(entry, cfg_file) == []


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert NAME.match(metric["name"])
    assert (spec.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        ends = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in ends


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_cell_is_refused():
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no-such-model.no_such_mix")
    with pytest.raises(ValueError):
        spec.load_cell("../BENCHMARK")
