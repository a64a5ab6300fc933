"""Every configuration, cell and metric of BENCHMARK.json is found by name and
keeps the benchmark's rules."""
import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
LINE = re.compile(r"[^\n\t]{1,200}")


def test_the_benchmark_validates():
    spec.validate(BENCH)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert spec.NAME.fullmatch(c["name"]) and LINE.fullmatch(c["why"])
    assert LINE.fullmatch(c["source"]) and c["source"].startswith("http")
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = spec.config(c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    assert hasattr(spec.generator(cfg["generator"]), "make")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert spec.NAME.fullmatch(w["name"]) and spec.NAME.fullmatch(w["traffic"])
    assert w["chips"] == 1 and LINE.fullmatch(w["why"])
    f = spec.workload(w["name"])
    assert f["config"] == w["config"]
    assert f["iterations_per_solve"] > 0 and f["trace_solves"] > 0
    assert set(f["check"]) == {"bound_gap", "bdd_bound_gap", "state_gap"}
    assert all(0 < v < 1 for v in f["check"].values())


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    keys = {"name", "unit", "better", "source"}
    if m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == keys | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    else:
        assert set(m) - {"workloads"} == keys | {"layer", "moves"}
        assert LINE.fullmatch(m["layer"])
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved["workloads"])
    assert spec.NAME.fullmatch(m["name"]) and spec.UNIT.fullmatch(m["unit"])
    assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("name,ok", [
    ("gm50k.dual", True), ("_x-1.a", True), ("a" * 64, True), ("a" * 65, False),
    ("two words", False), ("a/b", False), (".dot", False), ("a,b", False), ("µs", False)])
def test_name_rule(name, ok):
    assert bool(spec.NAME.fullmatch(name)) == ok


@pytest.mark.parametrize("unit,ok", [
    ("it/s", True), ("%", True), ("launches", True), ("ms", True), ("tokens per second", False),
    ("a" * 17, False), ("µs", False)])
def test_unit_rule(unit, ok):
    assert bool(spec.UNIT.fullmatch(unit)) == ok


def test_a_new_cell_is_data_alone(tmp_path, monkeypatch):
    """A configuration, a cell and a metric added as files are found by name."""
    root = tmp_path / "checkout"
    pb = root / "portbench"
    for sub in ("configs", "workloads", "metrics"):
        (pb / sub).mkdir(parents=True)
    (pb / "configs" / "gm_small.json").write_text(json.dumps(
        {**spec.config("gm50k"), "name": "gm_small",
         "instance": {"n_left": 8, "n_right": 8, "candidates": 3, "nr_quadratic": 5}}))
    (pb / "workloads" / "gm_small.dual.json").write_text(json.dumps(
        {**spec.workload("gm50k.dual"), "config": "gm_small"}))
    (pb / "metrics" / "solves_seen.py").write_text("def read(s):\n    return s['iterations']\n")
    monkeypatch.setattr(spec, "HERE", str(pb))
    assert spec.workload("gm_small.dual")["config"] == "gm_small"
    assert spec.config("gm_small")["instance"]["n_left"] == 8
    assert spec.metric_reader("solves_seen")({"iterations": 7}) == 7
    with pytest.raises(ValueError):
        spec.workload("../gm50k")
    assert os.path.exists(pb / "workloads" / "gm_small.dual.json")


def test_every_cell_reports_one_rate_and_the_layers_that_move_it():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(BENCH, w["name"], "end_to_end")}
        layers = spec.metrics_of(BENCH, w["name"], "per_layer")
        rates = e2e - {"setup_s"}
        assert "setup_s" in e2e and len(rates) == 1
        assert len(layers) == 5 and {m["moves"] for m in layers} == rates
