"""The benchmark's files, found by name, and the rules their names keep.

``BENCHMARK.json`` (at the root of the checkout) lists configurations, cells
and metrics. Each piece lives in a file of its own under ``portbench/``:

- a configuration: ``configs/<name>.json`` (its instance generator, sizes and
  the program's solver settings);
- a cell's traffic mix: ``workloads/<cell>.json`` (the configuration it runs,
  its own instance parameters, the solve, the traced slice, the check's limits);
- an instance generator: ``generators/<name>.py`` with ``make(params, seed)``;
- a metric: ``metrics/<name>.py`` with ``read(summary)``, which returns the
  value or None where the summary holds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}")
    return name


def workload(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", _checked(name) + ".json"))


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", _checked(name) + ".json"))


def generator(name: str):
    return importlib.import_module(f"portbench.generators.{_checked(name)}")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", _checked(name) + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def validate(bench: dict) -> None:
    """Raise on a file or name that breaks the benchmark's rules."""
    names: Dict[str, set] = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in bench["configs"]:
        names["configs"].add(_checked(c["name"]))
        for key in c["reduced"]:
            _checked(key)
        cfg = config(c["name"])
        generator(cfg["generator"])
        if not os.path.exists(os.path.join(ROOT, c["file"])):
            raise ValueError(f"missing {c['file']}")
    pairs = set()
    for w in bench["workloads"]:
        names["workloads"].add(_checked(w["name"]))
        _checked(w["traffic"])
        if w["config"] not in names["configs"]:
            raise ValueError(f"cell {w['name']} names an unknown configuration")
        if (w["config"], w["traffic"]) in pairs:
            raise ValueError(f"cell {w['name']} repeats a pair of configuration and traffic")
        pairs.add((w["config"], w["traffic"]))
        if workload(w["name"])["config"] != w["config"]:
            raise ValueError(f"cell {w['name']}: its file names another configuration")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            _checked(m["name"])
            if m["name"] in names["metrics"]:
                raise ValueError(f"metric {m['name']} twice")
            names["metrics"].add(m["name"])
            if not UNIT.fullmatch(m["unit"]) or m["better"] not in ("lower", "higher"):
                raise ValueError(f"metric {m['name']}: unit or direction")
            if m["source"] not in SOURCES:
                raise ValueError(f"metric {m['name']}: source {m['source']!r}")
            for w in m.get("workloads", []):
                if w not in names["workloads"]:
                    raise ValueError(f"metric {m['name']} names an unknown cell {w}")
            metric_reader(m["name"])
    for w in bench["workloads"]:
        if not any(m["name"] == "setup_s" for m in metrics_of(bench, w["name"], "end_to_end")):
            raise ValueError(f"cell {w['name']} reports no setup_s")
        if len(metrics_of(bench, w["name"], "end_to_end")) < 2 or not metrics_of(
                bench, w["name"], "per_layer"):
            raise ValueError(f"cell {w['name']} reports too few metrics")
    used = {w["config"] for w in bench["workloads"]}
    if used != names["configs"]:
        raise ValueError(f"configurations no cell runs: {names['configs'] - used}")
