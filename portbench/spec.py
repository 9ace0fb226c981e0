"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the ``file`` of its ``configs`` entry; its
traffic mix is ``traffic/<traffic>.json``; its correctness limits are
``correct/<cell>.json``; each per-layer metric is the module
``metrics/<metric>.py``, whose ``read(run)`` returns the value or None
when the run holds nothing to read.  So a later change adds a
configuration, a mix, a cell or a metric as new files and entries, and
edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


def root_of(here: str = HERE) -> str:
    """The checkout: the directory that holds ``BENCHMARK.json``."""
    return os.path.dirname(here)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    correct: dict
    end_to_end: list
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; raises KeyError for
    a name it does not list."""
    root = root or root_of()
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    here = os.path.join(root, bench["paths"][0])
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic", work["traffic"] + ".json")),
        correct=_json(os.path.join(here, "correct", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str, root: str | None = None):
    """The module ``metrics/<name>.py`` of the benchmark's folder."""
    root = root or root_of()
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    path = os.path.join(root, bench["paths"][0], "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
