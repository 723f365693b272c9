"""What ``BENCHMARK.json`` names, found by name, and the state of one run.

A cell is a workload entry: a configuration (``configs/<name>.json``, by
the entry's ``file``), a traffic mix (``traffic/<traffic>.json``) driven by
the loop its ``driver`` names (``drivers/<driver>.py``), and every metric
whose ``workloads`` list names the cell or that has no such list, each
read by ``metrics/<metric name>.py`` or, where there is none, by the reader
of the name before its first dot, which one quantity's split metrics
(``device_idle_share.saat``, ``.daat``) share. A new cell, configuration, mix or
metric is a new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Optional

PB = Path(__file__).resolve().parent
ROOT = PB.parent
JAX_MODULES = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # the metric entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    with open(root / c["file"]) as f:
        config = json.load(f)
    with open(PB / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, w, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader_path(name: str) -> Path:
    own = PB / "metrics" / f"{name}.py"
    return own if own.is_file() else PB / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str):
    """The metric's reader module; its ``read(run)`` gives the value or None."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """One run of one cell: what set-up built, what the window recorded."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    dep: Any = None  # the deployment's data
    index: Any = None  # the system's index on the device
    state: dict = dataclasses.field(default_factory=dict)  # the driver's objects
    records: dict = dataclasses.field(default_factory=dict)  # what the window recorded
    setup_s: Optional[float] = None
    memory_peak_bytes: Optional[int] = None
    trace_summary: Any = None
    work_bytes: Optional[float] = None  # the algorithm's bytes over the window

    def read_metrics(self, entries: list) -> dict:
        out = {}
        for m in entries:
            v = metric_reader(m["name"]).read(self)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
