"""Find a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) names the cells and the metrics.
Everything else is found by name under ``insitu_bench/``:

* ``workloads/<cell>.json``: the cell's configuration, traffic, driver,
  profiled sub-window and the limits of its comparison;
* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``drivers/<driver>.py``: the general generator that runs a traffic mix;
* ``metrics/<metric>.py``: the reader of one metric.

A later cell, configuration, traffic mix or metric is a new file here and a
new entry in ``BENCHMARK.json``; no file needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    workload: Dict[str, Any]     # workloads/<cell>.json
    config: Dict[str, Any]       # configs/<config>.json
    traffic: Dict[str, Any]      # traffic/<traffic>.json
    end_to_end: List[Dict[str, Any]]   # BENCHMARK.json's metrics of this cell
    per_layer: List[Dict[str, Any]]
    bench_dir: str = HERE        # where the cell's files were found


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    ``KeyError`` for a cell the benchmark does not name and ``ValueError``
    where the cell's file disagrees with ``BENCHMARK.json``."""
    doc = benchmark(root)
    entry = {w["name"]: w for w in doc["workloads"]}[name]
    workload = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(
        name=name, chips=int(entry["chips"]), workload=workload,
        config=_json(os.path.join(bench_dir, "configs", f"{entry['config']}.json")),
        traffic=_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json")),
        end_to_end=[m for m in doc["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in doc["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = HERE) -> ModuleType:
    return _module(os.path.join(bench_dir, "drivers", f"{name}.py"),
                   f"insitu_bench_driver_{name}")


def reader(metric: str, bench_dir: str = HERE) -> ModuleType:
    """``metrics/<metric>.py``: a module with ``read(raw) -> float | None``."""
    safe = metric.replace(".", "_").replace("-", "_")
    return _module(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                   f"insitu_bench_metric_{safe}")


@dataclass
class Context:
    """What a driver gets for one run of a cell."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                  # a torch.device
    tmpdir: str                  # the run's scratch directory (under TMPDIR)
    t_start: float               # the process's start, monotonic seconds

    def profile_start(self, t0: float) -> float:
        """Where the profiled sub-window of a traced run whose window opens at
        ``t0`` starts: the traffic's ``profile_s`` before the window's seconds
        end (at most half the window), so that it runs to the window's close."""
        return t0 + self.seconds - min(self.cell.traffic["profile_s"], 0.5 * self.seconds)
