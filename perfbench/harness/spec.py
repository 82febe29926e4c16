"""Everything a run needs, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell
names a configuration and a traffic mix.  The harness reads

* ``perfbench/configs/<config>.json``: the configuration as it is run;
* ``perfbench/traffic/<traffic>.json``: the mix's parameters;
* ``perfbench/limits/<cell>.json``: the limits of the output comparison;
* ``perfbench/metrics/<metric>.py``: one reader a metric, a function
  ``read(ctx)`` returning the number or None where it finds nothing (a
  metric split by cells, ``<quantity>.<qualifier>``, reads its
  quantity's file unless it has one of its own).

A cell, configuration, mix or metric added as new files (and entries in
``BENCHMARK.json``) runs with no edit to any file already there.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> Dict:
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")


def _json(kind: str, name: str, bench_dir: Path) -> Dict:
    return json.loads((bench_dir / kind / f"{name}.json").read_text())


def config(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return _json("configs", name, bench_dir)


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return _json("traffic", name, bench_dir)


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return _json("limits", cell_name, bench_dir)


def metrics_of(cell_name: str, kind: str, root: Path = ROOT) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` key and those that list the cell."""
    return [m for m in benchmark(root)[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read`` of ``perfbench/metrics/<metric>.py``; a metric split by
    cells (``<quantity>.<qualifier>``, e.g. ``audio_rtf.music``) without
    a file of its own reads its quantity's, ``<quantity>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    name = "perfbench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
