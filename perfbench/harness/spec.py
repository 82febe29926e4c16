"""Everything a run needs, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell
names a configuration and a traffic mix.  The harness reads

* ``perfbench/configs/<config>.json``: the configuration as it is run,
  whose ``system`` key names the system under test;
* ``perfbench/systems/<system>.py``: the system: how to build and call
  it, its units of work, spans and faults, and its check against its
  plain reference (``perfbench/README.md``, "To add a system");
* ``perfbench/traffic/<traffic>.json``: the mix's parameters;
* ``perfbench/limits/<cell>.json``: the limits of the output comparison;
* ``perfbench/metrics/<metric>.py``: one reader a metric, a function
  ``read(ctx)`` returning the number or None where it finds nothing (a
  metric split by cells, ``<quantity>.<qualifier>``, reads its
  quantity's file unless it has one of its own).

A cell, configuration, system, mix or metric added as new files (and
entries in ``BENCHMARK.json``) runs with no edit to any file already
there.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
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


def _module(name: str, path: Path) -> ModuleType:
    """The module at ``path``, loaded afresh under ``name`` (entered in
    ``sys.modules`` first, as an import would, so that its dataclasses
    find it)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def config(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    return _json("configs", name, bench_dir)


def system(config_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module ``perfbench/systems/<system>.py`` that the configuration
    names in its ``system`` key; a configuration without one, or naming a
    system with no module, fails with the file it looked for."""
    path = bench_dir / "configs" / f"{config_name}.json"
    name = json.loads(path.read_text()).get("system")
    if not name:
        raise LookupError(f"{path} names no system: give it a \"system\" key naming "
                          f"{bench_dir / 'systems'}/<system>.py")
    module = bench_dir / "systems" / f"{name}.py"
    if not module.is_file():
        raise LookupError(f"{path} names the system {name!r}, but there is no {module}")
    return _module(f"perfbench_system_{name}", module)


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
    return _module("perfbench_metric_" + metric.replace(".", "_"), path).read
