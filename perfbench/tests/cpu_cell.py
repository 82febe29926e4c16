"""A cell of the benchmark run on the CPU at a size a test can hold.

``small_bench(tmp, cell, ...)`` copies ``BENCHMARK.json`` and the
benchmark's files into ``tmp`` with the cell's traffic cut to a pool of
short files (the same generator, the same parameter file otherwise) and,
where asked, the configuration's widths narrowed; ``run(...)`` drives
``harness.main.run_cell`` on the CPU there and returns the result line.
Nothing here looks for a card.
"""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

from perfbench.harness import main, spec

NARROW = {"vae": {"base_channels": 32}, "unet": {"model_channels": 32},
          "vocoder": {"upsample_initial": 64, "channel_floor": 16}}


def small_bench(tmp: Path, cell_name: str, seconds=(5.5, 7.5), pool: int = 2,
                narrow: bool = False, limits: Optional[Dict] = None) -> Path:
    """``tmp`` laid out as a checkout's root: ``BENCHMARK.json`` and
    ``perfbench/`` with the cell's mix cut to ``pool`` files of
    ``seconds`` and, with ``narrow``, the configuration at ``NARROW``."""
    bench = tmp / "perfbench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    cell = spec.cell(cell_name)
    mix_path = bench / "traffic" / f"{cell['traffic']}.json"
    mix = json.loads(mix_path.read_text())
    mix.update(pool=pool, sample=pool, length_s=dict(mix["length_s"], min=seconds[0],
                                                     max=seconds[1]))
    mix_path.write_text(json.dumps(mix))
    cfg_path = bench / "configs" / f"{cell['config']}.json"
    cfg = json.loads(cfg_path.read_text())
    if cfg["weights"]["kind"] == "npz":
        cfg["weights"]["path"] = str(spec.ROOT / cfg["weights"]["path"])
    if narrow:
        for part, keys in NARROW.items():
            cfg["geometry"][part].update(keys)
    cfg_path.write_text(json.dumps(cfg))
    if limits is not None:
        (bench / "limits" / f"{cell_name}.json").write_text(json.dumps(limits))
    return bench


def run(root: Path, cell_name: str, seed: int = 2 ** 33 + 11, seconds: float = 0.01,
        trace: int = 0) -> Dict:
    """One run of the cell on the CPU; its result line."""
    args = main.parse(["--workload", cell_name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.run_cell(args, time.time(), "cpu", root=root, bench_dir=root / "perfbench")
    assert rc == 0, rc
    return json.loads(out.getvalue().strip().splitlines()[-1])
