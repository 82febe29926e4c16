"""One run of one cell: set-up, the measured window, the output check,
the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration names its system, ``perfbench/systems/<system>.py``
(``spec.system``), which the run drives through its interface alone.
Set-up (``setup_s``, from the process's start to the first timed call):
imports, the card, the traffic pool from the seed, the system built
(``build``; the port's CUDA library is built into its ``_build/`` on a
checkout's first run, then loaded), and a warm-up of the pool's shapes
(``warmup`` in the mix: one file of each distinct count of the system's
``rows``, "all", or the "extremes", largest and smallest), after which
the peak-memory counter is reset.  Then the window (``window.run``).
With ``--trace 1`` the window runs under ``torch.profiler`` (host and
CUDA activity) with the system's spans, and the line carries the
per-layer metrics, the device's busy and window seconds and the
breakdown; with ``--trace 0`` the end-to-end metrics.  After the window:
the peak memory, the check that no JAX module was loaded, the system
released, and the output comparison against the system's reference
(``check``), whose numbers and limits end standard error and the result
line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "egregora_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``egregora_tpu_torch`` is not ``egregora_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What the metric readers read (``perfbench/metrics/*.py``)."""
    cell: Dict
    config: Dict
    window: object                      # window.Window
    setup_s: float
    memory_peak_bytes: int
    device_name: str
    trace: Optional[object] = None      # trace.Reduced, traced runs
    attn_calls: Optional[list] = None   # (b, h, n, d, itemsize) per attention call, traced runs

    def peaks(self) -> Dict:
        from .flops import peaks
        return peaks(self.device_name)

    def rows_done(self) -> int:
        return sum(c.rows for c in self.window.calls if c.ok)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def warmup_items(pool, rows, mode: str):
    """One item of each distinct ``rows(item)`` in the pool, largest
    first: all of them, or with ``mode`` "extremes" the largest and the
    smallest."""
    by_rows = {}
    for item in pool:
        by_rows.setdefault(rows(item), item)
    rows = sorted(by_rows)
    if mode == "extremes":
        rows = [rows[-1], rows[0]] if len(rows) > 1 else rows
    else:
        rows = rows[::-1]
    return [by_rows[r] for r in rows]


def first_calls(calls) -> list:
    """(rows, first call's wall, median of the later calls' walls, count)
    for every size the window served more than once."""
    import statistics
    by_rows = {}
    for c in calls:
        by_rows.setdefault(c.rows, []).append(c.wall)
    return [(r, round(w[0], 4), round(statistics.median(w[1:]), 4), len(w))
            for r, w in sorted(by_rows.items()) if len(w) > 1]


def main(argv, t_start: float) -> int:
    """The benchmark's entry: a run on the card, or no result."""
    args = parse(argv)
    import torch

    from . import spec
    chips = int(spec.cell(args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        return fail(f"the cell asks for {chips} CUDA device(s); {have} available")
    return run_cell(args, t_start, "cuda")


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(args, t_start: float, device: str, root=None, bench_dir=None) -> int:
    """One run of the cell on ``device``; ``root`` and ``bench_dir`` hold
    ``BENCHMARK.json`` and the benchmark's files (the checkout's by
    default)."""
    import torch

    from . import check, spec, traffic, window

    root = root or spec.ROOT
    bench_dir = bench_dir or spec.BENCH_DIR
    cell = spec.cell(args.workload, root)
    system = spec.system(cell["config"], bench_dir)
    config = spec.config(cell["config"], bench_dir)
    mix = spec.traffic(cell["traffic"], bench_dir)
    lim = spec.limits(cell["name"], bench_dir)
    device_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"

    phases = [("imports", time.time() - t_start)]
    t = time.perf_counter()
    pool = traffic.make_pool(mix, args.seed, device)
    sample = check.sample_indices(traffic.sizes(mix), int(mix["sample"]), args.seed)
    phases.append(("traffic", time.perf_counter() - t))
    t = time.perf_counter()
    served = system.build(config, root, args.seed, device)
    _sync(device)
    phases.append(("pipeline", time.perf_counter() - t))
    warm = warmup_items(pool, served.rows, mix.get("warmup", "all"))
    warm_s = []
    for item in warm:
        s = time.perf_counter()
        served.call(item)
        _sync(device)
        warm_s.append((served.rows(item), time.perf_counter() - s))
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    spans = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spans = served.spans().install()
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if device == "cuda" else []))
        prof.__enter__()
        setup_s = time.time() - t_start
        with record_function("pb.window"):
            win = window.run(served, pool, args.seconds, set(sample))
            _sync(device)
        prof.__exit__(None, None, None)
        spans.uninstall()
    else:
        setup_s = time.time() - t_start
        win = window.run(served, pool, args.seconds, set(sample))
    _sync(device)
    memory_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0

    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", 3)

    ctx = Context(cell, config, win, setup_s, memory_peak, device_name)
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": device_name,
           "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    result: Dict = {}
    if args.trace:
        from . import trace as tr
        t = time.perf_counter()
        red = tr.reduce_window(prof, spans.NAMES)
        ctx.trace, ctx.attn_calls = red, spans.attn_calls
        print(f"trace: {len(red.dev)} device events, kinds {red.kinds}, reduced in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        dev["busy_s"] = red.busy_s
        dev["window_s"] = red.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in red.top_ops()],
                               "idle_gaps": [[n, s] for n, s in red.idle_gaps()]}
        del prof
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(cell["name"], kind, root):
        value = spec.reader(m["name"], bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    phases.append(("warm-up", sum(w for _, w in warm_s)))
    print(f"setup {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases)
          + f"; warm-up (rows, s) {[(r, round(w, 4)) for r, w in warm_s]}", file=sys.stderr)
    print(f"window: {len(win.calls)} calls, {ctx.rows_done()} rows, weight source "
          f"{served.weight_source}; first call at each size against its later ones (rows: first, "
          f"median of later, n): {first_calls(win.calls)}", file=sys.stderr)
    del served, spans
    system.release()

    done = [i for i in sample if i in win.outputs]
    by_index = {item.index: item for item in pool}
    t = time.perf_counter()
    refs = system.reference_outputs(config, root, args.seed, [by_index[i] for i in done],
                                    device, "fp32")
    files = [system.sums(win.outputs[i], r, device) for i, r in zip(done, refs)]
    verdict = check.judge(files, lim, system.NUMBERS, win.failed, len(sample))
    print(f"reference: {len(done)} file(s) in {time.perf_counter() - t:.1f} s"
          + (f"; {verdict.reason}" if verdict.reason else ""), file=sys.stderr)
    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", 3)

    line = {"correct": verdict.correct, "attempted": len(win.calls), "failed": win.failed,
            "metrics": metrics, "device": dev}
    line.update(result)
    line["checks"] = verdict.record()
    for text in verdict.lines():
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
