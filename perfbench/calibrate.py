"""The readings the limits of a cell's output comparison are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 [--faults 3]

For each seed, in one process on the card: the cell's traffic pool and
system as a run makes them, the system called on the run's sample of
files (one client, back to back: the cell's own load and sizes), then,
with the program released, the system's reference in "fp32" and its
control (``reference_outputs`` in "control": the reference a step below
the precision the configuration states) on the same files.  Printed a line a seed:
the worst reading of each number for the program (sound runs: the lower
reading) and for the control (the upper reading), each number pooled
over the sample as a run pools it (and the worst single file beside it),
and on the first ``--faults`` seeds each of the system's planted faults'
(``FAULTS``).  The last line sums them up.  The benchmark's own runs
never run this.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import run as entry  # noqa: E402


def calibrate(cell_name: str, seeds, n_faults: int, device: str = "cuda", root=None,
              bench_dir=None) -> dict:
    import torch

    from perfbench.harness import check, spec, traffic

    root, bench_dir = root or spec.ROOT, bench_dir or spec.BENCH_DIR
    cell = spec.cell(cell_name, root)
    system = spec.system(cell["config"], bench_dir)
    config, mix = spec.config(cell["config"], bench_dir), spec.traffic(cell["traffic"], bench_dir)
    numbers = system.NUMBERS
    fault_names = ()
    per_seed = []
    for k, seed in enumerate(seeds):
        t = time.perf_counter()
        pool = {item.index: item for item in traffic.make_pool(mix, seed, device)}
        sample = check.sample_indices(traffic.sizes(mix), int(mix["sample"]), seed)
        items = [pool[i] for i in sample]
        served = system.build(config, root, seed, device)
        fault_names = served.FAULTS
        outs = {"program": [served.call(it) for it in items]}
        for name in fault_names if k < n_faults else ():
            served.plant(name)
            outs[name] = [served.call(it) for it in items]
            served.undo()
        del served
        system.release()
        refs = system.reference_outputs(config, root, seed, items, device, "fp32")
        # the control's outputs, as the program would hand them back, held against the reference
        outs["control"] = [ref[0] for ref in system.reference_outputs(config, root, seed, items,
                                                                       device, "control")]
        row = {"seed": seed}
        for what, ys in outs.items():
            files = [system.sums(y, r, device) for y, r in zip(ys, refs)]
            row[what] = check.pooled(files, numbers)
            row[what + "_worst_file"] = {n: max(check.pooled([f], numbers)[n] for f in files)
                                         for n in numbers}
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        per_seed.append(row)
    summary = {"cell": cell_name, "seeds": len(seeds),
               "device": torch.cuda.get_device_name(0) if device == "cuda" else device}
    for n in numbers:
        lower = max(r["program"][n] for r in per_seed)
        upper = min(r["control"][n] for r in per_seed)
        summary[n] = {"lower": lower, "upper": upper, "ratio": upper / lower,
                      "worst_file_lower": max(r["program_worst_file"][n] for r in per_seed),
                      "worst_file_upper": min(r["control_worst_file"][n] for r in per_seed)}
        for f in fault_names:
            vals = [r[f][n] for r in per_seed if f in r]
            if vals:
                summary[n][f] = min(vals)
    return summary


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--faults", type=int, default=3)
    a = p.parse_args()
    entry.environment()
    print(json.dumps(calibrate(a.workload, [int(s) for s in a.seeds.split(",")], a.faults)))
