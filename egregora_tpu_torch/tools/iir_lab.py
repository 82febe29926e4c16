"""Time the port's K4 (``iir_lowpass``) at the eval path's shapes on the card.

The K-weighting low-pass at the meter's 300 s of 48 kHz stereo (2 x
14 400 000), the pair nodes' 60 s (2 x 2 880 000), a pole near 1 (1 x
4 194 304 at 0.9999), a ragged tile edge (3 x 32 769) and one short call
(1 x 100), float32:

  kernel   ``iir_lowpass`` (csrc/iir_lowpass.cu)
  plain    ``iir_lowpass_plain``, the blocked recurrence (timed once)

With ``--root DIR`` the kernel of the checkout at DIR (a parent unpacked
with ``git archive``, say) runs in the same process as ``other-kernel``.
Candidates are timed in turns (each turn times every candidate once);
each line gives the median over ``--turns`` turns of two times a call:
CUDA events around ``--rounds`` back-to-back calls after a warm-up (the
host's launch path included where it is slower than the kernel) and the
device time of a CUDA graph of those calls (the host path excluded); GB/s
at 8 bytes a sample; the share of the bytes bound (3.35 TB/s); max |d|
against the plain version.  Runs on the card only:

    python -m egregora_tpu_torch.tools.iir_lab [--rounds N] [--turns N] [--root DIR]
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys

import torch

from .. import tools
from ..ops import iir_lowpass
from . import cuda_ms, graph_ms

K48 = math.exp(-2.0 * math.pi * 60.0 / 24000.0)      # K-weighting pole at 48 kHz
SHAPES = [("meter", 2, 14_400_000, K48), ("pair", 2, 2_880_000, K48),
          ("pole-0.9999", 1, 4_194_304, 0.9999), ("ragged", 3, 32_769, K48),
          ("short", 1, 100, K48)]
HBM_BYTES_PER_S = 3.35e12


def load_checkout(root) -> tuple:
    """``(iir_lowpass,)`` of the checkout at ``root``, beside this package's."""
    return tools.load_checkout(root, "iir_lowpass")


def sweep(rounds: int = 20, turns: int = 3, seed: int = 0, other=None) -> list:
    """One row a (shape, candidate): shape, C, N, pole, candidate, ms
    (back-to-back) and graph ms (medians of the turns), GB/s, share of the
    bound, max |d| against the plain version."""
    if not torch.cuda.is_available():
        raise RuntimeError("iir_lab runs on a CUDA card; none is available")
    designs = [("", iir_lowpass)] + ([("other-", *other)] if other else [])
    rows = []
    for name, c, n, k in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(seed + n)
        x = 0.5 * torch.randn(c, n, generator=gen, device="cuda")
        plain = iir_lowpass.iir_lowpass_plain(x, k)
        cands = [(f"{tag}kernel", lambda mod=mod: mod.iir_lowpass(x, k)) for tag, mod in designs]
        errs = {cand: float((fn() - plain).abs().max()) for cand, fn in cands}
        times = {cand: ([], []) for cand, _ in cands}
        for _ in range(turns):
            for cand, fn in cands:
                times[cand][0].append(cuda_ms(fn, rounds))
                times[cand][1].append(graph_ms(fn, rounds))
        plain_ms = cuda_ms(lambda: iir_lowpass.iir_lowpass_plain(x, k), 1)
        bound_ms = 8.0 * c * n / HBM_BYTES_PER_S * 1e3
        for cand, _ in cands:
            ms, gms = (statistics.median(t) for t in times[cand])
            row = {"shape": name, "c": c, "n": n, "k": k, "candidate": cand, "ms": ms,
                   "graph_ms": gms, "gb_per_s": 8.0 * c * n / gms / 1e6,
                   "bound_ms": bound_ms, "bound_share": bound_ms / gms,
                   "max_abs_err": errs[cand], "turns_ms": times[cand][0],
                   "turns_graph_ms": times[cand][1], "plain_ms": plain_ms}
            rows.append(row)
            print(f"{name:12s} [{c},{n}] {cand:13s} {ms:8.4f} ms, graph {gms:8.4f} ms "
                  f"({row['gb_per_s']:6.0f} GB/s, {100 * row['bound_share']:5.1f}% of the bound "
                  f"{bound_ms:.4f} ms)  |d|max vs plain {errs[cand]:.3e}; plain {plain_ms:.3f} ms",
                  flush=True)
        del x, plain
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--root", help="also time the kernel of the checkout at ROOT")
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0) if torch.cuda.is_available() else None}",
          flush=True)
    sweep(args.rounds, args.turns, other=load_checkout(args.root) if args.root else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
