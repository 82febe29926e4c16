"""Time the port's MRF kernels against the module path on the card.

At the six main-path shapes of one HiFi-GAN MRF block (kernels 3, 7, 11,
dilations 1, 3, 5; B = 3 chunks, bf16) and at any ``--shape CxT`` given:

  module   ``MRF.forward``: cuDNN convs, the module path (no single
           PyTorch call computes an MRF block)
  fused    ``mrf_fused_cm`` on [B, C, T]: every branch in one launch
  rows     ``mrf_branch_rows`` on [B, T, C]: the three branch launches

With ``--root DIR`` the kernels of the checkout at DIR (a parent unpacked
with ``git archive``, say) run in the same process as ``other-fused`` and
``other-rows``.  Candidates are timed in turns (each turn times every
candidate once, CUDA events around ``--rounds`` back-to-back calls after
a warm-up); each line gives the median over ``--turns`` turns, TFLOP/s
(252 C^2 T B FLOPs a block) and max |d| against the entry's plain
version.  Runs on the card only:

    python -m egregora_tpu_torch.tools.mrf_lab [--rounds N] [--turns N]
        [--batch B] [--shape CxT ...] [--root DIR]
"""
from __future__ import annotations

import argparse
import statistics
import sys

import torch

from .. import tools
from ..models.flashsr.layers import seeded_init_
from ..models.flashsr.vocoder import MRF
from ..ops import mrf_fused, mrf_rows
from . import cuda_ms

# (C, T) of the vocoder's MRF blocks on the main paths: the served HiFi-GAN
# trio's three stages, the full config's and the converted trio's
SHAPES = [(64, 5120), (32, 40960), (16, 245760), (64, 245760), (128, 40960), (256, 5120)]
KERNELS, DILS = (3, 7, 11), (1, 3, 5)


def load_checkout(root) -> tuple:
    """``(mrf_fused, mrf_rows)`` of the checkout at ``root``, beside this
    package's (``tools.load_checkout``)."""
    return tools.load_checkout(root, "mrf_fused", "mrf_rows")


def block(c: int, seed: int) -> MRF:
    """A bf16 ``MRF`` of width C on the card, seeded weights and biases."""
    gen = torch.Generator().manual_seed(seed)
    m = MRF(c, KERNELS, (DILS,) * 3, torch.bfloat16)
    seeded_init_(m, gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return m.to("cuda")


def sweep(rounds: int = 5, turns: int = 3, shapes=None, batch: int = 3, seed: int = 0,
          other=None) -> list:
    """One row a (shape, candidate): C, T, B, candidate, ms (median of the
    turns), TFLOP/s, max |d| against the plain version (None for the
    module path).  ``other``: ``load_checkout``'s modules, timed as
    ``other-`` candidates."""
    if not torch.cuda.is_available():
        raise RuntimeError("mrf_lab runs on a CUDA card; none is available")
    designs = [("", mrf_fused, mrf_rows)] + ([("other-", *other)] if other else [])
    rows = []
    for c, t in shapes or SHAPES:
        m = block(c, seed + c)
        w, bias = mrf_fused.pack_resblock_weights(m, torch.bfloat16)
        branch_w = mrf_fused.branch_weights(w, c, KERNELS, len(DILS))
        gen = torch.Generator().manual_seed(seed + c + t)
        x = (0.5 * torch.randn(batch, c, t, generator=gen)).to("cuda", torch.bfloat16)
        xr = x.transpose(1, 2).contiguous()
        plain_cm = mrf_fused.mrf_fused_cm_plain(x, w, bias, KERNELS, DILS).float()
        plain_rows = sum(mrf_rows.mrf_branch_rows_plain(xr, wb, bias[i], DILS)
                         for i, wb in enumerate(branch_w)).float().transpose(1, 2) / len(KERNELS)
        cands = [("module", lambda: m(x), None, None)]
        for tag, mf, mr in designs:
            cands.append((f"{tag}fused",
                          lambda mf=mf: mf.mrf_fused_cm(x, w, bias, KERNELS, DILS),
                          lambda mf=mf: mf.mrf_fused_cm(x, w, bias, KERNELS, DILS), plain_cm))
            cands.append((f"{tag}rows",
                          lambda mr=mr: [mr.mrf_branch_rows(xr, wb, bias[i], DILS)
                                         for i, wb in enumerate(branch_w)],
                          lambda mr=mr: mr.mrf_rows(xr, w, bias, KERNELS, DILS).transpose(1, 2),
                          plain_rows))
        errs = {name: None if plain is None else float((whole().float() - plain).abs().max())
                for name, _, whole, plain in cands}
        times = {name: [] for name, *_ in cands}
        for _ in range(turns):
            for name, fn, *_ in cands:
                times[name].append(cuda_ms(fn, rounds))
        flops = sum(2.0 * 2 * len(DILS) * k * c * c * t * batch for k in KERNELS)
        for name, *_ in cands:
            ms = statistics.median(times[name])
            row = {"c": c, "t": t, "b": batch, "candidate": name, "ms": ms,
                   "tflops": flops / ms / 1e9, "max_abs_err": errs[name], "turns_ms": times[name]}
            rows.append(row)
            err = "" if errs[name] is None else f"  |d|max vs plain {errs[name]:.3e}"
            print(f"{c:4d}x{t:<7d} B={batch} {name:12s} {ms:9.4f} ms "
                  f"({row['tflops']:6.1f} TFLOP/s){err}", flush=True)
        del x, xr, plain_cm, plain_rows, m
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--shape", action="append", default=[], metavar="CxT",
                    help="a shape to time instead of the main-path ones (repeatable)")
    ap.add_argument("--root", help="also time the kernels of the checkout at ROOT")
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0) if torch.cuda.is_available() else None}",
          flush=True)
    shapes = [tuple(int(v) for v in s.lower().split("x")) for s in args.shape] or None
    sweep(args.rounds, args.turns, shapes, args.batch,
          other=load_checkout(args.root) if args.root else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
