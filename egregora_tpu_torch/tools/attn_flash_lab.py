"""Schedule sweep of the port's attention kernels at the FlashSR shapes.

Counterpart of ``tools/attn_flash_lab.py``: the whole-row kernel
(``attn_rows``, the port of ``flash_rows``) against the online-softmax
kernel (``flash_online``) at every tile it is built for, with SDPA
(``torch.nn.functional.scaled_dot_product_attention``) as the yardstick,
at the VAE mid block (26 x 8192 x 256: 26 chunks, one head of 256), the
UNet's ds=2 attention (208 x 2048 x 32: 26 chunks of 8 heads) and the
published checkpoints' VAE mid block (26 x 8192 x 512), bf16, and at
any ``--shape BHxNxD`` given (the main path's one-chunk-batch shapes,
say).  With ``--root DIR`` it also times the kernels of the checkout at
DIR (a parent unpacked with ``git archive``, say) in the same process, as
``other-`` candidates beside this checkout's.  Each line gives the time
per call (CUDA events around ``--rounds`` back-to-back calls after a
warm-up: the host's launch path included where it is slower than the
kernel), TFLOP/s and max |d| against the kernel's plain version.  Runs
on the card only:

    python -m egregora_tpu_torch.tools.attn_flash_lab [--rounds N] [--shape BHxNxD ...]
        [--root DIR] [shape names...]
"""
from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from .. import tools
from ..ops import attn_flash, attn_rows
from ..ops.attn_rows import attn_rows_plain
from . import cuda_ms

SHAPES = [("vae-mid", 26, 8192, 256), ("unet-ds2", 208, 2048, 32),
          ("vae-mid-published", 26, 8192, 512)]
HEADS = {"vae-mid": 1, "unet-ds2": 8, "vae-mid-published": 1}


def load_checkout(root) -> tuple:
    """``(attn_flash, attn_rows)`` of the checkout at ``root``, beside this
    package's (``tools.load_checkout``)."""
    return tools.load_checkout(root, "attn_flash", "attn_rows")


def sweep(rounds: int = 6, names=None, seed: int = 0, extra=(), other=None) -> list:
    """One row a (shape, candidate): name, ms, TFLOP/s, max |d|.
    ``extra``: more (bh, n, d) shapes, run after the named ones;
    ``other``: ``load_checkout``'s modules, timed as ``other-``
    candidates."""
    if not torch.cuda.is_available():
        raise RuntimeError("attn_flash_lab runs on a CUDA card; none is available")
    designs = [("", attn_flash, attn_rows)] + ([("other-", *other)] if other else [])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    shapes = [s for s in SHAPES if not names or s[0] in names]
    shapes += [(f"{bh}x{n}x{d}", bh, n, d) for bh, n, d in extra]
    for name, bh, n, d in shapes:
        q, k, v = (torch.randn(bh, n, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        flops = 4.0 * bh * n * n * d
        plain_rows = attn_rows_plain(q, k, v).float()
        plain_online = attn_flash.flash_online_plain(q, k, v).float()
        heads = HEADS.get(name, 1)
        q4, k4, v4 = (t.view(bh // heads, heads, n, d) for t in (q, k, v))
        cands = [("sdpa", lambda: F.scaled_dot_product_attention(q4, k4, v4).view(bh, n, d),
                  plain_rows)]
        for tag, af, ar in designs:
            cands.append((f"{tag}rows", lambda ar=ar: ar.attn_rows(q, k, v), plain_rows))
            bqs, bks = af.BF16_TILES[d]
            for bq in bqs:
                for bk in bks:
                    cands.append((f"{tag}online-q{bq}k{bk}",
                                  lambda af=af, bq=bq, bk=bk: af.flash_online(q, k, v, bq, bk),
                                  plain_online))
        for cname, fn, plain in cands:
            err = float((fn().float() - plain).abs().max())
            ms = cuda_ms(fn, rounds)
            rows.append({"shape": name, "bh": bh, "n": n, "d": d, "candidate": cname,
                         "ms": ms, "tflops": flops / ms / 1e9, "max_abs_err": err})
            print(f"{name:17s} {cname:22s} {ms:9.4f} ms ({flops / ms / 1e9:6.1f} TFLOP/s)"
                  f"  |d|max vs plain {err:.3e}", flush=True)
        del q, k, v, q4, k4, v4, plain_rows, plain_online
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--shape", action="append", default=[], metavar="BHxNxD",
                    help="a further shape (repeatable)")
    ap.add_argument("--root", help="also time the kernels of the checkout at ROOT")
    ap.add_argument("names", nargs="*", help=f"shapes: {[s[0] for s in SHAPES]}")
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0) if torch.cuda.is_available() else None}",
          flush=True)
    extra = [tuple(int(x) for x in s.lower().split("x")) for s in args.shape]
    sweep(args.rounds, set(args.names) if args.names or not extra else {""}, extra=extra,
          other=load_checkout(args.root) if args.root else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
