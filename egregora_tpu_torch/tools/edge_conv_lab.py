"""Time the VAE's one-channel edge convs and their rewrites on the card.

Counterpart of ``tools/edge_conv_lab.py``, with cuDNN in place of XLA and
the port's hand-written kernel added.  The decoder's final 3x3 conv to
one channel on [26, 512, 256, C] (C = 64, the tool's; 128, the published
checkpoints' decoder) and the encoder's first 3x3 conv from one channel
to 64 on [26, 512, 256, 1], bf16, channels last:

  dec-conv1     cuDNN conv, one output channel, as it is
  dec-conv128   the kernel zero-padded to 128 output channels, sliced
  dec-matmul    nine shifted [., C] @ [C] products, f32 accumulation
  dec-3x1d      three 3-tap 1D convs over M, one per F offset
  dec-kernel-fN the port's conv3x3_out1 (csrc/conv_edge.cu), f_tile N
  enc-conv      cuDNN conv, one input channel, as it is
  enc-matmul    nine shifted broadcasts times w[i, j, 0, :]

With ``--root DIR`` the kernel of the checkout at DIR (a parent unpacked
with ``git archive``, say) runs in the same process as
``other-dec-kernel-fN``; ``--batch`` sets B (26, the lab's; 3, one-shot's
chunk batch).  Candidates are timed in turns (each turn times every
candidate once); each line gives the median over ``--turns`` turns of
the time a call (CUDA events around ``--rounds`` launches after a
warm-up, the host's launch path included where it is slower than the
device), with ``--graph`` also the device time of a CUDA graph of those
calls, and max |d| against the plain version (the decoder's:
``conv3x3_out1_plain``; the encoder's: enc-matmul in f32).  Runs on the
card only:

    python -m egregora_tpu_torch.tools.edge_conv_lab [--rounds N] [--turns N] [--batch B]
        [--graph] [--root DIR] [variant names...]
"""
from __future__ import annotations

import argparse
import statistics
import sys

import torch
import torch.nn.functional as F

from .. import tools
from ..ops import conv_edge
from . import cuda_ms, graph_ms

B, FR, M = 26, 512, 256
DEC_CHANNELS = (64, 128)
F_TILES = (8, 16, 32, 64)


def _decoder_variants(x, w, bias, other=None):
    """(name, fn) of the decoder's conv: x [B, F, M, C] bf16, w [3, 3, C, 1];
    ``other``: another checkout's ``conv_edge`` module."""
    b, fr, m, c = x.shape
    xn = x.permute(0, 3, 1, 2)                                  # NCHW view, channels last
    w1 = w[..., 0].permute(2, 0, 1)[None].to(x.dtype)           # [1, C, 3, 3]
    w128 = F.pad(w1, (0, 0, 0, 0, 0, 0, 0, 127))
    b128 = F.pad(bias.to(x.dtype), (0, 127))

    def conv1():
        return F.conv2d(xn, w1, bias.to(x.dtype), padding=1).permute(0, 2, 3, 1)

    def conv128():
        return F.conv2d(xn, w128, b128, padding=1)[:, :1].permute(0, 2, 3, 1)

    def three_1d():
        rows = F.pad(x, (0, 0, 0, 0, 1, 1))                    # pad F
        out = None
        for i in range(3):
            r = rows[:, i:i + fr].reshape(-1, m, c).transpose(1, 2)
            y = F.conv1d(r, w1[:, :, i, :], padding=1).float()
            out = y if out is None else out + y
        return (out.reshape(b, fr, m) + bias.float()).unsqueeze(-1)

    variants = [("dec-conv1", conv1), ("dec-conv128", conv128),
                ("dec-matmul", lambda: conv_edge.conv3x3_out1_plain(x, w, bias)),
                ("dec-3x1d", three_1d)]
    for tag, mod in [("", conv_edge)] + ([("other-", other)] if other else []):
        variants += [(f"{tag}dec-kernel-f{ft}",
                      lambda ft=ft, mod=mod: mod.conv3x3_out1(x, w, bias, ft)) for ft in F_TILES]
    return variants


def _encoder_variants(x1, w64, bias64):
    """(name, fn) of the encoder's first conv: x1 [B, F, M, 1] bf16."""
    _, fr, m, _ = x1.shape
    xn = x1.permute(0, 3, 1, 2)
    wn = w64.permute(3, 2, 0, 1).to(x1.dtype).contiguous()     # [64, 1, 3, 3]

    def enc_matmul():
        xp = F.pad(x1[..., 0].float(), (1, 1, 1, 1))
        out = None
        for i in range(3):
            for j in range(3):
                tap = xp[:, i:i + fr, j:j + m, None] * w64[i, j, 0].to(x1.dtype).float()
                out = tap if out is None else out + tap
        return out + bias64

    return [("enc-conv", lambda: F.conv2d(xn, wn, bias64.to(x1.dtype), padding=1)
             .permute(0, 2, 3, 1)),
            ("enc-matmul", enc_matmul)]


def load_checkout(root) -> tuple:
    """``(conv_edge,)`` of the checkout at ``root``, beside this package's."""
    return tools.load_checkout(root, "conv_edge")


def sweep(rounds: int = 6, only=None, seed: int = 0, turns: int = 3, batch: int = B,
          graph: bool = False, other=None) -> list:
    """One row a (variant, C): name, ms (median of the turns), GB/s of x
    read once, max |d|; ``graph``: also the device time of a CUDA graph;
    ``other``: ``load_checkout``'s module, timed as ``other-``
    variants."""
    if not torch.cuda.is_available():
        raise RuntimeError("edge_conv_lab runs on a CUDA card; none is available")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []

    def run(cands, plain, nbytes, c):
        cands = [(name, fn) for name, fn in cands if not only or name in only]
        errs = {name: float((fn().float() - plain).abs().max()) for name, fn in cands}
        times = {name: ([], []) for name, _ in cands}
        for _ in range(turns):
            for name, fn in cands:
                times[name][0].append(cuda_ms(fn, rounds))
                if graph:
                    times[name][1].append(graph_ms(fn, rounds))
        for name, _ in cands:
            ms = statistics.median(times[name][0])
            gms = statistics.median(times[name][1]) if graph else None
            rows.append({"variant": name, "b": batch, "c": c, "ms": ms, "graph_ms": gms,
                         "gb_per_s": nbytes / ms / 1e6, "max_abs_err": errs[name],
                         "turns_ms": times[name][0]})
            dev = f", graph {gms:8.4f} ms" if graph else ""
            print(f"{name:22s} B={batch:<3d} C={c:<4d} {ms:8.4f} ms{dev} "
                  f"({nbytes / ms / 1e6:7.1f} GB/s)  |d|max vs plain {errs[name]:.3e}", flush=True)

    for c in DEC_CHANNELS:
        x = torch.randn(batch, FR, M, c, generator=gen, device="cuda").bfloat16()
        w = 0.1 * torch.randn(3, 3, c, 1, generator=gen, device="cuda")
        bias = torch.full((1,), 0.1, device="cuda")
        plain = conv_edge.conv3x3_out1_plain(x, w, bias)
        run(_decoder_variants(x, w, bias, other), plain, batch * FR * M * (2 * c + 4), c)
        del x, plain
    x1 = torch.randn(batch, FR, M, 1, generator=gen, device="cuda").bfloat16()
    w64 = 0.1 * torch.randn(3, 3, 1, 64, generator=gen, device="cuda")
    bias64 = torch.full((64,), 0.1, device="cuda")
    variants = _encoder_variants(x1, w64, bias64)
    run(variants, variants[1][1](), batch * FR * M * (2 + 64 * 2), 1)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--graph", action="store_true", help="also time CUDA graphs of the calls")
    ap.add_argument("--root", help="also time the kernel of the checkout at ROOT")
    ap.add_argument("names", nargs="*", help="variant names (default: all)")
    args = ap.parse_args(argv)
    print(f"device: {torch.cuda.get_device_name(0) if torch.cuda.is_available() else None}",
          flush=True)
    sweep(args.rounds, set(args.names), turns=args.turns, batch=args.batch, graph=args.graph,
          other=load_checkout(args.root)[0] if args.root else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
