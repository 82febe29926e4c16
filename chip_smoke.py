#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``egregora_tpu_torch``) on one
NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each on standard output:

1. the card's name and power limit (``nvidia-smi``); the builds of the
   five sources under ``egregora_tpu_torch/csrc/`` (``attn_rows``,
   ``mrf``, ``iir_lowpass``, ``attn_online``, ``conv_edge``), one
   ``nvcc`` each, at once;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at a ragged length, beside planted
   faults that the limits must reject, with the kernel's, the plain
   version's and (attention) the library call's or (MRF) the module
   path's times:
   - ``attn_rows`` (including the published VAE mid block, 3 x 8192 x
     512): relative L2 1e-2 and two bf16 ulps of the largest output;
     fault: the last key tile dropped;
   - ``mrf_fused_cm`` and ``mrf_rows`` (every branch of an MRF block in
     one launch, or one a launch), at the served and the full config's
     stages (C = 16 to 256): relative L2 1e-2 and four bf16 ulps, over
     the block and over its first and last 120 samples; faults: the
     per-layer re-zeroing outside the signal skipped, the last
     dilation's residual dropped;
3. the repaired shapes: ``attn_rows`` at head sizes 24, 40 and 320
   (bf16) and in float32 (D up to 512), the MRF entries at C = 8 and 24
   (bf16) and in float32 (float32 limits: relative L2 and max |d| 1e-5
   of the largest output), with the same planted faults; the upscaler
   node on a ``channel_floor=8`` HiFi-GAN config with the fused vocoder;
4. K4 (``iir_lowpass``) against its plain version and float64 ``lfilter``
   (max |d| 2e-6) at the meter's 300 s of 48 kHz stereo and at ragged
   and near-unit-pole shapes; fault: the cross-tile carry dropped;
5. K1b (``flash_online``) at the attention lab's shapes and a ragged N
   (bf16 limits; fault: the last key tile dropped) and K3
   (``conv3x3_out1``) at the decoders' C = 24/64/128, the edge lab's
   shapes, ragged F and M and its tile edges (float32 limits; fault: the
   bottom halo row dropped), with SDPA's or cuDNN's time;
6. a reference check of the full config (seeded weights) on one chunk:
   bf16 on the card against float32 arithmetic on the CPU with the same
   weights, and against the card pipeline with float32 plain attention
   (decoded mel, vocoder wave, the output's band above the crossover),
   and each attention call against the float32 plain version on its own
   inputs; the attention fault must fail every limit;
7. the ``EgregoraAudioUpscaler`` node on a comfy AUDIO dict (a seeded
   12 s, 16 kHz signal, 3 chunks, to 48 kHz) with the shipped weights:
   the HiFi-GAN trio with the fused MRF kernel, the same trio with the
   rows kernel (``EGREGORA_MRF_PATH=rows``), and the default istft trio;
   one-shot through ``run`` and streaming (``max_batch=2``), with every
   kernel's launches counted by shape around each run; the kernels'
   vocoder wave against the module path's;
8. the same reference check for one chunk of each shipped trio, with
   its own planted fault;
9. the full-config pipeline (seeded weights) one-shot and streaming, with
   the attention launches counted by shape;
10. the node on a converted reference trio at the published geometry: a
   seeded upstream-layout ``.pth`` trio (weight-norm pairs in the
   vocoder) in a temporary ``EGREGORA_TPU_WEIGHTS``, resolved as
   "converted", on the module-path, fused and rows vocoders, with
   ``attn_rows`` counted at D = 512 and the MRF kernels at C = 256/128/64;
   one chunk bf16 on the card against float32 on the CPU beside the
   attention fault;
11. the eval-pack and null-suite nodes at real sizes (the meter on 300 s
   of 48 kHz stereo, the pair nodes on 60 s with a planted 37.25-sample
   delay and -3 dB gain), each held to the same code on the CPU, with
   K4's calls counted by shape and the warm wall time of each node;
12. the two lab tools once (``tools/attn_flash_lab.py``,
   ``tools/edge_conv_lab.py``), where K1b and K3 launch;
13. a JSON line ``{"kernels": [...]}`` of all six kernels, whose times
   are the per-shape times of phases 2, 4 and 5 times the launches that
   phases 7, 9, 10, 11 and 12 counted, and, last, ``{"ok": true, ...}``.

Any failure exits non-zero and prints no ``"ok"`` line.  With no CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 rate, H100 SXM
SECONDS = 12.0               # test signal: 3 chunks of 5.12 s at 48 kHz
BATCH = 3                    # chunks in the one-shot batch of that signal
# attention calls of one chunk batch on the main path: (heads, N, D) -> calls
PATH_CALLS = {(8, 2048, 32): 5, (8, 512, 64): 6, (1, 8192, 256): 2}
# and in the served trios' StudentUNet: one call, mid block, 4 heads
SERVED_ATTN = (4, 512, 32)
# the published checkpoints' VAE mid block: one head of 512 (2 calls a
# batch); their UNet's attention is PATH_CALLS's
CONVERTED_MID = (1, 8192, 512)
RAGGED = [(8, 1000, 32), (8, 1000, 64), (1, 1000, 256)]
KEY_TILE = 64                # keys per K/V tile of csrc/attn_rows.cu
ATTN_REL_L2 = 1e-2           # kernel vs plain, relative L2 over the output


# egregora_tpu_torch/csrc/<name>.cu
SOURCES = ("attn_rows", "mrf", "iir_lowpass", "attn_online", "conv_edge")


def timed_build(name: str) -> float:
    """Seconds to build ``csrc/<name>.cu`` (nvcc)."""
    from egregora_tpu_torch.utils import cuda_build
    t = time.perf_counter()
    cuda_build.build(name)
    return time.perf_counter() - t


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def bf16_agreement(got, ref):
    """``(ok, rel_l2, max |d|, max-|d| limit)`` of a bf16 result against
    its plain version.  Both round their output to bf16 once, so sound
    runs differ by at most an ulp here and there: the limits are a
    relative L2 of ``ATTN_REL_L2`` and two bf16 ulps of ``max |ref|``
    (bf16 keeps 8 significant bits: ulp(m) = 2^(floor(log2 m) - 7))."""
    import math
    ref_max = float(ref.float().abs().max())
    limit = 2.0 ** (math.floor(math.log2(ref_max)) - 6) if ref_max > 0 else 0.0
    err = float((got.float() - ref.float()).abs().max())
    rel = rel_l2(got.float(), ref.float())
    ok = bool(got.float().isfinite().all()) and rel <= ATTN_REL_L2 and err <= limit
    return ok, rel, err, limit


# float32 kernels against their float32 plain versions: both sum in
# float32 in other orders, so sound runs differ by a few ulps of the
# values summed; relative L2 and max |d| over max |plain| within F32_REL
F32_REL = 1e-5


def f32_agreement(got, ref):
    """``(ok, rel_l2, max |d|)`` of a float32 result against its plain
    version: relative L2 and max |d| / max |ref| within ``F32_REL``."""
    ref_max = float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    rel = rel_l2(got.float(), ref.float())
    ok = bool(got.isfinite().all()) and rel <= F32_REL and err <= F32_REL * ref_max
    return ok, rel, err


# K4 against its plain version (or float64 lfilter) on a signal of scale
# ~0.5: max |d| within IIR_ABS.  The float32 recurrence drifts ~1e-7 from
# float64 (the plain version's blocks) and ~1e-8 (the kernel's 16-sample
# runs); a dropped cross-tile carry reads 1e-2 and more
IIR_ABS = 2e-6


def iir_agreement(got, ref):
    """``(ok, max |d|)`` of an IIR low-pass result against a reference."""
    err = float((got.double() - ref.double()).abs().max())
    return bool(got.isfinite().all()) and err <= IIR_ABS, err


def drop_last_tile(q, k, v):
    """A planted fault: attention that skips the last K/V tile (what a
    kernel that loses its tail tile computes), from the plain version."""
    from egregora_tpu_torch.ops.attention import chunked_attention
    m = (k.shape[1] - 1) // KEY_TILE * KEY_TILE
    return chunked_attention(q, k[:, :m].contiguous(), v[:, :m].contiguous())


def attention_phase() -> list:
    """attn_rows against its plain version at the FlashSR path shapes of
    one-shot's chunk batch (BATCH items) and at ragged N, beside the
    planted fault ``drop_last_tile``, which the limits must reject."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops.attention import chunked_attention

    gen = torch.Generator().manual_seed(0)
    rows = []
    for heads, n, d in list(PATH_CALLS) + [SERVED_ATTN, CONVERTED_MID] + RAGGED:
        bh = BATCH * heads
        q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", torch.bfloat16)
                   for _ in range(3))
        got = ar.attn_rows(q, k, v)
        torch.cuda.synchronize()
        plain = chunked_attention(q, k, v)
        ok, rel, err, limit = bf16_agreement(got, plain)
        bad_ok, bad_rel, bad_err, _ = bf16_agreement(drop_last_tile(q, k, v), plain)
        flops = 4.0 * bh * n * n * d
        nbytes = 4.0 * bh * n * d * 2
        bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / H100_BF16_FLOPS >= nbytes / H100_BYTES_PER_S else "bytes"
        reps = max(3, min(50, int(2e11 / flops)))
        ms = cuda_ms(lambda: ar.attn_rows(q, k, v), reps)
        plain_ms = cuda_ms(lambda: chunked_attention(q, k, v), max(2, reps // 4), 1)
        q4, k4, v4 = (t.view(BATCH, heads, n, d) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
        row = {"bh": bh, "n": n, "d": d, "max_abs_err": err, "rel_l2": rel,
               "max_abs_limit": limit, "planted_max_abs_err": bad_err,
               "planted_rel_l2": bad_rel, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / ms / 1e9}
        rows.append(row)
        log(f"attn_rows [{bh},{n},{d}]: vs plain max|d| {err:.3e} (limit {limit:.3e}), "
            f"rel L2 {rel:.3e} (limit {ATTN_REL_L2:g}) {'ok' if ok else 'FAIL'}; "
            f"planted fault (last key tile dropped) max|d| {bad_err:.3e}, rel L2 "
            f"{bad_rel:.3e} {'rejected' if not bad_ok else 'NOT REJECTED'}; "
            f"kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not ok:
            raise RuntimeError(f"attn_rows disagrees with its plain version at "
                               f"[{bh},{n},{d}]: max |d| {err}, rel L2 {rel}")
        if bad_ok:
            raise RuntimeError(f"the attention limits do not reject a dropped last "
                               f"key tile at [{bh},{n},{d}]")
        del q, k, v, got, plain
    return rows


def attn_entry(rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's attn_rows entry: times and bound of the
    launches the main paths' one-shot runs made, shape by shape as
    ``counts`` measured them (``by_path``: launches of each run)."""
    by_shape = {(r["bh"], r["n"], r["d"]): r for r in rows}

    def total(key):
        return sum(by_shape[s][key] * c for s, c in counts.items())

    ops_ms = sum(4.0 * bh * n * n * d * c for (bh, n, d), c in counts.items()) \
        / H100_BF16_FLOPS * 1e3
    byte_ms = sum(8.0 * bh * n * d * c for (bh, n, d), c in counts.items()) \
        / H100_BYTES_PER_S * 1e3
    return {
        "name": "attn_rows", "route": "cuda",
        "source": "egregora_tpu_torch/csrc/attn_rows.cu",
        "replaces": "egregora_tpu/ops/attn_pallas.py:92",
        "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(ops_ms, byte_ms),
        "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
        "library_ms": total("library_ms"),
        "launches_by_shape": {f"{bh}x{n}x{d}": c for (bh, n, d), c in counts.items()},
        "launches_by_path": by_path,
        "shapes": rows,
    }


def mrf_entry(name: str, rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's entry of an MRF kernel: ``counts`` maps (b,
    c, t) to the blocks the main path ran (one launch a block for
    mrf_fused_cm, one a branch for mrf_rows); times are the measured
    per-shape times of phase 2 at B = 3 (every counted launch is at B=3);
    the module path's time is kept beside them, as no single PyTorch call
    computes an MRF block."""
    by_shape = {(r["b"], r["c"], r["t"]): r for r in rows if r["entry"] == name}
    per_block = 1 if name == "mrf_fused_cm" else len(MRF_KERNELS)

    def total(key):
        return sum(by_shape[s][key] * n / per_block for s, n in counts.items())

    bounds = [mrf_bound_ms(c, t, b, [MRF_KERNELS] if per_block == 1
                           else [(k,) for k in MRF_KERNELS])[0] * n / per_block
              for (b, c, t), n in counts.items()]
    ops = sum(mrf_flops(c, t, b) * n / per_block for (b, c, t), n in counts.items())
    byte = sum(4.0 * b * c * t * n for (b, c, t), n in counts.items())
    return {
        "name": name, "route": "cuda", "source": "egregora_tpu_torch/csrc/mrf.cu",
        "replaces": ("egregora_tpu/ops/mrf_pallas.py:203" if name == "mrf_fused_cm"
                     else "egregora_tpu/ops/mrf_rows.py:128"),
        "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["entry"] == name),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": sum(bounds),
        "bound_by": ("operations" if ops / H100_BF16_FLOPS >= byte / H100_BYTES_PER_S
                     else "bytes"),
        "library_ms": None, "module_path_ms": total("module_ms"),
        "launches_by_shape": {"x".join(map(str, s)): n for s, n in counts.items()},
        "launches_by_path": by_path,
        "shapes": [r for r in rows if r["entry"] == name],
    }


# MRF blocks of the vocoder on the main paths, one-shot (B = 3 chunks):
# (C, T) -> where.  The served HiFi-GAN trio's three stages and the full
# config's last stage (the one of C <= 64)
MRF_SHAPES = {(64, 5120): "HiFi-GAN trio, stage 1", (32, 40960): "HiFi-GAN trio, stage 2",
              (16, 245760): "HiFi-GAN trio, stage 3", (64, 245760): "full config, stage 3",
              (256, 5120): "full config, stage 1", (128, 40960): "full config, stage 2"}
MRF_RAGGED_T = 5000
MRF_KERNELS, MRF_DILS = (3, 7, 11), (1, 3, 5)
MRF_HALO = 60                # per-side reach of the k=11 branch
# max |d| limits of the MRF checks, in bf16 ulps of max |plain|: each
# conv rounds its output, so a sum-order flip of one ulp early in a
# branch's six convs reaches the output as up to two (the sound reading
# on an H100); the planted faults read 22 ulps and more (PERF.md)
MRF_ULPS = 4


def mrf_flops(c: int, t: int, b: int, kernels=MRF_KERNELS) -> float:
    """Two FLOPs a multiply-add, 2 convs x 3 dilations a branch."""
    return sum(2.0 * 2 * len(MRF_DILS) * k * c * c * t * b for k in kernels)


def mrf_bound_ms(c: int, t: int, b: int, launches_kernels) -> tuple:
    """(bound ms, bound_by) of launches each reading its [B, C, T] bf16
    input once and writing its output once; ``launches_kernels`` lists
    the branch kernel sizes each launch computes."""
    ops_s = sum(mrf_flops(c, t, b, ks) for ks in launches_kernels) / H100_BF16_FLOPS
    byte_s = len(launches_kernels) * 4.0 * b * c * t / H100_BYTES_PER_S
    return max(ops_s, byte_s) * 1e3, "operations" if ops_s >= byte_s else "bytes"


def mrf_module(c: int, seed: int, dtype=None):
    """A port ``MRF`` at width C in ``dtype`` (bf16 by default) with
    seeded weights and biases."""
    import torch

    from egregora_tpu_torch.models.flashsr.layers import seeded_init_
    from egregora_tpu_torch.models.flashsr.vocoder import MRF
    gen = torch.Generator().manual_seed(seed)
    m = MRF(c, MRF_KERNELS, (MRF_DILS,) * 3, dtype or torch.bfloat16)
    seeded_init_(m, gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return m


def mrf_planted(x_cm, w, bias, fault: str, round_then_bias: bool):
    """A planted fault of the MRF block on ``[B, C, T]``, from plain
    PyTorch: ``"no_rezero"`` runs the chains on the signal zero-extended
    by the halo without re-zeroing each layer outside [0, T) (what a
    kernel that skips its per-layer mask computes near the edges);
    ``"drop_residual"`` leaves the last dilation's residual add out of
    every branch."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops.mrf_fused import _conv, _leaky, branch_weights
    c, t = x_cm.shape[1], x_cm.shape[2]
    pad = MRF_HALO if fault == "no_rezero" else 0
    xe = F.pad(x_cm, (pad, pad))
    acc = None
    for bi, wb in enumerate(branch_weights(w, c, MRF_KERNELS, len(MRF_DILS))):
        h = xe
        for m, d in enumerate(MRF_DILS):
            a = _conv(_leaky(h), wb[m, 0], bias[bi, m, 0], d, round_then_bias)
            a = _conv(_leaky(a), wb[m, 1], bias[bi, m, 1], 1, round_then_bias)
            if not (fault == "drop_residual" and m == len(MRF_DILS) - 1):
                h = h + a
        acc = h if acc is None else acc + h
    return (acc / len(MRF_KERNELS))[..., pad: pad + t]


def mrf_agreement(got, ref):
    """A bf16 MRF block against its plain version: relative L2 within
    ``ATTN_REL_L2``, max |d| within ``MRF_ULPS`` bf16 ulps of max |ref|
    over the whole block and, separately, over the first and last 2*halo
    samples: an error confined to the edges barely moves a relative L2
    over 245760 samples.  ``(ok, rel_l2, max |d|, edge max |d|, limit)``."""
    import math
    ref_max = float(ref.float().abs().max())
    limit = MRF_ULPS * 2.0 ** (math.floor(math.log2(ref_max)) - 7) if ref_max > 0 else 0.0
    d = (got.float() - ref.float()).abs()
    err, rel = float(d.max()), rel_l2(got.float(), ref.float())
    e = 2 * MRF_HALO
    edge = float(max(d[..., :e].max(), d[..., -e:].max()))
    ok = bool(got.float().isfinite().all()) and rel <= ATTN_REL_L2 and max(err, edge) <= limit
    return ok, rel, err, edge, limit


def mrf_phase() -> list:
    """Both MRF entry points of ``csrc/mrf.cu`` against their plain
    versions on the card, at the main paths' shapes and at a ragged T,
    beside two planted faults that the limits must reject; times of the
    kernel, the plain version and the module path (``MRF.forward``'s
    cuDNN convs, the same function with the module's rounding)."""
    import torch

    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr

    shapes = list(MRF_SHAPES) + [(c, MRF_RAGGED_T) for c in (16, 32, 64)]
    rows, failures = [], []
    for c, t in shapes:
        m = mrf_module(c, seed=c).to("cuda")
        w, bias = mf.pack_resblock_weights(m, torch.bfloat16)
        gen = torch.Generator().manual_seed(t + c)
        x = (0.5 * torch.randn(BATCH, c, t, generator=gen)).to("cuda", torch.bfloat16)
        x_rows = x.transpose(1, 2).contiguous()
        flops = mrf_flops(c, t, BATCH)
        branch_w = mf.branch_weights(w, c, MRF_KERNELS, len(MRF_DILS))
        for entry in ("mrf_fused_cm", "mrf_rows"):
            if entry == "mrf_fused_cm":
                def run():
                    return mf.mrf_fused_cm(x, w, bias, MRF_KERNELS, MRF_DILS)

                def plain():
                    return mf.mrf_fused_cm_plain(x, w, bias, MRF_KERNELS, MRF_DILS)
                launch_fns = [run]
                circ, launches_kernels = True, [MRF_KERNELS]
            else:        # mrf_rows: one mrf_branch_rows launch a branch, then the mean
                def run():
                    return mr.mrf_rows(x_rows, w, bias, MRF_KERNELS, MRF_DILS).transpose(1, 2)

                def plain():
                    acc = None
                    for bi, wb in enumerate(branch_w):
                        h = mr.mrf_branch_rows_plain(x_rows, wb, bias[bi], MRF_DILS)
                        acc = h if acc is None else acc + h
                    return (acc / len(MRF_KERNELS)).transpose(1, 2)
                launch_fns = [lambda bi=bi: mr.mrf_branch_rows(x_rows, branch_w[bi], bias[bi],
                                                               MRF_DILS)
                              for bi in range(len(MRF_KERNELS))]
                circ, launches_kernels = False, [(k,) for k in MRF_KERNELS]
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            ok, rel, err, edge, limit = mrf_agreement(got, ref)
            planted = {}
            for fault in ("no_rezero", "drop_residual"):
                bad = mrf_planted(x, w, bias, fault, round_then_bias=circ)
                b_ok, b_rel, b_err, b_edge, _ = mrf_agreement(bad, ref)
                planted[fault] = {"ok": b_ok, "rel_l2": b_rel, "max_abs_err": b_err,
                                  "edge_max_abs_err": b_edge}
            reps = max(2, min(20, int(2e11 / flops)))
            launch_ms = [cuda_ms(fn, reps) for fn in launch_fns]
            ms = sum(launch_ms)
            plain_ms = cuda_ms(plain, max(1, reps // 4), 1)
            module_ms = cuda_ms(lambda: m(x), max(1, reps // 2), 1)
            bound_ms, bound_by = mrf_bound_ms(c, t, BATCH, launches_kernels)
            row = {"entry": entry, "b": BATCH, "c": c, "t": t,
                   "where": MRF_SHAPES.get((c, t), "ragged T"), "max_abs_err": err,
                   "edge_max_abs_err": edge, "rel_l2": rel, "max_abs_limit": limit,
                   "planted": planted, "ms": ms, "launch_ms": launch_ms,
                   "plain_ms": plain_ms,
                   "module_ms": module_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": flops / ms / 1e9}
            rows.append(row)
            rejected = all(not p["ok"] for p in planted.values())
            log(f"{entry} [{BATCH},{c},{t}] ({row['where']}): vs plain max|d| {err:.3e}, "
                f"edges {edge:.3e} (limit {limit:.3e}), rel L2 {rel:.3e} (limit "
                f"{ATTN_REL_L2:g}) {'ok' if ok else 'FAIL'}; planted "
                + ", ".join(f"{f}: rel L2 {p['rel_l2']:.3e} max|d| {p['max_abs_err']:.3e} "
                            f"edges {p['edge_max_abs_err']:.3e}" for f, p in planted.items())
                + f" {'rejected' if rejected else 'NOT REJECTED'}; kernel {ms:.4f} ms "
                f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, module path "
                f"(cuDNN) {module_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                failures.append(f"{entry} disagrees with its plain version at "
                                f"[{BATCH},{c},{t}]: rel L2 {rel}, max |d| {err}, edges {edge}")
            if not rejected:
                failures.append(f"the MRF limits do not reject a planted fault at "
                                f"{entry} [{BATCH},{c},{t}]: {planted}")
            del got, ref
        del x, x_rows, m
    if failures:
        raise RuntimeError("; ".join(failures))
    return rows


def test_signal(seconds: float, sr: int, seed: int):
    """Seeded harmonic test signal with a little noise, peak 0.5."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = np.zeros_like(t)
    for h in range(1, 30):
        f = 196.0 * h
        if f >= sr / 2:
            break
        x += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) / h
    x += 0.01 * rng.standard_normal(t.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)[None, :]


# relative L2 limits of the full config in bf16 on the card against
# float32 arithmetic on the CPU, one chunk, seeded weights: each lies
# between the sound reading (1.61e-2, 1.55e-2, 2.14e-2) and the planted
# fault's (2.26e-2, 2.08e-2, 2.88e-2) on an H100 (PERF.md, Findings)
REF_LIMITS = {"mel_hr": 1.9e-2, "wave": 1.8e-2, "high_band": 2.5e-2}
# relative L2 limits of the same comparison with attention the only
# difference: the card's bf16 pipeline through attn_rows against the same
# card pipeline whose attention is the plain version in float32; each
# lies between the sound reading (1.93e-2, 1.92e-2, 2.65e-2) and that of
# every attention dropping its last key tile (2.61e-2, 2.46e-2, 3.40e-2)
# on an H100 (PERF.md, Findings).  The bf16 layers after each attention
# carry any change of its rounding to ~2% of the output, so this gap is
# no wider than the CPU comparison's; the per-call check below is wide
ATTN_ONLY_LIMITS = {"mel_hr": 2.25e-2, "wave": 2.15e-2, "high_band": 3.0e-2}
# each attention call of that chunk against the float32 plain version on
# its own inputs, relative L2: the kernel reads at most 1.7e-3, the
# dropped last key tile at least 5.6e-3 (the path's softmax rows are
# peaked, so the last 64 keys carry little weight in some calls) on an H100
ATTN_CALL_LIMIT = 3e-3


def reference_phase() -> None:
    """The full config on one chunk, seeded weights: bf16 on the card
    (through the kernel) against float32 arithmetic on the CPU (plain
    versions) with the same weights (rounded to bf16), and against the
    same card pipeline with its attention in float32 (the plain version):
    the second comparison sees the attention kernel alone.
    Compared: the decoded mel, the vocoder's wave and the output's band
    above the crossover (what the model adds; below it the output is the
    input).  A planted fault, every attention dropping its last key tile,
    gives the control reading, which the limits must reject."""
    import dataclasses

    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.ops import attention

    def cfg(dtype):
        c = P.FlashSRConfig()
        return dataclasses.replace(c, **{k: dataclasses.replace(getattr(c, k), dtype=dtype)
                                         for k in ("vae", "unet", "vocoder")})

    x = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=2)[:, :P.CHUNK_SAMPLES])

    def outputs(pipe):
        t = time.perf_counter()
        mel, wav = pipe.synthesize(x.to(pipe.device))
        y = pipe.chunk_forward(x)
        high = y - P.lowpass_fir(y, P.REQ_SR, pipe.cfg.crossover_hz)
        log(f"reference: one chunk on {pipe.device.type}: {time.perf_counter() - t:.1f} s")
        return {"mel_hr": mel.float().cpu(), "wave": wav.float().cpu(),
                "high_band": high.float().cpu()}

    cpu = P.FlashSRPipeline(cfg(torch.float32), seed=1, device="cpu")
    with torch.no_grad():     # the card's weights: the same draw, rounded to bf16
        for m in cpu.modules.all():
            for p in m.parameters():
                p.copy_(p.bfloat16().float())
    ref = outputs(cpu)
    card = P.FlashSRPipeline(cfg(torch.bfloat16), seed=1, device="cuda")
    sound = outputs(card)
    kernel = attention.attn_rows
    calls = []

    def f32_attention(q, k, v):
        return attention.chunked_attention(q.float(), k.float(), v.float())

    def checked(q, k, v):
        """The kernel, held on the spot to the float32 plain version on the
        pipeline's own inputs, beside the dropped last key tile."""
        got = kernel(q, k, v)
        ref32 = f32_attention(q, k, v)
        calls.append((tuple(q.shape), rel_l2(got.float(), ref32),
                      rel_l2(drop_last_tile(q, k, v).float(), ref32)))
        return got

    try:
        attention.attn_rows = checked
        outputs(card)
        attention.attn_rows = drop_last_tile
        planted = outputs(card)
        attention.attn_rows = lambda q, k, v: f32_attention(q, k, v).to(q.dtype)
        attn_ref = outputs(card)
    finally:
        attention.attn_rows = kernel
    failures = []
    good = max(c[1] for c in calls)
    bad = min(c[2] for c in calls)
    log(f"reference attention per call ({len(calls)} calls of one chunk, shapes "
        f"{sorted(set(c[0] for c in calls))}): attn_rows vs float32 plain on the same inputs, "
        f"relative L2 at most {good:.3e} (limit {ATTN_CALL_LIMIT:g}) "
        f"{'ok' if good <= ATTN_CALL_LIMIT else 'FAIL'}; planted fault (last key tile dropped) "
        f"at least {bad:.3e} {'rejected' if bad > ATTN_CALL_LIMIT else 'NOT REJECTED'}")
    if not good <= ATTN_CALL_LIMIT:
        failures.append(f"attention per call: {good}")
    if not bad > ATTN_CALL_LIMIT:
        failures.append("attention per call: the dropped key tile passes")
    for label, limits, base in (("bf16 card vs f32 cpu", REF_LIMITS, ref),
                                ("attention only: attn_rows vs f32 plain on the card",
                                 ATTN_ONLY_LIMITS, attn_ref)):
        for key, limit in limits.items():
            good, bad = rel_l2(sound[key], base[key]), rel_l2(planted[key], base[key])
            log(f"reference {key}, {label}: relative L2 {good:.3e} (limit {limit:g}) "
                f"{'ok' if good <= limit else 'FAIL'}; planted fault (last key tile dropped) "
                f"{bad:.3e} {'rejected' if bad > limit else 'NOT REJECTED'}")
            if not good <= limit:
                failures.append(f"{label}: {key} reads {good}")
            if not bad > limit:
                failures.append(f"{label}: the {key} limit does not reject a dropped last key tile")
    if failures:
        raise RuntimeError("; ".join(failures))


def reset_counts() -> None:
    """Every kernel's launch counts to 0."""
    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.ops import iir_lowpass as il
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    for mod in (ar, mf, mr, il, af, ce):
        mod.launches = 0
        mod.launches_by_shape.clear()


def read_counts() -> dict:
    """Launches since ``reset_counts`` by kernel and shape; mrf_rows's
    (b, t, c) shapes are given as (b, c, t), as mrf_fused_cm's."""
    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import conv_edge as ce
    from egregora_tpu_torch.ops import iir_lowpass as il
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    return {"attn_rows": dict(ar.launches_by_shape),
            "mrf_fused_cm": dict(mf.launches_by_shape),
            "mrf_rows": {(b, c, t): n for (b, t, c), n in mr.launches_by_shape.items()},
            "iir_lowpass": dict(il.launches_by_shape),
            "flash_online": dict(af.launches_by_shape),
            "conv3x3_out1": dict(ce.launches_by_shape)}


def set_env(**values) -> None:
    """Set (a string) or unset (None) the port's environment switches."""
    import os
    for key, val in values.items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val


def shipped_trio(name: str):
    """(config, state dicts) of a shipped trio; a missing file fails."""
    from egregora_tpu_torch.models.flashsr import distill
    path = distill.SHIPPED_DIR / name
    loaded = distill.load_pretrained_with_cfg(path)
    if loaded is None:
        raise RuntimeError(f"the shipped weights {path} are missing")
    return loaded


def unscaled_attention(q, k, v):
    """A planted fault: attention without its D^-1/2 score scale, from
    the plain version."""
    from egregora_tpu_torch.ops.attention import chunked_attention
    return chunked_attention(q * q.shape[-1] ** 0.5, k, v)


def planted_mrf(x, w, bias, kernels, dils):
    """``mrf_fused_cm`` with the last dilation's residual dropped."""
    return mrf_planted(x, w, bias, "drop_residual", round_then_bias=True)


# relative L2 limits of each shipped trio in bf16 on the card (the
# HiFi-GAN trio through the fused MRF kernel) against float32 arithmetic
# on the CPU with the card's bf16-rounded weights, one chunk; each lies
# between the sound reading and the planted fault's (PERF.md, Findings)
SERVED_REF_LIMITS = {
    "pretrained.npz": {"mel_hr": 9e-3, "wave": 0.1, "high_band": 0.35},
    "pretrained_istft.npz": {"mel_hr": 9e-3, "wave": 2.5e-3, "high_band": 3e-2},
}


def served_reference_phase() -> dict:
    """One chunk of each shipped trio, bf16 on the card against float32
    arithmetic on the CPU with the same (bf16-rounded) weights: the
    decoded mel, the vocoder's wave and the output's band above the
    crossover.  The planted fault, which the limits must reject: the
    attention without its score scale and, in the HiFi-GAN trio, the
    fused MRF without its last dilation's residual.  The HiFi-GAN trio's
    module-path vocoder is read beside it (bf16's own share)."""
    import dataclasses

    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.ops import attention

    x = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=2)[:, :P.CHUNK_SAMPLES])

    def outputs(pipe):
        mel, wav = pipe.synthesize(x.to(pipe.device))
        y = pipe.chunk_forward(x)
        high = y - P.lowpass_fir(y, P.REQ_SR, pipe.cfg.crossover_hz)
        return {"mel_hr": mel.float().cpu(), "wave": wav.float().cpu(),
                "high_band": high.float().cpu()}

    readings, failures = {}, []
    for name in SERVED_REF_LIMITS:
        cfg, sd = shipped_trio(name)
        f32 = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k),
                                                                 dtype=torch.float32)
                                          for k in ("vae", "unet", "vocoder")})
        rounded = {m: {k: v.bfloat16().float() for k, v in d.items()} for m, d in sd.items()}
        t = time.perf_counter()
        ref = outputs(P.FlashSRPipeline(f32, params=rounded, device="cpu"))
        log(f"served reference {name}: one chunk f32 on the CPU {time.perf_counter() - t:.1f} s")
        card = P.FlashSRPipeline(cfg, params=sd, device="cuda")
        hifigan = cfg.vocoder.kind == "hifigan"
        fault = "unscaled attention" + (", MRF residual dropped" if hifigan else "")
        set_env(EGREGORA_FUSED_VOCODER="1", EGREGORA_MRF_PATH=None)
        try:
            sound = outputs(card)
            real = attention.attn_rows, V.mrf_fused_cm
            attention.attn_rows = unscaled_attention
            if hifigan:
                V.mrf_fused_cm = planted_mrf
            try:
                planted = outputs(card)
            finally:
                attention.attn_rows, V.mrf_fused_cm = real
            if hifigan:
                set_env(EGREGORA_FUSED_VOCODER=None)
                module = outputs(card)
                log(f"served reference {name}: the module-path vocoder (cuDNN) in bf16 "
                    "reads " + ", ".join(f"{key} {rel_l2(module[key], ref[key]):.3e}"
                                         for key in ref))
        finally:
            set_env(EGREGORA_FUSED_VOCODER=None)
        for key, limit in SERVED_REF_LIMITS[name].items():
            good, bad = rel_l2(sound[key], ref[key]), rel_l2(planted[key], ref[key])
            readings[f"{name}:{key}"] = (good, bad)
            log(f"served reference {name} {key}: bf16 card vs f32 cpu relative L2 {good:.3e} "
                f"(limit {limit:g}) {'ok' if good <= limit else 'FAIL'}; planted fault "
                f"({fault}) {bad:.3e} {'rejected' if bad > limit else 'NOT REJECTED'}")
            if not good <= limit:
                failures.append(f"{name}: card and CPU disagree on {key}: {good}")
            if not bad > limit:
                failures.append(f"{name}: the {key} limit does not reject the planted fault")
        del card
    if failures:
        raise RuntimeError("; ".join(failures))
    return readings


# the node's paths, one-shot on the 12 s input (BATCH = 3 chunks): label,
# trio, switches, launches by kernel and shape
NODE_PATHS = [
    ("HiFi-GAN trio, fused MRF", "hifigan",
     {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": None},
     {"mrf_fused_cm": {(1, 64, 5120): 1, (1, 32, 40960): 1, (1, 16, 245760): 1}}),
    ("HiFi-GAN trio, rows MRF", "hifigan",
     {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": "rows"},
     {"mrf_rows": {(1, 64, 5120): 3, (1, 32, 40960): 3, (1, 16, 245760): 3}}),
    ("istft trio (default)", "",
     {"EGREGORA_FUSED_VOCODER": None, "EGREGORA_MRF_PATH": None}, {}),
]
# one-shot (pcm16 wire, batch 3) against streaming (float32, batches of
# 2) on the node's paths, relative L2: the bf16 convs of the VAE and the
# UNet take other cuDNN algorithms at another batch size, so the decoded
# mel moves by a bf16 ulp (0.094 at |mel| ~ 8 on an H100), and the
# input by the wire's step; the served trios carry that to 1.5e-2
# (HiFi-GAN, max |d| 0.24) and 1.3e-2 (istft, whose phase features of
# the empty band above 8 kHz follow rounding noise).  A chunk stitched
# in the wrong place reads ~1.
NODE_STREAM_REL_L2 = 5e-2
# relative L2 limit of the fused vocoder's wave against its module path
# (bf16 on the card, one chunk), between the sound reading and that of
# the planted fault (PERF.md, Findings)
FUSED_WAVE_LIMIT = 2e-2


def expected_counts(per_item: dict, b: int, batches: int) -> dict:
    """A path's launches at batch ``b`` over ``batches`` chunk batches,
    from its per-batch launches at batch 1 (the attention adds one
    ``SERVED_ATTN`` call a batch)."""
    heads, n, d = SERVED_ATTN
    out = {"attn_rows": {(b * heads, n, d): batches}, "mrf_fused_cm": {}, "mrf_rows": {},
           "iir_lowpass": {}, "flash_online": {}, "conv3x3_out1": {}}
    for kernel, shapes in per_item.items():
        out[kernel] = {(b, c, t): k * batches for (_, c, t), k in shapes.items()}
    return out


def node_phase() -> dict:
    """The ``EgregoraAudioUpscaler`` node on a comfy AUDIO dict (the
    seeded 12 s 16 kHz signal to 48 kHz) on each path of ``NODE_PATHS``,
    one-shot through ``run`` and streaming (``max_batch=2``) through the
    node's pipeline, with every kernel's launches counted by shape; the
    fused and rows vocoders against the module path on one chunk's wave,
    beside the planted fault."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.nodes import super_resolution
    from egregora_tpu_torch.nodes.base import to_buffer

    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    sr_in, sr_out = 16000, 48000
    x = test_signal(SECONDS, sr_in, seed=0)
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": sr_in}
    n_out = int(SECONDS * sr_out)
    results, trio = {}, None
    for label, variant, switches, per_item in NODE_PATHS:
        set_env(EGREGORA_FLASHSR_VARIANT=variant, **switches)
        if variant != trio:
            node_cls._PIPE = None
            trio = variant
        node = node_cls()
        t = time.perf_counter()
        pipe = node._pipeline()
        want = "distilled" if variant == "hifigan" else "distilled-istft"
        if pipe.weight_source != want or pipe.device.type != "cuda":
            raise RuntimeError(f"{label}: the node resolved {pipe.weight_source} on "
                               f"{pipe.device}, not the shipped {want} trio on the card")
        log(f"node {label}: pipeline ({pipe.weight_source}, {pipe.cfg.vocoder.kind} "
            f"vocoder) ready in {time.perf_counter() - t:.1f} s")
        one = None
        for run_no in ("cold", "warm"):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (out,) = node.run(audio, lowpass_input=False, output_sr=str(sr_out))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = read_counts()
            one = out["waveform"].numpy()
            finite = bool(np.isfinite(one).all())
            log(f"node {label} one-shot ({run_no}): {wall:.3f} s wall, RTF "
                f"{SECONDS / wall:.1f}x real time, out {one.shape} @ {out['sample_rate']} Hz, "
                f"finite {finite}, launches {counts}")
            if one.shape != (1, 1, n_out) or not finite or out["sample_rate"] != sr_out:
                raise RuntimeError(f"node {label}: bad output {one.shape}, finite={finite}")
            expect = expected_counts(per_item, BATCH, 1)
            if counts != expect:
                raise RuntimeError(f"node {label}: launches {counts}, expected {expect}")
        results[label] = {"wall_s": wall, "rtf": SECONDS / wall, "counts": counts}
        reset_counts()
        t = time.perf_counter()
        stream = pipe.process(to_buffer(audio), output_sr=sr_out, max_batch=2).numpy()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        counts_s = read_counts()
        expect = expected_counts(per_item, 2, 2)
        diff = float(np.abs(one[0] - stream).max())
        rel = rel_l2(torch.from_numpy(stream), torch.from_numpy(one[0]))
        log(f"node {label} streaming max_batch=2: {wall_s:.3f} s wall, launches {counts_s}; "
            f"one-shot vs streaming relative L2 {rel:.3e} (limit {NODE_STREAM_REL_L2:g}), "
            f"max|d| {diff:.3e}")
        if counts_s != expect:
            raise RuntimeError(f"node {label} streaming: launches {counts_s}, expected {expect}")
        if stream.shape != (1, n_out) or not rel <= NODE_STREAM_REL_L2:
            raise RuntimeError(f"node {label}: one-shot and streaming disagree: {rel}")
        results[label]["streaming_wall_s"] = wall_s
        if variant == "hifigan":      # the kernels' vocoder against the module path
            chunk = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=3)).to("cuda")
            wav = pipe.synthesize(chunk)[1]
            set_env(EGREGORA_FUSED_VOCODER=None)
            module = pipe.synthesize(chunk)[1]
            set_env(**switches)
            rel = rel_l2(wav.float(), module.float())
            line = (f"node {label}: vocoder wave vs the module path relative L2 {rel:.3e} "
                    f"(limit {FUSED_WAVE_LIMIT:g})")
            if switches["EGREGORA_MRF_PATH"] is None:
                real, V.mrf_fused_cm = V.mrf_fused_cm, planted_mrf
                try:
                    bad = rel_l2(pipe.synthesize(chunk)[1].float(), module.float())
                finally:
                    V.mrf_fused_cm = real
                line += (f"; planted fault (last dilation's residual dropped) {bad:.3e} "
                         f"{'rejected' if bad > FUSED_WAVE_LIMIT else 'NOT REJECTED'}")
                if not bad > FUSED_WAVE_LIMIT:
                    raise RuntimeError(f"the fused-wave limit does not reject the planted fault")
                results[label]["planted_wave_rel_l2"] = bad
            log(line)
            if not rel <= FUSED_WAVE_LIMIT:
                raise RuntimeError(f"node {label}: the vocoder wave is {rel} from the module path")
            results[label]["wave_rel_l2"] = rel
    set_env(EGREGORA_FLASHSR_VARIANT=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
    node_cls._PIPE = None
    return results


def pipeline_phase() -> dict:
    import numpy as np
    import torch

    from egregora_tpu_torch.core.audio import AudioBuffer
    from egregora_tpu_torch.models.flashsr.pipeline import (
        CHUNK_SAMPLES, HOP_SAMPLES, FlashSRConfig, FlashSRPipeline)
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops.wola import num_chunks

    sr_in, sr_out = 16000, 48000
    x = test_signal(SECONDS, sr_in, seed=0)
    n_out = int(SECONDS * sr_out)
    k = num_chunks(n_out, CHUNK_SAMPLES, HOP_SAMPLES)
    if k != BATCH:
        raise RuntimeError(f"the test signal makes {k} chunks, not {BATCH}")
    t0 = time.perf_counter()
    pipe = FlashSRPipeline(FlashSRConfig(), seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in pipe.modules.all() for p in m.parameters())
    log(f"pipeline: full config, {n_params / 1e6:.1f}M params from seed 0 "
        f"in {time.perf_counter() - t0:.1f} s; input {SECONDS:g} s @ {sr_in} Hz "
        f"-> {k} chunks @ {sr_out} Hz")

    def run(max_batch):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.process(AudioBuffer(x, sr_in), output_sr=sr_out,
                           max_batch=max_batch).numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        if counts["mrf_fused_cm"] or counts["mrf_rows"]:
            raise RuntimeError(f"the full config's module-path vocoder launched {counts}")
        return out, wall, ar.launches, counts["attn_rows"]

    results = {}
    for label, b, batches in (("one-shot", k, 1), ("streaming max_batch=2", 2, -(-k // 2))):
        expect = {(b * h, n, d): c * batches for (h, n, d), c in PATH_CALLS.items()}
        for run_no in ("cold", "warm"):      # the first call sets up cuDNN/cuBLAS
            out, wall, launches, counts = run(None if b == k else b)
            finite = bool(np.isfinite(out).all())
            log(f"pipeline {label} ({run_no}): {wall:.3f} s wall, RTF "
                f"{SECONDS / wall:.1f}x real time, out {out.shape}, finite {finite}, "
                f"attn_rows launches {launches} by (bh, n, d) {counts}")
            if out.shape != (1, n_out) or not finite:
                raise RuntimeError(f"pipeline {label}: bad output {out.shape}, "
                                   f"finite={finite}")
            if counts != expect or launches != sum(expect.values()):
                raise RuntimeError(f"pipeline {label}: attn_rows launches {launches} "
                                   f"{counts}, expected {expect}")
        results[label] = (out, launches, counts)
    one, stream = results["one-shot"][0], results["streaming max_batch=2"][0]
    diff = float(np.abs(one - stream).max())
    log(f"pipeline one-shot vs streaming: max|d| {diff:.3e}")
    if diff > 5e-2:
        raise RuntimeError(f"one-shot and streaming disagree: max |d| {diff}")
    return {"launches": results["one-shot"][1], "counts": results["one-shot"][2],
            "launches_streaming": results["streaming max_batch=2"][1]}


def kernel_agreement(got, ref):
    """``(ok, rel_l2, max |d|, max-|d| limit)``: ``bf16_agreement`` for a
    bf16 result, ``f32_agreement``'s limits for a float32 one."""
    import torch
    if got.dtype == torch.bfloat16:
        return bf16_agreement(got, ref)
    ok, rel, err = f32_agreement(got, ref)
    return ok, rel, err, F32_REL * float(ref.float().abs().max())


def bound(flops: float, nbytes: float, peak: float) -> tuple:
    """(bound ms, bound_by): the larger of operations at ``peak`` and
    bytes at the HBM rate."""
    ops_s, byte_s = flops / peak, nbytes / H100_BYTES_PER_S
    return max(ops_s, byte_s) * 1e3, "operations" if ops_s >= byte_s else "bytes"


# the repaired kernels' new shapes: attention (bh, n, d, dtype) -- the
# legacy geometry's mid block (4 heads of 24 at B = 3), a ragged head
# size, float32, head sizes above 256 (320 is padded to 512; 512 runs
# 32 q rows a block in bf16, 16 in float32); MRF (c, t, dtype) at B = 3 -- channel_floor=8 and C = 24
# in bf16 (padded to 16 and 32 channels), C = 16 in float32
REPAIR_ATTN = [(12, 512, 24, "bfloat16"), (8, 1000, 40, "bfloat16"), (12, 512, 32, "float32"),
               (2, 1000, 320, "bfloat16"), (1, 2048, 512, "float32"), (2, 300, 320, "float32")]
REPAIR_MRF = [(8, 40960, "bfloat16"), (24, 40960, "bfloat16"), (16, 40960, "float32")]


def repair_phase() -> dict:
    """``attn_rows`` and both MRF entries at the shapes and dtypes they
    refused before (head sizes outside 32/64/256, C not a multiple of 16,
    float32), each against its plain version beside the planted faults;
    then the ``EgregoraAudioUpscaler`` node on a ``channel_floor=8``
    HiFi-GAN config with the fused vocoder."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    from egregora_tpu_torch.ops.attention import chunked_attention

    attn, mrf, failures = [], [], []
    gen = torch.Generator().manual_seed(5)
    for bh, n, d, dt in REPAIR_ATTN:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", dtype) for _ in range(3))
        got = ar.attn_rows(q, k, v)
        torch.cuda.synchronize()
        plain = chunked_attention(q, k, v)
        ok, rel, err, limit = kernel_agreement(got, plain)
        bad_ok, bad_rel, bad_err, _ = kernel_agreement(drop_last_tile(q, k, v), plain)
        size = q.element_size()
        bound_ms, bound_by = bound(4.0 * bh * n * n * d, 4.0 * bh * n * d * size,
                                   H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
        ms = cuda_ms(lambda: ar.attn_rows(q, k, v), 20)
        plain_ms = cuda_ms(lambda: chunked_attention(q, k, v), 5, 1)
        heads = 4 if d == 24 else max(1, bh // BATCH)
        q4, k4, v4 = (t.view(-1, heads, n, d) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        row = {"bh": bh, "n": n, "d": d, "dtype": dt, "max_abs_err": err, "rel_l2": rel,
               "max_abs_limit": limit, "planted_rel_l2": bad_rel, "planted_max_abs_err": bad_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        attn.append(row)
        log(f"repair attn_rows [{bh},{n},{d}] {dt}: vs plain max|d| {err:.3e} (limit "
            f"{limit:.3e}), rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}; planted fault (last key "
            f"tile dropped) max|d| {bad_err:.3e}, rel L2 {bad_rel:.3e} "
            f"{'rejected' if not bad_ok else 'NOT REJECTED'}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        if not ok:
            failures.append(f"attn_rows [{bh},{n},{d}] {dt} disagrees: {rel}, {err}")
        if bad_ok:
            failures.append(f"attn_rows [{bh},{n},{d}] {dt}: the planted fault passes")

    for c, t, dt in REPAIR_MRF:
        dtype = getattr(torch, dt)
        m = mrf_module(c, seed=c, dtype=dtype).to("cuda")
        w, bias = mf.pack_resblock_weights(m, dtype)
        g = torch.Generator().manual_seed(t + c)
        x = (0.5 * torch.randn(BATCH, c, t, generator=g)).to("cuda", dtype)
        x_rows = x.transpose(1, 2).contiguous()
        branch_w = mf.branch_weights(w, c, MRF_KERNELS, len(MRF_DILS))

        def agree(got, ref):
            if dtype == torch.bfloat16:
                ok, rel, err, edge, limit = mrf_agreement(got, ref)
                return ok, rel, max(err, edge), limit
            return kernel_agreement(got, ref)

        def rows_plain():
            acc = None
            for bi, wb in enumerate(branch_w):
                h = mr.mrf_branch_rows_plain(x_rows, wb, bias[bi], MRF_DILS)
                acc = h if acc is None else acc + h
            return (acc / len(MRF_KERNELS)).transpose(1, 2)

        for entry, run, plain, circ in (
                ("mrf_fused_cm", lambda: mf.mrf_fused_cm(x, w, bias, MRF_KERNELS, MRF_DILS),
                 lambda: mf.mrf_fused_cm_plain(x, w, bias, MRF_KERNELS, MRF_DILS), True),
                ("mrf_rows", lambda: mr.mrf_rows(x_rows, w, bias, MRF_KERNELS,
                                                 MRF_DILS).transpose(1, 2), rows_plain, False)):
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            ok, rel, err, limit = agree(got, ref)
            planted = {f: agree(mrf_planted(x, w, bias, f, round_then_bias=circ), ref)
                       for f in ("no_rezero", "drop_residual")}
            rejected = all(not p[0] for p in planted.values())
            flops = mrf_flops(c, t, BATCH)
            launches = 1 if entry == "mrf_fused_cm" else len(MRF_KERNELS)
            bound_ms, bound_by = bound(flops, launches * 2.0 * BATCH * c * t * x.element_size(),
                                       H100_BF16_FLOPS if dtype == torch.bfloat16
                                       else H100_F32_FLOPS)
            ms = cuda_ms(run, 5)
            plain_ms = cuda_ms(plain, 2, 1)
            module_ms = cuda_ms(lambda: m(x), 3, 1)
            row = {"entry": entry, "b": BATCH, "c": c, "t": t, "dtype": dt, "max_abs_err": err,
                   "rel_l2": rel, "max_abs_limit": limit,
                   "planted": {f: {"rel_l2": p[1], "max_abs_err": p[2]} for f, p in planted.items()},
                   "ms": ms, "plain_ms": plain_ms, "module_ms": module_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "tflops": flops / ms / 1e9}
            mrf.append(row)
            log(f"repair {entry} [{BATCH},{c},{t}] {dt}: vs plain max|d| {err:.3e} (limit "
                f"{limit:.3e}), rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}; planted "
                + ", ".join(f"{f}: rel L2 {p[1]:.3e} max|d| {p[2]:.3e}" for f, p in planted.items())
                + f" {'rejected' if rejected else 'NOT REJECTED'}; kernel {ms:.4f} ms "
                f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, module path "
                f"{module_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if not ok:
                failures.append(f"{entry} [{BATCH},{c},{t}] {dt} disagrees: {rel}, {err}")
            if not rejected:
                failures.append(f"{entry} [{BATCH},{c},{t}] {dt}: a planted fault passes")
        del x, x_rows, m
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"attn": attn, "mrf": mrf, "node": narrow_node_run()}


def narrow_node_run() -> dict:
    """The upscaler node on a seeded narrow HiFi-GAN config whose vocoder
    stages all have ``channel_floor=8`` channels, bf16, with the fused
    vocoder (``EGREGORA_FUSED_VOCODER=1``): every stage through
    ``mrf_fused_cm`` padded to 16 channels, the StudentUNet's 4-head mid
    attention at D = 8 through ``attn_rows``; its vocoder wave against the
    module path's."""
    import numpy as np
    import torch

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr import unet as U
    from egregora_tpu_torch.models.flashsr import vocoder as V
    from egregora_tpu_torch.nodes import super_resolution

    cfg = P.FlashSRConfig(
        vae=P.VAEConfig(base_channels=8, channel_mults=(1, 2, 4), latent_channels=16,
                        num_res_blocks=1, groups=4, mid_attn=False, use_quant_conv=False),
        unet=U.UNetConfig(base_channels=16, channel_mults=(1, 2, 2), num_res_blocks=1,
                          attn_levels=(), num_heads=4, time_dim=32, groups=4),
        vocoder=V.VocoderConfig(upsample_initial=16, channel_floor=8))
    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    node_cls._PIPE = pipe = P.FlashSRPipeline(cfg, seed=0, device="cuda")
    x = test_signal(SECONDS, 16000, seed=0)
    set_env(EGREGORA_FUSED_VOCODER="1", EGREGORA_MRF_PATH=None)
    try:
        for _ in ("cold", "warm"):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            (out,) = node_cls().run({"waveform": torch.from_numpy(x[None]), "sample_rate": 16000},
                                    False, "48000")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = read_counts()
        y = out["waveform"].numpy()
        chunk = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=3)).to("cuda")
        wav = pipe.synthesize(chunk)[1]
        set_env(EGREGORA_FUSED_VOCODER=None)
        module = pipe.synthesize(chunk)[1]
    finally:
        set_env(EGREGORA_FUSED_VOCODER=None)
        node_cls._PIPE = None
    rel = rel_l2(wav.float(), module.float())
    fused = counts["mrf_fused_cm"]
    log(f"repair node (channel_floor=8, fused vocoder, bf16): warm {wall:.3f} s, out {y.shape}, "
        f"finite {bool(np.isfinite(y).all())}, launches {counts}; vocoder wave vs the module "
        f"path relative L2 {rel:.3e} (limit {FUSED_WAVE_LIMIT:g})")
    if y.shape != (1, 1, int(SECONDS * 48000)) or not np.isfinite(y).all():
        raise RuntimeError(f"the channel_floor=8 node gave {y.shape}, finite={np.isfinite(y).all()}")
    if sum(fused.values()) != 3 or any(c != 8 for (_, c, _) in fused):
        raise RuntimeError(f"the channel_floor=8 node's fused vocoder launched {fused}")
    if not counts["attn_rows"] or any(d != 8 for (_, _, d) in counts["attn_rows"]):
        raise RuntimeError(f"the channel_floor=8 node's attention launched {counts['attn_rows']}")
    if not rel <= FUSED_WAVE_LIMIT:
        raise RuntimeError(f"the channel_floor=8 fused vocoder is {rel} from the module path")
    return {"wall_s": wall, "wave_rel_l2": rel, "counts": {k: {str(s): n for s, n in v.items()}
                                                           for k, v in counts.items()}}


# K4: the K-weighting pole at 48 kHz and the shapes it runs at -- (C, N),
# pole, where
K48 = math.exp(-2.0 * math.pi * 60.0 / 24000.0)
K4_SHAPES = [((2, 14_400_000), K48, "300 s of 48 kHz stereo (the meter)"),
             ((2, 2_880_000), K48, "60 s of 48 kHz stereo (gain match, null test)"),
             ((1, 100), K48, "shorter than a tile"),
             ((3, 32_769), K48, "a ragged tile edge"),
             ((1, 4_194_304), 0.9999, "a pole near 1")]


def dropped_carry(x, k):
    """A planted fault of K4: every 4096-sample tile scanned from a zero
    state (the cross-tile carry dropped), from the plain version."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import iir_lowpass as il
    c, n = x.shape
    nt = -(-n // il.TILE)
    xp = F.pad(x, (0, nt * il.TILE - n)).reshape(c * nt, il.TILE)
    return il.iir_lowpass_plain(xp, k).reshape(c, nt * il.TILE)[:, :n]


def k4_phase() -> list:
    """``iir_lowpass`` (K4) against its plain version on the card and
    against float64 ``scipy.signal.lfilter`` on the host, beside the
    planted dropped carry (which needs more than one tile to show), with
    its time, the plain version's and the bound: 8 bytes a sample (one
    float32 read, one written) at the HBM rate.  No PyTorch call computes
    a first-order recurrence, so there is no library time."""
    import torch
    from scipy.signal import lfilter

    from egregora_tpu_torch.ops import iir_lowpass as il

    rows, failures = [], []
    for (c, n), k, where in K4_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = 0.5 * torch.randn(c, n, generator=gen, device="cuda")
        got = il.iir_lowpass(x, k)
        torch.cuda.synchronize()
        plain = il.iir_lowpass_plain(x, k)
        ok, err = iir_agreement(got, plain)
        got_h = got.cpu()
        ref64 = torch.from_numpy(lfilter([1.0 - k], [1.0, -k], x.cpu().double().numpy(), axis=-1))
        ok64, err64 = iir_agreement(got_h, ref64)
        plain_err64 = iir_agreement(plain.cpu(), ref64)[1]
        tiles = -(-n // il.TILE)
        bad_ok, bad_err = iir_agreement(dropped_carry(x, k), plain) if tiles > 1 else (None, None)
        reps = max(3, min(200, int(2e9 / (c * n))))
        ms = cuda_ms(lambda: il.iir_lowpass(x, k), reps)
        plain_ms = cuda_ms(lambda: il.iir_lowpass_plain(x, k), 2, 1)
        bound_ms = 8.0 * c * n / H100_BYTES_PER_S * 1e3
        row = {"c": c, "n": n, "k": k, "where": where, "max_abs_err": err,
               "max_abs_err_f64": err64, "plain_max_abs_err_f64": plain_err64,
               "planted_max_abs_err": bad_err, "limit": IIR_ABS, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes", "gb_per_s": 8.0 * c * n / ms / 1e6}
        rows.append(row)
        planted = ("n/a (one tile)" if bad_ok is None else
                   f"{bad_err:.3e} {'rejected' if not bad_ok else 'NOT REJECTED'}")
        log(f"iir_lowpass [{c},{n}] k={k:.6f} ({where}): vs plain max|d| {err:.3e}, vs float64 "
            f"lfilter {err64:.3e} (plain {plain_err64:.3e}; limit {IIR_ABS:g}) "
            f"{'ok' if ok and ok64 else 'FAIL'}; planted fault (cross-tile carry dropped) "
            f"{planted}; kernel {ms:.4f} ms ({row['gb_per_s']:.0f} GB/s), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes)")
        if not (ok and ok64):
            failures.append(f"iir_lowpass [{c},{n}] disagrees: {err} / {err64}")
        if bad_ok:
            failures.append(f"iir_lowpass [{c},{n}]: the dropped carry passes")
        del x, got, plain
    if failures:
        raise RuntimeError("; ".join(failures))
    return rows


def iir_entry(rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's K4 entry: times and bound of the calls the
    eval path made, shape by shape (``counts``: (c, n) -> calls)."""
    by_shape = {(r["c"], r["n"]): r for r in rows}

    def total(key):
        return sum(by_shape[s][key] * n for s, n in counts.items())

    return {
        "name": "iir_lowpass", "route": "cuda",
        "source": "egregora_tpu_torch/csrc/iir_lowpass.cu",
        "replaces": "egregora_tpu/ops/pallas_iir.py:110",
        "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": sum(8.0 * c * n * k for (c, n), k in counts.items())
        / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "library_note": "no PyTorch call computes a first-order recurrence",
        "launches_by_shape": {f"{c}x{n}": k for (c, n), k in counts.items()},
        "launches_by_path": by_path,
        "shapes": rows,
    }


EVAL_SR = 48000
METER_SECONDS = 300.0       # the meter on 300 s of 48 kHz stereo
PAIR_SECONDS = 60.0         # the pair nodes on 60 s of 48 kHz stereo
PLANTED_DELAY = 37.25       # samples: B is A delayed ...
PLANTED_GAIN_DB = -3.0      # ... and scaled
# card (K4, cuFFT, the card's matmuls) against the same port code on the
# CPU (plain versions): LUFS and dB readings within 1e-3, delays within
# 1e-3 samples, the null's RMS within 0.1 dB (a -20 dB null amplifies the
# signals' relative rounding ten times), audio within 1e-5
EVAL_DB, EVAL_DELAY, EVAL_NULL_DB, EVAL_AUDIO = 1e-3, 1e-3, 0.1, 1e-5
# the planted delay and gain recovered: the parabola through the
# whitened GCC-PHAT peak leans ~0.1 sample toward the integer lag
RECOVER_DELAY, RECOVER_GAIN_DB = 0.15, 0.05
# K4 calls a node makes, by shape: four K-weightings a meter reading
# set, two a LUFS-I gain match, three in "Null Test (Full)"'s defaults
METER_N = int(METER_SECONDS * EVAL_SR)
PAIR_N = int(PAIR_SECONDS * EVAL_SR)


def eval_signal(seconds: float, seed: int):
    """Seeded music-like stereo at 48 kHz, made on the card: 12 harmonics
    of 196 Hz under a slow level swing (so the loudness range is not 0),
    the right channel 0.8 of the left, a little noise; peak 0.5.
    Returns host float32 ``[2, N]``."""
    import torch
    n = int(seconds * EVAL_SR)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / EVAL_SR
    ph = torch.rand(12, generator=g, device="cuda", dtype=torch.float64) * 2 * math.pi
    x = torch.zeros(n, device="cuda", dtype=torch.float64)
    for h in range(1, 13):
        x += torch.sin(2 * math.pi * 196.0 * h * t + ph[h - 1]) / h
    x *= 0.55 + 0.45 * torch.sin(2 * math.pi * t / 23.0)
    y = torch.stack([x, 0.8 * x]) + 0.01 * torch.randn(2, n, generator=g, device="cuda",
                                                        dtype=torch.float64)
    return (0.5 * y / y.abs().max()).float().cpu().numpy()


def frac_delayed(x, delay: float, gain_db: float):
    """``x [C, N]`` delayed by ``delay`` samples (a band-limited shift
    through the FFT of the zero-padded signal, on the card in float64)
    and scaled by ``gain_db``."""
    import torch
    xd = torch.from_numpy(x).to("cuda", torch.float64)
    m = 2 * xd.shape[-1]
    f = torch.fft.rfftfreq(m, device="cuda", dtype=torch.float64)
    y = torch.fft.irfft(torch.fft.rfft(xd, m) * torch.exp(-2j * math.pi * f * delay), m)
    return (10 ** (gain_db / 20) * y[:, : x.shape[-1]]).float().cpu().numpy()


def eval_phase() -> dict:
    """The eval-pack and null-suite nodes on the card at real sizes: the
    meter on 300 s of 48 kHz stereo; Metrics, Gain Match (1770), Resample
    Audio (HQ) and Null Test (Full) (GCC-PHAT with the centre fixed,
    draws off) on a 60 s pair whose B is A delayed by 37.25 samples and
    scaled by -3 dB; the plotter with draws on where matplotlib is
    installed; ABX once.  Each node runs cold, then warm with the launch
    counts set to 0 before and read after; its readings are held to the
    same port code on the CPU (plain versions), the recovered delay and
    gain to the planted ones."""
    import importlib.util

    import numpy as np
    import torch

    from egregora_tpu_torch.nodes import eval_pack as ep
    from egregora_tpu_torch.nodes import null_suite as ns
    from egregora_tpu_torch.nodes.base import DeviceNode

    t0 = time.perf_counter()
    song = eval_signal(METER_SECONDS, seed=11)
    a = eval_signal(PAIR_SECONDS, seed=12)
    b = frac_delayed(a, PLANTED_DELAY, PLANTED_GAIN_DB)
    A = {"waveform": torch.from_numpy(a[None]), "sample_rate": EVAL_SR}
    B = {"waveform": torch.from_numpy(b[None]), "sample_rate": EVAL_SR}
    SONG = {"waveform": torch.from_numpy(song[None]), "sample_rate": EVAL_SR}
    log(f"eval: signals made in {time.perf_counter() - t0:.1f} s ({METER_SECONDS:g} s and "
        f"2 x {PAIR_SECONDS:g} s of {EVAL_SR} Hz stereo)")
    off = dict(draw_waveforms=False, draw_spectrograms=False, draw_diffspec=False)
    nodes = [  # label, node class, args, kwargs, K4 calls by shape
        ("Loudness Meter (BS1770)", ep.Loudness_Meter_1770, (SONG,), {}, {(2, METER_N): 4}),
        ("Metrics (LSD + SI-SDR)", ep.Metrics_LSD_SISDR, (A, B), {}, {}),
        ("Audio Gain Match (1770)", ep.Audio_Gain_Match_1770, (A, B), {}, {(2, PAIR_N): 2}),
        ("Resample Audio (HQ)", ep.Resample_Audio_HQ, (A,), {"target_sr": 44100}, {}),
        ("Null Test (Full)", ns.Null_Test_Full, (A, B), dict(align_method="gcc-phat-fixed", **off),
         {(2, PAIR_N): 3}),
    ]
    results, failures, k4_counts, by_path = {}, [], collections.Counter(), {}
    try:
        for label, cls, args, kw, k4_expect in nodes:
            DeviceNode.DEVICE = "cuda"
            for run_no in ("cold", "warm"):
                reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                card = getattr(cls(), cls.FUNCTION)(*args, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                counts = read_counts()
            DeviceNode.DEVICE = "cpu"
            t = time.perf_counter()
            cpu = getattr(cls(), cls.FUNCTION)(*args, **kw)
            cpu_wall = time.perf_counter() - t
            k4 = counts["iir_lowpass"]
            k4_counts.update(k4)
            by_path[label] = sum(k4.values())
            others = {name: c for name, c in counts.items() if name != "iir_lowpass" and c}
            readings = compare_eval_node(label, card, cpu, failures)
            results[label] = {"warm_wall_s": wall, "cpu_wall_s": cpu_wall, "k4": k4,
                              "readings": readings}
            log(f"eval node {label}: warm {wall:.4f} s on the card (CPU plain {cpu_wall:.2f} s); "
                f"K4 calls {k4} (expected {k4_expect}); readings {readings}")
            if k4 != k4_expect or others:
                failures.append(f"{label}: launches {counts}, expected K4 {k4_expect} only")
        DeviceNode.DEVICE = "cuda"
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        if has_mpl:
            null_card = ns.Null_Test_Full().execute(A, B, align_method="gcc-phat-fixed", **off)
            t = time.perf_counter()
            imgs = ns.Audio_Plotter().execute(A, null_card[0], null_card[1])
            wall = time.perf_counter() - t
            shapes = [tuple(i.shape) for i in imgs]
            log(f"eval node Audio Plotter: matplotlib found, draws on: images {shapes} in "
                f"{wall:.2f} s")
            if any(s[1] < 100 or s[3] != 3 for s in shapes):
                failures.append(f"Audio Plotter drew {shapes}")
            results["Audio Plotter"] = {"wall_s": wall, "images": shapes}
        else:
            log("eval node Audio Plotter: matplotlib not installed here, so the plotter runs "
                "with draws off only (inside Null Test (Full))")
        abx = ep.ABX_Prepare().execute(A, B, clip_seconds=5.0, random_seed=3)
        judged = ep.ABX_Judge().execute(abx[3], abx[3]["x_is"])[0]
        log(f"eval node ABX Prepare/Judge: X is {abx[3]['x_is']}, clips "
            f"{[tuple(x['waveform'].shape) for x in abx[:3]]}, judged {judged}")
        if not judged["correct"] or abx[0]["waveform"].shape[-1] != 5 * EVAL_SR:
            failures.append(f"ABX: {abx[3]}, {judged}")
    finally:
        DeviceNode.DEVICE = "cuda"
    full = results["Null Test (Full)"]["readings"]
    d_err = abs(full["delay_samples"] - PLANTED_DELAY)
    g_err = abs(full["gain_db"] + PLANTED_GAIN_DB)
    log(f"eval: planted delay {PLANTED_DELAY} read {full['delay_samples']:.4f} (|d| {d_err:.4f}, "
        f"limit {RECOVER_DELAY}); planted gain {PLANTED_GAIN_DB} dB undone by "
        f"{full['gain_db']:+.4f} dB (|d| {g_err:.4f}, limit {RECOVER_GAIN_DB})")
    if not (d_err <= RECOVER_DELAY and g_err <= RECOVER_GAIN_DB):
        failures.append(f"the planted delay/gain were not recovered: {full}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"nodes": results, "k4_counts": dict(k4_counts), "k4_by_path": by_path}


def compare_eval_node(label: str, card, cpu, failures: list) -> dict:
    """An eval node's card outputs against its CPU outputs: every DICT
    reading and FLOAT within its limit, every AUDIO within ``EVAL_AUDIO``;
    returns the card's readings (Null Test (Full): with its delay)."""
    import numpy as np

    def lim(key):
        if key in ("null_rms_dbfs", "null_lufs"):
            return EVAL_NULL_DB
        if key in ("corr_coef", "scale_k"):
            return 1e-4
        return 0 if key == "overshoot_count" else EVAL_DB

    readings = {}

    def check(key, got, ref, limit):
        readings[key] = got
        if not abs(got - ref) <= limit or not np.isfinite(got):
            failures.append(f"{label} {key}: card {got}, CPU {ref} (limit {limit})")

    for i, (g, r) in enumerate(zip(card, cpu)):
        if isinstance(g, dict) and "waveform" in g:
            gw, rw = g["waveform"].numpy(), r["waveform"].numpy()
            if gw.shape != rw.shape or not np.abs(gw - rw).max() <= EVAL_AUDIO:
                failures.append(f"{label} output {i}: audio {gw.shape} vs {rw.shape}, max|d| "
                                f"{np.abs(gw - rw).max() if gw.shape == rw.shape else 'n/a'}")
        elif isinstance(g, dict):
            for key in g:
                check(key, float(g[key]), float(r[key]), lim(key))
        elif isinstance(g, float):
            name = {"Null Test (Full)": ("", "", "delay_ms", "gain_db"),
                    "Audio Gain Match (1770)": ("", "gain_db", "ref_level", "in_level")}[label][i]
            check(name, g, r, EVAL_DELAY * 1e3 / EVAL_SR if name == "delay_ms" else EVAL_DB)
    if "delay_ms" in readings:
        readings["delay_samples"] = readings["delay_ms"] * EVAL_SR / 1e3
    return readings


# ---- the converted reference checkpoints at the published geometry ----

def published_cfg():
    """The published FlashSR checkpoints' geometry (what a user's real
    vae.pth / student_ldm.pth / sr_vocoder.pth trio carries): VAE base 128,
    mults (1, 2, 4), 2 res blocks, mid attention and quant convs; the
    CompVis UNet of 128 channels, attention at ds 2 and 4, 8 heads; the
    weight-normalised HiFi-GAN of 512 initial channels, floor 64."""
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr.vocoder import VocoderConfig
    return P.FlashSRConfig(
        vae=P.VAEConfig(base_channels=128, channel_mults=(1, 2, 4), latent_channels=16,
                        num_res_blocks=2, groups=32, mid_attn=True, use_quant_conv=True),
        unet=P.LDMUNetConfig(in_channels=32, out_channels=16, model_channels=128,
                             channel_mult=(1, 2, 4), num_res_blocks=2,
                             attention_resolutions=(2, 4), num_heads=8, groups=32),
        vocoder=VocoderConfig(n_mels=256, upsample_initial=512, upsample_factors=(10, 8, 6),
                              upsample_kernels=(20, 16, 12), resblock_kernels=(3, 7, 11),
                              resblock_dilations=((1, 3, 5),) * 3, channel_floor=64))


def upstream_state_dicts(cfg, seed: int) -> dict:
    """Seeded weights for ``cfg`` as the three upstream state dicts: the
    port's modules drawn from ``seed``, carried to the JAX package's flax
    layout (``flax_tree``) and from there to each checkpoint's torch keys
    and layouts by inverting the name maps: the CompVis fused qkv
    head-major, 1D convs for qkv and proj_out, Linear ``[out, in]``, convs
    ``[out, in, *k]``, ConvTranspose ``[in, out, k]``; the vocoder's
    weights as ``weight_g`` / ``weight_v`` pairs; an upstream-only extra
    key in the VAE, which the converter drops."""
    import numpy as np

    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.models.flashsr.ldm_unet import ldm_unet_name_map
    from egregora_tpu_torch.models.flashsr.vae import audioldm_vae_name_map
    from egregora_tpu_torch.models.flashsr.vocoder import hifigan_name_map
    from egregora_tpu_torch.utils import weights

    mods = P.FlashSRModules(cfg)
    mods.init_params(seed)
    maps = {"vae": audioldm_vae_name_map(cfg.vae).__self__,
            "student_ldm": ldm_unet_name_map(cfg.unet).__self__,
            "sr_vocoder": hifigan_name_map(cfg.vocoder).__self__}
    heads = cfg.unet.num_heads
    out = {}
    for name, module in mods.by_name().items():
        flat = weights._flatten(weights.flax_tree(module, values=True))
        sd = {}
        for tk, fk in maps[name].items():
            tr = None
            if isinstance(fk, tuple):
                fk, tr = fk
            w = flat[fk]
            if tk.endswith("qkv.weight"):      # flax [Cin, 3C] slot-major -> [3C, Cin, 1]
                oc = w.shape[1]
                t = (w.T.reshape(3, heads, oc // (3 * heads), -1).transpose(1, 0, 2, 3)
                     .reshape(oc, -1)[:, :, None])
            elif tk.endswith("qkv.bias"):
                t = w.reshape(3, heads, -1).transpose(1, 0, 2).reshape(-1)
            elif callable(tr):                 # dense from a Linear or a 1D conv
                t = w.T[:, :, None] if "proj_out" in tk else w.T
            elif tr is not None:               # ConvTranspose1d
                t = np.transpose(w, np.argsort(tr))
            elif w.ndim >= 3 and tk.endswith("weight"):
                t = np.transpose(w, np.argsort(tuple(range(2, w.ndim)) + (1, 0)))
            elif w.ndim == 2 and tk.endswith("weight"):
                t = w.T
            else:
                t = w
            t = np.ascontiguousarray(t, np.float32)
            if name == "sr_vocoder" and tk.endswith("weight") and t.ndim >= 2:
                g = np.sqrt(np.sum(t ** 2, axis=tuple(range(1, t.ndim)), keepdims=True))
                sd[tk[:-len("weight")] + "weight_v"] = 3.0 * t
                sd[tk[:-len("weight")] + "weight_g"] = g
            else:
                sd[tk] = t
        out[name] = sd
    out["vae"]["loss.logvar"] = np.zeros((1,), np.float32)
    return out


def write_reference_trio(cfg, d, seed: int = 0) -> None:
    """``upstream_state_dicts(cfg, seed)`` as ``vae.pth``,
    ``student_ldm.pth`` and ``sr_vocoder.pth`` in ``d`` (``torch.save``)."""
    import torch
    d.mkdir(parents=True, exist_ok=True)
    for name, sd in upstream_state_dicts(cfg, seed).items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(d / f"{name}.pth"))


# the converted node's paths, one-shot on the 12 s input: label, switches,
# MRF launches by (b, c, t) at batch 1 (the attention's are CONVERTED_CALLS)
CONVERTED_PATHS = [
    ("module-path vocoder", {"EGREGORA_FUSED_VOCODER": None, "EGREGORA_MRF_PATH": None}, {}),
    ("fused MRF", {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": None},
     {"mrf_fused_cm": {(1, 64, 245760): 1}}),
    ("rows MRF", {"EGREGORA_FUSED_VOCODER": "1", "EGREGORA_MRF_PATH": "rows"},
     {"mrf_rows": {(1, 256, 5120): 3, (1, 128, 40960): 3, (1, 64, 245760): 3}}),
]
CONVERTED_CALLS = dict(PATH_CALLS)
CONVERTED_CALLS.pop((1, 8192, 256))
CONVERTED_CALLS[CONVERTED_MID] = 2
# relative L2 limits of the converted published trio, bf16 on the card
# against float32 on the CPU with the same (bf16-rounded) weights, one
# chunk; each lies between the sound reading (1.467e-2, 2.148e-2,
# 2.144e-2) and that of every attention dropping its last 64 keys
# (1.927e-2, 2.696e-2, 2.685e-2) on an H100 (PERF.md, Findings)
CONVERTED_REF_LIMITS = {"mel_hr": 1.7e-2, "wave": 2.4e-2, "high_band": 2.4e-2}


def converted_counts(per_item: dict, b: int, batches: int) -> dict:
    """The converted node's launches at batch ``b`` over ``batches``."""
    out = {k: {} for k in ("attn_rows", "mrf_fused_cm", "mrf_rows", "iir_lowpass",
                           "flash_online", "conv3x3_out1")}
    out["attn_rows"] = {(b * h, n, d): c * batches for (h, n, d), c in CONVERTED_CALLS.items()}
    for kernel, shapes in per_item.items():
        out[kernel] = {(b, c, t): k * batches for (_, c, t), k in shapes.items()}
    return out


def converted_phase() -> dict:
    """The node on a converted reference trio at the published geometry.
    A seeded upstream-layout trio is written to a temporary
    ``$EGREGORA_TPU_WEIGHTS/flashsr``; the node resolves it ("converted":
    geometry inferred from the shapes, converted, cached; later builds
    read the cache) and runs the 12 s input one-shot on each path of
    ``CONVERTED_PATHS`` (streaming ``max_batch=2`` on the first), with
    launches counted by shape: ``attn_rows`` at D = 512 in the VAE mid
    blocks, the MRF kernels at C = 256/128/64 on the rows path.  Then one
    chunk, bf16 on the card against float32 on the CPU, beside every
    attention dropping its last key tile, which the limits must reject,
    and each attention call against the float32 plain version on its own
    inputs."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.nodes import super_resolution
    from egregora_tpu_torch.nodes.base import to_buffer
    from egregora_tpu_torch.ops import attention

    cfg = published_cfg()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    node_cls = super_resolution.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]
    sr_in, sr_out = 16000, 48000
    x = test_signal(SECONDS, sr_in, seed=0)
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": sr_in}
    n_out = int(SECONDS * sr_out)
    results = {"paths": {}}
    try:
        t = time.perf_counter()
        write_reference_trio(cfg, root / "flashsr", seed=7)
        results["write_s"] = time.perf_counter() - t
        set_env(EGREGORA_TPU_WEIGHTS=str(root), EGREGORA_FLASHSR_VARIANT=None,
                EGREGORA_FLASHSR_NUM_HEADS=None)
        for i, (label, switches, per_item) in enumerate(CONVERTED_PATHS):
            set_env(**switches)
            node_cls._PIPE = None
            t = time.perf_counter()
            node = node_cls()
            pipe = node._pipeline()
            ready = time.perf_counter() - t
            if pipe.weight_source != "converted" or pipe.cfg != cfg or pipe.device.type != "cuda":
                raise RuntimeError(f"converted {label}: the node resolved {pipe.weight_source} "
                                   f"on {pipe.device}, config {pipe.cfg}")
            cached = (root / "flashsr" / distill.CACHE).exists()
            log(f"converted {label}: pipeline ready in {ready:.1f} s "
                f"({'converted from the .pth trio' if i == 0 else 'from the cache'}; "
                f"cache written: {cached})")
            for run_no in ("cold", "warm"):
                reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                (out,) = node.run(audio, lowpass_input=False, output_sr=str(sr_out))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                counts = read_counts()
                one = out["waveform"].numpy()
                finite = bool(np.isfinite(one).all())
                log(f"converted {label} one-shot ({run_no}): {wall:.3f} s wall, RTF "
                    f"{SECONDS / wall:.1f}x real time, out {one.shape}, finite {finite}, "
                    f"launches {counts}")
                if one.shape != (1, 1, n_out) or not finite:
                    raise RuntimeError(f"converted {label}: bad output {one.shape}, "
                                       f"finite={finite}")
                expect = converted_counts(per_item, BATCH, 1)
                if counts != expect:
                    raise RuntimeError(f"converted {label}: launches {counts}, expected {expect}")
            results["paths"][label] = {"wall_s": wall, "rtf": SECONDS / wall, "counts": counts}
            if i == 0:
                reset_counts()
                t = time.perf_counter()
                stream = pipe.process(to_buffer(audio), output_sr=sr_out, max_batch=2).numpy()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t
                counts_s = read_counts()
                rel = rel_l2(torch.from_numpy(stream), torch.from_numpy(one[0]))
                log(f"converted {label} streaming max_batch=2: {wall_s:.3f} s wall, launches "
                    f"{counts_s}; one-shot vs streaming relative L2 {rel:.3e} "
                    f"(limit {NODE_STREAM_REL_L2:g})")
                if counts_s != converted_counts(per_item, 2, 2):
                    raise RuntimeError(f"converted streaming: launches {counts_s}")
                if stream.shape != (1, n_out) or not rel <= NODE_STREAM_REL_L2:
                    raise RuntimeError(f"converted: one-shot and streaming disagree: {rel}")
                results["paths"][label]["streaming_wall_s"] = wall_s
                module_pipe = pipe
            else:        # the kernels' vocoder wave against the module path's
                chunk = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=3)).to("cuda")
                wav = pipe.synthesize(chunk)[1]
                set_env(EGREGORA_FUSED_VOCODER=None)
                module = pipe.synthesize(chunk)[1]
                set_env(**switches)
                rel = rel_l2(wav.float(), module.float())
                log(f"converted {label}: vocoder wave vs the module path relative L2 "
                    f"{rel:.3e} (limit {FUSED_WAVE_LIMIT:g})")
                if not rel <= FUSED_WAVE_LIMIT:
                    raise RuntimeError(f"converted {label}: the vocoder wave is {rel} "
                                       "from the module path")
                results["paths"][label]["wave_rel_l2"] = rel
        set_env(EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
        results["reference"] = converted_reference(module_pipe, root / "flashsr")
    finally:
        set_env(EGREGORA_TPU_WEIGHTS=None, EGREGORA_FUSED_VOCODER=None, EGREGORA_MRF_PATH=None)
        node_cls._PIPE = None
        shutil.rmtree(root, ignore_errors=True)
    return results


def converted_reference(card, ckpt_dir) -> dict:
    """One chunk of the converted pipeline ``card`` (bf16) against float32
    arithmetic on the CPU with the same weights rounded to bf16: the
    decoded mel, the vocoder's wave and the output's band above the
    crossover; planted fault: every attention drops its last 64 keys.
    Each attention call of the card's chunk is also held to the float32
    plain version on its own inputs (``ATTN_CALL_LIMIT``)."""
    import dataclasses

    import torch

    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.ops import attention

    cfg, sd = distill.load_converted_flashsr(ckpt_dir)
    x = torch.from_numpy(test_signal(P.CHUNK_S, P.REQ_SR, seed=2)[:, :P.CHUNK_SAMPLES])

    def outputs(pipe):
        xd = x.to(pipe.device)
        with torch.inference_mode():
            mel, wav = pipe.synthesize(xd)
            y = pipe._postprocess(xd, wav, mel).float()
        high = y - P.lowpass_fir(y, P.REQ_SR, pipe.cfg.crossover_hz)
        return {"mel_hr": mel.float().cpu(), "wave": wav.float().cpu(),
                "high_band": high.float().cpu()}

    f32 = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), dtype=torch.float32)
                                      for k in ("vae", "unet", "vocoder")})
    rounded = {m: {k: v.bfloat16().float() for k, v in d.items()} for m, d in sd.items()}
    t = time.perf_counter()
    ref = outputs(P.FlashSRPipeline(f32, params=rounded, device="cpu"))
    log(f"converted reference: one chunk f32 on the CPU {time.perf_counter() - t:.1f} s")
    kernel, calls = attention.attn_rows, []

    def checked(q, k, v):
        got = kernel(q, k, v)
        ref32 = attention.chunked_attention(q.float(), k.float(), v.float())
        calls.append((tuple(q.shape), rel_l2(got.float(), ref32),
                      rel_l2(drop_last_tile(q, k, v).float(), ref32)))
        return got

    try:
        attention.attn_rows = checked
        sound = outputs(card)
        attention.attn_rows = drop_last_tile
        planted = outputs(card)
    finally:
        attention.attn_rows = kernel
    readings, failures, nan = {}, [], float("nan")
    good, bad = max(c[1] for c in calls), min(c[2] for c in calls)
    mid = [c for c in calls if c[0][-1] == 512]
    log(f"converted reference attention per call ({len(calls)} calls, shapes "
        f"{sorted(set(c[0] for c in calls))}): attn_rows vs float32 plain on the same inputs, "
        f"relative L2 at most {good:.3e} (D = 512: {max((c[1] for c in mid), default=nan):.3e}; "
        f"limit {ATTN_CALL_LIMIT:g}) {'ok' if good <= ATTN_CALL_LIMIT else 'FAIL'}; planted "
        f"fault (last key tile dropped) at least {bad:.3e} (D = 512: "
        f"{min((c[2] for c in mid), default=nan):.3e}) "
        f"{'rejected' if bad > ATTN_CALL_LIMIT else 'NOT REJECTED'}")
    readings["attn_call"] = (good, bad)
    if len(mid) != 2:
        failures.append(f"{len(mid)} attention calls at D = 512, expected 2")
    if not good <= ATTN_CALL_LIMIT:
        failures.append(f"attention per call: {good}")
    if not bad > ATTN_CALL_LIMIT:
        failures.append("attention per call: the dropped key tile passes")
    for key, limit in CONVERTED_REF_LIMITS.items():
        g, b = rel_l2(sound[key], ref[key]), rel_l2(planted[key], ref[key])
        readings[key] = (g, b)
        log(f"converted reference {key}: bf16 card vs f32 cpu relative L2 {g:.3e} "
            f"(limit {limit:g}) {'ok' if g <= limit else 'FAIL'}; planted fault (last key "
            f"tile dropped) {b:.3e} {'rejected' if b > limit else 'NOT REJECTED'}")
        if not g <= limit:
            failures.append(f"converted: card and CPU disagree on {key}: {g}")
        if not b > limit:
            failures.append(f"converted: the {key} limit does not reject the planted fault")
    if failures:
        raise RuntimeError("; ".join(failures))
    return readings


# ---- K1b (flash_online) and K3 (conv3x3_out1) against their plain versions ----

# K1b: the attention lab's shapes (bh, n, d) and a ragged N, at the JAX
# defaults (block_q 512, block_k 1024: the largest tile built for each D)
K1B_SHAPES = [(26, 8192, 256), (208, 2048, 32), (26, 8192, 512), (6, 1000, 64)]
# K3: (b, f, m, c, dtype, where) -- the decoders' last conv on one-shot's
# chunk batch (C = 24 compact trios, 64 full config, 128 published), the
# edge lab's geometry, ragged F and M, C off the vector and over a chunk
K3_SHAPES = [(3, 512, 256, 24, "bfloat16", "compact trios' decoder"),
             (3, 512, 256, 64, "bfloat16", "full config's decoder"),
             (3, 512, 256, 128, "bfloat16", "published decoder"),
             (26, 512, 256, 64, "bfloat16", "edge lab"),
             (26, 512, 256, 128, "bfloat16", "edge lab, published width"),
             (2, 37, 45, 64, "bfloat16", "ragged F and M"),
             (1, 19, 70, 200, "bfloat16", "C over one chunk, off the vector"),
             (3, 100, 77, 24, "float32", "float32")]
K3_ROWS, K3_COLS = 8, 32     # a K3 block's output tile: rows a step, columns


def drop_bottom_halo(x, w, bias):
    """A planted fault of K3: every 8-row tile without the halo row below
    it (its last row's taps of the next row left out), from the plain
    version."""
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import conv_edge as ce
    out = ce.conv3x3_out1_plain(x, w, bias)
    f, m = x.shape[1], x.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wr = w[2, :, :, 0].to(x.dtype).float()                   # taps of the row below
    below = sum(xp[:, 2:2 + f, dj:dj + m] @ wr[dj] for dj in range(3))
    rows = [r for r in range(K3_ROWS - 1, f - 1, K3_ROWS)]
    out[:, rows, :, 0] -= below[:, rows]
    return out


def k3_edges(y):
    """K3's output at its tiles' edges: rows 8i and 8i + 7, columns 32j
    and 32j + 31 (where a halo fault shows)."""
    import torch
    f, m = y.shape[1], y.shape[2]
    rows = sorted({r for i in range(0, f, K3_ROWS) for r in (i, min(i + K3_ROWS, f) - 1)})
    cols = sorted({c for j in range(0, m, K3_COLS) for c in (j, min(j + K3_COLS, m) - 1)})
    return torch.cat([y[:, rows].flatten(), y[:, :, cols].flatten()])


def edge_kernels_phase() -> dict:
    """K1b and K3 against their plain versions on the card, beside planted
    faults the limits must reject (K1b: the last key tile dropped; K3: the
    bottom halo row dropped), with the kernel's, the plain version's and
    the library call's times (SDPA; cuDNN ``F.conv2d`` on the same
    channels-last input, bf16 out) and the bound."""
    import torch
    import torch.nn.functional as F

    from egregora_tpu_torch.ops import attn_flash as af
    from egregora_tpu_torch.ops import conv_edge as ce

    k1b, k3, failures = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for bh, n, d in K1B_SHAPES:
        q, k, v = (torch.randn(bh, n, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        got = af.flash_online(q, k, v)
        torch.cuda.synchronize()
        plain = af.flash_online_plain(q, k, v)
        ok, rel, err, limit = bf16_agreement(got, plain)
        tile = af.kernel_tile(q.dtype, d, 512, 1024)[2]
        m = (n - 1) // tile * tile or n // 2       # one key tile: drop half of it
        bad = af.flash_online_plain(q, k[:, :m].contiguous(), v[:, :m].contiguous())
        bad_ok, bad_rel, bad_err, _ = bf16_agreement(bad, plain)
        flops = 4.0 * bh * n * n * d
        bound_ms, bound_by = bound(flops, 8.0 * bh * n * d, H100_BF16_FLOPS)
        reps = max(2, min(20, int(2e12 / flops)))
        ms = cuda_ms(lambda: af.flash_online(q, k, v), reps)
        plain_ms = cuda_ms(lambda: af.flash_online_plain(q, k, v), 1, 1)
        q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
        row = {"bh": bh, "n": n, "d": d, "tile": list(af.kernel_tile(q.dtype, d, 512, 1024)),
               "max_abs_err": err, "rel_l2": rel, "max_abs_limit": limit,
               "planted_max_abs_err": bad_err, "planted_rel_l2": bad_rel, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": flops / ms / 1e9}
        k1b.append(row)
        log(f"flash_online [{bh},{n},{d}] tile {row['tile']}: vs plain max|d| {err:.3e} "
            f"(limit {limit:.3e}), rel L2 {rel:.3e} {'ok' if ok else 'FAIL'}; planted fault "
            f"(last key tile dropped) max|d| {bad_err:.3e}, rel L2 {bad_rel:.3e} "
            f"{'rejected' if not bad_ok else 'NOT REJECTED'}; kernel {ms:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not ok:
            failures.append(f"flash_online [{bh},{n},{d}] disagrees: {rel}, {err}")
        if bad_ok:
            failures.append(f"flash_online [{bh},{n},{d}]: the planted fault passes")
        del q, k, v, q4, k4, v4, got, plain, bad

    for b, f, m, c, dt, where in K3_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(b, f, m, c, generator=gen, device="cuda").to(dtype)
        w = 0.1 * torch.randn(3, 3, c, 1, generator=gen, device="cuda")
        bias = torch.full((1,), 0.1, device="cuda")
        got = ce.conv3x3_out1(x, w, bias)
        torch.cuda.synchronize()
        plain = ce.conv3x3_out1_plain(x, w, bias)
        ok, rel, err = f32_agreement(got, plain)
        edge_err = float((k3_edges(got) - k3_edges(plain)).abs().max())
        bad_ok, bad_rel, bad_err = f32_agreement(drop_bottom_halo(x, w, bias), plain)
        elt = x.element_size()
        bound_ms, bound_by = bound(18.0 * b * f * m * c, b * f * m * (c * elt + 4.0),
                                   H100_F32_FLOPS)
        ms = cuda_ms(lambda: ce.conv3x3_out1(x, w, bias), 20)
        plain_ms = cuda_ms(lambda: ce.conv3x3_out1_plain(x, w, bias), 3, 1)
        xn, wn = x.permute(0, 3, 1, 2), w[..., 0].permute(2, 0, 1)[None].to(dtype)
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, bias.to(dtype), padding=1), 20)
        row = {"b": b, "f": f, "m": m, "c": c, "dtype": dt, "where": where,
               "max_abs_err": err, "edge_max_abs_err": edge_err, "rel_l2": rel,
               "max_abs_limit": F32_REL * float(plain.abs().max()),
               "planted_max_abs_err": bad_err, "planted_rel_l2": bad_rel, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "gb_per_s": b * f * m * (c * elt + 4.0) / ms / 1e6}
        k3.append(row)
        log(f"conv3x3_out1 [{b},{f},{m},{c}] {dt} ({where}): vs plain max|d| {err:.3e}, tile "
            f"edges {edge_err:.3e} (limit {row['max_abs_limit']:.3e}), rel L2 {rel:.3e} "
            f"{'ok' if ok else 'FAIL'}; planted fault (bottom halo row dropped) max|d| "
            f"{bad_err:.3e}, rel L2 {bad_rel:.3e} {'rejected' if not bad_ok else 'NOT REJECTED'}; "
            f"kernel {ms:.4f} ms ({row['gb_per_s']:.0f} GB/s), plain {plain_ms:.3f} ms, "
            f"cudnn {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if not ok:
            failures.append(f"conv3x3_out1 [{b},{f},{m},{c}] {dt} disagrees: {rel}, {err}")
        if bad_ok:
            failures.append(f"conv3x3_out1 [{b},{f},{m},{c}]: the planted fault passes")
        del x, got, plain
    if failures:
        raise RuntimeError("; ".join(failures))
    return {"flash_online": k1b, "conv3x3_out1": k3}


def lab_phase() -> dict:
    """The two lab entry points (``python -m egregora_tpu_torch.tools.
    attn_flash_lab`` / ``edge_conv_lab``), once at one round, with the
    launches of every kernel counted: K1b and K3 run on no node path; the
    labs are where they launch."""
    from egregora_tpu_torch.tools import attn_flash_lab, edge_conv_lab

    out = {}
    for name, lab in (("attn_flash_lab", attn_flash_lab), ("edge_conv_lab", edge_conv_lab)):
        reset_counts()
        t = time.perf_counter()
        rows = lab.sweep(rounds=1)
        wall = time.perf_counter() - t
        counts = read_counts()
        log(f"{name}: {len(rows)} lines in {wall:.1f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[name] = {"rows": rows, "counts": counts, "wall_s": wall}
    if not out["attn_flash_lab"]["counts"]["flash_online"]:
        raise RuntimeError("attn_flash_lab launched no flash_online")
    if not out["edge_conv_lab"]["counts"]["conv3x3_out1"]:
        raise RuntimeError("edge_conv_lab launched no conv3x3_out1")
    return out


def edge_entry(name: str, rows: list, counts: dict, by_path: dict) -> dict:
    """The ``kernels`` line's entry of K1b or K3: ``counts`` maps a shape to
    the launches the labs made; times and bounds are phase (ii)'s at that
    shape (K1b at its default tile) times those launches."""
    if name == "flash_online":
        key = ("bh", "n", "d")
        src, rep = "attn_online.cu", "egregora_tpu/ops/attn_flash.py:81"
    else:
        key = ("b", "f", "m", "c")
        src, rep = "conv_edge.cu", "egregora_tpu/ops/conv_edge.py:66"
    by_shape = {tuple(r[k] for k in key): r for r in rows if r.get("dtype", "bfloat16") == "bfloat16"}
    missing = set(counts) - set(by_shape)
    if missing:
        raise RuntimeError(f"{name}: launches at shapes phase (ii) did not time: {missing}")

    def total(k):
        return sum(by_shape[s][k] * n for s, n in counts.items())

    bound_ms = total("bound_ms")
    by = collections.Counter()
    for s, n in counts.items():
        by[by_shape[s]["bound_by"]] += by_shape[s]["bound_ms"] * n
    return {
        "name": name, "route": "cuda", "source": f"egregora_tpu_torch/csrc/{src}",
        "replaces": rep, "launches": sum(counts.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
        "bound_by": by.most_common(1)[0][0], "library_ms": total("library_ms"),
        "library_call": ("torch.nn.functional.scaled_dot_product_attention"
                         if name == "flash_online" else
                         "torch.nn.functional.conv2d (cuDNN, bf16 out)"),
        "launches_by_shape": {"x".join(map(str, s)): n for s, n in counts.items()},
        "launches_by_path": by_path, "node_path_launches": 0, "shapes": rows,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this script runs only on the card", file=sys.stderr, flush=True)
        return 2
    try:
        import egregora_tpu_torch.utils.cuda_build  # noqa: F401  (the package is here)
    except ImportError as e:
        print(f"chip_smoke: the egregora_tpu_torch package is missing ({e}); run "
              "from the root of a checkout of the repository", file=sys.stderr, flush=True)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    # the plain versions' float32 convs and matmuls in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:      # one nvcc a source, together
        built = list(ex.map(timed_build, SOURCES))
    log(f"build: {', '.join(f'{n} in {s:.1f} s' for n, s in zip(SOURCES, built))} "
        f"(nvcc, sm_90a, in parallel: {time.perf_counter() - t0:.1f} s)")

    attn_rows_ = attention_phase()
    mrf_rows_ = mrf_phase()
    repair = repair_phase()
    k4_rows = k4_phase()
    edge = edge_kernels_phase()
    reference_phase()
    nodes = node_phase()
    served_reference_phase()
    pipe = pipeline_phase()
    converted = converted_phase()
    evals = eval_phase()
    labs = lab_phase()

    attn_counts = collections.Counter(pipe["counts"])
    attn_paths = {"full config (seeded weights)": pipe["launches"]}
    for label, r in list(nodes.items()) + [(f"converted trio, {k}", r) for k, r
                                           in converted["paths"].items()]:
        attn_counts.update(r["counts"]["attn_rows"])
        attn_paths[label] = sum(r["counts"]["attn_rows"].values())
    fused = collections.Counter(nodes["HiFi-GAN trio, fused MRF"]["counts"]["mrf_fused_cm"])
    conv_fused = converted["paths"]["fused MRF"]["counts"]["mrf_fused_cm"]
    fused.update(conv_fused)
    rows = collections.Counter(nodes["HiFi-GAN trio, rows MRF"]["counts"]["mrf_rows"])
    conv_rows = converted["paths"]["rows MRF"]["counts"]["mrf_rows"]
    rows.update(conv_rows)
    k1b_counts = labs["attn_flash_lab"]["counts"]["flash_online"]
    k3_counts = labs["edge_conv_lab"]["counts"]["conv3x3_out1"]
    kernels = [attn_entry(attn_rows_, dict(attn_counts), attn_paths),
               mrf_entry("mrf_fused_cm", mrf_rows_, dict(fused),
                         {"HiFi-GAN trio, fused MRF": sum(fused.values()) - sum(conv_fused.values()),
                          "converted trio, fused MRF": sum(conv_fused.values())}),
               mrf_entry("mrf_rows", mrf_rows_, dict(rows),
                         {"HiFi-GAN trio, rows MRF": sum(rows.values()) - sum(conv_rows.values()),
                          "converted trio, rows MRF": sum(conv_rows.values())}),
               iir_entry(k4_rows, evals["k4_counts"], evals["k4_by_path"]),
               edge_entry("flash_online", edge["flash_online"], k1b_counts,
                          {"attn_flash_lab": sum(k1b_counts.values())}),
               edge_entry("conv3x3_out1", edge["conv3x3_out1"], k3_counts,
                          {"edge_conv_lab": sum(k3_counts.values())})]
    kernels[0]["launches_streaming"] = pipe["launches_streaming"]
    kernels[0]["repair_shapes"] = repair["attn"]
    kernels[1]["repair_shapes"] = [r for r in repair["mrf"] if r["entry"] == "mrf_fused_cm"]
    kernels[2]["repair_shapes"] = [r for r in repair["mrf"] if r["entry"] == "mrf_rows"]
    for k in kernels:
        if not k["launches"]:
            raise RuntimeError(f"{k['name']} was not launched on its main path")
    log("node paths: " + "; ".join(f"{label}: warm one-shot {r['wall_s']:.3f} s wall "
                                   f"(RTF {r['rtf']:.1f}x)" for label, r in nodes.items()))
    log("converted trio (published geometry): " + "; ".join(
        f"{label}: warm one-shot {r['wall_s']:.3f} s wall (RTF {r['rtf']:.1f}x)"
        for label, r in converted["paths"].items()))
    log(f"eval nodes, warm on {card}: " + "; ".join(
        f"{label} {r['warm_wall_s']:.4f} s" for label, r in evals["nodes"].items()
        if "warm_wall_s" in r))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
