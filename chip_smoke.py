#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``egregora_tpu_torch``) on one
NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each on standard output:

1. the card's name and power limit (``nvidia-smi``); the build of
   ``csrc/attn_rows.cu`` with ``nvcc``;
2. the kernel against its plain PyTorch version on the card, at the
   shapes the FlashSR main path gives it and at a ragged length, within
   a relative L2 of 1e-2 and two bf16 ulps of the largest output; a
   planted fault (the last key tile dropped) must fail those limits; the
   kernel's, the plain version's and the library call's times;
3. a reference check: the full config on one chunk in bf16 on the card
   against float32 arithmetic on the CPU with the same weights (decoded
   mel, vocoder wave, the output's band above the crossover); the same
   planted fault must fail those limits;
4. the full-config FlashSR pipeline at full width (random weights from
   a seed): a 12 s, 16 kHz test signal (3 chunks) to 48 kHz, one-shot
   and streaming (``max_batch=2``), with the kernel's launches counted
   by shape around each run;
5. a JSON line ``{"kernels": [...]}`` whose times are the per-shape
   times of phase 2 times the launches phase 4 counted, and, last,
   ``{"ok": true, ...}``.

Any failure exits non-zero and prints no ``"ok"`` line.  With no CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 rate, H100 SXM
SECONDS = 12.0               # test signal: 3 chunks of 5.12 s at 48 kHz
BATCH = 3                    # chunks in the one-shot batch of that signal
# attention calls of one chunk batch on the main path: (heads, N, D) -> calls
PATH_CALLS = {(8, 2048, 32): 5, (8, 512, 64): 6, (1, 8192, 256): 2}
RAGGED = [(8, 1000, 32), (8, 1000, 64), (1, 1000, 256)]
KEY_TILE = 64                # keys per K/V tile of csrc/attn_rows.cu
ATTN_REL_L2 = 1e-2           # kernel vs plain, relative L2 over the output


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
    for heads, n, d in list(PATH_CALLS) + RAGGED:
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


def kernels_entry(rows: list, counts: dict, launches: int) -> dict:
    """The ``kernels`` line's entry: times and bound of the launches the
    one-shot run made, shape by shape as ``counts`` measured them."""
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
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(ops_ms, byte_ms),
        "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
        "library_ms": total("library_ms"),
        "launches_by_shape": {f"{bh}x{n}x{d}": c for (bh, n, d), c in counts.items()},
        "shapes": rows,
    }


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


def reference_phase() -> None:
    """The full config on one chunk, seeded weights: bf16 on the card
    (through the kernel) against float32 arithmetic on the CPU (plain
    versions) with the same weights (rounded to bf16).
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
    attention.attn_rows = drop_last_tile
    try:
        planted = outputs(card)
    finally:
        attention.attn_rows = kernel
    for key, limit in REF_LIMITS.items():
        good, bad = rel_l2(sound[key], ref[key]), rel_l2(planted[key], ref[key])
        log(f"reference {key}: bf16 card vs f32 cpu relative L2 {good:.3e} "
            f"(limit {limit:g}) {'ok' if good <= limit else 'FAIL'}; planted fault "
            f"{bad:.3e} {'rejected' if bad > limit else 'not rejected'}")
        if not good <= limit:
            raise RuntimeError(f"card and CPU pipelines disagree on {key}: {good}")
        if not bad > limit:
            raise RuntimeError(f"the {key} limit does not reject a dropped last key tile")


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
        ar.launches = 0
        ar.launches_by_shape.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe.process(AudioBuffer(x, sr_in), output_sr=sr_out,
                           max_batch=max_batch).numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return out, wall, ar.launches, dict(ar.launches_by_shape)

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this script runs only on the card", file=sys.stderr, flush=True)
        return 2
    try:
        from egregora_tpu_torch.utils import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the egregora_tpu_torch package is missing ({e}); run "
              "from the root of a checkout of the repository", file=sys.stderr, flush=True)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build("attn_rows")
    log(f"build: attn_rows in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    rows = attention_phase()
    reference_phase()
    pipe = pipeline_phase()
    attn = kernels_entry(rows, pipe["counts"], pipe["launches"])
    attn["launches_streaming"] = pipe["launches_streaming"]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [attn]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
