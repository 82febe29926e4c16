"""The full production chain, the port of ``examples/full_chain.py``:

  denoise (RNNoise, VAD-adaptive mix) -> FlashSR super-resolution ->
  Fat Llama light pass -> 96 kHz delivery + evaluation on the device
  (loudness, LSD / SI-SDR against the input).

Audio stays on the device between stages.  On the card FlashSR's
attention runs on the ``attn_rows`` kernel and the loudness meter's
K-weighting on K4 (``iir_lowpass``).

    python -m egregora_tpu_torch.examples.full_chain in.wav out_96k.wav [--device {cuda,cpu}]

It runs on the card unless ``--device cpu``, and raises where there is
no card.  ``full_chain`` is the chain on tensors (no files); ``main``
reads the WAV, runs it and writes the 96 kHz WAV.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Tuple

import torch

from ..utils.device import card_line, ensure_accelerator


def _wall(device: torch.device, t0: float) -> float:
    """Seconds since ``t0``, the device's queued work included."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def full_chain(x_cn, sr: int, device) -> Tuple[torch.Tensor, Dict[str, float], Dict[str, float]]:
    """The chain on ``x_cn [C, N]`` at ``sr`` on ``device`` (a
    ``torch.device`` or its name): (the 96 kHz output ``[C, M]`` on the
    device, the printed metrics, seconds a stage).  Prints the example's
    lines: the FlashSR weights, each stage's running time, the device and
    the metrics' JSON."""
    from ..core.audio import AudioBuffer
    from ..eval.loudness import loudness_report
    from ..eval.metrics import lsd_sisdr_report
    from ..models.flashsr.distill import resolve_flashsr
    from ..models.flashsr.pipeline import FlashSRPipeline
    from ..models.rnnoise.model import FRAME, denoise
    from ..nodes.enhance_extras import Egregora_RNNoise_Denoise
    from ..ops.mix import adaptive_mix
    from ..ops.resample import resample
    from ..ops.spectral import spectral_enhance, upscale_factor

    device = torch.device(device)
    t0 = time.perf_counter()
    x = torch.as_tensor(x_cn, dtype=torch.float32, device=device)
    duration = x.shape[-1] / float(sr)
    marks = {}

    # 1) denoise at 48 kHz with the VAD-adaptive mix, on the weights the
    # RNNoise node serves
    rn_params = Egregora_RNNoise_Denoise._params()
    x48 = resample(x, sr, 48000) if sr != 48000 else x
    pad = (-x48.shape[1]) % FRAME
    wet, vads = denoise(rn_params, torch.nn.functional.pad(x48, (0, pad)))
    wet = wet[:, : x48.shape[1]]
    den = torch.stack([
        adaptive_mix(x48[c], wet[c], vads[c], strength=0.8,
                     mix_curve="equal_power", adaptive_mode="more_on_noise",
                     adaptive_amount=0.5, vad_threshold=0.9, vad_smooth_ms=50)
        for c in range(x48.shape[0])])
    marks["denoise"] = _wall(device, t0)
    print(f"[denoise] done ({marks['denoise']:.1f}s)")

    # 2) FlashSR chunked super-resolution (stays at 48 kHz); converted
    # checkpoints > trained > shipped distilled > random (loud warning)
    cfg, params, source = resolve_flashsr()
    print(f"[flashsr] weights: {source}")
    pipe = FlashSRPipeline(cfg, params=params, device=device)
    sr_out = pipe.process(AudioBuffer(den, 48000, {}), output_sr=48000, max_batch=8)
    marks["flashsr"] = _wall(device, t0)
    print(f"[flashsr] done ({marks['flashsr']:.1f}s)")

    # 3) Fat Llama light pass (few iterations), then 96 kHz delivery
    factor = max(2, upscale_factor(48000, sr_out.channels, 1411))
    enh = spectral_enhance(sr_out.samples, factor, 50, 0.6,
                           use_matmul_fft=device.type != "cpu")
    out96 = resample(enh, 48000 * factor, 96000)
    marks["enhance"] = _wall(device, t0)
    print(f"[enhance] factor {factor} -> 96 kHz ({marks['enhance']:.1f}s)")

    # 4) evaluation, all on the device
    rep = loudness_report(out96, 96000)
    ref96 = resample(x, sr, 96000)
    n = min(ref96.shape[1], out96.shape[1])
    m = lsd_sisdr_report(ref96[:, :n].mean(0), out96[:, :n].mean(0))
    metrics = {**{k: float(v) for k, v in rep.items()},
               **{k: float(v) for k, v in m.items()}}
    marks["eval"] = _wall(device, t0)
    wall = marks["eval"]
    metrics["wall_s"] = round(wall, 2)
    metrics["realtime_factor"] = round(duration / wall, 2)
    ends = list(marks.values())
    stages = {k: b - a for k, a, b in zip(marks, [0.0] + ends, ends)}
    where = card_line() if device.type == "cuda" else "cpu"
    print(f"[device] {where}: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; {duration:.1f} s of audio in {wall:.3f} s (RTF {duration / wall:.1f}x)")
    print(json.dumps(metrics, indent=2))
    return out96, metrics, stages


def main(in_path: str, out_path: str, device: str = "cuda") -> Dict[str, float]:
    """Read ``in_path``, run ``full_chain`` on ``device`` (the card unless
    "cpu"), write the 96 kHz result to ``out_path``; the metrics."""
    from ..core.audio import make_audio
    from ..utils.wavio import read_audio, write_audio

    dev = ensure_accelerator(device)
    cs, sr = read_audio(in_path)
    audio = make_audio(sr, cs)
    print(f"[load] {audio.duration_s:.1f}s @{sr} ({audio.channels} ch)")
    out96, metrics, _ = full_chain(audio.samples, sr, dev)
    write_audio(out_path, out96.cpu().numpy(), 96000)
    print(f"[save] {out_path}")
    return metrics


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m egregora_tpu_torch.examples.full_chain")
    ap.add_argument("infile")
    ap.add_argument("outfile", help="the 96 kHz WAV")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    main(args.infile, args.outfile, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
