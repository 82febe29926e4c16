"""Command-line interface of the port.

Counterpart of ``egregora_tpu/cli.py``, with its six subcommands, flags
and printed JSON:

  python -m egregora_tpu_torch.cli flashsr  --in a.wav --out b.wav --target-sr 48000
  python -m egregora_tpu_torch.cli enhance  --in a.wav --out b.wav --iterations 300
  python -m egregora_tpu_torch.cli eval     --ref a.wav --proc b.wav
  python -m egregora_tpu_torch.cli nulltest --ref a.wav --proc b.wav
  python -m egregora_tpu_torch.cli codec    --in a.wav --out b.wav --model-type 16khz
  python -m egregora_tpu_torch.cli loudness --in a.wav

A top-level ``--device {cuda,cpu}`` (before the subcommand; default
``cuda``) places every subcommand's work; asked for the card where there
is none, the CLI raises with ``utils.device.ensure_accelerator``'s
message.  ``flashsr`` also takes the reference CLI's own ``--device``
(``flashsr_min.py``'s), which, where given, places that subcommand.
Files are read and written at the host edge (``utils.wavio``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .utils.device import ensure_accelerator


def _load(path: str):
    from .core.audio import make_audio
    from .utils.wavio import read_audio
    cs, sr = read_audio(path)
    return make_audio(sr, cs)


def _save(path: str, buf) -> None:
    from .utils.wavio import write_audio
    write_audio(path, buf.numpy(), buf.sample_rate)


def _on(buf, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(buf.numpy(), np.float32)).to(device)


def cmd_flashsr(args, device: torch.device) -> int:
    from .models.flashsr.distill import resolve_flashsr
    from .models.flashsr.pipeline import FlashSRPipeline
    buf = _load(args.infile)
    cfg, params, source = resolve_flashsr()
    print(f"[flashsr] weights: {source}")
    pipe = FlashSRPipeline(cfg, params=params, device=device)
    out = pipe.process(buf, lowpass_input=args.lowpass_input, output_sr=args.target_sr)
    _save(args.outfile, out)
    print(f"[flashsr] {buf.duration_s:.2f}s @{buf.sample_rate} -> "
          f"{args.outfile} @{out.sample_rate}")
    return 0


def cmd_enhance(args, device: torch.device) -> int:
    from .core.audio import AudioBuffer
    from .ops.spectral import spectral_enhance, upscale_factor
    buf = _load(args.infile)
    factor = upscale_factor(buf.sample_rate, buf.channels, args.target_bitrate_kbps)
    y = spectral_enhance(_on(buf, device), factor, args.iterations, args.threshold,
                         use_matmul_fft=device.type != "cpu")
    _save(args.outfile, AudioBuffer(y, buf.sample_rate * factor, {}))
    print(f"[enhance] factor {factor}, {args.iterations} iterations -> {args.outfile}")
    return 0


def cmd_eval(args, device: torch.device) -> int:
    from .eval.metrics import lsd_sisdr_report
    a, b = _load(args.ref), _load(args.proc)
    am, bm = _on(a, device).mean(0), _on(b, device).mean(0)
    n = min(am.shape[0], bm.shape[0])
    rep = lsd_sisdr_report(am[:n], bm[:n])
    print(json.dumps({k: float(v) for k, v in rep.items()}))
    return 0


def cmd_nulltest(args, device: torch.device) -> int:
    import egregora_tpu_torch
    from .nodes.base import comfy_audio, node_device
    a, b = _load(args.ref), _load(args.proc)
    with node_device(device):
        node = egregora_tpu_torch.NODE_CLASS_MAPPINGS["Null Test (Full)"]()
        _m, _null, delay_ms, gain_db, metrics, *_ = node.execute(
            comfy_audio(a.sample_rate, a.numpy()), comfy_audio(b.sample_rate, b.numpy()),
            draw_waveforms=False, draw_spectrograms=False, draw_diffspec=False)
    metrics = dict(metrics)
    metrics["delay_ms"] = delay_ms
    metrics["gain_db"] = gain_db
    print(json.dumps({k: float(v) for k, v in metrics.items()}))
    return 0


def cmd_loudness(args, device: torch.device) -> int:
    from .eval.loudness import loudness_report
    buf = _load(args.infile)
    rep = loudness_report(_on(buf, device), buf.sample_rate)
    print(json.dumps({k: float(v) for k, v in rep.items()}))
    return 0


def cmd_codec(args, device: torch.device) -> int:
    """DAC encode -> decode roundtrip (the DAC node pair as one command)."""
    from .core.audio import AudioBuffer
    from .models.dac.model import build_dac
    from .ops.resample import resample

    buf = _load(args.infile)
    model, model_sr = build_dac(args.model_type)
    model.to(device)
    x = _on(buf, device)
    if buf.sample_rate != model_sr:
        x = resample(x, buf.sample_rate, model_sr)
    z_q, codes = model.encode(x)
    rec = model.decode(z_q)[:, : x.shape[-1]]
    _save(args.outfile, AudioBuffer(rec, model_sr, dict(buf.meta)))
    c = codes.shape
    print(json.dumps({"model_type": args.model_type, "sample_rate": model_sr,
                      "codes_shape": list(c),
                      "bitrate_kbps": round(
                          c[1] * np.log2(model.cfg.codebook_size)
                          * (model_sr / model.cfg.hop) / 1000.0, 2)}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="egregora_tpu_torch")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every subcommand runs (default: the card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("flashsr", help="FlashSR audio super-resolution")
    # flag names follow the reference CLI (flashsr_min.py:7-12)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir override (EGREGORA_TPU_WEIGHTS)")
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--out", dest="outfile", required=True)
    p.add_argument("--target-sr", type=int, default=48000, choices=(48000, 44100, 96000))
    p.add_argument("--lowpass-input", action="store_true")
    p.add_argument("--device", dest="flashsr_device", default=None,
                   help="the reference CLI's device flag: cuda or cpu (overrides the "
                        "top-level --device for this subcommand)")
    p.set_defaults(fn=cmd_flashsr)

    p = sub.add_parser("enhance", help="Fat-Llama-style spectral enhance")
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--out", dest="outfile", required=True)
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--target-bitrate-kbps", type=int, default=1411)
    p.set_defaults(fn=cmd_enhance)

    p = sub.add_parser("eval", help="SI-SDR / LSD metrics")
    p.add_argument("--ref", required=True)
    p.add_argument("--proc", required=True)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("nulltest", help="align + gain match + null test")
    p.add_argument("--ref", required=True)
    p.add_argument("--proc", required=True)
    p.set_defaults(fn=cmd_nulltest)

    p = sub.add_parser("codec", help="DAC encode/decode roundtrip")
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--out", dest="outfile", required=True)
    p.add_argument("--model-type", default="44khz", choices=("44khz", "24khz", "16khz"))
    p.set_defaults(fn=cmd_codec)

    p = sub.add_parser("loudness", help="BS.1770-style loudness report")
    p.add_argument("--in", dest="infile", required=True)
    p.set_defaults(fn=cmd_loudness)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "ckpt_dir", None):
        import os
        os.environ["EGREGORA_TPU_WEIGHTS"] = args.ckpt_dir
    device = getattr(args, "flashsr_device", None) or args.device
    return args.fn(args, ensure_accelerator(device))


if __name__ == "__main__":
    sys.exit(main())
