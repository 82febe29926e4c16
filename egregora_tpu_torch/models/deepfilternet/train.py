"""Synthetic distillation of the DeepFilterNet-class denoiser: the port of
``egregora_tpu/models/deepfilternet/train.py``.

The same approach as ``models/rnnoise/train.py``: the ERB-gain and
deep-filter pipeline is differentiable end to end (its GRUs too: one
cuDNN recurrence on the parameters), so it trains on synthetic
speech-proxy + noise mixtures.  The loss regresses the 32 ERB gains on
the ideal ratio (gamma 0.5, bands that carry signal only) and adds a log
ERB-energy and a waveform term; the STFT / inverse pair reconstructs in
place, so nothing is aligned.

``train_device`` steps ``clip_by_global_norm(1) + adam(cosine(lr, steps,
0.05))`` on RNNoise's ``synth_batch_device`` data (host draws, device
synthesis); ``train`` steps plain Adam (no clipping, as the JAX package's)
on numpy ``synth_batch`` batches.  The variant's topology comes from
``DFNConfig.for_variant``: DFN2's grouped GRU, DFN3's squeezed GRU.

The JAX package ships one weight set a variant in
``egregora_tpu/models/deepfilternet/``; ``load_pretrained`` reads them in
place.  This trainer writes under ``weights_dir() / "deepfilternet"`` (or
``--out``), never into the JAX package.

    python -m egregora_tpu_torch.models.deepfilternet.train
        [--variant DeepFilterNet2|DeepFilterNet3] [--steps 1500] [--batch 4]
        [--cpu] [--out PATH]
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..flashsr import prng
from ..optim import AdamChain
from ..rnnoise.train import (_device, _log, leaves, make_step, synth_batch,
                             synth_batch_device, to_numpy, trainable)
from .model import DFNConfig, init_params

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "deepfilternet"


def _band_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from ...ops.stft import device_tensor, stft_conv
    from .model import HOP, N_FFT, erb_filterbank
    fb = device_tensor(erb_filterbank, device=str(a.device))
    ra, ia = stft_conv(a, N_FFT, HOP)
    rb, ib = stft_conv(b, N_FFT, HOP)
    ea = torch.log10((ra * ra + ia * ia) @ fb + 1e-8)
    eb = torch.log10((rb * rb + ib * ib) @ fb + 1e-8)
    return torch.mean(torch.square(ea - eb))


def loss_fn(params: Dict, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """Oracle ERB-gain regression plus the end-to-end spectral and
    waveform terms, ``10 l_gain + 0.3 band_mse + 10 mse`` over a batch
    ``[B, T]``, as the JAX ``loss_fn``."""
    from .model import enhance_mono_full, erb_band_energies

    out, gains, en = enhance_mono_full(params, noisy)
    ec = erb_band_energies(clean)
    g_star = torch.clamp(torch.sqrt(ec / (en + 1e-10)), 0.0, 1.0)
    active = (en > 1e-7).float()
    l_gain = torch.sum(active * torch.square(gains ** 0.5 - g_star ** 0.5)
                       ) / (torch.sum(active) + 1.0)
    return (10.0 * l_gain + 0.3 * _band_mse(out, clean)
            + 10.0 * torch.mean(torch.square(out - clean)))


def train_device(steps: int = 1500, batch: int = 4, frames: int = 50, lr: float = 1e-3,
                 seed: int = 0, log_every: int = 100, cfg: DFNConfig = DFNConfig(),
                 device="cuda") -> Dict:
    """The JAX ``train_device``: each step's batch from ``fold_in(
    PRNGKey(seed + 1), step)`` (host draws, device synthesis), clip 1 +
    Adam on a cosine schedule to 5%; returns the parameter tree (numpy)."""
    dev = _device(device)
    params = trainable(init_params(seed, cfg), dev)
    opt = AdamChain(leaves(params), lr, steps, 0.05, clip=1.0)
    step = make_step(loss_fn, params, opt)
    base = prng.prng_key(seed + 1)
    for i in range(steps):
        noisy, clean, _ = synth_batch_device(prng.fold_in(base, i), batch, frames, dev)
        _log("dfn-train", i, steps, log_every, step(noisy, clean))
    return to_numpy(params)


def train(steps: int = 1500, batch: int = 4, frames: int = 50, lr: float = 1e-3,
          seed: int = 0, log_every: int = 250, device="cuda") -> Dict:
    """The JAX ``train``: DFN2 on numpy batches (``synth_batch`` on
    ``default_rng(seed)``), Adam on a cosine schedule to 5% without
    clipping; returns the parameter tree (numpy)."""
    dev = _device(device)
    params = trainable(init_params(seed), dev)
    opt = AdamChain(leaves(params), lr, steps, 0.05, clip=None)
    step = make_step(loss_fn, params, opt)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        noisy, clean, _ = (torch.from_numpy(a).to(dev) for a in synth_batch(rng, batch, frames))
        _log("dfn-train", i, steps, log_every, step(noisy, clean))
    return to_numpy(params)


def pretrained_path(variant: str = "DeepFilterNet2") -> Path:
    """The JAX package's shipped weights of ``variant``, read in place."""
    name = "pretrained.npz" if str(variant) == "DeepFilterNet2" else "pretrained_dfn3.npz"
    return SHIPPED_DIR / name


def load_pretrained(variant: str = "DeepFilterNet2") -> Dict | None:
    """The variant's shipped weights as a nested dict of numpy arrays, or
    None where the file is missing."""
    p = pretrained_path(variant)
    if not p.exists():
        return None
    from ...utils.weights import load_params
    return load_params(p)


def output_path(variant: str = "DeepFilterNet2") -> Path:
    """Where the CLI writes by default: ``weights_dir() / "deepfilternet" /``
    the shipped file's name."""
    from ...utils.weights import weights_dir
    return weights_dir() / "deepfilternet" / pretrained_path(variant).name


def main(argv=None) -> None:
    import argparse

    from ...utils.weights import save_params

    ap = argparse.ArgumentParser(description="Distill DFN weights")
    ap.add_argument("--variant", default="DeepFilterNet2",
                    choices=["DeepFilterNet2", "DeepFilterNet3"])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU, not the card")
    ap.add_argument("--out", type=Path, default=None,
                    help="output npz (default: $EGREGORA_TPU_WEIGHTS/deepfilternet/<shipped "
                         "name>)")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    print("device:", _device(device), flush=True)
    params = train_device(steps=a.steps, batch=a.batch, cfg=DFNConfig.for_variant(a.variant),
                          device=device)
    out = a.out or output_path(a.variant)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_params(params, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
