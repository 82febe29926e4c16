"""Train the RNNoise-class denoiser on synthetic mixtures: the port of
``egregora_tpu/models/rnnoise/train.py``.

The whole frame pipeline (band analysis -> GRU stack -> gains -> OLA) is
differentiable, so a denoiser is distilled from synthetic speech-proxy +
noise mixtures made on the fly: "speech" is a harmonic stack with a
random f0 and a syllabic (2-6 Hz) on/off envelope, "noise" white or
8-tap low-passed at a random SNR.  The loss regresses the RNN's 22 band
gains on the ideal ratio ``sqrt(Eclean / Enoisy)`` (gamma 0.5, bands that
carry signal only), plus VAD BCE and a band-energy and waveform term on
the output, one frame (the OLA's lookahead) aligned.

Two data paths, as in the JAX package: ``train`` draws each batch in
numpy (``synth_batch``, the same generator, bit for bit) and
``train_device`` draws the JAX ``synth_batch_device``'s random numbers on
the host from the same keys (``models.flashsr.prng``: ``fold_in(
PRNGKey(seed + 1), step)``, ``split``) and synthesises the waves on the
training device.  Both step ``optax.chain(clip_by_global_norm(1),
adam(cosine_decay_schedule(lr, steps, 0.05)))`` (``models.optim``).

The JAX package ships its weights as
``egregora_tpu/models/rnnoise/pretrained.npz``.  This trainer writes under
``weights_dir() / "rnnoise"`` (or ``--out``), never into the JAX package;
``load_pretrained`` (and so the node) serves that file where it exists
(``served_path``), else the shipped one in place, so that what the
trainer writes is what the node serves next, as in the JAX package.

    python -m egregora_tpu_torch.models.rnnoise.train [--steps 4000]
        [--batch 16] [--cpu] [--out PATH]
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..flashsr import prng
from ..flashsr.distill import _device
from ..optim import AdamChain
from .model import FRAME, PCM_SCALE, HP_A, HP_B, init_params

SR = 48000
SHIPPED = (Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "rnnoise"
           / "pretrained.npz")


def synth_batch(rng: np.random.Generator, batch: int, frames: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(noisy, clean, vad_target[frames]) batches of ``frames*FRAME`` samples."""
    t = frames * FRAME
    time = np.arange(t) / SR
    noisy = np.empty((batch, t), np.float32)
    clean = np.empty((batch, t), np.float32)
    vad = np.empty((batch, frames), np.float32)
    for b in range(batch):
        f0 = rng.uniform(100, 300)
        n_h = 8
        amps = rng.uniform(0.05, 0.3, n_h) / np.arange(1, n_h + 1)
        speech = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * time + rng.uniform(0, 6.28))
                     for h, a in enumerate(amps))
        # syllabic on/off envelope, smoothed
        env_rate = rng.uniform(2.0, 6.0)
        gate = (np.sin(2 * np.pi * env_rate * time + rng.uniform(0, 6.28)) > 0)
        k = int(0.01 * SR)
        env = np.convolve(gate.astype(np.float32), np.ones(k) / k, mode="same")
        s = (speech * env).astype(np.float32)

        noise = rng.standard_normal(t).astype(np.float32)
        if rng.uniform() < 0.5:  # lowpass-ish colored noise half the time
            noise = np.convolve(noise, np.ones(8) / 8, mode="same").astype(np.float32)
        snr_db = rng.uniform(0.0, 15.0)
        s_pow = np.mean(s ** 2) + 1e-9
        n_pow = np.mean(noise ** 2) + 1e-9
        noise *= np.sqrt(s_pow / n_pow / 10 ** (snr_db / 10))

        clean[b] = s
        noisy[b] = s + noise
        fr_env = env.reshape(frames, FRAME).mean(axis=1)
        vad[b] = (fr_env > 0.3).astype(np.float32)
    peak = np.abs(noisy).max(axis=1, keepdims=True) + 1e-6
    scale = np.minimum(1.0, 0.8 / peak)
    return noisy * scale, clean * scale, vad


# ---- synth_batch_device: host draws, device synthesis ----------------------

def synth_draws(key: np.ndarray, batch: int, frames: int) -> Dict[str, np.ndarray]:
    """Every random number of the JAX ``synth_batch_device(key, batch,
    frames)``, stacked over the batch: ``split(key, batch)``, then per item
    ``split(k, 8)`` and the same ``uniform`` / ``normal`` draws (host
    numpy; uniforms bit for bit, normals within 1e-6)."""
    t = frames * FRAME
    items = []
    for k in prng.split(np.asarray(key, np.uint32), batch):
        ks = prng.split(k, 8)
        items.append({"f0": prng.uniform(ks[0], (), 100.0, 300.0),
                      "amps": prng.uniform(ks[1], (8,), 0.05, 0.3),
                      "ph": prng.uniform(ks[2], (8,), 0.0, 6.28),
                      "env_rate": prng.uniform(ks[3], (), 2.0, 6.0),
                      "env_ph": prng.uniform(ks[4], (), 0.0, 6.28),
                      "noise": prng.normal_from_key(ks[5], (t,)),
                      "coin": prng.uniform(ks[6], (), 0.0, 1.0),
                      "snr_db": prng.uniform(ks[7], (), 0.0, 15.0)})
    return {name: np.stack([d[name] for d in items]) for name in items[0]}


def _movavg(x: torch.Tensor, k: int) -> torch.Tensor:
    """The JAX ``movavg``: a centred k-tap box mean from a cumulative sum
    (``[B, T]``)."""
    t = x.shape[-1]
    cs = torch.cumsum(torch.nn.functional.pad(x, (k // 2 + 1, k - k // 2)), -1)
    return (cs[..., k:] - cs[..., :-k])[..., :t] / k


def synth_from_draws(d: Dict[str, np.ndarray], frames: int, device="cuda"):
    """The JAX ``synth_batch_device``'s synthesis over a batch of draws, in
    float32 torch on ``device``: (noisy, clean, vad) ``[B, T]``, ``[B, T]``,
    ``[B, frames]``."""
    T = lambda name: torch.as_tensor(d[name]).to(device)        # noqa: E731
    t = frames * FRAME
    time = torch.arange(t, dtype=torch.float32, device=device) / SR
    h = torch.arange(1, 9, dtype=torch.float32, device=device)
    f0, amps = T("f0")[:, None, None], (T("amps") / h)[:, :, None]
    sp = torch.sum(amps * torch.sin(2 * math.pi * f0 * h[:, None] * time
                                    + T("ph")[:, :, None]), dim=1)
    gate = torch.sin(2 * math.pi * T("env_rate")[:, None] * time + T("env_ph")[:, None]) > 0
    env = _movavg(gate.float(), int(0.01 * SR))
    s = sp * env
    noise = T("noise")
    noise = torch.where(T("coin")[:, None] < 0.5, _movavg(noise, 8), noise)
    s_pow = torch.mean(s * s, -1, keepdim=True) + 1e-9
    n_pow = torch.mean(noise * noise, -1, keepdim=True) + 1e-9
    noise = noise * torch.sqrt(s_pow / n_pow / 10 ** (T("snr_db")[:, None] / 10))
    vad = (env.reshape(-1, frames, FRAME).mean(-1) > 0.3).float()
    noisy = s + noise
    peak = torch.amax(torch.abs(noisy), dim=1, keepdim=True) + 1e-6
    scale = torch.clamp(0.8 / peak, max=1.0)
    return noisy * scale, s * scale, vad


def synth_batch_device(key: np.ndarray, batch: int, frames: int, device="cuda"):
    """The JAX ``synth_batch_device(key, batch, frames)``: its draws on the
    host from ``key`` (a threefry key ``[2]`` uint32), the waves on
    ``device``."""
    return synth_from_draws(synth_draws(key, batch, frames), frames, device)


# ---- loss -------------------------------------------------------------------

def _band_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Log band-energy distance on 960-sample windows (the model's own
    analysis bands)."""
    from ...ops.stft import device_tensor, frame_strided
    from .model import WINDOW, _band_matrix_energy, _vorbis_window
    win = device_tensor(_vorbis_window, device=str(a.device))
    bm = device_tensor(_band_matrix_energy, device=str(a.device))
    n = a.shape[-1] // FRAME - 1

    def spec_bands(x):
        s = torch.fft.rfft(frame_strided(x, WINDOW, FRAME)[..., :n, :] * win, dim=-1)
        return torch.log10(torch.abs(s) ** 2 @ bm + 1e-6)

    return torch.mean(torch.square(spec_bands(a) - spec_bands(b)))


def filtered_target(clean: torch.Tensor) -> torch.Tensor:
    """RNNoise's input DC-blocking biquad applied to the clean target (the
    model denoises the filtered signal, and its output keeps the filter's
    colouration)."""
    from ...ops.iir import biquad
    return biquad(clean * PCM_SCALE, b=HP_B, a=HP_A) / PCM_SCALE


def loss_fn(params: Dict, noisy: torch.Tensor, clean: torch.Tensor,
            vad_t: torch.Tensor) -> torch.Tensor:
    """Oracle band-gain distillation: ``10 l_gain + 0.2 l_vad + 0.2 l_spec
    + l_wave`` over a batch ``[B, T]``, as the JAX ``loss_fn``."""
    from .model import _denoise_batch, band_energies

    clean = filtered_target(clean)
    out, vad, gains, ex = _denoise_batch(params, noisy, 1, 100)

    ec = band_energies(clean)                                  # [B, F, 22]
    g_star = torch.clamp(torch.sqrt(ec / (ex + 1e-9)), 0.0, 1.0)
    gamma = 0.5
    # only bands that carry signal in the mixture are supervised
    active = (ex > 1e-2).float()
    l_gain = torch.sum(active * torch.square(gains ** gamma - g_star ** gamma)
                       ) / (torch.sum(active) + 1.0)

    # the OLA pipeline's one-frame lookahead: out[n] reconstructs n - FRAME
    out_a = out[:, 2 * FRAME:]
    clean_a = clean[:, FRAME:-FRAME]
    l_spec = _band_mse(out_a, clean_a)
    l_wave = 10.0 * torch.mean(torch.square(out_a - clean_a))

    eps = 1e-6
    vad_a = vad[:, 1:]
    vad_ta = vad_t[:, :-1]
    l_vad = -torch.mean(vad_ta * torch.log(vad_a + eps)
                        + (1 - vad_ta) * torch.log(1 - vad_a + eps))
    return 10.0 * l_gain + 0.2 * l_vad + 0.2 * l_spec + l_wave


# ---- trainers ---------------------------------------------------------------

def trainable(params: Dict, device) -> Dict:
    """The tree's leaves as float32 leaf tensors on ``device`` that
    require a gradient."""
    if isinstance(params, dict):
        return {k: trainable(v, device) for k, v in params.items()}
    return torch.tensor(np.asarray(params, np.float32), device=device, requires_grad=True)


def leaves(tree: Dict) -> list:
    """The tree's leaves in sorted-key order (``jax.tree_util``'s)."""
    from ...utils.weights import sorted_leaves
    return [v for _, v in sorted_leaves(tree)]


def to_numpy(tree: Dict) -> Dict:
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def make_step(loss, params: Dict, opt: AdamChain):
    """``step(*batch) -> loss``: the loss and its gradient (the backward's
    convolutions in full float32 too, as the forward's), then one optimizer
    update of ``params`` in place."""
    from ...ops.fir import exact_f32
    ps = leaves(params)

    def step(*batch) -> torch.Tensor:
        with exact_f32():
            lv = loss(params, *batch)
            grads = torch.autograd.grad(lv, ps, allow_unused=True)
        opt.step(list(grads))
        return lv.detach()

    return step


def _log(tag: str, i: int, steps: int, log_every: int, lv: torch.Tensor) -> None:
    if log_every and (i % log_every == 0 or i == steps - 1):
        print(f"[{tag}] step {i}: loss {float(lv):.4f}", flush=True)


def train(steps: int = 300, batch: int = 8, frames: int = 50, lr: float = 3e-3,
          seed: int = 0, log_every: int = 50, device="cuda") -> Dict:
    """The JAX ``train``: numpy batches (``synth_batch`` on
    ``default_rng(seed)``), clip 1 + Adam on a cosine schedule to 5%;
    returns the parameter tree (numpy)."""
    dev = _device(device)
    params = trainable(init_params(seed), dev)
    opt = AdamChain(leaves(params), lr, max(steps, 1), 0.05, clip=1.0)
    step = make_step(loss_fn, params, opt)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        noisy, clean, vad_t = (torch.from_numpy(a).to(dev) for a in synth_batch(rng, batch, frames))
        _log("rnnoise-train", i, steps, log_every, step(noisy, clean, vad_t))
    return to_numpy(params)


def train_device(steps: int = 4000, batch: int = 16, frames: int = 50,
                 lr: float = 3e-3, seed: int = 0, log_every: int = 250, device="cuda") -> Dict:
    """The JAX ``train_device``: each step's batch from ``fold_in(
    PRNGKey(seed + 1), step)`` (host draws, device synthesis), clip 1 + Adam
    on a cosine schedule to 5%; returns the parameter tree (numpy)."""
    dev = _device(device)
    params = trainable(init_params(seed), dev)
    opt = AdamChain(leaves(params), lr, steps, 0.05, clip=1.0)
    step = make_step(loss_fn, params, opt)
    base = prng.prng_key(seed + 1)
    for i in range(steps):
        noisy, clean, vad_t = synth_batch_device(prng.fold_in(base, i), batch, frames, dev)
        _log("rnnoise-train", i, steps, log_every, step(noisy, clean, vad_t))
    return to_numpy(params)


def pretrained_path() -> Path:
    """The JAX package's shipped weights, which the port reads in place."""
    return SHIPPED


def served_path() -> Path:
    """The weights the node serves: ``output_path()`` where the trainer
    wrote it, else the shipped file."""
    from ...utils.weights import served_file
    return served_file(output_path(), pretrained_path())


def load_pretrained() -> Dict | None:
    """The served weights (``served_path``) as a nested dict of numpy
    arrays, or None where the file is missing."""
    p = served_path()
    if not p.exists():
        return None
    from ...utils.weights import load_params
    return load_params(p)


def output_path() -> Path:
    """Where the CLI writes by default: ``weights_dir() / "rnnoise" /
    "pretrained.npz"``."""
    from ...utils.weights import weights_dir
    return weights_dir() / "rnnoise" / "pretrained.npz"


def main(argv=None) -> None:
    import argparse

    from ...utils.weights import save_params

    ap = argparse.ArgumentParser(description="Distill RNNoise weights")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU, not the card")
    ap.add_argument("--out", type=Path, default=None,
                    help="output npz (default: $EGREGORA_TPU_WEIGHTS/rnnoise/pretrained.npz)")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    print("device:", _device(device), flush=True)
    params = train_device(steps=a.steps, batch=a.batch, device=device)
    out = a.out or output_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    save_params(params, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
