"""DAC synthetic distillation, the shipped codecs and the quality gate: the
port of ``egregora_tpu/models/dac/train.py``.

A compact DAC (``distilled_config``: hop 128, or 64 at 16 kHz; 9 books of
1024 x 16) is trained on synthetic music-like audio
(``models.flashsr.distill.synth_pair_batch``: host draws from the JAX
package's keys, synthesis on the training device) as a VQ-VAE with
straight-through residual quantization, in three phases (``train``):

1. ``ae``: the plain autoencoder (no quantizer in the path) until the
   latent carries the signal: ``40 wave_l2 + stft_w * mr_stft + 0.5
   (rms(z) - 1)^2`` (``ae_loss_fn``);
2. the codebooks from data (``init_codebooks_from_data``), then ``proj``:
   the quantizer alone (encoder and decoder given zero gradients, which
   ``adamw`` still decays) learns to reproduce the frozen latent
   (``proj_loss_fn``), with EMA codebook updates;
3. ``vq``: the whole codec on ``ema_loss_fn`` (the reconstruction, the
   commitment term, a full-space latent match and the scale term) with EMA
   cluster statistics moving the codebooks and dead rows restarted from
   the batch's residuals (``ema_codebook_update``).

Each phase steps ``clip_by_global_norm(1) + adamw(cosine(lr, steps, 0.1),
weight_decay=1e-5)`` (``models.optim``, optax's arithmetic) ``scan_size``
steps a dispatch, the STFT weight per dispatch (``_stft_w_schedule``);
every random number comes from the JAX package's key chain
(``models.flashsr.prng``), so a seed draws the JAX package's data, EMA
restarts and codebook picks.  ``DACModel.init_params(seed)`` is flax's
init, draw for draw.  Parameters live in the ``DACModel``'s modules (the
EMA update overwrites the codebook parameters in place); ``train`` and
``finetune`` return ``(model, params)`` with ``params`` the JAX package's
tree (numpy).

``finetune`` continues the VQ phase from a shipped codec; the guarded runs
ship a candidate only where the four-draw gate (``gate_metrics``: mean and
worst roundtrip SNR, mean LSD) moves toward ``TARGETS``
(``should_ship``).

The JAX package ships its codecs as
``egregora_tpu/models/dac/pretrained_{44,24,16}khz.npz``.  This trainer
writes its candidates and mid-run checkpoints (``.ckpt.npz``) under
``weights_dir() / "dac"`` (or ``--out``), never into the JAX package.
``load_pretrained(model_type)`` serves ``served_path(model_type)``: the
codec a guarded run shipped to ``output_path`` where there is one, else
the shipped file in place.  So ``build_dac``, ``finetune`` and the next
guarded run's incumbent read what the last guarded run shipped, as in the
JAX package, whose guarded runs overwrite the shipped file;
``load_pretrained(model_type, path)`` reads any such file.

    python -m egregora_tpu_torch.models.dac.train [--model-type 44khz]
        [--steps 2000 --batch 8 --length 16384 --lr 3e-4 --seed 0 --scan 1]
        [--ae-frac 0.5] [--finetune] [--guarded [--retrain --encoder-dim N
        --hop 32|64|128 --codebook-dim N --decoder-dim N]] [--stft-w 0.25
        --lsd-w 0 --stft-w-end 0] [--cpu] [--out PATH]
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.fir import exact_f32
from ..flashsr import prng
from ..flashsr.distill import _device
from ..optim import AdamChain
from .model import DACConfig, DACModel

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "dac"
PRETRAINED = {t: SHIPPED_DIR / f"pretrained_{t}.npz" for t in ("44khz", "24khz", "16khz")}

_RATES = {"44khz": 44100, "24khz": 24000, "16khz": 16000}


def distilled_config(model_type: str = "44khz") -> DACConfig:
    """The compact codec of each model type (fewer channels and books than
    upstream; hop 128, or 64 at 16 kHz; 9 books of 1024 x 16 under EMA
    updates)."""
    if model_type not in _RATES:
        raise ValueError(f"unknown DAC model_type {model_type!r}")
    strides = (2, 4, 4, 2) if model_type == "16khz" else (2, 4, 4, 4)
    return DACConfig(sample_rate=_RATES[model_type], encoder_dim=24,
                     strides=strides, decoder_dim=384, n_codebooks=9,
                     codebook_size=1024, codebook_dim=16, res_scale=0.5,
                     output_tanh=False, alpha_floor=0.05)


# ---- the codec's pieces as the losses call them ----------------------------

def _encode(model: DACModel, wav: torch.Tensor) -> torch.Tensor:
    """``[B, T] -> [B, T / hop, latent]`` float32 (the JAX layout)."""
    return model.encoder(wav[:, None]).transpose(1, 2)


def _decode(model: DACModel, z: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, T / hop, latent] -> [B, n]`` float32."""
    return model.decoder(z.transpose(1, 2))[:, :n]


def _stft_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1 at n_fft 512 / 2048 (hop a
    quarter; periodic Hann)."""
    from ...ops.stft import stft_conv
    total = 0.0
    for n_fft, hop in ((512, 128), (2048, 512)):
        rx, ix = stft_conv(x, n_fft, hop, window="hann_periodic")
        ry, iy = stft_conv(y, n_fft, hop, window="hann_periodic")
        mx = torch.sqrt(rx * rx + ix * ix + 1e-9)
        my = torch.sqrt(ry * ry + iy * iy + 1e-9)
        total = total + torch.sum(torch.square(mx - my)) / (torch.sum(torch.square(my)) + 1e-9)
        total = total + torch.mean(torch.abs(torch.log(mx) - torch.log(my)))
    return total


def _lsd_db(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A differentiable copy of the gate's LSD (n_fft 2048, hop 512,
    symmetric Hann): mean over frames of the RMS-over-frequency dB error."""
    from ...ops.stft import stft_conv
    rx, ix = stft_conv(x, 2048, 512, window="hann")
    ry, iy = stft_conv(y, 2048, 512, window="hann")
    mx2 = rx * rx + ix * ix + 1e-12
    my2 = ry * ry + iy * iy + 1e-12
    d = 10.0 * (torch.log10(mx2) - torch.log10(my2))
    per = torch.sqrt(torch.mean(torch.square(d), dim=-1) + 1e-9)
    return torch.mean(per)


def _recon_terms(model, z, z_q, wav, stft_w, lsd_w) -> torch.Tensor:
    """``40 wave_l2 + stft_w * mr_stft + latent_match + 0.5 scale_reg (+
    lsd_w * lsd)`` of a quantized roundtrip."""
    rec = _decode(model, z_q, wav.shape[-1])
    wave_l2 = torch.mean(torch.square(rec - wav))
    rms = torch.sqrt(torch.mean(torch.square(z)) + 1e-9)
    scale_reg = torch.square(rms - 1.0)
    denom_z = torch.mean(torch.square(z)).detach() + 1e-6
    latent_match = torch.mean(torch.square(z_q - z.detach())) / denom_z
    loss = 40.0 * wave_l2 + stft_w * _stft_l2(rec, wav) + latent_match + 0.5 * scale_reg
    if lsd_w:
        loss = loss + lsd_w * _lsd_db(wav, rec)
    return loss


def loss_fn(model: DACModel, wav: torch.Tensor, stft_w: float = 0.25,
            lsd_w: float = 0.0) -> torch.Tensor:
    """``wav [B, T]`` -> scalar: the encoder / straight-through RVQ /
    decoder roundtrip with the commitment and codebook terms."""
    z = _encode(model, wav)
    z_q, _, commit, codebook = model.rvq(z, with_losses=True)
    return _recon_terms(model, z, z_q, wav, stft_w, lsd_w) + 0.25 * commit + codebook


def ema_loss_fn(model: DACModel, wav: torch.Tensor, stft_w: float = 0.25,
                lsd_w: float = 0.0):
    """``loss_fn`` without the codebook term (EMA statistics move the
    codebooks); returns ``(loss, (codes, r_stack))`` for the EMA update."""
    z = _encode(model, wav)
    z_q, codes, commit, _, r_stack = model.rvq(z, with_losses=True, collect_stage_data=True)
    return _recon_terms(model, z, z_q, wav, stft_w, lsd_w) + 0.25 * commit, (codes, r_stack)


def proj_loss_fn(model: DACModel, wav: torch.Tensor, stft_w: Optional[float] = None):
    """RVQ warm-up: the quantizer chain reproduces the frozen encoder's
    latent, ``latent_match + 0.25 commit``; returns ``(loss, (codes,
    r_stack))``.  ``stft_w`` is taken and not used, as ``_run_phase``
    passes one."""
    with torch.no_grad():
        z = _encode(model, wav)
    z_q, codes, commit, _, r_stack = model.rvq(z, with_losses=True, collect_stage_data=True)
    denom_z = torch.mean(torch.square(z)) + 1e-6
    return torch.mean(torch.square(z_q - z)) / denom_z + 0.25 * commit, (codes, r_stack)


def ae_loss_fn(model: DACModel, wav: torch.Tensor, stft_w: float = 0.25,
               lsd_w: float = 0.0) -> torch.Tensor:
    """Phase A: the plain encoder -> decoder reconstruction (no quantizer)."""
    z = _encode(model, wav)
    rec = _decode(model, z, wav.shape[-1])
    wave_l2 = torch.mean(torch.square(rec - wav))
    rms = torch.sqrt(torch.mean(torch.square(z)) + 1e-9)
    loss = 40.0 * wave_l2 + stft_w * _stft_l2(rec, wav) + 0.5 * torch.square(rms - 1.0)
    if lsd_w:
        loss = loss + lsd_w * _lsd_db(wav, rec)
    return loss


# ---- the EMA codebooks -------------------------------------------------------

def _books(model: DACModel):
    return [getattr(model.rvq, f"codebook_{i}") for i in range(model.cfg.n_codebooks)]


def init_ema_state(cfg: DACConfig, model: DACModel) -> Dict[str, torch.Tensor]:
    """EMA cluster statistics seeded from the current codebooks with unit
    mass (``sums / counts`` reproduces the books exactly)."""
    books = torch.stack([b.detach().float() for b in _books(model)])
    counts = torch.ones(cfg.n_codebooks, cfg.codebook_size, device=books.device)
    return {"counts": counts, "sums": books * counts[..., None]}


@torch.no_grad()
def ema_codebook_update(cfg: DACConfig, model: DACModel, ema: Dict[str, torch.Tensor],
                        codes: torch.Tensor, r_stack: torch.Tensor, key: np.ndarray,
                        decay: float = 0.99, restart_thresh: float = 0.03
                        ) -> Dict[str, torch.Tensor]:
    """One EMA step a stage: counts and sums track this batch's assignments,
    book = sums / counts; rows whose mass decays below ``restart_thresh``
    restart to a random projected residual (``randint`` and ``normal`` from
    ``key``'s chain, as the JAX package draws them).  ``codes [B, n_q, T]``,
    ``r_stack [n_q, B, T, d]``.  The codebook parameters are overwritten in
    place (the optimizer's state stays keyed by them); returns the new
    statistics."""
    dev = r_stack.device
    new_counts, new_sums = [], []
    for i, book in enumerate(_books(model)):
        idx = codes[:, i].reshape(-1).long()
        r = r_stack[i].reshape(-1, cfg.codebook_dim).float()
        onehot = F.one_hot(idx, cfg.codebook_size).float()
        n = decay * ema["counts"][i] + (1.0 - decay) * onehot.sum(0)
        s = decay * ema["sums"][i] + (1.0 - decay) * (onehot.T @ r)
        key, k1, k2 = prng.split(key, 3)
        pick = torch.from_numpy(prng.randint(k1, (cfg.codebook_size,), 0, r.shape[0])).to(dev)
        noise = torch.from_numpy(prng.normal_from_key(k2, (cfg.codebook_size, cfg.codebook_dim)))
        picks = r[pick.long()] * (1.0 + 0.01 * noise.to(dev))
        dead = n < restart_thresh
        n = torch.where(dead, torch.ones_like(n), n)
        s = torch.where(dead[:, None], picks, s)
        book.copy_(s / (n[:, None] + 1e-7))
        new_counts.append(n)
        new_sums.append(s)
    return {"counts": torch.stack(new_counts), "sums": torch.stack(new_sums)}


@torch.no_grad()
def init_codebooks_from_data(model: DACModel, wav: torch.Tensor, seed: int = 0) -> DACModel:
    """Data-dependent codebook init: the encoder over a batch, then per
    stage the codebook rows set to projected-residual samples picked by
    ``choice`` (without replacement where there are enough frames; the JAX
    package's key chain from ``PRNGKey(seed + 77)``) times ``1 + 0.01 N``,
    the residual then reduced by the stage's quantized contribution.  In
    place; returns ``model``."""
    cfg = model.cfg
    with exact_f32():
        residual = _encode(model, wav)
        key = prng.prng_key(seed + 77)
        for i, book in enumerate(_books(model)):
            proj_in = getattr(model.rvq, f"proj_in_{i}")
            pr = proj_in(residual)
            r = pr.reshape(-1, cfg.codebook_dim)
            key, k = prng.split(key)
            idx = prng.choice(k, r.shape[0], (cfg.codebook_size,),
                              replace=r.shape[0] < cfg.codebook_size)
            key, k = prng.split(key)
            noise = prng.normal_from_key(k, (cfg.codebook_size, cfg.codebook_dim))
            new = r[torch.from_numpy(idx).long().to(r.device)] * (
                1.0 + 0.01 * torch.from_numpy(noise).to(r.device))
            book.copy_(new)
            d2 = (torch.sum(pr ** 2, -1, keepdim=True) - 2.0 * pr @ new.T
                  + torch.sum(new ** 2, -1)[None, None, :])
            residual = residual - getattr(model.rvq, f"proj_out_{i}")(new[d2.argmin(-1)])
    return model


# ---- steps and phases -----------------------------------------------------------

def make_optimizer(model: DACModel, lr: float, steps: int) -> AdamChain:
    """A phase's ``clip_by_global_norm(1) + adamw(cosine_decay_schedule(lr,
    steps, 0.1), weight_decay=1e-5)`` over every parameter of the codec."""
    return AdamChain(model.parameters(), lr, steps, 0.1, clip=1.0, weight_decay=1e-5)


def _zero_outside_rvq(model: DACModel, grads: list) -> list:
    """The projection warm-up's mask: zeros (not ``None``) for the encoder's
    and decoder's gradients, which ``adamw`` then still decays."""
    rvq = {id(p) for p in model.rvq.parameters()}
    return [g if id(p) in rvq else torch.zeros_like(p)
            for p, g in zip(model.parameters(), grads)]


def _grad_step(model: DACModel, opt: AdamChain, lv: torch.Tensor, rvq_only: bool) -> None:
    params = list(model.parameters())
    grads = list(torch.autograd.grad(lv, params, allow_unused=True))
    if rvq_only:
        grads = _zero_outside_rvq(model, grads)
    opt.step(grads)


def make_scan_step(model: DACModel, opt: AdamChain, batch: int, length: int, sr: int,
                   scan_size: int, loss=loss_fn):
    """``steps(key, stft_w) -> mean loss``: ``scan_size`` optimizer steps on
    the keys ``split(key, scan_size)``, each on a fresh synthetic batch."""
    from ..flashsr.distill import synth_pair_batch
    dev = model.device

    def steps(key: np.ndarray, stft_w: float) -> torch.Tensor:
        losses = []
        for k in prng.split(np.asarray(key, np.uint32), scan_size):
            _, hr = synth_pair_batch(k, batch, length, sr=sr, device=dev)
            with exact_f32():
                lv = loss(model, hr, stft_w=stft_w)
                _grad_step(model, opt, lv, False)
            losses.append(lv.detach())
        return torch.stack(losses).mean()

    return steps


def make_ema_scan_step(model: DACModel, opt: AdamChain, batch: int, length: int, sr: int,
                       scan_size: int, loss=ema_loss_fn, rvq_only: bool = False):
    """``steps(ema, key, stft_w) -> (ema, mean loss)``: ``scan_size``
    gradient steps, each followed by an EMA codebook step; a step's key
    splits into the data's and the EMA restarts'.  ``rvq_only`` zeroes the
    encoder's and decoder's gradients (the projection warm-up)."""
    from ..flashsr.distill import synth_pair_batch
    cfg, dev = model.cfg, model.device

    def steps(ema, key: np.ndarray, stft_w: float):
        losses = []
        for k in prng.split(np.asarray(key, np.uint32), scan_size):
            kd, kr = prng.split(k)
            _, hr = synth_pair_batch(kd, batch, length, sr=sr, device=dev)
            with exact_f32():
                lv, (codes, r_stack) = loss(model, hr, stft_w=stft_w)
                _grad_step(model, opt, lv, rvq_only)
            ema = ema_codebook_update(cfg, model, ema, codes, r_stack, kr)
            losses.append(lv.detach())
        return ema, torch.stack(losses).mean()

    return steps


def _roundtrip_snr(model: DACModel, hr: torch.Tensor, quantize: bool = True) -> torch.Tensor:
    """Roundtrip SNR (dB) of a batch ``[B, T]`` (padded to a hop multiple)."""
    n = hr.shape[-1]
    x = F.pad(hr, (0, (-n) % model.cfg.hop))
    z = _encode(model, x)
    if quantize:
        z, _ = model.rvq(z)
    rec = _decode(model, z, n)
    err = torch.mean(torch.square(rec - hr))
    sig = torch.mean(torch.square(hr)) + 1e-12
    return 10.0 * torch.log10(sig / (err + 1e-12))


def make_eval_snr(model: DACModel, n: int = 4, length: int = None, seed: int = 555,
                  quantize: bool = True):
    """``ev() -> float``: the held-out batch (``synth_pair_batch`` of
    ``PRNGKey(seed)``, drawn once) through the codec -> roundtrip SNR (dB);
    ``quantize=False`` skips the RVQ (the plain autoencoder's ceiling)."""
    from ..flashsr.distill import synth_pair_batch
    cfg = model.cfg
    length = length or cfg.sample_rate
    _, hr = synth_pair_batch(prng.prng_key(seed), n, length, sr=cfg.sample_rate,
                             device=model.device)

    @torch.no_grad()
    def ev() -> float:
        with exact_f32():
            return float(_roundtrip_snr(model, hr, quantize))

    return ev


def _stft_w_schedule(steps: int, stft_w: float, stft_w_end: float, ramp_frac: float = 0.2):
    """A step's STFT-loss weight: ``stft_w``, then a linear ramp to
    ``stft_w_end`` over the last ``ramp_frac`` of the phase."""
    if not stft_w_end or stft_w_end == stft_w or steps <= 0:
        return lambda i: stft_w
    s0 = int(round(steps * (1.0 - ramp_frac)))
    span = max(1, steps - s0)

    def at(i: int) -> float:
        if i <= s0:
            return stft_w
        return stft_w + (stft_w_end - stft_w) * min(1.0, (i - s0) / span)

    return at


def _run_phase(model: DACModel, tag: str, loss, steps: int, batch: int, length: int,
               lr: float, key: np.ndarray, scan_size: int, log_every: int,
               use_ema: bool = False, eval_fn=None, ckpt_path=None, ckpt_every: int = 0,
               rvq_only: bool = False, stft_w: float = 0.25, stft_w_end: float = 0.0
               ) -> DACModel:
    """One optimization phase of ``steps`` steps, ``scan_size`` a dispatch
    (a fresh optimizer, its schedule over the phase): the EMA step where
    ``use_ema``; ``eval_fn`` logs the held-out SNR beside the loss;
    ``ckpt_path`` / ``ckpt_every`` save mid-run.  ``loss`` takes ``(model,
    wav, stft_w=...)``; the weight comes from ``_stft_w_schedule`` a
    dispatch."""
    if steps <= 0:
        return model
    opt = make_optimizer(model, lr, steps)
    sr = model.cfg.sample_rate
    sz = max(1, scan_size)
    if use_ema:
        step = make_ema_scan_step(model, opt, batch, length, sr, sz, loss=(loss or ema_loss_fn),
                                  rvq_only=rvq_only)
        ema = init_ema_state(model.cfg, model)
    else:
        step = make_scan_step(model, opt, batch, length, sr, sz, loss=loss)
    w_at = _stft_w_schedule(steps, stft_w, stft_w_end)
    next_log = 0
    since_ckpt = 0
    for i in range(0, steps, sz):
        key, k = prng.split(key)
        sw = float(np.float32(w_at(i)))
        if use_ema:
            ema, lv = step(ema, k, sw)
        else:
            lv = step(k, sw)
        if log_every and i + sz > next_log:
            next_log += max(log_every, sz)
            extra = f"  held-out SNR {eval_fn():+.2f} dB" if eval_fn is not None else ""
            print(f"[dac-distill:{tag}] step {i}..{i + sz - 1} "
                  f"mean loss {float(lv):.4f}{extra}", flush=True)
        since_ckpt += sz
        if ckpt_path is not None and ckpt_every and since_ckpt >= ckpt_every:
            since_ckpt = 0
            save_pretrained(model, Path(ckpt_path), cfg=model.cfg)
            print(f"[dac-distill:{tag}] ckpt @ step {i} -> {ckpt_path}", flush=True)
    return model


def output_path(model_type: str, out: Optional[Path] = None) -> Path:
    """Where a run writes its candidate: ``out``, else ``weights_dir() /
    "dac" / f"pretrained_{model_type}.npz"``; mid-run checkpoints go to its
    ``.ckpt.npz`` sibling."""
    if out is not None:
        return Path(out)
    from ...utils.weights import weights_dir
    return weights_dir() / "dac" / f"pretrained_{model_type}.npz"


def served_path(model_type: str, out: Optional[Path] = None) -> Path:
    """The codec served for ``model_type``: ``output_path(model_type, out)``
    where a guarded run shipped one, else the shipped file."""
    from ...utils.weights import served_file
    return served_file(output_path(model_type, out), PRETRAINED[model_type])


def params_tree(model: DACModel) -> Dict:
    """The codec's parameters as the JAX package's tree (numpy)."""
    from ...utils.weights import flax_tree
    return {name: flax_tree(getattr(model, name), values=True)
            for name in ("encoder", "decoder", "rvq")}


def train(cfg: DACConfig = None, steps: int = 2000, batch: int = 8, length: int = 16384,
          lr: float = 3e-4, seed: int = 0, log_every: int = 100, scan_size: int = 1,
          ae_frac: float = 0.5, model_type: str = "44khz", eval_every: bool = True,
          stft_w: float = 0.25, lsd_w: float = 0.0, stft_w_end: float = 0.0,
          device="cuda", out: Optional[Path] = None):
    """The three-phase distillation from ``init_params(seed)``: ``ae``
    (``ae_frac`` of the steps), data-dependent codebooks, ``proj`` (a tenth,
    at least one dispatch, rvq only, half the lr), ``vq`` (the rest, half
    the lr, checkpoints every 3000 steps to ``output_path(model_type,
    out)``'s ``.ckpt.npz`` sibling).  Returns ``(model, params)``."""
    from ..flashsr.distill import synth_pair_batch

    dev = _device(device)
    cfg = cfg or distilled_config(model_type)
    model = DACModel(cfg).init_params(seed).to(dev)
    key = prng.prng_key(seed + 1)
    ae_steps = int(round(steps * ae_frac))
    ev_len = min(length, cfg.sample_rate)
    ev = make_eval_snr(model, length=ev_len) if eval_every else None
    ev_ae = make_eval_snr(model, length=ev_len, quantize=False) if eval_every else None
    ckpt = output_path(model_type, out).with_suffix(".ckpt.npz")

    proj_steps = max(scan_size, int(round(steps * 0.1)))
    key, ka, kc, kp, kb = prng.split(key, 5)
    _run_phase(model, "ae", functools.partial(ae_loss_fn, lsd_w=lsd_w), ae_steps, batch,
               length, lr, ka, scan_size, log_every, eval_fn=ev_ae, stft_w=stft_w)
    _, warm = synth_pair_batch(kc, batch, length, sr=cfg.sample_rate, device=dev)
    init_codebooks_from_data(model, warm, seed=seed)
    _run_phase(model, "proj", proj_loss_fn, proj_steps, batch, length, lr * 0.5, kp,
               scan_size, log_every, use_ema=True, eval_fn=ev, rvq_only=True)
    _run_phase(model, "vq", functools.partial(ema_loss_fn, lsd_w=lsd_w),
               steps - ae_steps - proj_steps, batch, length, lr * 0.5, kb, scan_size,
               log_every, use_ema=True, eval_fn=ev, ckpt_path=ckpt, ckpt_every=3000,
               stft_w=stft_w, stft_w_end=stft_w_end)
    return model, params_tree(model)


def shipped_model(model_type: str, device="cuda", out: Optional[Path] = None) -> DACModel:
    """The served codec of ``model_type`` (``served_path(model_type,
    out)``) as a float32-parameter ``DACModel`` on ``device`` (its geometry
    from the file)."""
    shipped = load_pretrained(model_type, served_path(model_type, out))
    if shipped is None:
        raise FileNotFoundError(f"no shipped weights for {model_type}")
    cfg, tree = shipped
    return DACModel(cfg).load_jax(tree).to(_device(device))


def finetune(model_type: str = "44khz", steps: int = 6000, batch: int = 8,
             length: int = 16384, lr: float = 5e-5, seed: int = 10, scan_size: int = 1,
             log_every: int = 100, stft_w: float = 0.25, lsd_w: float = 0.0,
             stft_w_end: float = 0.0, device="cuda", out: Optional[Path] = None):
    """The VQ phase continued from the served codec (``served_path(
    model_type, out)``) with a fresh low-lr optimizer and EMA state from the
    loaded codebooks; checkpoints to ``output_path(model_type, out)``'s
    ``.ckpt.npz`` sibling.  Returns ``(model, params)``."""
    model = shipped_model(model_type, device, out)
    print(f"[dac-finetune:{model_type}] resuming from {served_path(model_type, out)}",
          flush=True)
    ev = make_eval_snr(model, length=min(length, model.cfg.sample_rate))
    ckpt = output_path(model_type, out).with_suffix(".ckpt.npz")
    _run_phase(model, "ft", functools.partial(ema_loss_fn, lsd_w=lsd_w), steps, batch, length,
               lr, prng.prng_key(seed), scan_size, log_every, use_ema=True, eval_fn=ev,
               ckpt_path=ckpt, ckpt_every=3000, stft_w=stft_w, stft_w_end=stft_w_end)
    return model, params_tree(model)


# ---- the quality gate and shipping ------------------------------------------------

GATE_KEYS = (1234, 99, 7, 42)


def make_gate_eval(model: DACModel):
    """``ev() -> (snrs [4], lsds [4])``: per content key of ``GATE_KEYS``
    the roundtrip SNR over the whole ``[3, sr]`` draw and the mean over its
    items of ``eval.metrics.lsd_sisdr_report``'s LSD (the gate of
    ``tests/test_dac_distilled.py``); the draws are made once."""
    from ...eval.metrics import lsd_sisdr_report
    from ..flashsr.distill import synth_pair_batch

    sr = model.cfg.sample_rate
    draws = [synth_pair_batch(prng.prng_key(k), 3, sr, sr=sr, device=model.device)[1]
             for k in GATE_KEYS]

    @torch.no_grad()
    def ev():
        snrs, lsds = [], []
        with exact_f32():
            for hr in draws:
                x = F.pad(hr, (0, (-sr) % model.cfg.hop))
                z_q, _ = model.rvq(_encode(model, x))
                rec = _decode(model, z_q, sr)
                err = torch.mean(torch.square(rec - hr))
                sig = torch.mean(torch.square(hr)) + 1e-12
                snrs.append(10.0 * torch.log10(sig / (err + 1e-12)))
                lsds.append(torch.stack([lsd_sisdr_report(hr[i], rec[i], compute_si_sdr=False)
                                         ["lsd_mean_db"] for i in range(hr.shape[0])]).mean())
        return torch.stack(snrs), torch.stack(lsds)

    return ev


def gate_metrics(model: DACModel) -> dict:
    snrs, lsds = (a.cpu().numpy() for a in make_gate_eval(model)())
    return {"mean_snr": float(snrs.mean()), "worst_snr": float(snrs.min()),
            "mean_lsd": float(lsds.mean()),
            "snrs": [round(float(s), 2) for s in snrs]}


TARGETS = {"mean_snr": 8.0, "worst_snr": 4.0, "mean_lsd": 7.5}


def _target_deficit(m: dict) -> float:
    """Distance (dB, summed) from the codec targets: mean SNR >= +8, worst
    draw >= +4, mean LSD <= 7.5; 0 where every target is met."""
    return (max(0.0, TARGETS["mean_snr"] - m["mean_snr"])
            + max(0.0, TARGETS["worst_snr"] - m["worst_snr"])
            + max(0.0, m["mean_lsd"] - TARGETS["mean_lsd"]))


def should_ship(before: dict, after: dict) -> bool:
    """Ship where the distance to the targets strictly shrinks (ties: the
    combined SNR rises), and neither SNR falls near its test gate or by
    more than 0.3 dB, and LSD stays clear of its 9.5 dB bar."""
    d_before, d_after = _target_deficit(before), _target_deficit(after)
    better = (d_after < d_before
              or (d_after == d_before
                  and after["mean_snr"] + after["worst_snr"]
                  > before["mean_snr"] + before["worst_snr"]))
    safe = (after["worst_snr"] > max(1.8, before["worst_snr"] - 0.3)
            and after["mean_snr"] > max(4.8, before["mean_snr"] - 0.3)
            and after["mean_lsd"] < min(9.0, before["mean_lsd"] + 0.3))
    return better and safe


def _guarded_ship(model_type: str, before: dict, model: DACModel,
                  out: Optional[Path] = None) -> bool:
    after = gate_metrics(model)
    print(f"[dac-guarded:{model_type}] AFTER  gate: {after}", flush=True)
    path = output_path(model_type, out)
    if should_ship(before, after):
        save_pretrained(model, path, cfg=model.cfg)
        print(f"[dac-guarded:{model_type}] SHIPPED -> {path}", flush=True)
        return True
    print(f"[dac-guarded:{model_type}] NOT shipped; candidate stays in the .ckpt.npz "
          "sibling", flush=True)
    return False


def guarded_finetune(model_type: str, steps: int, batch: int, length: int, lr: float,
                     seed: int, scan_size: int, stft_w: float = 0.25, lsd_w: float = 0.0,
                     stft_w_end: float = 0.0, device="cuda", out: Optional[Path] = None
                     ) -> bool:
    """Fine-tune the served codec; write the candidate to ``output_path``
    only where the four-draw gate improves on it (``should_ship``).  True
    where it was written."""
    before = gate_metrics(shipped_model(model_type, device, out))
    print(f"[dac-guarded:{model_type}] BEFORE gate: {before}", flush=True)
    model, _ = finetune(model_type=model_type, steps=steps, batch=batch, length=length, lr=lr,
                        seed=seed, scan_size=scan_size, stft_w=stft_w, lsd_w=lsd_w,
                        stft_w_end=stft_w_end, device=device, out=out)
    return _guarded_ship(model_type, before, model, out)


def guarded_retrain(model_type: str, steps: int, batch: int, length: int, lr: float,
                    seed: int, scan_size: int, ae_frac: float, encoder_dim: int = 0,
                    hop: int = 0, codebook_dim: int = 0, decoder_dim: int = 0,
                    stft_w: float = 0.25, lsd_w: float = 0.0, stft_w_end: float = 0.0,
                    device="cuda", out: Optional[Path] = None) -> bool:
    """A from-scratch retrain at an (optionally) widened geometry, written
    only where the gate improves on the served codec (always where there
    is none).  True where it was written."""
    before = None
    if load_pretrained(model_type, served_path(model_type, out)) is not None:
        before = gate_metrics(shipped_model(model_type, device, out))
        print(f"[dac-guarded:{model_type}] BEFORE gate: {before}", flush=True)
    cfg = distilled_config(model_type)
    if encoder_dim:
        cfg = dataclasses.replace(cfg, encoder_dim=encoder_dim)
    if codebook_dim:
        cfg = dataclasses.replace(cfg, codebook_dim=codebook_dim)
    if decoder_dim:
        cfg = dataclasses.replace(cfg, decoder_dim=decoder_dim)
    if hop:
        strides = {32: (2, 4, 2, 2), 64: (2, 4, 4, 2), 128: (2, 4, 4, 4)}[hop]
        cfg = dataclasses.replace(cfg, strides=strides)
    print(f"[dac-guarded:{model_type}] retrain geometry: "
          f"encoder_dim={cfg.encoder_dim} strides={cfg.strides}", flush=True)
    model, _ = train(cfg=cfg, steps=steps, batch=batch, length=length, lr=lr, seed=seed,
                     scan_size=scan_size, ae_frac=ae_frac, model_type=model_type,
                     stft_w=stft_w, lsd_w=lsd_w, stft_w_end=stft_w_end, device=device, out=out)
    if before is None:
        path = output_path(model_type, out)
        save_pretrained(model, path, cfg=model.cfg)
        print(f"[dac-guarded:{model_type}] SHIPPED (no incumbent) -> {path}", flush=True)
        return True
    return _guarded_ship(model_type, before, model, out)


# ---- files ---------------------------------------------------------------------------

def save_pretrained(params, path: Path, cfg: DACConfig = None) -> None:
    """The weights (a ``DACModel`` or the JAX package's tree) as float16
    with the geometry that trained them (``__config__``, JSON bytes): the
    JAX package's shipped-codec format, which both packages'
    ``load_pretrained`` read."""
    from ...utils.weights import _flatten
    if isinstance(params, DACModel):
        params = params_tree(params)
    flat = {k: np.asarray(v, np.float16) for k, v in _flatten(params).items()}
    if cfg is not None:
        d = dataclasses.asdict(cfg)
        d["strides"] = list(d["strides"])
        d.pop("dtype", None)
        flat["__config__"] = np.frombuffer(json.dumps(d).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def load_pretrained(model_type: str = "44khz", path: Optional[Path] = None):
    """(config, parameter tree of float32 numpy arrays) of the served
    compact codec (``served_path``; or of the file at ``path``), or None
    where it is missing."""
    from ...utils.weights import unflatten

    if path is None and model_type in PRETRAINED:
        path = served_path(model_type)
    if path is None or not Path(path).exists():
        return None
    with np.load(path) as z:
        files = list(z.files)
        if "__config__" in files:
            d = json.loads(bytes(z["__config__"].tobytes()).decode())
            d["strides"] = tuple(d["strides"])
            cfg = DACConfig(**d)
            files.remove("__config__")
        else:
            # the round-2 weight sets predate the embedded config
            cfg = DACConfig(sample_rate=_RATES[model_type], encoder_dim=16,
                            strides=(2, 4, 4, 4), decoder_dim=256,
                            n_codebooks=6, codebook_size=1024, codebook_dim=8,
                            res_scale=0.5, output_tanh=False, alpha_floor=0.05)
        params = unflatten({k: z[k].astype(np.float32) for k in files})
    return cfg, params


def roundtrip_snr_db(model: DACModel, wav: np.ndarray) -> float:
    """Codec roundtrip SNR on ``[C, T]`` (the quality-gate metric), on the
    model's device."""
    z_q, _ = model.encode(torch.from_numpy(np.ascontiguousarray(wav, np.float32)))
    rec = model.decode(z_q).cpu().numpy()[:, : wav.shape[-1]]
    err = np.mean(np.square(rec - np.asarray(wav)))
    sig = np.mean(np.square(np.asarray(wav))) + 1e-12
    return float(10.0 * np.log10(sig / (err + 1e-12)))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Distill compact DAC weights")
    ap.add_argument("--model-type", default="44khz", choices=sorted(_RATES))
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--length", type=int, default=16384)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ae-frac", type=float, default=0.5)
    ap.add_argument("--scan", type=int, default=1, help="optimizer steps per dispatch")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU, not the card")
    ap.add_argument("--out", type=Path, default=None,
                    help="output npz (default: $EGREGORA_TPU_WEIGHTS/dac/pretrained_<type>.npz; "
                         "checkpoints beside it as .ckpt.npz)")
    ap.add_argument("--finetune", action="store_true",
                    help="continue the VQ phase from the shipped codec (pair with a lower --lr)")
    ap.add_argument("--guarded", action="store_true",
                    help="fine-tune and write the candidate ONLY if the four-draw gate "
                         "(mean+worst SNR, LSD) improves")
    ap.add_argument("--retrain", action="store_true",
                    help="with --guarded: full from-scratch retrain at the (optionally "
                         "widened) geometry instead of fine-tune")
    ap.add_argument("--encoder-dim", type=int, default=0,
                    help="retrain geometry override (0 = keep default)")
    ap.add_argument("--hop", type=int, default=0, choices=(0, 32, 64, 128),
                    help="retrain hop override via strides (0 = keep default)")
    ap.add_argument("--codebook-dim", type=int, default=0,
                    help="retrain RVQ stage rank override (0 = keep default)")
    ap.add_argument("--decoder-dim", type=int, default=0,
                    help="retrain decoder width override (0 = keep default)")
    ap.add_argument("--stft-w", type=float, default=0.25,
                    help="weight of the multi-resolution STFT loss term")
    ap.add_argument("--lsd-w", type=float, default=0.0,
                    help="weight of the gate-matched LSD surrogate (2048/512)")
    ap.add_argument("--stft-w-end", type=float, default=0.0,
                    help="ramp the STFT weight linearly to this value over the final 20%% of "
                         "the VQ / finetune phase")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    print("device:", _device(device), flush=True)
    w = dict(stft_w=a.stft_w, lsd_w=a.lsd_w, stft_w_end=a.stft_w_end, device=device, out=a.out)
    if a.guarded:
        if a.retrain:
            shipped = guarded_retrain(a.model_type, a.steps, a.batch, a.length, a.lr, a.seed,
                                      a.scan, a.ae_frac, a.encoder_dim, a.hop, a.codebook_dim,
                                      a.decoder_dim, **w)
        else:
            shipped = guarded_finetune(a.model_type, a.steps, a.batch, a.length, a.lr, a.seed,
                                       a.scan, **w)
        return 0 if shipped else 3
    if a.finetune:
        model, _ = finetune(model_type=a.model_type, steps=a.steps, batch=a.batch,
                            length=a.length, lr=a.lr, seed=a.seed, scan_size=a.scan, **w)
    else:
        model, _ = train(steps=a.steps, batch=a.batch, length=a.length, lr=a.lr, seed=a.seed,
                         scan_size=a.scan, ae_frac=a.ae_frac, model_type=a.model_type, **w)
    from ..flashsr.distill import synth_pair_batch
    sr = model.cfg.sample_rate
    _, hr = synth_pair_batch(prng.prng_key(99), 4, sr, sr=sr, device="cpu")
    snr = roundtrip_snr_db(model, hr.numpy())
    print(f"[dac-distill:{a.model_type}] held-out roundtrip SNR {snr:.2f} dB", flush=True)
    path = output_path(a.model_type, a.out)
    save_pretrained(model, path, cfg=model.cfg)
    print(f"[dac-distill] wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
