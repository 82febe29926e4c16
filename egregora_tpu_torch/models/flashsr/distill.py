"""FlashSR weights: converted reference checkpoints, the shipped compact
trios, the resolver that picks one, and the trainers that distill them.

Counterpart of ``egregora_tpu/models/flashsr/distill.py`` and of the JAX
package's ``utils/weights.load_converted_flashsr``.

Training (``distill``, ``distill_vocoder``; ``python -m
egregora_tpu_torch.models.flashsr.distill``, on the card unless
``--cpu``): synthetic LR/HR pairs from ``synth_pair_batch``, whose random
numbers are the JAX generator's (``prng``, on the host) and whose
waveforms are synthesised on the card, and the JAX key schedule
(``fold_in`` a step, then ``split``), so the same flags draw the same
data.  Output goes to ``weights_dir()`` unless ``out_path`` says
otherwise; nothing is ever written into the JAX package's shipped files.
What a trainer writes there is what the resolver serves next
(``served_trio``), so that training and serving form one loop as in the
JAX package, whose trainers overwrite the shipped files themselves.

Reference checkpoints: the three ``.pth`` files of upstream FlashSR
(``vae.pth``, ``student_ldm.pth``, ``sr_vocoder.pth``) in
``weights_dir()``.  Their geometry is inferred from the tensor shapes
(``geometry.infer_flashsr_config``), each file is mapped by its upstream
name map onto the JAX package's flax tree and then onto the port, and
the converted arrays are cached beside them as ``flashsr_params.npz``
with a ``flashsr_params.cfg.json`` sidecar, in the JAX package's format:
a cache either package wrote loads in the other.  With files missing the
resolver makes one first-use download attempt (``utils.fetch``; off under
``EGREGORA_TPU_OFFLINE``), then falls through to the shipped trios.

Shipped trios: the JAX package ships two distilled trios as data files, ``pretrained_istft.npz`` (the
served default: phase-conditioned exciter ``SpectralVocoder``) and
``pretrained.npz`` (the HiFi-GAN ``SRVocoder``).  The port reads them in
place, by path, from the checkout, unless a trainer of the port wrote
a trio of the same name under ``weights_dir()``: flat ``/``-joined flax
keys, float16 values cast to float32, and a ``__config__`` JSON entry with
the geometry.  ``utils.weights.params_from_jax`` maps them onto the port's
modules, key for key.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...utils.fetch import (FLASHSR_FILES as CONVERTED_FILES, FETCHED, auto_fetch_flashsr,
                            fetched_files, missing_flashsr_files)
from ...utils.weights import (convert_state_dict, flax_tree, load_params,
                              load_torch_state_dict, params_from_jax, save_params,
                              served_file, unflatten)
from . import prng
from .geometry import infer_flashsr_config
from .mel import log_mel
from .ldm_unet import LDMUNetConfig, ldm_unet_name_map
from .pipeline import FlashSRConfig, FlashSRModules
from .unet import UNetConfig
from .vae import VAEConfig, audioldm_vae_name_map
from .vocoder import VocoderConfig, hifigan_name_map

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "flashsr"
PRETRAINED = SHIPPED_DIR / "pretrained.npz"
PRETRAINED_ISTFT = SHIPPED_DIR / "pretrained_istft.npz"
CACHE = "flashsr_params.npz"
SIDECAR = "flashsr_params.cfg.json"

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def _cfg_to_json(cfg: FlashSRConfig) -> str:
    """The geometry of a trio as the JAX package writes it: each
    sub-config's fields but ``dtype`` (code policy, not checkpoint state),
    the UNet tagged by kind."""
    def enc(o):
        return {f.name: getattr(o, f.name) for f in dataclasses.fields(o) if f.name != "dtype"}

    return json.dumps({"vae": enc(cfg.vae), "unet": enc(cfg.unet),
                       "unet_kind": ("ldm" if isinstance(cfg.unet, LDMUNetConfig)
                                     else "student"),
                       "vocoder": enc(cfg.vocoder),
                       "crossover_hz": cfg.crossover_hz,
                       "noise_seed": cfg.noise_seed,
                       "envelope_match": cfg.envelope_match,
                       "adaptive_crossover": cfg.adaptive_crossover})


def _cfg_from_json(s: str) -> FlashSRConfig:
    """The ``__config__`` entry of a shipped npz -> the port's config."""
    d = json.loads(s)

    def dec(cls, dd):
        return cls(**{k: _deep_tuple(v) for k, v in dd.items()})

    unet_cls = LDMUNetConfig if d.get("unet_kind") == "ldm" else UNetConfig
    return FlashSRConfig(vae=dec(VAEConfig, d["vae"]),
                         unet=dec(unet_cls, d["unet"]),
                         vocoder=dec(VocoderConfig, d["vocoder"]),
                         crossover_hz=d["crossover_hz"],
                         noise_seed=d["noise_seed"],
                         envelope_match=d.get("envelope_match", False),
                         adaptive_crossover=d.get("adaptive_crossover", True))


# geometry of shipped npz files that predate the embedded config
_LEGACY_DISTILLED = FlashSRConfig(
    vae=VAEConfig(base_channels=24, channel_mults=(1, 2, 4), latent_channels=16,
                  num_res_blocks=1, groups=8, mid_attn=False, use_quant_conv=False),
    unet=UNetConfig(in_channels=32, out_channels=16, base_channels=48,
                    channel_mults=(1, 2), num_res_blocks=1, attn_levels=(),
                    num_heads=4, time_dim=128, groups=8),
    vocoder=VocoderConfig(upsample_initial=128, channel_floor=16),
)


def load_pretrained_with_cfg(path: Path = PRETRAINED
                             ) -> Optional[Tuple[FlashSRConfig, StateDicts]]:
    """``(config, state dicts)`` of a shipped trio, or None if the file is
    absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        files = list(z.files)
        if "__config__" in files:
            cfg = _cfg_from_json(bytes(z["__config__"].tobytes()).decode())
            files.remove("__config__")
        else:
            cfg = _LEGACY_DISTILLED
        tree = unflatten({k: z[k].astype(np.float32) for k in files})
    return cfg, params_from_jax(cfg, tree)


def load_pretrained(path: Optional[Path] = None) -> Optional[StateDicts]:
    """The state dicts of the trio at ``path`` (default: the served
    HiFi-GAN trio, ``served_trio(PRETRAINED)``), or None if it is absent."""
    out = load_pretrained_with_cfg(served_trio(PRETRAINED) if path is None else path)
    return None if out is None else out[1]


def weights_dir() -> Path:
    """The converted-checkpoint root the JAX package reads:
    ``EGREGORA_TPU_WEIGHTS``, else ``~/.cache/egregora_tpu/weights``;
    FlashSR's files sit in its ``flashsr`` folder."""
    env = os.environ.get("EGREGORA_TPU_WEIGHTS")
    root = Path(env) if env else Path.home() / ".cache" / "egregora_tpu" / "weights"
    return root / "flashsr"


def served_trio(shipped: Path) -> Path:
    """The trio file the resolver serves for a shipped trio: the copy the
    port's trainer wrote under ``weights_dir()`` (same name) where it
    exists, else the shipped file."""
    return served_file(weights_dir() / Path(shipped).name, shipped)


def convert_flashsr_trio(cfg: FlashSRConfig, sds: Dict[str, Dict[str, np.ndarray]],
                         d: Path) -> Dict[str, dict]:
    """The three checkpoints' state dicts (keyed like the trio) mapped by
    their upstream name maps onto the JAX package's flax trees for
    ``cfg`` (numpy leaves), cached in ``d`` as ``CACHE`` with the
    ``SIDECAR`` geometry."""
    with torch.device("meta"):
        mods = FlashSRModules(cfg)
    # a StudentUNet config (no upstream layout) matches by suffix and shape
    maps = {"vae": audioldm_vae_name_map(cfg.vae),
            "sr_vocoder": hifigan_name_map(cfg.vocoder),
            "student_ldm": (ldm_unet_name_map(cfg.unet) if isinstance(cfg.unet, LDMUNetConfig)
                            else None)}
    converted = {name: convert_state_dict(sds[name], flax_tree(m), name_map=maps[name])
                 for name, m in mods.by_name().items()}
    save_params(converted, d / CACHE)
    (d / SIDECAR).write_text(_cfg_to_json(cfg))
    return converted


def load_converted_flashsr(ckpt_dir: Optional[Path] = None
                           ) -> Optional[Tuple[FlashSRConfig, StateDicts]]:
    """``(config, state dicts)`` of the reference checkpoints in
    ``ckpt_dir`` (default ``weights_dir()``), or None when they are not
    all there.  The cache comes first (its sidecar's geometry, or the full
    config for a cache without one); else the three ``.pth`` files, with
    the geometry inferred from their shapes, converted and cached.  With
    files missing it makes the JAX resolver's first-use download attempt
    (``utils.fetch.auto_fetch_flashsr``: once per directory per process,
    none under ``EGREGORA_TPU_OFFLINE``) before giving up.  A file that
    fetch downloaded is read as tensors only (``weights_only``), and one
    that holds anything else raises; files put in place by hand are
    unpickled whole, as the JAX package does."""
    d = Path(ckpt_dir) if ckpt_dir is not None else weights_dir()
    cache, sidecar = d / CACHE, d / SIDECAR
    if cache.exists():
        cfg = _cfg_from_json(sidecar.read_text()) if sidecar.exists() else FlashSRConfig()
        return cfg, params_from_jax(cfg, load_params(cache))
    missing = missing_flashsr_files(d)
    if missing and not auto_fetch_flashsr(d):
        if len(missing) < len(CONVERTED_FILES):
            print(f"[egregora_tpu_torch] FlashSR: {d} lacks {', '.join(missing)}; "
                  "the reference checkpoints are skipped")
        return None
    fetched = fetched_files(d)
    sds = {}
    for name in ("vae", "student_ldm", "sr_vocoder"):
        f = f"{name}.pth"
        try:
            sds[name] = load_torch_state_dict(d / f, weights_only=f in fetched)
        except Exception as e:
            if f not in fetched:
                raise
            raise RuntimeError(
                f"{d / f} was downloaded and holds more than tensors, so it is not "
                f"loaded; delete it, or put a trusted copy there by hand and take its "
                f"name out of {d / FETCHED}") from e
    cfg = infer_flashsr_config(sds["vae"], sds["student_ldm"], sds["sr_vocoder"])
    print(f"[egregora_tpu_torch] FlashSR geometry inferred from checkpoints: "
          f"vae base={cfg.vae.base_channels} mults={cfg.vae.channel_mults}; "
          f"unet mc={cfg.unet.model_channels} mult={cfg.unet.channel_mult} "
          f"heads={cfg.unet.num_heads} (not shape-recoverable; "
          f"EGREGORA_FLASHSR_NUM_HEADS overrides); vocoder "
          f"init={cfg.vocoder.upsample_initial} factors={cfg.vocoder.upsample_factors}")
    return cfg, params_from_jax(cfg, convert_flashsr_trio(cfg, sds, d))


def resolve_flashsr(seed: int = 0) -> Tuple[FlashSRConfig, Optional[StateDicts], str]:
    """``(config, state dicts, source)`` for the node and the CLI, in the
    JAX resolver's order:

    1. converted reference checkpoints (the cache ``flashsr_params.npz``
       or all three ``.pth`` files in ``weights_dir()``, after one
       first-use download attempt; "converted");
    2. the istft trio ``pretrained_istft.npz`` ("distilled-istft"),
       unless ``EGREGORA_FLASHSR_VARIANT=hifigan``;
    3. the HiFi-GAN trio ``pretrained.npz`` ("distilled");
    4. the full config with no weights ("random": the pipeline draws
       them from ``seed``).

    Each trio is ``served_trio``'s: the one the port's trainers wrote under
    ``weights_dir()``, else the shipped one."""
    converted = load_converted_flashsr()
    if converted is not None:
        return converted[0], converted[1], "converted"
    variant = os.environ.get("EGREGORA_FLASHSR_VARIANT", "").strip().lower()
    if variant != "hifigan":
        shipped = load_pretrained_with_cfg(served_trio(PRETRAINED_ISTFT))
        if shipped is not None:
            return shipped[0], shipped[1], "distilled-istft"
        if variant in ("istft", "vocos"):
            print(f"[egregora_tpu_torch] FlashSR: EGREGORA_FLASHSR_VARIANT={variant!r} "
                  f"but no {PRETRAINED_ISTFT.name} shipped; falling back to the "
                  "HiFi-GAN trio")
    shipped = load_pretrained_with_cfg(served_trio(PRETRAINED))
    if shipped is not None:
        return shipped[0], shipped[1], "distilled"
    print("[egregora_tpu_torch] FlashSR: no checkpoints and no shipped distilled "
          "weights; using seeded random init (output will not be enhanced)")
    return FlashSRConfig(), None, "random"


# ---------------------------------------------------------------------------
# training: the distilled trio's config, synthetic data, the trainers
# ---------------------------------------------------------------------------

SR = 48000
_N_HARMONICS = 96
_N_FULL = 352                # coherent draws: 352 * 150 Hz > Nyquist
# the quality monitor's 50/50 mix of phase-coherent and incoherent
# harmonic stacks (``_synth_draws``), as the JAX package's eval-v2
EVAL_COHERENT_P = 0.5
TWO_PI = 2 * np.pi


def distilled_config() -> FlashSRConfig:
    """The compact trio of the shipped ``pretrained.npz``: the attention-free
    compact VAE, a StudentUNet (one 4-head attention block, in the middle)
    and a narrow HiFi-GAN vocoder; trained at 128 mel frames."""
    return FlashSRConfig(
        vae=VAEConfig(base_channels=24, channel_mults=(1, 2, 4), latent_channels=16,
                      num_res_blocks=1, groups=8, mid_attn=False, use_quant_conv=False),
        unet=UNetConfig(in_channels=32, out_channels=16, base_channels=64,
                        channel_mults=(1, 2, 2), num_res_blocks=2, attn_levels=(),
                        num_heads=4, time_dim=128, groups=8),
        vocoder=VocoderConfig(upsample_initial=128, channel_floor=16),
    )


def _log32(x: float) -> np.float32:
    return np.log(np.float32(x))


def _draws_one(key: np.ndarray, length: int, coherent_p: float) -> Dict[str, np.ndarray]:
    """Every random number of the JAX ``_synth_one(key, length, sr,
    coherent_p)``, drawn by ``prng`` from the same keys (host numpy,
    bit for bit): 14 split keys, and ``fold_in(key, 98)`` / ``(key, 99)``
    for the coherent class and the lowpass cutoff."""
    ks = prng.split(key, 14)
    u = prng.uniform
    d = {"f0": u(ks[0], (), _log32(70.0), _log32(900.0)),
         "rolloff": u(ks[1], (), 0.5, 1.8),
         "cf": u(ks[2], (3,), _log32(200.0), _log32(14000.0)),
         "bw": u(ks[3], (3,), 0.3, 1.0),
         "gn": u(ks[4], (3,), 0.0, 2.0),
         "vr": u(ks[5], (), 3.0, 7.0),
         "vd": u(ks[6], (), 0.0, 0.008),
         "ph0": u(ks[7], (_N_HARMONICS,), 0.0, TWO_PI),
         "r": u(ks[8], (3,), 0.3, 3.0),
         "p": u(ks[9], (3,), 0.0, TWO_PI),
         "white": prng.normal_from_key(ks[10], (length,)),
         "tilt": u(ks[11], (), 0.0, 1.0),
         "nr": u(ks[12], (), 0.02, 0.30),
         "peak": u(ks[13], (), 0.25, 0.8),
         "cut": u(prng.fold_in(key, 99), (), 5000.0, 11500.0)}
    if coherent_p > 0.0:
        kc = prng.fold_in(key, 98)
        d["coh"] = prng.bernoulli(prng.fold_in(kc, 0), coherent_p)
        d["c"] = u(prng.fold_in(kc, 1), (), 0.0, TWO_PI)
        d["f0_c"] = u(prng.fold_in(kc, 4), (), _log32(150.0), _log32(900.0))
        d["roll_c"] = u(prng.fold_in(kc, 2), (), 0.4, 1.0)
        d["ph0_f"] = u(prng.fold_in(kc, 3), (_N_FULL,), 0.0, TWO_PI)
    return d


def synth_draws(key: np.ndarray, batch: int, length: int,
                coherent_p: float = 0.0) -> Dict[str, np.ndarray]:
    """The draws of ``synth_pair_batch``, stacked over the batch
    (``split(key, batch)``, one key an item), on the host."""
    items = [_draws_one(k, length, coherent_p) for k in prng.split(np.asarray(key, np.uint32),
                                                                   batch)]
    return {name: np.stack([d[name] for d in items]) for name in items[0]}


def _harmonics(amps: torch.Tensor, nf: torch.Tensor, base_phase: torch.Tensor,
               ph0: torch.Tensor, block: int = 32) -> torch.Tensor:
    """``sum_h amps[:, h] * sin(nf[h] * base_phase + ph0[:, h])`` ->
    ``[B, T]``, ``block`` harmonics at a time."""
    out = torch.zeros_like(base_phase)
    for i in range(0, nf.shape[0], block):
        h = slice(i, i + block)
        out += (amps[:, h, None] * torch.sin(nf[h, None] * base_phase[:, None, :]
                                             + ph0[:, h, None])).sum(1)
    return out


def synth_from_draws(d: Dict[str, np.ndarray], length: int, sr: int = SR,
                     coherent_p: float = 0.0, device="cuda"):
    """The JAX ``_synth_one`` over a batch of draws, in float32 torch on
    ``device``, op for op: an additive harmonic tone (random f0, power
    rolloff, three formant bumps, vibrato FM, AM and sigmoid note gating)
    plus white / first-difference noise, scaled to a random peak -> HR;
    HR through a sigmoid spectral lowpass at a random 5-11.5 kHz cutoff
    -> LR.  ``coherent_p > 0`` adds the phase-coherent class: 352
    harmonics aligned as ``n * c``, f0 from 150 Hz, a shallower rolloff,
    less noise.  ``sin`` at the harmonics' phases (up to ~2.5e6 rad in
    float32) follows each library's range reduction, so the waves agree
    with JAX's to a tolerance, not bit for bit."""
    T = lambda name: torch.as_tensor(d[name]).to(device)        # noqa: E731
    f32 = torch.float32
    t = torch.arange(length, dtype=f32, device=device) / sr
    f0 = torch.exp(T("f0"))[:, None]                              # [B, 1]
    n = torch.arange(1, _N_HARMONICS + 1, dtype=f32, device=device)
    rolloff = T("rolloff")[:, None]
    cf = torch.exp(T("cf"))[:, :, None]                           # [B, 3, 1]
    bw, gn = T("bw")[:, :, None], T("gn")[:, :, None]
    vr, vd = T("vr")[:, None], T("vd")[:, None]

    def formant(freqs):                                           # [B, H]
        return 1.0 + torch.sum(gn * torch.exp(-0.5 * (torch.log(freqs[:, None, :] / cf)
                                                      / bw) ** 2), dim=1)

    def phase(f0_):
        return 2 * np.pi * f0_ * (t - vd * torch.cos(2 * np.pi * vr * t) / (2 * np.pi * vr))

    ph0 = T("ph0")
    if coherent_p > 0.0:
        coh = T("coh")[:, None]
        f0 = torch.where(coh, torch.exp(T("f0_c"))[:, None], f0)
        nf = torch.arange(1, _N_FULL + 1, dtype=f32, device=device)
        amps = nf ** (-torch.where(coh, T("roll_c")[:, None], rolloff))
        amps = amps * formant(f0 * nf) * (f0 * nf < 0.98 * sr / 2)
        amps = amps * torch.where(coh, torch.ones_like(amps), (nf <= _N_HARMONICS).to(f32))
        ph0_f = torch.cat([ph0, T("ph0_f")[:, _N_HARMONICS:]], dim=1)
        ph0_f = torch.where(coh, nf * T("c")[:, None], ph0_f)
        harm = _harmonics(amps, nf, phase(f0), ph0_f)
    else:
        freq_n = f0 * n
        amps = n ** (-rolloff) * formant(freq_n) * (freq_n < 0.98 * sr / 2)
        harm = _harmonics(amps, n, phase(f0), ph0)
    harm = harm / (torch.sqrt(torch.mean(torch.square(harm), dim=-1, keepdim=True)) + 1e-6)

    r, p = T("r")[:, :, None], T("p")[:, :, None]
    am = 0.6 + 0.4 * torch.sin(2 * np.pi * r[:, 0] * t + p[:, 0]) * torch.sin(
        2 * np.pi * r[:, 1] * t + p[:, 1])
    gate = torch.sigmoid(6.0 * torch.sin(2 * np.pi * r[:, 2] * t + p[:, 2]) + 2.0)
    harm = harm * am * gate

    white = T("white")
    tilt = T("tilt")[:, None]
    noise = (1 - tilt) * white + tilt * torch.diff(white, dim=-1, prepend=torch.zeros_like(white[:, :1]))
    nr = T("nr")[:, None]
    if coherent_p > 0.0:
        nr = torch.where(coh, 0.3 * nr, nr)
    x = harm + nr * noise / (torch.sqrt(torch.mean(torch.square(noise), dim=-1, keepdim=True))
                             + 1e-6)
    hr = x * (T("peak")[:, None] / (torch.amax(torch.abs(x), dim=-1, keepdim=True) + 1e-6))

    f = torch.from_numpy(np.fft.rfftfreq(length, 1.0 / sr).astype(np.float32)).to(device)
    mask = torch.sigmoid((T("cut")[:, None] - f) / 200.0)
    lr = torch.fft.irfft(torch.fft.rfft(hr) * mask, n=length).to(f32)
    return lr, hr


def synth_pair_batch(key: np.ndarray, batch: int, length: int, sr: int = SR,
                     coherent_p: float = 0.0, device="cuda"):
    """``[B, length]`` (lr, hr) float32 pairs on ``device``: the JAX
    ``synth_pair_batch(key, ...)``'s draws (host, bit for bit) through
    ``synth_from_draws`` (the card)."""
    return synth_from_draws(synth_draws(key, batch, length, coherent_p), length, sr,
                            coherent_p, device)


# ---- vocoder-only training -------------------------------------------------

def _neg_sisdr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean negative SI-SDR (dB) over the batch."""
    est = est - torch.mean(est, dim=-1, keepdim=True)
    ref = ref - torch.mean(ref, dim=-1, keepdim=True)
    a = (torch.sum(est * ref, dim=-1, keepdim=True)
         / (torch.sum(ref * ref, dim=-1, keepdim=True) + 1e-9))
    proj = a * ref
    err = est - proj
    ratio = torch.sum(proj * proj, dim=-1) / (torch.sum(err * err, dim=-1) + 1e-9)
    return -torch.mean(10.0 * torch.log10(ratio + 1e-12))


def _vocoder_loss(modules, lr_wave: torch.Tensor, hr_wave: torch.Tensor, rng: np.ndarray,
                  sisdr_w: float = 0.0) -> torch.Tensor:
    """The JAX ``_vocoder_loss``: the vocoder (``modules.vocoder``, trained)
    on the clean HR mel and on the decoded prediction of the frozen
    VAE/UNet (run under ``no_grad``): MR-STFT of both, half their mel L2,
    20x the clean branch's waveform L2; with ``sisdr_w`` the negative
    SI-SDR of both branches and the decoded branch's waveform L2."""
    from .train import _mrstft
    hop, n_mels, n_fft = 480, 256, 2048
    frames = lr_wave.shape[-1] // hop
    mel_lr = log_mel(lr_wave, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]
    mel_hr = log_mel(hr_wave, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]
    with torch.no_grad():
        z_lr = modules.vae.encode(mel_lr[..., None])
        noise = torch.from_numpy(prng.normal_from_key(rng, tuple(z_lr.shape))).to(z_lr.device)
        z_in = torch.cat([noise, z_lr.float()], dim=-1)
        z = modules.unet(z_in, torch.ones(z_in.shape[0], device=z_in.device))
        mel_dec = modules.vae.decode(z)[..., 0].float()

    n = hr_wave.shape[-1]
    kw = {"ref": lr_wave} if getattr(modules.vocoder.cfg, "phase_cond", False) else {}
    wav1 = modules.vocoder(mel_hr, **kw)[:, :n].float()
    wav2 = modules.vocoder(mel_dec, **kw)[:, :n].float()
    mel1 = log_mel(wav1, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]
    mel2 = log_mel(wav2, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]
    loss = (_mrstft(wav1, hr_wave) + _mrstft(wav2, hr_wave)
            + 0.5 * (torch.mean(torch.square(mel1 - mel_hr))
                     + torch.mean(torch.square(mel2 - mel_hr)))
            + 20.0 * torch.mean(torch.square(wav1 - hr_wave)))
    if sisdr_w:
        loss = loss + (sisdr_w * (_neg_sisdr(wav1, hr_wave) + _neg_sisdr(wav2, hr_wave))
                       + 20.0 * torch.mean(torch.square(wav2 - hr_wave)))
    return loss


def init_vocoder_head(vocoder: torch.nn.Module, seed: int) -> None:
    """The JAX ``distill_vocoder``'s head init in place: ``fast_init_like``
    over the vocoder's flax tree, then, for a phase-conditioned head, the
    positive-copy start (``phase_gates`` and ``mag_gate`` kernels zero,
    only the input-copy gate group ``g1r`` biased to 1; the head emits 6
    gate groups, 10 with the exciter)."""
    from ...utils.weights import fast_init_like, module_from_jax
    tree = fast_init_like(flax_tree(vocoder), seed)
    if vocoder.cfg.phase_cond:
        p = tree["params"]
        for name in ("phase_gates", "mag_gate"):
            p[name]["kernel"] = np.zeros_like(p[name]["kernel"])
        b = np.zeros_like(p["phase_gates"]["bias"])
        b[: b.shape[0] // (10 if vocoder.cfg.exciter else 6)] = 1.0
        p["phase_gates"]["bias"] = b
    vocoder.load_state_dict(module_from_jax(vocoder, tree), strict=True)


# ---- the trainers ----------------------------------------------------------

def _device(device) -> torch.device:
    """The trainers' device: the card unless the caller names another;
    raises when the card is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("distill: no CUDA device; pass device='cpu' (--cpu) to train "
                           "on the CPU")
    return dev


def make_distill_step(modules, opt: torch.optim.Optimizer, batch: int, length: int,
                      sr: int = SR):
    """``step(key) -> loss``: one distillation step with fresh synthetic
    data, as the JAX ``make_distill_step``: ``kd, kn = split(key)``, the
    batch from ``kd``, the noise latent from ``kn``."""
    from .train import make_train_step
    train = make_train_step(modules, opt, None, hop=480, n_mels=256, n_fft=2048)
    device = next(modules.parameters()).device

    def step(key) -> torch.Tensor:
        kd, kn = prng.split(np.asarray(key, np.uint32))
        lr_w, hr_w = synth_pair_batch(kd, batch, length, sr, device=device)
        return train(lr_w, hr_w, kn)

    return step


def make_distill_scan(modules, opt: torch.optim.Optimizer, batch: int, length: int,
                      scan_size: int, sr: int = SR):
    """``steps(key) -> mean loss``: ``scan_size`` distillation steps on the
    keys ``split(key, scan_size)``, as the JAX ``make_distill_scan``."""
    step = make_distill_step(modules, opt, batch, length, sr)

    def steps(key) -> torch.Tensor:
        return torch.stack([step(k) for k in prng.split(np.asarray(key, np.uint32),
                                                        scan_size)]).mean()

    return steps


def _state_dicts(params) -> StateDicts:
    """State dicts of a trio: ``params`` itself, or a ``FlashSRModules``'s."""
    if hasattr(params, "by_name"):
        return {name: m.state_dict() for name, m in params.by_name().items()}
    return params


def save_pretrained(params, path: Path, cfg: Optional[FlashSRConfig] = None) -> None:
    """A trio (``FlashSRModules`` or its state dicts with ``cfg``) as the
    JAX ``save_pretrained`` writes it: flat ``/``-joined flax keys in
    float16 and the ``__config__`` geometry (``load_pretrained_with_cfg``
    of either package reads it)."""
    from ...utils.weights import _flatten
    if hasattr(params, "by_name"):
        cfg = cfg or params.cfg
        mods = params.by_name()
    else:
        with torch.device("meta"):
            mods = FlashSRModules(cfg).by_name()
        for name, m in mods.items():
            m.load_state_dict(params[name], assign=True)
    flat = {k: np.asarray(v, np.float16) for k, v in
            _flatten({name: flax_tree(m, values=True) for name, m in mods.items()}).items()}
    if cfg is not None:
        flat["__config__"] = np.frombuffer(_cfg_to_json(cfg).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def evaluate(params, cfg: FlashSRConfig, seed: int = 7, n: int = 4,
             coherent_p: float = EVAL_COHERENT_P, device="cuda") -> dict:
    """LSD / SI-SDR of the pipeline's output against the HR truth on ``n``
    fresh synthetic pairs at the full 5.12 s chunk (``synth_pair_batch(
    PRNGKey(seed), ...)``, the JAX ``evaluate``'s draws), beside the LR
    passthrough's."""
    from ...eval.metrics import lsd_sisdr_report
    from .pipeline import CHUNK_SAMPLES, FlashSRPipeline
    dev = _device(device)
    pipe = FlashSRPipeline(cfg, params=_state_dicts(params), device=dev)
    lr_w, hr_w = synth_pair_batch(prng.prng_key(seed), n, CHUNK_SAMPLES,
                                  coherent_p=coherent_p, device=dev)
    out = pipe.chunk_forward(lr_w, lowpass_input=False)
    r_pt, r_md = lsd_sisdr_report(hr_w, lr_w), lsd_sisdr_report(hr_w, out)
    return {"lsd_passthrough": float(r_pt["lsd_mean_db"].mean()),
            "lsd_model": float(r_md["lsd_mean_db"].mean()),
            "sisdr_passthrough": float(r_pt["si_sdr_db"].mean()),
            "sisdr_model": float(r_md["si_sdr_db"].mean())}


def _finish(tag: str, modules, cfg, out_path: Path, seed: int, metrics_extra: dict) -> dict:
    metrics = evaluate(modules, cfg, seed=seed + 7, device=next(modules.parameters()).device)
    metrics.update(metrics_extra)
    save_pretrained(modules, out_path, cfg=cfg)
    out_path.with_suffix(".json").write_text(json.dumps(metrics, indent=1))
    print(f"[{tag}] saved {out_path} metrics={metrics}", flush=True)
    return metrics


def _checkpoint(tag: str, i: int, modules, cfg, out_path: Path, seed: int) -> None:
    m = evaluate(modules, cfg, seed=seed + 7, n=2, device=next(modules.parameters()).device)
    save_pretrained(modules, out_path, cfg=cfg)
    print(f"[{tag}] ckpt @ step {i}: LSD {m['lsd_model']:.2f} dB, "
          f"SI-SDR {m['sisdr_model']:.2f} dB -> {out_path}", flush=True)


def distill(steps: int = 3000, batch: int = 8, frames: int = 128, lr: float = 2e-4,
            seed: int = 0, out_path: Optional[Path] = None, log_every: int = 100,
            scan_size: int = 1, cfg: Optional[FlashSRConfig] = None, ckpt_every: int = 0,
            resume: bool = False, device="cuda") -> dict:
    """Distill a compact trio on synthetic pairs (the JAX ``distill``, with
    its key schedule: ``fold_in(PRNGKey(seed + 1), i)`` a step, or a group
    of ``scan_size`` steps on ``split`` of it, one mean loss logged a
    group) and write ``out_path`` (float16 npz + ``.json`` metrics).
    ``out_path`` defaults to ``weights_dir() / "pretrained.npz"``, never
    the shipped file; ``resume`` continues (with a fresh optimizer) from
    the weights at an explicit ``out_path``, else from the served HiFi-GAN
    trio (``served_trio(PRETRAINED)``), as the JAX default, whose
    ``out_path`` is the served file."""
    from .train import make_optimizer
    dev = _device(device)
    src = Path(out_path) if out_path is not None else served_trio(PRETRAINED)
    out_path = Path(out_path) if out_path is not None else weights_dir() / PRETRAINED.name
    length = 480 * frames
    if resume:
        shipped = load_pretrained_with_cfg(src)
        if shipped is None:
            raise FileNotFoundError(f"--resume: no weights at {src}")
        cfg, sds = shipped
        modules = FlashSRModules(cfg)
        modules.load_state_dicts(sds)
        print(f"[distill] resuming from {src}", flush=True)
    else:
        cfg = cfg or distilled_config()
        modules = FlashSRModules(cfg)
        modules.init_params(seed)
    modules.to(dev)
    opt = make_optimizer(modules, lr)
    base = prng.prng_key(seed + 1)
    loss0 = loss = None
    if scan_size > 1:
        scan = make_distill_scan(modules, opt, batch, length, scan_size)
        since = 0
        for i in range(0, steps, scan_size):
            loss = float(scan(prng.fold_in(base, i)))
            loss0 = loss if loss0 is None else loss0
            print(f"[distill] step {i:5d}..{i + scan_size - 1} mean loss {loss:.4f}", flush=True)
            since += scan_size
            if ckpt_every and since >= ckpt_every and i + scan_size < steps:
                since = 0
                _checkpoint("distill", i, modules, cfg, out_path, seed)
    else:
        step = make_distill_step(modules, opt, batch, length)
        for i in range(steps):
            loss_t = step(prng.fold_in(base, i))
            if i % log_every == 0 or i == steps - 1:
                loss = float(loss_t)
                loss0 = loss if loss0 is None else loss0
                print(f"[distill] step {i:5d} loss {loss:.4f}", flush=True)
            if ckpt_every and i and i % ckpt_every == 0:
                _checkpoint("distill", i, modules, cfg, out_path, seed)
    return _finish("distill", modules, cfg, out_path, seed,
                   dict(steps=steps, batch=batch, frames=frames, loss_first=loss0,
                        loss_last=loss))


def distill_vocoder(steps: int = 20000, batch: int = 8, frames: int = 128, lr: float = 2e-4,
                    seed: int = 0, src_path: Optional[Path] = None,
                    out_path: Optional[Path] = None, scan_size: int = 1,
                    ckpt_every: int = 0, hidden: int = 256, depth: int = 6,
                    resume: bool = False, sisdr_w: float = 0.0, phase_cond: bool = False,
                    exciter: bool = False, device="cuda") -> dict:
    """Train an iSTFT-head ``SpectralVocoder`` against the frozen VAE/UNet
    of the trio at ``src_path`` (default: the served HiFi-GAN trio,
    ``served_trio(PRETRAINED)``; the JAX ``distill_vocoder``: key schedule
    ``fold_in(PRNGKey(seed + 11), i)`` then ``split(key, scan_size)``,
    data at ``EVAL_COHERENT_P``) and write the whole trio to ``out_path``
    (default ``weights_dir() / "pretrained_istft.npz"``, never the shipped
    file; ``resume`` reads an explicit ``out_path``, else the served istft
    trio).  The frozen modules run under ``no_grad``."""
    from .train import make_optimizer
    dev = _device(device)
    src_path = served_trio(PRETRAINED) if src_path is None else Path(src_path)
    prev_path = (Path(out_path) if out_path is not None
                 else served_trio(PRETRAINED_ISTFT))
    out_path = (Path(out_path) if out_path is not None
                else weights_dir() / PRETRAINED_ISTFT.name)
    shipped = load_pretrained_with_cfg(src_path)
    if shipped is None:
        raise FileNotFoundError(f"distill_vocoder: no shipped trio at {src_path}")
    cfg0, sds0 = shipped
    if resume:
        prev = load_pretrained_with_cfg(prev_path)
        if prev is None:
            raise FileNotFoundError(f"--resume: no weights at {prev_path}")
        cfg, prev_sds = prev
        modules = FlashSRModules(cfg)
        modules.vocoder.load_state_dict(prev_sds["sr_vocoder"], strict=True)
        print(f"[distill-voc] resuming from {prev_path}", flush=True)
    else:
        cfg = dataclasses.replace(cfg0, vocoder=VocoderConfig(
            kind="istft", hidden=hidden, depth=depth, phase_cond=phase_cond, exciter=exciter))
        modules = FlashSRModules(cfg)
        init_vocoder_head(modules.vocoder, seed)
    modules.vae.load_state_dict(sds0["vae"], strict=True)
    modules.unet.load_state_dict(sds0["student_ldm"], strict=True)
    modules.to(dev)
    for m in (modules.vae, modules.unet):
        m.requires_grad_(False)
    opt = make_optimizer(modules.vocoder, lr)
    length = 480 * frames
    base = prng.prng_key(seed + 11)
    ss = max(scan_size, 1)

    def one(k) -> torch.Tensor:
        kd, kn = prng.split(k)
        lr_w, hr_w = synth_pair_batch(kd, batch, length, coherent_p=EVAL_COHERENT_P,
                                      device=dev)
        opt.zero_grad(set_to_none=True)
        loss = _vocoder_loss(modules, lr_w, hr_w, kn, sisdr_w=sisdr_w)
        loss.backward()
        opt.step()
        return loss.detach()

    loss0 = loss = None
    since = 0
    for i in range(0, steps, ss):
        loss = float(torch.stack([one(k) for k in prng.split(prng.fold_in(base, i), ss)]).mean())
        loss0 = loss if loss0 is None else loss0
        print(f"[distill-voc] step {i:5d}..{i + ss - 1} mean loss {loss:.4f}", flush=True)
        since += ss
        if ckpt_every and since >= ckpt_every and i + ss < steps:
            since = 0
            _checkpoint("distill-voc", i, modules, cfg, out_path, seed)
    return _finish("distill-voc", modules, cfg, out_path, seed,
                   dict(steps=steps, batch=batch, frames=frames, loss_first=loss0,
                        loss_last=loss,
                        vocoder=f"istft hidden={cfg.vocoder.hidden} depth={cfg.vocoder.depth}"))


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="Distill compact FlashSR weights on the card")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan", type=int, default=1,
                    help="steps a group, one mean loss logged a group")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save + eval every N steps (long runs)")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU, not the card")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the weights at --out, else from the served "
                         "trio (fresh optimizer; pair with a lower --lr)")
    ap.add_argument("--vocoder-only", action="store_true",
                    help="train an iSTFT-head SpectralVocoder against the frozen shipped "
                         "VAE/UNet")
    ap.add_argument("--hidden", type=int, default=256,
                    help="SpectralVocoder backbone width (--vocoder-only)")
    ap.add_argument("--depth", type=int, default=6,
                    help="SpectralVocoder ConvNeXt blocks (--vocoder-only)")
    ap.add_argument("--sisdr-w", type=float, default=0.0,
                    help="weight of the SI-SDR surrogate + decoded-branch waveform L2 "
                         "(--vocoder-only)")
    ap.add_argument("--phase-cond", action="store_true",
                    help="condition the istft head on the input chunk's complex STFT "
                         "(--vocoder-only)")
    ap.add_argument("--exciter", action="store_true",
                    help="add x^2/x^3 sum-frequency phase candidates (--vocoder-only, "
                         "needs --phase-cond)")
    ap.add_argument("--out", type=str, default="",
                    help="output npz (default: pretrained.npz, or pretrained_istft.npz "
                         "with --vocoder-only, under the weights directory)")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    print("device:", torch.cuda.get_device_name(0) if device == "cuda"
          and torch.cuda.is_available() else device, flush=True)
    out = {"out_path": Path(a.out)} if a.out else {}
    if a.vocoder_only:
        distill_vocoder(steps=a.steps, batch=a.batch, frames=a.frames, lr=a.lr, seed=a.seed,
                        scan_size=a.scan, ckpt_every=a.ckpt_every, hidden=a.hidden,
                        depth=a.depth, resume=a.resume, sisdr_w=a.sisdr_w,
                        phase_cond=a.phase_cond, exciter=a.exciter, device=device, **out)
    else:
        distill(steps=a.steps, batch=a.batch, frames=a.frames, lr=a.lr, seed=a.seed,
                scan_size=a.scan, ckpt_every=a.ckpt_every, resume=a.resume,
                device=device, **out)


if __name__ == "__main__":
    main()
