"""The FlashSR upscaler node's whole path, in plain float32 PyTorch.

What ``EgregoraAudioUpscaler.run(audio, lowpass_input=False,
output_sr="48000")`` computes, written out from the port's pipeline
(``models/flashsr/pipeline.py``) without its kernels, its bfloat16 or its
pcm16 wire: resample to 48 kHz -> 5.12 s chunks with 0.5 s overlap ->
log-mel -> VAE encode -> one-step UNet on (JAX-seeded noise latent ++
the LR latent) at t = 1 -> VAE decode -> vocoder -> (envelope projection
where configured) adaptive crossover merge with the input's observed band
-> symmetric-Hann overlap-add -> resample out.  Chunks run in blocks of
``block`` rows, so that a long input fits; every row is independent of
the others, so the block changes nothing but memory.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import convert, dsp
from .models import LDMUNet, LDMUNetConfig, MelVAE, StudentUNet, build_vocoder
from .numerics import float32_mode, precision

CHUNK = int(48000 * 5.12)                  # 245760
HOP_SAMPLES = int((5.12 - 0.50) * 48000)   # 221760
MEL_FRAMES = CHUNK // dsp.HOP              # 512


class ReferenceFlashSR:
    """The trio (``vae``, ``student_ldm``, ``sr_vocoder``) and the node's
    orchestration around it, on ``device``."""

    def __init__(self, vae_cfg, unet_cfg, voc_cfg, opts: Dict, device):
        self.cfgs = (vae_cfg, unet_cfg, voc_cfg)
        self.opts = dict(opts)
        self.device = torch.device(device)
        with self.device:
            self.modules = {
                "vae": MelVAE(vae_cfg),
                "student_ldm": (LDMUNet(unet_cfg) if isinstance(unet_cfg, LDMUNetConfig)
                                else StudentUNet(unet_cfg)),
                "sr_vocoder": build_vocoder(voc_cfg),
            }

    @classmethod
    def from_npz(cls, path, device) -> "ReferenceFlashSR":
        text, flat = convert.read_npz(path)
        ref = cls(*convert.config_from_json(text), device=device)
        convert.load_npz(ref.modules, flat)
        return ref.to(device)

    def load_upstream(self, sds: Dict[str, Dict[str, torch.Tensor]]) -> "ReferenceFlashSR":
        convert.load_upstream(self.modules, sds, self.cfgs)
        return self.to(self.device)

    def to(self, device) -> "ReferenceFlashSR":
        self.device = torch.device(device)
        for m in self.modules.values():
            m.to(self.device).eval()
        return self

    # ---- one batch of 48 kHz chunks ----
    def synthesize(self, x: torch.Tensor):
        """``[B, CHUNK]`` -> ``(mel_hr [B, 512, 256], wave [B, CHUNK])``."""
        vae, unet, voc = (self.modules[n] for n in ("vae", "student_ldm", "sr_vocoder"))
        mel = dsp.log_mel(x)[:, :MEL_FRAMES, :]
        z_lr = vae.encode(mel[..., None])
        noise = torch.from_numpy(dsp.jax_normal(self.opts["noise_seed"],
                                                (1,) + tuple(z_lr.shape[1:]))).to(x.device)
        z_in = torch.cat([noise.expand_as(z_lr), z_lr], dim=-1)
        z_hr = unet(z_in, torch.ones(z_in.shape[0], device=x.device))
        mel_hr = vae.decode(z_hr)[..., 0]
        wav = voc(mel_hr, ref=x) if self.cfgs[2].phase_cond else voc(mel_hr)
        return mel_hr, wav[:, :CHUNK]

    def postprocess(self, x: torch.Tensor, wav: torch.Tensor, mel_hr: torch.Tensor) -> torch.Tensor:
        o = self.opts
        if not o["adaptive_crossover"]:
            raise NotImplementedError("the reference follows the adaptive crossover only")
        n_fft, hop, pad = 2048, 512, 1024
        t = x.shape[-1]
        rl, il = dsp.stft_conv(dsp.reflect_pad(x, pad), n_fft, hop)
        rh, ih = dsp.stft_conv(dsp.reflect_pad(wav, pad), n_fft, hop)
        if o["envelope_match"]:
            g = dsp.envelope_gain(rh, ih, mel_hr, n_fft, hop,
                                  replace=o["envelope_match"] == "replace")
            rh, ih = rh * g, ih * g
        w, edges = dsp.bandwidth_mask(rl, il, mel_hr, o["crossover_hz"], n_fft)
        y = dsp.istft_dense(rl * w + rh * (1.0 - w), il * w + ih * (1.0 - w), n_fft, hop)
        return y[..., pad: pad + t], edges

    def chunk_forward(self, chunks: torch.Tensor):
        """``[B, CHUNK]`` -> (``[B, CHUNK]``, each row's lowest and highest
        possible merge edge in Hz, ``[B, 2]``)."""
        x = chunks.to(self.device, torch.float32)
        mel_hr, wav = self.synthesize(x)
        return self.postprocess(x, wav, mel_hr)

    # ---- a whole input ----
    @torch.inference_mode()
    def process(self, samples: np.ndarray, sr: int, out_sr: int = 48000, block: int = 4,
                mode: str = "fp32") -> Tuple[np.ndarray, np.ndarray]:
        """``[C, N]`` float32 at ``sr`` -> (``[C, M]`` float32 at ``out_sr``,
        ``[K, C, 2]`` each chunk's lowest and highest possible merge edge in
        Hz).  ``mode`` "control" is the control: the sub-models' products
        in fp8 and the float32 signal processing in TF32."""
        with float32_mode(mode == "control"), precision("fp8" if mode == "control" else "fp32"):
            x = dsp.resample(torch.from_numpy(np.ascontiguousarray(samples, np.float32))
                             .to(self.device), int(sr), 48000)
            c, total = x.shape
            chunks, lengths = dsp.chunk_batch(x, CHUNK, HOP_SAMPLES)
            rows = chunks.reshape(-1, CHUNK)
            parts = [self.chunk_forward(rows[i:i + block]) for i in range(0, rows.shape[0], block)]
            out = torch.cat([p[0] for p in parts])
            edges = torch.cat([p[1] for p in parts]).reshape(chunks.shape[:2] + (2,))
            y = dsp.wola_stitch(out.reshape(chunks.shape), lengths, total, HOP_SAMPLES)
            return dsp.resample(y, 48000, int(out_sr)).cpu().numpy(), edges.cpu().numpy()
