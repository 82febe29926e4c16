"""FlashSR end-to-end pipeline in PyTorch: chunked, batched, on one card.

Counterpart of ``egregora_tpu/models/flashsr/pipeline.py``, for the full
config (``LDMUNet``, ``MelVAE`` with mid attention and quant convs, the
HiFi-GAN ``SRVocoder``) and the shipped compact trios (``StudentUNet``,
the compact ``MelVAE``, and the HiFi-GAN ``SRVocoder`` or the
phase-conditioned ``SpectralVocoder``):

  resample to 48 kHz -> chunk (5.12 s window / 0.5 s overlap) -> log-mel
  -> VAE encode -> one-step UNet (LR latent ++ a seeded noise latent)
  -> VAE decode -> vocoder -> adaptive crossover merge with the input's
  observed band -> Hann WOLA stitch -> resample out.

All chunks run as one batch (``max_batch=None``) or stream through
fixed-size batches folded into running overlap-add sums.  Every
attention of the path goes through ``ops.attention.mha``, one launch of
the ``attn_rows`` kernel on the card per call: 13 calls per chunk batch
at the full config (5 + 6 in the UNet, 2 in the VAE), one in the
compact trios (the ``StudentUNet`` mid block).  With
``EGREGORA_FUSED_VOCODER=1`` on the card, a HiFi-GAN vocoder runs
``vocoder.apply_fused``: its MRF stages on the ``csrc/mrf.cu`` kernels.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...core.audio import AudioBuffer, wire_in, wire_out
from ...ops.fir import fir_same
from ...ops.resample import resample, resampled_length
from ...ops.stft import device_tensor, istft_dense, stft_conv
from ...ops.wola import (chunk_batch, num_chunks, wola_accumulate_dense,
                         wola_finalize, wola_stitch)
from ...parallel.mesh import chunk_parallel, make_chunk_mesh, replicate, resolve
from ...parallel.multihost import all_gather_rows, local_batch_slice, world
from ...utils.profiling import count, span
from . import prng
from .ldm_unet import LDMUNet, LDMUNetConfig
from .mel import (HOP, N_MELS, SAMPLE_RATE, _reflect_pad, envelope_gain, log_mel,  # noqa: F401
                  mel_band_peaks, mel_envelope_match, mel_filterbank)
from .unet import StudentUNet, UNetConfig
from .vae import MelVAE, VAEConfig
from .vocoder import VocoderConfig, apply_fused, build_vocoder

REQ_SR = SAMPLE_RATE                  # 48000
CHUNK_S = 5.12
OVERLAP_S = 0.50
CHUNK_SAMPLES = int(REQ_SR * CHUNK_S)  # 245760
HOP_SAMPLES = int((CHUNK_S - OVERLAP_S) * REQ_SR)  # 221760
MEL_FRAMES = CHUNK_SAMPLES // HOP      # 512 frames per chunk


@dataclasses.dataclass(frozen=True)
class FlashSRConfig:
    vae: VAEConfig = VAEConfig()
    # LDMUNetConfig -> the upstream LDMUNet layout; UNetConfig -> StudentUNet
    unet: Union[LDMUNetConfig, UNetConfig] = LDMUNetConfig()
    vocoder: VocoderConfig = VocoderConfig()
    crossover_hz: float = 11000.0   # low-band preservation crossover
    noise_seed: int = 0             # deterministic one-step noise latent
    # re-impose the predicted mel envelope on the vocoder output before
    # the merge: False, True (per-band gain) or "replace"
    envelope_match: object = False
    # lower the merge point per item to the input's detected bandwidth
    adaptive_crossover: bool = True


class FlashSRModules:
    """The three sub-models (the three reference checkpoints)."""

    NAMES = ("vae", "student_ldm", "sr_vocoder")

    def __init__(self, cfg: FlashSRConfig = FlashSRConfig()):
        self.cfg = cfg
        self.vae = MelVAE(cfg.vae)
        self.unet = (LDMUNet(cfg.unet) if isinstance(cfg.unet, LDMUNetConfig)
                     else StudentUNet(cfg.unet))
        self.vocoder = build_vocoder(cfg.vocoder)

    def all(self):
        return self.vae, self.unet, self.vocoder

    def parameters(self):
        """Every parameter of the trio, in ``all()``'s order."""
        for m in self.all():
            yield from m.parameters()

    def by_name(self) -> Dict[str, torch.nn.Module]:
        return dict(zip(self.NAMES, self.all()))

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights in place: the JAX package's
        ``init_params(seed)`` draw for draw (``utils.weights.fast_init_like``
        over the trio's flax tree, JAX's sorted leaf order), drawn on the
        host, so a seed gives the same weights in both packages and on
        every device."""
        from ...utils.weights import fast_init_like, flax_tree, module_from_jax
        mods = self.by_name()
        tree = fast_init_like({name: flax_tree(m) for name, m in mods.items()}, seed)
        for name, m in mods.items():
            m.load_state_dict(module_from_jax(m, tree[name]), strict=True)

    def load_state_dicts(self, params: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load ``{"vae": sd, "student_ldm": sd, "sr_vocoder": sd}``
        (``utils.weights.params_from_jax``'s output), strictly."""
        for name, mod in self.by_name().items():
            mod.load_state_dict(params[name], strict=True)

    def to(self, device) -> "FlashSRModules":
        for m in self.all():
            m.to(device).eval()
        return self


def _fused_vocoder_enabled(device: torch.device) -> bool:
    """Whether a HiFi-GAN vocoder runs ``vocoder.apply_fused`` (the MRF
    kernels) instead of its module path: ``EGREGORA_FUSED_VOCODER`` set
    and the pipeline on a CUDA device."""
    return bool(os.environ.get("EGREGORA_FUSED_VOCODER")) and device.type == "cuda"


def lowpass_fir(x: torch.Tensor, sr: int, cutoff_hz: float, taps: int = 255) -> torch.Tensor:
    """Linear-phase windowed-sinc lowpass along the last axis."""
    n = np.arange(taps) - (taps - 1) / 2.0
    wc = cutoff_hz / (sr / 2.0)
    h = np.sinc(wc * n) * wc * np.hamming(taps)
    return fir_same(x, (h / h.sum()).astype(np.float32))


def _crossover_merge(low_src: torch.Tensor, high_src: torch.Tensor, sr: int,
                     crossover_hz: float) -> torch.Tensor:
    """Linear-phase FIR crossover: low band from ``low_src``, high band
    from ``high_src`` (complementary highpass = x - lowpass(x))."""
    return (lowpass_fir(low_src, sr, crossover_hz)
            + high_src - lowpass_fir(high_src, sr, crossover_hz))


def _bandwidth_mask_vs_pred(rl: torch.Tensor, il: torch.Tensor, log_mel_pred: torch.Tensor,
                            sr: int, max_hz: float, n_fft: int,
                            delta: float = 2.0) -> torch.Tensor:
    """Low-band weight ``[..., 1, bins]``: a sigmoid step (4 bins wide) at
    the merge edge, the peak of the highest mel band whose observed level
    reaches the model's predicted level (within ``delta`` nats), at most
    ``max_hz``; ``max_hz`` when no band does (an input far below the
    prediction everywhere keeps the fixed crossover)."""
    n_mels = log_mel_pred.shape[-1]
    dev = str(rl.device)
    mag = torch.sqrt(rl * rl + il * il + 1e-20)
    fb = device_tensor(mel_filterbank, sr, n_fft, n_mels, device=dev)
    in_band = torch.log(torch.clamp(mag @ fb, min=1e-5)).mean(dim=-2)
    active = in_band > log_mel_pred.mean(dim=-2) - delta
    peaks = device_tensor(mel_band_peaks, sr, n_fft, n_mels, device=dev)
    edge = torch.where(active, peaks, torch.zeros_like(peaks)).amax(dim=-1, keepdim=True)
    edge = torch.where(active.any(dim=-1, keepdim=True), edge, torch.full_like(edge, max_hz))
    cut = torch.clamp(edge, max=max_hz) / (sr / n_fft)
    bins = torch.arange(n_fft // 2 + 1, dtype=torch.float32, device=rl.device)
    return torch.sigmoid((cut - bins) / 4.0)[..., None, :]


class FlashSRPipeline:
    """Chunk forward + orchestration of a whole file, on ``device``."""

    def __init__(self, cfg: FlashSRConfig = FlashSRConfig(),
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.modules = FlashSRModules(cfg)
        if params is None:
            self.modules.init_params(seed)
        else:
            self.modules.load_state_dicts(params)
        self.modules.to(self.device)
        self._noise: Dict[tuple, torch.Tensor] = {}

    def _noise_latent(self, shape) -> torch.Tensor:
        """``jax.random.normal(PRNGKey(noise_seed), (1,) + shape)``: one
        noise map broadcast over the batch, so results do not depend on
        how chunks are batched."""
        key = tuple(shape)
        if key not in self._noise:
            count("noise_builds")
            self._noise[key] = torch.from_numpy(
                prng.normal(self.cfg.noise_seed, (1,) + key)).to(self.device)
        return self._noise[key]

    @torch.inference_mode()
    def synthesize(self, x: torch.Tensor):
        """The model stages of a chunk batch ``[B, CHUNK_SAMPLES]`` (float32
        on the pipeline's device): ``(mel_hr [B, 512, n_mels], wav [B,
        CHUNK_SAMPLES])``, the decoded mel and the vocoder's wave."""
        mods = self.modules
        with span("egr.mel"):
            mel = log_mel(x)[:, :MEL_FRAMES, :]
        with span("egr.vae.encode"):
            z_lr = mods.vae.encode(mel[..., None])
        noise = self._noise_latent(z_lr.shape[1:]).expand_as(z_lr)
        z_in = torch.cat([noise, z_lr], dim=-1)
        with span("egr.unet"):
            z_hr = mods.unet(z_in, torch.ones(z_in.shape[0], device=self.device))
        with span("egr.vae.decode"):
            mel_hr = mods.vae.decode(z_hr)[..., 0]
        voc = self.cfg.vocoder
        with span("egr.vocoder"):
            if voc.kind == "hifigan" and _fused_vocoder_enabled(self.device):
                wav = apply_fused(mods.vocoder, mel_hr)
            elif voc.phase_cond:
                wav = mods.vocoder(mel_hr, ref=x)
            else:
                wav = mods.vocoder(mel_hr)
        return mel_hr, wav[:, :CHUNK_SAMPLES]

    @torch.inference_mode()
    def chunk_forward(self, chunks: torch.Tensor, lowpass_input: bool = False) -> torch.Tensor:
        """``[B, CHUNK_SAMPLES] @48k -> [B, CHUNK_SAMPLES] @48k`` float32."""
        x = chunks.to(self.device, torch.float32)
        if lowpass_input:
            x = lowpass_fir(x, REQ_SR, self.cfg.crossover_hz)
        mel_hr, wav = self.synthesize(x)
        with span("egr.merge"):
            return self._postprocess(x, wav, mel_hr).float()

    def _postprocess(self, x: torch.Tensor, wav: torch.Tensor,
                     mel_hr: torch.Tensor) -> torch.Tensor:
        """Envelope projection + low-band crossover merge, sharing one
        STFT analysis/synthesis pass when the crossover is adaptive."""
        cfg = self.cfg
        replace = cfg.envelope_match == "replace"
        if not cfg.adaptive_crossover:
            if cfg.envelope_match:
                wav = mel_envelope_match(wav, mel_hr, replace=replace)
            return _crossover_merge(x, wav, REQ_SR, cfg.crossover_hz)
        n_fft, hop = 2048, 512
        t = x.shape[-1]
        pad = n_fft // 2
        rl, il = stft_conv(_reflect_pad(x, pad), n_fft, hop)
        rh, ih = stft_conv(_reflect_pad(wav, pad), n_fft, hop)
        if cfg.envelope_match:
            g = envelope_gain(rh, ih, mel_hr, sr=REQ_SR, n_fft=n_fft, hop=hop,
                              replace=replace)
            rh, ih = rh * g, ih * g
        w = _bandwidth_mask_vs_pred(rl, il, mel_hr, REQ_SR, cfg.crossover_hz, n_fft)
        y = istft_dense(rl * w + rh * (1.0 - w), il * w + ih * (1.0 - w), n_fft, hop)
        return y[..., pad: pad + t]

    # ---- chunk parallelism ----
    def _resolve_mesh(self, mesh):
        """'auto' -> a chunk mesh over every visible card when there is
        more than one and the pipeline is on the card, else None."""
        if mesh != "auto":
            return mesh
        if self.device.type != "cuda" or torch.cuda.device_count() <= 1:
            return None
        return make_chunk_mesh()

    def _sharded_forward(self, mesh, flat: torch.Tensor, lowpass_input: bool) -> torch.Tensor:
        """``chunk_forward`` of ``[K, CHUNK_SAMPLES]`` over the mesh: this
        process's ``local_batch_slice`` of the rows, split over its cards
        (one copy of the trio a card), then every process's rows gathered
        in order.  K is a multiple of ``mesh.size``."""
        if mesh is None:
            return self.chunk_forward(flat, lowpass_input=lowpass_input)
        if mesh.devices[0] != resolve(self.device):
            raise ValueError(f"process: the mesh's first device {mesh.devices[0]} is not "
                             f"the pipeline's {self.device}")
        if mesh.world != world():
            raise ValueError(f"process: the mesh spans {mesh.world} processes, the "
                             f"torch.distributed group {world()}")
        local = flat[local_batch_slice(flat.shape[0])] if mesh.world > 1 else flat
        replicas = []
        for mods in replicate(mesh, self.modules):
            rep = self
            if mods is not self.modules:
                rep = copy.copy(self)
                rep.modules, rep.device, rep._noise = mods, next(mods.parameters()).device, {}
            replicas.append(rep)
        run = chunk_parallel(
            lambda i, x: replicas[i].chunk_forward(x, lowpass_input=lowpass_input), mesh)
        out = run(local)
        return all_gather_rows(out) if mesh.world > 1 else out

    # ---- full-file processing ----
    @torch.inference_mode()
    def process(self, audio: AudioBuffer, lowpass_input: bool = False,
                output_sr: int = 48000, pad_to_multiple: int = 1,
                max_batch: Optional[int] = None, mesh="auto",
                wire: str = "auto") -> AudioBuffer:
        """The reference node flow on the card.

        ``max_batch`` bounds device memory for long inputs: fixed-size
        chunk batches stream through the forward and fold into running
        Hann-weighted sums; None runs every chunk in one batch.

        ``mesh``: 'auto' shards the chunk batch over every visible card
        when there is more than one (``parallel.mesh``); a ``ChunkMesh``
        pins one (``multihost.make_global_chunk_mesh()`` across the
        processes of a ``torch.distributed`` group: each process runs its
        ``local_batch_slice`` and every process gets the whole output);
        None keeps one card.  The chunk count is padded to
        ``lcm(pad_to_multiple, mesh.size)`` and a streaming ``max_batch``
        rounded up to a multiple of ``mesh.size``.

        ``wire``: host<->device transfer format of the one-shot path
        (``core.audio.wire_in`` / ``wire_out``; streaming stays float32).
        "pcm16" quantises to 16 bits at both edges (-90 dBFS floor),
        dividing peaks above full scale down by ``max(1, peak)``: the
        float32 input crosses once and is quantised on the pipeline's
        device; the output is quantised there and crosses as int16 (2
        bytes a sample), its factor in ``meta["wire_scale"]``, so the
        returned buffer holds int16 samples that ``AudioBuffer.numpy()``
        dequantizes.  "auto" takes pcm16 when the samples are host numpy
        and the pipeline runs on the card; "f32" never.

        Spans (``utils.profiling``): ``egr.process`` (attributes
        ``channels``, ``in_sr``, ``samples``; counts ``rows``, the chunk
        rows, and the pcm16 wire's ``wire_bytes_in`` and
        ``wire_bytes_out``) over ``egr.wire.h2d``, ``egr.wire.encode``,
        ``egr.resample.in``, ``egr.chunk``, ``egr.forward``,
        ``egr.stitch``, ``egr.resample.out`` and ``egr.wire.quantise``."""
        in_sr = int(audio.sample_rate)
        out_sr = int(output_sr)
        with span("egr.process", channels=audio.channels, in_sr=in_sr,
                  samples=audio.num_samples):
            mesh = self._resolve_mesh(mesh)
            pad_mult = (int(np.lcm(max(pad_to_multiple, 1), mesh.size)) if mesh
                        else pad_to_multiple)
            total48 = resampled_length(audio.samples.shape[-1], in_sr, REQ_SR)
            k = -(-num_chunks(total48, CHUNK_SAMPLES, HOP_SAMPLES) // pad_mult) * pad_mult
            if max_batch is not None and k > max_batch:
                b = int(max_batch)
                if mesh:
                    b = -(-b // mesh.size) * mesh.size
                return self._process_streaming(audio, lowpass_input, out_sr, pad_mult, b, mesh)

            x, on_wire = wire_in(audio, self.device, wire)
            with span("egr.resample.in"):
                x = resample(x, in_sr, REQ_SR)
            c, total = x.shape
            with span("egr.chunk"):
                chunks, starts, lengths = chunk_batch(x, CHUNK_SAMPLES, HOP_SAMPLES,
                                                      pad_to_multiple=pad_mult)
            count("rows", chunks.shape[0] * c)
            with span("egr.forward"):
                preds = self._sharded_forward(mesh, chunks.reshape(-1, CHUNK_SAMPLES),
                                              lowpass_input)
            with span("egr.stitch"):
                out = wola_stitch(preds.reshape(chunks.shape), starts, lengths, total,
                                  CHUNK_SAMPLES)
            with span("egr.resample.out"):
                out = resample(out, REQ_SR, out_sr)
            return wire_out(out, out_sr, audio.meta, on_wire)

    def _process_streaming(self, audio: AudioBuffer, lowpass_input: bool, out_sr: int,
                           pad_to_multiple: int, b: int, mesh=None) -> AudioBuffer:
        """Fixed-size batches of ``b`` chunks folded into running dense
        OLA accumulators: O(batch) activations, O(total) accumulators.
        Inside ``process``'s span: ``egr.forward`` and ``egr.stitch`` once
        a batch."""
        x, _ = wire_in(audio, self.device, "f32")
        with span("egr.resample.in"):
            x = resample(x, int(audio.sample_rate), REQ_SR)
        c, total = x.shape
        with span("egr.chunk"):
            chunks, _, lengths = chunk_batch(x, CHUNK_SAMPLES, HOP_SAMPLES,
                                             pad_to_multiple=int(np.lcm(pad_to_multiple, b)))
        k = chunks.shape[0]               # a multiple of b; starts = i*hop
        count("rows", k * c)
        alloc = (k + 1) * HOP_SAMPLES
        acc = torch.zeros(c, alloc, device=self.device)
        wsum = torch.zeros(alloc, device=self.device)
        for s0 in range(0, k, b):
            with span("egr.forward"):
                pred = self._sharded_forward(
                    mesh, chunks[s0: s0 + b].reshape(-1, CHUNK_SAMPLES), lowpass_input)
            with span("egr.stitch"):
                wola_accumulate_dense(pred.reshape(b, c, CHUNK_SAMPLES), lengths[s0: s0 + b],
                                      HOP_SAMPLES, acc, wsum, s0 * HOP_SAMPLES)
        with span("egr.stitch"):
            out = wola_finalize(acc[:, :total], wsum[:total])
        with span("egr.resample.out"):
            out = resample(out, REQ_SR, out_sr)
        return wire_out(out, out_sr, audio.meta, False)
