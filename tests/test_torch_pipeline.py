"""PyTorch port vs the JAX package: the FlashSR pipeline as a whole.

A narrow full-config pipeline (LDMUNet with attention at ds=2 and ds=4,
VAE with mid attention and quant convs, HiFi-GAN vocoder) at the real
chunk geometry (5.12 s chunks, 512 mel frames, 256 mels), float32 on
both sides, with the JAX parameters converted by ``params_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.core.audio import AudioBuffer as JBuffer
from egregora_tpu.models.flashsr import ldm_unet as j_ldm
from egregora_tpu.models.flashsr import mel as j_mel
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.models.flashsr import vae as j_vae
from egregora_tpu.models.flashsr import vocoder as j_voc
from egregora_tpu.ops.stft import stft_conv as j_stft_conv
from egregora_tpu.ops.wola import chunk_batch as j_chunk_batch
from egregora_tpu_torch.core.audio import AudioBuffer
from egregora_tpu_torch.models.flashsr import ldm_unet as t_ldm
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.models.flashsr import vae as t_vae
from egregora_tpu_torch.models.flashsr import vocoder as t_voc
from egregora_tpu_torch.models.flashsr.mel import _reflect_pad
from egregora_tpu_torch.ops.stft import stft_conv as t_stft_conv
from egregora_tpu_torch.utils.weights import params_from_jax

SR_IN = 16000
N_FFT = 2048


def _cfgs():
    vae = dict(base_channels=8, channel_mults=(1, 2, 2), latent_channels=4,
               num_res_blocks=1, groups=4)
    unet = dict(in_channels=8, out_channels=4, model_channels=8, channel_mult=(1, 2, 2),
                num_res_blocks=1, attention_resolutions=(2, 4), num_heads=2, groups=4)
    voc = dict(upsample_initial=16, channel_floor=8)
    jc = j_pipe.FlashSRConfig(vae=j_vae.VAEConfig(dtype=jnp.float32, **vae),
                              unet=j_ldm.LDMUNetConfig(dtype=jnp.float32, **unet),
                              vocoder=j_voc.VocoderConfig(dtype=jnp.float32, **voc))
    tc = t_pipe.FlashSRConfig(vae=t_vae.VAEConfig(dtype=torch.float32, **vae),
                              unet=t_ldm.LDMUNetConfig(dtype=torch.float32, **unet),
                              vocoder=t_voc.VocoderConfig(dtype=torch.float32, **voc))
    return jc, tc


def _signal(seconds, seed=0):
    """Harmonic test tone + a little noise at 16 kHz, peak 0.5."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR_IN)) / SR_IN
    x = sum(np.sin(2 * np.pi * 220.0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 30)
            if 220.0 * h < SR_IN / 2)
    x = x + 0.01 * rng.standard_normal(t.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)[None, :]


@pytest.fixture(scope="module")
def pipes():
    jc, tc = _cfgs()
    jp = j_pipe.FlashSRPipeline(jc, seed=0)
    params = jax.tree_util.tree_map(np.asarray, jp.params)
    tp = t_pipe.FlashSRPipeline(tc, params=params_from_jax(tc, params), device="cpu")
    return jp, tp


def _jax_stages(jp):
    """The JAX chunk forward's stages, from the JAX package's own
    functions: (mel_hr, vocoder wave, output, low-band weight)."""
    mods, cfg = jp.modules, jp.cfg

    def run(params, x):
        mel = j_mel.log_mel(x)[:, :j_pipe.MEL_FRAMES, :]
        z_lr = mods.vae.apply(params["vae"], mel[..., None], method=j_vae.MelVAE.encode)
        noise = jax.random.normal(jax.random.PRNGKey(cfg.noise_seed),
                                  (1,) + z_lr.shape[1:], jnp.float32)
        z_in = jnp.concatenate([jnp.broadcast_to(noise, z_lr.shape), z_lr], axis=-1)
        z_hr = mods.unet.apply(params["student_ldm"], z_in, jnp.ones((z_in.shape[0],)))
        mel_hr = mods.vae.apply(params["vae"], z_hr, method=j_vae.MelVAE.decode)[..., 0]
        wav = mods.vocoder.apply(params["sr_vocoder"], mel_hr)[:, :j_pipe.CHUNK_SAMPLES]
        pad = N_FFT // 2
        rl, il = j_stft_conv(jnp.pad(x, ((0, 0), (pad, pad)), mode="reflect"), N_FFT, 512)
        w = j_pipe._bandwidth_mask_vs_pred(rl, il, mel_hr, j_pipe.REQ_SR,
                                           cfg.crossover_hz, N_FFT)
        return mel_hr, wav, jp._postprocess(x, wav, mel_hr), w

    return jax.jit(run)


def _edge_bins(w):
    """Bins below the merge edge (low-band weight above 1/2), per item."""
    return (np.asarray(w)[..., 0, :] > 0.5).sum(axis=-1)


def _lsd_db(a, b):
    """Log-spectral distance (dB) over 2048-sample Hann frames."""
    n = a.shape[-1] // 2048 * 2048

    def spec(x):
        return np.abs(np.fft.rfft(x[..., :n].reshape(-1, 2048) * np.hanning(2048))) + 1e-8

    return float(np.mean(np.sqrt(np.mean((20 * np.log10(spec(a) / spec(b))) ** 2, axis=-1))))


def test_chunk_forward_and_process_match_jax(pipes):
    """chunk_forward: decoded mel and vocoder wave within 1e-4 of JAX.
    process (one-shot, 16 kHz -> 48 kHz): the per-item crossover band
    edge agrees first, then the samples within 1e-4; if an edge sat on
    the border and flipped, LSD within 0.05 dB instead."""
    jp, tp = pipes
    x16 = _signal(4.0)
    x48 = np.asarray(jax.device_get(j_pipe.resample(jnp.asarray(x16), SR_IN, 48000)))
    chunks = np.array(j_chunk_batch(jnp.asarray(x48), j_pipe.CHUNK_SAMPLES,
                                    j_pipe.HOP_SAMPLES)[0])[:, 0]
    mel_j, wav_j, y_j, w_j = _jax_stages(jp)(jp.params, jnp.asarray(chunks))
    xt = torch.from_numpy(chunks)
    mel_t, wav_t = tp.synthesize(xt)
    assert np.abs(mel_t.numpy() - np.asarray(mel_j)).max() <= 1e-4
    assert np.abs(wav_t.numpy() - np.asarray(wav_j)).max() <= 1e-4
    y_t = tp.chunk_forward(xt)
    assert y_t.shape == (1, j_pipe.CHUNK_SAMPLES)
    assert np.abs(y_t.numpy() - np.asarray(y_j)).max() <= 1e-4

    rl, il = t_stft_conv(_reflect_pad(xt, N_FFT // 2), N_FFT, 512)
    w_t = t_pipe._bandwidth_mask_vs_pred(rl, il, mel_t, 48000, tp.cfg.crossover_hz, N_FFT)
    edges_agree = np.array_equal(_edge_bins(w_t.numpy()), _edge_bins(w_j))

    ref = np.asarray(jp.process(JBuffer(jnp.asarray(x16), SR_IN), mesh=None,
                                wire="f32").samples)
    got = tp.process(AudioBuffer(x16, SR_IN)).numpy()
    assert got.shape == ref.shape == (1, 4 * 48000)
    assert _lsd_db(ref, x48) > 0.0
    if edges_agree:
        assert np.abs(got - ref).max() <= 1e-4
    else:
        assert abs(_lsd_db(got, x48) - _lsd_db(ref, x48)) <= 0.05


def test_process_streaming_equals_one_shot_and_wire(pipes):
    """max_batch streaming == one-shot (the noise latent is shared by
    every chunk, so batching does not change any chunk), and the pcm16
    wire path decodes to the f32 output within its quantisation step."""
    _, tp = pipes
    x16 = _signal(6.5, seed=1)                     # 2 chunks at 48 kHz
    one = tp.process(AudioBuffer(x16, SR_IN), wire="f32").numpy()
    stream = tp.process(AudioBuffer(x16, SR_IN), max_batch=1).numpy()
    assert one.shape == stream.shape == (1, int(6.5 * 48000))
    assert np.isfinite(one).all()
    assert np.abs(one - stream).max() <= 1e-5
    wire = tp.process(AudioBuffer(x16, SR_IN), wire="pcm16")
    assert wire.samples.dtype == torch.int16 and wire.meta["wire"] == "pcm16"
    scale = float(wire.meta["wire_scale"])
    assert np.abs(wire.numpy() - one).max() <= 1.5 * scale / 32767 + 1e-4


@pytest.mark.parametrize("envelope_match,adaptive", [(True, True), ("replace", False)])
def test_postprocess_envelope_match_and_fixed_crossover(pipes, envelope_match, adaptive):
    """The merge options off the default path: the mel-envelope projection
    (per-band gain or "replace") fused into the adaptive merge, and the
    fixed FIR crossover."""
    import dataclasses
    jp, tp = pipes
    jcfg = dataclasses.replace(jp.cfg, envelope_match=envelope_match,
                               adaptive_crossover=adaptive)
    tcfg = dataclasses.replace(tp.cfg, envelope_match=envelope_match,
                               adaptive_crossover=adaptive)
    jq = j_pipe.FlashSRPipeline(jcfg, params=jp.params)
    tq = t_pipe.FlashSRPipeline(tcfg, params={k: m.state_dict() for k, m in
                                              tp.modules.by_name().items()}, device="cpu")
    rng = np.random.default_rng(8)
    x = (0.3 * rng.standard_normal((2, 48000))).astype(np.float32)
    wav = (0.3 * rng.standard_normal((2, 48000))).astype(np.float32)
    mel = (rng.standard_normal((2, 100, 256)) - 3.0).astype(np.float32)
    ref = np.asarray(jq._postprocess(jnp.asarray(x), jnp.asarray(wav), jnp.asarray(mel)))
    got = tq._postprocess(torch.from_numpy(x), torch.from_numpy(wav),
                          torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == x.shape
    assert np.abs(got - ref).max() <= 1e-4
