"""PyTorch port vs the JAX package: the served FlashSR path.

``StudentUNet`` and ``SpectralVocoder`` at small widths, the shipped
trios (``pretrained.npz``, ``pretrained_istft.npz``) loaded by both
packages and run on one full-width chunk, the weight resolver's order
and the ``EgregoraAudioUpscaler`` node's contract.  Every comparison is
float32 on the CPU; each tolerance is stated where it is used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models.flashsr import distill as j_distill
from egregora_tpu.models.flashsr import mel as j_mel
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.models.flashsr import unet as j_unet
from egregora_tpu.models.flashsr import vae as j_vae
from egregora_tpu.models.flashsr import vocoder as j_voc
from egregora_tpu.nodes import super_resolution as j_node
from egregora_tpu.utils.weights import fast_init_like
from egregora_tpu_torch.core.audio import from_any
from egregora_tpu_torch.models.flashsr import distill as t_distill
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.models.flashsr import unet as t_unet
from egregora_tpu_torch.models.flashsr import vocoder as t_voc
from egregora_tpu_torch.nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
from egregora_tpu_torch.nodes import super_resolution as t_node
from egregora_tpu_torch.utils.weights import module_from_jax

# modules at small widths: the same weights and input on both sides,
# sums in another order (~1e-7 relative a layer) over a few dozen layers
ATOL = 1e-4


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _init(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return jax.tree_util.tree_map(np.asarray, fast_init_like(shapes, seed))


def test_student_unet_matches_jax():
    """FiLM ResBlocks, attention at level 1 and in the middle (flax
    multi-head attention in JAX, ``ops.attention.mha`` in the port),
    stride-2 down, nearest up."""
    kw = dict(in_channels=8, out_channels=4, base_channels=16, channel_mults=(1, 2, 2),
              num_res_blocks=1, attn_levels=(1,), num_heads=2, time_dim=32, groups=4)
    jm = j_unet.StudentUNet(j_unet.UNetConfig(dtype=jnp.float32, **kw))
    tm = t_unet.StudentUNet(t_unet.UNetConfig(dtype=torch.float32, **kw))
    z = _x((2, 16, 8, 8), 1)
    t = np.array([1.0, 0.3], np.float32)
    p = _init(jm, jnp.asarray(z), jnp.asarray(t), seed=2)
    tm.load_state_dict(module_from_jax(tm, p), strict=True)
    attn = [n for n, m in tm.named_modules() if isinstance(m, t_unet.SelfAttention2D)]
    assert len(attn) == 4            # level 1: one down, two up; one in the middle
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(t)).numpy()
    ref = np.asarray(jm.apply(p, jnp.asarray(z), jnp.asarray(t)))
    assert got.shape == ref.shape == (2, 16, 8, 4)
    assert np.abs(got - ref).max() <= ATOL


@pytest.mark.parametrize("phase_cond,exciter", [(False, False), (True, False), (True, True)])
def test_spectral_vocoder_matches_jax(phase_cond, exciter):
    """ConvNeXt backbone (LayerNorm eps 1e-6, tanh GELU, depthwise taps
    as shifted multiply-adds) and the gated phase head.  The output is
    ``exp(logmag)``-scaled, so the bound is relative to its peak."""
    kw = dict(n_mels=16, hidden=32, depth=2, mlp_ratio=2, istft_nfft=960,
              phase_cond=phase_cond, exciter=exciter, kind="istft")
    jm = j_voc.SpectralVocoder(j_voc.VocoderConfig(dtype=jnp.float32, **kw))
    tm = t_voc.SpectralVocoder(t_voc.VocoderConfig(dtype=torch.float32, **kw))
    mel = _x((2, 10, 16), 3, scale=0.5)
    ref_in = _x((2, 10 * 480), 4, scale=0.3)
    extra = {"ref": jnp.asarray(ref_in)} if phase_cond else {}
    p = _init(jm, jnp.asarray(mel), seed=5, **extra)
    # flax zero-initialises the gates' kernels: give them values
    for name in ("phase_gates", "mag_gate"):
        if name in p["params"]:
            p["params"][name]["kernel"] = _x(p["params"][name]["kernel"].shape, 6, 0.05)
    tm.load_state_dict(module_from_jax(tm, p), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(mel), ref=torch.from_numpy(ref_in) if phase_cond else None)
    ref = np.asarray(jm.apply(p, jnp.asarray(mel), **extra))
    assert got.shape == ref.shape == (2, 10 * 480)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _f32(cfg, dtype):
    return dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), dtype=dtype)
                                       for k in ("vae", "unet", "vocoder")})


def _geometry(cfg):
    """A config's fields without the dtype ones, comparable across packages."""
    def strip(c):
        d = dataclasses.asdict(c)
        d.pop("dtype", None)
        return d
    return {f.name: (strip(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module", params=["pretrained.npz", "pretrained_istft.npz"])
def shipped(request):
    path = j_distill.PRETRAINED.parent / request.param
    assert t_distill.SHIPPED_DIR / request.param == path
    jcfg, jparams = j_distill.load_pretrained_with_cfg(path)
    tcfg, sd = t_distill.load_pretrained_with_cfg(path)
    return request.param, jcfg, jparams, tcfg, sd


def test_shipped_npz_config_and_state_dicts(shipped):
    """The same geometry from ``__config__``; every npz value lands in
    the port's state dicts (float16 cast to float32), in the layouts of
    ``utils.weights``."""
    name, jcfg, jparams, tcfg, sd = shipped
    assert _geometry(tcfg) == _geometry(jcfg)
    n_npz = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jparams))
    assert n_npz == sum(t.numel() for d in sd.values() for t in d.values())
    att = "SelfAttention2D_0.MultiHeadDotProductAttention_0"
    jatt = jparams["student_ldm"]["params"]["SelfAttention2D_0"]["MultiHeadDotProductAttention_0"]
    assert sd["student_ldm"][f"{att}.query.weight"].shape == (128, 4, 32)
    assert np.array_equal(sd["student_ldm"][f"{att}.out.weight"].numpy(),
                          np.asarray(jatt["out"]["kernel"]))
    conv = jparams["sr_vocoder"]["params"]["Conv_0"]["kernel"]          # [7, Ci, Co]
    assert np.array_equal(sd["sr_vocoder"]["Conv_0.weight"].numpy(),
                          np.asarray(conv).transpose(2, 1, 0))
    if name == "pretrained_istft.npz":
        assert tcfg.vocoder.kind == "istft" and tcfg.vocoder.phase_cond and tcfg.vocoder.exciter
        assert sd["sr_vocoder"]["phase_in.weight"].shape == (256, 13 * 961)
    else:
        assert tcfg.vocoder.kind == "hifigan" and tcfg.vocoder.upsample_initial == 128


def _chunk():
    """One 5.12 s chunk at 48 kHz: two tones and a little noise."""
    t = np.arange(t_pipe.CHUNK_SAMPLES) / 48000
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1320 * t)
    return (x + 0.01 * np.random.default_rng(0).standard_normal(t.shape)).astype(np.float32)[None]


def test_shipped_trio_one_chunk_matches_jax(shipped):
    """One full-width chunk of each shipped trio, float32 on both sides:
    the decoded mel within 5e-3 (the log-mel front end takes ``log`` of
    mel bins near its 1e-5 floor, which turns the DFT matmuls' sum-order
    differences into up to 2.3e-3 at this input; every model stage
    alone agrees to 6e-6), the vocoder wave and the merged output within
    1e-3 (HiFi-GAN: 3.7e-4 through 54 convs at 48 kHz)."""
    name, jcfg, jparams, tcfg, sd = shipped
    jp = j_pipe.FlashSRPipeline(_f32(jcfg, jnp.float32), params=jparams)
    tp = t_pipe.FlashSRPipeline(_f32(tcfg, torch.float32), params=sd, device="cpu")
    mods = jp.modules
    x = _chunk()

    def stages(params, x):
        mel = j_mel.log_mel(x)[:, :j_pipe.MEL_FRAMES, :]
        z_lr = mods.vae.apply(params["vae"], mel[..., None], method=j_vae.MelVAE.encode)
        noise = jax.random.normal(jax.random.PRNGKey(jp.cfg.noise_seed),
                                  (1,) + z_lr.shape[1:], jnp.float32)
        z_in = jnp.concatenate([jnp.broadcast_to(noise, z_lr.shape), z_lr], axis=-1)
        z_hr = mods.unet.apply(params["student_ldm"], z_in, jnp.ones((1,)))
        mel_hr = mods.vae.apply(params["vae"], z_hr, method=j_vae.MelVAE.decode)[..., 0]
        kw = {"ref": x} if jp.cfg.vocoder.phase_cond else {}
        wav = mods.vocoder.apply(params["sr_vocoder"], mel_hr, **kw)[:, :j_pipe.CHUNK_SAMPLES]
        return mel_hr, wav, jp._postprocess(x, wav, mel_hr)

    mel_j, wav_j, y_j = jax.jit(stages)(jp.params, jnp.asarray(x))
    mel_t, wav_t = tp.synthesize(torch.from_numpy(x))
    y_t = tp.chunk_forward(torch.from_numpy(x))
    assert mel_t.shape == (1, 512, 256) and wav_t.shape == y_t.shape == x.shape
    assert np.abs(mel_t.numpy() - np.asarray(mel_j)).max() <= 5e-3
    assert np.abs(wav_t.numpy() - np.asarray(wav_j)).max() <= 1e-3
    assert np.abs(y_t.numpy() - np.asarray(y_j)).max() <= 1e-3
    assert np.abs(np.asarray(wav_j)).max() > 0.05          # the vocoder says something


def _band_limited(seconds=2.0, sr=16000):
    """A harmonic tone at 16 kHz: empty above 8 kHz once resampled to 48 kHz."""
    rng = np.random.default_rng(1)
    t = np.arange(int(seconds * sr)) / sr
    x = sum(np.sin(2 * np.pi * 196 * h * t + rng.uniform(0, 6.3)) / h
            for h in range(1, 30) if 196 * h < sr / 2)
    x = x + 0.01 * rng.standard_normal(t.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)[None]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_shipped_trio_on_band_limited_input(shipped):
    """A 16 kHz input to the node's path, one chunk, float32: what the
    node serves, where the resampled input leaves every bin above 8 kHz
    near zero.  Two effects make the outputs differ by more than the
    model stages do (test_shipped_trio_one_chunk_matches_jax):

    * the log-mel of those bins sits at its 1e-5 floor, where the DFT
      matmuls' sum-order differences move it by up to 5e-3; through the
      HiFi-GAN trio that leaves 1.6e-4 relative L2 on the output (the
      bound: 1e-3);
    * the istft head's phase features divide each input STFT bin by its
      magnitude plus 1e-6, so the empty bins carry the phase of rounding
      noise: the JAX output itself moves by ~1% relative L2 when the
      input is scaled by one ulp.  The port is held to at most twice that
      spread.

    Both keep the energy above 8.5 kHz (what the model adds) within 2%."""
    name, jcfg, jparams, tcfg, sd = shipped
    from egregora_tpu.core.audio import AudioBuffer as JBuffer
    from egregora_tpu_torch.core.audio import AudioBuffer
    jp = j_pipe.FlashSRPipeline(_f32(jcfg, jnp.float32), params=jparams)
    tp = t_pipe.FlashSRPipeline(_f32(tcfg, torch.float32), params=sd, device="cpu")
    x = _band_limited()
    ref = np.asarray(jp.process(JBuffer(jnp.asarray(x), 16000), mesh=None, wire="f32").samples)
    got = tp.process(AudioBuffer(x, 16000)).numpy()
    assert got.shape == ref.shape == (1, 96000) and np.isfinite(got).all()

    def high_energy(y):
        s = np.abs(np.fft.rfft(y[0, :94208].reshape(-1, 2048) * np.hanning(2048), axis=-1))
        return float((s[:, 363:854] ** 2).sum())          # 8.5 to 20 kHz

    assert abs(high_energy(got) / high_energy(ref) - 1.0) <= 0.02
    if name == "pretrained.npz":
        assert _rel(got, ref) <= 1e-3
        return
    x_ulp = x * np.float32(1 + 2.0 ** -23)
    ref_ulp = np.asarray(jp.process(JBuffer(jnp.asarray(x_ulp), 16000), mesh=None,
                                    wire="f32").samples)
    spread = _rel(ref_ulp, ref)
    assert 1e-3 < spread and _rel(got, ref) <= 2 * spread


def test_shipped_trio_quality_matches_jax(shipped):
    """The served quality of each shipped trio: one 5.12 s synthetic pair
    from the JAX package's ``distill.synth_pair_batch`` (what its
    ``evaluate`` scores), the low-rate side through both pipelines in
    float32, scored against the high-rate side with each package's
    ``lsd_sisdr_report``.  LSD (mean, p95) and SI-SDR within 0.05 dB: the
    HiFi-GAN trio's outputs agree to 3e-5 relative L2 and read within
    2e-4 dB; the istft trio's head is ill-conditioned on this
    band-limited input (outputs 3.5e-2 apart) and reads within 0.02 dB.
    Both beat the pass-through's LSD."""
    from egregora_tpu.eval.metrics import lsd_sisdr_report as j_report
    from egregora_tpu_torch.eval.metrics import lsd_sisdr_report as t_report
    name, jcfg, jparams, tcfg, sd = shipped
    lr, hr = (np.asarray(v)[0] for v in j_distill.synth_pair_batch(
        jax.random.PRNGKey(7), 1, j_pipe.CHUNK_SAMPLES))
    jp = j_pipe.FlashSRPipeline(_f32(jcfg, jnp.float32), params=jparams)
    tp = t_pipe.FlashSRPipeline(_f32(tcfg, torch.float32), params=sd, device="cpu")
    y_j = np.asarray(jax.jit(jp.chunk_forward)(jp.params, jnp.asarray(lr[None])))[0]
    y_t = tp.chunk_forward(torch.from_numpy(lr[None].copy()))[0]
    ref = j_report(jnp.asarray(hr), jnp.asarray(y_j))
    got = t_report(torch.from_numpy(hr.copy()), y_t)
    assert set(got) == set(ref) == {"lsd_mean_db", "lsd_p95_db", "si_sdr_db"}
    for key in ref:
        assert abs(float(got[key]) - float(ref[key])) <= 0.05, (key, got[key], ref[key])
    passthrough = t_report(torch.from_numpy(hr.copy()), torch.from_numpy(lr.copy()))
    assert float(got["lsd_mean_db"]) < float(passthrough["lsd_mean_db"])


def test_resolver_order(monkeypatch, tmp_path):
    """istft trio by default and for ``istft``; the HiFi-GAN trio for
    ``hifigan`` or when the istft file is missing; the seeded full
    config when neither is there; converted checkpoints in the weights
    directory come first, before anything else is loaded (empty files
    here, so reading them fails loud; ``tests/test_torch_checkpoint.py``
    resolves real ones)."""
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    calls = []
    real = t_distill.load_pretrained_with_cfg
    monkeypatch.setattr(t_distill, "load_pretrained_with_cfg",
                        lambda path: calls.append(path.name) or real(path))
    for variant, source, kind in (("", "distilled-istft", "istft"),
                                  ("istft", "distilled-istft", "istft"),
                                  ("HiFiGAN ", "distilled", "hifigan")):
        monkeypatch.setenv("EGREGORA_FLASHSR_VARIANT", variant)
        cfg, sd, src = t_distill.resolve_flashsr()
        assert (src, cfg.vocoder.kind) == (source, kind) and set(sd) == {
            "vae", "student_ldm", "sr_vocoder"}
    assert calls == ["pretrained_istft.npz"] * 2 + ["pretrained.npz"]
    monkeypatch.setenv("EGREGORA_FLASHSR_VARIANT", "istft")
    monkeypatch.setattr(t_distill, "PRETRAINED_ISTFT", tmp_path / "none.npz")
    assert t_distill.resolve_flashsr()[2] == "distilled"
    monkeypatch.setattr(t_distill, "PRETRAINED", tmp_path / "none.npz")
    cfg, sd, src = t_distill.resolve_flashsr()
    assert (src, sd) == ("random", None) and isinstance(cfg.unet, t_pipe.LDMUNetConfig)
    (tmp_path / "flashsr").mkdir()
    for f in t_distill.CONVERTED_FILES[:2]:
        (tmp_path / "flashsr" / f).touch()
    assert t_distill.resolve_flashsr()[2] == "random"       # two of three: not converted
    (tmp_path / "flashsr" / t_distill.CONVERTED_FILES[2]).touch()
    n = len(calls)
    with pytest.raises(EOFError):                              # the .pth trio is read
        t_distill.resolve_flashsr()
    for f in t_distill.CONVERTED_FILES:
        (tmp_path / "flashsr" / f).unlink()
    (tmp_path / "flashsr" / "flashsr_params.npz").touch()
    with pytest.raises(EOFError):                              # the cache is read
        t_distill.resolve_flashsr()
    assert len(calls) == n


def test_node_contract_matches_jax(monkeypatch):
    """Same key, display name, widgets, return types, function and
    category; the node's AUDIO dict round trip against the JAX node's,
    both running a narrow float32 compact pipeline with the same weights
    (samples within 1e-4, as ``tests/test_torch_pipeline.py``)."""
    from egregora_tpu.nodes import enhance_extras as j_ee
    from egregora_tpu.nodes import eval_pack as j_ep
    from egregora_tpu.nodes import null_suite as j_ns
    from egregora_tpu.nodes import spectral_enhance as j_se
    # the package's registry: the 19 keys of the five ported node modules
    keys = (set(j_node.NODE_CLASS_MAPPINGS) | set(j_ep.NODE_CLASS_MAPPINGS)
            | set(j_ns.NODE_CLASS_MAPPINGS) | set(j_se.NODE_CLASS_MAPPINGS)
            | set(j_ee.NODE_CLASS_MAPPINGS))
    assert len(keys) == 19 and set(NODE_CLASS_MAPPINGS) == keys
    assert NODE_DISPLAY_NAME_MAPPINGS == {**j_node.NODE_DISPLAY_NAME_MAPPINGS,
                                          **j_ep.NODE_DISPLAY_NAME_MAPPINGS,
                                          **j_ns.NODE_DISPLAY_NAME_MAPPINGS,
                                          **j_se.NODE_DISPLAY_NAME_MAPPINGS,
                                          **j_ee.NODE_DISPLAY_NAME_MAPPINGS}
    tn, jn = NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"], j_node.EgregoraAudioSuperResolution
    assert tn is t_node.EgregoraAudioSuperResolution
    assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY", "OUTPUT_NODE"):
        assert getattr(tn, attr) == getattr(jn, attr)
    assert tn.DEVICE == "cuda"

    vae = dict(base_channels=8, channel_mults=(1, 2, 4), latent_channels=16,
               num_res_blocks=1, groups=4, mid_attn=False, use_quant_conv=False)
    unet = dict(base_channels=16, channel_mults=(1, 2, 2), num_res_blocks=1,
                attn_levels=(), num_heads=4, time_dim=32, groups=4)
    # a HiFi-GAN head: on a band-limited input the istft head's output is
    # ill-conditioned (test_istft_trio_on_band_limited_input)
    voc = dict(upsample_initial=16, channel_floor=8)
    jcfg = j_pipe.FlashSRConfig(vae=j_vae.VAEConfig(dtype=jnp.float32, **vae),
                                unet=j_unet.UNetConfig(dtype=jnp.float32, **unet),
                                vocoder=j_voc.VocoderConfig(dtype=jnp.float32, **voc))
    tcfg = t_pipe.FlashSRConfig(vae=t_pipe.VAEConfig(dtype=torch.float32, **vae),
                                unet=t_unet.UNetConfig(dtype=torch.float32, **unet),
                                vocoder=t_voc.VocoderConfig(dtype=torch.float32, **voc))
    jp = j_pipe.FlashSRPipeline(jcfg, seed=3)
    params = jax.tree_util.tree_map(np.asarray, jp.params)
    from egregora_tpu_torch.utils.weights import params_from_jax
    tp = t_pipe.FlashSRPipeline(tcfg, params=params_from_jax(tcfg, params), device="cpu")
    monkeypatch.setattr(jn, "_PIPE", jp)
    monkeypatch.setattr(tn, "_PIPE", tp)
    monkeypatch.setattr(tn, "DEVICE", "cpu")           # the node serves tp, built for the CPU
    wave = torch.from_numpy(_x((1, 2, 32000), 7, scale=0.2))        # [B=1, C=2, T] 16 kHz
    audio = {"waveform": wave, "sample_rate": 16000}
    (ref,) = jn().run(audio, lowpass_input=False, output_sr="44100")
    (got,) = tn().run(audio, lowpass_input=False, output_sr="44100")
    assert set(got) == set(ref) and got["sample_rate"] == got["sr"] == 44100
    assert isinstance(got["waveform"], torch.Tensor) and got["waveform"].shape == (1, 2, 88200)
    assert np.abs(got["waveform"].numpy() - np.asarray(ref["waveform"])).max() <= 1e-4
    # the coercions of the JAX package's from_any, shape by shape
    for obj in (audio, {"samples": _x((3000, 2), 8), "sr": 22050}, (_x((2, 500), 9), 8000),
                _x((700,), 10), {"waveform": _x((2, 1, 400), 11), "sample_rate": 16000}):
        a, b = from_any(obj), j_node.to_buffer(obj, device=False)
        assert (a.sample_rate, a.meta) == (b.sample_rate, b.meta)
        assert np.array_equal(a.numpy(), np.asarray(b.samples))
