"""PyTorch port vs the JAX package: the DSP ops of the FlashSR path.

Same inputs (numpy, seeded) through ``egregora_tpu`` and
``egregora_tpu_torch`` on the CPU, in float32.  Tolerance 1e-5 absolute
for fir, resample, wola and stft: both sides run the same float32
matmuls on audio-level signals (|x| < 1), so only the summation order
differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.core import audio as j_audio
from egregora_tpu.models.flashsr import mel as j_mel
from egregora_tpu.ops import fir as j_fir
from egregora_tpu.ops import resample as j_rs
from egregora_tpu.ops import resize as j_resize
from egregora_tpu.ops import stft as j_stft
from egregora_tpu.ops import wola as j_wola
from egregora_tpu_torch.core import audio as t_audio
from egregora_tpu_torch.models.flashsr import mel as t_mel
from egregora_tpu_torch.nodes.base import buffer_to_comfy
from egregora_tpu_torch.ops import fir as t_fir
from egregora_tpu_torch.ops import resample as t_rs
from egregora_tpu_torch.ops import resize as t_resize
from egregora_tpu_torch.ops import stft as t_stft
from egregora_tpu_torch.ops import wola as t_wola

ATOL = 1e-5


def _sig(shape, seed=0, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("taps,t", [(255, 5000), (31, 1792), (64, 100)])
def test_fir_same(taps, t):
    x = _sig((2, t))
    h = np.random.default_rng(1).standard_normal(taps).astype(np.float32) / taps
    ref = np.asarray(j_fir.fir_same(jnp.asarray(x), h))
    got = _np(t_fir.fir_same(torch.from_numpy(x), h))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= ATOL


@pytest.mark.parametrize("src,dst,n", [(16000, 48000, 7001), (48000, 44100, 9000),
                                       (44100, 48000, 4410), (22050, 16000, 3000)])
def test_resample_poly(src, dst, n):
    x = _sig((2, n), scale=0.3)
    ref = np.asarray(j_rs.resample(jnp.asarray(x), src, dst))
    got = _np(t_rs.resample(torch.from_numpy(x), src, dst))
    assert got.shape == ref.shape == (2, t_rs.resampled_length(n, src, dst))
    assert t_rs.resampled_length(n, src, dst) == j_rs.resampled_length(n, src, dst)
    assert np.abs(got - ref).max() <= ATOL


def test_resample_linear_and_identity():
    x = _sig((1, 1000), scale=0.3)
    ref = np.asarray(j_rs.resample(jnp.asarray(x), 16000, 24000, mode="linear"))
    got = _np(t_rs.resample(torch.from_numpy(x), 16000, 24000, mode="linear"))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= ATOL
    assert np.array_equal(_np(t_rs.resample(torch.from_numpy(x), 48000, 48000)), x)


@pytest.mark.parametrize("total,pad_mult", [(1000, 1), (2500, 4), (300, 1)])
def test_chunk_batch_and_stitch(total, pad_mult):
    win, hop = 400, 330
    x = _sig((2, total))
    jc, js, jl = j_wola.chunk_batch(jnp.asarray(x), win, hop, pad_to_multiple=pad_mult)
    tc, ts, tl = t_wola.chunk_batch(torch.from_numpy(x), win, hop, pad_to_multiple=pad_mult)
    assert np.array_equal(js, ts) and np.array_equal(jl, tl)
    assert np.array_equal(np.asarray(jc), _np(tc))
    assert t_wola.num_chunks(total, win, hop) == j_wola.num_chunks(total, win, hop)
    preds = _sig(tuple(jc.shape), seed=2, scale=0.5)
    ref = np.asarray(j_wola.wola_stitch(jnp.asarray(preds), js, jl, total, win))
    got = _np(t_wola.wola_stitch(torch.from_numpy(preds), ts, tl, total, win))
    assert np.abs(got - ref).max() <= ATOL


def test_wola_scatter_path():
    """Irregular starts take the scatter-add path on both sides."""
    win, total = 64, 300
    starts = np.array([0, 50, 170, 260], np.int32)
    lengths = np.array([64, 64, 64, 40], np.int32)
    preds = _sig((4, 2, win), seed=3, scale=0.5)
    ref = np.asarray(j_wola.wola_stitch(jnp.asarray(preds), starts, lengths, total, win))
    got = _np(t_wola.wola_stitch(torch.from_numpy(preds), starts, lengths, total, win))
    assert np.abs(got - ref).max() <= ATOL


def test_wola_accumulate_dense_streaming():
    """Folding batches one by one equals the one-shot stitch."""
    win, hop, total = 400, 330, 1700
    x = torch.from_numpy(_sig((1, total)))
    chunks, starts, lengths = t_wola.chunk_batch(x, win, hop, pad_to_multiple=2)
    k = chunks.shape[0]
    acc = torch.zeros(1, (k + 1) * hop)
    wsum = torch.zeros((k + 1) * hop)
    for s0 in range(0, k, 2):
        t_wola.wola_accumulate_dense(chunks[s0:s0 + 2], lengths[s0:s0 + 2], hop,
                                     acc, wsum, s0 * hop)
    got = _np(t_wola.wola_finalize(acc[:, :total], wsum[:total]))
    ref = np.asarray(j_wola.wola_stitch(jnp.asarray(_np(chunks)), starts, lengths, total, win))
    assert np.abs(got - ref).max() <= ATOL


@pytest.mark.parametrize("n_fft,hop,t", [(2048, 512, 30000), (2048, 480, 24000),
                                         (64, 16, 50), (64, 16, 1000)])
def test_stft_conv_istft_dense(n_fft, hop, t):
    x = _sig((2, t))
    assert np.array_equal(np.asarray(j_stft.frame_strided(jnp.asarray(x), n_fft, hop)),
                          _np(t_stft.frame_strided(torch.from_numpy(x), n_fft, hop)))
    jr, ji = j_stft.stft_conv(jnp.asarray(x), n_fft, hop)
    tr, ti = t_stft.stft_conv(torch.from_numpy(x), n_fft, hop)
    assert np.abs(_np(tr) - np.asarray(jr)).max() <= ATOL
    assert np.abs(_np(ti) - np.asarray(ji)).max() <= ATOL
    if n_fft % hop == 0:
        ref = np.asarray(j_stft.istft_dense(jr, ji, n_fft, hop))
        got = _np(t_stft.istft_dense(tr, ti, n_fft, hop))
        assert np.abs(got - ref).max() <= ATOL
    np.testing.assert_array_equal(t_stft.hann_periodic(n_fft), j_stft.hann_periodic(n_fft))


def test_upsample2x_nearest():
    h = _sig((2, 5, 3, 4), scale=1.0)                      # NHWC
    ref = np.asarray(j_resize.upsample2x_nearest(jnp.asarray(h)))
    got = _np(t_resize.upsample2x_nearest(torch.from_numpy(h).permute(0, 3, 1, 2)))
    assert np.array_equal(got.transpose(0, 2, 3, 1), ref)


def test_fixed_crossover_merge():
    """The non-adaptive merge: 255-tap windowed-sinc lowpass (fir_same)."""
    from egregora_tpu.models.flashsr import pipeline as j_pipe
    from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
    lo, hi = _sig((2, 6000), seed=6, scale=0.3), _sig((2, 6000), seed=7, scale=0.3)
    ref = np.asarray(j_pipe._crossover_merge(jnp.asarray(lo), jnp.asarray(hi), 48000, 11000.0))
    got = _np(t_pipe._crossover_merge(torch.from_numpy(lo), torch.from_numpy(hi), 48000, 11000.0))
    assert np.abs(got - ref).max() <= ATOL


def test_mel_front_end():
    """log_mel to 1e-4 (log of values down to 1e-5 amplifies the 1e-7
    relative matmul differences near the clip floor), constant tables
    exactly, envelope projection to 1e-4."""
    np.testing.assert_array_equal(t_mel.mel_filterbank(), j_mel.mel_filterbank())
    np.testing.assert_array_equal(t_mel.mel_band_peaks(), j_mel.mel_band_peaks())
    x = _sig((2, 24000), scale=0.3)
    ref = np.asarray(j_mel.log_mel(jnp.asarray(x)))
    got = _np(t_mel.log_mel(torch.from_numpy(x)))
    assert got.shape == ref.shape == (2, 24000 // 480 + 1, 256)
    assert np.abs(got - ref).max() <= 1e-4
    tgt = ref[:, :48] + _sig(ref[:, :48].shape, seed=4, scale=1.0)
    for replace in (False, True):
        r = np.asarray(j_mel.mel_envelope_match(jnp.asarray(x), jnp.asarray(tgt),
                                                replace=replace))
        g = _np(t_mel.mel_envelope_match(torch.from_numpy(x), torch.from_numpy(tgt),
                                         replace=replace))
        assert np.abs(g - r).max() <= 1e-4


def test_audio_buffer_and_pcm16():
    rng = np.random.default_rng(5)
    for shape in [(100,), (100, 2), (2, 100), (1, 2, 100), (3, 1, 50)]:
        a = rng.standard_normal(shape).astype(np.float32) * 2
        np.testing.assert_array_equal(t_audio.normalize_cn(a), j_audio.normalize_cn(a))
        np.testing.assert_array_equal(t_audio.to_cs(a), j_audio.to_cs(a))
        np.testing.assert_array_equal(t_audio.pcm16_encode(a), j_audio.pcm16_encode(a))
    q = t_audio.pcm16_encode(rng.uniform(-1, 1, 64).astype(np.float32))
    np.testing.assert_array_equal(t_audio.pcm16_decode(q), j_audio.pcm16_decode(q))
    buf = t_audio.AudioBuffer(torch.from_numpy(q[None]), 48000,
                              {"wire_scale": torch.tensor(2.0)})
    np.testing.assert_allclose(buf.numpy(), 2.0 * j_audio.pcm16_decode(q[None]))
    assert buf.channels == 1 and buf.num_samples == 64
    d = buffer_to_comfy(t_audio.AudioBuffer(t_audio.normalize_cn(a), 16000))
    assert d["waveform"].shape == (1,) + j_audio.normalize_cn(a).shape


def _wire_input(case):
    rng = np.random.default_rng(21)
    if case == "empty":
        return np.zeros((2, 0), np.float32)
    if case.startswith("stereo"):
        peak = {"stereo_peak_0.6": 0.6, "stereo_peak_3.3": 3.3}[case]
        x = rng.uniform(-1, 1, (2, 30000)) * peak
        x[1, 7] = -peak                         # the peak on a negative sample
        return x.astype(np.float32)
    if case == "halfway":
        # samples that land exactly on k + 1/2 steps, k even and odd, either sign
        k = np.arange(-32767, 32767)
        x = ((k + 0.5) / 32767.0).astype(np.float32)
        x = x[x * np.float32(32767.0) == k + 0.5]
        assert len(x) > 1000 and len(np.unique(np.floor(x * 32767.0) % 2)) == 2
        return np.stack([x, -x[::-1]])
    # past full scale: quiet samples, spikes at +-2.5, and tiny negatives that round to -0
    x = rng.uniform(-0.3, 0.3, (1, 20000))
    x[0, ::997], x[0, 500::997] = 2.5, -2.5
    x[0, 1::97] = -1e-6
    return x.astype(np.float32)


@pytest.mark.parametrize("case", ["stereo_peak_0.6", "stereo_peak_3.3", "halfway",
                                  "past_full_scale", "empty"])
def test_pcm16_roundtrip_on_device_equals_host_wire(case):
    """``pcm16_roundtrip_`` (the wire's input quantisation as tensor ops on
    the pipeline's device) bit for bit against the host path it replaces:
    the numpy peak scan, ``pcm16_encode`` and the dequantising product;
    in place, so the input's one float32 copy is the only one."""
    xs = _wire_input(case)
    in_scale = max(1.0, float(np.max(np.abs(xs))) if xs.size else 1.0)
    q = t_audio.pcm16_encode(xs / np.float32(in_scale))
    want = (torch.from_numpy(q).float() * np.float32(in_scale / 32767.0)).numpy()
    x = torch.from_numpy(xs.copy())
    got = t_audio.pcm16_roundtrip_(x)
    assert got.data_ptr() == x.data_ptr() and got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _inline_output_chain(out):
    """The pcm16 wire's output side as ``FlashSRPipeline.process`` wrote it
    inline before ``core.audio.wire_out``, frozen: (int16, scale)."""
    scale = torch.clamp(out.abs().max(), min=1.0)
    return torch.round(torch.clamp(out / scale, -1.0, 1.0) * 32767.0).to(torch.int16), scale


@pytest.mark.parametrize("case", ["stereo_peak_0.6", "stereo_peak_3.3", "halfway",
                                  "past_full_scale", "empty"])
def test_wire_out_equals_inline_output_chain(case):
    """``wire_out`` (the output quantised in place on the shared quantiser,
    then cast) bit for bit against the frozen inline chain: the int16
    samples, ``meta["wire_scale"]`` as a 0-d float32 tensor, the meta
    kept; an empty output raises in both, as before (``process`` never
    makes one: it refuses an empty input first)."""
    xs = _wire_input(case)
    if not xs.size:
        with pytest.raises(RuntimeError):
            _inline_output_chain(torch.from_numpy(xs.copy()))
        with pytest.raises(RuntimeError):
            t_audio.wire_out(torch.from_numpy(xs.copy()), 48000, {}, True)
        return
    want, scale = _inline_output_chain(torch.from_numpy(xs.copy()))
    meta = {"batch": 1}
    buf = t_audio.wire_out(torch.from_numpy(xs.copy()), 48000, meta, True)
    assert buf.samples.dtype == torch.int16 and buf.sample_rate == 48000
    assert torch.equal(buf.samples, want)
    s = buf.meta["wire_scale"]
    assert s.dtype == torch.float32 and s.shape == () and torch.equal(s, scale)
    assert buf.meta["wire"] == "pcm16" and buf.meta["batch"] == 1 and meta == {"batch": 1}
    off = t_audio.wire_out(torch.from_numpy(xs.copy()), 48000, meta, False)
    assert off.meta == meta and np.array_equal(off.numpy(), xs)


@pytest.mark.parametrize("case", ["stereo_peak_0.6", "stereo_peak_3.3"])
def test_upscaler_audio_dict_from_wire_buffer_unchanged(case):
    """The upscaler's AUDIO dict from a pcm16 wire buffer
    (``buffer_to_comfy(wire_out(...))``) against a frozen copy of the
    conversion before the wire moved into ``core.audio``: the same keys,
    dtypes, ``waveform`` (a batch of 2 unfolded) and ``samples`` bit for
    bit, ``meta`` with ``wire`` and ``wire_scale``."""
    xs = _wire_input(case)
    q, scale = _inline_output_chain(torch.from_numpy(xs.copy()))
    dec = q.numpy().astype(np.float32) / 32767.0
    if float(scale) != 1.0:
        dec = dec * np.float32(float(scale))
    arr = np.ascontiguousarray(dec).reshape(2, 1, dec.shape[1])
    want = {"sr": 48000, "sample_rate": 48000, "samples": dec,
            "waveform": torch.from_numpy(arr.copy()),
            "meta": {"batch": 2, "wire": "pcm16", "wire_scale": scale}}
    got = buffer_to_comfy(t_audio.wire_out(torch.from_numpy(xs.copy()), 48000,
                                           {"batch": 2}, True))
    assert list(got) == list(want)
    assert got["sr"] == got["sample_rate"] == 48000
    assert got["samples"].dtype == np.float32 and got["waveform"].dtype == torch.float32
    np.testing.assert_array_equal(got["samples"].view(np.int32), want["samples"].view(np.int32))
    assert got["waveform"].shape == (2, 1, xs.shape[1])
    assert torch.equal(got["waveform"].view(torch.int32), want["waveform"].view(torch.int32))
    assert set(got["meta"]) == {"batch", "wire", "wire_scale"}
    assert got["meta"]["wire"] == "pcm16" and got["meta"]["batch"] == 2
    assert torch.equal(got["meta"]["wire_scale"], scale)
