"""PyTorch port vs the JAX package: the eval layer, its nodes and the
node registry, all on the CPU.

The same numpy-seeded signals go through the JAX functions and nodes and
through the port's (``DEVICE = "cpu"``, so every K-weighting runs K4's
plain version).  Both sides compute in float32 with sums in other
orders; each tolerance is stated where it is used.  Loudness readings
take ``10 log10`` of mean squares, so 1e-3 LU is ~2e-4 relative in
power, far above float32 rounding and far below any real difference.
"""
import importlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egregora_tpu_torch as t_pkg
from egregora_tpu.eval import align as j_align
from egregora_tpu.eval import batch as j_batch
from egregora_tpu.eval import loudness as j_loud
from egregora_tpu.eval import metrics as j_met
from egregora_tpu.eval import nulltest as j_null
from egregora_tpu.nodes import eval_pack as j_ep
from egregora_tpu.nodes import null_suite as j_ns
from egregora_tpu.nodes import super_resolution as j_sr
from egregora_tpu.ops import resample as j_res
from egregora_tpu.ops import stft as j_stft
from egregora_tpu_torch.eval import align as t_align
from egregora_tpu_torch.eval import batch as t_batch
from egregora_tpu_torch.eval import loudness as t_loud
from egregora_tpu_torch.eval import metrics as t_met
from egregora_tpu_torch.eval import nulltest as t_null
from egregora_tpu_torch.nodes import eval_pack as t_ep
from egregora_tpu_torch.nodes import null_suite as t_ns
from egregora_tpu_torch.nodes.base import DeviceNode
from egregora_tpu_torch.ops import iir_lowpass as t_k4
from egregora_tpu_torch.ops import resample as t_res
from egregora_tpu_torch.ops import stft as t_stft

LU = 1e-3          # loudness, dB and LU readings
DELAY = 1e-3       # samples


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    assert DeviceNode.DEVICE == "cuda"           # the nodes' default: the card
    monkeypatch.setattr(DeviceNode, "DEVICE", "cpu")


def _sig(sr, seconds, seed, channels=2):
    """A seeded harmonic tone with noise, peak 0.5, channels a little apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(sr * seconds))) / sr
    x = sum(np.sin(2 * np.pi * 220 * h * t + rng.uniform(0, 6.3)) / h
            for h in range(1, 13) if 220 * h < sr / 2)
    x = x + 0.05 * rng.standard_normal(t.shape)
    chans = [x] + [0.8 * x + 0.05 * rng.standard_normal(t.shape) for _ in range(channels - 1)]
    out = np.stack(chans)
    return (0.5 * out / np.abs(out).max()).astype(np.float32)


def _delayed(x, delay, gain_db):
    """``x`` delayed by ``delay`` samples (band-limited, through the FFT of
    the zero-padded signal) and scaled by ``gain_db``."""
    n = x.shape[-1]
    m = 2 * n
    f = np.fft.rfftfreq(m)
    y = np.fft.irfft(np.fft.rfft(x, m) * np.exp(-2j * np.pi * f * delay), m)[..., :n]
    return (10 ** (gain_db / 20) * y).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def _audio(x, sr):
    return {"waveform": _t(x[None]), "sample_rate": sr}


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("n,n_fft,hop", [(5000, 512, 128), (3000, 2048, 512), (700, 1024, 256)])
def test_frame_stft_istft_match_jax(n, n_fft, hop):
    """Framing is a copy (equal); the magnitude STFT within 1e-5 of its
    largest bin; the WOLA inverse within 1e-5; the dB spectrogram within
    1e-3 dB on bins within 60 dB of the largest (below that, sum-order
    differences of 1e-7 of the largest bin move a bin by more).
    ``n < n_fft`` is one zero-padded frame."""
    x = _sig(16000, n / 16000, n)
    assert t_stft.num_frames(n, n_fft, hop) == j_stft.num_frames(n, n_fft, hop)
    np.testing.assert_array_equal(t_stft.frame(_t(x), n_fft, hop).numpy(),
                                  np.asarray(j_stft.frame(jnp.asarray(x), n_fft, hop)))
    ref = np.asarray(j_stft.stft_mag(jnp.asarray(x), n_fft, hop))
    got = t_stft.stft_mag(_t(x), n_fft, hop)
    assert got.shape == ref.shape
    _close(got, ref, 1e-5 * np.abs(ref).max())
    spec = j_stft.stft(jnp.asarray(x), n_fft, hop, window="hann_periodic")
    ref_i = np.asarray(j_stft.istft(spec, n_fft, hop, n))
    _close(t_stft.istft(torch.from_numpy(np.array(spec)), n_fft, hop, n), ref_i, 1e-5)
    db_ref = np.asarray(j_stft.spectrogram_db(jnp.asarray(x), n_fft, hop))
    db = t_stft.spectrogram_db(_t(x), n_fft, hop).numpy()
    keep = db_ref > db_ref.max() - 60
    np.testing.assert_allclose(db[keep], db_ref[keep], atol=1e-3)


@pytest.mark.parametrize("factor", [1, 4, 8])
def test_oversample_matches_jax(factor):
    """The true-peak oversampler (scipy's default design), within 1e-6 on
    a 0.5-peak signal; leading axes are rows."""
    x = _sig(16000, 0.4, factor, channels=2)
    ref = np.stack([np.asarray(j_res.oversample(jnp.asarray(r), factor)) for r in x])
    _close(t_res.oversample(_t(x), factor), ref, 1e-6)


# ---------------------------------------------------------------- eval


def test_metrics_match_jax():
    """SI-SDR and LSD within 1e-3 dB, correlation within 1e-5, the high
    band's share within 1e-3 dB; a batch of pairs reads as each pair."""
    sr = 16000
    a = _sig(sr, 1.5, 1)
    b = _delayed(a, 3.3, -2.0) + 0.01 * _sig(sr, 1.5, 2)
    for i in range(2):
        _close(t_met.si_sdr(_t(a[i]), _t(b[i])), j_met.si_sdr(jnp.asarray(a[i]), jnp.asarray(b[i])),
               LU)
        _close(t_met.corr_coef(_t(a[i]), _t(b[i])),
               j_met.corr_coef(jnp.asarray(a[i]), jnp.asarray(b[i])), 1e-5)
    rep = t_met.lsd_sisdr_report(_t(a), _t(b), n_fft=1024, hop=256)
    for i in range(2):
        ref = j_met.lsd_sisdr_report(jnp.asarray(a[i]), jnp.asarray(b[i]), n_fft=1024, hop=256)
        assert set(ref) == set(rep)
        for k in ref:
            _close(rep[k][i], ref[k], LU)
    m = t_met.lsd(t_stft.stft_mag(_t(a[0])), t_stft.stft_mag(_t(b[0])))
    mj = j_met.lsd(j_stft.stft_mag(jnp.asarray(a[0])), j_stft.stft_mag(jnp.asarray(b[0])))
    _close(torch.stack(m), np.stack([np.asarray(v) for v in mj]), LU)
    for lo in (1000.0, 6000.0):
        _close(t_met.band_energy_hi_db(_t(b), sr, lo),
               j_met.band_energy_hi_db(jnp.asarray(b), sr, lo), LU)


@pytest.mark.parametrize("sr,seconds", [(16000, 4.0), (48000, 1.2), (16000, 0.25)])
def test_loudness_matches_jax(sr, seconds):
    """Every meter reading within 1e-3 LU / dB, the momentary series
    element by element; 0.25 s is shorter than one 400 ms block (the
    reference averages only the real samples)."""
    x = _sig(sr, seconds, int(seconds * 10))
    xj = jnp.asarray(x)
    ref = j_loud.loudness_report(xj, sr)
    got = t_loud.loudness_report(_t(x), sr)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], LU)
    _close(t_loud.lufs_series(_t(x), sr, 0.4, 0.1), j_loud.lufs_series(xj, sr, 0.4, 0.1), LU)
    _close(t_loud.rms_db(_t(x)), j_loud.rms_db(xj), LU)
    _close(t_loud.true_peak_dbfs(_t(x), sr, 2), j_loud.true_peak_dbfs(xj, sr, 2), LU)
    no_tp = t_loud.loudness_report(_t(x), sr, compute_true_peak=False)
    assert set(no_tp) == set(ref) - {"true_peak_dbfs"}


def test_masked_percentile_matches_jax():
    """Linear interpolation over the masked values only, row by row."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    mask = rng.uniform(size=(3, 40)) > 0.4
    mask[2] = False
    mask[2, 7] = True                          # a single surviving value
    for q in (10.0, 95.0):
        got = t_loud._masked_percentile(_t(x), torch.from_numpy(mask), q)
        for i in range(3):
            _close(got[i], j_loud._masked_percentile(jnp.asarray(x[i]), jnp.asarray(mask[i]), q),
                   1e-6)


def test_align_matches_jax():
    """GCC-PHAT delays within 1e-3 samples (both centre conventions), the
    surface within 1e-5, the peak correlation within 1e-5, the fractional
    delay within 1e-5 (positive, negative, integer, zero); the planted
    37.25-sample delay read back within 0.15 by ``bias_fix`` (the
    parabola through a whitened peak leans toward the integer lag: 37.14
    on both sides)."""
    sr = 16000
    a = _sig(sr, 1.0, 7)[0]
    b = _delayed(a, 37.25, -3.0)
    for fix in (False, True):
        d, w = t_align.xcorr_delay_curve(_t(a), _t(b), 800, bias_fix=fix)
        dj, wj = j_align.xcorr_delay_curve(jnp.asarray(a), jnp.asarray(b), 800, bias_fix=fix)
        _close(d, dj, DELAY)
        _close(w, wj, 1e-5)
        _close(t_align.xcorr_delay(_t(a), _t(b), 800, bias_fix=fix), dj, DELAY)
    assert abs(float(d) - 37.25) <= 0.15
    _close(t_align.peak_correlation(_t(a), _t(b), d), j_align.peak_correlation(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(np.float32(d))), 1e-5)
    x = _sig(sr, 0.5, 8)
    for delay in (37.25, -12.6, 5.0, 0.0, 3e-7):
        for taps in (16, 64):
            _close(t_align.apply_frac_delay(_t(x), delay, taps=taps),
                   j_align.apply_frac_delay(jnp.asarray(x), jnp.float32(delay), taps=taps), 1e-5)
    assert t_align.pad_or_crop(_t(x), 100).shape == (2, 100)
    _close(t_align.pad_or_crop(_t(x), 9000), j_align.pad_or_crop(jnp.asarray(x), 9000), 0)


@pytest.mark.parametrize("mode,max_gain", [("LUFS-I", 12.0), ("RMS", 12.0), ("RMS", 1.0)])
def test_gain_match_matches_jax(mode, max_gain):
    """Levels and gain within 1e-3 dB (the 1 dB limit clamps), the
    matched signal within 1e-5."""
    sr = 16000
    a = _sig(sr, 2.0, 9)
    b = _delayed(a, 0.0, -4.5)
    got = t_null.gain_match(_t(a), _t(b), sr, mode=mode, max_gain_db=max_gain)
    ref = j_null.gain_match(jnp.asarray(a), jnp.asarray(b), sr, mode=mode, max_gain_db=max_gain)
    _close(got[0], ref[0], 1e-5)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, LU)
    if max_gain == 1.0:
        assert float(got[1]) == pytest.approx(1.0)


@pytest.mark.parametrize("lsq,invert", [(False, True), (True, True), (False, False)])
def test_null_test_matches_jax(lsq, invert):
    """Every metric of a pair whose null is well above rounding (B is A
    scaled and with 5% of other noise): dB and LU readings within 1e-3,
    correlation and the least-squares scale within 1e-4, the overshoot
    count equal; the null within 1e-5 (the JAX package's float32 dot
    product puts its least-squares scale ~1e-5 from the port's)."""
    sr = 16000
    a = _sig(sr, 2.0, 10)
    b = (0.9 * a + 0.05 * _sig(sr, 2.0, 11)).astype(np.float32)
    kw = dict(invert_b=invert, least_squares_scale=lsq, compute_hf_residual=True,
              n_fft=1024, hop=256, hf_band_hz=4000)
    null, m = t_null.null_test(_t(a), _t(b), sr, **kw)
    null_j, mj = j_null.null_test(jnp.asarray(a), jnp.asarray(b), sr, **kw)
    _close(null, null_j, 1e-5)
    assert set(m) == set(mj)
    for k in mj:
        tol = {"corr_coef": 1e-4, "scale_k": 1e-4, "overshoot_count": 0}.get(k, LU)
        _close(m[k], mj[k], tol)


def test_batch_matches_jax():
    """Both batch programs over P = 2 pairs, every reading within its
    per-pair tolerance; the K-weighting runs once a reading on [P, T]."""
    sr = 16000
    a = np.stack([_sig(sr, 1.5, 12)[0], _sig(sr, 1.5, 13)[0]])
    b = np.stack([_delayed(a[0], 21.5, -2.0), _delayed(a[1], -6.0, 1.0)])
    rep = t_batch.evalpack_report_batch(_t(a), _t(b), sr)
    ref = j_batch.evalpack_report_batch(jnp.asarray(a), jnp.asarray(b), sr)
    assert set(rep) == set(ref)
    for k in ref:
        assert rep[k].shape == (2,)
        _close(rep[k], ref[k], LU)
    null, m = t_batch.nullsuite_batch(_t(a), _t(b), sr, max_shift=800)
    null_j, mj = j_batch.nullsuite_batch(jnp.asarray(a), jnp.asarray(b), sr, max_shift=800)
    assert null.shape == (2, a.shape[1]) and set(m) == set(mj)
    _close(null, null_j, 1e-5)
    for k in mj:
        tol = {"corr_coef": 1e-4, "scale_k": 1e-4, "overshoot_count": 0,
               "delay_samples": DELAY}.get(k, LU)
        _close(m[k], mj[k], tol)


# ---------------------------------------------------------------- nodes

EVAL_KEYS = set(j_ep.NODE_CLASS_MAPPINGS)
NULL_KEYS = set(j_ns.NODE_CLASS_MAPPINGS)


@pytest.mark.parametrize("key", sorted(EVAL_KEYS | NULL_KEYS))
def test_node_contract_matches_jax(key):
    """Same key and display name, widgets, return types and names,
    function and category; every computing node runs on ``DEVICE``."""
    jmaps = {**j_ep.NODE_CLASS_MAPPINGS, **j_ns.NODE_CLASS_MAPPINGS}
    jnames = {**j_ep.NODE_DISPLAY_NAME_MAPPINGS, **j_ns.NODE_DISPLAY_NAME_MAPPINGS}
    tn, jn = t_pkg.NODE_CLASS_MAPPINGS[key], jmaps[key]
    assert t_pkg.NODE_DISPLAY_NAME_MAPPINGS[key] == jnames[key]
    assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
        assert getattr(tn, attr) == getattr(jn, attr)
    if key not in ("ABX Prepare", "ABX Judge", "Null Test (Full)"):
        assert issubclass(tn, DeviceNode) and "DEVICE" not in tn.__dict__


def test_registry_holds_every_ported_node():
    """The merged registry: the 19 keys of the five ported modules, all
    of the JAX package's, with its display names."""
    import egregora_tpu
    from egregora_tpu.nodes import enhance_extras as j_ee
    from egregora_tpu.nodes import spectral_enhance as j_se
    keys = (set(j_sr.NODE_CLASS_MAPPINGS) | EVAL_KEYS | NULL_KEYS
            | set(j_se.NODE_CLASS_MAPPINGS) | set(j_ee.NODE_CLASS_MAPPINGS))
    assert len(keys) == 19 and set(t_pkg.NODE_CLASS_MAPPINGS) == keys
    assert keys == set(egregora_tpu.NODE_CLASS_MAPPINGS)
    assert t_pkg.NODE_DISPLAY_NAME_MAPPINGS == {
        **j_sr.NODE_DISPLAY_NAME_MAPPINGS, **j_ep.NODE_DISPLAY_NAME_MAPPINGS,
        **j_ns.NODE_DISPLAY_NAME_MAPPINGS, **j_se.NODE_DISPLAY_NAME_MAPPINGS,
        **j_ee.NODE_DISPLAY_NAME_MAPPINGS} == egregora_tpu.NODE_DISPLAY_NAME_MAPPINGS
    from egregora_tpu_torch.nodes import NODE_CLASS_MAPPINGS
    assert NODE_CLASS_MAPPINGS is t_pkg.NODE_CLASS_MAPPINGS


def test_registry_degrades_per_module(monkeypatch, capsys):
    """A node module that fails to import leaves only its own keys out
    and says why."""
    real = importlib.import_module

    def failing(name, package=None):
        if name.endswith("eval_pack"):
            raise ImportError("planted failure")
        return real(name, package)

    monkeypatch.setattr(importlib, "import_module", failing)
    monkeypatch.setattr(t_pkg, "NODE_CLASS_MAPPINGS", {})
    monkeypatch.setattr(t_pkg, "NODE_DISPLAY_NAME_MAPPINGS", {})
    for name in t_pkg.NODE_MODULES:
        t_pkg._merge(name)
    keys = (set(j_sr.NODE_CLASS_MAPPINGS) | NULL_KEYS
            | {"EgregoraFatLlamaGPU", "EgregoraFatLlamaCPU", "Egregora_RNNoise_Denoise",
               "Egregora_WPE_Dereverb", "Egregora_DeepFilterNet_Denoise", "Egregora_DAC_Encode",
               "Egregora_DAC_Decode"})
    assert set(t_pkg.NODE_CLASS_MAPPINGS) == keys == set(t_pkg.NODE_DISPLAY_NAME_MAPPINGS)
    assert "'eval_pack' unavailable: planted failure" in capsys.readouterr().out


def _run(node_cls, *args, **kw):
    return getattr(node_cls(), node_cls.FUNCTION)(*args, **kw)


def _same_audio(got, ref, atol):
    assert got["sample_rate"] == ref["sample_rate"] and got["sr"] == ref["sr"]
    assert isinstance(got["waveform"], torch.Tensor)
    _close(got["waveform"], np.asarray(ref["waveform"]), atol)
    assert got["meta"] == ref["meta"]


def _same_dict(got, ref, atol=LU):
    assert set(got) == set(ref)
    for k in ref:
        assert type(got[k]) is type(ref[k]), k
        _close(np.float64(got[k]), np.float64(ref[k]), atol)


def test_eval_pack_nodes_match_jax():
    """Every eval-pack node's outputs on the same AUDIO dicts: audio within
    1e-5, readings within 1e-3 dB / LU; the gain match resamples an input
    at another rate (linear, as the reference); the meter also on a
    signal shorter than one 400 ms block; ABX exactly."""
    sr = 16000
    a = _sig(sr, 2.0, 20)
    b = _delayed(a, 2.5, -3.0) + 0.02 * _sig(sr, 2.0, 22)
    A, B = _audio(a, sr), _audio(b, sr)
    short = _audio(_sig(sr, 0.3, 21), sr)
    for audio in (A, short):
        for tp in (True, False):
            (got,) = _run(t_ep.Loudness_Meter_1770, audio, compute_true_peak=tp)
            (ref,) = _run(j_ep.Loudness_Meter_1770, audio, compute_true_peak=tp)
            _same_dict(got, ref)
    b22 = _audio(t_res.resample_linear(_t(b), sr, 22050).numpy(), 22050)
    for inp, mode in ((B, "LUFS-I"), (B, "RMS"), (b22, "LUFS-I")):
        got = _run(t_ep.Audio_Gain_Match_1770, A, inp, mode=mode, max_gain_db=6.0)
        ref = _run(j_ep.Audio_Gain_Match_1770, A, inp, mode=mode, max_gain_db=6.0)
        _same_audio(got[0], ref[0], 1e-5)
        _close(np.array(got[1:]), np.array(ref[1:]), LU)
    (got,) = _run(t_ep.Metrics_LSD_SISDR, A, B, n_fft=1024, hop=256)
    (ref,) = _run(j_ep.Metrics_LSD_SISDR, A, B, n_fft=1024, hop=256)
    _same_dict(got, ref)
    for target, mode in ((48000, "auto"), (22050, "linear"), (sr, "auto")):
        (got,) = _run(t_ep.Resample_Audio_HQ, A, target_sr=target, mode=mode)
        (ref,) = _run(j_ep.Resample_Audio_HQ, A, target_sr=target, mode=mode)
        _same_audio(got, ref, 1e-5)
    for seed in (0, 1, 2):
        got = _run(t_ep.ABX_Prepare, A, B, clip_seconds=1.0, random_seed=seed, start_seconds=0.5)
        ref = _run(j_ep.ABX_Prepare, A, B, clip_seconds=1.0, random_seed=seed, start_seconds=0.5)
        for g, r in zip(got[:3], ref[:3]):
            _same_audio(g, r, 0)
        assert got[3] == ref[3]
        for guess in ("A", "b"):
            assert _run(t_ep.ABX_Judge, got[3], guess) == _run(j_ep.ABX_Judge, ref[3], guess)


def test_null_suite_nodes_match_jax():
    """The align node (both methods, fractional or whole-sample, an input
    at another rate), the gain match, the null test and "Null Test
    (Full)": delays within 1e-3 samples, audio within 1e-5, readings
    within 1e-3 dB / LU, the overshoot count equal.  The fixed method
    reads the planted 37.25-sample delay back within 0.15 (see
    ``test_align_matches_jax``)."""
    sr = 16000
    a = _sig(sr, 2.0, 30)
    b = _delayed(a, 37.25, -3.0)
    A, B = _audio(a, sr), _audio(b, sr)
    B24 = _audio(t_res.resample_linear(_t(b), sr, 24000).numpy(), 24000)
    for method, frac, proc in (("gcc-phat", True, B), ("gcc-phat-fixed", True, B),
                               ("gcc-phat-fixed", False, B), ("gcc-phat", True, B24)):
        got = _run(t_ns.Audio_Align_XCorr, A, proc, max_shift_ms=50, align_method=method,
                   fractional=frac)
        ref = _run(j_ns.Audio_Align_XCorr, A, proc, max_shift_ms=50, align_method=method,
                   fractional=frac)
        _same_audio(got[0], ref[0], 1e-5)
        _close(np.array(got[1:4]), np.array(ref[1:4]), DELAY)
        assert got[4].shape == ref[4].shape and got[4].dtype == torch.float32
        if method == "gcc-phat-fixed" and proc is B:
            assert abs(got[1] - 37.25) <= 0.15 and got[3] > 0.99
    aligned = got[0]
    for mode in ("LUFS-I", "RMS"):
        got = _run(t_ns.Audio_Gain_Match, A, aligned, mode=mode)
        ref = _run(j_ns.Audio_Gain_Match, A, aligned, mode=mode)
        _same_audio(got[0], ref[0], 1e-5)
        _close(np.array(got[1:]), np.array(ref[1:]), LU)
    matched = got[0]
    kw = dict(least_squares_scale=True, compute_hf_residual=True, n_fft=1024, hop=256)
    got = _run(t_ns.Audio_Null_Test, A, matched, **kw)
    ref = _run(j_ns.Audio_Null_Test, A, matched, **kw)
    _same_audio(got[0], ref[0], 1e-5)
    _same_dict(got[1], ref[1])
    with pytest.raises(ValueError, match="Sample rate mismatch"):
        _run(t_ns.Audio_Null_Test, A, B24)
    off = dict(draw_waveforms=False, draw_spectrograms=False, draw_diffspec=False)
    got = _run(t_ns.Null_Test_Full, A, B, align_method="gcc-phat-fixed", **off)
    ref = _run(j_ns.Null_Test_Full, A, B, align_method="gcc-phat-fixed", **off)
    for g, r in zip(got[:2], ref[:2]):
        _same_audio(g, r, 1e-5)
    _close(np.array(got[2:4]), np.array(ref[2:4]), LU)
    _same_dict(got[4], ref[4])
    # the planted delay and gain are undone: the -12 dBFS signal nulls to
    # below -25 dBFS (the 0.1-sample lean of the delay estimate limits it)
    assert got[4]["null_rms_dbfs"] < -25
    for img in got[5:]:
        assert tuple(img.shape) == (1, 1, 1, 3) and not img.any()


def test_plotter_matches_jax():
    """Three figures of the same data through the same matplotlib: images
    of the JAX node's size within a mean |d| of 0.01; draws off give
    1x1 blanks; "Null Test (Full)" with draws on returns them."""
    sr = 16000
    a = _sig(sr, 1.0, 40)
    A, B = _audio(a, sr), _audio(_delayed(a, 2.5, -1.0), sr)
    N = _audio(a - _delayed(a, 2.5, -1.0), sr)
    got = _run(t_ns.Audio_Plotter, A, B, N, n_fft=1024, hop=256)
    ref = _run(j_ns.Audio_Plotter, A, B, N, n_fft=1024, hop=256)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape) and g.shape[-1] == 3 and g.shape[1] > 100
        assert float((g - r).abs().mean()) <= 0.01
    blank = _run(t_ns.Audio_Plotter, A, B, N, draw_waveforms=False, draw_spectrograms=False,
                 draw_diffspec=False)
    assert all(tuple(i.shape) == (1, 1, 1, 3) for i in blank)
    full = _run(t_ns.Null_Test_Full, A, B, n_fft=1024, hop=256)
    assert all(i.shape[1] > 100 for i in full[5:])


def test_nodes_without_matplotlib(monkeypatch):
    """As in the JAX package: the plotter raises when a draw flag is on and
    matplotlib is missing, and draws nothing with the flags off; the align
    node's debug image falls back to an 8x8 blank."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    sr = 16000
    a = _sig(sr, 0.5, 50)
    A, B = _audio(a, sr), _audio(_delayed(a, 4.0, 0.0), sr)
    for pkg in (t_ns, j_ns):
        with pytest.raises(ImportError):
            _run(pkg.Audio_Plotter, A, B, A)
        imgs = _run(pkg.Audio_Plotter, A, B, A, draw_waveforms=False, draw_spectrograms=False,
                    draw_diffspec=False)
        assert all(tuple(i.shape) == (1, 1, 1, 3) for i in imgs)
        dbg = _run(pkg.Audio_Align_XCorr, A, B, max_shift_ms=20)[4]
        assert tuple(dbg.shape) == (1, 8, 8, 3) and not dbg.any()


def test_eval_nodes_on_cpu_never_launch_k4():
    """With ``DEVICE = "cpu"`` the K-weighting takes the plain version:
    the kernel's count stays put through a meter and a LUFS gain match."""
    sr = 16000
    A = _audio(_sig(sr, 1.0, 60), sr)
    before = t_k4.launches
    _run(t_ep.Loudness_Meter_1770, A)
    _run(t_ep.Audio_Gain_Match_1770, A, A)
    assert t_k4.launches == before
