"""PyTorch port vs the JAX package: the RNNoise denoiser, ``ops.mix`` and
the RNNoise node.

Same inputs (numpy, seeded) and the shipped weights
(``egregora_tpu/models/rnnoise/pretrained.npz``) through ``egregora_tpu``
and ``egregora_tpu_torch`` on the CPU, in float32.  Tolerances:

* ``_gru_step`` and the seeded ``init_params``: max |d| <= 1e-6;
* the analysis from the same band energies (log-band follower, BFCC):
  max |d| <= 1e-5; band energies from the same wave: relative 1e-3 of
  the largest (the two packages' DC-blocking biquads are different
  blocked scans, ~1e-4 relative apart at PCM scale);
* silence flags and pitch periods: equal on every frame where they are
  used, with two divergences of the reference pinned by tests.  (1) On a
  frame whose lag windows hold no energy (frame 0's zero history; the
  DC blocker's transient after an abrupt stop) the normalised
  correlation is FFT roundoff over sqrt(1e-4), and the period follows it
  (``test_period_divergence_is_pinned``); the test signals start with a
  quiet lead-in and fade in and out of their gaps.  (2) On the quiet
  frames after a loud passage each package's float32 DC blocker (blocked
  scans of two first-order sections, in other orders) is off by up to 8x
  in band energy, so a frame near the 0.04 silence threshold can flip;
  one flipped flag before a gap changes the GRU state carried across it
  and so the rest of the output (``test_silence_flip_is_pinned``).
  Engine outputs are compared on the frames before the first flag that
  differs (all of them where none does);
* ``denoise_channel_full`` (2.5 s, ``segments`` 1 and 4): wave max |d|
  <= 5e-4 (|x| ~ 0.5), VAD <= 5e-3, band gains <= 2e-2 (the GRU chain
  carries the DC blocker's 1e-4 relative through 250 steps);
* ``ops.mix``: max |d| <= 1e-6 (``rms_vad_probs`` 1e-5);
* the node (inputs with a lead-in and no gap): relative L2 <= 1e-3 over
  the output, max |d| <= 2e-3 on every frame but those whose pitch period
  differs between the packages (and the next, which shares its
  overlap-add), at most 1 in 100: a near-tie in the period choice
  (frame 191 of the 48 kHz downmix input) changes that frame's comb
  filter by up to 2.7e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models.rnnoise import model as j_rn
from egregora_tpu.models.rnnoise import train as j_train
from egregora_tpu.nodes import enhance_extras as j_node
from egregora_tpu.ops import mix as j_mix
from egregora_tpu.ops.iir import biquad as j_biquad
from egregora_tpu.ops.stft import frame_strided as j_frames
from egregora_tpu_torch.models.rnnoise import model as t_rn
from egregora_tpu_torch.models.rnnoise import train as t_train
from egregora_tpu_torch.nodes import enhance_extras as t_node
from egregora_tpu_torch.ops import mix as t_mix

SR = 48000
SECONDS = 2.5
WAVE, VAD, GAINS = 5e-4, 5e-3, 2e-2
NODE = 2e-3


@pytest.fixture(scope="module")
def params():
    pj, pt = j_train.load_pretrained(), t_train.load_pretrained()
    assert pj is not None and pt is not None
    return pj, pt


def speech_like(seconds, sr, seed, gaps=((0.9, 1.4),), lead=0.05, fade=0.05, abrupt=False):
    """A gliding harmonic tone with a syllable envelope plus noise, a
    quiet (1e-6) lead-in and gaps; raised-cosine fades unless ``abrupt``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    ph = 2 * np.pi * np.cumsum(140 + 40 * np.sin(2 * np.pi * 0.7 * t)) / sr
    x = sum((0.25 / k) * np.sin(k * ph) for k in range(1, 8))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)) + 0.03 * rng.standard_normal(n)
    env = np.ones(n)
    for a, b in list(gaps) + [(-1.0, lead)]:
        inside = (t >= a) & (t < b)
        if abrupt:
            env[inside] = 0
        else:
            d = np.clip(np.minimum(np.abs(t - a), np.abs(t - b)) / fade, 0, 1)
            env = np.where(inside, 0, np.minimum(env, 0.5 - 0.5 * np.cos(np.pi * d)))
    return (x * env + 1e-6 * rng.standard_normal(n)).astype(np.float32)


def jax_periods(x):
    """The JAX package's per-frame periods and silence flags (its engine
    does not return them): its front end, candidates and doubling scan."""
    n = x.shape[0] // j_rn.FRAME
    xs = j_biquad(jnp.asarray(x) * j_rn.PCM_SCALE, b=t_rn.HP_B, a=t_rn.HP_A)
    pb = j_frames(jnp.concatenate([jnp.zeros(j_rn.PITCH_BUF - j_rn.FRAME), xs]),
                  j_rn.PITCH_BUF, j_rn.FRAME)[:n]
    cand, gc, g0 = j_rn._pitch_candidates(pb)
    sil = np.asarray(j_rn.band_energies(jnp.asarray(x))).sum(-1) < j_rn.SILENCE_E

    def step(carry, inp):
        c, g, g0_, s = inp
        per, gain = j_rn._pitch_select(c, g, g0_, *carry)
        return tuple(jnp.where(s, o, v) for v, o in zip((per, gain), carry)), per

    _, per = jax.lax.scan(step, (jnp.float32(300.0), jnp.float32(0.0)),
                          (cand, gc, g0, jnp.asarray(sil)))
    return np.asarray(per), sil


def torch_periods(x):
    _, ex, pb = t_rn._front_end(torch.from_numpy(x)[None])
    sil = ex.sum(-1) < t_rn.SILENCE_E
    per, _ = t_rn._pitch_loop(t_rn._pitch_candidates(pb), sil)
    return per[0].numpy(), sil[0].numpy()


# ---------------------------------------------------------------- weights

def test_shipped_weights_through_gru_step(params):
    pj, pt = params
    assert set(pj) == set(pt) == {"input_dense", "vad_gru", "noise_gru", "denoise_gru",
                                  "denoise_output", "vad_output"}
    rng = np.random.default_rng(0)
    for name in ("vad_gru", "noise_gru", "denoise_gru"):
        k = np.asarray(pj[name]["kernel"])
        units = k.shape[1] // 3
        x = rng.standard_normal((5, k.shape[0])).astype(np.float32)
        h = np.tanh(rng.standard_normal((5, units))).astype(np.float32)
        ref = np.asarray(j_rn._gru_step(pj[name], jnp.asarray(h), jnp.asarray(x)))
        got = t_rn._gru_step(t_rn.params_on(pt[name], "cpu"), torch.from_numpy(h),
                             torch.from_numpy(x)).numpy()
        assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_matches_jax(seed):
    ref, got = j_rn.init_params(seed), t_rn.init_params(seed)
    assert set(ref) == set(got)
    for layer in ref:
        for leaf in ref[layer]:
            r, g = np.asarray(ref[layer][leaf]), got[layer][leaf]
            assert g.shape == r.shape and g.dtype == np.float32
            assert np.abs(g - r).max() <= 1e-6, (layer, leaf)


def test_convert_rnnoise_tables():
    rng = np.random.default_rng(1)
    tables = {name: rng.standard_normal(shape[::-1] if len(shape) == 2 and i % 2 else shape)
              .astype(np.float32) for i, (name, (_, shape)) in enumerate(j_rn._TABLE_LAYOUT.items())}
    ref, got = j_rn.convert_rnnoise_tables(tables), t_rn.convert_rnnoise_tables(tables)
    for layer in ref:
        for leaf in ref[layer]:
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(ref[layer][leaf]))
    with pytest.raises(ValueError, match="missing fields"):
        t_rn.convert_rnnoise_tables({k: v for k, v in tables.items() if k != "vad_gru_bias"})
    with pytest.raises(ValueError, match="want"):
        t_rn.convert_rnnoise_tables({**tables, "vad_gru_bias": np.zeros(71)})


# ---------------------------------------------------------------- analysis

def test_band_energies_and_bfcc():
    x = speech_like(SECONDS, SR, seed=1)
    ex_j = np.asarray(j_rn.band_energies(jnp.asarray(x)))
    ex_t = t_rn.band_energies(torch.from_numpy(x)).numpy()
    assert ex_t.shape == ex_j.shape == (250, 22)
    assert np.abs(ex_t - ex_j).max() <= 1e-3 * ex_j.max()
    ly_j = np.asarray(jax.vmap(j_rn._log_band_follow)(jnp.asarray(ex_j)))
    ly_t = t_rn._log_band_follow(torch.from_numpy(ex_j)).numpy()
    assert np.abs(ly_t - ly_j).max() <= 1e-5
    dct = j_rn._dct_matrix()
    np.testing.assert_array_equal(t_rn._dct_matrix(), dct)
    np.testing.assert_array_equal(t_rn._band_matrix_energy(), j_rn._band_matrix_energy())
    np.testing.assert_array_equal(t_rn._band_matrix_interp(), j_rn._band_matrix_interp())
    np.testing.assert_array_equal(t_rn._vorbis_window(), j_rn._vorbis_window())
    assert np.abs(ly_t @ dct - np.asarray(jnp.asarray(ly_j) @ jnp.asarray(dct))).max() <= 1e-5


def band_energy_f64(x):
    """Per-frame total band energy through a float64 DC blocker and FFT."""
    from scipy.signal import lfilter
    xs = lfilter([1.0, *t_rn.HP_B], [1.0, *t_rn.HP_A], x.astype(np.float64) * t_rn.PCM_SCALE)
    n = xs.shape[0] // t_rn.FRAME
    fr = np.lib.stride_tricks.sliding_window_view(np.pad(xs, (t_rn.FRAME, 0)),
                                                  t_rn.WINDOW)[:: t_rn.FRAME][:n]
    sp = np.fft.rfft(fr * t_rn._vorbis_window(), axis=-1) / t_rn.WINDOW
    return (np.abs(sp) ** 2 @ t_rn._band_matrix_energy()).sum(-1)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pitch_periods_equal(seed):
    """Silence flags equal wherever the float64 band energy is not within
    a factor of 10 of the threshold (divergence (2) of the module
    docstring: seeds 1 and 2 flip frames 93 and 92).  Periods equal on
    every frame non-silent in both."""
    x = speech_like(SECONDS, SR, seed=seed)
    per_j, sil_j = jax_periods(x)
    per_t, sil_t = torch_periods(x)
    e64 = band_energy_f64(x)
    near = (e64 > 0.1 * t_rn.SILENCE_E) & (e64 < 10 * t_rn.SILENCE_E)
    np.testing.assert_array_equal(sil_t[~near], sil_j[~near])
    assert sil_j[:5].all() and sil_j.sum() >= 40 and not sil_j.all()
    voiced = ~sil_j & ~sil_t
    np.testing.assert_array_equal(per_t[voiced], per_j[voiced])


def test_pitch_candidates_from_the_same_buffers():
    """From identical pitch windows the candidate tables are equal on
    every non-silent frame but near-ties of the best lag: seed 4's frame
    92 (the fade into its gap, a smooth decay that correlates ~1 at every
    lag) reads T0 = 30 in the JAX package and 39 in the port, at
    correlations 0.99617 and 0.99542."""
    x = speech_like(SECONDS, SR, seed=4)
    _, ex, pb = t_rn._front_end(torch.from_numpy(x)[None])
    pb, voiced = pb[0].numpy(), (ex[0].sum(-1) >= t_rn.SILENCE_E).numpy()
    ref = [np.asarray(a)[voiced] for a in j_rn._pitch_candidates(jnp.asarray(pb))]
    got = [a.numpy()[voiced] for a in t_rn._pitch_candidates(torch.from_numpy(pb))]
    tie = (got[0] != ref[0]).any(-1)
    assert np.nonzero(voiced)[0][tie].tolist() == [92]
    np.testing.assert_array_equal(got[0][~tie], ref[0][~tie])
    assert np.abs(got[1][~tie] - ref[1][~tie]).max() <= 1e-3    # correlations
    assert np.abs(got[2] - ref[2]).max() <= 1e-3
    # the single-frame composition of the two halves
    f = int(np.nonzero(voiced)[0][40])
    pj, gj = j_rn._pitch_search(jnp.asarray(pb[f]), jnp.float32(300.0), jnp.float32(0.5))
    pt, gt = t_rn._pitch_search(torch.from_numpy(pb[f]), torch.tensor(300.0), torch.tensor(0.5))
    assert float(pt) == float(pj) and abs(float(gt) - float(gj)) <= 1e-3


def test_period_divergence_is_pinned():
    """Where a frame's lag windows hold no energy (frame 0's zero
    history; the DC blocker's transient after an abrupt stop), the
    normalised correlation there is FFT roundoff over sqrt(1e-4) and the
    period follows it.  Signal in frame 0 and an abrupt gap: the two
    packages may pick other periods on frame 0 and on the transient's
    frames (within 12 frames of the stop at frame 90), nowhere else."""
    x = speech_like(SECONDS, SR, seed=0, gaps=((0.9, 1.4),), lead=0.0, abrupt=True)
    per_j, sil_j = jax_periods(x)
    per_t, sil_t = torch_periods(x)
    flips = set(np.nonzero((per_t != per_j) & ~sil_j & ~sil_t)[0].tolist())
    assert flips <= {0} | set(range(90, 102)), sorted(flips)


# ---------------------------------------------------------------- engine

def _first_flip(x):
    """Frames before the first silence flag that differs between the
    packages (all frames where none does)."""
    _, sil_j = jax_periods(x)
    _, sil_t = torch_periods(x)
    flips = np.nonzero(sil_j != sil_t)[0]
    return int(flips[0]) if flips.size else sil_j.shape[0]


@pytest.mark.parametrize("seed,gaps", [(1, ((0.9, 1.4),)), (3, ((0.9, 1.4),)), (5, ())])
@pytest.mark.parametrize("segments", [1, 4])
def test_denoise_channel_full_matches_jax(params, segments, seed, gaps):
    pj, pt = params
    x = speech_like(SECONDS, SR, seed=seed, gaps=gaps)
    ref = [np.asarray(a) for a in j_rn.denoise_channel_full(pj, jnp.asarray(x),
                                                            segments=segments)]
    got = [a.numpy() for a in t_rn.denoise_channel_full(pt, torch.from_numpy(x),
                                                        segments=segments)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float32
    f = _first_flip(x)
    assert f >= (90 if gaps else 250)
    out = np.abs(got[0] - ref[0])[: f * t_rn.FRAME].max()
    vad, gains = (np.abs(g - r)[:f].max() for g, r in zip(got[1:3], ref[1:3]))
    assert out <= WAVE and vad <= VAD and gains <= GAINS
    assert np.abs(got[3] - ref[3]).max() <= 1e-3 * ref[3].max()
    # the batched form: both channels of one call equal one call each
    xx = np.stack([x, speech_like(SECONDS, SR, seed=2)])
    wet, vads = t_rn.denoise(pt, torch.from_numpy(xx), segments=segments)
    one = t_rn.denoise_channel(pt, torch.from_numpy(xx[1]), segments=segments)
    assert np.abs(wet[0].numpy() - got[0]).max() <= 1e-5
    assert np.abs(wet[1].numpy() - one[0].numpy()).max() <= 1e-5
    assert np.abs(vads[1].numpy() - one[1].numpy()).max() <= 1e-5


def test_silence_flip_is_pinned(params):
    """Divergence (2): seed 2's fade into its gap.  Frame 92's float64
    band energy is 0.168 (not silent); the JAX package's float32 DC
    blocker reads 0.022 (silent), the port's 0.058 (not silent).  The
    outputs agree up to it and differ after the gap, where the GRU state
    carried across it differs by that one step."""
    pj, pt = params
    x = speech_like(SECONDS, SR, seed=2)
    assert _first_flip(x) == 92
    e64 = band_energy_f64(x)
    ex_j = np.asarray(j_rn.band_energies(jnp.asarray(x))).sum(-1)
    ex_t = t_rn.band_energies(torch.from_numpy(x)).numpy().sum(-1)
    assert ex_j[92] < t_rn.SILENCE_E < ex_t[92] < e64[92]
    ref = np.asarray(j_rn.denoise_channel_full(pj, jnp.asarray(x))[0])
    got = t_rn.denoise_channel_full(pt, torch.from_numpy(x))[0].numpy()
    head, tail = slice(0, 92 * t_rn.FRAME), slice(141 * t_rn.FRAME, None)
    assert np.abs(got[head] - ref[head]).max() <= WAVE
    assert np.linalg.norm(got[tail] - ref[tail]) > 0.05 * np.linalg.norm(ref[tail])


def test_segments_match_sequential(params):
    """``segments=4``: segment 0 exact, the warmed-up segments close to
    the sequential loop (as the JAX package's segmented scan)."""
    _, pt = params
    x = speech_like(SECONDS, SR, seed=1)
    seq = t_rn.denoise_channel_full(pt, torch.from_numpy(x), segments=1)
    seg = t_rn.denoise_channel_full(pt, torch.from_numpy(x), segments=4)
    q = 250 // 4 + 1
    assert torch.allclose(seq[1][:q], seg[1][:q], rtol=0, atol=1e-6)
    assert torch.allclose(seq[0][: (q - 1) * t_rn.FRAME], seg[0][: (q - 1) * t_rn.FRAME],
                          rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-7])
def test_all_silent_input(params, scale):
    pj, pt = params
    x = (scale * np.random.default_rng(5).standard_normal(int(SECONDS * SR))).astype(np.float32)
    ref = [np.asarray(a) for a in j_rn.denoise_channel_full(pj, jnp.asarray(x))]
    got = [a.numpy() for a in t_rn.denoise_channel_full(pt, torch.from_numpy(x))]
    assert np.isfinite(got[0]).all() and not got[1].any()
    assert np.abs(got[0] - ref[0]).max() <= 1e-9 + 1e-3 * np.abs(ref[0]).max()
    assert np.abs(got[2] - ref[2]).max() <= 1e-5


def test_planted_faults_fail_the_limits(params, monkeypatch):
    """The silence freeze dropped, or z and r swapped in the GRU, must
    fail the engine's limits against the JAX package."""
    pj, pt = params
    x = speech_like(SECONDS, SR, seed=1)
    ref = [np.asarray(a) for a in j_rn.denoise_channel_full(pj, jnp.asarray(x))]

    def swapped(h, xw, recurrent):
        u = h.shape[-1]
        perm = torch.cat([torch.arange(u, 2 * u), torch.arange(u), torch.arange(2 * u, 3 * u)])
        return real(h, xw[..., perm], recurrent[..., perm])

    real = t_rn._gru_update
    monkeypatch.setattr(t_rn, "_gru_update", swapped)
    bad = [a.numpy() for a in t_rn.denoise_channel_full(pt, torch.from_numpy(x))]
    monkeypatch.undo()
    assert np.abs(bad[2] - ref[2]).max() > GAINS and np.abs(bad[0] - ref[0]).max() > WAVE

    monkeypatch.setattr(t_rn, "_hold", lambda silent, old, new: new)
    bad = [a.numpy() for a in t_rn.denoise_channel_full(pt, torch.from_numpy(x))]
    monkeypatch.undo()
    assert np.abs(bad[2] - ref[2]).max() > GAINS


# ---------------------------------------------------------------- ops.mix

MODES = ["off", "more_on_noise", "more_on_speech", "gate_on_noise"]


@pytest.mark.parametrize("mode", MODES)
def test_strength_and_gains(mode):
    v = np.random.default_rng(2).uniform(-0.2, 1.2, 300).astype(np.float32)
    for base, amount, thr in ((0.8, 0.5, 0.9), (0.3, 1.0, 0.4), (1.0, 0.0, 0.5)):
        ref = np.asarray(j_mix.strength_per_frame(base, jnp.asarray(v), mode, amount, thr))
        got = t_mix.strength_per_frame(base, torch.from_numpy(v), mode, amount, thr).numpy()
        assert np.abs(got - ref).max() <= 1e-6
        for curve in ("equal_power", "linear"):
            rd, rw = (np.asarray(a) for a in j_mix.gains_from_strength(jnp.asarray(ref), curve))
            gd, gw = (a.numpy() for a in t_mix.gains_from_strength(torch.from_numpy(ref), curve))
            assert np.abs(gd - rd).max() <= 1e-6 and np.abs(gw - rw).max() <= 1e-6


@pytest.mark.parametrize("shape", [(48000,), (2, 47999), (3, 480)])
def test_rms_vad_probs(shape):
    x = (0.2 * np.random.default_rng(3).standard_normal(shape)).astype(np.float32)
    x[..., : x.shape[-1] // 3] *= 0.01
    ref = np.asarray(j_mix.rms_vad_probs(jnp.asarray(x)))
    got = t_mix.rms_vad_probs(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("curve", ["equal_power", "linear"])
def test_adaptive_mix(mode, curve):
    rng = np.random.default_rng(4)
    dry = (0.5 * rng.standard_normal(4810)).astype(np.float32)
    wet = (0.5 * rng.standard_normal(4810)).astype(np.float32)
    for probs in (rng.uniform(0, 1, 10).astype(np.float32), None):
        for smooth in (50.0, 0.0):
            kw = dict(strength=0.7, mix_curve=curve, adaptive_mode=mode, adaptive_amount=0.5,
                      vad_threshold=0.6, vad_smooth_ms=smooth, frame_hop=480)
            ref = np.asarray(j_mix.adaptive_mix(jnp.asarray(dry), jnp.asarray(wet),
                                                None if probs is None else jnp.asarray(probs),
                                                **kw))
            got = t_mix.adaptive_mix(torch.from_numpy(dry), torch.from_numpy(wet),
                                     None if probs is None else torch.from_numpy(probs),
                                     **kw).numpy()
            assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("gain_db,limit,ceiling", [(0.0, True, 0.999), (6.0, True, 0.5),
                                                   (-3.0, False, 0.9), (12.0, False, 0.9)])
def test_post_gain_limit(gain_db, limit, ceiling):
    y = (0.4 * np.random.default_rng(6).standard_normal((2, 3000))).astype(np.float32)
    ref = np.asarray(j_mix.post_gain_limit(jnp.asarray(y), gain_db, limit, ceiling))
    got = t_mix.post_gain_limit(torch.from_numpy(y), gain_db, limit, ceiling).numpy()
    assert np.abs(got - ref).max() <= 1e-6


# ---------------------------------------------------------------- node

def _audio(sr, channels=2, batch=1, seed=0):
    x = np.stack([speech_like(SECONDS, sr, seed=seed + i, gaps=()) for i in range(batch * channels)])
    return {"waveform": torch.from_numpy(x.reshape(batch, channels, -1)), "sample_rate": sr}


def _same(got, ref, audio, mode):
    """The node outputs agree (module docstring): relative L2 over all,
    max |d| on every frame but a flipped period's (and the next)."""
    gw, rw = got["waveform"].numpy(), np.asarray(ref["waveform"])
    assert got["sample_rate"] == ref["sample_rate"] and gw.shape == rw.shape
    assert got["meta"] == ref["meta"]
    assert np.linalg.norm(gw - rw) <= 1e-3 * np.linalg.norm(rw)
    from egregora_tpu_torch.ops.resample import resample
    wf = audio["waveform"]
    x48 = resample(wf.reshape(-1, wf.shape[-1]), audio["sample_rate"], SR).numpy()
    if mode == "downmix_mono":
        x48 = x48.reshape(wf.shape[0], wf.shape[1], -1).mean(1)
    hop = t_rn.FRAME * audio["sample_rate"] // SR
    for g, r, x in zip(gw.reshape(-1, gw.shape[-1]), rw.reshape(-1, rw.shape[-1]), x48):
        (per_j, sil), (per_t, _) = jax_periods(x), torch_periods(x)
        flips = np.nonzero((per_j != per_t) & ~sil)[0]
        assert flips.size <= 0.01 * (~sil).sum()
        keep = np.ones(g.shape[0] // hop + 1, bool)
        keep[flips], keep[np.minimum(flips + 1, keep.size - 1)] = False, False
        d = np.abs(g - r)
        d = np.pad(d, (0, keep.size * hop - d.size)).reshape(keep.size, hop)
        assert d[keep].max() <= NODE


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setattr(t_node.Egregora_RNNoise_Denoise, "DEVICE", "cpu")


@pytest.mark.parametrize("frame_ms", [10, 30])
@pytest.mark.parametrize("mode", ["per_channel", "downmix_mono"])
@pytest.mark.parametrize("sr", [48000, 16000])
def test_node_matches_jax(sr, mode, frame_ms, on_cpu):
    audio = _audio(sr)
    kw = dict(frame_ms=frame_ms, stereo_mode=mode, strength=0.9, adaptive_mode="gate_on_noise")
    (ref,) = j_node.Egregora_RNNoise_Denoise().execute(audio, **kw)
    (got,) = t_node.Egregora_RNNoise_Denoise().execute(audio, **kw)
    _same(got, ref, audio, mode)
    assert got["waveform"].shape[1] == (2 if mode == "per_channel" else 1)


def test_node_batch_meta(on_cpu, monkeypatch):
    """B = 2 items: a batch folded into channels, downmixed per item."""
    audio = _audio(48000, batch=2, seed=5)
    monkeypatch.setenv("EGREGORA_RNNOISE_SEGMENTS", "4")
    for mode in ("per_channel", "downmix_mono"):
        (ref,) = j_node.Egregora_RNNoise_Denoise().execute(audio, stereo_mode=mode)
        (got,) = t_node.Egregora_RNNoise_Denoise().execute(audio, stereo_mode=mode)
        _same(got, ref, audio, mode)
        assert got["meta"]["batch"] == 2 and got["waveform"].shape[0] == 2


def test_node_contract_and_random_init_warning(monkeypatch, capsys):
    for key in ("Egregora_RNNoise_Denoise", "Egregora_WPE_Dereverb"):
        tn, jn = t_node.NODE_CLASS_MAPPINGS[key], j_node.NODE_CLASS_MAPPINGS[key]
        assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
        assert t_node.NODE_DISPLAY_NAME_MAPPINGS[key] == j_node.NODE_DISPLAY_NAME_MAPPINGS[key]
        for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
            assert getattr(tn, attr) == getattr(jn, attr)
        assert tn.DEVICE == "cuda"
    cls = t_node.Egregora_RNNoise_Denoise
    monkeypatch.setattr(cls, "_PARAMS", None)
    monkeypatch.setattr(t_train, "load_pretrained", lambda: None)
    p = cls._params()
    assert "RANDOM-INIT" in capsys.readouterr().out
    np.testing.assert_array_equal(p["vad_gru"]["kernel"], t_rn.init_params(0)["vad_gru"]["kernel"])
