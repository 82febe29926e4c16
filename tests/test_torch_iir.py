"""PyTorch port vs the JAX package: the first-order IIR filters and K4.

The port's plain version of K4 (``ops.iir_lowpass.iir_lowpass`` on a CPU
tensor: the blocked recurrence) against the JAX Pallas kernel
``iir_lowpass_pallas`` run through the Pallas interpreter, as
``tests/test_pallas_iir.py`` runs it; ``k_weight``, ``biquad``,
``ema_smooth`` and ``first_order_lowpass`` against the JAX functions and
a float64 reference.  Inputs are numpy-seeded; tolerances are stated
where they are used.
"""
import collections
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from scipy.signal import lfilter

import chip_smoke
import egregora_tpu.ops.pallas_iir as P
from egregora_tpu.ops import iir as j_iir
from egregora_tpu_torch.ops import iir as t_iir
from egregora_tpu_torch.ops import iir_lowpass as t_k4

K24 = math.exp(-2 * math.pi * 60.0 / 24000)      # the K-weighting pole at 48 kHz


@pytest.fixture()
def interpret_mode(monkeypatch):
    """The JAX kernel through the Pallas interpreter (no TPU here)."""
    monkeypatch.setattr(P.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n", [100, P.BLOCK, 2 * P.BLOCK + 777])
def test_plain_k4_matches_pallas_kernel(interpret_mode, n):
    """Two channels, one call; within 2e-6 (both are float32 scans of a
    unit-scale signal, ~2e-7 from float64 each), and the CPU tensor never
    reaches the CUDA kernel."""
    x = _x((2, n), n)
    ref = np.asarray(P.iir_lowpass_pallas(jnp.asarray(x), K24))
    before = t_k4.launches
    got = t_k4.iir_lowpass(torch.from_numpy(x), K24).numpy()
    assert t_k4.launches == before
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_plain_k4_cross_block_impulse(interpret_mode):
    """A unit impulse decays smoothly across the 32768-sample block of the
    JAX kernel and the 1024-sample blocks of the plain version: both
    within 1e-3 relative of ``(1-k) k^(n-10)``, and of each other within
    1e-7."""
    k, n = 0.999, P.BLOCK + 512
    x = np.zeros((1, n), np.float32)
    x[0, 10] = 1.0
    idx = np.array([10, 1000, 1023, 1034, P.BLOCK - 1, P.BLOCK, P.BLOCK + 100])
    expect = (1 - k) * k ** (idx - 10)
    got = t_k4.iir_lowpass(torch.from_numpy(x), k).numpy()[0]
    ref = np.asarray(P.iir_lowpass_pallas(jnp.asarray(x), k))[0]
    np.testing.assert_allclose(got[idx], expect, rtol=1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-7)


def test_blocked_recurrence_near_unit_pole():
    """k = 0.9999 over 300000 samples (three levels of 1024-sample
    blocks): within 2e-6 of float64, where one float32 scan over the
    whole signal drifts."""
    k = 0.9999
    x = _x((1, 300000), 5, 0.5)
    ref = lfilter([1 - k], [1, -k], x.astype(np.float64))
    got = t_k4.iir_lowpass(torch.from_numpy(x), k).numpy()
    assert np.abs(got - ref).max() <= 2e-6


def test_pole_tables_are_float64_powers():
    """k^j for j = 0..TILE, then (k^TILE)^j for the look-back window, from
    float64: a table of repeated float32 products would drift ~1e-4
    relative by j = 4096 at k near 1."""
    k = 0.9999
    t = t_k4.pole_tables(k)
    j = np.arange(t_k4.TILE + 1)
    w = np.arange(t_k4.WINDOW + 1)
    np.testing.assert_allclose(t[:t_k4.TILE + 1], k ** j.astype(np.float64), rtol=2e-7)
    np.testing.assert_allclose(t[t_k4.TILE + 1:], np.power(k, float(t_k4.TILE) * w),
                               rtol=2e-7, atol=1e-38)
    assert t.dtype == np.float32 and t.shape == (t_k4.TILE + 1 + t_k4.WINDOW + 1,)


LOOKBACK_N = [1, 100, t_k4.TILE - 1, t_k4.TILE, 3 * t_k4.TILE + 5, 2 * P.BLOCK + 777]


@pytest.mark.parametrize("k", [K24, 0.9999])
@pytest.mark.parametrize("n", LOOKBACK_N)
def test_lookback_model_matches_plain_and_pallas(interpret_mode, n, k):
    """The kernel's single-pass schedule on the CPU (local tile scans,
    published aggregates, a look-back over a seeded mix of predecessor
    states) on two channels: within 2e-6 (``chip_smoke.IIR_ABS``) of the
    plain version and of the JAX kernel in interpret mode."""
    x = _x((2, n), n + 1, 0.5)
    got = t_k4.lookback_model(torch.from_numpy(x), k, order_seed=n).numpy()
    plain = t_k4.iir_lowpass_plain(torch.from_numpy(x), k).numpy()
    ref = np.asarray(P.iir_lowpass_pallas(jnp.asarray(x), k))
    assert got.shape == x.shape
    assert np.abs(got - plain).max() <= chip_smoke.IIR_ABS
    assert np.abs(got - ref).max() <= chip_smoke.IIR_ABS


def test_lookback_model_sees_every_state_and_any_order_agrees():
    """Over seeded orders the look-backs meet predecessors not yet
    published, with an aggregate only and with an inclusive prefix; every
    order gives the same scan (float32 rounding apart) at both poles."""
    x = torch.from_numpy(_x((3, 12 * t_k4.TILE + 9), 4, 0.5))
    for k in (K24, 0.9999):
        plain = t_k4.iir_lowpass_plain(x, k)
        seen = collections.Counter()
        for seed in range(3):
            got = t_k4.lookback_model(x, k, order_seed=seed, seen=seen)
            assert float((got - plain).abs().max()) <= chip_smoke.IIR_ABS
        assert set(seen) == set(t_k4.STATUS_NAMES), seen


def _tiles(x, lo, hi, k):
    """The plain scan of x[:, lo:hi] from a zero state."""
    return t_k4.iir_lowpass_plain(x[:, lo:hi].contiguous(), k)


@pytest.mark.parametrize("k,visible", [(K24, False), (0.9999, True)])
def test_smoke_planted_lookback_fault_is_what_it_says(k, visible):
    """``chip_smoke.one_step_lookback`` is each tile scanned from the state
    its predecessor reaches from zero (the scan of the two tiles from a
    zero state, restricted to the second); the card run's limit
    (``chip_smoke.iir_agreement``) passes it at the 48 kHz pole, where
    k^TILE ~ 1e-56 hides it, and rejects it at pole 0.9999 (k^TILE ~
    0.44), as ``chip_smoke.one_step_visible`` says; the dropped carry is
    rejected at both."""
    T = t_k4.TILE
    x = torch.from_numpy(_x((2, 4 * T + 77), 7, 0.5))
    plain = t_k4.iir_lowpass_plain(x, k)
    bad = chip_smoke.one_step_lookback(x, k)
    torch.testing.assert_close(bad[:, :T], plain[:, :T], rtol=0, atol=1e-7)
    for t in range(1, 5):
        want = _tiles(x, (t - 1) * T, (t + 1) * T, k)[:, T:]
        torch.testing.assert_close(bad[:, t * T:(t + 1) * T], want, rtol=0, atol=2e-7)
    assert chip_smoke.one_step_visible(k) == visible
    assert chip_smoke.iir_agreement(bad, plain)[0] == (not visible)
    assert not chip_smoke.iir_agreement(chip_smoke.dropped_carry(x, k), plain)[0]


def _k_weight_f64(sr, x):
    k = math.exp(-2.0 * math.pi * 60.0 / (sr * 0.5))
    y = x - lfilter([1 - k], [1, -k], x.astype(np.float64))
    out = y.copy()
    out[..., 1:] += 0.02 * (y[..., 1:] - y[..., :-1])
    return out


@pytest.mark.parametrize("sr,n", [(48000, 96000), (16000, 5000), (44100, 1)])
def test_k_weight_matches_jax_and_float64(sr, n):
    """The JAX package's CPU path runs one full-length associative scan,
    the port the blocked recurrence: both are held to a float64 reference
    within 2e-6 on a 0.5-scale signal, and to each other within 4e-6."""
    x = _x((2, n), sr + n, 0.5)
    ref = _k_weight_f64(sr, x)
    j = np.asarray(j_iir.k_weight(sr, jnp.asarray(x)))
    t = t_iir.k_weight(sr, torch.from_numpy(x)).numpy()
    assert t.shape == j.shape == x.shape and t.dtype == np.float32
    assert np.abs(t - ref).max() <= 2e-6
    assert np.abs(j - ref).max() <= 2e-6
    assert np.abs(t - j).max() <= 4e-6


def test_first_order_lowpass_matches_jax():
    """Leading axes are rows; within 2e-6 of the JAX scan and of float64."""
    x = _x((3, 2, 7000), 11)
    ref = lfilter([1 - K24], [1, -K24], x.astype(np.float64))
    got = t_iir.first_order_lowpass(torch.from_numpy(x), K24).numpy()
    j = np.asarray(j_iir.first_order_lowpass(jnp.asarray(x), K24))
    assert np.abs(got - ref).max() <= 2e-6 and np.abs(got - j).max() <= 2e-6


@pytest.mark.parametrize("b,a", [((-2.0, 1.0), (-1.975, 0.9751)),   # a DC blocker, poles 0.995, 0.98
                                 ((0.5, 0.1), (-0.9, 0.2))])
def test_biquad_matches_jax(b, a):
    """Two first-order sections against float64 ``lfilter``: the JAX
    package's docstring bounds the factorisation error to the stopband,
    so both are compared on a tone in the passband (1 kHz at 48 kHz), to
    float64 within 1e-3 relative L2 and to each other within 5e-4."""
    t = np.arange(48000) / 48000
    x = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)[None]
    ref = lfilter([1.0, b[0], b[1]], [1.0, a[0], a[1]], x.astype(np.float64))
    got = t_iir.biquad(torch.from_numpy(x), b, a).numpy()
    j = np.asarray(j_iir.biquad(jnp.asarray(x), b, a))

    def rel(u, v):
        return np.linalg.norm(u - v) / np.linalg.norm(v)
    assert rel(got, ref) <= 1e-3 and rel(j, ref) <= 1e-3 and rel(got, j) <= 5e-4
    with pytest.raises(ValueError, match="complex poles"):
        t_iir.biquad(torch.from_numpy(x), b, (0.0, 0.5))


@pytest.mark.parametrize("smooth_ms", [0.0, 25.0, 300.0])
def test_ema_smooth_matches_jax(smooth_ms):
    """Seeded with p[0]; against the JAX scan and the reference's loop
    within 1e-6."""
    p = np.random.default_rng(3).uniform(size=(2, 700)).astype(np.float32)
    got = t_iir.ema_smooth(torch.from_numpy(p), smooth_ms).numpy()
    j = np.asarray(j_iir.ema_smooth(jnp.asarray(p), smooth_ms))
    np.testing.assert_allclose(got, j, atol=1e-6)
    if smooth_ms > 0:
        alpha = math.exp(-10.0 / smooth_ms)
        acc, loop = p[:, 0].astype(np.float64), []
        for i in range(p.shape[1]):
            acc = alpha * acc + (1 - alpha) * p[:, i]
            loop.append(acc)
        np.testing.assert_allclose(got, np.stack(loop, -1), atol=1e-6)
