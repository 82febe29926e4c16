"""PyTorch port vs the JAX package: the Fat Llama spectral-enhance path.

Same inputs (numpy, seeded) through ``egregora_tpu`` and
``egregora_tpu_torch`` on the CPU, in float32.  The JAX package runs its
accelerator loop (``use_matmul_fft=True``) on matmul DFTs in a permuted
bin order and its CPU loop on ``jnp.fft``; the port runs both on
``torch.fft``.  Tolerances:

* the factorisations and the bitrate helpers: exact;
* ``ist_upscale`` / ``spectral_enhance`` at 0, 3 and 20 iterations:
  max |d| <= 1e-5 (outputs of order 1; the two transforms differ by
  float32 rounding, ~5e-7 measured);
* at the node default of 300 iterations: max |d| <= 1e-3 and relative
  L2 <= 1e-4.  The gate ``|X|^2 >= thr^2 max |X|^2`` is discontinuous,
  so a bin at the threshold can flip between the two float orders over
  hundreds of iterations;
* the nodes (AUDIO dict, ``(array, sr)``, a WAV path, a URL served on
  127.0.0.1): max |d| <= 1e-5 at 20 iterations.
"""
import threading
import wave
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.nodes import spectral_enhance as j_node
from egregora_tpu.ops import fft as j_fft
from egregora_tpu.ops import spectral as j_sp
from egregora_tpu_torch.nodes import spectral_enhance as t_node
from egregora_tpu_torch.ops import fft as t_fft
from egregora_tpu_torch.ops import spectral as t_sp
from egregora_tpu_torch.utils import native as t_native
from egregora_tpu_torch.utils import wavio as t_wavio

TIGHT = 1e-5
LONG_ABS, LONG_REL = 1e-3, 1e-4


def _signal(c, s, seed, noise=0.05):
    """Tones plus noise, |x| < 1."""
    rng = np.random.default_rng(seed)
    t = np.arange(s) / 16000.0
    tones = sum(0.2 / k * np.sin(2 * np.pi * 220 * k * t + k) for k in range(1, 5))
    return (tones + noise * rng.standard_normal((c, s))).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("sr,ch,kbps,bits", [(16000, 1, 1411, 16), (48000, 1, 1411, 16),
                                             (44100, 2, 1411, 16), (8000, 1, 64, 16),
                                             (22050, 2, 5000, 24), (48000, 2, 64, 16)])
def test_bitrate_and_factor_helpers(sr, ch, kbps, bits):
    assert t_sp.source_bitrate_kbps(sr, ch, bits) == j_sp.source_bitrate_kbps(sr, ch, bits)
    assert t_sp.upscale_factor(sr, ch, kbps, bits) == j_sp.upscale_factor(sr, ch, kbps, bits)


def test_factorisations_match_jax():
    """``balanced_factors`` and ``alias_factors`` decide the transform
    length and the loop form: equal to the JAX package's on every n of a
    range and at the node paths' lengths."""
    ns = list(range(2, 3000)) + [4099 * 2, 2_880_000, 11_520_000, 2 ** 22, 4097 * 4099,
                                 16_777_216 + 2, 1600 * 1800 * 3]
    for n in ns:
        assert t_fft.balanced_factors(n) == j_fft.balanced_factors(n), n
        for f in (1, 2, 3, 6):
            assert t_fft.alias_factors(n, f) == j_fft.alias_factors(n, f), (n, f)


# (S, factor): balanced n_up (the fold loop where the factor aliases) and
# a padded one (4099 * 2 = 8198 has no radix pair <= 4096: next pow2)
SHAPES = [(4000, 2), (4099, 2), (3000, 3), (1200, 6)]


@pytest.mark.parametrize("use_mm", [True, False])
@pytest.mark.parametrize("s,factor", SHAPES)
def test_loop_form_matches_jax(s, factor, use_mm):
    """The port runs the fold-domain loop exactly where the JAX package does."""
    n_up = s * factor
    n_fft = n_up if j_fft.balanced_factors(n_up) else j_sp._next_pow2(n_up)
    jax_fold = (use_mm and factor > 1 and n_fft == n_up
                and j_fft.alias_factors(n_up, factor) is not None)
    assert t_sp.transform_length(n_up) == n_fft
    assert t_sp.fold_loop(n_up, factor, use_mm) == jax_fold
    assert jax_fold == (use_mm and s != 4099)


@pytest.mark.parametrize("iters", [0, 3, 20])
@pytest.mark.parametrize("use_mm", [True, False])
@pytest.mark.parametrize("s,factor", SHAPES)
def test_ist_upscale_matches_jax(s, factor, use_mm, iters):
    x = _signal(2, s, seed=s + factor)
    ref = np.asarray(j_sp.ist_upscale(jnp.asarray(x), factor, iters, 0.6,
                                      use_matmul_fft=use_mm))
    got = t_sp.ist_upscale(torch.from_numpy(x), factor, iters, 0.6,
                           use_matmul_fft=use_mm).numpy()
    assert got.shape == ref.shape == (2, s * factor) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= TIGHT
    np.testing.assert_array_equal(got[:, ::factor], x)      # observations kept


@pytest.mark.parametrize("use_mm", [True, False])
@pytest.mark.parametrize("s,factor", SHAPES)
def test_spectral_enhance_matches_jax(s, factor, use_mm):
    x = 1.5 * _signal(1, s, seed=7 * s)
    for norm, auto in ((True, True), (True, False), (False, True)):
        kw = dict(toggle_normalize=norm, toggle_autoscale=auto, use_matmul_fft=use_mm)
        ref = np.asarray(j_sp.spectral_enhance(jnp.asarray(x), factor, 20, 0.3, **kw))
        got = t_sp.spectral_enhance(torch.from_numpy(x), factor, 20, 0.3, **kw).numpy()
        assert got.shape == ref.shape and np.abs(got - ref).max() <= TIGHT


@pytest.mark.parametrize("use_mm", [True, False])
@pytest.mark.parametrize("s,factor", [(4000, 2), (4099, 2)])
def test_spectral_enhance_300_iterations(s, factor, use_mm):
    """The node default: the looser limit of the module docstring."""
    x = _signal(2, s, seed=3, noise=0.1)
    ref = np.asarray(j_sp.spectral_enhance(jnp.asarray(x), factor, 300, 0.05,
                                           use_matmul_fft=use_mm))
    got = t_sp.spectral_enhance(torch.from_numpy(x), factor, 300, 0.05,
                                use_matmul_fft=use_mm).numpy()
    assert np.abs(got - ref).max() <= LONG_ABS and _rel(got, ref) <= LONG_REL


def test_planted_late_clamp_fails_the_limit(monkeypatch):
    """The observations clamped one sample late (``k f + 1``) must fail
    the tight limit on both loops."""
    x = _signal(1, 4000, seed=5)

    def late(z, y_obs, factor):
        z[:, 1: y_obs.shape[1] * factor: factor] = y_obs
        return z

    for use_mm in (True, False):
        ref = np.asarray(j_sp.ist_upscale(jnp.asarray(x), 2, 20, 0.6, use_matmul_fft=use_mm))
        monkeypatch.setattr(t_sp, "_clamp_observed", late)
        bad = t_sp.ist_upscale(torch.from_numpy(x), 2, 20, 0.6, use_matmul_fft=use_mm).numpy()
        monkeypatch.undo()
        assert np.abs(bad - ref).max() > 100 * TIGHT


# ---------------------------------------------------------------- nodes

NODE_KEYS = ("EgregoraFatLlamaGPU", "EgregoraFatLlamaCPU")
NODE_ARGS = dict(target_format="wav", max_iterations=20, threshold_value=0.6,
                 target_bitrate_kbps=1411)


def _write_wav(path, x_cs, sr):
    pcm = (np.clip(x_cs.T, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x_cs.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.fixture()
def served(tmp_path):
    """A WAV file on disk and served over HTTP on 127.0.0.1."""
    x = 0.5 * _signal(1, 4000, seed=11)
    _write_wav(tmp_path / "in.wav", x, 16000)
    handler = partial(SimpleHTTPRequestHandler, directory=str(tmp_path))
    srv = HTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield tmp_path / "in.wav", f"http://127.0.0.1:{srv.server_address[1]}/in.wav", x
    srv.shutdown()
    th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.parametrize("key", NODE_KEYS)
def test_node_contract_matches_jax(key):
    tn, jn = t_node.NODE_CLASS_MAPPINGS[key], j_node.NODE_CLASS_MAPPINGS[key]
    assert t_node.NODE_DISPLAY_NAME_MAPPINGS[key] == j_node.NODE_DISPLAY_NAME_MAPPINGS[key]
    assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY", "OUTPUT_NODE"):
        assert getattr(tn, attr) == getattr(jn, attr)
    assert t_node.EgregoraFatLlamaCPU.DEVICE == "cpu"
    assert t_node.EgregoraFatLlamaGPU.DEVICE == "cuda"


@pytest.mark.parametrize("source", ["dict", "pair", "path", "url"])
@pytest.mark.parametrize("key", NODE_KEYS)
def test_node_matches_jax(key, source, served, monkeypatch):
    path, url, x = served
    if key == "EgregoraFatLlamaGPU":
        monkeypatch.setattr(t_node.EgregoraFatLlamaGPU, "DEVICE", "cpu")
    inputs = {"dict": dict(AUDIO={"waveform": torch.from_numpy(x[None]), "sample_rate": 16000}),
              "pair": dict(AUDIO=(x[0], 16000)),
              "path": dict(audio_path=str(path)),
              "url": dict(audio_url=url)}[source]
    (ref,) = j_node.NODE_CLASS_MAPPINGS[key]().run(**NODE_ARGS, **inputs)
    (got,) = t_node.NODE_CLASS_MAPPINGS[key]().run(**NODE_ARGS, **inputs)
    assert got["sample_rate"] == ref["sample_rate"] == 16000 * 6
    gw, rw = got["waveform"].numpy(), np.asarray(ref["waveform"])
    assert isinstance(got["waveform"], torch.Tensor) and gw.shape == rw.shape == (1, 1, 24000)
    assert np.abs(gw - rw).max() <= TIGHT


def test_node_without_audio_raises():
    with pytest.raises(RuntimeError, match="No AUDIO"):
        t_node.EgregoraFatLlamaCPU().run(**NODE_ARGS)
    with pytest.raises(RuntimeError, match="not found"):
        t_node.EgregoraFatLlamaCPU().run(**NODE_ARGS, audio_path="/nonexistent/x.wav")


def test_read_audio_backends(tmp_path, monkeypatch):
    """The native codec builds into the port's ``_build`` (never under
    ``native/``) and reads what the stdlib fallback reads."""
    x = 0.5 * _signal(2, 3001, seed=2)
    p = tmp_path / "a.wav"
    _write_wav(p, x, 22050)
    before = sorted(q.name for q in t_native.NATIVE_DIR.iterdir())
    so = t_native.build()
    assert so is not None and so.parent == t_native.BUILD_DIR and so.exists()
    assert sorted(q.name for q in t_native.NATIVE_DIR.iterdir()) == before
    got, sr = t_wavio.read_audio(p)
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setattr(t_native, "_TRIED", True)           # no native library
    fallback, sr2 = t_wavio.read_audio(p)
    assert sr == sr2 == 22050 and got.shape == fallback.shape == (2, 3001)
    np.testing.assert_allclose(got, fallback, atol=1e-6)
    np.testing.assert_allclose(got, x, atol=1.0 / 16000)
