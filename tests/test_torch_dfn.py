"""PyTorch port vs the JAX package: the DeepFilterNet denoiser (both
variants) and its node.

Same inputs (numpy, seeded) and the shipped weights
(``egregora_tpu/models/deepfilternet/pretrained.npz`` and
``pretrained_dfn3.npz``) through ``egregora_tpu`` and
``egregora_tpu_torch`` on the CPU, in float32.  Tolerances:

* the seeded ``init_params``: max |d| <= 1e-6; the ERB filterbank equal;
* each layer (convs at stride 1 and 2 on F = 32 and 96, the transposed
  convs, linear, grouped linear, the three GRUs, the shift stack):
  max |d| <= 1e-5 of outputs of order one;
* ``enhance_mono_full`` on 2 s of seeded noisy speech-like 48 kHz, both
  variants, with and without the post-filter: wave relative L2 <= 1e-4,
  ERB gains max |d| <= 1e-4, band power relative 1e-5 of the largest;
* the node (VAD sources rms, rnnoise and none; both stereo modes; 16
  and 48 kHz): relative L2 <= 1e-3 and equal meta but for
  ``meta["deepfilternet"]["device"]`` (the device it ran on; the JAX node
  writes "tpu").  The inputs (``chip_smoke.speech_signal`` plus noise)
  have a 50 ms quiet lead-in and fade into and out of their gaps
  (``test_torch_rnnoise.py``'s convention), so that the RNNoise VAD's
  pinned silence-flag divergence does not decide the result;
* name-mapped upstream weights (``test_weights.py``'s synthetic state
  dicts): equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from egregora_tpu.models.deepfilternet import model as J
from egregora_tpu.models.deepfilternet import train as j_train
from egregora_tpu.nodes import enhance_extras as j_node
from egregora_tpu.utils.weights import _flatten as j_flatten
from egregora_tpu.utils.weights import convert_state_dict as j_convert
from egregora_tpu_torch.models.deepfilternet import model as T
from egregora_tpu_torch.models.deepfilternet import train as t_train
from egregora_tpu_torch.nodes import enhance_extras as t_node
from egregora_tpu_torch.utils.weights import _flatten as t_flatten
from egregora_tpu_torch.utils.weights import convert_state_dict as t_convert
from egregora_tpu_torch.utils.weights import unflatten
from test_weights import _synthetic_torch_sd

VARIANTS = ("DeepFilterNet2", "DeepFilterNet3")
LAYER = 1e-5
WAVE, GAINS = 1e-4, 1e-4
NODE = 1e-3


@pytest.fixture(scope="module")
def shipped():
    out = {}
    for v in VARIANTS:
        pj, pt = j_train.load_pretrained(v), t_train.load_pretrained(v)
        assert pj is not None and pt is not None
        out[v] = (pj, pt)
    return out


def _t(tree):
    """A JAX-layout tree as float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def noisy_speech(seconds, sr, seed, channels=1):
    """``chip_smoke.noisy_speech`` with a gap at 0.9-1.2 s: speech-like
    harmonics with a 50 ms quiet lead-in, faded gaps, and noise."""
    x = chip_smoke.speech_signal(seconds, sr, channels, seed, gaps=((0.9, 1.2),))
    return (x + 0.05 * np.random.default_rng(seed + 1000).standard_normal(x.shape)
            ).astype(np.float32)


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_matches_jax(variant, seed):
    ref = j_flatten(J.init_params(seed, J.DFNConfig.for_variant(variant)))
    got = t_flatten(T.init_params(seed, T.DFNConfig.for_variant(variant)))
    assert set(ref) == set(got)
    for k in ref:
        r, g = np.asarray(ref[k]), got[k]
        assert g.shape == r.shape and g.dtype == np.float32, k
        assert np.abs(g - r).max() <= 1e-6, k


def test_config_and_filterbank():
    for v in VARIANTS + ("other",):
        assert J.DFNConfig.for_variant(v).__dict__ == T.DFNConfig.for_variant(v).__dict__
    np.testing.assert_array_equal(T.erb_filterbank(), J.erb_filterbank())
    assert (T.SR, T.N_FFT, T.HOP, T.FREQ, T.NB_ERB, T.NB_DF, T.DF_ORDER, T.KT, T.KF) == (
        J.SR, J.N_FFT, J.HOP, J.FREQ, J.NB_ERB, J.NB_DF, J.DF_ORDER, J.KT, J.KF)


def _maps(variant):
    if variant == "DeepFilterNet3":
        return J.dfn3_name_map(), T.dfn3_name_map()
    return ({**J.DF_NAME_MAP, **J.grouped_gru_name_map(8)},
            {**T.DF_NAME_MAP, **T.grouped_gru_name_map(8)})


@pytest.mark.parametrize("variant", VARIANTS)
def test_name_maps_convert_bit_for_bit(variant):
    """An upstream-layout state dict (``test_weights.py``'s synthetic one,
    GRU gates in torch's order) maps onto the same tree through both
    packages' name maps and converters, bit for bit."""
    cfg = J.DFNConfig.for_variant(variant)
    target = J.init_params(0, cfg)
    flat = j_flatten(target)
    raw_j, raw_t = _maps(variant)
    assert set(raw_j) == set(raw_t)
    rng = np.random.default_rng(13)
    sd = _synthetic_torch_sd(raw_j, flat, rng)
    for tk in ("emb_gru.linear_in.weight", "emb_gru.linear_out.weight"):
        if tk in raw_j:       # grouped linear weights load unchanged
            sd[tk] = rng.standard_normal(flat[raw_j[tk]].shape).astype(np.float32)
    ref = j_flatten(j_convert(sd, target, name_map=raw_j.get))
    got = t_flatten(t_convert(sd, T.init_params(0, T.DFNConfig.for_variant(variant)),
                              name_map=raw_t.get))
    assert set(ref) == set(got) == set(flat)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    # the converted tree runs in the port
    y = T.enhance_mono(unflatten(got),
                       torch.from_numpy(rng.standard_normal(4800).astype(np.float32) * 0.1))
    assert y.shape == (4800,) and bool(torch.isfinite(y).all())


def test_gru_gate_maps_match_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 6)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    np.testing.assert_array_equal(T._torch_gru_kernel(w), J._torch_gru_kernel(w))
    np.testing.assert_array_equal(T._torch_gru_bias(b), J._torch_gru_bias(b))


# ---------------------------------------------------------------- layers

def _nchw(x):            # JAX [T, F, C] -> port [1, C, T, F]
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))


def _close(got, ref, tol=LAYER):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("cin,f,stride", [(1, 32, 1), (64, 32, 2), (64, 16, 2), (2, 96, 1),
                                          (64, 96, 2), (64, 8, 1)])
def test_conv_matches_jax(cin, f, stride):
    rng = np.random.default_rng(cin + f + stride)
    p = J._conv_init(J.jax.random.PRNGKey(cin + f), cin, 64)
    p["bias"] = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    x = rng.standard_normal((7, f, cin)).astype(np.float32)
    ref = np.asarray(J._conv(p, jnp.asarray(x), stride_f=stride))
    got = T._conv(_t(p), _nchw(x), stride_f=stride)[0].permute(1, 2, 0).numpy()
    _close(got, ref)


@pytest.mark.parametrize("f", [8, 16])
def test_conv_t_matches_jax(f):
    rng = np.random.default_rng(f)
    p = J._conv_init(J.jax.random.PRNGKey(f), 64, 64)
    p["bias"] = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    x = rng.standard_normal((6, f, 64)).astype(np.float32)
    ref = np.asarray(J._conv_t(p, jnp.asarray(x), stride_f=2))
    got = T._conv_t(_t(p), _nchw(x), stride_f=2)[0].permute(1, 2, 0).numpy()
    _close(got, ref)


def test_linear_layers_and_shift_stack_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 256)).astype(np.float32)
    p = J._lin_init(J.jax.random.PRNGKey(1), 256, 40)
    _close(T._lin(_t(p), torch.from_numpy(x)), J._lin(p, jnp.asarray(x)))
    g = J._grouped_lin_init(J.jax.random.PRNGKey(2), 8, 256, 256)
    _close(T._grouped_lin(_t(g), torch.from_numpy(x)[None])[0], J._grouped_lin(g, jnp.asarray(x)))
    s = rng.standard_normal((9, 96)).astype(np.float32)
    np.testing.assert_array_equal(T._shift_stack(torch.from_numpy(s), 5).numpy(),
                                  np.asarray(J._shift_stack(jnp.asarray(s), 5)))


@pytest.mark.parametrize("variant", VARIANTS)
def test_sequence_models_match_jax(shipped, variant):
    """The grouped (DFN2) or squeezed (DFN3) GRU and the deep-filter GRU
    with the shipped weights, as one ``torch.nn.GRU`` call each, against
    the JAX package's ``lax.scan``."""
    pj, pt = shipped[variant]
    x = np.tanh(np.random.default_rng(3).standard_normal((2, 40, 256))).astype(np.float32)
    for b in range(2):
        ref = np.asarray(J._sequence_model(pj, jnp.asarray(x[b])))
        got = T._sequence_model(_t(pt), torch.from_numpy(x))[b].numpy()
        _close(got, ref)
        ref = np.asarray(J._gru_scan(pj["df_dec"]["gru"], jnp.asarray(x[b])))
        _close(T._gru_scan(_t(pt["df_dec"]["gru"]), torch.from_numpy(x))[b].numpy(), ref)


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("post_filter", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_enhance_mono_full_matches_jax(shipped, variant, post_filter):
    pj, pt = shipped[variant]
    x = noisy_speech(2.0, 48000, seed=7)[0]
    yj, gj, ej = (np.asarray(a) for a in J.enhance_mono_full(pj, jnp.asarray(x), post_filter))
    yt, gt, et = (a.numpy() for a in T.enhance_mono_full(pt, torch.from_numpy(x), post_filter))
    assert yt.shape == yj.shape == x.shape and gt.shape == gj.shape
    assert np.linalg.norm(yt - yj) <= WAVE * np.linalg.norm(yj)
    assert np.abs(gt - gj).max() <= GAINS
    assert np.abs(et - ej).max() <= 1e-5 * np.abs(ej).max()
    assert np.linalg.norm(yt - x) > 0.05 * np.linalg.norm(x)     # it did denoise


def test_enhance_batches_channels_and_band_energies(shipped):
    """``enhance`` runs channels as one batch, each as ``enhance_mono``;
    ``erb_band_energies`` is the JAX package's."""
    _, pt = shipped["DeepFilterNet2"]
    x = noisy_speech(0.5, 48000, seed=1, channels=2)
    both = T.enhance(pt, torch.from_numpy(x)).numpy()
    for c in range(2):
        one = T.enhance_mono(pt, torch.from_numpy(x[c])).numpy()
        assert np.abs(both[c] - one).max() <= 1e-6
    ref = np.asarray(J.erb_band_energies(jnp.asarray(x[0])))
    got = T.erb_band_energies(torch.from_numpy(x[0])).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_short_and_silent_inputs(shipped):
    _, pt = shipped["DeepFilterNet3"]
    for n in (1, 479, 480, 961):
        y = T.enhance_mono(pt, torch.zeros(n))
        assert y.shape == (n,) and bool(torch.isfinite(y).all())


# ---------------------------------------------------------------- node

@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setattr(t_node.Egregora_DeepFilterNet_Denoise, "DEVICE", "cpu")
    monkeypatch.setattr(t_node.Egregora_RNNoise_Denoise, "DEVICE", "cpu")


def _audio(sr, seconds=1.2, channels=2, batch=1):
    x = noisy_speech(seconds, sr, seed=20, channels=batch * channels)
    return {"waveform": torch.from_numpy(x.reshape(batch, channels, -1)), "sample_rate": sr}


def _same_node_output(got, ref):
    gw, rw = got["waveform"].numpy(), np.asarray(ref["waveform"])
    assert got["sample_rate"] == ref["sample_rate"] and gw.shape == rw.shape
    assert np.linalg.norm(gw - rw) <= NODE * np.linalg.norm(rw)
    gm, rm = got["meta"], ref["meta"]
    assert gm["deepfilternet"]["device"] == "cpu" and rm["deepfilternet"]["device"] == "tpu"

    def strip(m):
        return {**m, "deepfilternet": {k: v for k, v in m["deepfilternet"].items()
                                       if k != "device"}}

    assert strip(gm) == strip(rm)


@pytest.mark.parametrize("sr,vad,mode,variant,pf", [
    (48000, "rms", "per_channel", "DeepFilterNet2", False),
    (48000, "rnnoise", "downmix_mono", "DeepFilterNet3", True),
    (48000, "none", "downmix_mono", "DeepFilterNet2", False),
    (16000, "rms", "downmix_mono", "DeepFilterNet3", False),
    (16000, "rnnoise", "per_channel", "DeepFilterNet2", True),
    (16000, "none", "per_channel", "DeepFilterNet3", False),
])
def test_node_matches_jax(on_cpu, sr, vad, mode, variant, pf):
    audio = _audio(sr)
    kw = dict(dfn_model=variant, adaptive_vad_source=vad, stereo_mode=mode, use_postfilter=pf)
    (ref,) = j_node.Egregora_DeepFilterNet_Denoise().execute(audio, **kw)
    (got,) = t_node.Egregora_DeepFilterNet_Denoise().execute(audio, **kw)
    _same_node_output(got, ref)


def test_node_batch_and_widgets(on_cpu):
    """A [2, 2, T] batch (downmixed per item) and non-default widgets."""
    audio = _audio(48000, seconds=0.6, batch=2)
    kw = dict(stereo_mode="downmix_mono", strength=0.9, mix_curve="linear",
              adaptive_mode="gate_on_noise", adaptive_amount=0.7, vad_threshold=0.5,
              vad_smooth_ms=0, post_gain_db=-3.0, limit_ceiling=False, device="cuda:0")
    (ref,) = j_node.Egregora_DeepFilterNet_Denoise().execute(audio, **kw)
    (got,) = t_node.Egregora_DeepFilterNet_Denoise().execute(audio, **kw)
    assert got["waveform"].shape == (2, 1, audio["waveform"].shape[-1])
    _same_node_output(got, ref)


def test_node_contract_and_random_init_warning(monkeypatch, capsys):
    key = "Egregora_DeepFilterNet_Denoise"
    tn, jn = t_node.NODE_CLASS_MAPPINGS[key], j_node.NODE_CLASS_MAPPINGS[key]
    assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
    assert t_node.NODE_DISPLAY_NAME_MAPPINGS[key] == j_node.NODE_DISPLAY_NAME_MAPPINGS[key]
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(tn, attr) == getattr(jn, attr)
    assert tn.DEVICE == "cuda"
    monkeypatch.setattr(tn, "_PARAMS", {})
    monkeypatch.setattr(t_train, "SHIPPED_DIR", t_train.SHIPPED_DIR / "missing")
    params = tn._params("DeepFilterNet3")
    assert "RANDOM-INIT" in capsys.readouterr().out
    ref = j_flatten(J.init_params(0, J.DFNConfig.for_variant("DeepFilterNet3")))
    got = t_flatten(params)
    assert set(got) == set(ref) and all(np.abs(got[k] - np.asarray(ref[k])).max() <= 1e-6
                                        for k in ref)
