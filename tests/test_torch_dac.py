"""PyTorch port vs the JAX package: the DAC codec and its two nodes.

Same inputs (numpy, seeded) through ``egregora_tpu`` and
``egregora_tpu_torch`` on the CPU: the three shipped compact codecs
(``egregora_tpu/models/dac/pretrained_{16,24,44}khz.npz``) and the
published 44 kHz and 24 kHz geometries (76.6M and 74.1M parameters) with
seeded weights, on a few hops of input.  Tolerances:

* float32 (both sides built with ``dtype`` float32): pre-quantisation
  latents relative L2 <= 1e-4; codes identical on every stage and frame
  up to the first near-tie of the JAX package's distances (second-best
  minus best below ``TIE`` of the frame's squared residual: one flip
  there changes every later stage's residual); decode of the same latents
  relative L2 <= 1e-4;
* bf16, as served, on speech-like input: decode of the JAX package's
  latents relative L2 <= 2e-2, and roundtrip SNR within 0.5 dB of the
  JAX package's at each shipped rate (the planted unflipped transposed
  conv misses that limit by far).  The port's bf16 decode is as far from
  the JAX package's compiled one as the JAX package's own op-by-op run
  (``jax.disable_jit``) is: 7e-3 at 16 and 24 kHz, 1.6e-2 at 44 kHz (XLA
  keeps the bias adds that feed a Snake in float32); the encoders' bf16
  roundings flip 20-30% of the codes, so the encode nodes' latents are
  compared on the frames whose codes agree;
* a codes dict from the JAX encode node decodes in the port's decode
  node within the bf16 limit of its rate;
* name-mapped upstream weights: equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from egregora_tpu.models.dac import model as J
from egregora_tpu.models.dac import train as j_train
from egregora_tpu.nodes import enhance_extras as j_node
from egregora_tpu.utils.weights import _flatten as j_flatten
from egregora_tpu.utils.weights import convert_state_dict as j_convert
from egregora_tpu.utils.weights import save_params as j_save
from egregora_tpu_torch.models.dac import model as T
from egregora_tpu_torch.models.dac import train as t_train
from egregora_tpu_torch.models.flashsr import layers
from egregora_tpu_torch.nodes import enhance_extras as t_node
from egregora_tpu_torch.utils.weights import _flatten as t_flatten
from egregora_tpu_torch.utils.weights import convert_state_dict as t_convert
from egregora_tpu_torch.utils.weights import unflatten

RATES = ("16khz", "24khz", "44khz")
F32 = 1e-4
BF16_DECODE = 2e-2
SNR_DB = 0.5
TIE = 2e-6


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def t_cfg(jcfg, dtype):
    d = dataclasses.asdict(jcfg)
    d["dtype"] = dtype
    return T.DACConfig(**d)


def seeded_tree(jcfg, seed):
    """``chip_smoke.seeded_dac_tree`` for the JAX package's ``jcfg``: the
    flax tree (numpy leaves) both packages load."""
    return chip_smoke.seeded_dac_tree(t_cfg(jcfg, torch.float32), seed)


def signal(sr, seconds, channels, seed):
    """Seeded ``[C, S]``: gliding harmonics with a syllable envelope plus
    noise, loud from the first sample (a few hops of codec input)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = []
    for c in range(channels):
        ph = 2 * np.pi * np.cumsum(130 + 30 * c + 40 * np.sin(2 * np.pi * 3 * t + c)) / sr
        x = sum((0.25 / k) * np.sin(k * ph) for k in range(1, 8))
        out.append(x * (0.6 + 0.4 * np.sin(2 * np.pi * 9 * t)) + 0.03 * rng.standard_normal(t.size))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def shipped():
    out = {}
    for mt in RATES:
        (jcfg, jp), (tcfg, tp) = j_train.load_pretrained(mt), t_train.load_pretrained(mt)
        assert dataclasses.asdict(jcfg) | {"dtype": None} == dataclasses.asdict(tcfg) | {"dtype": None}
        assert tcfg.dtype == torch.bfloat16
        out[mt] = (jcfg, jp, tp)
    return out


def _jax_rvq_ties(jcfg, rvq_params, z, codes):
    """``[B, n_q, T]`` True where the JAX package's choice at that stage
    and frame, or an earlier stage's at that frame, was a near-tie (the
    RVQ replayed in float64 along the JAX codes)."""
    p = rvq_params["params"]
    residual = np.asarray(z, np.float64)
    tie = np.zeros(codes.shape, bool)
    for i in range(jcfg.n_codebooks):
        r = residual @ np.asarray(p[f"proj_in_{i}"]["kernel"], np.float64) + p[f"proj_in_{i}"]["bias"]
        book = np.asarray(p[f"codebook_{i}"], np.float64)
        d2 = (r ** 2).sum(-1, keepdims=True) - 2 * r @ book.T + (book ** 2).sum(-1)
        best = d2.argmin(-1)
        # the runner-up among codes of another value (trained codebooks
        # hold repeated entries, which both packages resolve to the first)
        other = (book[None, None] != book[best][..., None, :]).any(-1)
        margin = np.where(other, d2, np.inf).min(-1) - d2.min(-1)
        tie[:, i] = margin < TIE * ((r ** 2).sum(-1) + 1.0)
        q = book[codes[:, i]] @ np.asarray(p[f"proj_out_{i}"]["kernel"], np.float64)
        residual = residual - (q + p[f"proj_out_{i}"]["bias"])
    return np.logical_or.accumulate(tie, axis=1)


def _f32_case(jcfg, tree, x):
    """Encoder, RVQ and decoder of both packages in float32 on ``x [C, T]``."""
    j32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    jm = J.DACModel(j32)
    z = np.asarray(jax.jit(jm.encoder.apply)(tree["encoder"], jnp.asarray(x)[..., None]))
    zq, codes = (np.asarray(a) for a in jax.jit(jm.rvq.apply)(tree["rvq"], jnp.asarray(z)))
    y = np.asarray(jax.jit(jm.decoder.apply)(tree["decoder"], jnp.asarray(zq)))
    tm = T.DACModel(t_cfg(jcfg, torch.float32)).load_jax(tree)
    with torch.no_grad():
        zt = tm.encoder(torch.from_numpy(x)[:, None]).transpose(1, 2)
        zqt, ct = (a.numpy() for a in tm.rvq(zt))
    yt = tm.decode(torch.tensor(zq)).numpy()
    assert rel(zt.numpy(), z) <= F32
    ties = _jax_rvq_ties(jcfg, tree["rvq"], z, codes)
    assert ct.dtype == np.int64 and ct.shape == codes.shape
    assert (ct == codes)[~ties].all() and ties.mean() < 0.05
    if not ties.any():
        assert rel(zqt, zq) <= F32
    assert yt.shape == y.shape and rel(yt, y) <= F32


@pytest.mark.parametrize("mt", RATES)
def test_f32_matches_jax_shipped(shipped, mt):
    jcfg, jp, _ = shipped[mt]
    _f32_case(jcfg, jp, signal(jcfg.sample_rate, 24 * jcfg.hop / jcfg.sample_rate, 2, seed=1))


@pytest.mark.parametrize("mt", ["44khz", "24khz"])
def test_f32_matches_jax_published_geometry(mt):
    """The published geometry (upstream's strides, 64 -> 1024 encoder
    channels, 1536 decoder channels, 9 codebooks of dimension 8; at 24 kHz
    the stride-5 'SAME' convs pad (2, 3)) with seeded weights."""
    jcfg = J.MODEL_TYPES[mt]
    tree = seeded_tree(jcfg, seed=3)
    assert sum(v.size for v in jax.tree_util.tree_leaves(tree)) == {
        "44khz": 76_620_777, "24khz": 74_064_873}[mt]
    _f32_case(jcfg, tree, signal(jcfg.sample_rate, 3 * jcfg.hop / jcfg.sample_rate, 1, seed=2))


def _unflipped_transposes(tm):
    """The planted fault: every transposed conv's kernel left as flax
    stores it (not flipped along k)."""
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, layers.ConvTranspose1d):
                m.weight.copy_(m.weight.flip(2))


@pytest.mark.parametrize("mt", RATES)
def test_bf16_decode_matches_jax(shipped, mt):
    """As served (bf16 convs): decode of the JAX package's latents, and the
    roundtrip SNR on 0.3 s of speech-like stereo."""
    jcfg, jp, tp = shipped[mt]
    jm, tm = J.DACModel(jcfg), T.DACModel(t_cfg(jcfg, torch.bfloat16)).load_jax(tp)
    x = signal(jcfg.sample_rate, 0.3, 2, seed=4).astype(np.float32)
    zq, _ = jm.encode(jp, jnp.asarray(x))
    y = np.asarray(jm.decode(jp, zq))
    yt = tm.decode(torch.from_numpy(np.asarray(zq))).numpy()
    assert yt.shape == y.shape and rel(yt, y) <= BF16_DECODE
    snr_j = j_train.roundtrip_snr_db(jm, jp, x)
    snr_t = t_train.roundtrip_snr_db(tm, x)
    assert snr_j > 3.0 and abs(snr_t - snr_j) <= SNR_DB, (snr_t, snr_j)
    _unflipped_transposes(tm)
    assert rel(tm.decode(torch.from_numpy(np.asarray(zq))).numpy(), y) > 10 * BF16_DECODE


def test_conv1d_stride_same_pads_match_flax():
    """``layers.Conv1d`` with ``stride``: flax 'SAME' at kernel 2s, stride
    s, which pads (2, 3) at s = 5; stride 1 keeps its results."""
    import flax.linen as nn
    rng = np.random.default_rng(8)
    for s, t in ((5, 40), (5, 37), (2, 16), (8, 64), (4, 30)):
        x = rng.standard_normal((2, t, 6)).astype(np.float32)
        conv = nn.Conv(4, (2 * s,), strides=(s,), dtype=jnp.float32)
        v = conv.init(jax.random.PRNGKey(s), jnp.asarray(x))
        ref = np.asarray(conv.apply(v, jnp.asarray(x)))
        c = layers.Conv1d(6, 4, 2 * s, 1, torch.float32, stride=s)
        with torch.no_grad():
            c.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(2, 1, 0)))
            c.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
            got = c(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5
    assert layers.same_pads(40, 10, 5) == (2, 3)


def test_snake_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 50, 3)).astype(np.float32) * 3
    alpha = np.array([0.01, 0.7, 2.0], np.float32)
    for floor in (0.0, 0.05):
        ref = np.asarray(J.snake(jnp.asarray(x), jnp.asarray(alpha), floor))
        got = T.snake(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(alpha), floor)
        assert np.abs(got.transpose(1, 2).numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_name_map_converts_bit_for_bit():
    """``test_weights.py``'s DAC layout (Snake1d alphas ``[1, C, 1]``,
    1x1-conv projections, transposed-conv ``[in, out, k]``) through both
    packages' name maps and converters, bit for bit; the result loads."""
    cfg = J.DACConfig(encoder_dim=8, strides=(2, 4), decoder_dim=64, n_codebooks=2)
    target = seeded_tree(cfg, seed=0)
    flat = j_flatten(target)
    raw = J.dac_name_map(cfg).__self__
    rng = np.random.default_rng(11)
    sd = {}
    for tk, fk in raw.items():
        tr = fk[1] if isinstance(fk, tuple) else None
        w = rng.standard_normal(flat[fk[0] if tr is not None else fk].shape).astype(np.float32)
        if callable(tr):
            sd[tk] = w.reshape(1, -1, 1) if tk.endswith("alpha") else w.T[:, :, None]
        elif tr is not None:
            sd[tk] = np.transpose(w, np.argsort(tr))
        elif tk.endswith("codebook.weight") or w.ndim == 1:
            sd[tk] = w
        elif w.ndim == 2:
            sd[tk] = w.T
        else:
            sd[tk] = np.transpose(w, (2, 1, 0))
    tcfg = t_cfg(cfg, torch.float32)
    assert set(T.dac_name_map(tcfg).__self__) == set(raw)
    ref = j_flatten(j_convert(sd, target, name_map=J.dac_name_map(cfg)))
    got = t_flatten(t_convert(sd, target, name_map=T.dac_name_map(tcfg)))
    assert set(got) == set(ref) == set(flat)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    T.DACModel(tcfg).load_jax(unflatten(got))


def test_params_from_jax_refuses_a_wrong_tree(shipped):
    jcfg, jp, _ = shipped["16khz"]
    with pytest.raises(KeyError):
        T.dac_params_from_jax(t_cfg(jcfg, torch.float32), {**jp, "extra": {}})
    bad = {**jp, "rvq": {"params": {**jp["rvq"]["params"], "codebook_99": np.zeros((4, 16))}}}
    with pytest.raises(KeyError):
        T.dac_params_from_jax(t_cfg(jcfg, torch.float32), bad)


# ---------------------------------------------------------------- build_dac

TINY = dict(encoder_dim=4, strides=(2, 5), decoder_dim=32, n_codebooks=2, codebook_size=16,
            codebook_dim=4)


@pytest.fixture()
def fresh_caches(monkeypatch, tmp_path):
    """Both packages' DAC caches emptied, and a weights root of its own."""
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    for mod in (J, T):
        monkeypatch.setattr(mod, "_CACHE", {})
    for node in (j_node.Egregora_DAC_Encode, t_node.Egregora_DAC_Encode):
        monkeypatch.setattr(node, "_MODELS", {})
    monkeypatch.setattr(t_node.Egregora_DAC_Encode, "DEVICE", "cpu")
    monkeypatch.setattr(t_node.Egregora_DAC_Decode, "DEVICE", "cpu")
    return tmp_path


def test_build_dac_resolves_converted_then_shipped_then_random(fresh_caches, monkeypatch,
                                                               capsys):
    jcfg = J.DACConfig(sample_rate=16000, dtype=jnp.float32, **TINY)
    monkeypatch.setitem(J.MODEL_TYPES, "16khz", jcfg)
    monkeypatch.setitem(T.MODEL_TYPES, "16khz", t_cfg(jcfg, torch.float32))
    tree = seeded_tree(jcfg, seed=5)
    j_save(tree, fresh_caches / "dac_16khz.npz")
    jm, jp, jsr = J.build_dac("16khz")
    tm, tsr = T.build_dac("16khz")
    assert tm.weight_source == "converted" and tsr == jsr == 16000
    assert T.build_dac("16khz")[0] is tm
    x = signal(16000, 0.05, 1, seed=6).astype(np.float32)
    zq, codes = jm.encode(jp, jnp.asarray(x))
    zqt, ct = tm.encode(torch.from_numpy(x))
    assert (ct.numpy() == np.asarray(codes)).all() and rel(zqt.numpy(), zq) <= F32

    got, _ = T.build_dac("24khz")
    assert got.weight_source == "shipped" and got.cfg == t_train.load_pretrained("24khz")[0]

    monkeypatch.setitem(t_train.PRETRAINED, "44khz", fresh_caches / "missing.npz")
    monkeypatch.setitem(T.MODEL_TYPES, "44khz", T.DACConfig(sample_rate=44100, **TINY))
    rnd, _ = T.build_dac("44khz")
    assert rnd.weight_source == "random" and "RANDOM-INIT" in capsys.readouterr().out
    assert not rnd.decoder.Conv_1.weight.detach().any()
    with pytest.raises(ValueError):
        T.build_dac("8khz")


# ---------------------------------------------------------------- nodes

def test_node_contracts():
    for key in ("Egregora_DAC_Encode", "Egregora_DAC_Decode"):
        tn, jn = t_node.NODE_CLASS_MAPPINGS[key], j_node.NODE_CLASS_MAPPINGS[key]
        assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
        assert t_node.NODE_DISPLAY_NAME_MAPPINGS[key] == j_node.NODE_DISPLAY_NAME_MAPPINGS[key]
        for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
            assert getattr(tn, attr) == getattr(jn, attr)
        assert tn.DEVICE == "cuda"


@pytest.mark.parametrize("mt,sr", [("16khz", 48000), ("24khz", 24000), ("44khz", 44100)])
def test_nodes_match_jax(fresh_caches, mt, sr):
    """The encode nodes' codes dicts agree (layout, rates, log; the codes
    mostly, and the latents where a frame's codes do); the JAX node's dict decodes in the
    port's decode node (not cropped to the input's length) within the
    rate's bf16 limit of the JAX decode node."""
    x = signal(sr, 0.25, 2, seed=7).astype(np.float32)
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": sr}
    jd, jlog = j_node.Egregora_DAC_Encode().execute(audio, model_type=mt, device="cuda")
    td, tlog = t_node.Egregora_DAC_Encode().execute(audio, model_type=mt)
    assert tlog == jlog and set(td) == set(jd)
    for k in ("model_type", "sample_rate", "model_sample_rate"):
        assert td[k] == jd[k]
    zj, zt = np.asarray(jd["latents"][0][0]), td["latents"][0][0]
    assert isinstance(zt, np.ndarray) and zt.shape == zj.shape and zt.dtype == np.float32
    cj, ct = np.asarray(jd["codes"]), td["codes"]
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    same = (ct == cj).all(1)                       # [C, frames]: every stage agrees
    assert (ct == cj).mean() >= 0.6 and same.any()
    assert rel(zt[same], zj[same]) <= F32
    (ref, rlog) = j_node.Egregora_DAC_Decode().execute(jd, device="cpu")
    (got, glog) = t_node.Egregora_DAC_Decode().execute(jd)
    assert glog == rlog and got["sample_rate"] == ref["sample_rate"] == sr
    gw, rw = got["waveform"].numpy(), np.asarray(ref["waveform"])
    assert gw.shape == rw.shape and gw.shape[-1] >= x.shape[-1]
    assert rel(gw, rw) <= BF16_DECODE
    assert t_node.Egregora_DAC_Encode._MODELS[mt][0].weight_source == "shipped"
    with pytest.raises(ValueError):
        t_node.Egregora_DAC_Decode().execute({"model_type": mt, "latents": []})


# ---------------------------------------------------------------- layout

SMALL = dict(encoder_dim=8, decoder_dim=32, n_codebooks=2, codebook_size=16, codebook_dim=4)


def _small_codec(mt):
    """A float32 codec at a small width with the rate's strides (the 16 and
    24 kHz codecs' stride-5 convs pad (2, 3)) and seeded weights."""
    cfg = dataclasses.replace(T.MODEL_TYPES[mt], dtype=torch.float32, **SMALL)
    return T.DACModel(cfg).load_jax(seeded_tree(cfg, seed=12))


def _clip(model, frames=6, seed=13):
    sr = model.cfg.sample_rate
    return torch.from_numpy(signal(sr, frames * model.cfg.hop / sr, 2, seed))


def _is_nwc(t):
    return t.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("mt", RATES)
def test_channels_last_matches_ncw(monkeypatch, mt):
    """The encoder and the decoder channels-last against the same modules
    run in NCW by the shared layers' ``forward`` (what the DAC ran before
    its own convs): float32 within ``F32``."""
    model, x = _small_codec(mt), None
    x = _clip(model)[:, None]
    with torch.no_grad():
        z = model.encoder(x)
        y = model.decoder(z)
        monkeypatch.setattr(T.Conv1dNWC, "forward", layers.Conv1d.forward)
        monkeypatch.setattr(T.ConvTranspose1dNWC, "forward", layers.ConvTranspose1d.forward)
        monkeypatch.setattr(T, "nwc", lambda t: t.contiguous())
        z0 = model.encoder(x)
        y0 = model.decoder(z0)
    assert _is_nwc(z) and z0.is_contiguous() and not z0.transpose(1, 2).is_contiguous()
    assert z.shape == z0.shape and rel(z.numpy(), z0.numpy()) <= F32
    assert y.shape == y0.shape and rel(y.numpy(), y0.numpy()) <= F32


@pytest.mark.parametrize("mt", RATES)
def test_every_activation_is_channels_last(mt):
    """A forward hook on each of the DAC's convs and Snakes sees every input
    and output channels-last; ``encode`` hands the quantizer a contiguous
    ``[C, T, D]`` and ``decode`` returns a contiguous ``[C, T]``."""
    model = _small_codec(mt)
    seen = []

    def hook(mod, args, out):
        seen.append((type(mod).__name__, _is_nwc(args[0]), _is_nwc(out)))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (T.Conv1dNWC, T.ConvTranspose1dNWC, T.Snake))]
    x = _clip(model)
    z = model.encoder(model.preprocess(x)[:, None]).transpose(1, 2)
    zq, _ = model.encode(x)
    y = model.decode(zq)
    for h in hooks:
        h.remove()
    n = len(model.cfg.strides)
    per_side = (7 * n + 1) + (7 * n + 2)              # Snakes and convs of encoder or decoder
    assert len(seen) == 3 * per_side                  # the encoder twice, the decoder once
    assert all(a and b for _, a, b in seen), [s for s in seen if not all(s[1:])]
    assert z.is_contiguous() and zq.is_contiguous() and y.is_contiguous()


@pytest.mark.parametrize("mt", RATES)
def test_a_call_makes_no_layout_copy(mt):
    """``dac_layout_copies`` reads 0 over an ``encode`` + ``decode`` in
    ``profiling.recording()``; an NCW activation handed to a DAC conv or
    Snake is copied to channels-last, counted once, with the same
    numbers."""
    from egregora_tpu_torch.utils import profiling
    model = _small_codec(mt)
    x = _clip(model)

    def copies():
        return profiling.counters().get("dac_layout_copies", 0)

    with torch.no_grad(), profiling.recording():
        before = copies()
        model.decode(model.encode(x)[0])
        assert copies() == before
        conv, snake = model.decoder.Conv_0, model.decoder.DecoderBlock_0.Snake_0
        h = torch.randn(2, conv.weight.shape[1], 5, generator=torch.Generator().manual_seed(14))
        for mod in (conv, snake):
            before = copies()
            got = mod(h)
            assert copies() == before + 1 and _is_nwc(got)
            assert torch.equal(got, mod(h.transpose(1, 2).contiguous().transpose(1, 2)))
            assert copies() == before + 1
            h = got.contiguous()


def test_dac_convs_match_flax():
    """The DAC's own conv modules against flax on channels-last input:
    'SAME' at kernel 2s and stride s (pads (2, 3) at s = 5), a dilated
    7-tap conv, and ``ConvTranspose`` at kernel 2s, stride s (flax's
    window cut by the call's padding; at odd s the last sample cropped)."""
    import flax.linen as nn
    rng = np.random.default_rng(15)

    def load(mod, v, flip=False):
        k = np.asarray(v["params"]["kernel"])
        w = np.flip(k, 0).transpose(1, 2, 0) if flip else k.transpose(2, 1, 0)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            mod.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
        return mod

    for s, t in ((5, 40), (2, 16), (8, 64), (4, 28)):
        x = rng.standard_normal((2, t, 6)).astype(np.float32)
        xt = torch.from_numpy(x).transpose(1, 2)            # channels-last [B, C, T]
        for flax_mod, mod, flip in (
                (nn.Conv(4, (2 * s,), strides=(s,)), T.Conv1dNWC(6, 4, 2 * s, 1, torch.float32,
                                                                  stride=s), False),
                (nn.Conv(4, (7,), kernel_dilation=(3,)), T.Conv1dNWC(6, 4, 7, 3, torch.float32),
                 False),
                (nn.ConvTranspose(4, (2 * s,), strides=(s,)),
                 T.ConvTranspose1dNWC(6, 4, 2 * s, s, torch.float32), True)):
            v = flax_mod.init(jax.random.PRNGKey(s), jnp.asarray(x))
            v = jax.tree_util.tree_map(lambda a: a + 0.1, v)      # nonzero biases
            ref = np.asarray(flax_mod.apply(v, jnp.asarray(x)))
            with torch.no_grad():
                got = load(mod, v, flip)(xt)
            assert _is_nwc(got), type(mod).__name__
            got = got.transpose(1, 2).numpy()
            assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5, (s, type(mod))
    with pytest.raises(ValueError, match="not inside the full output"):
        T.ConvTranspose1dNWC(6, 4, 3, 8, torch.float32)      # a window the padding cannot cut
