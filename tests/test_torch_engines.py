"""PyTorch port vs the JAX package: the engine switches.

The MRF layout engines (``ops.mrf_dense``, ``ops.mrf_packed``) and the
vocoder's ``apply_fused`` under ``EGREGORA_MRF_PATH=dense`` and
``=packed`` at an even and an odd batch, with the weights of one flax
tree on both sides, in float32 within 2e-4 (the JAX package's own limit
against its module path: sums in another order); the JAX side's Pallas
kernel (the packed path's odd batch) runs with ``interpret=True``.  The
attention engines under ``EGREGORA_ATTN_PATH`` x ``EGREGORA_ATTN_BLOCK``
x ``EGREGORA_ATTN_SCORES``, against the JAX ``mha`` under the same
variables, in float32 within 2e-5, and with bf16 scores within 5e-4
(both round float32 logits to bf16, summed in another order: a logit
near a rounding boundary can round the other way, which moves its weight
by 2^-8 relative; the largest such move seen is 1.5e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models.flashsr import vocoder as j_voc
from egregora_tpu.ops import attention as j_att
from egregora_tpu.ops import mrf_dense as j_dense
from egregora_tpu.ops import mrf_packed as j_packed
from egregora_tpu.ops.mrf_pallas import pack_resblock_weights as j_pack
from egregora_tpu.utils.weights import fast_init_like
from egregora_tpu_torch.models.flashsr import vocoder as t_voc
from egregora_tpu_torch.ops import attention as t_att
from egregora_tpu_torch.ops import attn_rows as ar
from egregora_tpu_torch.ops import mrf_dense, mrf_fused, mrf_packed
from egregora_tpu_torch.utils.weights import module_from_jax

KERNELS, DILS = (3, 7, 11), (1, 3, 5)
TOL = 2e-4


def _x(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _mrf(c, seed):
    jm = j_voc.MRF(c, KERNELS, (DILS,) * 3, jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, c))))
    p = jax.tree_util.tree_map(np.asarray, fast_init_like(shapes, seed))
    tm = t_voc.MRF(c, KERNELS, (DILS,) * 3, torch.float32)
    tm.load_state_dict(module_from_jax(tm, p), strict=True)
    return p["params"], tm


def test_mrf_dense_matches_jax():
    c, t = 16, 200
    params, tm = _mrf(c, seed=3)
    x = _x((2, c, t), 1)
    ref = np.asarray(j_dense.mrf_dense_cm(jnp.asarray(x), j_pack(params, KERNELS, DILS,
                                                                 dtype=jnp.float32),
                                          KERNELS, DILS))
    w, b = mrf_fused.pack_resblock_weights(tm, torch.float32)
    got = mrf_dense.mrf_dense_cm(torch.from_numpy(x), w, b, KERNELS, DILS)
    assert got.shape == (2, c, t) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= TOL


def test_pack_unpack_item_order():
    """Items that differ: item ``gi*m + mi`` lands in packed item ``mi``'s
    channel block ``gi``, as in the JAX package, and unpacking inverts it."""
    x = np.arange(6 * 5 * 3, dtype=np.float32).reshape(6, 5, 3)
    got = mrf_packed.pack_batch(torch.from_numpy(x), 2)
    ref = np.asarray(j_packed.pack_batch(jnp.asarray(x), 2))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got[1, :, 3:], torch.from_numpy(x[4]))      # gi = 1, mi = 1, m = 3
    np.testing.assert_array_equal(mrf_packed.unpack_batch(got, 2).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(j_packed.unpack_batch(jnp.asarray(ref), 2)), x)
    with pytest.raises(ValueError):
        mrf_packed.pack_batch(torch.from_numpy(x[:5]), 2)


@pytest.mark.parametrize("d,k,cout", [(1, 3, 8), (3, 7, 8), (1, 7, 1)])
def test_conv_packed_matches_jax(d, k, cout):
    rng = np.random.default_rng(k + d)
    a = _x((3, 50, 2 * 8), k)
    w = (0.3 * rng.standard_normal((k, 8, cout))).astype(np.float32)     # flax [k, Ci, Co]
    bias = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(j_packed.conv_packed(jnp.asarray(a), jnp.asarray(w), jnp.asarray(bias),
                                          d, 2))
    got = mrf_packed.conv_packed(torch.from_numpy(a), torch.from_numpy(w).permute(2, 1, 0),
                                 torch.from_numpy(bias), d, 2)
    assert got.shape == ref.shape == (3, 50, 2 * cout)
    assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_mrf_packed_matches_jax():
    c, t = 16, 120
    params, tm = _mrf(c, seed=4)
    xp = _x((2, t, 2 * c), 2)
    ref = np.asarray(j_packed.mrf_packed(jnp.asarray(xp), params, 2, KERNELS, DILS))
    with torch.no_grad():
        got = mrf_packed.mrf_packed(torch.from_numpy(xp), tm, 2, KERNELS, DILS)
    assert np.abs(got.numpy() - ref).max() <= TOL


def _vocoders(batch, seed=1):
    base = dict(n_mels=8, upsample_initial=256, upsample_factors=(2, 2, 3),
                upsample_kernels=(4, 4, 6), resblock_kernels=(3, 7),
                resblock_dilations=((1, 3),) * 2, channel_floor=16)
    jc = j_voc.VocoderConfig(dtype=jnp.float32, **base)
    tc = t_voc.VocoderConfig(dtype=torch.float32, **base)
    jm = j_voc.SRVocoder(jc)
    mel = _x((batch, 24, jc.n_mels), seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(mel)))
    p = jax.tree_util.tree_map(np.asarray, fast_init_like(shapes, seed))
    tm = t_voc.SRVocoder(tc)
    tm.load_state_dict(module_from_jax(tm, p), strict=True)
    return jc, p, tm.eval(), mel


@pytest.mark.parametrize("path,batch", [("dense", 2), ("dense", 3), ("packed", 2),
                                        ("packed", 3)])
def test_apply_fused_engines_match_jax(monkeypatch, path, batch):
    """A 128-channel first stage (module path) and two narrow ones (64 and
    32 channels; two branches of two dilations, to keep JAX's compile
    short) through ``apply_fused`` under the engine, against the JAX
    ``apply_fused`` under the same variable; the stages each engine takes
    are recorded: dense the narrow ones, packed the narrow ones at an even
    batch (the last through the post conv), the fused kernel's plain
    version at an odd one."""
    jc, p, tm, mel = _vocoders(batch, seed=batch)
    monkeypatch.setenv("EGREGORA_MRF_PATH", path)
    calls = []
    for name in ("mrf_dense_cm", "mrf_fused_cm", "mrf_packed", "conv_packed"):
        real = getattr(t_voc, name)
        monkeypatch.setattr(t_voc, name, lambda x, *a, _r=real, _n=name, **k:
                            calls.append((_n, tuple(x.shape))) or _r(x, *a, **k))
    ref = np.asarray(j_voc.apply_fused(p, jnp.asarray(mel), jc, interpret=True))
    with torch.no_grad():
        got = t_voc.apply_fused(tm, torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (batch, 24 * 12)
    assert np.abs(got - ref).max() <= TOL
    if path == "dense":
        want = [("mrf_dense_cm", (batch, 64, 96)), ("mrf_dense_cm", (batch, 32, 288))]
    elif batch % 2 == 0:
        want = [("mrf_packed", (1, 96, 128)), ("mrf_packed", (1, 288, 64)),
                ("conv_packed", (1, 288, 64))]
    else:
        want = [("mrf_fused_cm", (batch, 64, 96)), ("mrf_fused_cm", (batch, 32, 288))]
    assert calls == want


def _qkv(b, h, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("path,block,scores", [
    ("chunked", "", ""), ("unroll", "", ""), ("chunked", "64", ""), ("unroll", "96", ""),
    ("chunked", "", "bf16"), ("unroll", "64", "bf16"), ("auto", "", ""), ("auto", "", "bf16"),
])
def test_mha_engines_match_jax(monkeypatch, path, block, scores):
    """``auto`` on the CPU is the chunked engine in both packages."""
    for key, val in (("EGREGORA_ATTN_PATH", path), ("EGREGORA_ATTN_BLOCK", block),
                     ("EGREGORA_ATTN_SCORES", scores)):
        monkeypatch.setenv(key, val) if val else monkeypatch.delenv(key, raising=False)
    q, k, v = _qkv(2, 3, 200, 32, seed=len(path) + len(block))
    ref = np.asarray(j_att.mha(*(jnp.asarray(t) for t in (q, k, v))))
    before = ar.launches
    got = t_att.mha(*(torch.from_numpy(t) for t in (q, k, v)))
    assert ar.launches == before and got.shape == (2, 3, 200, 32)
    assert np.abs(got.numpy() - ref).max() <= (5e-4 if scores else 2e-5)


@pytest.mark.parametrize("path", ["palas", "rows", "flash", ""])
def test_mha_rejects_unknown_path(monkeypatch, path):
    """A misspelt ``EGREGORA_ATTN_PATH`` raises instead of leaving the
    kernel path for a plain engine without a word."""
    monkeypatch.setenv("EGREGORA_ATTN_PATH", path)
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 1, 16, 8, seed=1))
    with pytest.raises(ValueError, match="EGREGORA_ATTN_PATH"):
        t_att.mha(q, k, v)


def test_mha_bf16_scores_round_the_logits_and_block_is_tiling(monkeypatch):
    """Under ``SCORES=bf16`` the engines round the QK product (the output
    moves, by less than 1e-2 here); the block changes nothing but the
    tiling; the pallas path (the kernel's plain version on the CPU) ignores
    both, as the JAX pallas path does."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 150, 32, seed=9))
    monkeypatch.setenv("EGREGORA_ATTN_PATH", "chunked")
    exact = t_att.mha(q, k, v)
    monkeypatch.setenv("EGREGORA_ATTN_BLOCK", "32")
    assert (t_att.mha(q, k, v) - exact).abs().max() <= 1e-6
    monkeypatch.setenv("EGREGORA_ATTN_SCORES", "bf16")
    rounded = t_att.mha(q, k, v)
    assert 0 < (rounded - exact).abs().max() < 1e-2
    monkeypatch.setenv("EGREGORA_ATTN_PATH", "pallas")
    kernel_path = t_att.mha(q, k, v)
    plain = ar.attn_rows_plain(q.reshape(2, 150, 32), k.reshape(2, 150, 32),
                               v.reshape(2, 150, 32)).reshape(1, 2, 150, 32)
    assert torch.equal(kernel_path, plain)


def test_chunked_scales_q_first_in_its_dtype():
    """The JAX engines scale q before the product, in q's dtype; in bf16
    that rounding shows (the kernel's plain version scales after)."""
    q, k, v = (torch.from_numpy(t[0]).to(torch.bfloat16) for t in _qkv(1, 1, 64, 32, seed=2))
    got = t_att.chunked_attention(q, k, v)
    qs = (q * 32 ** -0.5).float()
    s = qs @ k.float().transpose(1, 2)
    want = (torch.softmax(s, -1).to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16)
    assert torch.equal(got, want)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    ref = np.asarray(j_att.chunked_attention(jq, jk, jv).astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() <= 2 ** -7
