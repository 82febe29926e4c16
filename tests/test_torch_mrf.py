"""PyTorch port vs the JAX package: the fused HiFi-GAN MRF block.

The port's plain versions (what its kernels compute, and what runs for
CPU tensors) against the JAX package's Pallas kernels in interpret mode,
as ``tests/test_mrf_pallas.py`` runs them, with the weights of one flax
``MRF`` on both sides.  Tolerances are absolute, those of the JAX
package's own tests against its module path: 2e-4 in float32 (sums in
another order) and 3e-2 in bfloat16 (a rounding step of activations of
order 1 is 4e-3 to 8e-3, and either side may round on the other side of
a tie a few layers deep).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models.flashsr import vocoder as j_voc
from egregora_tpu.ops.mrf_pallas import mrf_fused_cm as j_fused_cm
from egregora_tpu.ops.mrf_pallas import pack_resblock_weights as j_pack
from egregora_tpu.ops.mrf_rows import mrf_rows as j_rows
from egregora_tpu.utils.weights import fast_init_like
from egregora_tpu_torch.models.flashsr import vocoder as t_voc
from egregora_tpu_torch.ops import mrf_fused, mrf_rows
from egregora_tpu_torch.utils.weights import module_from_jax

KERNELS, DILS = (3, 7, 11), (1, 3, 5)
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _mrf(c, seed):
    """A flax MRF's params (numpy) and the port's packed weights."""
    jm = j_voc.MRF(c, KERNELS, (DILS,) * 3, jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, c))))
    p = jax.tree_util.tree_map(np.asarray, fast_init_like(shapes, seed))
    tm = t_voc.MRF(c, KERNELS, (DILS,) * 3, torch.float32)
    tm.load_state_dict(module_from_jax(tm, p), strict=True)
    return p["params"], tm


def _x(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,block_t", [(384, 128), (300, None)])
def test_plain_fused_cm_matches_pallas(dtype, t, block_t):
    """Channel-major, every branch and the mean: one tile and three
    (the JAX halo framing), and a T that no tile divides."""
    c = 16
    params, tm = _mrf(c, seed=t)
    x = _x((2, c, t), 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    ref = j_fused_cm(xj, j_pack(params, KERNELS, DILS, dtype=jdt), KERNELS, DILS,
                     block_t=block_t, interpret=True)
    w, b = mrf_fused.pack_resblock_weights(tm, tdt)
    got = mrf_fused.mrf_fused_cm(torch.from_numpy(x).to(tdt), w, b, KERNELS, DILS)
    assert got.dtype == tdt and got.shape == (2, c, t)
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,tile", [(512, 128), (300, 4096)])
def test_plain_rows_matches_pallas(dtype, t, tile):
    """NWC, one branch a call and the mean of three, as ``mrf_rows``."""
    c = 16
    params, tm = _mrf(c, seed=t + 1)
    x = _x((2, t, c), 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = j_rows(jnp.asarray(x).astype(jdt), params, KERNELS, (DILS,) * 3, tile=tile,
                 interpret=True)
    w, b = mrf_fused.pack_resblock_weights(tm, tdt)
    got = mrf_rows.mrf_rows(torch.from_numpy(x).to(tdt), w, b, KERNELS, DILS)
    assert got.dtype == tdt and got.shape == (2, t, c)
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= TOL[dtype], err


def test_plain_versions_are_the_module_in_float32():
    """In float32 both roundings vanish: the two plain versions and the
    module path (``MRF.forward``) agree to float32 summation order."""
    c, t = 32, 200
    _, tm = _mrf(c, seed=5)
    x = torch.from_numpy(_x((1, c, t), 3))
    w, b = mrf_fused.pack_resblock_weights(tm, torch.float32)
    with torch.no_grad():
        ref = tm(x)
    fused = mrf_fused.mrf_fused_cm(x, w, b, KERNELS, DILS)
    rows = mrf_rows.mrf_rows(x.transpose(1, 2).contiguous(), w, b, KERNELS, DILS)
    assert (fused - ref).abs().max() <= 1e-5
    assert (rows.transpose(1, 2) - ref).abs().max() <= 1e-5
    assert mrf_fused.branch_halo(11, DILS) == 60 and mrf_fused.branch_halo(3, DILS) == 12


def _voc_cfgs(**kw):
    base = dict(n_mels=8, upsample_initial=32, upsample_factors=(2, 2, 3),
                upsample_kernels=(4, 4, 6), channel_floor=16)
    base.update(kw)
    return (j_voc.VocoderConfig(dtype=jnp.float32, **base),
            t_voc.VocoderConfig(dtype=torch.float32, **base))


def _vocoders(jc, tc, seed=1):
    jm = j_voc.SRVocoder(jc)
    mel = _x((2, 64, jc.n_mels), seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(mel)))
    p = jax.tree_util.tree_map(np.asarray, fast_init_like(shapes, seed))
    tm = t_voc.SRVocoder(tc)
    tm.load_state_dict(module_from_jax(tm, p), strict=True)
    return jm, p, tm.eval(), mel


@pytest.mark.parametrize("path", ["pallas", "rows"])
def test_apply_fused_matches_jax(monkeypatch, path):
    """The whole vocoder through ``apply_fused`` on a narrow config (three
    16-channel stages, T = 128, 256, 768, which the rows path's tiles
    divide): the port (plain versions on the CPU) against JAX
    (``interpret=True``), both in float32, within 2e-4, for each
    ``EGREGORA_MRF_PATH``."""
    jc, tc = _voc_cfgs()
    jm, p, tm, mel = _vocoders(jc, tc)
    monkeypatch.setenv("EGREGORA_MRF_PATH", path)
    ref = np.asarray(j_voc.apply_fused(p, jnp.asarray(mel), jc, interpret=True))
    with torch.no_grad():
        got = t_voc.apply_fused(tm, torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 64 * 12)
    assert np.abs(got - ref).max() <= 2e-4


def test_apply_fused_dispatch(monkeypatch):
    """Stages over 64 channels keep the module path and the rest go to
    ``mrf_fused_cm`` (the shapes it is called with are recorded); the
    result matches JAX's ``apply_fused``; heterogeneous dilations and
    the engines not ported raise."""
    jc, tc = _voc_cfgs(upsample_initial=256, channel_floor=16)
    jm, p, tm, mel = _vocoders(jc, tc, seed=2)
    calls = []
    real = t_voc.mrf_fused_cm
    monkeypatch.setattr(t_voc, "mrf_fused_cm",
                        lambda x, *a, **k: calls.append(tuple(x.shape)) or real(x, *a, **k))
    ref = np.asarray(j_voc.apply_fused(p, jnp.asarray(mel), jc, interpret=True))
    with torch.no_grad():
        got = t_voc.apply_fused(tm, torch.from_numpy(mel)).numpy()
    assert np.abs(got - ref).max() <= 2e-4
    assert calls == [(2, 64, 64 * 4), (2, 32, 64 * 12)]   # C=128 stage: module path
    for engine in ("dense", "packed"):
        monkeypatch.setenv("EGREGORA_MRF_PATH", engine)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_voc.apply_fused(tm, torch.from_numpy(mel))
    monkeypatch.delenv("EGREGORA_MRF_PATH")
    het = dataclasses.replace(tc, resblock_dilations=((1, 3, 5), (1, 3, 5), (2, 6, 12)))
    with pytest.raises(NotImplementedError, match="resblock_dilations"):
        t_voc.apply_fused(t_voc.SRVocoder(het), torch.from_numpy(mel))
