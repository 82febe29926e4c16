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
    result matches JAX's ``apply_fused``; the dense and packed engines
    (at this even batch) take those stages off the kernel with the same
    result; heterogeneous dilations raise."""
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
    for engine in ("dense", "packed"):      # batch 2: both keep the narrow stages off the kernel
        monkeypatch.setenv("EGREGORA_MRF_PATH", engine)
        calls.clear()
        with torch.no_grad():
            other = t_voc.apply_fused(tm, torch.from_numpy(mel)).numpy()
        assert calls == [] and np.abs(other - ref).max() <= 2e-4
    monkeypatch.delenv("EGREGORA_MRF_PATH")
    het = dataclasses.replace(tc, resblock_dilations=((1, 3, 5), (1, 3, 5), (2, 6, 12)))
    with pytest.raises(NotImplementedError, match="resblock_dilations"):
        t_voc.apply_fused(t_voc.SRVocoder(het), torch.from_numpy(mel))


# ---- the bf16 core's tile plan (csrc/mrf_core.cuh, mirrored by
# mrf_fused.bf16_plan; the card tests hold it to mrf_bf16_layout) ----

# (C, T, halo, branches, channel-major) -> (channels run, time tile,
# shared memory bytes, weight slots, wgmma N, taps a slice, leaky tile) at the main
# paths' shapes: the fused entry (three branches, halo 60) and each rows
# launch (one branch, halo 12 / 36 / 60 for k = 3 / 7 / 11)
MAIN_PLANS = {
    (16, 245760, 60, 3, True): (16, 896, 194688, 8, 16, 16, 1),
    (32, 40960, 60, 3, True): (32, 640, 223264, 2, 32, 8, 1),
    (64, 5120, 60, 3, True): (64, 288, 231456, 2, 64, 2, 1),
    (64, 245760, 60, 3, True): (64, 288, 231456, 2, 64, 2, 1),
    (64, 245760, 60, 1, False): (64, 384, 230432, 2, 64, 2, 1),
    (64, 245760, 12, 1, False): (64, 384, 226368, 4, 64, 2, 1),
    (128, 40960, 60, 1, False): (128, 128, 230432, 2, 128, 1, 1),
    (128, 40960, 36, 1, False): (128, 128, 226368, 4, 128, 1, 1),
    (256, 5120, 60, 1, False): (256, 64, 230432, 2, 128, 1, 0),
    (256, 5120, 12, 1, False): (256, 128, 230464, 4, 128, 1, 0),
}


@pytest.mark.parametrize("key", sorted(MAIN_PLANS))
def test_bf16_plan_at_the_main_path_shapes(key):
    """The tile the core takes at each main-path shape: a multiple of 16
    within 227 KB, 288 threads, C padded to 16, 32 or a multiple of 64,
    wgmma N = C up to 128 and 128 above, taps a weight slice as the
    layout allows."""
    c, t, halo, nb, cm = key
    plan = mrf_fused.bf16_plan(c, t, halo, nb, cm)
    assert plan is not None and plan.threads == 288
    assert plan.tt % 16 == 0 and plan.smem_bytes <= mrf_fused.SMEM_LIMIT
    assert (plan.c, plan.tt, plan.smem_bytes, plan.stages, plan.nc, plan.q, plan.lk) == MAIN_PLANS[key]


def test_bf16_plan_widths_and_limits():
    """``kernel_width`` pads C to what the core runs; short signals take a
    tile no longer than T needs; the widest channel counts shrink the tile
    to 16 samples and, past what fits 227 KB, have no plan, which the
    wrappers' ``check_tile`` turns into a ValueError."""
    widths = {c: mrf_fused.kernel_width(c) for c in (1, 8, 16, 17, 24, 32, 33, 48, 64, 65,
                                                      128, 192, 256, 320, 321)}
    assert widths == {1: 16, 8: 16, 16: 16, 17: 32, 24: 32, 32: 32, 33: 64, 48: 64, 64: 64,
                      65: 128, 128: 128, 192: 192, 256: 256, 320: 320, 321: 384}
    assert mrf_fused.bf16_plan(64, 1, 60, 3, True).tt == 16
    assert mrf_fused.bf16_plan(64, 100, 60, 3, True).tt == 112
    assert mrf_fused.bf16_plan(320, 4096, 60, 3, True).tt == 16
    assert mrf_fused.bf16_plan(336, 4096, 60, 3, True) is None
    x = torch.zeros(1, 336, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no bf16 tile"):
        mrf_fused.check_tile("mrf_fused_cm", x, 336, 8, KERNELS, DILS, cm=True)
    mrf_fused.check_tile("mrf_fused_cm", x.float(), 336, 8, KERNELS, DILS, cm=True)   # f32: no tile
    for c in (16, 32, 64, 128, 256):
        tts = [mrf_fused.bf16_plan(c, 10 ** 6, h, 3, True).tt for h in (12, 36, 60)]
        assert tts == sorted(tts, reverse=True)


def _leaky(v):
    return torch.nn.functional.leaky_relu(v, 0.1)


def _tiled_schedule(x, w, bias, kernels, dils, tt):
    """The bf16 core's schedule in float32 on the CPU, block by block: a
    tile of ``HL + TT + H`` rows (HL: the halo rounded up to 8; rows
    rounded up to 16) loaded with zeros outside [0, T); each conv computes
    rows ``[HL - reach, +64 ceil((TT + 2 reach) / 64))`` of its output
    (reach: what the rest of the chain still needs), clamps reads past the
    tile to its last row and drops writes past it, and re-zeroes rows
    outside the signal; ``tmp`` starts as NaN, so a needed row that reads
    a row no conv wrote comes out NaN."""
    b, c, t = x.shape
    nd = len(dils)
    halo = max(mrf_fused.branch_halo(k, dils) for k in kernels)
    hl = -(-halo // 8) * 8
    rows = -(-(hl + tt + halo) // 16) * 16
    y = torch.empty_like(x)
    for t0 in range(0, t, tt):
        idx = torch.arange(rows) + t0 - hl
        inside = (idx >= 0) & (idx < t)
        tile = torch.zeros(b, c, rows)
        tile[..., inside] = x[..., idx[inside]]
        acc = None
        for bi, wb in enumerate(mrf_fused.branch_weights(w, c, kernels, nd)):
            k = kernels[bi]
            hw = (k - 1) // 2
            reach = mrf_fused.branch_halo(k, dils)
            cur, tmp = tile.clone(), torch.full_like(tile, float("nan"))
            for m, d in enumerate(dils):
                for u in (0, 1):
                    dd = 1 if u else d
                    reach -= hw * dd
                    lo = hl - reach
                    rr = torch.arange(lo, min(lo + 64 * -(-(tt + 2 * reach) // 64), rows))
                    src = tmp if u else _leaky(cur)
                    out = bias[bi, m, u][:, None].expand(b, c, len(rr)).clone()
                    for j in range(k):
                        ij = (rr + j * dd - hw * dd).clamp(max=rows - 1)
                        out = out + torch.einsum("oi,bir->bor", wb[m, u, j], src[..., ij])
                    keep = inside[rr]
                    if u:
                        cur[..., rr] = torch.where(keep, cur[..., rr] + out, 0.0)
                    else:
                        tmp[..., rr] = torch.where(keep, _leaky(out), 0.0)
            h = cur[..., hl: hl + tt]
            acc = h if acc is None else acc + h
        y[..., t0: t0 + tt] = (acc / len(kernels))[..., : min(tt, t - t0)]
    return y


@pytest.mark.parametrize("c,t,kernels,dils,tt", [
    (16, 2 * 896 + 37, KERNELS, DILS, None), (24, 300, (3, 5), (1, 2), None),
    (16, 333, (3, 5, 7, 9), (1, 3, 5, 7), None), (16, 200, KERNELS, DILS, 16),
    (16, 77, KERNELS, DILS, 64)])
def test_tiled_schedule_is_the_block(c, t, kernels, dils, tt):
    """The core's tile schedule (time tile from ``bf16_plan`` or forced)
    computes the plain block: every row of every tile gets its exact
    receptive field, whatever the tile's edges, the schedule and the
    rounding of the conv windows to 64-row M tiles."""
    gen = torch.Generator().manual_seed(c + t)
    nd = len(dils)
    w = torch.randn(2 * nd * sum(kernels) * c * c, generator=gen) / (5 * c) ** 0.5
    bias = 0.1 * torch.randn(len(kernels), nd, 2, c, generator=gen)
    x = 0.5 * torch.randn(2, c, t, generator=gen)
    halo = max(mrf_fused.branch_halo(k, dils) for k in kernels)
    tt = tt or mrf_fused.bf16_plan(c, t, halo, len(kernels), True).tt
    got = _tiled_schedule(x, w, bias, kernels, dils, tt)
    ref = mrf_fused.mrf_fused_cm_plain(x, w, bias, kernels, dils)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("c,channel_dim", [(24, 1), (48, 1), (80, -1), (16, -1)])
def test_kernel_operands_pad_bf16_to_the_core_width(c, channel_dim):
    """bf16 operands travel padded with zero channels to ``kernel_width(C)``
    (activations, every conv's C_out and C_in, and the bias), the real
    channels untouched; a width the core runs passes through as it is."""
    kernels, nd = (3, 5), 2
    gen = torch.Generator().manual_seed(c)
    w = torch.randn(2 * nd * sum(kernels) * c * c, generator=gen).to(torch.bfloat16)
    bias = torch.randn(len(kernels), nd, 2, c, generator=gen)
    shape = (2, c, 7) if channel_dim == 1 else (2, 7, c)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    xk, wk, bk, ck = mrf_fused.kernel_operands(
        x, w, mrf_fused.branch_weights(w, c, kernels, nd), bias, channel_dim)
    assert ck == mrf_fused.kernel_width(c)
    if ck == c:
        assert xk is x and wk is w and bk is bias
        return
    assert torch.equal(xk.narrow(channel_dim, 0, c), x)
    assert not xk.narrow(channel_dim, c, ck - c).any()
    assert torch.equal(bk[..., :c], bias) and not bk[..., c:].any()
    for wb, wpad in zip(mrf_fused.branch_weights(w, c, kernels, nd),
                        mrf_fused.branch_weights(wk, ck, kernels, nd)):
        assert torch.equal(wpad[..., :c, :c], wb)
        assert not wpad[..., c:, :].any() and not wpad[..., :, c:].any()


def test_mrf_lab_loads_another_checkout_and_needs_the_card():
    """``tools/mrf_lab.py --root`` times another checkout's MRF kernels in
    the same process: ``load_checkout`` imports that checkout's package
    under another name, whose wrappers run apart from this package's (here
    their plain versions, on the CPU); the sweep itself refuses to run
    without a card."""
    from pathlib import Path

    from egregora_tpu_torch.tools import mrf_lab
    root = Path(mrf_fused.__file__).resolve().parents[2]
    other_mf, other_mr = mrf_lab.load_checkout(root)
    assert other_mf is not mrf_fused and other_mr is not mrf_rows
    assert other_mf.__name__.endswith(".ops.mrf_fused")
    _, tm = _mrf(16, seed=9)
    w, b = mrf_fused.pack_resblock_weights(tm, torch.bfloat16)
    x = torch.from_numpy(_x((1, 16, 50), 4)).to(torch.bfloat16)
    assert torch.equal(other_mf.mrf_fused_cm(x, w, b, KERNELS, DILS),
                       mrf_fused.mrf_fused_cm(x, w, b, KERNELS, DILS))
    xr = x.transpose(1, 2).contiguous()
    assert torch.equal(other_mr.mrf_rows(xr, w, b, KERNELS, DILS),
                       mrf_rows.mrf_rows(xr, w, b, KERNELS, DILS))
    with pytest.raises(RuntimeError, match="CUDA card"):
        mrf_lab.sweep(rounds=1, turns=1, shapes=[(16, 64)])
