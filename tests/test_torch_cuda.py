"""The port's CUDA kernels on the card, against their plain versions.

Skips without a card.  The machine with the card has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import pytest
import torch

import chip_smoke
from egregora_tpu_torch.ops import attn_rows as ar
from egregora_tpu_torch.ops.attention import chunked_attention

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("bh,n,d", [(16, 2048, 32), (16, 512, 64), (2, 1000, 256),
                                    (3, 77, 64), (1, 8192, 256), (12, 512, 24),
                                    (4, 300, 40), (2, 500, 128), (3, 257, 96),
                                    (2, 1000, 320), (3, 2048, 512), (1, 77, 512)])
def test_attn_rows_matches_plain(card, bh, n, d):
    """bf16 in and out, within ``chip_smoke.bf16_agreement``'s limits of
    the plain version (relative L2 1e-2, max |d| two bf16 ulps of the
    largest output); one launch counted, under its shape.  Head sizes
    outside 32/64/128/256/512 go through the kernel padded with zero
    columns; 512 is the published checkpoints' VAE mid block."""
    gen = torch.Generator().manual_seed(n + d)
    q, k, v = (torch.randn(bh, n, d, generator=gen).to(card, torch.bfloat16)
               for _ in range(3))
    before, before_shape = ar.launches, ar.launches_by_shape[(bh, n, d)]
    got = ar.attn_rows(q, k, v)
    torch.cuda.synchronize()
    assert ar.launches == before + 1
    assert ar.launches_by_shape[(bh, n, d)] == before_shape + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ok, rel, err, limit = chip_smoke.bf16_agreement(got, chunked_attention(q, k, v))
    assert ok, (rel, err, limit)


@pytest.mark.parametrize("bh,n,d", [(16, 512, 32), (2, 300, 24), (1, 1000, 256),
                                    (2, 100, 128), (3, 77, 48), (2, 300, 320), (1, 500, 512)])
def test_attn_rows_f32_matches_plain(card, bh, n, d):
    """float32 in and out through ``attn_rows_f32`` (plain FMA, no TF32),
    within ``chip_smoke.f32_agreement``'s limits of the plain version
    (relative L2 and max |d| over max |plain| 1e-5); one launch counted."""
    gen = torch.Generator().manual_seed(n * d)
    q, k, v = (torch.randn(bh, n, d, generator=gen).to(card) for _ in range(3))
    before = ar.launches_by_shape[(bh, n, d)]
    got = ar.attn_rows(q, k, v)
    torch.cuda.synchronize()
    assert ar.launches_by_shape[(bh, n, d)] == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    ok, rel, err = chip_smoke.f32_agreement(got, chunked_attention(q, k, v))
    assert ok, (rel, err)


def test_attn_rows_rejects_what_it_does_not_take(card):
    q = torch.zeros(2, 64, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ar.attn_rows(q, q, q)                       # float16
    qb = torch.zeros(2, 64, 640, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="beyond the kernel's range"):
        ar.attn_rows(qb, qb, qb)                    # head dim 640 > 512
    qt = torch.zeros(2, 32, 64, device=card, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        ar.attn_rows(qt, qt, qt)                    # not contiguous
    qf = torch.zeros(2, 64, 32, device=card)
    with pytest.raises(ValueError):
        ar.attn_rows(qf, qf.bfloat16(), qf)         # mixed dtypes


def _mrf_operands(card, b, c, t, seed, dtype=torch.bfloat16):
    from egregora_tpu_torch.ops import mrf_fused as mf
    m = chip_smoke.mrf_module(c, seed, dtype).to(card)
    w, bias = mf.pack_resblock_weights(m, dtype)
    gen = torch.Generator().manual_seed(seed)
    x = (0.5 * torch.randn(b, c, t, generator=gen)).to(card, dtype)
    return x, w, bias


@pytest.mark.parametrize("b,c,t", [(2, 16, 1000), (1, 32, 4096), (2, 64, 777), (1, 48, 300),
                                   (1, 128, 700), (1, 8, 500), (2, 24, 1000)])
def test_mrf_fused_cm_matches_plain(card, b, c, t):
    """One launch, counted under its shape; within ``chip_smoke.mrf_agreement``'s
    limits of the plain version (relative L2 1e-2, max |d| four bf16 ulps
    of the largest output, over the block and over its edges).  C not a
    multiple of 16 runs padded with zero channels."""
    from egregora_tpu_torch.ops import mrf_fused as mf
    x, w, bias = _mrf_operands(card, b, c, t, seed=c + t)
    before, before_shape = mf.launches, mf.launches_by_shape[(b, c, t)]
    got = mf.mrf_fused_cm(x, w, bias)
    torch.cuda.synchronize()
    assert mf.launches == before + 1 and mf.launches_by_shape[(b, c, t)] == before_shape + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ok, rel, err, edge, limit = chip_smoke.mrf_agreement(got, mf.mrf_fused_cm_plain(
        x, w, bias, chip_smoke.MRF_KERNELS, chip_smoke.MRF_DILS))
    assert ok, (rel, err, edge, limit)


@pytest.mark.parametrize("b,c,t", [(2, 16, 1000), (1, 64, 4096), (3, 32, 333), (1, 256, 500),
                                   (1, 8, 700), (2, 24, 300)])
def test_mrf_branch_rows_matches_plain(card, b, c, t):
    """Each branch one launch on [B, T, C], counted under (b, t, c); the
    three averaged as ``mrf_rows``; C = 256 takes the large tile budget."""
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    x, w, bias = _mrf_operands(card, b, c, t, seed=c * t)
    xr = x.transpose(1, 2).contiguous()
    before = mr.launches_by_shape[(b, t, c)]
    got = mr.mrf_rows(xr, w, bias)
    torch.cuda.synchronize()
    assert mr.launches_by_shape[(b, t, c)] == before + 3
    acc = None
    for bi, wb in enumerate(mf.branch_weights(w, c, chip_smoke.MRF_KERNELS, 3)):
        h = mr.mrf_branch_rows_plain(xr, wb, bias[bi], chip_smoke.MRF_DILS)
        acc = h if acc is None else acc + h
    ok, rel, err, edge, limit = chip_smoke.mrf_agreement(got.transpose(1, 2),
                                                         (acc / 3).transpose(1, 2))
    assert ok, (rel, err, edge, limit)


@pytest.mark.parametrize("b,c,t", [(1, 16, 1000), (2, 8, 333), (1, 24, 600), (1, 256, 300)])
def test_mrf_f32_matches_plain(card, b, c, t):
    """Both float32 entries (SIMT FMA, any C; C = 256 keeps its tiles in a
    device workspace) against their plain versions within
    ``chip_smoke.f32_agreement``'s limits; one launch a block or branch."""
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    x, w, bias = _mrf_operands(card, b, c, t, seed=c + 7 * t, dtype=torch.float32)
    before_f, before_r = mf.launches_by_shape[(b, c, t)], mr.launches_by_shape[(b, t, c)]
    got = mf.mrf_fused_cm(x, w, bias)
    xr = x.transpose(1, 2).contiguous()
    got_rows = mr.mrf_rows(xr, w, bias).transpose(1, 2)
    torch.cuda.synchronize()
    assert mf.launches_by_shape[(b, c, t)] == before_f + 1
    assert mr.launches_by_shape[(b, t, c)] == before_r + 3
    assert got.dtype == got_rows.dtype == torch.float32
    ref = mf.mrf_fused_cm_plain(x, w, bias, chip_smoke.MRF_KERNELS, chip_smoke.MRF_DILS)
    ok, rel, err = chip_smoke.f32_agreement(got, ref)
    assert ok, ("fused", rel, err)
    ok, rel, err = chip_smoke.f32_agreement(got_rows, ref)
    assert ok, ("rows", rel, err)


def test_mrf_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import mrf_fused as mf
    x, w, bias = _mrf_operands(card, 1, 16, 256, seed=0)
    with pytest.raises(TypeError):
        mf.mrf_fused_cm(x.half(), w, bias)                      # float16 activations
    with pytest.raises(TypeError):
        mf.mrf_fused_cm(x.float(), w, bias)                     # float32 with bf16 weights
    with pytest.raises(ValueError):
        mf.mrf_fused_cm(x.transpose(1, 2).contiguous().transpose(1, 2), w, bias)
    with pytest.raises(ValueError):
        mf.mrf_fused_cm(x, w[:-1], bias)                        # weights of another size


@pytest.mark.parametrize("c,n,k", [(1, 100, 0.984), (3, 32769, 0.984), (2, 4096, 0.99),
                                   (1, 4194304, 0.9999), (1, 4096 * 4096 + 5000, 0.984)])
def test_iir_lowpass_matches_plain(card, c, n, k):
    """K4 on [C, N] float32 in one call (the last shape takes three scan
    levels), within ``chip_smoke.iir_agreement``'s limit (max |d| 2e-6 on
    a 0.5-scale signal) of the blocked plain version; one call counted."""
    from egregora_tpu_torch.ops import iir_lowpass as il
    gen = torch.Generator().manual_seed(n)
    x = (0.5 * torch.randn(c, n, generator=gen)).to(card)
    before = il.launches_by_shape[(c, n)]
    got = il.iir_lowpass(x, k)
    torch.cuda.synchronize()
    assert il.launches_by_shape[(c, n)] == before + 1
    ok, err = chip_smoke.iir_agreement(got, il.iir_lowpass_plain(x, k))
    assert ok, err


def test_iir_lowpass_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import iir_lowpass as il
    with pytest.raises(ValueError):
        il.iir_lowpass(torch.zeros(2, 100, device=card, dtype=torch.float64), 0.9)
    with pytest.raises(ValueError):
        il.iir_lowpass(torch.zeros(100, 2, device=card).t(), 0.9)   # not contiguous


def _flash_online_cases():
    from egregora_tpu_torch.ops import attn_flash as af
    cases = []
    for dtype, tiles in ((torch.bfloat16, af.BF16_TILES), (torch.float32, af.F32_TILES)):
        for d, (bqs, bks) in tiles.items():
            cases += [(dtype, d, bq, bk) for bq in bqs for bk in bks]
    return cases


@pytest.mark.parametrize("dtype,d,bq,bk", _flash_online_cases())
def test_flash_online_matches_plain(card, dtype, d, bq, bk):
    """K1b at every built tile, bf16 and float32, at a ragged N (the last
    key tile masked) and a head size padded to the built one, within
    ``chip_smoke.kernel_agreement``'s limits of the plain version at the
    same blocks; one launch counted."""
    from egregora_tpu_torch.ops import attn_flash as af
    gen = torch.Generator().manual_seed(d + bq + bk)
    for bh, n, dd in ((3, 1000, d), (2, 129, d - 8)):
        q, k, v = (torch.randn(bh, n, dd, generator=gen).to(card, dtype) for _ in range(3))
        before = af.launches_by_shape[(bh, n, dd)]
        got = af.flash_online(q, k, v, bq, bk)
        torch.cuda.synchronize()
        assert af.launches_by_shape[(bh, n, dd)] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        ok, rel, err, limit = chip_smoke.kernel_agreement(got, af.flash_online_plain(q, k, v, bq, bk))
        assert ok, (bh, n, dd, rel, err, limit)


def test_flash_online_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import attn_flash as af
    q = torch.zeros(2, 64, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        af.flash_online(q, q, q)                    # float16
    qb = torch.zeros(2, 64, 640, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="beyond the kernel's range"):
        af.flash_online(qb, qb, qb)                 # head dim 640 > 512
    qt = torch.zeros(2, 32, 64, device=card, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        af.flash_online(qt, qt, qt)                 # not contiguous
    q32 = torch.zeros(2, 64, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        af.flash_online(q32, q32, q32, block_q=0)   # no block


@pytest.mark.parametrize("b,f,m,c,dtype", [
    (3, 512, 256, 64, torch.bfloat16), (3, 512, 256, 128, torch.bfloat16),
    (3, 512, 256, 24, torch.bfloat16), (2, 37, 45, 20, torch.bfloat16),
    (1, 9, 33, 200, torch.bfloat16), (2, 64, 64, 128, torch.float32),
    (1, 13, 70, 7, torch.float32)])
def test_conv3x3_out1_matches_plain(card, b, f, m, c, dtype):
    """K3 at the decoders' widths (C = 24/64/128), ragged F and M, C not a
    multiple of the 16-byte vector and above one channel chunk, float32;
    each at three row tiles; within the float32 limits of
    ``chip_smoke.f32_agreement`` (the output is float32 in both dtypes);
    one launch counted a call."""
    from egregora_tpu_torch.ops import conv_edge as ce
    gen = torch.Generator().manual_seed(f * m + c)
    x = torch.randn(b, f, m, c, generator=gen).to(card, dtype)
    w = (0.1 * torch.randn(3, 3, c, 1, generator=gen)).to(card)
    bias = torch.tensor([0.25], device=card)
    ref = ce.conv3x3_out1_plain(x, w, bias)
    for f_tile in (64, 8, 13):
        before = ce.launches_by_shape[(b, f, m, c)]
        got = ce.conv3x3_out1(x, w, bias, f_tile=f_tile)
        torch.cuda.synchronize()
        assert ce.launches_by_shape[(b, f, m, c)] == before + 1
        assert got.dtype == torch.float32 and got.shape == (b, f, m, 1)
        ok, rel, err = chip_smoke.f32_agreement(got, ref)
        assert ok, (f_tile, rel, err)


def test_conv3x3_out1_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import conv_edge as ce
    w, bias = torch.zeros(3, 3, 8, 1, device=card), torch.zeros(1, device=card)
    with pytest.raises(TypeError):
        ce.conv3x3_out1(torch.zeros(1, 4, 4, 8, device=card, dtype=torch.float16), w, bias)
    with pytest.raises(ValueError):
        ce.conv3x3_out1(torch.zeros(1, 4, 8, 4, device=card).transpose(2, 3), w, bias)
    with pytest.raises(ValueError):
        ce.conv3x3_out1(torch.zeros(1, 4, 4, 8, device=card), w.cpu(), bias)
