"""The port's CUDA kernels on the card, against their plain versions.

Skips without a card.  The machine with the card has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import pytest
import torch

import chip_smoke
from egregora_tpu_torch.ops import attn_rows as ar
from egregora_tpu_torch.ops.attn_rows import attn_rows_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (d, bh, n) of more bf16 cases: N = 1, 17, 1000 at every built head size
# (and tile) with BH up to 26, and N = 8191 at D = 512 (the published VAE
# mid block's length, less one)
BF16_CASES = [(d, bh, n) for d in ar.KERNEL_D
              for bh, n in ((26, 1), (5, 17), (2, 1000), (26, 1000))] + [(512, 3, 8191)]


@pytest.mark.parametrize("bh,n,d", [(16, 2048, 32), (16, 512, 64), (2, 1000, 256),
                                    (3, 77, 64), (1, 8192, 256), (12, 512, 24),
                                    (4, 300, 40), (2, 500, 128), (3, 257, 96),
                                    (2, 1000, 320), (3, 2048, 512), (1, 77, 512)]
                         + [(bh, n, d) for d, bh, n in BF16_CASES])
def test_attn_rows_matches_plain(card, bh, n, d):
    """bf16 in and out, within ``chip_smoke.bf16_agreement``'s limits of
    the plain version (relative L2 1e-2, max |d| two bf16 ulps of the
    largest output); one launch counted, under its shape.  Head sizes
    outside 32/64/128/256/512 go through the kernel padded with zero
    columns; 512 is the published checkpoints' VAE mid block.  From one
    key (a single ragged key tile) to 8191 (many tiles through the
    ring)."""
    gen = torch.Generator().manual_seed(n + d)
    q, k, v = (torch.randn(bh, n, d, generator=gen).to(card, torch.bfloat16)
               for _ in range(3))
    before, before_shape = ar.launches, ar.launches_by_shape[(bh, n, d)]
    got = ar.attn_rows(q, k, v)
    torch.cuda.synchronize()
    assert ar.launches == before + 1
    assert ar.launches_by_shape[(bh, n, d)] == before_shape + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ok, rel, err, limit = chip_smoke.bf16_agreement(got, attn_rows_plain(q, k, v))
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
    ok, rel, err = chip_smoke.f32_agreement(got, attn_rows_plain(q, k, v))
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
    of the largest output, over the block and over its edges).  C other
    than 16, 32 or a multiple of 64 runs padded with zero channels."""
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
    three averaged as ``mrf_rows``; C = 256 takes two passes of 128
    output channels."""
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


def _mrf_bf16_check(card, entry, b, c, t, kernels=(3, 7, 11), dils=(1, 3, 5), seed=0):
    """One bf16 block through ``entry`` ("fused": one ``mrf_fused_cm``
    launch on [B, C, T]; "rows": one ``mrf_branch_rows`` launch a branch on
    [B, T, C], averaged) with random weights of the given schedule, held
    to ``chip_smoke.mrf_agreement``'s limits of the entry's plain version;
    the launches counted under the shape."""
    from egregora_tpu_torch.ops import mrf_fused as mf
    from egregora_tpu_torch.ops import mrf_rows as mr
    gen = torch.Generator().manual_seed(seed + 31 * c + t)
    nb, nd = len(kernels), len(dils)
    w = (torch.randn(2 * nd * sum(kernels) * c * c, generator=gen) / (5 * c) ** 0.5).to(
        card, torch.bfloat16)
    bias = (0.1 * torch.randn(nb, nd, 2, c, generator=gen)).to(card)
    x = (0.5 * torch.randn(b, c, t, generator=gen)).to(card, torch.bfloat16)
    if entry == "fused":
        before = mf.launches_by_shape[(b, c, t)]
        got = mf.mrf_fused_cm(x, w, bias, kernels, dils)
        torch.cuda.synchronize()
        assert mf.launches_by_shape[(b, c, t)] == before + 1
        ref = mf.mrf_fused_cm_plain(x, w, bias, kernels, dils)
    else:
        xr = x.transpose(1, 2).contiguous()
        branch_w = mf.branch_weights(w, c, kernels, nd)
        before = mr.launches_by_shape[(b, t, c)]
        got = sum(mr.mrf_branch_rows(xr, wb, bias[i], dils) for i, wb in enumerate(branch_w))
        torch.cuda.synchronize()
        assert mr.launches_by_shape[(b, t, c)] == before + nb
        got = (got / nb).transpose(1, 2)
        ref = (sum(mr.mrf_branch_rows_plain(xr, wb, bias[i], dils)
                   for i, wb in enumerate(branch_w)) / nb).transpose(1, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (b, c, t)
    ok, rel, err, edge, limit = chip_smoke.mrf_agreement(got, ref)
    assert ok, (entry, b, c, t, kernels, dils, rel, err, edge, limit)


@pytest.mark.parametrize("entry", ["fused", "rows"])
@pytest.mark.parametrize("c", [8, 16, 24, 32, 48, 64, 128, 256, 320])
def test_mrf_bf16_tile_edges(card, entry, c):
    """Both bf16 entries of the warpgroup-MMA core at the edges of its time
    tile TT (``bf16_plan``'s at the k = 11 branch's halo, which the rows
    entry's widest launch and the fused entry take): T = 1, TT - 1, TT,
    TT + 1 and 3 TT + 5 (four tiles, the last ragged), B = 1 to 3; C
    padded to 16, 32 or a multiple of 64 where it is not one."""
    from egregora_tpu_torch.ops import mrf_fused as mf
    fused = entry == "fused"
    tt = mf.bf16_plan(c, 10 ** 6, 60, 3 if fused else 1, fused).tt
    for i, t in enumerate((1, tt - 1, tt, tt + 1, 3 * tt + 5)):
        _mrf_bf16_check(card, entry, 1 + i % 3, c, t)


@pytest.mark.parametrize("entry", ["fused", "rows"])
@pytest.mark.parametrize("c,t,kernels,dils", [
    (32, 1000, (3, 5), (1, 2)), (64, 777, (3, 5), (1, 2)),
    (16, 2500, (3, 5, 7, 9), (1, 3, 5, 7)), (64, 1500, (3, 5, 7, 9), (1, 3, 5, 7)),
    (128, 600, (3, 5, 7, 9), (1, 3, 5, 7))])
def test_mrf_bf16_schedules(card, entry, c, t, kernels, dils):
    """Schedules other than the vocoder's: two branches of two dilations,
    and four branches of four (a halo of 80, whose first convs take two
    passes of the M tiles a warpgroup keeps in registers, so each weight
    slice streams twice)."""
    _mrf_bf16_check(card, entry, 2, c, t, kernels, dils)


def test_mrf_bf16_layout_matches_the_plan(card):
    """The library's ``mrf_bf16_layout`` (the block it launches) is the
    wrappers' ``bf16_plan`` at every width, halo and entry, including
    where no tile fits."""
    from egregora_tpu_torch.ops import mrf_fused as mf
    for c in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 320, 336):
        for halo in (0, 12, 36, 60, 80):
            for nb, cm in ((3, True), (1, False), (1, True), (4, True)):
                for t in (1, 100, 5120, 245760):
                    plan = mf.bf16_plan(c, t, halo, nb, cm)
                    got = chip_smoke.mrf_bf16_layout(c, t, halo, nb, cm)
                    assert got == (None if plan is None else tuple(plan)), (c, t, halo, nb, cm)


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
    """K4 on [C, N] float32 in one call (the last shape chains 2049 tiles
    a row), within ``chip_smoke.iir_agreement``'s limit (max |d| 2e-6 on a
    0.5-scale signal) of the blocked plain version; one call counted."""
    from egregora_tpu_torch.ops import iir_lowpass as il
    gen = torch.Generator().manual_seed(n)
    x = (0.5 * torch.randn(c, n, generator=gen)).to(card)
    before = il.launches_by_shape[(c, n)]
    got = il.iir_lowpass(x, k)
    torch.cuda.synchronize()
    assert il.launches_by_shape[(c, n)] == before + 1
    ok, err = chip_smoke.iir_agreement(got, il.iir_lowpass_plain(x, k))
    assert ok, err


def _iir_cases():
    from egregora_tpu_torch.ops import iir_lowpass as il
    T = il.TILE
    shapes = [(c, n) for c in (1, 2, 3) for n in (1, 100, T - 1, T, T + 1, 3 * T + 5)]
    return shapes + [(1000, 100), (1000, T + 1), (2, 14_400_000)]


@pytest.mark.parametrize("k", [0.9844, 0.9999])
@pytest.mark.parametrize("c,n", _iir_cases())
def test_iir_lowpass_lookback_shapes(card, c, n, k):
    """The single-pass scan at n = 1, 100, TILE - 1, TILE, TILE + 1 and
    3 TILE + 5 on one to three rows, many short rows (C = 1000, one tile
    or two a row) and the meter's 2 x 14.4M samples, at the 48 kHz pole
    and at 0.9999: within ``chip_smoke.iir_agreement`` of the plain
    version; one call counted."""
    from egregora_tpu_torch.ops import iir_lowpass as il
    gen = torch.Generator().manual_seed(c * 7 + n)
    x = (0.5 * torch.randn(c, n, generator=gen)).to(card)
    before = il.launches_by_shape[(c, n)]
    got = il.iir_lowpass(x, k)
    torch.cuda.synchronize()
    assert il.launches_by_shape[(c, n)] == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    ok, err = chip_smoke.iir_agreement(got, il.iir_lowpass_plain(x, k))
    assert ok, err


def test_iir_lowpass_calls_in_a_row_and_on_two_streams(card):
    """Each call zeroes its own workspace: two calls in a row give the same
    result, calls of alternating shapes and poles stay right, and calls on
    two streams at once (each with its workspace) agree with the plain
    version."""
    from egregora_tpu_torch.ops import iir_lowpass as il
    gen = torch.Generator().manual_seed(5)
    xs = [(0.5 * torch.randn(c, n, generator=gen)).to(card)
          for c, n in ((2, 5 * il.TILE + 3), (3, 2 * il.TILE), (1, 100))]
    a = il.iir_lowpass(xs[0], 0.9999)
    b = il.iir_lowpass(xs[0], 0.9999)
    torch.cuda.synchronize()
    assert chip_smoke.iir_agreement(a, b)[1] <= 1e-6
    for _ in range(2):
        for x in xs:
            for k in (0.9844, 0.9999):
                ok, err = chip_smoke.iir_agreement(il.iir_lowpass(x, k), il.iir_lowpass_plain(x, k))
                assert ok, (tuple(x.shape), k, err)
    big = (0.5 * torch.randn(2, 3_000_000, generator=gen)).to(card)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for s, k in zip(streams, (0.9844, 0.9999)):
        with torch.cuda.stream(s):
            outs.append(il.iir_lowpass(big, k))
    torch.cuda.synchronize()
    for out, k in zip(outs, (0.9844, 0.9999)):
        ok, err = chip_smoke.iir_agreement(out, il.iir_lowpass_plain(big, k))
        assert ok, (k, err)


def test_iir_lowpass_layout_matches_the_wrapper(card):
    """The library's tile, threads and look-back window are the ones the
    wrapper's tables and the planted faults assume."""
    from egregora_tpu_torch.ops import iir_lowpass as il
    assert il.layout() == (il.TILE, il.THREADS, il.WINDOW)


def test_iir_lowpass_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import iir_lowpass as il
    with pytest.raises(ValueError):
        il.iir_lowpass(torch.zeros(2, 100, device=card, dtype=torch.float64), 0.9)
    with pytest.raises(ValueError):
        il.iir_lowpass(torch.zeros(100, 2, device=card).t(), 0.9)   # not contiguous



# ---- Snake (csrc/snake.cu) ----

def _snake_cell_shapes():
    """``(c, t)`` of every Snake of the DAC 44 kHz cell on one channel of
    1, 17 (odd stages: T % 8 != 0) and 200 frames, once each."""
    from perfbench.reference.dac import snake_shapes
    g = {"encoder_dim": 64, "decoder_dim": 1536, "strides": [2, 4, 8, 8]}
    return sorted({s for f in (1, 17, 200) for s in snake_shapes(g, f)})


def _snake_operands(card, b, c, t, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = (3.0 * torch.randn(b, c, t, generator=gen, device=card)).to(dtype)
    alpha = 0.5 + torch.rand(c, generator=gen, device=card)
    alpha[::3] = 0.02                  # below the shipped codecs' floor
    return x, alpha


@pytest.mark.parametrize("c,t", _snake_cell_shapes())
def test_snake_matches_plain_at_the_cells_shapes(card, c, t):
    """bf16 in and out, stereo, at floor 0 and 0.05: every element within
    one bf16 ulp of the plain version rounded to bf16; one launch a call."""
    from egregora_tpu_torch.ops import snake as sn
    x, alpha = _snake_operands(card, 2, c, t, torch.bfloat16, c * 7 + t)
    for floor in (0.0, 0.05):
        before = sn.launches
        got = sn.snake(x, alpha, floor, torch.bfloat16)
        torch.cuda.synchronize()
        assert sn.launches == before + 1 and got.dtype == torch.bfloat16
        worst, equal = chip_smoke.snake_ulps(got, sn.snake_plain(x, alpha, floor).bfloat16())
        assert worst <= 1, (worst, equal)


@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                               (torch.float32, torch.bfloat16),
                                               (torch.float32, torch.float32)])
@pytest.mark.parametrize("b,c,t", [(2, 96, 12345), (1, 3, 7), (3, 70000, 5), (2, 64, 4096)])
def test_snake_float32_sides_and_ragged_rows(card, x_dtype, out_dtype, b, c, t):
    """float32 in or out, odd T (rows off the vector boundary: scalar head
    and tail), more rows than the grid's 65535, T % 8 == 0: within one ulp
    of the output dtype of the plain version rounded to it."""
    from egregora_tpu_torch.ops import snake as sn
    x, alpha = _snake_operands(card, b, c, t, x_dtype, b * c + t)
    got = sn.snake(x, alpha, 0.05, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == x.shape
    worst, _ = chip_smoke.snake_ulps(got, sn.snake_plain(x, alpha, 0.05).to(out_dtype))
    assert worst <= 1


def test_snake_off_the_16_byte_boundary(card):
    """An input that starts 2 bytes past a 16-byte boundary takes the
    scalar path: the same result."""
    from egregora_tpu_torch.ops import snake as sn
    x, alpha = _snake_operands(card, 2, 5, 1001, torch.bfloat16, 3)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    got = sn.snake(shifted, alpha, 0.0, torch.bfloat16)
    assert torch.equal(got, sn.snake(x, alpha, 0.0, torch.bfloat16))


def test_snake_past_two_to_the_31_elements(card):
    """``[2, 96, 11.2M]`` bf16, 2.15e9 elements: the last row, which holds
    element 2^31, against the plain version run on that row alone; and the
    first row."""
    from egregora_tpu_torch.ops import snake as sn
    b, c, t = 2, 96, 11_200_000
    assert b * c * t > 2 ** 31
    gen = torch.Generator(device=card).manual_seed(31)
    x = torch.randn(b, c, t, generator=gen, device=card, dtype=torch.bfloat16)
    alpha = 0.5 + torch.rand(c, generator=gen, device=card)
    got = sn.snake(x, alpha, 0.0, torch.bfloat16)
    torch.cuda.synchronize()
    for i, ch in ((b - 1, c - 1), (0, 0)):
        ref = sn.snake_plain(x[i:i + 1, ch:ch + 1], alpha[ch:ch + 1], 0.0).bfloat16()
        worst, _ = chip_smoke.snake_ulps(got[i:i + 1, ch:ch + 1], ref)
        assert worst <= 1, (i, ch, worst)


def test_snake_gradient_on_the_card(card):
    """With grad, the kernel runs inside the autograd Function: the output
    and the gradients for x and alpha equal autograd of the plain version
    on the card (the clamp's zero gradient below the floor kept)."""
    from egregora_tpu_torch.ops import snake as sn
    x, alpha = _snake_operands(card, 2, 12, 3001, torch.bfloat16, 5)
    grad = torch.randn(x.shape, device=card).bfloat16()
    xk, ak = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    before = sn.launches
    y = sn.snake(xk, ak, 0.05, torch.bfloat16)
    y.backward(grad)
    xr, ar = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    ref = sn.snake_plain(xr, ar, 0.05).bfloat16()
    ref.backward(grad)
    assert sn.launches == before + 1
    assert chip_smoke.snake_ulps(y, ref.detach())[0] <= 1
    assert torch.equal(xk.grad, xr.grad) and torch.equal(ak.grad, ar.grad)
    assert torch.all(ak.grad[::3] == 0)


def test_snake_counts_a_launch_in_every_snake_span(card):
    """A small codec on the card: every ``egr.dac.snake`` span holds one
    ``snake_launches``, 2 x 29 an encode and decode at four strides."""
    import time

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.utils import profiling
    cfg = M.DACConfig(encoder_dim=8, decoder_dim=64, n_codebooks=2, codebook_size=16)
    model = M.DACModel(cfg).init_params(0).to(card)
    x = torch.rand(2, 3 * cfg.hop) - 0.5
    with profiling.recording():
        t0 = time.time_ns()
        z, _ = model.encode(x)
        model.decode(z)
        torch.cuda.synchronize()
        recs = [r for r in profiling.spans(t0, time.time_ns()) if r.name == "egr.dac.snake"]
    assert len(recs) == 58 and all(r.counts == {"snake_launches": 1} for r in recs)


@pytest.mark.parametrize("c,t", [(96, 200 * 512), (96, 17 * 512 + 3), (1536, 200), (1536, 17),
                                 (6, 1001)])
def test_snake_nwc_equals_plain_bit_for_bit(card, c, t):
    """A channels-last input (the DAC's layout) at the 44 kHz decoder's last
    stage (96 channels) and first (1536), stereo, a row count off the
    tile, and 6 channels (not a multiple of the 16-byte vector: one
    channel a group): equal bit for bit to the plain version rounded to
    bf16 and to the NCW kernel on the same values, in the input's layout;
    one launch a call."""
    from egregora_tpu_torch.ops import snake as sn
    x, alpha = _snake_operands(card, 2, c, t, torch.bfloat16, c + t)
    xn = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert sn.kernel_layout(xn) and not sn.kernel_layout(x)
    for floor in (0.0, 0.05):
        before = sn.launches
        got = sn.snake(xn, alpha, floor, torch.bfloat16)
        torch.cuda.synchronize()
        assert sn.launches == before + 1 and got.stride() == xn.stride()
        assert torch.equal(got, sn.snake_plain(x, alpha, floor).bfloat16())
        assert torch.equal(got, sn.snake(x, alpha, floor, torch.bfloat16))


def test_snake_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import snake as sn
    x, alpha = _snake_operands(card, 2, 4, 100, torch.bfloat16, 0)
    with pytest.raises(ValueError):
        sn.snake(x.half(), alpha, 0.0, torch.bfloat16)                # float16
    with pytest.raises(ValueError):
        sn.snake(x[..., ::2], alpha, 0.0, torch.bfloat16)             # strided
    with pytest.raises(ValueError):
        sn.snake(x.permute(2, 0, 1).contiguous().permute(1, 2, 0), alpha, 0.0,
                 torch.bfloat16)                                      # [T, B, C] memory
    with pytest.raises(ValueError):
        sn.snake(x, alpha.double(), 0.0, torch.bfloat16)              # alpha not float32
    with pytest.raises(ValueError):
        sn.snake(x, alpha, 0.0, torch.float16)                        # output dtype
    with pytest.raises(ValueError):
        sn.snake(x, alpha.cpu(), 0.0, torch.bfloat16)                 # alpha elsewhere

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
    key tile masked), a head size padded to the built one, one key, 17
    keys with BH 26 and 8191 keys at D = 512, within
    ``chip_smoke.kernel_agreement``'s limits of the plain version at the
    same blocks; one launch counted."""
    from egregora_tpu_torch.ops import attn_flash as af
    gen = torch.Generator().manual_seed(d + bq + bk)
    shapes = [(3, 1000, d), (2, 129, d - 8), (26, 1, d), (26, 17, d)]
    for bh, n, dd in shapes + ([(3, 8191, d)] if d == 512 else []):
        q, k, v = (torch.randn(bh, n, dd, generator=gen).to(card, dtype) for _ in range(3))
        before = af.launches_by_shape[(bh, n, dd)]
        got = af.flash_online(q, k, v, bq, bk)
        torch.cuda.synchronize()
        assert af.launches_by_shape[(bh, n, dd)] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        ok, rel, err, limit = chip_smoke.kernel_agreement(got, af.flash_online_plain(q, k, v, bq, bk))
        assert ok, (bh, n, dd, rel, err, limit)


def test_bf16_tiles_match_the_built_layout(card):
    """The wrappers' ``BF16_TILES`` (which the CPU side and the planted
    faults read) name the tiles each library builds, with its q rows:
    ``<lib>_bf16_layout`` answers for each of them and for no other key
    tile."""
    from egregora_tpu_torch.ops import attn_flash as af
    for d, (bq, bk) in ar.BF16_TILES.items():
        assert chip_smoke.bf16_layout("attn_rows", d, bk)[0] == bq
        assert chip_smoke.bf16_layout("attn_rows", d, bk // 2) is None
    for d, (bqs, bks) in af.BF16_TILES.items():
        for bk in bks:
            assert chip_smoke.bf16_layout("attn_online", d, bk)[0] in bqs
        assert chip_smoke.bf16_layout("attn_online", d, 16) is None


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


# K3 on every tile edge: (f, m) around the 8-row step and F segments, the
# 32-column CUDA-core tile and the 64-column strips
K3_EDGES = [(1, 1), (8, 32), (9, 65), (17, 63), (25, 129), (33, 64), (7, 31), (16, 33)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [5, 8, 16, 24, 64, 128, 200, 256])
def test_conv3x3_out1_tile_edges(card, c, dtype):
    """Both routes at C = 5 to 256, B = 1 and 3, F and M on every tile
    edge, f_tile 64 and 8: within ``chip_smoke.f32_agreement`` of the plain
    version; one launch counted a call, on the route ``plan_of`` names
    (bf16 at C % 8 == 0 on the tensor cores)."""
    from egregora_tpu_torch.ops import conv_edge as ce
    gen = torch.Generator().manual_seed(c)
    route = ce.TC if dtype == torch.bfloat16 and c % 8 == 0 else ce.CC
    for b in (1, 3):
        for f, m in K3_EDGES:
            x = torch.randn(b, f, m, c, generator=gen).to(card, dtype)
            w = (0.1 * torch.randn(3, 3, c, 1, generator=gen)).to(card)
            bias = torch.tensor([0.25], device=card)
            ref = ce.conv3x3_out1_plain(x, w, bias)
            for f_tile in (64, 8):
                before = ce.launches_by_route[route]
                got = ce.conv3x3_out1(x, w, bias, f_tile=f_tile)
                torch.cuda.synchronize()
                assert ce.launches_by_route[route] == before + 1
                ok, rel, err = chip_smoke.f32_agreement(got, ref)
                assert ok, (b, f, m, f_tile, rel, err)


def test_conv3x3_out1_layout_matches_the_plan(card):
    """The library's ``conv_edge_bf16_layout`` (the block each route
    launches) is the wrapper's ``bf16_plan`` at every C to 320 and at the
    limits, aligned or not; the tensor-core entry refuses a C or an
    alignment of the other route; a misaligned bf16 x runs on the CUDA
    cores."""
    from egregora_tpu_torch.ops import conv_edge as ce
    for c in list(range(1, 321)) + [4088, 4096, 4104]:
        for aligned in (True, False):
            assert chip_smoke.conv_edge_layout(c, aligned) == tuple(ce.bf16_plan(c, aligned)), c
    x = torch.zeros(1, 4, 4, 20, device=card, dtype=torch.bfloat16)
    w, bias = torch.zeros(3, 3, 20, 1, device=card), torch.zeros(1, device=card)
    out = torch.empty(1, 4, 4, 1, device=card)
    fn = ce._kernel(torch.bfloat16, ce.TC)
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), 1, 4, 4, 20, 4,
              stream) == 1                           # cudaErrorInvalidValue: C % 8 != 0
    flat = torch.randn(1 + 3 * 9 * 70 * 64, device=card).bfloat16()
    xm = flat[1:].view(3, 9, 70, 64)                 # contiguous, 2 bytes past alignment
    wm = 0.1 * torch.randn(3, 3, 64, 1, device=card)
    assert ce.plan_of(xm).route == 0
    before = ce.launches_by_route[ce.CC]
    ok, rel, err = chip_smoke.f32_agreement(ce.conv3x3_out1(xm, wm, bias),
                                            ce.conv3x3_out1_plain(xm, wm, bias))
    assert ok and ce.launches_by_route[ce.CC] == before + 1, (rel, err)


def test_conv3x3_out1_rejects_what_it_does_not_take(card):
    from egregora_tpu_torch.ops import conv_edge as ce
    w, bias = torch.zeros(3, 3, 8, 1, device=card), torch.zeros(1, device=card)
    with pytest.raises(TypeError):
        ce.conv3x3_out1(torch.zeros(1, 4, 4, 8, device=card, dtype=torch.float16), w, bias)
    with pytest.raises(ValueError):
        ce.conv3x3_out1(torch.zeros(1, 4, 8, 4, device=card).transpose(2, 3), w, bias)
    with pytest.raises(ValueError):
        ce.conv3x3_out1(torch.zeros(1, 4, 4, 8, device=card), w.cpu(), bias)


# ---- the enhance chain's modules (plain PyTorch on the card) against the CPU


@pytest.mark.parametrize("s,use_mm", [(4000, True), (4099, True), (4000, False)])
def test_spectral_enhance_card_matches_cpu(card, s, use_mm):
    """Fold loop, a padded length, the per-iteration loop: 20 iterations
    on the card within ``chip_smoke.FL_ABS`` of the CPU."""
    import numpy as np

    from egregora_tpu_torch.ops import spectral as sp
    x = torch.from_numpy(chip_smoke.speech_signal(s / 16000, 16000, 2, seed=s)[:, :s].copy())
    host = sp.spectral_enhance(x, 2, 20, 0.6, use_matmul_fft=use_mm)
    got = sp.spectral_enhance(x.to(card), 2, 20, 0.6, use_matmul_fft=use_mm)
    assert got.device.type == "cuda" and got.shape == (2, 2 * s)
    assert float((got.cpu() - host).abs().max()) <= chip_smoke.FL_ABS
    assert np.isfinite(got.cpu().numpy()).all()


def test_rnnoise_card_matches_cpu(card):
    """The engine on 4 s of speech-like stereo with a silent gap: wave,
    VAD, periods and silence within ``chip_smoke.rnnoise_compare``'s
    limits of the CPU, at segments 1 and 4."""
    from egregora_tpu_torch.models.rnnoise import model as rn
    from egregora_tpu_torch.models.rnnoise import train as rt
    params = rt.load_pretrained()
    x = chip_smoke.speech_signal(4.0, 48000, 2, seed=7, gaps=((1.5, 2.0),))
    r = chip_smoke.rnnoise_compare(chip_smoke.rnnoise_run(params, x, "cuda"),
                                   chip_smoke.rnnoise_run(params, x, "cpu"))
    assert r["ok"], r
    xd = torch.from_numpy(x)
    host = rn.denoise(params, xd, segments=4)[0]
    got = rn.denoise(params, xd.to(card), segments=4)[0]
    assert float(torch.linalg.norm(got.cpu() - host) / torch.linalg.norm(host)) \
        <= chip_smoke.RN_WAVE_REL


def test_wpe_card_matches_cpu(card):
    from egregora_tpu_torch.models import wpe as W
    x, _ = chip_smoke.reverb_signal(2.0, 16000, seed=3)
    host = W.wpe_dereverb(torch.from_numpy(x), n_fft=512, hop=128)
    got = W.wpe_dereverb(torch.from_numpy(x).to(card), n_fft=512, hop=128)
    assert float((got.cpu() - host).abs().max()) <= chip_smoke.WPE_CPU_ABS


def test_enhance_nodes_run_on_the_card(card):
    """The Fat Llama GPU, RNNoise and WPE nodes run their engines on the
    card by default; the Fat Llama CPU node on the CPU."""
    from egregora_tpu_torch.models import wpe as W
    from egregora_tpu_torch.models.rnnoise import model as rn
    from egregora_tpu_torch.nodes import enhance_extras as ee
    from egregora_tpu_torch.nodes import spectral_enhance as se
    x = chip_smoke.speech_signal(1.0, 16000, 1, seed=2, gaps=())
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": 16000}
    seen = []
    undo = [chip_smoke.on_devices(m, name, seen) for m, name in
            ((se, "spectral_enhance"), (rn, "denoise"), (W, "wpe_dereverb"))]
    try:
        for node, args in ((se.EgregoraFatLlamaGPU(), ("wav", 10, 0.6, 1411)),
                           (se.EgregoraFatLlamaCPU(), ("wav", 10, 0.6, 1411))):
            (out,) = node.run(*args, AUDIO=audio)
            assert out["sample_rate"] == 96000
        (out,) = ee.Egregora_RNNoise_Denoise().execute(audio)
        assert out["waveform"].shape == (1, 1, 16000)
        (out,) = ee.Egregora_WPE_Dereverb().execute(audio, n_fft=512, hop=128)
        assert out["waveform"].shape == (1, 1, 16000)
    finally:
        for u in undo:
            u()
    assert seen == ["cuda", "cpu", "cuda", "cuda"]


# ---- DeepFilterNet and the DAC codec (plain PyTorch on the card) against the CPU


@pytest.mark.parametrize("variant", ["DeepFilterNet2", "DeepFilterNet3"])
def test_dfn_card_matches_cpu(card, variant):
    """Wave and ERB gains on 2 s within ``chip_smoke.dfn_compare``'s
    limits of the CPU (convs and GRUs in full float32 whatever the global
    TF32 flags say)."""
    from egregora_tpu_torch.models.deepfilternet import train as dtr
    params = dtr.load_pretrained(variant)
    x = chip_smoke.noisy_speech(2.0, 48000, 1, seed=3)[0]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        r = chip_smoke.dfn_compare(chip_smoke.dfn_run(params, x, "cuda"),
                                   chip_smoke.dfn_run(params, x, "cpu"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert r["ok"], r


@pytest.mark.parametrize("mt", ["16khz", "24khz", "44khz"])
def test_dac_card_matches_cpu(card, mt):
    """A shipped codec, bf16 on both: decode of the CPU's latents within
    ``chip_smoke.DAC_DECODE_REL`` and the roundtrip SNR within
    ``DAC_SNR_DB`` of the CPU's, on 1 s of speech-like stereo."""
    import copy

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.dac import train as dtr
    cfg, tree = dtr.load_pretrained(mt)
    cpu = M.DACModel(cfg).load_jax(tree)
    gpu = copy.deepcopy(cpu).to(card)
    x = chip_smoke.speech_signal(1.0, cfg.sample_rate, 2, seed=5)
    zq, codes = cpu.encode(torch.from_numpy(x))
    zq_c, codes_c = gpu.encode(torch.from_numpy(x))
    assert zq_c.device.type == "cuda" and zq_c.shape == zq.shape and codes_c.shape == codes.shape
    assert chip_smoke.dac_rel(gpu.decode(zq), cpu.decode(zq)) <= chip_smoke.DAC_DECODE_REL
    assert abs(dtr.roundtrip_snr_db(gpu, x) - dtr.roundtrip_snr_db(cpu, x)) <= chip_smoke.DAC_SNR_DB


def test_dac_channels_last_on_the_card_matches_cpu_float32(card):
    """The shipped 44 kHz codec in bf16 on the card, every activation
    channels-last (a forward hook on each conv and Snake) and no layout
    copy counted, against the same weights in float32 on the CPU: decode
    of the CPU's latents within ``chip_smoke.DAC_DECODE_REL``."""
    import dataclasses

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.dac import train as dtr
    from egregora_tpu_torch.utils import profiling
    cfg, tree = dtr.load_pretrained("44khz")
    cpu = M.DACModel(dataclasses.replace(cfg, dtype=torch.float32)).load_jax(tree)
    gpu = M.DACModel(cfg).load_jax(tree).to(card)
    x = torch.from_numpy(chip_smoke.speech_signal(2.0, cfg.sample_rate, 2, seed=6))
    zq, _ = cpu.encode(x)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(args[0].transpose(1, 2).is_contiguous()
                                           and out.transpose(1, 2).is_contiguous()))
             for m in gpu.modules() if isinstance(m, (M.Conv1dNWC, M.ConvTranspose1dNWC, M.Snake))]
    try:
        with profiling.recording():
            before = profiling.counters().get("dac_layout_copies", 0)
            gpu.encode(x)
            y = gpu.decode(zq)
            torch.cuda.synchronize()
            copies = profiling.counters().get("dac_layout_copies", 0) - before
    finally:
        for h in hooks:
            h.remove()
    n = len(cfg.strides)
    assert len(seen) == 2 * ((7 * n + 1) + (7 * n + 2)) and all(seen) and copies == 0
    assert y.device.type == "cuda" and chip_smoke.dac_rel(y, cpu.decode(zq)) <= chip_smoke.DAC_DECODE_REL


def test_dfn_and_dac_nodes_run_on_the_card(card, monkeypatch):
    """The DeepFilterNet and DAC nodes run on the card by default (the
    ``device`` widget is ignored) and say so where the JAX node does."""
    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.deepfilternet import model as D
    from egregora_tpu_torch.nodes import enhance_extras as ee
    monkeypatch.setattr(ee.Egregora_DAC_Encode, "_MODELS", {})
    monkeypatch.setattr(M, "_CACHE", {})
    x = chip_smoke.speech_signal(1.0, 16000, 2, seed=2, gaps=())
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": 16000}
    seen = []
    undo = chip_smoke.on_devices(D, "enhance", seen)
    try:
        (out,) = ee.Egregora_DeepFilterNet_Denoise().execute(audio, device="cpu")
    finally:
        undo()
    assert seen == ["cuda"] and out["meta"]["deepfilternet"]["device"] == "cuda"
    assert out["waveform"].shape == (1, 2, 16000)
    codes, log = ee.Egregora_DAC_Encode().execute(audio, model_type="16khz", device="cpu")
    model, _ = ee.Egregora_DAC_Encode._MODELS["16khz"]
    assert model.device.type == "cuda" and model.weight_source == "shipped"
    assert codes["latents"][0][0].shape[0] == 2 and log.startswith("DAC encode ok")
    (back, log) = ee.Egregora_DAC_Decode().execute(codes, device="cpu")
    assert back["waveform"].shape[:2] == (1, 2) and back["waveform"].shape[2] >= 16000


# ---- training (the attention Function, a distilled step, the mesh) ----

@pytest.mark.parametrize("bh,n,d,dtype", [(32, 128, 32, torch.bfloat16), (16, 512, 64, torch.bfloat16),
                                          (2, 1000, 40, torch.bfloat16), (4, 300, 32, torch.float32)])
def test_attn_rows_gradient_matches_plain(card, bh, n, d, dtype):
    """Autograd through ``attn_rows`` (the kernel forward, the plain
    backward of ``AttnRows``) against autograd through the plain version
    in float32: dq, dk, dv within ``chip_smoke.ATTN_GRAD_LIMIT``; the
    forward is one kernel launch."""
    gen = torch.Generator().manual_seed(bh + n)
    q, k, v, do = (torch.randn(bh, n, d, generator=gen).to(card, dtype) for _ in range(4))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    before = ar.launches
    o = ar.attn_rows(qs, ks, vs)
    assert ar.launches == before + 1 and o.grad_fn is not None
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(attn_rows_plain(qf, kf, vf), (qf, kf, vf), do.float())
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert chip_smoke.rel_l2(g.float(), w) <= chip_smoke.ATTN_GRAD_LIMIT
    with torch.inference_mode():          # the served path: no Function, one launch
        before = ar.launches
        assert ar.attn_rows(q, k, v).grad_fn is None and ar.launches == before + 1


def test_distilled_step_gives_every_parameter_a_gradient(card):
    """The distilled config at full width, batch 2: every parameter has a
    finite gradient, the attention projections of the StudentUNet's mid
    block among them; one AdamW step updates every parameter."""
    from egregora_tpu_torch.models.flashsr import distill, pipeline as P, prng, train
    mods = P.FlashSRModules(distill.distilled_config())
    mods.init_params(0)
    mods.to(card)
    kd, kn = prng.split(prng.prng_key(1))
    lr_w, hr_w = distill.synth_pair_batch(kd, 2, 480 * 64)
    loss, grads = chip_smoke.loss_and_grads(mods, lr_w, hr_w, kn)
    assert chip_smoke.grad_holes(grads) == ([], [])
    mid = [k for k in grads if "MultiHeadDotProductAttention" in k[1]]
    assert mid and all(float(grads[k].abs().max()) > 0 for k in mid if k[1].endswith("query.weight"))
    before = [p.detach().clone() for p in mods.parameters()]
    step = train.make_train_step(mods, train.make_optimizer(mods, 1e-3), None, 480, 256, 2048)
    assert torch.isfinite(step(lr_w, hr_w, kn))
    assert all(not torch.equal(a, b) for a, b in zip(before, mods.parameters()))


def test_process_mesh_matches_one_device(card, monkeypatch):
    """``process(mesh=make_chunk_mesh())`` equals ``mesh=None`` bit for bit,
    and two slots of the card (two streams) equal one device at the same
    forward batches, with the fused MRF kernels."""
    import numpy as np

    from egregora_tpu_torch.core.audio import AudioBuffer
    from egregora_tpu_torch.models.flashsr import pipeline as P
    from egregora_tpu_torch.parallel.mesh import ChunkMesh, make_chunk_mesh
    monkeypatch.setenv("EGREGORA_FUSED_VOCODER", "1")
    cfg, sds = chip_smoke.shipped_trio("pretrained.npz")
    pipe = P.FlashSRPipeline(cfg, params=sds)
    audio = AudioBuffer(chip_smoke.test_signal(chip_smoke.SECONDS, 16000, 0), 16000)
    one = pipe.process(audio, mesh=None, wire="f32").numpy()
    assert np.array_equal(pipe.process(audio, mesh=make_chunk_mesh(), wire="f32").numpy(), one)
    want = pipe.process(audio, mesh=None, wire="f32", max_batch=2, pad_to_multiple=2).numpy()
    two = pipe.process(audio, mesh=ChunkMesh(("cuda:0", "cuda:0")), wire="f32").numpy()
    assert np.linalg.norm(two - want) / np.linalg.norm(want) <= chip_smoke.MESH_PROCESS_LIMIT


# ---- the RNNoise, DeepFilterNet and DAC trainers ----

@pytest.mark.parametrize("variant", ["DeepFilterNet2", "DeepFilterNet3"])
def test_dfn_cudnn_gru_gradient_matches_a_step_loop(card, variant):
    """One cuDNN GRU recurrence (``_torch_gru`` / DFN2's grouped form) on the
    card: outputs and the gradients of its weights and input against a
    step loop of plain operations, max |d| 1e-4 of the largest."""
    import numpy as np

    from egregora_tpu_torch.models.deepfilternet import model as D
    from egregora_tpu_torch.models.rnnoise.train import trainable
    from egregora_tpu_torch.ops.fir import exact_f32
    params = trainable(D.init_params(0, D.DFNConfig.for_variant(variant)), "cuda")
    p = params["df_dec"]["gru"]
    x = torch.randn(3, 40, 256, generator=torch.Generator().manual_seed(2)).cuda().requires_grad_()
    w = torch.linspace(-1, 1, 3 * 40 * 256, device="cuda").reshape(3, 40, 256)

    def loop(k, r, b, xs):
        u = r.shape[0]
        h, out = xs.new_zeros(xs.shape[0], u), []
        for t in range(xs.shape[1]):
            xw, hw = xs[:, t] @ k + b, h @ r
            z, rr = torch.sigmoid(xw[:, :u] + hw[:, :u]), torch.sigmoid(xw[:, u:2 * u] + hw[:, u:2 * u])
            h = (1 - z) * torch.tanh(xw[:, 2 * u:] + rr * hw[:, 2 * u:]) + z * h
            out.append(h)
        return torch.stack(out, 1)

    leaves = [p["kernel"], p["recurrent"], p["bias"], x]
    with exact_f32():
        got = D._torch_gru(p["kernel"], p["recurrent"], p["bias"], x)
        g1 = torch.autograd.grad((got * w).sum(), leaves)
        ref = loop(p["kernel"], p["recurrent"], p["bias"], x)
        g2 = torch.autograd.grad((ref * w).sum(), leaves)
    for a, b in zip((got,) + g1, (ref,) + g2):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    seq = D._sequence_model(params, x[..., :256])
    assert seq.requires_grad and np.isfinite(seq.detach().cpu().numpy()).all()


def test_trainers_gradients_match_cpu(card):
    """Each trainer's loss and gradient on the card against the CPU (float32,
    ``chip_smoke.TRAINER_*`` limits), every leaf with a gradient."""
    import numpy as np

    from egregora_tpu_torch.models.deepfilternet import model as D
    from egregora_tpu_torch.models.deepfilternet import train as dtr
    from egregora_tpu_torch.models.rnnoise import model as R
    from egregora_tpu_torch.models.rnnoise import train as rtr
    noisy, clean, vad = rtr.synth_batch(np.random.default_rng(3), 4, 30)
    batch = (chip_smoke.rn_lead_in(noisy), chip_smoke.rn_lead_in(clean), vad)
    cases = [("rnnoise", rtr.loss_fn, R.init_params(1), batch)]
    cases += [(v, dtr.loss_fn, D.init_params(1, D.DFNConfig.for_variant(v)), (noisy, clean))
              for v in ("DeepFilterNet2", "DeepFilterNet3")]
    for label, loss, params, b in cases:
        r = chip_smoke.trainer_check(label, chip_smoke.tree_grads(loss, params, b, "cuda"),
                                     chip_smoke.tree_grads(loss, params, b, "cpu"))
        assert r["ok"], (label, r)


def test_dac_rvq_only_step_decays_encoder_and_decoder(card, monkeypatch):
    """One rvq-only step on the card (a decay large enough to show in
    float32): every encoder and decoder weight shrinks by the decay alone,
    as on the CPU; the quantizer moves."""
    import dataclasses

    from egregora_tpu_torch.models.dac import model as M
    from egregora_tpu_torch.models.dac import train as dtr
    from egregora_tpu_torch.models.flashsr import prng
    from egregora_tpu_torch.models.optim import AdamChain
    cfg = dataclasses.replace(dtr.distilled_config("16khz"), dtype=torch.float32)
    monkeypatch.setattr(dtr, "make_optimizer", lambda m, lr, steps: AdamChain(
        m.parameters(), 1e-2, steps, 0.1, clip=1.0, weight_decay=0.1))
    models = {}
    for dev in ("cuda", "cpu"):
        m = M.DACModel(cfg).init_params(2).to(dev)
        before = {n: p.detach().clone() for n, p in m.named_parameters()}
        dtr._run_phase(m, "proj", dtr.proj_loss_fn, 1, 2, 4096, 1e-2, prng.prng_key(4), 1, 0,
                       use_ema=True, rvq_only=True)
        for n, p in m.named_parameters():
            if n.startswith(("encoder.", "decoder.")):
                assert torch.allclose(p.detach(), before[n] * (1 - 1e-2 * 0.1), rtol=1e-6, atol=0), n
        assert not torch.equal(m.rvq.proj_in_0.weight.detach(), before["rvq.proj_in_0.weight"])
        models[dev] = m
    for (n, a), (_, b) in zip(models["cuda"].named_parameters(), models["cpu"].named_parameters()):
        if n.startswith(("encoder.", "decoder.")):
            assert torch.allclose(a.detach().cpu(), b.detach(), rtol=1e-6, atol=0), n


# ---- the bootstrap and the full-chain example on the card


def test_bootstrap_on_the_card(card, tmp_path, monkeypatch, capsys):
    """``install.main(["--offline"])`` on the card: exit 0, capability
    (9, 0), every source's library built, every warmup ok, K4 launched by
    the loudness warmup."""
    from egregora_tpu_torch import install
    from egregora_tpu_torch.ops import iir_lowpass as il
    from egregora_tpu_torch.utils import cuda_build
    monkeypatch.setenv("EGREGORA_TPU_OFFLINE", "1")
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    before = il.launches_by_shape[(1, 4800)]
    assert install.main(["--offline"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "[deps] compute capability: (9, 0) (sm_90a)" in lines
    assert all(cuda_build.library_path(n).exists() for n in cuda_build.SOURCES)
    assert [ln for ln in lines if ln.startswith("[warmup]")] == \
        [f"[warmup] {w}: ok" for w in chip_smoke.WARMUPS]
    assert il.launches_by_shape[(1, 4800)] == before + 4
    assert lines[-1] == "[install] done"


def test_full_chain_card_matches_cpu(card, tmp_path, monkeypatch):
    """The example on 2 s of speech-like 16 kHz stereo, card against CPU
    within ``chip_smoke.EXAMPLE_WAVE_REL``, with its attention on
    ``attn_rows`` and its meter on K4; ``main`` writes a 96 kHz WAV."""
    import numpy as np

    from egregora_tpu_torch.examples import full_chain as fc
    from egregora_tpu_torch.ops import iir_lowpass as il
    from egregora_tpu_torch.utils.wavio import read_audio, write_audio
    monkeypatch.setenv("EGREGORA_TPU_OFFLINE", "1")
    x = chip_smoke.speech_signal(2.0, 16000, 2, seed=5, gaps=())
    attn, k4 = ar.launches, il.launches
    got, got_m, _ = fc.full_chain(x, 16000, card)
    assert ar.launches > attn and il.launches == k4 + 4
    host, host_m, _ = fc.full_chain(x, 16000, "cpu")
    assert chip_smoke.rel_l2(got.cpu(), host) <= chip_smoke.EXAMPLE_WAVE_REL
    for k, lim in chip_smoke.EXAMPLE_KEY_LIMITS.items():
        assert abs(got_m[k] - host_m[k]) <= lim, (k, got_m[k], host_m[k])
    write_audio(tmp_path / "in.wav", x, 16000)
    fc.main(str(tmp_path / "in.wav"), str(tmp_path / "out.wav"))
    y, sr = read_audio(tmp_path / "out.wav")
    assert sr == 96000 and y.shape == (2, 192000) and np.isfinite(y).all()
