"""PyTorch port vs the JAX package: the last two TPU kernels' plain versions.

``flash_online`` (K1b, ``ops/attn_flash.py``) and ``conv3x3_out1`` (K3,
``ops/conv_edge.py``) on CPU tensors run their plain versions; the same
seeded inputs go through the JAX kernels in interpret mode.  Both port
versions also take the sizes the JAX kernels refuse (N not a multiple of
block_k, F not a multiple of f_tile), held there against the JAX
package's plain references.  The CUDA kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.ops.attention import unrolled_attention
from egregora_tpu.ops.attn_flash import flash_online as j_flash_online
from egregora_tpu.ops.conv_edge import conv3x3_out1 as j_conv3x3_out1
import chip_smoke
from egregora_tpu_torch.ops import attn_flash, conv_edge
from egregora_tpu_torch.tools import attn_flash_lab, edge_conv_lab

# float32 results: both sides sum in float32 in other orders
F32_REL = 1e-5


def bf16_limit(ref: np.ndarray) -> float:
    """Two bf16 ulps of max |ref|: both sides round their float32 result to
    bf16 once, so a sound port differs by an ulp here and there."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 6)


def _qkv(b, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(3)]


def _cast(arrays, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


@pytest.mark.parametrize("b,n,d,bq,bk,dtype", [
    (16, 512, 32, 256, 256, torch.bfloat16),    # tests/test_attn_pallas.py's three shapes
    (8, 512, 64, 512, 128, torch.bfloat16),
    (2, 1024, 256, 256, 512, torch.bfloat16),
    (2, 512, 512, 128, 256, torch.bfloat16),    # the published VAE mid block's head size
    (2, 384, 64, 256, 128, torch.float32),      # ragged q blocks, float32
])
def test_flash_online_plain_matches_jax(b, n, d, bq, bk, dtype):
    arrays = _qkv(b, n, d, seed=n + d)
    (jq, jk, jv), (tq, tk, tv) = _cast(arrays, dtype)
    ref = np.asarray(j_flash_online(jq, jk, jv, block_q=bq, block_k=bk,
                                    interpret=True)).astype(np.float32)
    got = attn_flash.flash_online(tq, tk, tv, block_q=bq, block_k=bk)
    assert got.dtype == dtype and tuple(got.shape) == (b, n, d)
    err = float(np.abs(got.float().numpy() - ref).max())
    limit = bf16_limit(ref) if dtype == torch.bfloat16 else F32_REL * float(np.abs(ref).max())
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("n,bk,dtype", [(1000, 256, torch.bfloat16), (333, 64, torch.float32),
                                        (77, 1024, torch.bfloat16)])
def test_flash_online_takes_ragged_n(n, bk, dtype):
    """N % block_k != 0: the JAX kernel raises; the port masks the last key
    block and matches the JAX package's exact attention."""
    arrays = _qkv(2, n, 64, seed=n)
    (jq, jk, jv), (tq, tk, tv) = _cast(arrays, dtype)
    if n % min(bk, n):
        with pytest.raises(ValueError, match="not a multiple of block_k"):
            j_flash_online(jq, jk, jv, block_q=128, block_k=bk, interpret=True)
    ref = np.asarray(unrolled_attention(jq, jk, jv)).astype(np.float32)
    got = attn_flash.flash_online(tq, tk, tv, block_q=128, block_k=bk).float().numpy()
    err = float(np.abs(got - ref).max())
    # bf16: both round once, after different f32 softmax formulations
    limit = bf16_limit(ref) if dtype == torch.bfloat16 else F32_REL * float(np.abs(ref).max())
    assert err <= limit, (err, limit)


def test_flash_online_tiles_clamp_to_built():
    """Requested blocks map to the largest built tile not above them (the
    smallest where none is), per dtype and padded head size."""
    bf, f32 = torch.bfloat16, torch.float32
    assert attn_flash.kernel_tile(bf, 32, 512, 1024) == (32, 128, 128)
    assert attn_flash.kernel_tile(bf, 256, 512, 1024) == (256, 64, 64)
    assert attn_flash.kernel_tile(bf, 320, 64, 64) == (512, 32, 32)
    assert attn_flash.kernel_tile(bf, 128, 100, 48) == (128, 64, 32)
    assert attn_flash.kernel_tile(bf, 64, 16, 16) == (64, 64, 32)
    assert attn_flash.kernel_tile(f32, 512, 512, 1024) == (512, 16, 32)
    assert attn_flash.kernel_tile(f32, 40, 32, 64) == (64, 32, 64)
    for table in (attn_flash.BF16_TILES, attn_flash.F32_TILES):
        assert set(table) == set(attn_flash.KERNEL_D)


def test_flash_online_tiling_does_not_change_the_result():
    """The plain version at two tilings: float32 rounding apart."""
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(3, 300, 48, seed=9))
    a = attn_flash.flash_online(tq, tk, tv, block_q=64, block_k=32)
    b = attn_flash.flash_online(tq, tk, tv, block_q=300, block_k=300)
    assert float((a - b).abs().max()) <= F32_REL * float(b.abs().max())


def _conv_inputs(b, f, m, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f, m, c)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, c, 1))).astype(np.float32)
    bias = np.array([0.3], np.float32)
    return x, w, bias


@pytest.mark.parametrize("c,dtype", [(24, torch.float32), (24, torch.bfloat16),
                                     (64, torch.bfloat16), (64, torch.float32)])
def test_conv3x3_out1_plain_matches_jax(c, dtype):
    """C = 24 (the compact trios' decoder) and 64 (the full config's)."""
    x, w, bias = _conv_inputs(2, 64, 32, c, seed=c)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(j_conv3x3_out1(jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(bias),
                                    f_tile=32, interpret=True))
    got = conv_edge.conv3x3_out1(torch.from_numpy(x).to(dtype), torch.from_numpy(w),
                                 torch.from_numpy(bias), f_tile=32)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 64, 32, 1)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= F32_REL * float(np.abs(ref).max()), err


@pytest.mark.parametrize("f,m,c", [(37, 45, 24), (9, 7, 5)])
def test_conv3x3_out1_takes_ragged_f(f, m, c):
    """F % f_tile != 0: the JAX kernel raises; the port matches XLA's
    'SAME' conv (``lax.conv_general_dilated``) on the bf16-rounded
    operands in float32."""
    x, w, bias = _conv_inputs(2, f, m, c, seed=f)
    with pytest.raises(ValueError, match="not a multiple of f_tile"):
        j_conv3x3_out1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), f_tile=8,
                       interpret=True)
    xb = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
    wb = jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        xb, wb, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + bias[0])
    got = conv_edge.conv3x3_out1(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                                 torch.from_numpy(bias), f_tile=8)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= F32_REL * float(np.abs(ref).max()), err


def test_wrappers_refuse_other_devices_and_shapes():
    """The wrappers run the plain version only for CPU tensors; a tensor
    on another device raises (no fallback), and a wrong kernel shape
    raises before anything runs."""
    q = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attn_flash.flash_online(q, q, q)
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_edge.conv3x3_out1(x, torch.zeros(3, 3, 8, 1), torch.zeros(1))
    with pytest.raises(ValueError, match="is not"):
        conv_edge.conv3x3_out1(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 4, 1), torch.zeros(1))
    assert attn_flash.launches == 0 and conv_edge.launches == 0


def test_smoke_planted_halo_fault_is_what_it_says():
    """``chip_smoke.drop_bottom_halo`` equals the plain conv with the row
    below each 8-row tile zeroed for that tile's last row, and the card
    run's limits (``chip_smoke.f32_agreement``) reject it while the tile
    edges ``k3_edges`` reads lie where the fault shows."""
    x, w, bias = (torch.from_numpy(a) for a in _conv_inputs(2, 21, 40, 16, seed=4))
    xb = x.bfloat16()
    bad = chip_smoke.drop_bottom_halo(xb, w, bias)
    plain = conv_edge.conv3x3_out1_plain(xb, w, bias)
    for r in range(21):
        xr = xb.clone()
        if r % 8 == 7 and r + 1 < 21:
            xr[:, r + 1] = 0
        want = conv_edge.conv3x3_out1_plain(xr, w, bias)[:, r]
        torch.testing.assert_close(bad[:, r], want, rtol=0, atol=1e-5)
    assert not chip_smoke.f32_agreement(bad, plain)[0]
    assert chip_smoke.f32_agreement(plain.clone(), plain)[0]
    edges = chip_smoke.k3_edges(bad) - chip_smoke.k3_edges(plain)
    assert float(edges.abs().max()) == float((bad - plain).abs().max())


def test_edge_lab_variants_agree_on_the_cpu():
    """The edge lab's decoder and encoder variants compute the same conv
    (bf16 outputs of the cuDNN-style calls round once)."""
    x, w, bias = (torch.from_numpy(a) for a in _conv_inputs(2, 16, 12, 8, seed=2))
    xb = x.bfloat16()
    plain = conv_edge.conv3x3_out1_plain(xb, w, bias)
    for name, fn in edge_conv_lab._decoder_variants(xb, w, bias):
        y = fn().float()
        assert y.shape == plain.shape, name
        assert float((y - plain).abs().max()) <= bf16_limit(plain.numpy()), name
    x1 = xb[..., :1].contiguous()
    w64 = 0.1 * torch.randn(3, 3, 1, 64, generator=torch.Generator().manual_seed(0))
    variants = edge_conv_lab._encoder_variants(x1, w64, torch.full((64,), 0.1))
    ref = variants[1][1]()
    for name, fn in variants:
        assert float((fn().float() - ref).abs().max()) <= bf16_limit(ref.numpy()), name


@pytest.mark.parametrize("lab", [attn_flash_lab, edge_conv_lab])
def test_labs_refuse_to_run_without_a_card(lab):
    """The labs time the kernels on the card and nowhere else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        lab.main(["--rounds", "1"])
