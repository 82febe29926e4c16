"""PyTorch port vs the JAX package: attention and the noise latent.

The plain version of the port's attention kernel (``attn_rows_plain``,
what ``attn_rows`` runs for CPU tensors) against the Pallas kernel it
replaces,
``flash_rows``, run in interpret mode as ``tests/test_attn_pallas.py``
runs it: in bf16 within ``chip_smoke.bf16_agreement``'s limits (relative
L2 1e-2, max |d| two bf16 ulps of the largest output), in float32 within
1e-4.  The CUDA kernel itself is checked on the card, against the same
limits (``tests/test_torch_cuda.py`` and ``chip_smoke.py``); here the
limits are shown to pass the kernel's arithmetic, emulated in PyTorch,
and to reject planted faults of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from egregora_tpu.ops.attn_pallas import flash_rows
from egregora_tpu_torch.models.flashsr import prng
from egregora_tpu_torch.ops import attn_rows as ar
from egregora_tpu_torch.ops.attention import chunked_attention, mha


def _qkv(b, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(3)]


def _exact(q, k, v):
    s = np.einsum("bqc,bkc->bqk", q.astype(np.float64), k) / np.sqrt(q.shape[-1])
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bqk,bkc->bqc", w / w.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("b,n,d,bq", [
    (16, 512, 32, 256),    # UNet ds=2 family (B*H folded)
    (8, 512, 64, 512),     # UNet ds=4 family
    (2, 1024, 256, 256),   # VAE mid-block family
    (4, 300, 64, 128),     # ragged N: not a multiple of any block
])
def test_plain_matches_flash_rows_bf16(b, n, d, bq):
    q, k, v = _qkv(b, n, d, 7)
    ref = np.asarray(flash_rows(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                block_q=bq, interpret=True)).astype(np.float32)
    got = ar.attn_rows(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, d)
    ok, rel, err, limit = chip_smoke.bf16_agreement(got, torch.from_numpy(ref))
    assert ok, (rel, err, limit)


def _online(q, k, v, rescale=True, drop_last=False):
    """``csrc/attn_rows.cu``'s arithmetic in PyTorch: the bf16 kernel's key
    tiles (``BF16_TILES``), f32 running max and sum, unnormalised weights
    rounded to bf16 (the sum adds the rounded weights), f32 accumulator,
    one division and one bf16 rounding at the end.  ``rescale=False`` and
    ``drop_last=True`` plant the faults a kernel could have."""
    b, n, d = q.shape
    tile = ar.BF16_TILES[d][1]
    m = torch.full((b, n, 1), float("-inf"))
    l, acc = torch.zeros(b, n, 1), torch.zeros(b, n, d)
    starts = list(range(0, n, tile))
    for s0 in starts[:-1] if drop_last else starts:
        s = (q.float() @ k[:, s0:s0 + tile].float().transpose(1, 2)) * d ** -0.5
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        p = torch.exp(s - m_new).to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ v[:, s0:s0 + tile].float()
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "drop_last_tile", "no_rescale", "plain_drop"])
@pytest.mark.parametrize("b,n,d", [(4, 512, 32), (2, 1000, 64), (1, 1000, 256)])
def test_bf16_limits_pass_kernel_math_and_reject_faults(b, n, d, fault):
    """The card check's limits hold the kernel's own rounding (relative
    L2 ~3e-3, max |d| one ulp) and reject each planted fault (relative L2
    9e-2 and more)."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(b, n, d, 5))
    plain = ar.attn_rows_plain(q, k, v)
    got = {"none": lambda: _online(q, k, v),
           "drop_last_tile": lambda: _online(q, k, v, drop_last=True),
           "no_rescale": lambda: _online(q, k, v, rescale=False),
           "plain_drop": lambda: chip_smoke.drop_last_tile(q, k, v)}[fault]()
    ok, rel, err, limit = chip_smoke.bf16_agreement(got, plain)
    assert ok == (fault == "none"), (rel, err, limit)


def test_card_cases_cover_every_bf16_tile():
    """``tests/test_torch_cuda.py``'s bf16 cases reach every built head
    size at N = 1, 17 and 1000 with BH up to 26, and 8191 at D = 512."""
    import test_torch_cuda
    cases = set(test_torch_cuda.BF16_CASES)
    for d in ar.KERNEL_D:
        assert {n for dd, _, n in cases if dd == d} >= {1, 17, 1000}
    assert (512, 3, 8191) in cases
    assert max(bh for _, bh, _ in cases) == 26


@pytest.mark.parametrize("d,tile", [
    (32, (32, 64, 128)),      # UNet ds=2 and the served trios' mid block
    (40, (64, 64, 128)),      # padded to 64
    (64, (64, 64, 128)),      # UNet ds=4
    (256, (256, 64, 64)),     # full config's VAE mid block
    (320, (512, 64, 32)),     # padded to 512: two warpgroups split D
    (512, (512, 64, 32)),     # published VAE mid block
])
def test_attn_rows_tile_choice(d, tile):
    assert ar.kernel_tile(d) == tile


def test_planted_fault_drops_the_kernels_smaller_tile():
    """The planted fault drops ``KEY_TILE`` keys, or the kernel's key tile
    where that is smaller: 32 at D = 512."""
    assert chip_smoke.KEY_TILE == 64
    assert {d: chip_smoke.fault_tile(d) for d in ar.KERNEL_D} == {
        32: 64, 64: 64, 128: 64, 256: 64, 512: 32}
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(1, 200, 512, 4))
    dropped = chip_smoke.drop_last_tile(q, k, v)
    assert torch.equal(dropped, ar.attn_rows_plain(q, k[:, :192], v[:, :192]))


def test_lab_loads_another_checkout_beside_this_one():
    """``attn_flash_lab --root`` times another checkout's kernels in the
    same process: ``load_checkout`` imports that checkout's package under
    another name, whose wrappers run apart from this package's (here
    their plain versions, on the CPU)."""
    from pathlib import Path

    from egregora_tpu_torch.ops import attn_flash
    from egregora_tpu_torch.tools import attn_flash_lab as lab
    other_af, other_ar = lab.load_checkout(Path(chip_smoke.__file__).parent)
    assert other_ar is not ar and other_af is not attn_flash
    assert other_af.__name__.endswith(".ops.attn_flash") and other_af.__name__ != attn_flash.__name__
    assert other_af.BF16_TILES == attn_flash.BF16_TILES
    assert lab.load_checkout(Path(chip_smoke.__file__).parent)[1] is other_ar
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(2, 100, 32, 6))
    assert torch.equal(other_ar.attn_rows(q, k, v), ar.attn_rows(q, k, v))
    assert torch.equal(other_af.flash_online(q, k, v, 64, 64),
                       attn_flash.flash_online(q, k, v, 64, 64))


@pytest.mark.parametrize("n", [512, 300])
def test_plain_f32_close_to_flash_rows_and_exact(n):
    q, k, v = _qkv(4, n, 32, 3)
    ref = np.asarray(flash_rows(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                block_q=256, interpret=True))
    got = ar.attn_rows_plain(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(got - _exact(q, k, v)).max() < 1e-4


def test_mha_folds_heads_and_counts_no_cpu_launch():
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 100, 32)).astype(np.float32))
               for _ in range(3))
    before = ar.launches
    o = mha(q, k, v)
    assert ar.launches == before          # CPU tensors take the plain version
    ref = chunked_attention(q.reshape(6, 100, 32), k.reshape(6, 100, 32),
                            v.reshape(6, 100, 32)).reshape(2, 3, 100, 32)
    assert torch.equal(o, ref)


def test_attn_rows_rejects_other_devices():
    q = torch.zeros(1, 8, 32, device="meta")
    with pytest.raises(ValueError):
        ar.attn_rows(q, q, q)


@pytest.mark.parametrize("seed,shape", [(0, (1, 128, 64, 16)), (7, (3, 5)), (2 ** 31 + 5, (2, 9))])
def test_prng_normal_matches_jax(seed, shape):
    """The noise latent at the full latent shape, bits exactly and the
    normals within 1e-6 (XLA's float32 erfinv rounds a little differently
    from numpy's emulation of it)."""
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(prng.prng_key(seed), shape),
                                  np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    ref = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = prng.normal(seed, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.abs(got - ref).max() <= 1e-6
    with pytest.raises(ValueError):
        prng.prng_key(-1)
