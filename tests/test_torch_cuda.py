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
                                    (3, 77, 64), (1, 8192, 256)])
def test_attn_rows_matches_plain(card, bh, n, d):
    """bf16 in and out, within ``chip_smoke.bf16_agreement``'s limits of
    the plain version (relative L2 1e-2, max |d| two bf16 ulps of the
    largest output); one launch counted, under its shape."""
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


def test_attn_rows_rejects_what_it_does_not_take(card):
    q = torch.zeros(2, 64, 32, device=card)
    with pytest.raises(TypeError):
        ar.attn_rows(q, q, q)                       # float32
    qb = torch.zeros(2, 64, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ar.attn_rows(qb, qb, qb)                    # head dim 48
    qt = torch.zeros(2, 32, 64, device=card, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        ar.attn_rows(qt, qt, qt)                    # not contiguous
