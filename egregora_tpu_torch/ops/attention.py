"""Scaled-dot-product attention for the FlashSR stack.

``mha`` is what every attention block of the full config calls: the
LDM UNet's ``LDMAttentionBlock`` (8 heads; N=2048, D=32 at ds=2 and
N=512, D=64 at ds=4) and the VAE's mid ``AttnBlock2D`` (one head,
N=8192, D=256; D=512 at the published checkpoints' geometry).  It folds heads into the batch and runs the hand-written
kernel (``ops.attn_rows``) on the card, or its plain version,
``chunked_attention``, for CPU tensors.
"""
from __future__ import annotations

import torch

from .attn_rows import attn_rows


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block: int = 256) -> torch.Tensor:
    """Exact single-head attention ``[B, N, D]`` with query chunking.

    Each query block's whole score row ``[block, N]`` is formed in f32
    (scale applied after the product), softmaxed with the true row max,
    rounded to the value dtype and multiplied into v with f32
    accumulation; the output takes q's dtype.  The ``[N, N]`` matrix is
    never formed."""
    n, d = q.shape[-2:]
    scale = d ** -0.5
    kt, vf = k.float().transpose(1, 2), v.float()
    out = torch.empty_like(q)
    for i in range(0, n, block):
        s = torch.matmul(q[:, i:i + block].float(), kt) * scale
        w = torch.softmax(s, dim=-1).to(v.dtype)
        out[:, i:i + block] = torch.matmul(w.float(), vf).to(q.dtype)
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention ``[B, H, N, D] -> [B, H, N, D]``."""
    b, h, n, d = q.shape
    o = attn_rows(q.reshape(b * h, n, d).contiguous(),
                  k.reshape(b * h, n, d).contiguous(),
                  v.reshape(b * h, n, d).contiguous())
    return o.reshape(b, h, n, d)
