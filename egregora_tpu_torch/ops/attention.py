"""Scaled-dot-product attention for the FlashSR stack.

``mha`` is what every attention block of the full config calls: the
LDM UNet's ``LDMAttentionBlock`` (8 heads; N=2048, D=32 at ds=2 and
N=512, D=64 at ds=4), the served trios' StudentUNet mid block (4 heads,
N=512, D=32) and the VAE's mid ``AttnBlock2D`` (one head, N=8192,
D=256; D=512 at the published checkpoints' geometry).  It folds heads
into the batch and picks an engine by ``EGREGORA_ATTN_PATH``, as the JAX
package's ``mha`` does:

* ``auto`` (default): the hand-written kernel (``ops.attn_rows``) on the
  card, ``chunked_attention`` on the CPU (the JAX ``auto`` runs its
  chunked engine off the TPU);
* ``pallas``: ``attn_rows`` (the port of the Pallas ``flash_rows``) on
  any device; for CPU tensors it runs its plain version;
* ``chunked`` and ``unroll``: the JAX package's XLA engines, picked by
  hand; here both run ``chunked_attention`` in plain PyTorch (cuBLAS
  products on the card), which scales q before the product, takes
  ``EGREGORA_ATTN_BLOCK`` query rows a block and rounds the QK product to
  bf16 under ``EGREGORA_ATTN_SCORES=bf16``.

Any other value raises ``ValueError``: a misspelt path never takes the
card off its kernel silently.
"""
from __future__ import annotations

import os

import torch

from .attn_rows import attn_rows


def _scores_dtype() -> torch.dtype:
    """The dtype the QK product is rounded to before the float32 softmax:
    bf16 under ``EGREGORA_ATTN_SCORES=bf16`` (the JAX engines then write
    their score blocks in bf16: the logits round by 2^-8 relative), else
    float32."""
    return (torch.bfloat16 if os.environ.get("EGREGORA_ATTN_SCORES", "") == "bf16"
            else torch.float32)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block: int = 256) -> torch.Tensor:
    """Exact single-head attention ``[B, N, D]`` with query chunking (the
    JAX ``chunked_attention``), the ``[N, N]`` matrix never formed: q
    scaled by ``D**-0.5`` in its own dtype first, then per block of
    ``block`` rows its whole score row ``[block, N]``: the f32 product
    rounded to the scores dtype, a float32 softmax, weights rounded to the
    value dtype, f32 accumulation, the value dtype out."""
    n, d = q.shape[-2:]
    q = q * d ** -0.5
    sd = _scores_dtype()
    kt, vf = k.float().transpose(1, 2), v.float()
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for i in range(0, n, block):
        s = torch.matmul(q[:, i:i + block].float(), kt).to(sd).float()
        w = torch.softmax(s, dim=-1).to(v.dtype)
        out[:, i:i + block] = torch.matmul(w.float(), vf).to(v.dtype)
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention ``[B, H, N, D] -> [B, H, N, D]`` on the engine
    ``EGREGORA_ATTN_PATH`` names (module docstring).

    ``EGREGORA_ATTN_BLOCK`` sets the chunked engine's query block.  On the
    kernel path it changes only the tiling, never the result, and the
    Hopper kernel's tile is fixed by its ``wgmma`` layout
    (``attn_rows.BF16_TILES``), so there it is ignored; the JAX pallas
    path ignores ``EGREGORA_ATTN_SCORES``, and so does this one.

    ``EGREGORA_ATTN_SCORES=bf16`` is for numerical parity with the JAX
    engines only: on the card the product is still formed in float32 and
    then rounded, so it saves no traffic, as it does on the TPU, and only
    lowers precision."""
    b, h, n, d = q.shape
    path = os.environ.get("EGREGORA_ATTN_PATH", "auto")
    if path not in ("auto", "pallas", "chunked", "unroll"):
        raise ValueError(f"EGREGORA_ATTN_PATH={path!r}: expected auto, "
                         "pallas, chunked or unroll")
    if path == "auto":
        path = "pallas" if q.device.type == "cuda" else "chunked"
    q3, k3, v3 = (t.reshape(b * h, n, d).contiguous() for t in (q, k, v))
    if path == "pallas":
        o = attn_rows(q3, k3, v3)
    else:
        # "unroll" names the JAX package's loop-free XLA engine; eager
        # PyTorch has no loop carry to avoid, so it runs the same blocks.
        blk = os.environ.get("EGREGORA_ATTN_BLOCK", "")
        o = chunked_attention(q3, k3, v3, **({"block": int(blk)} if blk else {}))
    return o.reshape(b, h, n, d)
