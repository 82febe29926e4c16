"""Chunking and Hann weighted overlap-add (WOLA) stitching, batched.

Counterpart of ``egregora_tpu/ops/wola.py``.  All chunks of a signal
form one batch ``[K, C, win]``; the model runs over the batch, and the
outputs are stitched with a symmetric Hann window over each chunk's
valid (unpadded) samples, normalised by the summed weight (zero weight
guarded to 1) — the reference node's ``_iter_chunks``/``_wola_stitch``
semantics.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stft import device_tensor, frame_strided, hann_symmetric


def iter_chunks(total_samples: int, win: int, hop: int) -> List[Tuple[int, int]]:
    """(start, length) spans covering [0, total)."""
    spans: List[Tuple[int, int]] = []
    i = 0
    while i < total_samples:
        length = min(win, total_samples - i)
        spans.append((i, length))
        if i + length >= total_samples:
            break
        i += hop
    return spans


def num_chunks(total_samples: int, win: int, hop: int) -> int:
    return len(iter_chunks(total_samples, win, hop))


def chunk_batch(x_cs: torch.Tensor, win: int, hop: int, pad_to_multiple: int = 1
                ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Slice ``[C, S]`` into a zero-padded chunk batch ``[K, C, win]``.

    Returns (chunks, starts[K], lengths[K]).  ``pad_to_multiple`` rounds
    K up with all-zero dummy chunks whose starts continue the ``i*hop``
    grid and whose lengths are 0 (zero stitch weight)."""
    c, total = x_cs.shape
    spans = iter_chunks(total, win, hop)
    k_pad = -(-len(spans) // pad_to_multiple) * pad_to_multiple
    starts = (np.arange(k_pad, dtype=np.int64) * hop).astype(np.int32)
    lengths = np.zeros(k_pad, dtype=np.int32)
    for i, (s, l) in enumerate(spans):
        starts[i], lengths[i] = s, l
    x_pad = F.pad(x_cs.float(), (0, (k_pad - 1) * hop + win - total))
    chunks = frame_strided(x_pad, win, hop)[:, :k_pad].transpose(0, 1)   # [K, C, win]
    lens = torch.as_tensor(lengths, device=x_cs.device)
    mask = torch.arange(win, device=x_cs.device)[None, :] < lens[:, None]
    return chunks * mask[:, None, :], starts, lengths


def _weights(lengths, win: int, device) -> torch.Tensor:
    """``[K, win]`` stitch weights: Hann taps below each valid length."""
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=device)
    valid = torch.arange(win, device=device)[None, :] < lens[:, None]
    hann = device_tensor(hann_symmetric, win, device=str(device))
    return torch.where(valid, hann[None, :], 0.0)


def wola_accumulate(preds: torch.Tensor, starts, lengths, acc: torch.Tensor,
                    wsum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add one chunk batch's weighted contributions into running
    ``(acc [C, total], wsum [total])`` for arbitrary ``starts``; taps
    past ``total`` are dropped.  Updates ``acc`` and ``wsum`` in place."""
    k, c, win = preds.shape
    dev = preds.device
    wgt = _weights(lengths, win, dev)                                 # [K, win]
    tap = torch.arange(win, device=dev)[None, :]
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int64, device=dev)
    pos = torch.as_tensor(np.asarray(starts), dtype=torch.int64, device=dev)[:, None] + tap
    keep = ((tap < lens[:, None]) & (pos < acc.shape[-1])).reshape(-1)
    flat = pos.reshape(-1)[keep]
    weighted = (preds * wgt[:, None, :]).transpose(0, 1).reshape(c, -1)[:, keep]
    acc.index_add_(1, flat, weighted.to(acc.dtype))
    wsum.index_add_(0, flat, wgt.reshape(-1)[keep])
    return acc, wsum


def wola_finalize(acc: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Normalise accumulated sums; zero weight guards to 1."""
    wsum = torch.where(wsum == 0.0, torch.ones_like(wsum), wsum)
    return (acc / wsum[None, :]).float()


def _regular_hop(starts, win: int) -> Optional[int]:
    """The grid's hop if ``starts`` is the regular ``i*hop`` grid with
    ``win <= 2*hop`` (always so for ``chunk_batch`` output), else None."""
    s = np.asarray(starts)
    if s.ndim != 1 or s.size == 0 or s[0] != 0:
        return None
    if s.size == 1:
        return int(win)
    hop = int(s[1] - s[0])
    if hop <= 0 or win > 2 * hop:
        return None
    if not np.array_equal(s, np.arange(s.size, dtype=np.int64) * hop):
        return None
    return hop


def _wola_dense_tracks(preds: torch.Tensor, lengths, hop: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-free OLA of a contiguous regular-grid chunk batch: with
    ``win <= 2*hop`` each output sample receives at most two chunks, so
    the overlap-add is two shifted dense tracks.  Returns
    ``(acc [C, (K+1)*hop], wsum [(K+1)*hop])`` from chunk 0's start."""
    k, c, w = preds.shape
    wgt = _weights(lengths, w, preds.device)                        # [K, w]
    pad_w = 2 * hop - w
    weighted = F.pad(preds * wgt[:, None, :], (0, pad_w))            # [K, C, 2hop]
    wgt2 = F.pad(wgt, (0, pad_w))
    ta = weighted[:, :, :hop].transpose(0, 1).reshape(c, k * hop)
    tb = weighted[:, :, hop:].transpose(0, 1).reshape(c, k * hop)
    acc = F.pad(ta, (0, hop)) + F.pad(tb, (hop, 0))
    wsum = F.pad(wgt2[:, :hop].reshape(-1), (0, hop)) + F.pad(wgt2[:, hop:].reshape(-1), (hop, 0))
    return acc, wsum


def wola_accumulate_dense(preds: torch.Tensor, lengths, hop: int, acc: torch.Tensor,
                          wsum: torch.Tensor, offset: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one contiguous regular-grid chunk batch, whose first chunk
    starts at ``offset``, into running ``(acc, wsum)``.  The accumulators
    need ``(K+1)*hop`` samples of room past ``offset``.  Updates ``acc``
    and ``wsum`` in place (the streaming path keeps one pair for the
    whole input) and returns them."""
    seg_a, seg_w = _wola_dense_tracks(preds, lengths, hop)
    seg = seg_a.shape[-1]
    acc[:, offset: offset + seg] += seg_a
    wsum[offset: offset + seg] += seg_w
    return acc, wsum


def wola_stitch(preds: torch.Tensor, starts, lengths, total_len: int,
                win: int) -> torch.Tensor:
    """Hann-weighted overlap-add of ``[K, C, win]`` chunk outputs ->
    ``[C, total]``.  Regular-grid inputs (``chunk_batch``'s always are)
    take the dense two-track path; other ``starts`` the scatter-add."""
    k, c, w = preds.shape
    hop = _regular_hop(starts, w)
    if hop is not None:
        acc, wsum = _wola_dense_tracks(preds, lengths, hop)
        return wola_finalize(acc[:, :total_len], wsum[:total_len])
    acc = preds.new_zeros((c, total_len))
    wsum = torch.zeros(total_len, device=preds.device)
    acc, wsum = wola_accumulate(preds, starts, lengths, acc, wsum)
    return wola_finalize(acc, wsum)
