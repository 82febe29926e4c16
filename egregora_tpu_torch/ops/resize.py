"""Nearest-neighbour 2x spatial upsampling by pixel duplication.

Counterpart of ``egregora_tpu/ops/resize.py::upsample2x_nearest`` (torch
``F.interpolate(scale_factor=2, mode="nearest")`` semantics for integer
factors), on the port's NCHW layout.
"""
import torch


def upsample2x_nearest(h: torch.Tensor) -> torch.Tensor:
    """[B, C, F, M] -> [B, C, 2F, 2M] by exact pixel duplication."""
    b, c, f, m = h.shape
    return h[:, :, :, None, :, None].expand(b, c, f, 2, m, 2).reshape(b, c, 2 * f, 2 * m)
