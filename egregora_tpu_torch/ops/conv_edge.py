"""Wrapper of the hand-written one-output-channel 3x3 conv ``csrc/conv_edge.cu``.

The port of ``egregora_tpu/ops/conv_edge.py::conv3x3_out1``: the 'SAME'
3x3 convolution ``[B, F, M, C] x [3, 3, C, 1] -> [B, F, M, 1]`` (the
flax kernel layout) with float32 accumulation and output plus the bias,
what the VAE decoder's final ``nn.Conv(1, (3, 3))`` computes.  bf16 or
float32 input, any B, F, M and C (the JAX kernel refuses F % f_tile !=
0).  As in the JAX kernel, the weights are rounded to the input's dtype
and every product is summed in float32.

Two routes, a rule of shape and dtype (``bf16_plan``), each its own
entry of the library:

- **tensor cores** (bf16, C % 8 == 0, C <= 4096, x 16-byte aligned: what
  a TMA tensor map addresses): the nine taps' per-pixel partials ``D = x
  @ W16`` by wgmma over a TMA ring of row slabs, then their 3 x 3 stencil
  in float32; ``tap_partials_model`` is that schedule on the CPU;
- **CUDA cores** (float32 at any C, bf16 at any other C or alignment):
  the staged-halo FMA kernel.

``f_tile`` is the most rows a block walks (an F segment).  On the
tensor-core route the segments take at most ``SEGMENT_ROWS`` and are
shortened, in steps of 8 rows, until the grid holds ``BLOCKS_PER_SM``
blocks an SM (B = 3 would otherwise leave most SMs idle); on the
CUDA-core route they are rounded up to its 8-row step.  A CUDA tensor goes to the kernel or raises; a CPU tensor
goes to the plain version, ``conv3x3_out1_plain``, nine shifted products
over a zero-padded copy.  ``launches`` counts kernel launches, in all,
by (b, f, m, c) and by route.

Not wired into the port's VAE decoder: the JAX package never wires its
kernel in either.  ``tools/edge_conv_lab.py`` and ``chip_smoke.py``
launch it and time it against cuDNN.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build

TC, CC = "tensor cores", "CUDA cores"
ENTRIES = {(torch.bfloat16, TC): "conv_edge_bf16_tc", (torch.bfloat16, CC): "conv_edge_bf16_cc",
           (torch.float32, CC): "conv_edge_f32"}
# the tensor-core route (csrc/conv_edge.cu, namespace tc)
STRIP = 64              # output columns a block
BOX_CH = 64             # channels a TMA box
BOX_COLS = STRIP + 2    # pixels a slab: the strip and its halo columns
STAGES = 4              # slabs in the ring
MAX_TC_C = 4096
BLOCKS_PER_SM = 2       # the grid the segment rows fill at least
SEGMENT_ROWS = 40       # the most rows a segment takes (longer ones leave a tail of
                        # blocks on a few SMs: 64 rows ran 10% slower at B = 26)
# the CUDA-core route (namespace staged)
ROW_STEP = 8            # output rows a step of a block
CC_COLS = 32            # output columns a block


class Plan(NamedTuple):
    """The block a launch runs, in the order of ``conv_edge_bf16_layout``."""
    route: int          # 1: tensor cores, 0: CUDA cores
    cols: int           # output columns a block
    row_step: int       # a segment's rows are a multiple of it
    threads: int
    smem_bytes: int     # dynamic shared memory
    stages: int         # TMA ring stages (0: none)


@functools.lru_cache(maxsize=None)
def bf16_plan(c: int, aligned: bool = True) -> Plan:
    """The block a bf16 x of C channels launches (16-byte aligned or not):
    the wrapper's mirror of the library's ``conv_edge_bf16_layout``."""
    if aligned and c % 8 == 0 and c <= MAX_TC_C:
        nbox = -(-c // BOX_CH)
        smem = 1024 + STAGES * 72 * 128 + nbox * 16 * 128 + 2 * 9 * 68 * 4 + 2 * STAGES * 8
        return Plan(1, STRIP, 1, 160, smem, STAGES)
    return Plan(0, CC_COLS, ROW_STEP, 256, 10 * 34 * 72 * 2 + 9 * 64 * 4, 0)


# float32 takes the CUDA-core route at every C (tensor cores round to TF32)
F32_PLAN = Plan(0, CC_COLS, ROW_STEP, 256, 10 * 34 * 36 * 4 + 9 * 32 * 4, 0)

# kernel launches since the last reset, in all, by shape (b, f, m, c) and
# by route; counted where the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()
launches_by_route: collections.Counter = collections.Counter()
# the FLOPs of every call of the public function, appended whatever the
# route (kernel or plain): an operator-level count sees none of a hand
# kernel's work, as XLA's cost analysis sees none of a Pallas call's
# (the JAX ``conv_edge.FLOP_LOG``: ``2 * 9 * B * F * M * C`` a call)
FLOP_LOG: list = []

_FNS: dict = {}
_SMS: dict = {}


def _kernel(dtype: torch.dtype, route: str):
    fn = _FNS.get((dtype, route))
    if fn is None:
        fn = getattr(cuda_build.load("conv_edge"), ENTRIES[(dtype, route)])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[(dtype, route)] = fn
    return fn


def plan_of(x: torch.Tensor) -> Plan:
    """The plan of a launch on x (its dtype, C and alignment)."""
    if x.dtype == torch.float32:
        return F32_PLAN
    return bf16_plan(x.shape[-1], x.data_ptr() % 16 == 0)


def segment_rows(b: int, f: int, m: int, f_tile: int, plan: Plan, sms: int) -> int:
    """Output rows a block walks: at most ``f_tile``; on the tensor-core
    route at most ``SEGMENT_ROWS`` and no more than fill ``BLOCKS_PER_SM``
    blocks on each of ``sms`` SMs (in steps of 8 rows), on the CUDA-core
    route a multiple of its 8-row step."""
    if not plan.route:
        return -(-min(f_tile, f) // ROW_STEP) * ROW_STEP
    cells = -(-m // STRIP) * b
    segs = -(-BLOCKS_PER_SM * sms // cells)
    fill = max(ROW_STEP, -(-f // segs // ROW_STEP) * ROW_STEP)
    return max(1, min(f_tile, f, SEGMENT_ROWS, fill))


def _sms(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3_out1: expected x [B, F, M, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(kernel.shape) != (3, 3, c, 1):
        raise ValueError(f"conv3x3_out1: kernel {tuple(kernel.shape)} is not [3, 3, {c}, 1]")
    if bias.numel() != 1:
        raise ValueError(f"conv3x3_out1: bias must hold one value, got {tuple(bias.shape)}")


def conv3x3_out1_plain(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Nine shifted ``[.., C] @ [C]`` products over the zero-padded input
    in float32, with the weights rounded to x's dtype, plus the bias."""
    _check(x, kernel, bias)
    b, f, m, _ = x.shape
    w = kernel[..., 0].to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.zeros(b, f, m, dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            out = out + torch.matmul(xp[:, di:di + f, dj:dj + m], w[di, dj])
    return (out + bias.reshape(-1)[0].float())[..., None]


def tap_partials_model(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       rows: int | None = None) -> torch.Tensor:
    """The tensor-core route's schedule on the CPU, in float32: for each
    F segment of ``rows`` rows (all of F by default) and 64-column strip,
    walk the input rows f0 - 1 .. f1; each row's slab is a box of 66
    pixels (the strip and one halo column each side) and C padded to 64s,
    zero outside the image and past C; its tap partials are ``D = slab @
    W16`` (taps 0-8 of 16 columns), summed box by box; then each output
    column's three row sums of D fold into running sums, one output row
    completed per input row, as the kernel's consumers do."""
    _check(x, kernel, bias)
    b, f, m, c = x.shape
    rows = rows or f
    nbox = -(-c // BOX_CH)
    cp = nbox * BOX_CH
    w16 = torch.zeros(cp, 16, dtype=torch.float32)
    w16[:c, :9] = kernel[..., 0].to(x.dtype).float().reshape(9, c).t().cpu()
    xf = x.float().cpu()
    bv = bias.reshape(-1)[0].float().cpu()
    out = torch.empty(b, f, m, dtype=torch.float32)
    for f0 in range(0, f, rows):
        f1 = min(f, f0 + rows)
        for m0 in range(0, m, STRIP):
            part_prev = part_cur = torch.zeros(b, STRIP)
            for r in range(f1 - f0 + 2):
                fr = f0 - 1 + r
                slab = torch.zeros(b, BOX_COLS, cp)
                lo, hi = max(m0 - 1, 0), min(m0 - 1 + BOX_COLS, m)
                if 0 <= fr < f:
                    slab[:, lo - (m0 - 1):hi - (m0 - 1), :c] = xf[:, fr, lo:hi]
                d = torch.zeros(b, BOX_COLS, 16)
                for cb in range(nbox):
                    d = d + slab[..., cb * BOX_CH:(cb + 1) * BOX_CH] @ w16[cb * BOX_CH:
                                                                       (cb + 1) * BOX_CH]
                rs = [d[:, 0:STRIP, 3 * di] + d[:, 1:STRIP + 1, 3 * di + 1]
                      + d[:, 2:STRIP + 2, 3 * di + 2] for di in range(3)]
                done = part_prev + rs[2]
                if r >= 2:
                    n = min(STRIP, m - m0)
                    out[:, f0 - 2 + r, m0:m0 + n] = done[:, :n] + bv
                part_prev = part_cur + rs[1]
                part_cur = rs[0]
    return out[..., None].to(x.device)


def conv3x3_out1(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 f_tile: int = 64) -> torch.Tensor:
    """``[B, F, M, C] x [3, 3, C, 1] -> [B, F, M, 1]`` float32 ('SAME')."""
    if x.dim() == 4:
        b, f, m, c = x.shape
        FLOP_LOG.append(2 * 9 * b * f * m * c)
    if x.device.type == "cpu":
        return conv3x3_out1_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_out1: unsupported device {x.device}")
    _check(x, kernel, bias)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_out1: the kernel takes bfloat16 or float32, got {x.dtype}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError(f"conv3x3_out1: kernel on {kernel.device}, bias on "
                         f"{bias.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_out1: x must be contiguous")
    if f_tile < 1:
        raise ValueError(f"conv3x3_out1: f_tile must be positive, got {f_tile}")
    b, f, m, c = x.shape
    if not (0 < b <= 65535 and f and m):
        raise ValueError(f"conv3x3_out1: unsupported shape {tuple(x.shape)}")
    plan = plan_of(x)
    route = TC if plan.route else CC
    rows = segment_rows(b, f, m, f_tile, plan, _sms(x.device))
    # the kernels round float32 weights to x's dtype themselves; other
    # dtypes are rounded here first, as the JAX kernel casts them
    w = kernel if kernel.dtype == torch.float32 else kernel.to(x.dtype).float()
    w = w.contiguous()                                           # [3, 3, C, 1]
    bvec = bias if bias.dtype == torch.float32 else bias.float()
    out = torch.empty(b, f, m, 1, dtype=torch.float32, device=x.device)
    fn = _kernel(x.dtype, route)
    with cuda_build.on_device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), bvec.data_ptr(), out.data_ptr(),
                 b, f, m, c, rows, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3_out1: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(b, f, m, c)] += 1
    launches_by_route[route] += 1
    return out
