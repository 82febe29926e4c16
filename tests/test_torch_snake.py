"""The DAC's Snake (``ops.snake``) on the CPU: what the module returns,
the autograd Function's backward, and that a CPU tensor never reaches
the kernel.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``)."""
import time

import numpy as np
import pytest
import torch

from egregora_tpu_torch.models.dac import model as M
from egregora_tpu_torch.ops import snake as S
from egregora_tpu_torch.utils import profiling


def _operands(c=6, t=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = 3.0 * torch.randn(2, c, t, generator=g)
    # alphas around the shipped codecs' floor of 0.05, some below it
    alpha = torch.tensor([0.01, 0.04, 0.05, 0.3, 1.0, 2.0][:c])
    return x, alpha


@pytest.mark.parametrize("floor", [0.0, 0.05])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_module_returns_cfg_dtype(floor, dtype):
    x, alpha = _operands()
    m = M.Snake(6, floor, dtype)
    with torch.no_grad():
        m.alpha.copy_(alpha)
        got = m(x.to(dtype))
    assert got.dtype == dtype
    assert torch.equal(got, S.snake_plain(x.to(dtype), alpha, floor).to(dtype))
    assert torch.equal(got, M.snake(x.to(dtype), alpha, floor).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_snake_of_the_codec_returns_its_conv_dtype(dtype):
    cfg = M.DACConfig(encoder_dim=4, decoder_dim=16, strides=(2, 2), n_codebooks=2,
                      codebook_size=8, codebook_dim=2, dtype=dtype)
    snakes = [m for m in M.DACModel(cfg).modules() if isinstance(m, M.Snake)]
    assert len(snakes) == 2 * (7 * len(cfg.strides) + 1)
    assert {m.out_dtype for m in snakes} == {dtype}


@pytest.mark.parametrize("floor", [0.0, 0.05])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_matches_autograd_of_the_plain_version(floor, dtype):
    x, alpha = _operands(seed=1)
    x = x.to(dtype)
    grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    xr, ar = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    S.snake_plain(xr, ar, floor).to(dtype).backward(grad)
    gx, ga = S.snake_backward(x, alpha, floor, dtype, grad)
    assert gx.dtype == x.dtype and ga.dtype == alpha.dtype
    assert torch.equal(gx, xr.grad) and torch.equal(ga, ar.grad)
    below = alpha < floor
    if floor > 0:                      # the clamp passes no gradient below the floor
        assert below.any() and torch.all(ga[below] == 0) and torch.all(ga[~below] != 0)
    gx_only, none = S.snake_backward(x, alpha, floor, dtype, grad, (True, False))
    assert none is None and torch.equal(gx_only, xr.grad)


@pytest.mark.parametrize("floor", [0.0, 0.05])
def test_the_function_forwards_the_kernel_and_backwards_the_plain_version(monkeypatch, floor):
    """``_SnakeFunction`` with the kernel replaced by the plain version (the
    kernel runs only on a card): its output and both gradients equal
    autograd of the plain version, and the kernel ran once."""
    calls = []

    def kernel(x, alpha, fl, out_dtype):
        calls.append(out_dtype)
        return S.snake_plain(x, alpha, fl).to(out_dtype)

    monkeypatch.setattr(S, "snake_kernel", kernel)
    x, alpha = _operands(seed=3)
    x = x.bfloat16()
    grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)).bfloat16()
    xk, ak = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    y = S._SnakeFunction.apply(xk, ak, floor, torch.bfloat16)
    y.backward(grad)
    xr, ar = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    ref = S.snake_plain(xr, ar, floor).to(torch.bfloat16)
    ref.backward(grad)
    assert calls == [torch.bfloat16] and y.dtype == torch.bfloat16
    assert torch.equal(y, ref) and torch.equal(xk.grad, xr.grad) and torch.equal(ak.grad, ar.grad)


def test_a_cpu_tensor_never_reaches_the_kernel():
    cfg = M.DACConfig(encoder_dim=4, decoder_dim=16, strides=(2, 2), n_codebooks=2,
                      codebook_size=8, codebook_dim=2)
    model = M.DACModel(cfg).init_params(0)
    before = S.launches
    x = torch.from_numpy(np.random.default_rng(5).uniform(-0.5, 0.5, (2, 40)).astype(np.float32))
    with profiling.recording():
        t0 = time.time_ns()
        z, _ = model.encode(x)
        model.decode(z)
        recs = [r for r in profiling.spans(t0, time.time_ns()) if r.name == "egr.dac.snake"]
    assert len(recs) == 2 * (7 * len(cfg.strides) + 1)
    assert all("snake_launches" not in r.counts for r in recs)
    m = M.Snake(6, 0.05, torch.bfloat16)                 # and with grad
    m(_operands()[0].requires_grad_()).float().sum().backward()
    assert S.launches == before and m.alpha.grad is not None


def _nwc(x):
    """``x`` laid out channels-last: the memory of ``[B, T, C]``."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def test_the_kernel_path_refuses_what_it_does_not_take():
    """Off the CPU, a tensor goes to the kernel or raises: no fallback.  A
    contiguous and a channels-last input pass to the launch (which refuses
    a CPU tensor); every other layout is refused before it: a strided
    slice, the memory of ``[T, B, C]`` and of ``[C, B, T]``."""
    x, alpha = _operands()
    with pytest.raises(ValueError, match="CUDA tensor"):
        S.snake(x.to("meta"), alpha.to("meta"), 0.0, torch.bfloat16)
    for taken in (x, _nwc(x)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            S.snake_kernel(taken, alpha, 0.0, torch.bfloat16)
    for other in (x[..., ::2], x.permute(2, 0, 1).contiguous().permute(1, 2, 0),
                  x.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError, match="contiguous or channels-last"):
            S.snake_kernel(other, alpha, 0.0, torch.bfloat16)


@pytest.mark.parametrize("layout,shape", [("ncw", (2, 6, 37)), ("nwc", (2, 6, 37)),
                                          ("nwc", (1, 6, 1)), ("ncw", (2, 1, 37))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_reads_the_layout_of_its_input(monkeypatch, layout, shape, dtype):
    """With the library's launch replaced by the plain version (the kernel
    runs only on a card): a channels-last input goes to the NWC variant, a
    contiguous one (one channel or one sample is both) to the NCW one; the
    output has the input's strides and the plain version's values, through
    the autograd Function too."""
    launched = []

    def launch(x, alpha, y, floor, nwc):
        launched.append(nwc)
        y.copy_(S.snake_plain(x, alpha, floor))

    monkeypatch.setattr(S, "_launch", launch)
    b, c, t = shape
    x, alpha = _operands(c=c, t=t, seed=6)
    x = x[:b].to(dtype)
    if layout == "nwc":
        x = _nwc(x)
    nwc = layout == "nwc" and not x.is_contiguous()
    before = S.launches
    for floor in (0.0, 0.05):
        y = S.snake_kernel(x, alpha, floor, torch.bfloat16)
        assert y.stride() == x.stride() and y.dtype == torch.bfloat16
        assert torch.equal(y, S.snake_plain(x, alpha, floor).bfloat16())
    y = S._SnakeFunction.apply(x.clone().requires_grad_(), alpha, 0.05, dtype)
    assert y.stride() == x.stride() and torch.equal(y, S.snake_plain(x, alpha, 0.05).to(dtype))
    assert launched == [nwc] * 3 and S.launches == before + 3
