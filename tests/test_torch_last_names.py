"""PyTorch port vs the JAX package: the last public names of the port.

Each against its JAX counterpart on the CPU:

* ``FLOP_LOG`` of ``ops.attn_rows`` (shared with ``ops.attn_flash``),
  ``ops.mrf_rows`` and ``ops.conv_edge``: the entries the port appends for
  a sequence of calls equal those the JAX functions append at trace time
  (``jax.eval_shape``) for the same shapes and calls, exactly;
* ``mrf_rows.branch_span``: equal over a table of kernels and dilations;
* ``utils.native.read_wav_batch``: each file equal to ``read_wav``'s
  decode, bit for bit, and None for a missing path (the JAX package's
  ``tests/test_native_wavio.py::test_batch_decode``);
* ``models.flashsr.distill.load_pretrained``: the shipped trio's state
  dicts equal to the JAX ``load_pretrained``'s tree mapped by
  ``params_from_jax``, bit for bit; None for a missing file;
* ``utils.weights.ensure_flashsr_weights`` on a seeded ``.pth`` trio at
  the reduced geometry of ``tests/test_checkpoint_e2e.py``: the converted
  arrays equal to the JAX function's, bit for bit, then from the cache;
  the seeded init where a file is missing equal to the JAX init, bit for
  bit, with the JAX package's report; its re-exports equal the JAX names;
* ``models.flashsr.pipeline.N_MELS``;
* the six matmul-DFT names of ``ops.fft`` over ``torch.fft``: max |d|
  1e-5 of the largest magnitude (the JAX side sums two float32 matmul
  stages; the transforms' own error is ~1e-6 relative here).
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_checkpoint_e2e as e2e
from egregora_tpu.models.flashsr import distill as j_distill
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.ops import attn_flash as j_flash
from egregora_tpu.ops import attn_pallas as j_attn
from egregora_tpu.ops import conv_edge as j_edge
from egregora_tpu.ops import fft as j_fft
from egregora_tpu.ops import mrf_rows as j_mrf
from egregora_tpu.utils import weights as j_weights
from egregora_tpu_torch.models.flashsr import distill as t_distill
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.ops import attn_flash as t_flash
from egregora_tpu_torch.ops import attn_rows as t_attn
from egregora_tpu_torch.ops import conv_edge as t_edge
from egregora_tpu_torch.ops import fft as t_fft
from egregora_tpu_torch.ops import mrf_rows as t_mrf
from egregora_tpu_torch.utils import native as t_native
from egregora_tpu_torch.utils import profiling as t_profiling
from egregora_tpu_torch.utils import weights as t_weights

DFT_TOL = 1e-5


def _traced(fn, *shapes):
    """Trace ``fn`` on arrays of ``shapes`` (its FLOP_LOG appends run), in a
    fresh closure each time: a cached trace would skip them."""
    jax.eval_shape(lambda *a: fn(*a), *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes))


def _zeros(*shape):
    return torch.zeros(shape)


@pytest.fixture()
def empty_logs():
    """Empty FLOP logs, and the port's logging on: it appends only while
    spans record (``utils.profiling.recording``)."""
    for log in (j_attn.FLOP_LOG, j_mrf.FLOP_LOG, j_edge.FLOP_LOG,
                t_attn.FLOP_LOG, t_mrf.FLOP_LOG, t_edge.FLOP_LOG):
        log.clear()
    with t_profiling.recording():
        yield
    for log in (j_attn.FLOP_LOG, j_mrf.FLOP_LOG, j_edge.FLOP_LOG,
                t_attn.FLOP_LOG, t_mrf.FLOP_LOG, t_edge.FLOP_LOG):
        log.clear()


def test_attention_flop_log_matches_jax(empty_logs):
    """flash_rows and flash_online append to one list in both packages,
    once a call; the port's backward appends nothing."""
    assert t_flash.FLOP_LOG is t_attn.FLOP_LOG and j_flash.FLOP_LOG is j_attn.FLOP_LOG
    for bh, n, d in ((2, 16, 8), (3, 33, 32), (1, 64, 16)):
        _traced(j_attn.flash_rows, *[(bh, n, d)] * 3)
        _traced(functools.partial(j_flash.flash_online, block_q=n, block_k=n), *[(bh, n, d)] * 3)
        t_attn.attn_rows(*(_zeros(bh, n, d) for _ in range(3)))
        t_flash.flash_online(*(_zeros(bh, n, d) for _ in range(3)))
    q = torch.randn(2, 16, 8, requires_grad=True)
    t_attn.attn_rows(q, q.detach(), q.detach()).sum().backward()
    _traced(j_attn.flash_rows, *[(2, 16, 8)] * 3)
    assert t_attn.FLOP_LOG == j_attn.FLOP_LOG and len(t_attn.FLOP_LOG) == 7


def test_mrf_and_edge_flop_logs_match_jax(empty_logs):
    """One entry a branch in both packages' ``mrf_rows`` (none of the block
    itself), one a ``conv3x3_out1`` call."""
    kernels, dils, c, t = (3, 7, 11), (1, 3, 5), 8, 64
    params = {f"ResBlock1D_{bi}": {f"Conv_{j}": {"kernel": jnp.zeros((k, c, c)),
                                                  "bias": jnp.zeros((c,))}
                                   for j in range(2 * len(dils))}
              for bi, k in enumerate(kernels)}
    _traced(lambda x: j_mrf.mrf_rows(x, params, kernels, (dils,) * 3), (2, t, c))
    packed = _zeros(sum(len(dils) * 2 * k * c * c for k in kernels))
    t_mrf.mrf_rows(_zeros(2, t, c), packed, _zeros(len(kernels), len(dils), 2, c), kernels, dils)
    _traced(lambda x, a, b, u, v: j_mrf.mrf_branch_rows(x, a, b, u, v, 5, (1, 2), tile=32),
            (1, 32, 4), (2, 5, 4, 4), (2, 4), (2, 5, 4, 4), (2, 4))
    t_mrf.mrf_branch_rows(_zeros(1, 32, 4), _zeros(2, 2, 5, 4, 4), _zeros(2, 2, 4), (1, 2))
    assert t_mrf.FLOP_LOG == j_mrf.FLOP_LOG and len(t_mrf.FLOP_LOG) == 4
    for b, f, m, ch in ((1, 8, 16, 4), (2, 64, 40, 24)):
        _traced(functools.partial(j_edge.conv3x3_out1, f_tile=8), (b, f, m, ch), (3, 3, ch, 1),
                (1,))
        t_edge.conv3x3_out1(_zeros(b, f, m, ch), _zeros(3, 3, ch, 1), _zeros(1))
    assert t_edge.FLOP_LOG == j_edge.FLOP_LOG and len(t_edge.FLOP_LOG) == 2


def test_branch_span_matches_jax():
    for k in (1, 3, 5, 7, 11):
        for dils in ((1,), (1, 2), (1, 3, 5), (2, 4, 8, 16)):
            assert t_mrf.branch_span(k, dils) == j_mrf.branch_span(k, dils)


def test_read_wav_batch_equals_read_wav(tmp_path):
    if t_native.load() is None:
        pytest.skip("no C++ toolchain to build the native codec")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        p = tmp_path / f"b{i}.wav"
        t_native.write_wav(p, (0.4 * rng.standard_normal((1 + i % 2, 2000 + i))).astype(
            np.float32), 24000, bits=16 if i % 2 else 32)
        paths.append(str(p))
    paths.insert(2, str(tmp_path / "missing.wav"))
    out = t_native.read_wav_batch(paths, n_threads=3)
    assert len(out) == len(paths) and out[2] is None
    for p, got in zip(paths, out):
        if got is not None:
            ref, sr = t_native.read_wav(p)
            assert got[1] == sr == 24000 and got[0].dtype == np.float32
            assert np.array_equal(got[0], ref)
    assert t_native.read_wav_batch([]) == []


def _same_state_dicts(a, b):
    assert set(a) == set(b)
    for name in a:
        assert set(a[name]) == set(b[name]), name
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)


def test_load_pretrained_matches_jax(tmp_path):
    for name in ("pretrained.npz", "pretrained_istft.npz"):
        path = t_distill.SHIPPED_DIR / name
        cfg, _ = t_distill.load_pretrained_with_cfg(path)
        _same_state_dicts(t_distill.load_pretrained(path),
                          t_weights.params_from_jax(cfg, j_distill.load_pretrained(path)))
    assert t_distill.load_pretrained(tmp_path / "none.npz") is None
    assert j_distill.load_pretrained(tmp_path / "none.npz") is None


def _port_cfg(jcfg):
    return t_distill._cfg_from_json(j_distill._cfg_to_json(jcfg))


def test_ensure_flashsr_weights_matches_jax(tmp_path, capsys):
    jcfg = e2e._reduced_cfg()
    cfg = _port_cfg(jcfg)
    src = tmp_path / "src"
    src.mkdir()
    e2e._build_trio(jcfg, src)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        shutil.copytree(src, dirs[side])
    ref = j_weights.ensure_flashsr_weights(j_pipe.FlashSRModules(jcfg), ckpt_dir=dirs["jax"])
    ref = t_weights.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, ref))
    mods = t_pipe.FlashSRModules(cfg)
    got = t_weights.ensure_flashsr_weights(mods, ckpt_dir=dirs["port"])
    _same_state_dicts(got, ref)
    assert (dirs["port"] / t_distill.CACHE).exists() and (dirs["port"] / t_distill.SIDECAR).exists()
    (dirs["port"] / "vae.pth").unlink()                     # the cache comes first
    _same_state_dicts(t_weights.ensure_flashsr_weights(mods, ckpt_dir=dirs["port"]), ref)

    (src / "vae.pth").unlink()
    capsys.readouterr()
    init = j_weights.ensure_flashsr_weights(j_pipe.FlashSRModules(jcfg), seed=3, ckpt_dir=src)
    j_line = capsys.readouterr().out
    got = t_weights.ensure_flashsr_weights(mods, seed=3, ckpt_dir=src)
    t_line = capsys.readouterr().out
    _same_state_dicts(got, t_weights.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, init)))
    assert t_line.split("]", 1)[1] == j_line.split("]", 1)[1]
    assert "missing: vae.pth" in t_line and t_weights.HF_DATASET in t_line


def test_weights_names_match_jax(tmp_path, monkeypatch):
    assert t_weights.FLASHSR_FILES == j_weights.FLASHSR_FILES
    assert t_weights.HF_DATASET == j_weights.HF_DATASET
    (tmp_path / "vae.pth").touch()
    assert t_weights.missing_flashsr_files(tmp_path) == j_weights.missing_flashsr_files(tmp_path)
    monkeypatch.setenv("EGREGORA_TPU_OFFLINE", "1")
    assert t_weights.load_converted_flashsr(0, tmp_path) is None
    assert t_pipe.N_MELS == j_pipe.N_MELS == 256


@pytest.mark.parametrize("n", [64, 8192])
def test_matmul_dft_names_match_jax(n):
    rng = np.random.default_rng(n)
    x, xi = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
    tx, txi, jx, jxi = torch.from_numpy(x), torch.from_numpy(xi), jnp.asarray(x), jnp.asarray(xi)

    def close(got, ref):
        got, ref = [g.numpy() for g in got], [np.asarray(r) for r in ref]
        scale = max(float(np.abs(r).max()) for r in ref)
        assert all(g.shape == r.shape for g, r in zip(got, ref))
        assert max(float(np.abs(g - r).max()) for g, r in zip(got, ref)) <= DFT_TOL * scale

    for inverse in (False, True):
        close(t_fft.fft_mm(tx, txi, inverse), j_fft.fft_mm(jx, jxi, inverse))
    spec = t_fft.rfft_mm(tx)
    close(spec, j_fft.rfft_mm(jx))
    close([t_fft.irfft_mm(*spec, n)], [j_fft.irfft_mm(*j_fft.rfft_mm(jx), n)])
    assert t_fft.permuted_fft_bases(n)["factors"] == j_fft.permuted_fft_bases(n)["factors"]
    *perm, factors = t_fft.rfft_permuted(tx)
    *j_perm, j_factors = j_fft.rfft_permuted(jx)
    assert factors == j_factors
    close(perm, j_perm)
    close([t_fft.irfft_permuted(*perm, n)], [j_fft.irfft_permuted(*j_perm, n)])
    close([t_fft.irfft_permuted(*perm, n)], [x])
