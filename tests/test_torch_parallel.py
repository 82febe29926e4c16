"""Chunk parallelism of the PyTorch port on ``torch.distributed``.

In one process: the mesh helpers, and ``FlashSRPipeline.process`` over a
two-slot CPU mesh (``mesh=ChunkMesh(("cpu", "cpu"))``) against
``mesh=None``, one-shot and streaming.  In two processes over gloo,
modelled on ``tests/test_multihost.py``: a cross-process reduction and
gather, one sharded train step (each rank its half of the batch, the
loss's sums and the gradients all-reduced) equal to the one-process step
on the global batch, and the sharded ``process`` equal to one device.
On the card the same runs with two ranks on one card
(``chip_smoke.py``'s mesh phase).
"""
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from egregora_tpu_torch.core.audio import AudioBuffer
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.parallel import mesh as M
from egregora_tpu_torch.parallel import multihost as MH

REPO = Path(__file__).resolve().parent.parent
PROCESS_TOL = 1e-5       # relative L2, sharded against one device (same arithmetic,
                         # other batch sizes: CPU convolutions may sum in another order)

TINY = r'''
import dataclasses, numpy as np, torch
from egregora_tpu_torch.models.flashsr import pipeline as P
from egregora_tpu_torch.models.flashsr.ldm_unet import LDMUNetConfig
from egregora_tpu_torch.models.flashsr.vae import VAEConfig
from egregora_tpu_torch.models.flashsr.vocoder import VocoderConfig

def tiny_cfg(n_mels=256, hop_factors=(10, 8, 6)):
    return P.FlashSRConfig(
        vae=VAEConfig(base_channels=8, channel_mults=(1, 2, 2, 2), latent_channels=4,
                      num_res_blocks=1, groups=4, mid_attn=False, use_quant_conv=False,
                      dtype=torch.float32),
        unet=LDMUNetConfig(in_channels=8, out_channels=4, model_channels=8, channel_mult=(1, 2),
                           num_res_blocks=1, attention_resolutions=(2,), num_heads=2, groups=4,
                           dtype=torch.float32),
        vocoder=VocoderConfig(n_mels=n_mels, upsample_initial=16, upsample_factors=hop_factors,
                              upsample_kernels=tuple(2 * f for f in hop_factors),
                              resblock_kernels=(3,), resblock_dilations=((1,),),
                              channel_floor=8, dtype=torch.float32))

def signal(seconds, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = sum(np.sin(2 * np.pi * 220.0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 20))
    return (0.4 * x / np.abs(x).max()).astype(np.float32)[None, :]
'''
exec(TINY)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_mesh_helpers_in_one_process(monkeypatch):
    mesh = M.ChunkMesh(("cpu", "cpu"))
    assert mesh.size == 2 and mesh.world == 1 and mesh.axis_names == ("chunk",)
    x = torch.arange(12.0).reshape(6, 2)
    parts = M.shard_chunks(mesh, x)
    assert [tuple(p.shape) for p in parts] == [(3, 2), (3, 2)]
    run = M.chunk_parallel(lambda i, c: c * 10 + i, mesh)
    torch.testing.assert_close(run(x), torch.cat([x[:3] * 10, x[3:] * 10 + 1]))
    with pytest.raises(ValueError):
        run(x[:5])
    lin = torch.nn.Linear(2, 2)
    assert M.replicate(mesh, lin) == [lin, lin]       # both slots on its own device
    assert MH.local_batch_slice(10) == slice(0, 10)
    assert MH.world() == 1 and MH.rank() == 0
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    MH.initialize_distributed()                       # no coordinator: a no-op
    assert not torch.distributed.is_initialized()
    if torch.cuda.device_count() == 0:
        assert MH.pick_backend(2) == "gloo"
        with pytest.raises(RuntimeError):
            M.make_chunk_mesh()
        with pytest.raises(RuntimeError):
            MH.make_global_chunk_mesh()


@pytest.fixture(scope="module")
def pipe():
    return t_pipe.FlashSRPipeline(tiny_cfg(), seed=0, device="cpu")


def test_process_mesh_matches_one_device(pipe):
    """JAX-style calls: ``mesh=None``, 'auto' (one device) and a pinned
    two-slot mesh, one-shot (3 chunks padded to 4) and streaming."""
    audio = AudioBuffer(signal(12.0), 16000)
    ref = pipe.process(audio, mesh=None).numpy()
    assert pipe._resolve_mesh("auto") is None            # one device: no mesh
    mesh = M.ChunkMesh(("cpu", "cpu"))
    got = pipe.process(audio, mesh=mesh).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _rel(got, ref) < PROCESS_TOL
    stream = pipe.process(audio, mesh=mesh, max_batch=1).numpy()    # rounded up to 2
    assert _rel(stream, ref) < PROCESS_TOL


CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import numpy as np, torch
    torch.set_num_threads(2)
    pid, port = int(sys.argv[1]), sys.argv[2]
    os.environ.update(COORDINATOR_ADDRESS="127.0.0.1:" + port, NUM_PROCESSES="2",
                      PROCESS_ID=str(pid))
    from egregora_tpu_torch.parallel import multihost as MH
    MH.initialize_distributed()
    import torch.distributed as dist
    assert MH.world() == 2 and MH.rank() == pid
    assert dist.get_backend() == "gloo"
    mesh = MH.make_global_chunk_mesh(devices=["cpu"])
    assert mesh.size == 2

    # (a) a cross-process reduction and gather
    sl = MH.local_batch_slice(8)
    x = torch.arange(8, dtype=torch.float32)[sl]
    s = x.sum()
    dist.all_reduce(s)
    assert float(s) == 28.0
    assert torch.equal(MH.all_gather_rows(x), torch.arange(8, dtype=torch.float32))

    # (b) one sharded train step == the one-process step on the global batch
    %s
    from egregora_tpu_torch.models.flashsr import pipeline as P, prng, train as T
    cfg = tiny_cfg(n_mels=32, hop_factors=(4, 4, 4))
    ref, sh = P.FlashSRModules(cfg), P.FlashSRModules(cfg)
    ref.init_params(0); sh.init_params(0)
    rng = np.random.default_rng(0)
    lr = (0.1 * rng.standard_normal((4, 64 * 16))).astype(np.float32)
    hr = (0.1 * rng.standard_normal((4, 64 * 16))).astype(np.float32)
    key = prng.prng_key(5)
    l_ref = float(T.make_train_step(ref, T.make_optimizer(ref, 1e-3), None, 64, 32)(lr, hr, key))
    l_sh = float(T.make_train_step(sh, T.make_optimizer(sh, 1e-3), mesh, 64, 32)(lr, hr, key))
    assert abs(l_sh - l_ref) <= 1e-5 * abs(l_ref), (l_sh, l_ref)
    total = sum(float(p.grad.norm() ** 2) for p in ref.parameters()) ** 0.5
    worst = max(float((a.grad - b.grad).norm()) / (float(b.grad.norm()) + 1e-6 * total)
                for a, b in zip(sh.parameters(), ref.parameters()))
    # the all-reduced gradients the optimizer stepped with (measured <= 1.6e-4:
    # batch 2 against 4 sums in other orders).  The parameters themselves are
    # not compared: Adam's first step is lr * g / (|g| + eps), so a gradient
    # at roundoff level (a key bias's is zero in theory) moves by a share of lr
    assert worst <= 1e-3, worst

    # (c) the sharded process == one device, one-shot and streaming
    from egregora_tpu_torch.core.audio import AudioBuffer
    pipe = P.FlashSRPipeline(tiny_cfg(), seed=0, device="cpu")
    audio = AudioBuffer(signal(12.0), 16000)
    one = pipe.process(audio, mesh=None).numpy()
    for kw in ({}, {"max_batch": 2}):
        got = pipe.process(audio, mesh=mesh, **kw).numpy()
        rel = np.linalg.norm(got - one) / np.linalg.norm(one)
        assert got.shape == one.shape and rel < %r, (kw, rel)
    print("proc", pid, "OK", l_ref, worst, flush=True)
    dist.destroy_process_group()
""") % (str(REPO), TINY.replace("\\n", "\\n    "), PROCESS_TOL)


def test_two_process_gloo(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen([sys.executable, str(child), str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                                   "HOME": str(tmp_path)})
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        finally:
            p.kill()
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "\n".join(f"proc {j}:\n{o[-2000:]}" for j, o in enumerate(outs))
        assert f"proc {i} OK" in out
