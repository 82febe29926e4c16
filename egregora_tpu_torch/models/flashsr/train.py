"""FlashSR training step in PyTorch: loss, AdamW, checkpoints, data
parallelism over ``torch.distributed``.

Counterpart of ``egregora_tpu/models/flashsr/train.py``.  Given paired
48 kHz ``(lr_wave, hr_wave)`` chunks the loss is, term by term as in the
JAX package,

  3 latent_l2 + ae_l2 + mel_dec_l2 + mel_l2 + 0.5 mr + 0.5 mr_e2e

(latent distillation through the one-step UNet, the VAE as an
autoencoder of the HR mel, the decoded prediction's mel, the vocoder on
the clean HR mel, and the multi-resolution STFT loss of the vocoder on
the clean and, detached, on the decoded mel).  The noise latent is
``jax.random.normal(rng, ...)`` drawn by ``prng`` from the same key, so a
step sees the JAX package's noise.  Parameters and AdamW's moments are
float32; each module computes in its config's dtype, as flax does.

Data parallelism: the JAX step is one program over the ``"chunk"`` mesh.
Here each process of a ``torch.distributed`` group runs its
``local_batch_slice`` of the global batch with a full copy of the
weights.  Every mean of the loss is a mean over the global batch and the
spectral convergence ``||mx - my|| / ||my||`` a ratio of global sums:
each process all-reduces its local sums (``Shard.total``), which carry
the gradient of the local part only, so summing the gradients over the
processes (one all-reduce a step) gives the one-device gradient of the
global batch with no world-size factor.  The optimizer then takes the
same step on every process.

Checkpoints are the JAX package's files (``params.npz`` in the flax
layout, ``opt_state.npz`` with optax's ``adamw`` leaves, ``step.txt``),
so a run moves between the packages in both directions.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ...ops.stft import stft_conv
from ...parallel.multihost import local_batch_slice, world
from . import prng
from .mel import log_mel


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's part of a global batch: ``rows`` of it, one of
    ``world`` equal parts.  ``total`` turns a local sum into the global
    sum (all-reduced) whose gradient flows to the local part only."""

    rows: slice = slice(None)
    world: int = 1

    def total(self, x: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return x
        tot = x.detach().clone()
        dist.all_reduce(tot)
        return x + (tot - x.detach())

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the global batch of ``x`` (this process's rows)."""
        if self.world == 1:
            return x.mean()
        return self.total(x.sum()) / (x.numel() * self.world)


LOCAL = Shard()


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, b1=0.9, b2=0.99, weight_decay=1e-4)`` (eps 1e-8):
    decoupled decay on every parameter, biases and norm scales too.
    ``params``: anything with ``parameters()`` (``FlashSRModules``, a
    module) or an iterable of tensors."""
    if hasattr(params, "parameters"):
        params = params.parameters()
    return torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.99), eps=1e-8,
                             weight_decay=1e-4)


def _mags(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    r, i = stft_conv(x, n_fft, hop, window="hann_periodic")
    return torch.sqrt(r * r + i * i + 1e-9)


def _mrstft(x: torch.Tensor, y: torch.Tensor, shard: Shard = LOCAL) -> torch.Tensor:
    """Multi-resolution STFT loss: spectral convergence + log-magnitude L1
    at n_fft 512 / 1024 / 2048 (hop n_fft/4; scales longer than half the
    input are skipped; one short-window pair for tiny inputs), the
    convergence from global sums."""
    total, n = 0.0, 0
    for n_fft in (512, 1024, 2048):
        if n_fft * 2 > x.shape[-1]:
            continue
        mx, my = _mags(x, n_fft, n_fft // 4), _mags(y, n_fft, n_fft // 4)
        total = total + (torch.sqrt(shard.total(torch.square(mx - my).sum()))
                         / (torch.sqrt(shard.total(torch.square(my).sum())) + 1e-9))
        total = total + shard.mean(torch.abs(torch.log(mx) - torch.log(my)))
        n += 1
    if n == 0:   # tiny inputs: one short-window pair
        n_fft = max(64, x.shape[-1] // 4)
        mx, my = _mags(x, n_fft, n_fft // 4), _mags(y, n_fft, n_fft // 4)
        total = shard.mean(torch.abs(torch.log(mx) - torch.log(my)))
        n = 1
    return total / n


def noise_like(rng: np.ndarray, shape, shard: Shard, device) -> torch.Tensor:
    """``jax.random.normal(rng, shape)`` over the global batch (``shape[0]``
    is the local batch), this process's rows, on ``device``."""
    glob = (shape[0] * shard.world,) + tuple(shape[1:])
    return torch.from_numpy(prng.normal_from_key(rng, glob)[shard.rows]).to(device)


def loss_fn(modules, lr_wave: torch.Tensor, hr_wave: torch.Tensor, rng: np.ndarray,
            hop: int, n_mels: int, n_fft: int = 0, shard: Shard = LOCAL) -> torch.Tensor:
    """The distillation loss of the JAX ``loss_fn`` on this process's rows
    of the batch (``shard``), with the noise of the key ``rng`` (a
    threefry key ``[2]`` uint32).  ``n_fft`` 0 picks ``4 * hop``."""
    n_fft = n_fft or 4 * hop
    frames = lr_wave.shape[-1] // hop
    mel_lr = log_mel(lr_wave, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]
    mel_hr = log_mel(hr_wave, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]

    z_lr = modules.vae.encode(mel_lr[..., None])
    z_tgt = modules.vae.encode(mel_hr[..., None])
    noise = noise_like(rng, z_lr.shape, shard, z_lr.device)
    z_in = torch.cat([noise, z_lr.float()], dim=-1)
    t = torch.ones(z_in.shape[0], device=z_in.device)
    z_pred = modules.unet(z_in, t)
    latent_l2 = shard.mean(torch.square(z_pred.float() - z_tgt.float()))

    mel_ae = modules.vae(mel_hr[..., None])[..., 0]
    ae_l2 = shard.mean(torch.square(mel_ae.float() - mel_hr))

    mel_dec = modules.vae.decode(z_pred)[..., 0]
    mel_dec_l2 = shard.mean(torch.square(mel_dec.float() - mel_hr))

    n = hr_wave.shape[-1]
    wav = modules.vocoder(mel_hr)[:, :n].float()
    mel_out = log_mel(wav, n_fft=n_fft, hop=hop, n_mels=n_mels)[:, :frames]
    mel_l2 = shard.mean(torch.square(mel_out - mel_hr))
    mr = _mrstft(wav, hr_wave, shard)

    wav_e2e = modules.vocoder(mel_dec.detach())[:, :n].float()
    mr_e2e = _mrstft(wav_e2e, hr_wave, shard)

    return (3.0 * latent_l2 + ae_l2 + mel_dec_l2 + mel_l2
            + 0.5 * mr + 0.5 * mr_e2e)


def _check_mesh(mesh) -> Shard:
    """The ``Shard`` of a train step's mesh: one card a process (the
    processes of the group carry the chunk axis)."""
    if mesh is None:
        return LOCAL
    if len(mesh.devices) != 1:
        raise ValueError(f"make_train_step: a train step drives one card a process; the "
                         f"mesh has {len(mesh.devices)} here. Start one process a card "
                         "(parallel.multihost) and pass make_global_chunk_mesh()")
    if mesh.world != world():
        raise ValueError(f"make_train_step: the mesh spans {mesh.world} processes, the "
                         f"torch.distributed group {world()}")
    return Shard(world=mesh.world)


def reduce_gradients(params, world: int) -> None:
    """Sum the gradients over the group, in one all-reduce of a flat
    buffer.  A parameter autograd left without a gradient gets zeros
    first (optax's ``adamw`` updates every leaf: moments and decay)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if world == 1:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    i = 0
    for p in params:
        p.grad.copy_(flat[i: i + p.numel()].view_as(p))
        i += p.numel()


def make_train_step(modules, opt: torch.optim.Optimizer, mesh=None, hop: int = 480,
                    n_mels: int = 256, n_fft: int = 0):
    """``step(lr_wave, hr_wave, rng) -> loss``: one AdamW step of
    ``modules`` in place on the global batch ``[B, T]`` (numpy or
    tensors; B a multiple of ``mesh.size``), this process's rows of it
    (``mesh`` from ``parallel.multihost.make_global_chunk_mesh``, or
    None for one device).  Returns the loss as a 0-d tensor on the card
    (``float()`` it to wait for it)."""
    shard0 = _check_mesh(mesh)
    params = [p for p in modules.parameters() if p.requires_grad]
    device = params[0].device

    def step(lr_wave, hr_wave, rng) -> torch.Tensor:
        lr_wave, hr_wave = torch.as_tensor(lr_wave), torch.as_tensor(hr_wave)
        b = lr_wave.shape[0]
        if b % shard0.world:
            raise ValueError(f"train step: batch {b} does not split over {shard0.world} "
                             "processes")
        shard = (dataclasses.replace(shard0, rows=local_batch_slice(b)) if shard0.world > 1
                 else shard0)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(modules, lr_wave[shard.rows].to(device, torch.float32),
                       hr_wave[shard.rows].to(device, torch.float32),
                       np.asarray(rng, np.uint32), hop, n_mels, n_fft, shard)
        loss.backward()
        reduce_gradients(params, shard.world)
        opt.step()
        return loss.detach()

    return step


# ---- checkpoints (the JAX package's files) ----------------------------------

def _opt_trees(modules, opt: torch.optim.Optimizer):
    """``(count, mu tree, nu tree)`` of AdamW's state in optax's layout:
    the moments as flax trees of the trio (zeros before the first step)."""
    from ...utils.weights import flax_tree
    count, mu, nu = 0, {}, {}
    for name, m in modules.by_name().items():
        sd = m.state_dict(keep_vars=True)
        ex, exq = {}, {}
        for key, p in sd.items():
            st = opt.state.get(p, {})
            if "step" in st:
                count = int(st["step"])
            ex[key] = st.get("exp_avg", torch.zeros_like(p))
            exq[key] = st.get("exp_avg_sq", torch.zeros_like(p))
        mu[name] = flax_tree(m, values=True, tensors=ex)
        nu[name] = flax_tree(m, values=True, tensors=exq)
    return count, mu, nu


def save_checkpoint(path, modules, opt: torch.optim.Optimizer, step: int) -> None:
    """The JAX ``save_checkpoint``'s files: ``params.npz`` (``save_params``
    of the flax trio), ``opt_state.npz`` (``leaf_i``: optax's count, the
    ``mu`` leaves, the ``nu`` leaves, each in JAX's sorted order and the
    flax layout) and ``step.txt``."""
    from ...utils.weights import flax_tree, save_params, sorted_leaves
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    save_params({name: flax_tree(m, values=True) for name, m in modules.by_name().items()},
                p / "params.npz")
    count, mu, nu = _opt_trees(modules, opt)
    leaves = ([np.asarray(count, np.int32)] + [v for _, v in sorted_leaves(mu)]
              + [v for _, v in sorted_leaves(nu)])
    np.savez(p / "opt_state.npz", **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    (p / "step.txt").write_text(str(int(step)))


def load_checkpoint(path, modules, opt: Optional[torch.optim.Optimizer] = None) -> int:
    """Loads what ``save_checkpoint`` of either package wrote into
    ``modules`` (in place) and ``opt`` (AdamW's ``step`` / ``exp_avg`` /
    ``exp_avg_sq``); returns the step."""
    from ...utils.weights import (flax_tree, load_params, module_from_jax, sorted_leaves,
                                  unflatten)
    p = Path(path)
    mods = modules.by_name()
    params = load_params(p / "params.npz")
    for name, m in mods.items():
        sd = module_from_jax(m, params[name])
        m.load_state_dict(sd, strict=True)
    step = int((p / "step.txt").read_text())
    if opt is None:
        return step
    with np.load(p / "opt_state.npz") as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    shapes = {name: flax_tree(m) for name, m in mods.items()}
    paths = [path_ for path_, _ in sorted_leaves(shapes)]
    if len(leaves) != 1 + 2 * len(paths):
        raise ValueError(f"load_checkpoint: {len(leaves)} optimizer leaves, expected "
                         f"{1 + 2 * len(paths)} (count, mu, nu) for this trio")
    count = int(leaves[0])
    keys = ["/".join(path_) for path_ in paths]
    mu = unflatten(dict(zip(keys, leaves[1: 1 + len(keys)])))
    nu = unflatten(dict(zip(keys, leaves[1 + len(keys):])))
    for name, m in mods.items():
        ex, exq = module_from_jax(m, mu[name]), module_from_jax(m, nu[name])
        for key, prm in m.state_dict(keep_vars=True).items():
            opt.state[prm] = {"step": torch.tensor(float(count)),
                              "exp_avg": ex[key].to(prm.device),
                              "exp_avg_sq": exq[key].to(prm.device)}
    return step
