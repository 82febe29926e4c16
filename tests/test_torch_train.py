"""PyTorch port vs the JAX package: the FlashSR training step.

At tiny widths in float32, with the StudentUNet (attention at level 1)
and with the upstream LDMUNet topology (attention at ds 2), the reduced
configs of ``tests/test_train_and_parallel.py`` and ``__graft_entry__.py``:

* ``train.loss_fn``'s value and the gradient of every parameter against
  ``jax.value_and_grad`` of the JAX ``loss_fn`` (same weights, same
  batch, the noise of the same key);
* two AdamW steps against ``optax.adamw`` from the same gradients;
* checkpoints both ways: the JAX ``save_checkpoint`` resumed by the
  port's ``load_checkpoint`` and the port's resumed by the JAX
  ``load_checkpoint``, each followed by one step on both sides;
* the port's ``make_train_step`` lowering the loss on a fixed batch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egregora_tpu.models.flashsr import distill as j_distill
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.models.flashsr import train as j_train
from egregora_tpu.models.flashsr.ldm_unet import LDMUNetConfig as JL
from egregora_tpu.models.flashsr.unet import UNetConfig as JU
from egregora_tpu.models.flashsr.vae import VAEConfig as JV
from egregora_tpu.models.flashsr.vocoder import VocoderConfig as JVoc
from egregora_tpu.utils.weights import fast_init_like as j_fast_init_like
from egregora_tpu_torch.models.flashsr import distill as t_distill
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.models.flashsr import train as t_train
from egregora_tpu_torch.parallel.mesh import ChunkMesh
from egregora_tpu_torch.utils.weights import params_from_jax

HOP, N_MELS = 64, 32
LOSS_TOL = 1e-5          # relative; measured 1e-7 - 4e-7
GRAD_TOL = 1e-3          # relative a parameter, measured <= 5e-5 (plus 1e-6 of the
                         # trio's gradient norm for the exactly-zero ones, e.g. key biases)
ADAM_TOL = 1e-6          # absolute on parameters of O(1) after two steps at lr 1e-3


def _jax_cfg(kind):
    unet = (JU(in_channels=8, out_channels=4, base_channels=8, channel_mults=(1, 2),
               num_res_blocks=1, attn_levels=(1,), num_heads=2, time_dim=16, groups=4,
               dtype=jnp.float32) if kind == "student" else
            JL(in_channels=8, out_channels=4, model_channels=8, channel_mult=(1, 2),
               num_res_blocks=1, attention_resolutions=(2,), num_heads=2, groups=4,
               dtype=jnp.float32))
    return j_pipe.FlashSRConfig(
        vae=JV(base_channels=8, channel_mults=(1, 2), latent_channels=4, num_res_blocks=1,
               groups=4, mid_attn=False, use_quant_conv=False, dtype=jnp.float32),
        unet=unet,
        vocoder=JVoc(n_mels=N_MELS, upsample_initial=16, upsample_factors=(4, 4, 4),
                     upsample_kernels=(8, 8, 8), resblock_kernels=(3, 5),
                     resblock_dilations=((1, 2), (1, 2)), channel_floor=8,
                     dtype=jnp.float32))


def _torch_cfg(jcfg):
    c = t_distill._cfg_from_json(j_distill._cfg_to_json(jcfg))
    f32 = lambda x: dataclasses.replace(x, dtype=torch.float32)       # noqa: E731
    return dataclasses.replace(c, vae=f32(c.vae), unet=f32(c.unet), vocoder=f32(c.vocoder))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=["student", "ldm"])
def setup(request):
    jcfg = _jax_cfg(request.param)
    jm = j_pipe.FlashSRModules(jcfg)

    def build():     # init_params' tree at the tiny hop and mel count
        k = jax.random.split(jax.random.PRNGKey(0), 3)
        return {"vae": jm.vae.init(k[0], jnp.zeros((1, 16, N_MELS, 1))),
                "student_ldm": jm.unet.init(k[1], jnp.zeros((1, 8, N_MELS // 2, 8)),
                                            jnp.zeros((1,))),
                "sr_vocoder": jm.vocoder.init(k[2], jnp.zeros((1, 16, N_MELS)))}

    params = _np(j_fast_init_like(jax.eval_shape(build), 0))
    rng = np.random.default_rng(0)
    lr_w = (0.1 * rng.standard_normal((2, HOP * 16))).astype(np.float32)
    hr_w = (0.1 * rng.standard_normal((2, HOP * 16))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_train.loss_fn(jm, p, lr_w, hr_w, key, HOP, N_MELS)))(params)
    return dict(kind=request.param, jcfg=jcfg, tcfg=_torch_cfg(jcfg), params=params,
                lr=lr_w, hr=hr_w, key=np.asarray(key, np.uint32), loss=float(loss),
                grads=_np(grads))


def _port(s):
    mods = t_pipe.FlashSRModules(s["tcfg"])
    mods.load_state_dicts(params_from_jax(s["tcfg"], s["params"]))
    return mods


def _set_grads(mods, cfg, grads, scale=1.0):
    sds = params_from_jax(cfg, grads)
    for name, m in mods.by_name().items():
        for key, p in m.named_parameters():
            p.grad = sds[name][key] * scale


def _assert_params(mods, cfg, tree, tol=0.0):
    want = params_from_jax(cfg, _np(tree))
    for name, m in mods.by_name().items():
        for key, v in m.state_dict().items():
            d = float((v - want[name][key]).abs().max())
            assert d <= tol, (name, key, d)


def test_loss_and_gradients_match_jax(setup):
    mods = _port(setup)
    loss = t_train.loss_fn(mods, torch.from_numpy(setup["lr"]), torch.from_numpy(setup["hr"]),
                           setup["key"], HOP, N_MELS)
    loss.backward()
    assert abs(float(loss.detach()) - setup["loss"]) <= LOSS_TOL * abs(setup["loss"])
    want = params_from_jax(setup["tcfg"], setup["grads"])
    total = sum(float(v.norm() ** 2) for sd in want.values() for v in sd.values()) ** 0.5
    n = 0
    for name, m in mods.by_name().items():
        for key, p in m.named_parameters():
            assert p.grad is not None, (name, key)
            err = float((p.grad - want[name][key]).norm())
            assert err <= GRAD_TOL * float(want[name][key].norm()) + 1e-6 * total, (name, key)
            n += 1
    assert n == len(jax.tree_util.tree_leaves(setup["params"]))


@jax.jit
def _optax_update(g, opt_state, params):
    """One ``optax.adamw`` step at lr 1e-3 (``make_optimizer(1e-3)``)."""
    updates, opt_state = j_train.make_optimizer(1e-3).update(g, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def _optax_steps(s, tx, params, opt_state, scales):
    for sc in scales:
        g = jax.tree_util.tree_map(lambda x: x * sc, s["grads"])
        params, opt_state = _optax_update(g, opt_state, params)
    return params, opt_state


def test_adamw_steps_match_optax(setup):
    tx = j_train.make_optimizer(1e-3)
    want, _ = _optax_steps(setup, tx, setup["params"], tx.init(setup["params"]), (1.0, -0.5))
    mods = _port(setup)
    opt = t_train.make_optimizer(mods, 1e-3)
    for sc in (1.0, -0.5):
        _set_grads(mods, setup["tcfg"], setup["grads"], sc)
        opt.step()
    _assert_params(mods, setup["tcfg"], want, ADAM_TOL)


@pytest.mark.parametrize("setup", ["student"], indirect=True)
def test_checkpoints_resume_across_packages(setup, tmp_path):
    cfg = setup["tcfg"]
    tx = j_train.make_optimizer(1e-3)
    p1, o1 = _optax_steps(setup, tx, setup["params"], tx.init(setup["params"]), (1.0,))
    j_train.save_checkpoint(tmp_path / "jax", p1, o1, step=1)
    # JAX -> port: the weights and the moments exactly, then one step each
    mods = t_pipe.FlashSRModules(cfg)
    opt = t_train.make_optimizer(mods, 1e-3)
    assert t_train.load_checkpoint(tmp_path / "jax", mods, opt) == 1
    _assert_params(mods, cfg, p1)
    count, mu, nu = t_train._opt_trees(mods, opt)
    assert count == int(o1[0].count)
    for got, want in ((mu, o1[0].mu), (nu, o1[0].nu)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    p2, o2 = _optax_steps(setup, tx, p1, o1, (-0.5,))
    _set_grads(mods, cfg, setup["grads"], -0.5)
    opt.step()
    _assert_params(mods, cfg, p2, ADAM_TOL)
    # port -> JAX: the JAX loader reads every leaf, then one step each
    t_train.save_checkpoint(tmp_path / "port", mods, opt, step=2)
    pj, oj, step = j_train.load_checkpoint(tmp_path / "port", o2)
    assert step == 2
    assert jax.tree_util.tree_structure(oj) == jax.tree_util.tree_structure(o2)
    for a, b in zip(jax.tree_util.tree_leaves(oj), jax.tree_util.tree_leaves(o2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-9)
    p3, _ = _optax_steps(setup, tx, _np(pj), oj, (1.0,))
    _set_grads(mods, cfg, setup["grads"], 1.0)
    opt.step()
    _assert_params(mods, cfg, p3, ADAM_TOL)


@pytest.mark.parametrize("setup", ["ldm"], indirect=True)
def test_train_step_decreases_loss(setup):
    mods = _port(setup)
    step = t_train.make_train_step(mods, t_train.make_optimizer(mods, 1e-3), None, HOP, N_MELS)
    losses = [float(step(setup["lr"], setup["hr"], setup["key"])) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    with pytest.raises(ValueError):
        t_train.make_train_step(mods, None, ChunkMesh(("cpu", "cpu")), HOP, N_MELS)


@pytest.mark.parametrize("bh,n,d,dtype", [(4, 300, 32, torch.float32), (2, 77, 40, torch.float32),
                                          (3, 130, 64, torch.bfloat16)])
def test_attn_rows_function_gradient(bh, n, d, dtype, monkeypatch):
    """``AttnRows`` (what ``mha``'s kernel path runs where autograd
    records; on the CPU its forward is the plain version) against autograd
    through ``attn_rows_plain`` in float32, via ``mha`` on the pallas
    path; under ``no_grad`` no Function is recorded."""
    from egregora_tpu_torch.ops import attn_rows as ar
    from egregora_tpu_torch.ops.attention import mha
    monkeypatch.setenv("EGREGORA_ATTN_PATH", "pallas")
    gen = torch.Generator().manual_seed(n)
    q, k, v, do = (torch.randn(bh, n, d, generator=gen).to(dtype) for _ in range(4))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    calls = []
    real = ar.attn_rows_backward
    monkeypatch.setattr(ar, "attn_rows_backward", lambda *a: calls.append(1) or real(*a))
    o = mha(qs[None], ks[None], vs[None])[0]
    got = torch.autograd.grad(o, (qs, ks, vs), do)
    assert calls == [1]                     # the Function's backward ran, once
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ar.attn_rows_plain(qf, kf, vf), (qf, kf, vf), do.float())
    tol = 1e-5 if dtype == torch.float32 else 1e-2      # bf16 outputs round by 2^-8
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - w).norm() / w.norm()) <= tol
    with torch.no_grad():
        assert ar.attn_rows(qs, ks, vs).grad_fn is None


def test_training_after_inference_reuses_the_dsp_constants():
    """The DSP ops' cached constant matrices (``ops.stft.device_tensor``),
    first made by a call under ``inference_mode`` (a served forward), can
    be saved for the backward of a later training step."""
    from egregora_tpu_torch.models.flashsr.mel import log_mel
    with torch.inference_mode():          # an n_fft / hop / mels no other test uses
        log_mel(torch.zeros(1, 4000), n_fft=320, hop=80, n_mels=20)
    x = torch.randn(1, 4000, requires_grad=True)
    log_mel(x, n_fft=320, hop=80, n_mels=20).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
