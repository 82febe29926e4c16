"""PyTorch port vs the JAX package: FlashSR's training data and seeded
weights.

* ``prng.fold_in`` / ``bernoulli`` bit for bit against ``jax.random``;
* ``distill.synth_draws``: every random number of the JAX
  ``_synth_one``, from the same keys, bit for bit (the uniforms and the
  class draw; the white-noise normals to 1e-6, as
  ``test_torch_attention.py::test_prng_normal_matches_jax`` holds them:
  XLA:CPU's float32 ``log1p`` inside ``erf_inv`` is its own polynomial);
* ``distill.synth_pair_batch`` against the JAX generator at
  ``coherent_p`` 0 and 0.5 (float32 waves to a measured tolerance: the
  JAX and torch ``exp`` of f0 and ``cos`` of the vibrato term differ by
  an ulp on some samples, and harmonic n multiplies that phase error by
  up to 352);
* ``FlashSRModules.init_params(seed)`` and the vocoder distiller's head
  init equal to the JAX package's, bit for bit;
* ``_vocoder_loss`` (with ``sisdr_w``) and its gradient against
  ``jax.value_and_grad``, float32;
* the trainers never write into the JAX package: default paths go under
  ``EGREGORA_TPU_WEIGHTS``.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models.flashsr import distill as j_distill
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.models.flashsr.vocoder import VocoderConfig as JVoc
from egregora_tpu.utils.weights import fast_init_like as j_fast_init_like
from egregora_tpu_torch.models.flashsr import distill as t_distill
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.models.flashsr import prng
from egregora_tpu_torch.models.flashsr.vocoder import build_vocoder
from egregora_tpu_torch.utils.weights import module_from_jax, params_from_jax

LENGTH = 4800                  # 0.1 s at 48 kHz
# waves against JAX (relative L2 over the batch); measured 1.1e-5 / 1.4e-5
# (incoherent) and 7.2e-5 / 6.2e-5 (coherent) at this length
WAVE_TOL = {0.0: 1e-4, 0.5: 5e-4}


def _key_data(k):
    return np.asarray(jax.random.key_data(k) if hasattr(jax.random, "key_data") else k)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7])
def test_fold_in_and_bernoulli_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for data in (0, 1, 98, 99, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data),
                                      _key_data(jax.random.fold_in(jk, data)))
    k = prng.fold_in(tk, 3)
    for p in (0.0, 0.25, 0.5, 1.0):
        for shape in ((), (9,)):
            got = prng.bernoulli(k, p, shape)
            want = np.asarray(jax.random.bernoulli(jax.random.fold_in(jk, 3), p, shape))
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def _jax_draws(key, length, coherent_p):
    """The random numbers the JAX ``_synth_one`` draws, by its own calls."""
    ks = jax.random.split(key, 14)
    u = jax.random.uniform
    d = {"f0": u(ks[0], (), minval=jnp.log(70.0), maxval=jnp.log(900.0)),
         "rolloff": u(ks[1], (), minval=0.5, maxval=1.8),
         "cf": u(ks[2], (3,), minval=jnp.log(200.0), maxval=jnp.log(14000.0)),
         "bw": u(ks[3], (3,), minval=0.3, maxval=1.0),
         "gn": u(ks[4], (3,), minval=0.0, maxval=2.0),
         "vr": u(ks[5], (), minval=3.0, maxval=7.0),
         "vd": u(ks[6], (), minval=0.0, maxval=0.008),
         "ph0": u(ks[7], (96,), maxval=2 * jnp.pi),
         "r": u(ks[8], (3,), minval=0.3, maxval=3.0),
         "p": u(ks[9], (3,), maxval=2 * jnp.pi),
         "white": jax.random.normal(ks[10], (length,), jnp.float32),
         "tilt": u(ks[11], (), minval=0.0, maxval=1.0),
         "nr": u(ks[12], (), minval=0.02, maxval=0.30),
         "peak": u(ks[13], (), minval=0.25, maxval=0.8),
         "cut": u(jax.random.fold_in(key, 99), (), minval=5000.0, maxval=11500.0)}
    if coherent_p > 0:
        kc = jax.random.fold_in(key, 98)
        d.update(coh=jax.random.bernoulli(jax.random.fold_in(kc, 0), coherent_p),
                 c=u(jax.random.fold_in(kc, 1), (), maxval=2 * jnp.pi),
                 f0_c=u(jax.random.fold_in(kc, 4), (), minval=jnp.log(150.0),
                        maxval=jnp.log(900.0)),
                 roll_c=u(jax.random.fold_in(kc, 2), (), minval=0.4, maxval=1.0),
                 ph0_f=u(jax.random.fold_in(kc, 3), (352,), maxval=2 * jnp.pi))
    return d


@pytest.mark.parametrize("coherent_p", [0.0, 0.5])
def test_synth_draws_match_jax_bit_for_bit(coherent_p):
    got = t_distill.synth_draws(prng.prng_key(11), 3, LENGTH, coherent_p)
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(11), 3)):
        want = _jax_draws(k, LENGTH, coherent_p)
        assert set(want) == set(got)
        for name, v in want.items():
            if name == "white":   # normals: bits exact, values within XLA's log1p roundoff
                assert np.abs(got[name][i] - np.asarray(v)).max() <= 1e-6
            else:
                np.testing.assert_array_equal(got[name][i], np.asarray(v), err_msg=name)


@pytest.mark.parametrize("coherent_p", [0.0, 0.5])
def test_synth_pair_batch_matches_jax(coherent_p):
    jl, jh = jax.jit(lambda k: j_distill.synth_pair_batch(k, 4, LENGTH, coherent_p=coherent_p))(
        jax.random.PRNGKey(3))
    tl, th = t_distill.synth_pair_batch(prng.prng_key(3), 4, LENGTH, coherent_p=coherent_p,
                                        device="cpu")
    for got, want in ((tl, jl), (th, jh)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < WAVE_TOL[coherent_p], rel
    # band-limited LR, as the JAX test holds it
    f = np.fft.rfftfreq(LENGTH, 1 / 48000)
    e_lr = (np.abs(np.fft.rfft(tl[0].numpy()))[f > 13000] ** 2).sum()
    e_hr = (np.abs(np.fft.rfft(th[0].numpy()))[f > 13000] ** 2).sum()
    assert e_lr < 1e-6 * e_hr and e_hr > 0


def _torch_cfg(jcfg):
    return t_distill._cfg_from_json(j_distill._cfg_to_json(jcfg))


ISTFT_EXC = JVoc(kind="istft", hidden=32, depth=2, phase_cond=True, exciter=True)


@pytest.mark.parametrize("which", ["full", "distilled", "istft-exciter"])
def test_init_params_match_jax_bit_for_bit(which):
    jcfg = {"full": j_pipe.FlashSRConfig(), "distilled": j_distill.distilled_config(),
            "istft-exciter": dataclasses.replace(j_distill.distilled_config(),
                                                 vocoder=ISTFT_EXC)}[which]
    want = jax.tree_util.tree_map(np.asarray, j_pipe.FlashSRModules(jcfg).init_params(5))
    tcfg = _torch_cfg(jcfg)
    ref = params_from_jax(tcfg, want)
    mods = t_pipe.FlashSRModules(tcfg)
    mods.init_params(5)
    for name, m in mods.by_name().items():
        sd = m.state_dict()
        assert set(sd) == set(ref[name])
        for key, v in ref[name].items():
            assert torch.equal(sd[key], v), (name, key)


def test_vocoder_head_init_matches_jax():
    """``init_vocoder_head`` = the JAX ``distill_vocoder``'s init of a
    phase-conditioned exciter head: fast_init_like over the vocoder's
    tree (with its ``ref`` input), gates zeroed, g1r's bias 1."""
    from egregora_tpu.models.flashsr.vocoder import build_vocoder as j_build
    jv = j_build(ISTFT_EXC)
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(4), jnp.zeros((1, 128, 256)),
                                            ref=jnp.zeros((1, 128 * 480))))
    p = jax.tree_util.tree_map(np.asarray, j_fast_init_like(shapes, 4))
    q = p["params"]
    for name in ("phase_gates", "mag_gate"):
        q[name]["kernel"] = np.zeros_like(q[name]["kernel"])
    b = np.zeros_like(q["phase_gates"]["bias"])
    b[: b.shape[0] // 10] = 1.0
    q["phase_gates"]["bias"] = b
    tcfg = _torch_cfg(dataclasses.replace(j_distill.distilled_config(), vocoder=ISTFT_EXC))
    voc = build_vocoder(tcfg.vocoder)
    t_distill.init_vocoder_head(voc, 4)
    want = module_from_jax(voc, p)
    for key, v in voc.state_dict().items():
        assert torch.equal(v, want[key]), key


def test_neg_sisdr_matches_jax():
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((3, 999)).astype(np.float32)
    est = (ref + 0.3 * rng.standard_normal((3, 999))).astype(np.float32)
    want = float(j_distill._neg_sisdr(jnp.asarray(est), jnp.asarray(ref)))
    got = float(t_distill._neg_sisdr(torch.from_numpy(est), torch.from_numpy(ref)))
    assert abs(got - want) < 1e-5 * abs(want)


# (loss, gradient) relative limits.  Measured: the plain head's loss 3e-7
# and gradients <= 2.2e-4; the phase-conditioned exciter head's own output
# differs by 3.3e-5 between the packages (the unit phasors of near-empty
# STFT bins are roundoff), its loss by 4.4e-5, its gradients <= 1.05e-3
VOC_TOL = {False: (1e-5, 1e-3), True: (2e-4, 1e-2)}


@pytest.fixture(scope="module", params=[False, True], ids=["istft", "phase-cond-exciter"])
def vocoder_setup(request):
    """A tiny frozen VAE/UNet at 256 mels (``_vocoder_loss`` fixes hop 480
    and 256 mels) and an istft head, plain or phase-conditioned with the
    exciter, float32."""
    from egregora_tpu.models.flashsr.unet import UNetConfig as JU
    from egregora_tpu.models.flashsr.vae import VAEConfig as JV
    jcfg = j_pipe.FlashSRConfig(
        vae=JV(base_channels=8, channel_mults=(1, 2), latent_channels=4, num_res_blocks=1,
               groups=4, mid_attn=False, use_quant_conv=False, dtype=jnp.float32),
        unet=JU(in_channels=8, out_channels=4, base_channels=8, channel_mults=(1,),
                num_res_blocks=1, attn_levels=(), num_heads=2, time_dim=16, groups=4,
                dtype=jnp.float32),
        vocoder=JVoc(kind="istft", hidden=16, depth=1, phase_cond=request.param,
                     exciter=request.param, dtype=jnp.float32))
    jm = j_pipe.FlashSRModules(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(1))
    rng = np.random.default_rng(0)
    lr_w = (0.1 * rng.standard_normal((2, 480 * 8))).astype(np.float32)
    hr_w = (0.1 * rng.standard_normal((2, 480 * 8))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    frozen = {"vae": params["vae"], "student_ldm": params["student_ldm"]}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda vp: j_distill._vocoder_loss(jm, frozen, vp, lr_w, hr_w, key, sisdr_w=0.5)))(
        params["sr_vocoder"])
    tcfg = _torch_cfg(jcfg)
    fix = lambda c: dataclasses.replace(c, dtype=torch.float32)       # noqa: E731
    tcfg = dataclasses.replace(tcfg, vae=fix(tcfg.vae), unet=fix(tcfg.unet),
                               vocoder=fix(tcfg.vocoder))
    return request.param, tcfg, params, lr_w, hr_w, key, float(loss), grads


def test_vocoder_loss_and_gradient_match_jax(vocoder_setup):
    pc, tcfg, params, lr_w, hr_w, key, jloss, jgrads = vocoder_setup
    loss_tol, grad_tol = VOC_TOL[pc]
    mods = t_pipe.FlashSRModules(tcfg)
    mods.load_state_dicts(params_from_jax(tcfg, params))
    for m in (mods.vae, mods.unet):
        m.requires_grad_(False)
    loss = t_distill._vocoder_loss(mods, torch.from_numpy(lr_w), torch.from_numpy(hr_w),
                                   np.asarray(_key_data(key), np.uint32), sisdr_w=0.5)
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= loss_tol * abs(jloss), (float(loss), jloss)
    want = params_from_jax(tcfg, {**params, "sr_vocoder": jax.tree_util.tree_map(
        np.asarray, jgrads)})["sr_vocoder"]
    total = sum(float(v.norm() ** 2) for v in want.values()) ** 0.5
    for key_, prm in mods.vocoder.named_parameters():
        err = float((prm.grad - want[key_]).norm())
        assert err <= grad_tol * float(want[key_].norm()) + 1e-6 * total, key_
    assert all(p.grad is None for p in mods.vae.parameters())


def _digests(root):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.glob("*.npz"))}


def test_trainers_write_under_the_weights_dir(tmp_path, monkeypatch):
    """Default-argument runs of both trainers write under
    ``$EGREGORA_TPU_WEIGHTS/flashsr``; the shipped npz files stay
    byte-identical; ``--resume`` without weights raises as in JAX."""
    shipped = t_distill.SHIPPED_DIR
    before = _digests(shipped)
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    tiny = _torch_cfg(j_pipe.FlashSRConfig(
        vae=j_distill.distilled_config().vae,
        unet=dataclasses.replace(j_distill.distilled_config().unet, base_channels=8,
                                 channel_mults=(1,), num_res_blocks=1, time_dim=16),
        vocoder=JVoc(upsample_initial=16, channel_floor=8, resblock_kernels=(3,),
                     resblock_dilations=((1,),))))
    m = t_distill.distill(steps=1, batch=1, frames=8, cfg=tiny, device="cpu")
    assert (tmp_path / "flashsr" / "pretrained.npz").exists()
    assert (tmp_path / "flashsr" / "pretrained.json").exists()
    assert np.isfinite(m["loss_first"]) and np.isfinite(m["lsd_model"])
    back = t_distill.load_pretrained_with_cfg(tmp_path / "flashsr" / "pretrained.npz")
    assert back[0] == tiny
    m = t_distill.distill_vocoder(steps=1, batch=1, frames=16, hidden=16, depth=1,
                                  phase_cond=True, exciter=True, device="cpu")
    assert (tmp_path / "flashsr" / "pretrained_istft.npz").exists()
    assert np.isfinite(m["loss_first"])
    assert _digests(shipped) == before
    with pytest.raises(FileNotFoundError):
        t_distill.distill(steps=1, resume=True, out_path=tmp_path / "absent.npz", device="cpu")
