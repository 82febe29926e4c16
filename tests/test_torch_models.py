"""PyTorch port vs the JAX package: the FlashSR models at small widths.

The JAX modules' parameters go through ``params_from_jax`` so both
sides compute with the same weights; every comparison is float32 on the
CPU (``dtype=float32`` on both sides).  Tolerances are absolute, 1e-4:
the convolutions sum in another order on each side, ~1e-7 relative per
layer over a few dozen layers on activations of order 1-10.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models.flashsr import ldm_unet as j_ldm
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.models.flashsr import vae as j_vae
from egregora_tpu.models.flashsr import vocoder as j_voc
from egregora_tpu.utils.weights import fast_init_like
from egregora_tpu_torch.models.flashsr import layers
from egregora_tpu_torch.models.flashsr import ldm_unet as t_ldm
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.models.flashsr import vae as t_vae
from egregora_tpu_torch.models.flashsr import vocoder as t_voc
from egregora_tpu_torch.utils.weights import module_from_jax, params_from_jax

ATOL = 1e-4


def _init(module, *args, seed=0, **kw):
    """fast_init_like params (random everywhere, zero-init convs too)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return jax.tree_util.tree_map(np.asarray, fast_init_like(shapes, seed))


def _load(t_module, j_vars):
    t_module.load_state_dict(module_from_jax(t_module, j_vars), strict=True)
    return t_module.eval()


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_vae_encode_decode_with_mid_attention_and_quant_convs():
    kw = dict(base_channels=16, channel_mults=(1, 2, 2), latent_channels=4, groups=8)
    jm = j_vae.MelVAE(j_vae.VAEConfig(dtype=jnp.float32, **kw))
    tm = t_vae.MelVAE(t_vae.VAEConfig(dtype=torch.float32, **kw))
    mel = _x((2, 64, 32, 1), 1)
    p = _init(jm, jnp.asarray(mel), seed=3)
    assert "AttnBlock2D_0" in p["params"]["encoder"] and "quant_conv" in p["params"]
    _load(tm, p)
    with torch.no_grad():
        z = tm.encode(torch.from_numpy(mel)).numpy()
        zr = np.asarray(jm.apply(p, jnp.asarray(mel), method=j_vae.MelVAE.encode))
        assert z.shape == zr.shape == (2, 16, 8, 4)
        assert np.abs(z - zr).max() <= ATOL
        zz = _x(zr.shape, 2)
        d = tm.decode(torch.from_numpy(zz)).numpy()
        dr = np.asarray(jm.apply(p, jnp.asarray(zz), method=j_vae.MelVAE.decode))
        assert d.shape == dr.shape == mel.shape
        assert np.abs(d - dr).max() <= ATOL


def test_ldm_unet_attention_at_two_levels():
    kw = dict(in_channels=8, out_channels=4, model_channels=16, channel_mult=(1, 2, 2),
              attention_resolutions=(2, 4), num_heads=2, groups=8)
    jm = j_ldm.LDMUNet(j_ldm.LDMUNetConfig(dtype=jnp.float32, **kw))
    tm = t_ldm.LDMUNet(t_ldm.LDMUNetConfig(dtype=torch.float32, **kw))
    z = _x((2, 32, 16, 8), 4)
    t = np.array([1.0, 0.5], np.float32)
    p = _init(jm, jnp.asarray(z), jnp.asarray(t), seed=5)
    _load(tm, p)
    attn = [n for n, m in tm.named_modules() if isinstance(m, t_ldm.LDMAttentionBlock)]
    assert len(attn) == 11          # 5 at ds=2 and 6 at ds=4, as at full config
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(t)).numpy()
    ref = np.asarray(jm.apply(p, jnp.asarray(z), jnp.asarray(t)))
    assert got.shape == ref.shape == (2, 32, 16, 4)
    assert np.abs(got - ref).max() <= ATOL


def test_sr_vocoder_module_path():
    cfg = dict(n_mels=32, upsample_initial=32, channel_floor=8)
    jm = j_voc.SRVocoder(j_voc.VocoderConfig(dtype=jnp.float32, **cfg))
    tm = t_voc.SRVocoder(t_voc.VocoderConfig(dtype=torch.float32, **cfg))
    mel = _x((2, 12, 32), 6)
    p = _init(jm, jnp.asarray(mel), seed=7)
    _load(tm, p)
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
    ref = np.asarray(jm.apply(p, jnp.asarray(mel)))
    assert got.shape == ref.shape == (2, 12 * 480)
    assert np.abs(got - ref).max() <= ATOL


# ---------------- hazards of the flax -> torch translation ----------------

@pytest.mark.parametrize("h,w", [(8, 6), (7, 5)])
def test_stride2_same_pads_after(h, w):
    """flax pads a stride-2 3x3 'SAME' conv (0, 1) on even sizes; torch's
    padding=1 would pad (1, 1) and shift every output by one tap."""
    x = _x((1, h, w, 3), 8)
    jm = fnn.Conv(4, (3, 3), strides=(2, 2), dtype=jnp.float32)
    p = _init(jm, jnp.asarray(x), seed=9)
    tm = _load(layers.Conv2d(3, 4, 3, stride=2, dtype=torch.float32), p)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5
    assert layers.same_pads(h, 3, 2) == ((0, 1) if h % 2 == 0 else (1, 1))


@pytest.mark.parametrize("k,s", [(20, 10), (16, 8), (12, 6), (3, 5), (4, 1)])
def test_conv_transpose_flax_semantics(k, s):
    """flax ConvTranspose (transpose_kernel=False, 'SAME') = torch
    conv_transpose1d with the kernel flipped and channel-swapped, cropped
    to length*stride."""
    x = _x((2, 9, 6), 10)
    jm = fnn.ConvTranspose(5, (k,), strides=(s,), dtype=jnp.float32)
    p = _init(jm, jnp.asarray(x), seed=11)
    p["params"]["bias"] = _x((5,), 12)
    tm = _load(layers.ConvTranspose1d(6, 5, k, s, dtype=torch.float32), p)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 9 * s, 5)
    assert np.abs(got - ref).max() <= 1e-5


def test_group_norm_eps_and_f32_statistics():
    """eps 1e-6 (torch's default is 1e-5) and float32 statistics for bf16
    activations: a low-variance input tells both apart."""
    x = _x((2, 6, 5, 8), 13, scale=1e-3)
    jm = fnn.GroupNorm(num_groups=4, dtype=jnp.bfloat16)
    p = {"params": {"scale": _x((8,), 14) + 1.0, "bias": _x((8,), 15)}}
    tm = _load(layers.GroupNorm(4, 8, dtype=torch.bfloat16), p)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(jm.apply(p, jnp.asarray(xb.float().numpy(), jnp.bfloat16))
                     .astype(jnp.float32))
    with torch.no_grad():
        got = tm(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    # both round one float32 result to bf16: at most one bf16 step apart
    assert (np.abs(got.float().numpy() - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6).all()
    x32 = torch.from_numpy(x).permute(0, 3, 1, 2)
    torch_default = torch.nn.functional.group_norm(x32, 4, tm.weight, tm.bias)
    assert (torch_default.permute(0, 2, 3, 1) - got.float()).abs().max() > 0.1


def test_params_from_jax_full_width_round_trip():
    """The full config, shapes only (jax.eval_shape, meta tensors): every
    flax leaf lands on exactly one port parameter of the same size, and
    every port parameter is filled."""
    mods = j_pipe.FlashSRModules(j_pipe.FlashSRConfig())
    z = jnp.zeros((1, 128, 64, 32))
    shapes = jax.eval_shape(lambda: {
        "vae": mods.vae.init(jax.random.PRNGKey(0), jnp.zeros((1, 512, 256, 1))),
        "student_ldm": mods.unet.init(jax.random.PRNGKey(1), z, jnp.zeros((1,))),
        "sr_vocoder": mods.vocoder.init(jax.random.PRNGKey(2), jnp.zeros((1, 512, 256))),
    })
    sd = params_from_jax(t_pipe.FlashSRConfig(), shapes)
    with torch.device("meta"):
        ref = t_pipe.FlashSRModules(t_pipe.FlashSRConfig())
    n_flax = n_port = 0
    for name, m in ref.by_name().items():
        want = m.state_dict()
        assert set(sd[name]) == set(want)
        for key, t in sd[name].items():
            assert t.device.type == "meta" and t.shape == want[key].shape, key
            n_port += t.numel()
        n_flax += sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes[name]))
    assert n_flax == n_port > 90_000_000          # 91.6M at full width
    bad = jax.tree_util.tree_map(lambda s: s, shapes)
    bad["vae"]["params"]["extra"] = {"kernel": jax.ShapeDtypeStruct((3, 3, 1, 1), jnp.float32)}
    with pytest.raises(KeyError):
        params_from_jax(t_pipe.FlashSRConfig(), bad)
    del bad["vae"]["params"]["extra"], bad["vae"]["params"]["quant_conv"]
    with pytest.raises(KeyError):
        params_from_jax(t_pipe.FlashSRConfig(), bad)
