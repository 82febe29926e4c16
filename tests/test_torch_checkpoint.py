"""PyTorch port vs the JAX package: the converted reference checkpoints.

Real ``.pth`` trios (``torch.save``, upstream key layouts, a
weight-normalised vocoder, the head-major fused qkv) are written by the
JAX package's own fixture, ``tests/test_checkpoint_e2e.py::_build_trio``,
at its reduced geometry and at the published FlashSR one (VAE base 128,
whose single-head mid attention runs at D = 512).  Both packages infer
the geometry, convert and cache; the port must agree key for key, read
the other's cache, and run the same forward within float32 rounding.
"""
import dataclasses
import os
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_checkpoint_e2e as e2e
from egregora_tpu.models.flashsr import distill as j_distill
from egregora_tpu.models.flashsr import geometry as j_geometry
from egregora_tpu.models.flashsr import ldm_unet as j_ldm
from egregora_tpu.models.flashsr import pipeline as j_pipe
from egregora_tpu.models.flashsr import vae as j_vae
from egregora_tpu.models.flashsr import vocoder as j_voc
from egregora_tpu.utils import weights as j_weights
from egregora_tpu_torch.models.flashsr import distill, geometry
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.ops import attention
from egregora_tpu_torch.utils import weights

GEOMETRIES = {"reduced": (e2e._reduced_cfg, "2"), "published": (e2e._upstream_published_cfg, None)}
# forward on [1, 32 frames, 32 mels]: the latent (8 x 8) survives the
# UNet's two downsamples; the VAE mid attention sees 64 tokens.  The
# vocoder takes 16 frames of 256 mels
FRAMES, MELS, VOC_FRAMES = 32, 32, 16
# float32 on both sides, relative L2 of each output: the two packages'
# convs and matmuls sum in other orders (~1e-7 a layer); through ~60
# layers of random lecun-normal weights that stays below 1e-5
FWD_REL = 1e-4


def _heads_env(mp, heads):
    if heads is None:
        mp.delenv("EGREGORA_FLASHSR_NUM_HEADS", raising=False)
    else:
        mp.setenv("EGREGORA_FLASHSR_NUM_HEADS", heads)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def trio(request, tmp_path_factory):
    """One trio per geometry, converted by each package into its own
    copy of the directory (so each writes its own cache)."""
    name = request.param
    make_cfg, heads = GEOMETRIES[name]
    mp = pytest.MonkeyPatch()
    _heads_env(mp, heads)
    src = tmp_path_factory.mktemp(f"{name}_src")
    shapes = e2e._build_trio(make_cfg(), src)[0]
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path_factory.mktemp(f"{name}_{side}")
        for f in distill.CONVERTED_FILES:
            shutil.copy(src / f, dirs[side] / f)
    j_cfg, j_params = _jax_convert(dirs["jax"], shapes)
    t_cfg, t_sd = distill.load_converted_flashsr(ckpt_dir=dirs["port"])
    yield {"name": name, "published": make_cfg(), "dirs": dirs, "j_cfg": j_cfg,
           "j_params": j_params, "t_cfg": t_cfg, "t_sd": t_sd}
    mp.undo()


def _jax_convert(d, shapes):
    """The JAX package's ``load_converted_flashsr`` on the trio in ``d``
    (infer, convert with the three name maps, cache with the sidecar),
    with the trio's own parameter tree as the conversion target: only its
    shapes are read, and it saves a second seeded init of the model."""
    sds = {n: j_weights.load_torch_state_dict(d / f"{n}.pth")
           for n in ("vae", "student_ldm", "sr_vocoder")}
    cfg = j_geometry.infer_flashsr_config(sds["vae"], sds["student_ldm"], sds["sr_vocoder"])
    maps = {"vae": j_vae.audioldm_vae_name_map(cfg.vae),
            "sr_vocoder": j_voc.hifigan_name_map(cfg.vocoder),
            "student_ldm": j_ldm.ldm_unet_name_map(cfg.unet)}
    params = {n: j_weights.convert_state_dict(sds[n], shapes[n], name_map=maps[n]) for n in sds}
    j_weights.save_params(params, d / distill.CACHE)
    (d / distill.SIDECAR).write_text(j_distill._cfg_to_json(cfg))
    return cfg, params


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in j_weights._flatten(tree).items()}


def test_inferred_geometry_matches_jax(trio):
    """The port infers the JAX package's config from the same state dicts;
    at the published geometry it is the published config."""
    assert distill._cfg_to_json(trio["t_cfg"]) == j_distill._cfg_to_json(trio["j_cfg"])
    assert distill._cfg_from_json(j_distill._cfg_to_json(trio["j_cfg"])) == trio["t_cfg"]
    if trio["name"] == "published":
        assert trio["j_cfg"].vae == trio["published"].vae
        assert trio["t_cfg"].vae.base_channels * trio["t_cfg"].vae.channel_mults[-1] == 512
        assert trio["t_cfg"].unet.num_heads == 8


def test_geometry_functions_match_jax(trio):
    """Each ``infer_*`` of the port on the raw state dicts, against the
    JAX one (numbers compared through the JSON both packages write)."""
    d = trio["dirs"]["port"]
    sds = {n: weights.load_torch_state_dict(d / f"{n}.pth")
           for n in ("vae", "student_ldm", "sr_vocoder")}
    for t_fn, j_fn, key in ((geometry.infer_vae_config, j_geometry.infer_vae_config, "vae"),
                            (geometry.infer_ldm_unet_config,
                             j_geometry.infer_ldm_unet_config, "student_ldm"),
                            (geometry.infer_vocoder_config,
                             j_geometry.infer_vocoder_config, "sr_vocoder")):
        t, j = t_fn(sds[key]), j_fn(sds[key])
        assert ({f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "dtype"}
                == {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"})


def test_converted_arrays_match_jax_key_for_key(trio):
    """The port's cache holds the JAX package's converted arrays, key for
    key and bit for bit; its state dicts are those arrays mapped by
    ``params_from_jax``."""
    port = _flat_np(weights.load_params(trio["dirs"]["port"] / distill.CACHE))
    jax_ = _flat_np(trio["j_params"])
    assert set(port) == set(jax_)
    for k in jax_:
        np.testing.assert_array_equal(port[k], jax_[k], err_msg=k)
    ref = weights.params_from_jax(trio["t_cfg"], {k: _np_tree(v)
                                                  for k, v in trio["j_params"].items()})
    for m in ref:
        assert set(ref[m]) == set(trio["t_sd"][m])
        for k in ref[m]:
            assert torch.equal(ref[m][k], trio["t_sd"][m][k]), (m, k)


def _np_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_cache_interop_both_ways(trio):
    """A cache the port wrote loads in the JAX package, and the JAX
    package's cache loads in the port, each with its geometry sidecar."""
    port_dir, jax_dir = trio["dirs"]["port"], trio["dirs"]["jax"]
    assert (port_dir / distill.SIDECAR).exists()
    j_from_port = _flat_np(j_weights.load_params(port_dir / distill.CACHE))
    for k, v in _flat_np(trio["j_params"]).items():
        np.testing.assert_array_equal(j_from_port[k], v, err_msg=k)
    assert j_distill._cfg_from_json((port_dir / distill.SIDECAR).read_text()) == trio["j_cfg"]

    for f in distill.CONVERTED_FILES:       # the cache alone must serve
        (jax_dir / f).unlink()
    t_cfg, t_sd = distill.load_converted_flashsr(ckpt_dir=jax_dir)
    assert t_cfg == trio["t_cfg"]
    for m in t_sd:
        for k in t_sd[m]:
            assert torch.equal(t_sd[m][k], trio["t_sd"][m][k]), (m, k)


def _f32(cfg, pkg_dtype):
    return dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), dtype=pkg_dtype)
                                       for k in ("vae", "unet", "vocoder")})


def test_converted_forward_matches_jax(trio, monkeypatch):
    """encode -> UNet -> decode and the vocoder, float32 on both sides, on
    the converted weights; at the published geometry the VAE's mid
    attention runs one head of D = 512."""
    rng = np.random.default_rng(3)
    mel_img = rng.standard_normal((1, FRAMES, MELS, 1)).astype(np.float32)
    mel = rng.standard_normal((1, VOC_FRAMES, 256)).astype(np.float32)

    j_mods = j_pipe.FlashSRModules(_f32(trio["j_cfg"], jnp.float32))
    p = trio["j_params"]
    vae_t = type(j_mods.vae)
    # the parameters go in as arguments, not as constants of the program
    z = jax.jit(lambda w, x: j_mods.vae.apply(w, x, method=vae_t.encode))(
        p["vae"], jnp.asarray(mel_img))
    zi = jnp.concatenate([z, z], axis=-1)
    pred = jax.jit(lambda w, a: j_mods.unet.apply(w, a, jnp.ones((1,))))(p["student_ldm"], zi)
    dec = jax.jit(lambda w, a: j_mods.vae.apply(w, a, method=vae_t.decode))(p["vae"], pred)
    wav = jax.jit(j_mods.vocoder.apply)(p["sr_vocoder"], jnp.asarray(mel))
    ref = {k: np.asarray(v) for k, v in (("z", z), ("pred", pred), ("dec", dec), ("wav", wav))}

    seen = []
    real = attention.attn_rows

    def recording(q, k, v):
        seen.append(tuple(q.shape))
        return real(q, k, v)

    monkeypatch.setattr(attention, "attn_rows", recording)
    # the kernel's path, as on the card (on the CPU "auto" takes the chunked engine)
    monkeypatch.setenv("EGREGORA_ATTN_PATH", "pallas")
    t_mods = t_pipe.FlashSRModules(_f32(trio["t_cfg"], torch.float32))
    t_mods.load_state_dicts(trio["t_sd"])
    t_mods.to("cpu")
    with torch.no_grad():
        tz = t_mods.vae.encode(torch.from_numpy(mel_img))
        tpred = t_mods.unet(torch.cat([tz, tz], dim=-1), torch.ones(1))
        tdec = t_mods.vae.decode(tpred)
        twav = t_mods.vocoder(torch.from_numpy(mel))
    got = {"z": tz, "pred": tpred, "dec": tdec, "wav": twav}
    assert ref["wav"].shape == (1, VOC_FRAMES * int(np.prod(trio["t_cfg"].vocoder.upsample_factors)))
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.shape == r.shape, k
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert np.isfinite(g).all() and rel <= FWD_REL, (k, rel)
    vae_mid = trio["t_cfg"].vae.base_channels * trio["t_cfg"].vae.channel_mults[-1]
    tokens = (FRAMES // 4) * (MELS // 4)
    assert seen.count((1, tokens, vae_mid)) == 2       # encoder and decoder mid blocks
    if trio["name"] == "published":
        assert vae_mid == 512


def test_resolver_serves_converted_trio(trio, monkeypatch):
    """``EGREGORA_TPU_WEIGHTS/flashsr`` holding the port's converted cache
    resolves as "converted" at the inferred geometry."""
    root = trio["dirs"]["port"].parent / f"{trio['name']}_root"
    (root / "flashsr").mkdir(parents=True, exist_ok=True)
    for f in (distill.CACHE, distill.SIDECAR):
        shutil.copy(trio["dirs"]["port"] / f, root / "flashsr" / f)
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(root))
    cfg, sd, source = distill.resolve_flashsr()
    assert source == "converted" and cfg == trio["t_cfg"]
    assert set(sd) == {"vae", "student_ldm", "sr_vocoder"}


@pytest.mark.parametrize("present", [(), ("vae.pth",), ("vae.pth", "sr_vocoder.pth")])
def test_missing_files_fall_through_without_fetching(tmp_path, monkeypatch, present, capsys):
    """With no trio, or part of one, and ``EGREGORA_TPU_OFFLINE`` set (as
    the suite sets it), the resolver serves the shipped istft trio: its
    first-use fetch is consulted and declines, so no download runs and
    nothing opens a connection."""
    from egregora_tpu_torch.utils import fetch
    assert os.environ.get("EGREGORA_TPU_OFFLINE")
    d = tmp_path / "flashsr"
    d.mkdir()
    for f in present:
        (d / f).write_bytes(b"")
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.delenv("EGREGORA_FLASHSR_VARIANT", raising=False)

    def no_network(*args, **kwargs):
        raise AssertionError("the resolver tried to open a connection")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(fetch, "fetch_flashsr_weights", no_network)
    cfg, sd, source = distill.resolve_flashsr()
    assert source == "distilled-istft" and sd is not None
    assert ("lacks" in capsys.readouterr().out) == bool(present)


def test_smoke_trio_writer_inverts_the_conversion(tmp_path, monkeypatch):
    """``chip_smoke.write_reference_trio`` (the card run's upstream-layout
    trio, written from the port's seeded modules through the inverted name
    maps, with weight-norm pairs) converts back, in the JAX package and in
    the port, to the weights it was drawn from."""
    monkeypatch.setenv("EGREGORA_FLASHSR_NUM_HEADS", "2")
    cfg = distill._cfg_from_json(j_distill._cfg_to_json(e2e._reduced_cfg()))
    # 32 -> 16 -> 8 channels: the reduced config's second upsampler is
    # [8, 8, 8], and both converters skip a name map's explicit transpose
    # when the shapes already agree, so a cubic ConvTranspose kernel
    # converts untransposed (ROADMAP.md, Queue 3)
    cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder, upsample_initial=32))
    chip_smoke.write_reference_trio(cfg, tmp_path, seed=5)
    src = chip_smoke.legacy_init(t_pipe.FlashSRModules(cfg), 5)
    j_cfg, j_params = j_weights.load_converted_flashsr(ckpt_dir=tmp_path)
    t_cfg, t_sd = distill.load_converted_flashsr(ckpt_dir=tmp_path)   # reads the JAX cache
    assert distill._cfg_to_json(t_cfg) == j_distill._cfg_to_json(j_cfg)
    via_jax = weights.params_from_jax(t_cfg, {k: _np_tree(v) for k, v in j_params.items()})
    for name, mod in src.by_name().items():
        want = mod.state_dict()
        for got in (via_jax[name], t_sd[name]):
            assert set(got) == set(want)
            for k, v in want.items():
                # the vocoder's weights went through weight_g * v / ||v||
                torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-7, msg=k)
