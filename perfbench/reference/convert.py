"""Weights into the reference: upstream checkpoints and the JAX package's
``.npz`` trios.

``load_upstream`` maps the three upstream state dicts (``vae.pth``: the
AudioLDM AutoencoderKL layout; ``student_ldm.pth``: the CompVis
``UNetModel``; ``sr_vocoder.pth``: the weight-normalised HiFi-GAN
generator) onto the reference modules by the same naming the port's
converter follows (a frozen copy of its ``audioldm_vae_name_map``,
``ldm_unet_name_map`` and ``hifigan_name_map``), directly into the
reference's torch layouts: the CompVis fused qkv is read head-major and
regrouped slot-major, 1D convs of width 1 become dense weights, the
transposed convs are flipped along their taps, and weight-norm pairs are
folded.  ``upstream_layout`` lists each upstream key with its shape,
which the benchmark's seeded draw fills.

``load_npz`` reads a ``.npz`` trio (flat ``/``-joined flax keys, a
``__config__`` JSON entry) into the reference modules: flax kernels
``[*k, in, out]`` to torch ``[out, in, *k]``, dense kernels transposed,
transposed-conv kernels permuted and flipped, ``scale`` to ``weight``.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from .models import LDMUNetConfig, UNetConfig, VAEConfig, VocoderConfig

Entry = Tuple[str, str]     # (reference state-dict key, transform)


def _vae_map(cfg: VAEConfig) -> Dict[str, Entry]:
    L, R = len(cfg.channel_mults), cfg.num_res_blocks
    m: Dict[str, Entry] = {}

    def param(u, r):
        m[f"{u}.weight"] = (f"{r}.weight", "same")
        m[f"{u}.bias"] = (f"{r}.bias", "same")

    def res(u, r, shortcut):
        for a, b in (("norm1", "GroupNorm_0"), ("conv1", "Conv_0"),
                     ("norm2", "GroupNorm_1"), ("conv2", "Conv_1")):
            param(f"{u}.{a}", f"{r}.{b}")
        if shortcut:
            param(f"{u}.nin_shortcut", f"{r}.Conv_2")

    def attn(u, r):
        param(f"{u}.norm", f"{r}.GroupNorm_0")
        for lin in ("q", "k", "v", "proj_out"):
            param(f"{u}.{lin}", f"{r}.{lin}")

    param("encoder.conv_in", "encoder.Conv_0")
    for i in range(L):
        ch_in = cfg.channel_mults[i - 1] if i else 1
        for j in range(R):
            res(f"encoder.down.{i}.block.{j}", f"encoder.ResBlock_{i * R + j}",
                j == 0 and cfg.channel_mults[i] != ch_in)
        if i < L - 1:
            param(f"encoder.down.{i}.downsample.conv", f"encoder.Conv_{i + 1}")
    if cfg.mid_attn:
        res("encoder.mid.block_1", f"encoder.ResBlock_{L * R}", False)
        attn("encoder.mid.attn_1", "encoder.AttnBlock2D_0")
        res("encoder.mid.block_2", f"encoder.ResBlock_{L * R + 1}", False)
    param("encoder.norm_out", "encoder.GroupNorm_0")
    param("encoder.conv_out", f"encoder.Conv_{L}")
    mults = tuple(reversed(cfg.channel_mults))
    param("decoder.conv_in", "decoder.Conv_0")
    off = 0
    if cfg.mid_attn:
        res("decoder.mid.block_1", "decoder.ResBlock_0", False)
        attn("decoder.mid.attn_1", "decoder.AttnBlock2D_0")
        res("decoder.mid.block_2", "decoder.ResBlock_1", False)
        off = 2
    for i in range(L):
        u = L - 1 - i          # upstream lists the decoder's levels in reverse
        ch_in = mults[i - 1] if i else mults[0]
        for j in range(R):
            res(f"decoder.up.{u}.block.{j}", f"decoder.ResBlock_{off + i * R + j}",
                j == 0 and mults[i] != ch_in)
        if i < L - 1:
            param(f"decoder.up.{u}.upsample.conv", f"decoder.Conv_{i + 1}")
    param("decoder.norm_out", "decoder.GroupNorm_0")
    param("decoder.conv_out", f"decoder.Conv_{L}")
    if cfg.use_quant_conv:
        param("quant_conv", "quant_conv")
        param("post_quant_conv", "post_quant_conv")
    return m


def _ldm_map(cfg: LDMUNetConfig) -> Dict[str, Entry]:
    m: Dict[str, Entry] = {}

    def param(u, r, w="same", b="same"):
        m[f"{u}.weight"] = (f"{r}.weight", w)
        m[f"{u}.bias"] = (f"{r}.bias", b)

    def res(u, r, cin, cout):
        param(f"{u}.in_layers.0", f"{r}.in_layers_0")
        param(f"{u}.in_layers.2", f"{r}.in_layers_2")
        param(f"{u}.emb_layers.1", f"{r}.emb_layers_1", "dense")
        param(f"{u}.out_layers.0", f"{r}.out_layers_0")
        param(f"{u}.out_layers.3", f"{r}.out_layers_3")
        if cin != cout:
            param(f"{u}.skip_connection", f"{r}.skip_connection")

    def attn(u, r):
        param(f"{u}.norm", f"{r}.norm")
        param(f"{u}.qkv", f"{r}.qkv", "qkv", "qkv")
        param(f"{u}.proj_out", f"{r}.proj_out", "dense")

    mc = cfg.model_channels
    param("time_embed.0", "time_embed_0", "dense")
    param("time_embed.2", "time_embed_2", "dense")
    param("input_blocks.0.0", "input_blocks_0_0")
    chans = [mc]
    ch, ds, idx = mc, 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            res(f"input_blocks.{idx}.0", f"input_blocks_{idx}_0", ch, mult * mc)
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                attn(f"input_blocks.{idx}.1", f"input_blocks_{idx}_1")
            chans.append(ch)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            param(f"input_blocks.{idx}.0.op", f"input_blocks_{idx}_0_op")
            chans.append(ch)
            ds *= 2
            idx += 1
    res("middle_block.0", "middle_block_0", ch, ch)
    attn("middle_block.1", "middle_block_1")
    res("middle_block.2", "middle_block_2", ch, ch)
    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            res(f"output_blocks.{idx}.0", f"output_blocks_{idx}_0", ch + chans.pop(), mult * mc)
            ch = mult * mc
            sub = 1
            if ds in cfg.attention_resolutions:
                attn(f"output_blocks.{idx}.{sub}", f"output_blocks_{idx}_{sub}")
                sub += 1
            if level and i == cfg.num_res_blocks:
                param(f"output_blocks.{idx}.{sub}.conv", f"output_blocks_{idx}_{sub}_conv")
                ds //= 2
            idx += 1
    param("out.0", "out_0")
    param("out.2", "out_2")
    return m


def _hifigan_map(cfg: VocoderConfig) -> Dict[str, Entry]:
    m: Dict[str, Entry] = {}

    def param(u, r, w="wn"):
        m[f"{u}.weight"] = (f"{r}.weight", w)
        m[f"{u}.bias"] = (f"{r}.bias", "same")

    param("conv_pre", "Conv_0")
    param("conv_post", "Conv_1")
    nk = len(cfg.resblock_kernels)
    for i in range(len(cfg.upsample_factors)):
        param(f"ups.{i}", f"ConvTranspose_{i}", "wn_flip")
        for j in range(nk):
            for d in range(len(cfg.resblock_dilations[j])):
                base = f"resblocks.{i * nk + j}"
                param(f"{base}.convs1.{d}", f"MRF_{i}.ResBlock1D_{j}.Conv_{2 * d}")
                param(f"{base}.convs2.{d}", f"MRF_{i}.ResBlock1D_{j}.Conv_{2 * d + 1}")
    return m


def upstream_maps(vae: VAEConfig, unet: LDMUNetConfig, voc: VocoderConfig
                  ) -> Dict[str, Dict[str, Entry]]:
    """Upstream key -> (reference key, transform), per checkpoint."""
    return {"vae": _vae_map(vae), "student_ldm": _ldm_map(unet),
            "sr_vocoder": _hifigan_map(voc)}


def _qkv_rows(n: int, heads: int) -> torch.Tensor:
    """Row order taking CompVis's head-major ``(h, slot, d)`` fused qkv to
    the reference's slot-major ``(slot, h, d)``."""
    hd = n // (3 * heads)
    return torch.arange(n).reshape(heads, 3, hd).transpose(0, 1).reshape(-1)


def _to_reference(v: torch.Tensor, kind: str, heads: int) -> torch.Tensor:
    if kind == "dense":
        return v[..., 0] if v.dim() == 3 else v
    if kind == "qkv":
        return (v[..., 0] if v.dim() == 3 else v)[_qkv_rows(v.shape[0], heads).to(v.device)]
    if kind == "wn_flip":
        return v.flip(-1)
    return v


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``X.weight_g * X.weight_v / ||X.weight_v||`` (norm over all dims
    but 0) -> ``X.weight``."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_v") and k[:-9] + ".weight_g" in sd:
            g = sd[k[:-9] + ".weight_g"]
            norm = torch.sqrt(torch.sum(v.float() ** 2, dim=tuple(range(1, v.dim())),
                                        keepdim=True)) + 1e-12
            out[k[:-9] + ".weight"] = g.float() * v.float() / norm
        elif not (k.endswith(".weight_g") and k[:-9] + ".weight_v" in sd):
            out[k] = v
    return out


def load_upstream(modules: Dict[str, torch.nn.Module], sds: Dict[str, Dict[str, torch.Tensor]],
                  cfgs: Tuple[VAEConfig, LDMUNetConfig, VocoderConfig]) -> None:
    """Fill ``modules`` (``vae``, ``student_ldm``, ``sr_vocoder``) from the
    three upstream state dicts; keys outside the map (``loss.logvar``) are
    ignored, and a reference parameter left unfilled raises."""
    maps = upstream_maps(*cfgs)
    heads = cfgs[1].num_heads
    for name, module in modules.items():
        target = module.state_dict()
        got = {}
        for ukey, v in fold_weight_norm(sds[name]).items():
            if ukey not in maps[name]:
                continue
            rkey, kind = maps[name][ukey]
            t = _to_reference(torch.as_tensor(v).float(), kind, heads)
            if tuple(t.shape) != tuple(target[rkey].shape):
                raise ValueError(f"{name}: {ukey} {tuple(t.shape)} does not fit {rkey} "
                                 f"{tuple(target[rkey].shape)}")
            got[rkey] = t
        missing = sorted(set(target) - set(got))
        if missing:
            raise KeyError(f"{name}: no upstream tensor for {missing[:8]}")
        module.load_state_dict(got, strict=True)


def upstream_layout(modules: Dict[str, torch.nn.Module],
                    cfgs: Tuple[VAEConfig, LDMUNetConfig, VocoderConfig]
                    ) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], str, int]]]:
    """``{checkpoint: {upstream key: (shape, role, fan_in)}}`` with role
    one of ``weight``, ``bias``, ``norm_weight``, ``norm_bias``,
    ``weight_v``, ``weight_g`` (the vocoder's weight-norm pairs), in a
    fixed order; ``fan_in`` is that of the weight a key belongs to (0 for
    biases and norms)."""
    maps = upstream_maps(*cfgs)
    out = {}
    for name, module in modules.items():
        shapes = {k: tuple(t.shape) for k, t in module.state_dict().items()}
        norms = {n for n, mod in module.named_modules()
                 if type(mod).__name__ in ("GroupNorm", "LayerNorm")}
        layout = {}
        for ukey, (rkey, kind) in maps[name].items():
            shape = shapes[rkey]
            owner, leaf = rkey.rsplit(".", 1)
            # a weight's fan-in: [out, in, *k], or [in, out, k] transposed
            fan_in = (shape[0] * shape[-1] if kind == "wn_flip"
                      else int(np.prod(shape[1:], dtype=np.int64)))
            if ukey.split(".")[-2] in ("qkv", "proj_out") and name == "student_ldm" \
                    and leaf == "weight":
                shape = shape + (1,)          # CompVis 1D convs of width 1
            if owner in norms:
                layout[ukey] = (shape, "norm_" + leaf, 0)
            elif kind.startswith("wn") and leaf == "weight":
                layout[ukey[:-6] + "weight_v"] = (shape, "weight_v", fan_in)
                layout[ukey[:-6] + "weight_g"] = ((shape[0],) + (1,) * (len(shape) - 1),
                                                  "weight_g", fan_in)
            else:
                layout[ukey] = (shape, leaf, fan_in if leaf == "weight" else 0)
        out[name] = layout
    return out


# ---- .npz trios ------------------------------------------------------------

def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_from_json(text: str):
    """The ``__config__`` entry -> ``(VAEConfig, unet config, VocoderConfig,
    pipeline options)``."""
    d = json.loads(text)

    def dec(cls, dd):
        return cls(**{k: _tuples(v) for k, v in dd.items()})

    unet_cls = LDMUNetConfig if d.get("unet_kind") == "ldm" else UNetConfig
    opts = {"crossover_hz": float(d["crossover_hz"]), "noise_seed": int(d["noise_seed"]),
            "envelope_match": d.get("envelope_match", False),
            "adaptive_crossover": bool(d.get("adaptive_crossover", True))}
    return dec(VAEConfig, d["vae"]), dec(unet_cls, d["unet"]), dec(VocoderConfig, d["vocoder"]), opts


def read_npz(path) -> Tuple[str, Dict[str, np.ndarray]]:
    """``(config JSON, {flat flax key: float32 array})`` of a trio file."""
    with np.load(path) as z:
        cfg = bytes(z["__config__"].tobytes()).decode()
        return cfg, {k: z[k].astype(np.float32) for k in z.files if k != "__config__"}


def load_npz(modules: Dict[str, torch.nn.Module], flat: Dict[str, np.ndarray]) -> None:
    """Fill ``modules`` from flat flax keys ``<sub-model>/params/<path>``."""
    for name, module in modules.items():
        target = module.state_dict()
        owners = dict(module.named_modules())
        got = {}
        prefix = f"{name}/params/"
        for key, arr in flat.items():
            if not key.startswith(prefix):
                continue
            *mods, leaf = key[len(prefix):].split("/")
            rkey = ".".join(mods + ["weight" if leaf in ("kernel", "scale") else leaf])
            t = torch.from_numpy(arr)
            if leaf == "kernel":
                kind = type(owners[".".join(mods)]).__name__
                if kind == "ConvTranspose1d":
                    t = t.permute(1, 2, 0).flip(2)
                elif kind != "DenseGeneral":
                    t = t.permute(*range(t.dim() - 1, t.dim() - 3, -1), *range(t.dim() - 2))
            if rkey not in target or tuple(t.shape) != tuple(target[rkey].shape):
                raise ValueError(f"{name}: {key} {tuple(t.shape)} has no place in the reference")
            got[rkey] = t.contiguous()
        missing = sorted(set(target) - set(got))
        if missing:
            raise KeyError(f"{name}: the file lacks {missing[:8]}")
        module.load_state_dict(got, strict=True)

