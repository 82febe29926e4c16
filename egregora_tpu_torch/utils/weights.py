"""Weight conversion from the JAX package's flax trees to the port.

``params_from_jax(cfg, flax_params)`` turns the JAX pipeline's parameter
trio ``{"vae": {"params": ...}, "student_ldm": ..., "sr_vocoder": ...}``
(numpy leaves, nested dicts as flax keeps them or as ``unflatten`` makes
them from a shipped npz) into the port's state dicts.  The port's
modules name their children as flax names its submodules, so a leaf's
key is its flax path with ``/`` -> ``.`` and ``kernel``/``scale`` ->
``weight``; the values change layout:

* Conv2D kernel ``[kh, kw, Ci, Co]`` -> OIHW; Conv1D ``[k, Ci, Co]`` -> OIW;
* Dense kernel ``[in, out]`` -> ``[out, in]``;
* GroupNorm and LayerNorm ``scale`` -> ``weight``;
* ConvTranspose kernel ``[k, Ci, Co]`` (``transpose_kernel=False``) ->
  ``[Ci, Co, k]`` flipped along k, what ``layers.ConvTranspose1d`` takes;
* DenseGeneral kernels (multi-head attention's ``query/key/value``
  ``[C, H, hd]`` and ``out`` ``[H, hd, C]``) and the ConvNeXt depthwise
  ``dw_kernel [7, D]`` keep their layout.

Every flax leaf is consumed exactly once; a leaf the port has no place
for, a port parameter no leaf fills, or a shape that disagrees raises.
A leaf without values (``jax.ShapeDtypeStruct``, from ``jax.eval_shape``)
becomes a tensor on the ``meta`` device of the converted shape, so the
full-width mapping can be checked without allocating it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.flashsr.layers import ConvTranspose1d, DenseGeneral
from ..models.flashsr.pipeline import FlashSRConfig, FlashSRModules


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if hasattr(tree, "items"):          # dict / FrozenDict; arrays have none
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _convert(module: torch.nn.Module, path: Tuple[str, ...], ndim: int):
    """(torch key, permutation, flip axis or None) of one flax leaf."""
    *mods, leaf = path
    key = ".".join(mods + ["weight" if leaf in ("kernel", "scale") else leaf])
    if leaf != "kernel":
        return key, None, None
    try:
        owner = module.get_submodule(".".join(mods))
    except AttributeError:
        owner = None
    if isinstance(owner, ConvTranspose1d):
        return key, (1, 2, 0), 2         # [k, Ci, Co] -> [Ci, Co, k], flipped
    if isinstance(owner, DenseGeneral):
        return key, None, None
    return key, {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}.get(ndim), None


def module_from_jax(module: torch.nn.Module, flax_vars: Any) -> Dict[str, torch.Tensor]:
    """One flax variable tree (``{"params": ...}``) -> ``module``'s state dict."""
    expected = module.state_dict(keep_vars=True)
    tree = flax_vars["params"] if "params" in flax_vars else flax_vars
    out: Dict[str, torch.Tensor] = {}
    leftovers = []
    for path, leaf in _leaves(tree):
        key, perm, flip = _convert(module, path, len(leaf.shape))
        if key not in expected or key in out:
            leftovers.append("/".join(path))
            continue
        if isinstance(leaf, (np.ndarray, np.generic)) or hasattr(leaf, "__array__"):
            t = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if perm is not None:
                t = t.permute(perm)
            if flip is not None:
                t = t.flip(flip)
            t = t.contiguous()
        else:
            shape = tuple(leaf.shape)
            t = torch.empty([shape[i] for i in perm] if perm else shape, device="meta")
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"params_from_jax: {'/'.join(path)} converts to "
                             f"{tuple(t.shape)}, the port's {key} is "
                             f"{tuple(expected[key].shape)}")
        out[key] = t
    missing = sorted(set(expected) - set(out))
    if leftovers or missing:
        raise KeyError(f"params_from_jax: flax leaves with no place in the port: "
                       f"{leftovers}; port parameters no leaf fills: {missing}")
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/c": v}`` -> ``{"a": {"b": {"c": v}}}`` (the flat ``/``-joined
    keys of the JAX package's npz files)."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def params_from_jax(cfg: FlashSRConfig, flax_params: Dict[str, Any]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX pipeline's parameter trio -> the port's state dicts, keyed
    like the trio (``vae``, ``student_ldm``, ``sr_vocoder``)."""
    with torch.device("meta"):
        mods = FlashSRModules(cfg)
    extra = set(flax_params) - set(FlashSRModules.NAMES)
    if extra:
        raise KeyError(f"params_from_jax: unknown sub-models {sorted(extra)}")
    return {name: module_from_jax(m, flax_params[name])
            for name, m in mods.by_name().items()}
