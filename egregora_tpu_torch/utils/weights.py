"""Weight conversion: the JAX package's flax trees and torch checkpoints.

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

Reference checkpoints (the ``.pth`` files of upstream FlashSR) go the
JAX package's way: ``load_torch_state_dict`` reads one,
``convert_state_dict`` maps it, by a name map, onto the flax tree the
JAX package would build (``flax_tree`` derives that tree's keys and
shapes from the port's own modules, inverting the mapping above), and
``params_from_jax`` carries the result onto the port.  ``save_params``
and ``load_params`` keep converted trees in the JAX package's flat npz
format, so a cache either package writes, the other reads; converted
files live under ``weights_dir()``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.flashsr.layers import ConvTranspose1d, DenseGeneral, GroupNorm, LayerNorm
from ..models.flashsr.pipeline import FlashSRConfig, FlashSRModules


def weights_dir() -> Path:
    """The converted-checkpoint root both packages read and write:
    ``EGREGORA_TPU_WEIGHTS``, else ``~/.cache/egregora_tpu/weights``;
    made if missing."""
    env = os.environ.get("EGREGORA_TPU_WEIGHTS")
    d = Path(env) if env else Path.home() / ".cache" / "egregora_tpu" / "weights"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if hasattr(tree, "items"):          # dict / FrozenDict; arrays have none
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


_PERMS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}   # flax kernel -> torch weight


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
    return key, _PERMS.get(ndim), None


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


# ---- reference checkpoints ------------------------------------------------

def flax_tree(module: torch.nn.Module, values: bool = False,
              tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``{"params": ...}``: the flax variable tree of ``module``'s JAX
    counterpart, the inverse of ``module_from_jax``'s mapping (norm
    weights are ``scale``, other weights ``kernel`` in flax's layout).
    Leaves are ``meta`` tensors of the flax shapes or, with ``values``,
    numpy arrays of the module's parameters, or of ``tensors`` (tensors
    of the parameters' shapes keyed like the state dict, e.g. an
    optimizer's moments) in their place."""
    tree: Dict[str, Any] = {}
    for key, t in module.state_dict(keep_vars=True).items():
        if tensors is not None:
            t = tensors[key]
        *mods, leaf = key.split(".")
        owner = module.get_submodule(".".join(mods))
        perm, flip = None, None
        if leaf == "weight" and isinstance(owner, (GroupNorm, LayerNorm)):
            leaf = "scale"
        elif leaf == "weight":
            leaf = "kernel"
            if isinstance(owner, ConvTranspose1d):
                perm, flip = (1, 2, 0), 2
            elif not isinstance(owner, DenseGeneral):
                perm = _PERMS.get(t.dim())
        inv = None if perm is None else tuple(int(i) for i in np.argsort(perm))
        if values:
            v = t.detach().float().cpu()
            if flip is not None:
                v = v.flip(flip)
            val = (v if inv is None else v.permute(inv)).contiguous().numpy()
        else:
            shape = tuple(t.shape)
            val = torch.empty(shape if inv is None else tuple(shape[i] for i in inv),
                              device="meta")
        node = tree
        for p in mods:
            node = node.setdefault(p, {})
        node[leaf] = val
    return {"params": tree}


def load_torch_state_dict(path: Path, weights_only: bool = False) -> Dict[str, np.ndarray]:
    """A ``.pth`` file as numpy arrays, unwrapped from a module or a
    ``{"state_dict": ...}`` dict as the JAX package unwraps it; entries
    that are not tensors dropped.  Like the JAX package's, it unpickles
    the whole file by default: load only checkpoints you trust.  With
    ``weights_only`` (a downloaded file) it reads tensors and plain
    containers only, and raises on anything else."""
    obj = torch.load(str(path), map_location="cpu", weights_only=weights_only)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    else:
        flat[prefix.rstrip("/")] = tree
    return flat


def sorted_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                  ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` in ``jax.tree_util``'s order for nested dicts:
    keys sorted at every level."""
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def fast_init_like(shape_tree: Any, seed: int = 0) -> Dict[str, Any]:
    """The JAX package's ``utils.weights.fast_init_like``, draw for draw:
    one ``np.random.default_rng(seed)`` walks the leaves in JAX's sorted
    flatten order; a leaf named ``*bias`` is zero, ``*scale`` or
    ``alpha`` one, anything else ``standard_normal(shape, float32) /
    sqrt(prod(shape[:-1]))`` (lecun-normal).  Leaves need only a
    ``shape`` (``flax_tree``'s meta tensors); returns numpy float32."""
    rng = np.random.default_rng(seed)
    flat: Dict[str, np.ndarray] = {}
    for path, spec in sorted_leaves(shape_tree):
        name, shape = path[-1], tuple(spec.shape)
        if name.endswith("bias"):
            val = np.zeros(shape, np.float32)
        elif name in ("scale", "alpha") or name.endswith("scale"):
            val = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])
            std = 1.0 / np.sqrt(max(fan_in, 1))
            val = (rng.standard_normal(shape, dtype=np.float32) * std).astype(np.float32)
        flat["/".join(path)] = val
    return unflatten(flat)


def save_params(params: Any, path: Path) -> None:
    """A nested tree of arrays as a flat npz with ``/``-joined keys (the
    JAX package's ``utils.weights.save_params`` format)."""
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(params).items()})


def load_params(path: Path) -> Dict[str, Any]:
    """What ``save_params`` (of either package) wrote, as a nested tree of
    numpy arrays."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def fold_weight_norm(torch_sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Merge torch ``weight_norm`` pairs: ``X.weight_g * X.weight_v /
    ||X.weight_v||`` -> ``X.weight`` (norm over all dims but 0, torch's
    default ``dim=0``).  HiFi-GAN checkpoints ship weight-normalised."""
    out = {}
    for k, v in torch_sd.items():
        if k.endswith(".weight_v"):
            base = k[: -len(".weight_v")]
            g = torch_sd.get(base + ".weight_g")
            if g is None:
                out[k] = v
                continue
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True)) + 1e-12
            out[base + ".weight"] = np.asarray(g) * v / norm
        elif k.endswith(".weight_g") and k[: -len(".weight_g")] + ".weight_v" in torch_sd:
            continue
        else:
            out[k] = v
    return out


def convert_state_dict(torch_sd: Dict[str, np.ndarray], target_tree: Any,
                       name_map: Optional[Callable[[str], Any]] = None) -> Dict[str, Any]:
    """Map a torch state dict onto a flax tree (leaves: anything with a
    ``shape``, e.g. ``flax_tree``'s); returns the tree with numpy leaves.

    ``name_map`` maps a torch key to the ``/``-joined flax path, or to a
    ``(path, perm)`` pair where ``perm`` is a transpose or a callable
    transform (applied even when shapes agree); None drops the key.
    Without a map, keys match by normalised name (dots -> slashes,
    ``weight`` -> ``kernel``).  torch Linear ``[out, in]`` and conv
    ``[out, in, *k]`` weights are transposed to flax's ``[in, out]`` /
    ``[*k, in, out]`` when the shapes say so, ConvTranspose's
    ``[in, out, *k]`` as a fallback.  ``weight_norm`` pairs fold first.
    Raises ``ValueError`` listing every target leaf left unfilled.
    """
    torch_sd = fold_weight_norm(torch_sd)
    flat_target = _flatten(target_tree)
    remaining = dict(flat_target)
    out: Dict[str, np.ndarray] = {}

    def norm(k: str) -> str:
        return k.replace(".", "/").replace("/weight", "/kernel")

    for tk, tv in torch_sd.items():
        fk = name_map(tk) if name_map else None
        if name_map and fk is None:
            continue
        perm_override = None
        if isinstance(fk, tuple):
            fk, perm_override = fk
        if fk is None:
            cand = norm(tk)
            fk = next((k for k in remaining if k.endswith(cand)), None)
        if fk is None or fk not in remaining:
            continue
        want = tuple(remaining[fk].shape)
        v = tv
        if callable(perm_override):
            v = np.asarray(perm_override(v))
        if v.shape != want:
            if perm_override is not None and not callable(perm_override):
                v = np.transpose(v, perm_override)
            elif v.ndim == 2 and v.T.shape == want:
                v = v.T
            elif v.ndim >= 3:
                for perm in (tuple(range(2, v.ndim)) + (1, 0),    # Conv
                             tuple(range(2, v.ndim)) + (0, 1)):   # ConvTranspose
                    if np.transpose(v, perm).shape == want:
                        v = np.transpose(v, perm)
                        break
        if v.shape == want:
            out[fk] = v
            del remaining[fk]

    if remaining:
        need = [f"  need {k}: {tuple(v.shape)}" for k, v in sorted(remaining.items())[:15]]
        offered = [f"  have {k}: {tuple(np.asarray(v).shape)}"
                   for k, v in sorted(torch_sd.items())][:15]
        raise ValueError(
            f"convert_state_dict: {len(remaining)}/{len(flat_target)} target leaves "
            "unmatched.\nUnfilled model leaves:\n" + "\n".join(need)
            + "\nCheckpoint tensors:\n" + "\n".join(offered)
            + "\nLikely a geometry mismatch: check the inferred config "
            "(models/flashsr/geometry.py) or give an explicit name_map.")
    return unflatten(out)
