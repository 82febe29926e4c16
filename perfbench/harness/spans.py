"""Spans the harness puts around the calls into each layer of the port,
from its own files and only in a traced run.

Each span is a ``torch.profiler.record_function`` range named
``pb.<layer>``, installed by wrapping the bound methods of the node, the
pipeline and its sub-models on their instances, and ``mha`` in the
namespaces of the model modules that call it.  ``Spans.uninstall``
restores every attribute.  The attention wrapper also records each
call's shape and dtype, which the roofline's bound is computed from.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Tuple

from torch.profiler import record_function

NAMES = ("pb.node.run", "pb.process", "pb.synthesize", "pb.vae.encode", "pb.vae.decode",
         "pb.unet", "pb.vocoder", "pb.mha")
MHA_USERS = ("egregora_tpu_torch.models.flashsr.vae",
             "egregora_tpu_torch.models.flashsr.ldm_unet",
             "egregora_tpu_torch.models.flashsr.unet")


def _spanned(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


class Spans:
    """The traced run's spans over one node and its cached pipeline."""

    def __init__(self, node, pipe):
        self.node, self.pipe = node, pipe
        self.attn_calls: List[Tuple[int, int, int, int, int]] = []   # (b, h, n, d, itemsize)
        self._saved: List[Tuple[object, str, object, bool]] = []

    def _wrap(self, owner, attr: str, name: str, fn: Callable = None) -> None:
        had = attr in vars(owner)
        self._saved.append((owner, attr, vars(owner).get(attr), had))
        setattr(owner, attr, _spanned(name, fn or getattr(owner, attr)))

    def install(self) -> "Spans":
        import importlib

        mods = self.pipe.modules
        self._wrap(self.node, "run", "pb.node.run")
        self._wrap(self.pipe, "process", "pb.process")
        self._wrap(self.pipe, "synthesize", "pb.synthesize")
        self._wrap(mods.vae, "encode", "pb.vae.encode")
        self._wrap(mods.vae, "decode", "pb.vae.decode")
        self._wrap(mods.unet, "forward", "pb.unet")
        self._wrap(mods.vocoder, "forward", "pb.vocoder")
        calls = self.attn_calls
        for path in MHA_USERS:
            module = importlib.import_module(path)
            mha = module.mha

            def counted(q, k, v, _mha=mha):
                b, h, n, d = q.shape
                calls.append((b, h, n, d, q.element_size()))
                return _mha(q, k, v)

            self._wrap(module, "mha", "pb.mha", counted)
        return self

    def uninstall(self) -> None:
        for owner, attr, old, had in reversed(self._saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._saved.clear()
