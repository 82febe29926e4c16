"""Workflow graph executor: the ComfyUI executor's role, standalone.

Counterpart of ``egregora_tpu/pipeline/executor.py``: it loads the JSON
graph shape of ``examples/audio_super_resolution_workflow.json``, resolves
``[node_id, output_index]`` references, executes in dependency order with
memoization, and records each node's wall time (``utils.profiling``).
The built-in IO nodes (``LoadAudio``, ``SaveAudio``, ``PreviewAudio``)
take the host-edge roles ComfyUI plays for the reference.

Nodes run on ``device``, the card unless the caller asks for the CPU
(``nodes.base.node_device`` sets every node's ``DEVICE`` for the run and
restores it after); asked for the card where there is none, ``run``
raises with ``utils.device.ensure_accelerator``'s message.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

from ..nodes.base import comfy_audio, node_device
from ..utils.device import ensure_accelerator
from ..utils.profiling import GLOBAL_TIMER, NodeTimer


class LoadAudio:
    CATEGORY = "Egregora/IO"
    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"path": ("STRING", {"default": ""})}}

    def execute(self, path: str):
        from ..utils.wavio import read_audio
        cs, sr = read_audio(path)
        return (comfy_audio(sr, cs),)


class SaveAudio:
    CATEGORY = "Egregora/IO"
    RETURN_TYPES = ("STRING",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",),
                             "path": ("STRING", {"default": "out.wav"})}}

    def execute(self, audio, path: str):
        from ..core.audio import from_any
        from ..utils.wavio import write_audio
        buf = from_any(audio)
        write_audio(path, buf.numpy(), buf.sample_rate)
        return (path,)


class PreviewAudio:
    CATEGORY = "Egregora/IO"
    RETURN_TYPES = ("DICT",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",)}}

    def execute(self, audio):
        from ..core.audio import from_any
        buf = from_any(audio)
        return ({"sample_rate": buf.sample_rate, "channels": buf.channels,
                 "duration_s": buf.duration_s},)


BUILTIN_NODES = {
    "LoadAudio": LoadAudio,
    "SaveAudio": SaveAudio,
    "PreviewAudio": PreviewAudio,
}


class WorkflowExecutor:
    """Execute a node-graph dict or JSON file through the registry."""

    def __init__(self, extra_nodes: Optional[Dict[str, type]] = None,
                 timer: Optional[NodeTimer] = None, device: str = "cuda"):
        import egregora_tpu_torch
        self.registry: Dict[str, type] = dict(BUILTIN_NODES)
        self.registry.update(egregora_tpu_torch.NODE_CLASS_MAPPINGS)
        if extra_nodes:
            self.registry.update(extra_nodes)
        self.timer = timer or GLOBAL_TIMER
        self.device = device

    @staticmethod
    def _is_ref(v: Any) -> bool:
        return (isinstance(v, (list, tuple)) and len(v) == 2
                and isinstance(v[0], (str, int))
                and isinstance(v[1], int) and not isinstance(v[0], bool))

    def run(self, workflow: Union[str, Path, Dict[str, Any]],
            overrides: Optional[Dict[str, Dict[str, Any]]] = None
            ) -> Dict[str, Tuple]:
        """Execute; returns ``{node_id: output_tuple}``.  ``overrides``
        patches node inputs by id, e.g. ``{"1": {"path": "other.wav"}}``."""
        device = ensure_accelerator(self.device)
        if not isinstance(workflow, dict):
            workflow = json.loads(Path(workflow).read_text())
        nodes = {str(n["id"]): n for n in workflow["nodes"]}
        if overrides:
            for nid, patch in overrides.items():
                nodes[str(nid)]["inputs"] = {**nodes[str(nid)].get("inputs", {}), **patch}
        results: Dict[str, Tuple] = {}
        visiting: set = set()

        def execute(nid: str) -> Tuple:
            if nid in results:
                return results[nid]
            if nid in visiting:
                raise ValueError(f"workflow cycle through node {nid}")
            visiting.add(nid)
            spec = nodes[nid]
            ntype = spec["type"]
            if ntype not in self.registry:
                raise KeyError(f"unknown node type {ntype!r} (node {nid}); "
                               f"known: {sorted(self.registry)[:8]}...")
            cls = self.registry[ntype]
            kwargs = {}
            for name, val in spec.get("inputs", {}).items():
                if self._is_ref(val) and str(val[0]) in nodes:
                    kwargs[name] = execute(str(val[0]))[val[1]]
                else:
                    kwargs[name] = val
            node = cls()
            fn = getattr(node, getattr(cls, "FUNCTION", "execute"))
            with self.timer.measure(ntype):
                out = fn(**kwargs)
            if not isinstance(out, tuple):
                out = (out,)
            results[nid] = out
            visiting.discard(nid)
            return out

        with node_device(device):
            for nid in nodes:
                execute(nid)
        return results

    def timing_summary(self) -> Dict[str, Dict[str, float]]:
        return self.timer.summary()
