"""The port's ComfyUI nodes, registered under the JAX package's keys.

``NODE_CLASS_MAPPINGS`` / ``NODE_DISPLAY_NAME_MAPPINGS`` here are the
package's merged registry (``egregora_tpu_torch``), read when asked for,
so that importing one node module never imports the others.
"""


def __getattr__(name):
    if name in ("NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"):
        import egregora_tpu_torch
        return getattr(egregora_tpu_torch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
