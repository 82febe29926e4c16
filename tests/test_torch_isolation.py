"""The PyTorch port stands alone: no module of ``egregora_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, flax or the JAX package (the
machine with the card has none of them), and ``chip_smoke.py`` refuses
to run without a CUDA card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORTS = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "egregora_tpu"):
            raise ImportError("blocked: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "egregora_tpu"):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import egregora_tpu_torch
names = [m.name for m in pkgutil.walk_packages(egregora_tpu_torch.__path__, "egregora_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", " ".join(names))
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split("imported", 1)[1].split())
    assert len(names) >= 37          # every module of the package was imported
    assert {"egregora_tpu_torch.ops.mrf_fused", "egregora_tpu_torch.ops.mrf_rows",
            "egregora_tpu_torch.models.flashsr.unet", "egregora_tpu_torch.models.flashsr.distill",
            "egregora_tpu_torch.nodes.base", "egregora_tpu_torch.nodes.super_resolution",
            "egregora_tpu_torch.ops.iir", "egregora_tpu_torch.ops.iir_lowpass",
            "egregora_tpu_torch.eval.metrics", "egregora_tpu_torch.eval.loudness",
            "egregora_tpu_torch.eval.align", "egregora_tpu_torch.eval.nulltest",
            "egregora_tpu_torch.eval.batch", "egregora_tpu_torch.utils.viz",
            "egregora_tpu_torch.nodes.eval_pack", "egregora_tpu_torch.nodes.null_suite"} <= names
    assert "unavailable" not in r.stdout      # the registry merged every node module


def test_chip_smoke_fails_without_card(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:      # a directory with chip_smoke.py and nothing else
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        env = _env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr
        assert '"ok": true' not in r.stdout
