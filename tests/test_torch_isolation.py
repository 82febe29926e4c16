"""The PyTorch port stands alone: no module of ``egregora_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, flax, optax or the JAX package (the
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
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "egregora_tpu"):
            raise ImportError("blocked: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "egregora_tpu"):
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


_CONVERTED_WITHOUT_JAX = r'''
import sys, tempfile
from pathlib import Path
from egregora_tpu_torch.models.flashsr import distill, pipeline as P
from egregora_tpu_torch.models.flashsr.vocoder import VocoderConfig
import chip_smoke
cfg = P.FlashSRConfig(
    vae=P.VAEConfig(base_channels=8, channel_mults=(1, 2), latent_channels=4, num_res_blocks=1,
                    groups=8),
    unet=P.LDMUNetConfig(in_channels=8, out_channels=4, model_channels=8, channel_mult=(1, 2),
                         num_res_blocks=1, attention_resolutions=(2,), num_heads=8, groups=8),
    vocoder=VocoderConfig(upsample_initial=16, upsample_factors=(4, 4), upsample_kernels=(8, 8),
                          channel_floor=8))
d = Path(tempfile.mkdtemp())
chip_smoke.write_reference_trio(cfg, d, seed=1)
got, sd = distill.load_converted_flashsr(d)          # from the .pth trio
again, sd2 = distill.load_converted_flashsr(d)       # from the cache
assert got == cfg == again, (got, cfg)
assert all(set(sd[m]) == set(sd2[m]) for m in sd)
print("converted without jax")
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
    assert len(names) >= 60          # every module of the package was imported
    assert {"egregora_tpu_torch.ops.mrf_fused", "egregora_tpu_torch.ops.mrf_rows",
            "egregora_tpu_torch.models.flashsr.unet", "egregora_tpu_torch.models.flashsr.distill",
            "egregora_tpu_torch.nodes.base", "egregora_tpu_torch.nodes.super_resolution",
            "egregora_tpu_torch.ops.iir", "egregora_tpu_torch.ops.iir_lowpass",
            "egregora_tpu_torch.eval.metrics", "egregora_tpu_torch.eval.loudness",
            "egregora_tpu_torch.eval.align", "egregora_tpu_torch.eval.nulltest",
            "egregora_tpu_torch.eval.batch", "egregora_tpu_torch.utils.viz",
            "egregora_tpu_torch.nodes.eval_pack", "egregora_tpu_torch.nodes.null_suite",
            "egregora_tpu_torch.ops.attn_flash", "egregora_tpu_torch.ops.conv_edge",
            "egregora_tpu_torch.models.flashsr.geometry", "egregora_tpu_torch.utils.weights",
            "egregora_tpu_torch.tools.attn_flash_lab",
            "egregora_tpu_torch.tools.edge_conv_lab",
            "egregora_tpu_torch.ops.fft", "egregora_tpu_torch.ops.spectral",
            "egregora_tpu_torch.ops.mix", "egregora_tpu_torch.models.wpe",
            "egregora_tpu_torch.models.rnnoise.model", "egregora_tpu_torch.models.rnnoise.train",
            "egregora_tpu_torch.utils.native", "egregora_tpu_torch.utils.wavio",
            "egregora_tpu_torch.nodes.spectral_enhance",
            "egregora_tpu_torch.nodes.enhance_extras",
            "egregora_tpu_torch.models.deepfilternet.model",
            "egregora_tpu_torch.models.deepfilternet.train",
            "egregora_tpu_torch.models.dac.model", "egregora_tpu_torch.models.dac.train",
            "egregora_tpu_torch.models.flashsr.train", "egregora_tpu_torch.models.flashsr.prng",
            "egregora_tpu_torch.parallel.mesh", "egregora_tpu_torch.parallel.multihost",
            "egregora_tpu_torch.models.optim", "egregora_tpu_torch.install",
            "egregora_tpu_torch.examples.full_chain"} <= names
    assert "unavailable" not in r.stdout      # the registry merged every node module


def test_converted_path_runs_without_jax():
    """A reference trio written and converted (then read from the cache)
    with JAX, flax and the JAX package blocked from import."""
    code = _BLOCKED_IMPORTS.split("import egregora_tpu_torch\n")[0] + _CONVERTED_WITHOUT_JAX
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "converted without jax" in r.stdout


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


NEW_KEYS = ("EgregoraFatLlamaGPU", "EgregoraFatLlamaCPU", "Egregora_RNNoise_Denoise",
            "Egregora_WPE_Dereverb", "Egregora_DeepFilterNet_Denoise", "Egregora_DAC_Encode",
            "Egregora_DAC_Decode")


def test_registry_holds_the_enhance_nodes():
    """The seven enhance keys are in the port's registry with the JAX
    package's widgets, display names, return types and functions; the
    registry holds all 19 of the JAX package's keys."""
    import egregora_tpu
    import egregora_tpu_torch
    for key in NEW_KEYS:
        tn, jn = egregora_tpu_torch.NODE_CLASS_MAPPINGS[key], egregora_tpu.NODE_CLASS_MAPPINGS[key]
        assert tn.INPUT_TYPES() == jn.INPUT_TYPES()
        assert (egregora_tpu_torch.NODE_DISPLAY_NAME_MAPPINGS[key]
                == egregora_tpu.NODE_DISPLAY_NAME_MAPPINGS[key])
        for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
            assert getattr(tn, attr) == getattr(jn, attr)
        assert getattr(tn, "RETURN_NAMES", None) == getattr(jn, "RETURN_NAMES", None)
    assert len(egregora_tpu_torch.NODE_CLASS_MAPPINGS) == 19
    assert set(egregora_tpu_torch.NODE_CLASS_MAPPINGS) == set(egregora_tpu.NODE_CLASS_MAPPINGS)
