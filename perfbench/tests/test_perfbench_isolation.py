"""Neither the harness nor the reference loads JAX or the JAX package,
and the reference loads nothing of the port (top-level module names,
compared whole)."""
import json
import subprocess
import sys

from perfbench.harness import spec

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "egregora_tpu"]

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(spec.ROOT), imports=imports)],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_the_port():
    names = loaded("import perfbench.reference.pipeline, perfbench.reference.numerics, "
                   "perfbench.harness.weights, perfbench.harness.flops")
    assert not names & set(FORBIDDEN + ["egregora_tpu_torch"])


def test_a_run_loads_no_jax(tmp_path):
    imports = (f"from pathlib import Path\nfrom perfbench.tests import cpu_cell\n"
               f"root = Path({str(tmp_path)!r})\n"
               f"cpu_cell.small_bench(root, 'flashsr_istft.music', seconds=(2.0, 2.5), pool=1)\n"
               f"line = cpu_cell.run(root, 'flashsr_istft.music')\n"
               f"import perfbench.calibrate, perfbench.harness.trace\n"
               f"from perfbench.harness import spec\n"
               f"spec.system('flashsr_istft').Spans\n")
    names = loaded(imports)
    assert "egregora_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_forbidden_is_compared_whole():
    from perfbench.harness import main
    assert main.FORBIDDEN == tuple(FORBIDDEN)
    sys.modules.setdefault("egregora_tpu_torch_probe", sys)
    assert "egregora_tpu_torch" not in main.forbidden_modules()
    assert not set(main.forbidden_modules()) - set(FORBIDDEN)
