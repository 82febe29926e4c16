"""The port's bootstrap (``egregora_tpu_torch.install``) against the
repository's ``install.py``, on the CPU.

* ``_ensure``: the reference's semantics, the same scripted-runner cases
  as ``tests/test_fetch.py``'s;
* ``main(["--device", "cpu", "--offline"])``: exit 0 and every warmup
  "ok";
* ``check_weights(fetch=False)``: the same printed rows as the JAX
  ``install.check_weights(fetch=False)`` under the same
  ``EGREGORA_TPU_WEIGHTS`` (a temporary directory, so only the shipped
  files are found);
* asked for the card where there is none: exit 1 with
  ``ensure_accelerator``'s message, no build and no warmup;
* past the card check with no ``nvcc`` anywhere: the build step fails the
  run and names nvcc.
"""
import importlib.util
import os
from pathlib import Path

import pytest
import torch

from egregora_tpu_torch import install
from egregora_tpu_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parents[1]
WARMUPS = ("loudness", "spectral enhance", "rnnoise", "deepfilternet", "dac")


def _jax_install():
    """The repository's ``install.py``, imported by path."""
    spec = importlib.util.spec_from_file_location("jax_install", ROOT / "install.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def weights(tmp_path, monkeypatch):
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path / "weights"))
    return tmp_path / "weights"


@pytest.mark.parametrize("ensure", [install._ensure, _jax_install()._ensure],
                         ids=["port", "jax"])
def test_ensure_no_deps_chain(ensure):
    """Importable module -> no pip call; missing module with try_no_deps
    -> ``pip install --no-deps`` first, plain install second;
    ``install=False`` never shells out; a runner that raises stops the
    chain."""
    calls = []

    def runner(args):
        calls.append(args)
        return 0

    assert ensure("json", "json", install=True, runner=runner)
    assert calls == []
    assert not ensure("definitely_not_a_module_xyz", "pkg-xyz", install=False, runner=runner)
    assert calls == []
    assert not ensure("definitely_not_a_module_xyz", "pkg-xyz", try_no_deps=True,
                      install=True, runner=runner)
    assert len(calls) == 2
    assert calls[0][-2:] == ["--no-deps", "pkg-xyz"]
    assert calls[1][-1] == "pkg-xyz" and "--no-deps" not in calls[1]
    calls.clear()
    assert not ensure("definitely_not_a_module_xyz", "pkg-xyz", install=True, runner=runner)
    assert len(calls) == 1 and "--no-deps" not in calls[0]

    def offline(args):
        raise OSError("no network")

    assert not ensure("definitely_not_a_module_xyz", "pkg-xyz", try_no_deps=True,
                      install=True, runner=offline)


def test_dependency_lists_name_the_port():
    assert [m for m, _, _ in install.REQUIRED_DEPS] == ["torch", "numpy"]
    assert [m for m, _, _ in install.OPTIONAL_DEPS] == ["soundfile", "matplotlib"]


def test_cpu_bootstrap_warms_every_engine(weights, capsys):
    assert install.main(["--device", "cpu", "--offline"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith("[warmup]")] == \
        [f"[warmup] {w}: ok" for w in WARMUPS]
    assert "[deps] torch: ok" in lines and "[deps] numpy: ok" in lines
    assert any(ln.startswith("[native] wavcodec: ") for ln in lines)
    assert not any(ln.startswith(("[deps] card", "[native] CUDA")) for ln in lines)
    assert lines[-1] == "[install] done"


def test_weight_rows_match_jax(weights, capsys):
    """Row for row, the FlashSR directory path included (both packages
    read ``$EGREGORA_TPU_WEIGHTS/flashsr``)."""
    install.check_weights(fetch=False)
    got = capsys.readouterr().out.splitlines()
    _jax_install().check_weights(fetch=False)
    ref = capsys.readouterr().out.splitlines()
    assert got == ref
    assert len(got) == 10 and not any("MISSING" in ln for ln in got if "shipped" in ln)


def test_trained_file_is_named_in_its_row(weights, capsys):
    """Where a trainer's output exists, the row names the file served."""
    from egregora_tpu_torch.models.rnnoise import train as rn_train
    trained = rn_train.output_path()
    trained.parent.mkdir(parents=True)
    trained.write_bytes(b"")
    install.check_weights(fetch=False)
    rows = [ln for ln in capsys.readouterr().out.splitlines() if "shipped RNNoise" in ln]
    assert rows == [f"[weights] shipped RNNoise: present (serving the trained {trained})"]


def test_cuda_without_a_card_stops_before_the_build(weights, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    warmed = []
    monkeypatch.setattr(install, "warmups", lambda device: warmed.append(device))
    assert install.main(["--offline"]) == 1
    out = capsys.readouterr().out
    assert "[deps] card: MISSING (No CUDA device detected" in out
    assert "--device cpu" in out
    assert "[native]" not in out and "[warmup]" not in out and "[install] done" not in out
    assert warmed == []


def test_missing_nvcc_fails_the_build_step(weights, capsys, monkeypatch):
    """Past the card check (simulated), with no nvcc on ``PATH``, under
    ``CUDA_HOME`` or at the default path: exit 1, the cause named, no
    warmup."""
    monkeypatch.setattr(install, "check_card", lambda: "a card, 700.00 W")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(d, "nvcc"))))
    monkeypatch.setattr(cuda_build, "NVCC_DEFAULT", str(weights / "no" / "nvcc"))
    warmed = []
    monkeypatch.setattr(install, "warmups", lambda device: warmed.append(device))
    assert install.main(["--offline"]) == 1
    captured = capsys.readouterr()
    assert "[install] failed at the build step" in captured.out
    assert "nvcc not found" in captured.out
    assert "[install] done" not in captured.out and warmed == []


def test_build_all_names_a_source_that_does_not_exist():
    with pytest.raises(RuntimeError, match="no CUDA source 'no_such_kernel'"):
        cuda_build.build_all(("no_such_kernel",))


def test_sources_list_every_kernel_source():
    """One list for the bootstrap and ``chip_smoke.py``: every
    ``csrc/*.cu``, none missing."""
    assert sorted(cuda_build.SOURCES) == sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
