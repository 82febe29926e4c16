"""On the card only (``-m cuda``): one short run of each cell through the
benchmark's command, from the checkout's root."""
import json
import subprocess
import sys

import pytest

from perfbench.harness import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures nothing on the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_short_run(card, cell):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 32 + 77), "--seconds", "3", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


def test_no_result_without_a_card(card_absent):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          spec.benchmark()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
