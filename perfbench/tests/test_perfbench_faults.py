"""The output comparison on a whole run with the timed path broken
underneath: each fault a served cell can have comes out as not correct,
and the sound run as correct.  On the CPU, the cells' own limits; the
published geometry at narrowed widths, the istft trio as shipped."""
import pytest

from perfbench.harness import spec
from perfbench.tests import cpu_cell

CELLS = [("flashsr_istft.music", False), ("flashsr_published.voice", True),
         ("flashsr_published.music", True)]
FAULTS = spec.system("flashsr_istft").Upscaler.FAULTS


@pytest.fixture(scope="module", params=CELLS, ids=[c for c, _ in CELLS])
def bench(request, tmp_path_factory):
    cell, narrow = request.param
    root = tmp_path_factory.mktemp(cell)
    cpu_cell.small_bench(root, cell, seconds=(5.5, 6.0), pool=1, narrow=narrow)
    return cell, root


def test_sound_run_is_correct(bench):
    cell, root = bench
    line = cpu_cell.run(root, cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(bench, fault, monkeypatch):
    cell, root = bench
    found = spec.system

    def broken_system(*args, **kwargs):
        system = found(*args, **kwargs)
        build = system.build

        def broken(*args, **kwargs):
            served = build(*args, **kwargs)
            served.plant(fault)
            return served

        monkeypatch.setattr(system, "build", broken)
        return system

    monkeypatch.setattr(spec, "system", broken_system)
    line = cpu_cell.run(root, cell)
    assert not line["correct"], line["checks"]
