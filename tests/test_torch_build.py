"""The build helper's cache key (``utils.cuda_build.library_path``).

A library is rebuilt exactly when its key changes, so the key must follow
every byte the compiler reads: the source, the headers a quoted
``#include`` finds beside it in ``csrc/`` (``attn_core.cuh``, shared by
both attention kernels) and the flags.  These run on a copy of ``csrc``;
no ``nvcc`` is needed.
"""
import shutil

import pytest

from egregora_tpu_torch.utils import cuda_build

SOURCES = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))


@pytest.fixture()
def csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, d)
    return d


def test_every_source_is_listed():
    assert {"attn_rows", "attn_online", "mrf", "iir_lowpass", "conv_edge",
            "snake"} <= set(SOURCES)
    assert (cuda_build.CSRC / "attn_core.cuh").is_file()


@pytest.mark.parametrize("name", SOURCES)
def test_a_copy_of_the_sources_gives_the_same_key(csrc, name):
    assert cuda_build.library_path(name, csrc) == cuda_build.library_path(name)
    assert cuda_build.library_path(name, csrc).parent == cuda_build.BUILD_DIR


@pytest.mark.parametrize("name", SOURCES)
def test_the_key_follows_every_header(csrc, name):
    """An edited ``attn_core.cuh`` (or any ``csrc/*.cuh``) gives a new
    library path, so a stale library is never loaded."""
    before = cuda_build.library_path(name, csrc)
    header = csrc / "attn_core.cuh"
    header.write_bytes(header.read_bytes() + b"\n// one more line\n")
    edited = cuda_build.library_path(name, csrc)
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path(name, csrc) not in (before, edited)


@pytest.mark.parametrize("name", SOURCES)
def test_the_key_follows_its_source_and_no_other(csrc, name):
    before = cuda_build.library_path(name, csrc)
    other = next(s for s in SOURCES if s != name)
    (csrc / f"{other}.cu").write_text("// another kernel's edit\n")
    assert cuda_build.library_path(name, csrc) == before
    src = csrc / f"{name}.cu"
    src.write_bytes(src.read_bytes().replace(b"\n", b"\n\n", 1))
    assert cuda_build.library_path(name, csrc) != before


def test_the_key_follows_the_flags(csrc, monkeypatch):
    before = cuda_build.library_path("attn_rows", csrc)
    monkeypatch.setattr(cuda_build, "FLAGS", cuda_build.FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("attn_rows", csrc) != before


def test_build_log_is_empty_before_a_build(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    assert cuda_build.build_log("attn_rows") == ""
    log = cuda_build.library_path("attn_rows").with_suffix(".log")
    log.parent.mkdir()
    log.write_text("ptxas info    : Used 168 registers\n")
    assert "168 registers" in cuda_build.build_log("attn_rows")
