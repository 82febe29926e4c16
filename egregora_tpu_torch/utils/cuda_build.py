"""Build the port's CUDA sources with ``nvcc`` and bind them with ctypes.

``csrc/<name>.cu`` compiles at first use into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the flags, the source and every header
in ``csrc/`` (``*.cuh``, which a quoted ``#include`` finds beside the
source), so an edited source or header rebuilds and an unchanged one
loads at once.  The compiler writes a temporary name that ``os.replace``
moves into place: there is no lock file, and a build that is cut off
leaves no half-written library.  ``ptxas -v``'s report (registers, shared
memory and spills of each kernel) is kept beside the library as
``_build/<name>-<hash>.log``.

``SOURCES`` lists every source; ``build_all`` builds them at once, one
``nvcc`` each (what the bootstrap and ``chip_smoke.py`` run).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every csrc/<name>.cu, each one library
SOURCES = ("attn_rows", "mrf", "iir_lowpass", "attn_online", "conv_edge", "snake")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``NVCC_DEFAULT``; raises where none exists."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 NVCC_DEFAULT):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """``_build/<name>-<hash>.so`` for the current flags, source and
    headers of ``csrc``."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [csrc / f"{name}.cu"] + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's report of the current build of ``name`` (``ptxas -v``
    lines), or "" before it is built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(name: str, timeout: float = 600.0) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise RuntimeError(f"no CUDA source {name!r}: {src} does not exist")
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
    try:
        r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA build of {name} timed out after {timeout:.0f} s")
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA build of {name} failed: nvcc exit {r.returncode}\n"
                           f"{r.stdout}")
    path.with_suffix(".log").write_text(r.stdout)
    os.replace(tmp, path)
    return path


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Build every source in ``sources`` (default ``SOURCES``) at once, one
    ``nvcc`` each; seconds a source (near 0 where it was built already).
    Raises one ``RuntimeError`` naming every source that failed, after
    all have ended."""
    sources = SOURCES if sources is None else sources

    def timed(name: str) -> float:
        t = time.perf_counter()
        build(name)
        return time.perf_counter() - t

    with ThreadPoolExecutor(max(1, len(sources))) as ex:
        futures = {name: ex.submit(timed, name) for name in sources}
    seconds, failed = {}, []
    for name, fut in futures.items():
        try:
            seconds[name] = fut.result()
        except RuntimeError as e:
            failed.append(f"{name}: {e}")
    if failed:
        raise RuntimeError("CUDA build failed for " + "; ".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def on_device(device):
    """The context of a CUDA ``device`` where it is not the current device
    already (a library launches on the current one); a no-op otherwise."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
