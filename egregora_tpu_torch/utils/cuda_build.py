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
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
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
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
