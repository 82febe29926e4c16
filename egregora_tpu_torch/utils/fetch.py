"""The weight download layer, stdlib only.

Counterpart of ``egregora_tpu/utils/fetch.py``; the reference node
downloads FlashSR's three checkpoints from a Hugging Face dataset at
first use, honouring ``EGREGORA_FLASHSR_HF_REPO``, and marks a finished
fetch with a marker file.  The port streams plain HTTPS (the JAX
package's hf_hub branch, which its own first-use path skips, is not
ported).

* ``download``: streaming HTTP with Range resume, optional sha256
  check, atomic ``.part`` -> final rename.
* ``fetch_flashsr_weights``: the three checkpoints into a directory;
  returns what is still missing, and lists what it downloaded in
  ``FETCHED`` so that the loader opens those files as tensors only.
* ``auto_fetch_flashsr``: the resolver's first-use attempt
  (``models.flashsr.distill.load_converted_flashsr``): at most once per
  directory per process, a 5 s timeout, never when
  ``EGREGORA_TPU_OFFLINE`` is set, and never from a plain-http mirror
  off the loopback host.

A network failure never raises out of the resolver's path: the caller
gets the files still missing and falls back to the shipped trios.  A
checksum mismatch is a hard error.
"""
from __future__ import annotations

import hashlib
import os
import sys
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Dict, FrozenSet, Optional, Tuple

HF_DATASET = "jakeoneijk/FlashSR_weights"
FLASHSR_FILES = ("student_ldm.pth", "sr_vocoder.pth", "vae.pth")
MARKER = ".egregora_weights_ok"
FETCHED = ".egregora_fetched"       # names this module downloaded, one a line

_CHUNK = 1 << 20


class ChecksumError(ValueError):
    """Downloaded bytes do not match the expected sha256."""


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, dest: Path, *, sha256: Optional[str] = None,
             resume: bool = True, timeout: float = 30.0) -> Path:
    """Stream ``url`` to ``dest`` atomically.

    * A partial transfer lands in ``dest.part``; with ``resume`` an
      interrupted download continues with an HTTP Range request (a server
      that ignores Range answers 200 and the file restarts clean, so bytes
      are never appended twice).
    * ``sha256`` (hex) is checked on the finished file before the rename;
      a mismatch deletes it and raises ``ChecksumError``.
    * An existing ``dest`` that passes the check is returned untouched.
    """
    dest = Path(dest)
    if dest.exists():
        if sha256 is None or _sha256(dest) == sha256.lower():
            return dest
        dest.unlink()
    dest.parent.mkdir(parents=True, exist_ok=True)
    part = dest.with_suffix(dest.suffix + ".part")

    offset = part.stat().st_size if (resume and part.exists()) else 0
    req = urllib.request.Request(url)
    if offset:
        req.add_header("Range", f"bytes={offset}-")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        status = getattr(resp, "status", 200)
        mode = "ab" if (offset and status == 206) else "wb"
        with open(part, mode) as f:
            while chunk := resp.read(_CHUNK):
                f.write(chunk)
    if sha256 is not None and _sha256(part) != sha256.lower():
        part.unlink()
        raise ChecksumError(f"{dest.name}: sha256 mismatch after download from {url}; "
                            "refusing to install corrupt weights")
    part.replace(dest)
    return dest


def flashsr_weight_urls(repo: Optional[str] = None) -> Dict[str, str]:
    """File name -> URL of the three reference checkpoints.
    ``EGREGORA_FLASHSR_HF_REPO`` overrides the dataset repo; a full
    ``http(s)://`` base URL is accepted there too (a mirror)."""
    repo = repo or os.environ.get("EGREGORA_FLASHSR_HF_REPO", HF_DATASET)
    if repo.startswith(("http://", "https://")):
        base = repo.rstrip("/")
        return {f: f"{base}/{f}" for f in FLASHSR_FILES}
    return {f: f"https://huggingface.co/datasets/{repo}/resolve/main/{f}"
            for f in FLASHSR_FILES}


def missing_flashsr_files(ckpt_dir: Path) -> Tuple[str, ...]:
    """The FlashSR checkpoints not in ``ckpt_dir``."""
    return tuple(f for f in FLASHSR_FILES if not (Path(ckpt_dir) / f).exists())


def fetched_files(ckpt_dir: Path) -> FrozenSet[str]:
    """The files of ``ckpt_dir`` that ``fetch_flashsr_weights`` downloaded."""
    p = Path(ckpt_dir) / FETCHED
    return frozenset(p.read_text().split()) if p.exists() else frozenset()


def fetch_flashsr_weights(ckpt_dir: Path, timeout: float = 30.0) -> Tuple[str, ...]:
    """Make sure the three FlashSR checkpoints are in ``ckpt_dir``; returns
    the file names still missing afterwards (empty on success) and never
    raises on a network failure.  The ``MARKER`` file makes repeated calls
    free."""
    d = Path(ckpt_dir)
    marker = d / MARKER
    missing = missing_flashsr_files(d)
    if not missing:
        marker.touch()
        return ()
    if marker.exists():                     # fetched once; the user removed files
        marker.unlink()

    repo = os.environ.get("EGREGORA_FLASHSR_HF_REPO", HF_DATASET)
    urls = flashsr_weight_urls(repo)
    still = []
    for fname in missing:
        try:
            download(urls[fname], d / fname, timeout=timeout)
        except Exception as e:              # offline, 404, DNS: degrade
            print(f"[egregora_tpu_torch] fetch {fname} failed ({type(e).__name__}: {e}); "
                  f"place it in {d} by hand (source: HF dataset {repo})", file=sys.stderr)
            still.append(fname)
            continue
        with open(d / FETCHED, "a") as f:
            f.write(fname + "\n")
    if not still:
        marker.touch()
    return tuple(still)


def _plain_http_off_loopback(url: str) -> bool:
    p = urllib.parse.urlsplit(url)
    return p.scheme == "http" and p.hostname not in ("localhost", "127.0.0.1", "::1")


_AUTO_TRIED: set = set()


def auto_fetch_flashsr(ckpt_dir: Path) -> bool:
    """The resolver's first-use fetch: at most one attempt per directory
    per process, a 5 s timeout, none when ``EGREGORA_TPU_OFFLINE`` is set,
    and none from a plain-http mirror off the loopback host (its bytes
    could be altered on the way).  True iff the trio is complete
    afterwards."""
    d = Path(ckpt_dir)
    if not missing_flashsr_files(d):
        return True
    if os.environ.get("EGREGORA_TPU_OFFLINE") or str(d) in _AUTO_TRIED:
        return False
    _AUTO_TRIED.add(str(d))
    if any(_plain_http_off_loopback(u) for u in flashsr_weight_urls().values()):
        print("[egregora_tpu_torch] EGREGORA_FLASHSR_HF_REPO is a plain-http mirror; "
              "the first-use fetch needs https", file=sys.stderr)
        return False
    return not fetch_flashsr_weights(d, timeout=5.0)
