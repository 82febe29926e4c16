"""Bootstrap and environment check of the port.

Counterpart of the repository's ``install.py``, with its steps, flags
and printed ``[deps]`` / ``[native]`` / ``[weights]`` / ``[warmup]`` /
``[install]`` lines:

1. the dependency set imports (``--install-deps`` pip-installs what is
   missing, as the reference installer does); then, unless ``--device
   cpu``, the toolchain and the card the kernels need: a CUDA build of
   torch, a card, ``nvcc``, and compute capability 9.0 (the sources build
   for ``sm_90a`` only, so any other card would build them and fail at
   load or launch).  A failed card check stops the run before any build;
2. the host codec (``native/``) and, on the card, every CUDA source
   (``utils.cuda_build.SOURCES``), one ``nvcc`` each at once, into
   ``egregora_tpu_torch/_build/``, so that no node pays for the build at
   its first call; an unchanged tree loads at once (the library names
   carry a hash of flags and sources);
3. the weight store: the FlashSR checkpoints (one fetch attempt unless
   ``--offline`` or ``EGREGORA_TPU_OFFLINE``) and every shipped weight
   file, with the trained file a loader serves in its place where one
   exists;
4. a tiny call of each engine on the chosen device, so that first real
   use is fast.

    python -m egregora_tpu_torch.install [--device {cuda,cpu}] [--skip-warmup]
                                         [--offline] [--install-deps]

Exit code 0 only when the required dependencies, every build and every
warmup succeeded.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time
import traceback

# (module, pip name, try --no-deps first): the reference's _ensure list.
# --no-deps first for a package whose own pins would drag a second torch
# into the environment.
REQUIRED_DEPS = (("torch", "torch", False), ("numpy", "numpy", False))
OPTIONAL_DEPS = (("soundfile", "soundfile", False), ("matplotlib", "matplotlib", False))
CAPABILITY = (9, 0)      # the sources build for arch=compute_90a,code=sm_90a


def _ensure(mod: str, pip_name: str, try_no_deps: bool = False,
            install: bool = False, runner=None) -> bool:
    """Import ``mod``; optionally pip-install ``pip_name`` and retry.
    ``try_no_deps`` attempts ``pip install --no-deps`` first so a
    package's own pins can't replace the environment's torch; a plain
    install follows only if the import still fails.  ``install=False``
    never shells out.  ``runner`` injects the subprocess call (tests).
    Returns importability."""
    import importlib
    import subprocess

    def importable() -> bool:
        try:
            importlib.import_module(mod)
            return True
        except Exception:
            return False

    if importable():
        return True
    if not install:
        return False
    run = runner or (lambda args: subprocess.run(args).returncode)
    base = [sys.executable, "-m", "pip", "install"]
    attempts = ([base + ["--no-deps", pip_name], base + [pip_name]]
                if try_no_deps else [base + [pip_name]])
    for args in attempts:
        try:
            run(args)
        except Exception as e:
            print(f"[deps] pip install {pip_name} failed: {e}")
            return False
        importlib.invalidate_caches()
        if importable():
            return True
    return importable()


def check_deps(install: bool = False) -> bool:
    ok = True
    for mod, pip_name, no_deps in REQUIRED_DEPS:
        if _ensure(mod, pip_name, no_deps, install=install):
            print(f"[deps] {mod}: ok")
        else:
            print(f"[deps] {mod}: MISSING"
                  + ("" if install else " (re-run with --install-deps)"))
            ok = False
    for mod, pip_name, no_deps in OPTIONAL_DEPS:
        if _ensure(mod, pip_name, no_deps, install=install):
            print(f"[deps] {mod}: ok (optional)")
        else:
            print(f"[deps] {mod}: absent (optional; degraded gracefully)")
    return ok


def check_card():
    """The toolchain and card checks, one ``[deps]`` line each: a CUDA
    build of torch, a card (``ensure_accelerator``), ``nvcc``, compute
    capability 9.0.  The card's ``nvidia-smi`` line where all pass, else
    None."""
    import torch

    from .utils import cuda_build
    from .utils.device import card_line, ensure_accelerator
    ok = torch.version.cuda is not None
    print(f"[deps] torch CUDA: {torch.version.cuda} ({torch.__version__})" if ok else
          f"[deps] torch CUDA: MISSING (torch {torch.__version__} is built for the CPU only)")
    try:
        device = ensure_accelerator("cuda")
    except RuntimeError as e:
        print(f"[deps] card: MISSING ({e})")
        device, ok = None, False
    try:
        print(f"[deps] nvcc: {cuda_build.nvcc()}")
    except RuntimeError as e:
        print(f"[deps] nvcc: MISSING ({e})")
        ok = False
    if device is None:
        return None
    card = card_line()
    print(f"[deps] card: {card}")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != CAPABILITY:
        print(f"[deps] compute capability: {tuple(cap)} UNSUPPORTED: the kernels build "
              f"for sm_90a (Hopper, {CAPABILITY}) and cannot load or launch on "
              f"{torch.cuda.get_device_name(device)}")
        return None
    print(f"[deps] compute capability: {tuple(cap)} (sm_90a)")
    return card if ok else None


def _ptxas_summary(log: str) -> str:
    """Kernels and spilled bytes in a ``ptxas -v`` report."""
    kernels = log.count("Compiling entry function")
    spills = [(int(a), int(b)) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return (f"{kernels} kernels, {sum(a for a, _ in spills)} bytes spill stores, "
            f"{sum(b for _, b in spills)} bytes spill loads")


def build_native(device, card=None) -> dict:
    """The host codec; on the card, every CUDA source (seconds a source,
    returned; empty on the CPU).  A source that fails to build raises
    (``cuda_build.build_all``'s ``RuntimeError``)."""
    from .utils.native import load
    lib = load()
    print("[native] wavcodec: " + ("built" if lib is not None else
                                    "unavailable (g++ missing?); stdlib fallback active"))
    if device.type != "cuda":
        return {}
    from .utils import cuda_build
    t0 = time.perf_counter()
    seconds = cuda_build.build_all()
    wall = time.perf_counter() - t0
    print(f"[native] CUDA kernels on {card}: "
          + ", ".join(f"{name} in {s:.1f} s" for name, s in seconds.items())
          + f" (nvcc, sm_90a, in parallel: {wall:.1f} s) into {cuda_build.BUILD_DIR}")
    for name in seconds:
        print(f"[native] ptxas {name}: {_ptxas_summary(cuda_build.build_log(name))}")
    return seconds


def check_weights(fetch: bool = True) -> None:
    from .models.dac import train as dac_train
    from .models.deepfilternet import train as dfn_train
    from .models.flashsr import distill
    from .models.rnnoise import train as rn_train
    from .utils.fetch import (FLASHSR_FILES, HF_DATASET, fetch_flashsr_weights,
                              missing_flashsr_files)
    d = distill.weights_dir()
    d.mkdir(parents=True, exist_ok=True)
    missing = missing_flashsr_files(d)
    if missing and fetch and not os.environ.get("EGREGORA_TPU_OFFLINE"):
        print(f"[weights] FlashSR: fetching {', '.join(missing)} ...")
        missing = fetch_flashsr_weights(d, timeout=30.0)
    if missing:
        print(f"[weights] FlashSR: missing {', '.join(missing)} in {d}")
        print(f"[weights]   place the files from HF dataset {HF_DATASET} there; "
              "the shipped distilled trio serves until then")
    else:
        print(f"[weights] FlashSR: all of {', '.join(FLASHSR_FILES)} present in {d}")

    # each shipped set, and the trained file its loader serves instead
    rows = [("FlashSR distilled trio", distill.PRETRAINED, distill.served_trio(distill.PRETRAINED)),
            ("RNNoise", rn_train.pretrained_path(), rn_train.served_path())]
    rows += [(v, dfn_train.pretrained_path(v), dfn_train.served_path(v))
             for v in ("DeepFilterNet2", "DeepFilterNet3")]
    rows += [(f"DAC {t}", p, dac_train.served_path(t))
             for t, p in sorted(dac_train.PRETRAINED.items())]
    for name, shipped, served in rows:
        print(f"[weights] shipped {name}: {'present' if shipped.exists() else 'MISSING'}"
              + (f" (serving the trained {served})" if served != shipped else ""))
    served = distill.served_trio(distill.PRETRAINED_ISTFT)
    if distill.PRETRAINED_ISTFT.exists():   # optional variant, not a MISSING-able set
        print("[weights] shipped FlashSR istft trio: present "
              "(serve with EGREGORA_FLASHSR_VARIANT=istft)"
              + (f" (serving the trained {served})" if served != distill.PRETRAINED_ISTFT
                 else ""))


def _done(device) -> None:
    """Wait for the card, so that a launch failure raises before "ok"."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warmups(device) -> None:
    """A tiny call of each engine on ``device``; the loudness meter's
    K-weighting runs the K4 kernel on the card."""
    import torch
    silence = torch.zeros(1, 4800, device=device)     # 100 ms @ 48 kHz

    from .eval.loudness import loudness_report
    loudness_report(silence, 48000)
    _done(device)
    print("[warmup] loudness: ok")

    from .ops.spectral import spectral_enhance
    spectral_enhance(silence, 2, 4, 0.6, use_matmul_fft=device.type != "cpu")
    _done(device)
    print("[warmup] spectral enhance: ok")

    from .models.rnnoise.model import denoise, init_params
    denoise(init_params(0), torch.zeros(1, 4800, device=device))
    _done(device)
    print("[warmup] rnnoise: ok")

    from .models.deepfilternet.model import enhance
    from .models.deepfilternet.model import init_params as dfn_init
    enhance(dfn_init(0), silence)
    _done(device)
    print("[warmup] deepfilternet: ok")

    # weights resolved as the nodes resolve them (converted > trained >
    # shipped > random), then a tiny encode
    from .models.dac.model import build_dac
    model, _sr = build_dac("44khz")
    model.to(device)
    model.encode(torch.zeros(1, model.cfg.hop * 4, device=device))
    _done(device)
    print("[warmup] dac: ok")


def _failed(step: str) -> int:
    traceback.print_exc()
    print(f"[install] failed at the {step} step: {sys.exc_info()[1]}")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m egregora_tpu_torch.install")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernels build and the warmups run (default: the card)")
    ap.add_argument("--skip-warmup", action="store_true")
    ap.add_argument("--offline", action="store_true",
                    help="skip the weight fetch attempt")
    ap.add_argument("--install-deps", action="store_true",
                    help="pip-install missing dependencies (reference "
                         "install.py behavior; default only checks)")
    args = ap.parse_args(argv)
    if not check_deps(install=args.install_deps):
        print("[install] finished with missing required deps")
        return 1
    card = None
    if args.device == "cuda":
        card = check_card()
        if card is None:
            print("[install] stopped before the build: the card checks failed "
                  "(pass --device cpu to bootstrap for the CPU)")
            return 1
    import torch
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    try:
        build_native(device, card)
    except RuntimeError:
        return _failed("build")
    check_weights(fetch=not args.offline)
    if not args.skip_warmup:
        try:
            warmups(device)
        except Exception:           # the run's boundary: report, exit 1
            return _failed("warmup")
    print("[install] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
