"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It prints, as the last line of its
standard output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number of the output comparison beside its limit).  It
exits non-zero with no result where the card is missing, where a module
of JAX or of the JAX package is loaded, or where the program is absent.
See ``perfbench/README.md``.
"""
import os
import sys
import time


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def environment() -> None:
    """The run's environment, set before torch is imported: the port's
    defaults (every ``EGREGORA_*`` switch cleared; offline, so that no
    weight lookup can reach for the network), libraries that never load
    JAX, and every kernel cache at a fixed path inside the checkout."""
    for key in [k for k in os.environ if k.startswith("EGREGORA_")]:
        del os.environ[key]
    os.environ["EGREGORA_TPU_OFFLINE"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    cache = os.path.join(ROOT, ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


if __name__ == "__main__":
    environment()
    sys.path.insert(0, ROOT)
    from perfbench.harness.main import main
    sys.exit(main(sys.argv[1:], T_START))
