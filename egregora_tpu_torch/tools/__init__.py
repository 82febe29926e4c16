"""Lab tools that time the port's kernels on the card (``python -m
egregora_tpu_torch.tools.<name>``)."""
from __future__ import annotations


def cuda_ms(fn, rounds: int) -> float:
    """Mean device time of ``fn()`` over ``rounds`` launches, after one,
    from CUDA events."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds
