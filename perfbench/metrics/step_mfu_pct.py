"""step_mfu_pct (%, moves audio_rtf): the benchmark's own count of the
three sub-models' operations a chunk (``flops.model_flops_per_chunk``,
from the configuration's widths), times the chunk rows completed, over
the traced window, as a share of the card's bf16 peak."""
import json

from perfbench.harness.flops import model_flops_per_chunk


def read(ctx):
    rows = ctx.rows_done()
    if ctx.trace is None or not rows or not len(ctx.trace.dev):
        return None
    flops = model_flops_per_chunk(json.dumps(ctx.config["geometry"], sort_keys=True)) * rows
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks()["flops_per_s"]["bf16"]
