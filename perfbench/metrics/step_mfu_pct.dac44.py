"""step_mfu_pct.dac44 (%, moves audio_rtf): the benchmark's own count of
the DAC's operations a codec frame (``reference.dac.flops_per_frame``,
from the configuration's widths: every conv and transposed conv, and the
quantizer's projections and distance products), times the frames the
window served (codec frames times channels), over the traced window, as a
share of the card's bf16 peak."""
from perfbench.reference.dac import flops_per_frame


def read(ctx):
    rows = ctx.rows_done()
    if ctx.trace is None or not rows or not len(ctx.trace.dev):
        return None
    flops = flops_per_frame(ctx.config["geometry"]) * rows
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks()["flops_per_s"]["bf16"]
