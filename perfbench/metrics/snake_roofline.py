"""snake_roofline (%, moves audio_rtf): the least time of the window's
Snake calls over the device time of the kernels launched under the
program's ``egr.dac.snake`` spans, in percent.  A Snake call's least time
is its bytes over the card's bandwidth: its bf16 input read once and its
bf16 output, which the next conv reads, written once (4 bytes an
element); its elements are counted from the configuration's shapes
(``reference.dac.snake_shapes``: 58 Snakes a call at four strides), per
codec frame, times the frames the window served.  None where the program
records no such span."""
from perfbench.reference.dac import snake_shapes

BYTES_PER_ELEMENT = 4       # bf16 in, bf16 out


def read(ctx):
    t = ctx.trace
    rows = ctx.rows_done()
    if t is None or not rows or not len(t.dev) or not len(t.spans.get("egr.dac.snake", ())):
        return None
    busy = t.device_time("egr.dac.snake")
    if busy <= 0:
        return None
    elements = rows * sum(c * n for c, n in snake_shapes(ctx.config["geometry"], 1))
    return 100.0 * BYTES_PER_ELEMENT * elements / ctx.peaks()["bytes_per_s"] / busy
