"""wire_idle_ms (ms, moves file_p95_s): the card's idle time inside the
program's own spans of a node call's host path (``egr.node.audio_in``,
``egr.wire.encode``, ``egr.wire.h2d``, ``egr.wire.quantise``,
``egr.node.audio_out``: the AUDIO conversion in, the pcm16 wire both ways
and the fetch and conversion out), summed per node call, as a mean over
the traced window's calls (``egr.node.upscale``).  The spans are read
from ``egregora_tpu_torch.utils.profiling``, stamped on the profiler's
clock; None where the program records none or the window holds no
device events."""

WIRE = ("egr.node.audio_in", "egr.wire.encode", "egr.wire.h2d", "egr.wire.quantise",
        "egr.node.audio_out")


def program_spans(ctx):
    """The program's span records inside the traced window, or None (also
    read by ``forward_idle_ms_per_chunk``)."""
    t = ctx.trace
    if t is None or not len(t.dev):
        return None
    try:
        from egregora_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if spans is None:                   # a program without spans of its own
        return None
    # 1 us of room for the window's edges, which the trace holds as float seconds
    return spans(int(t.t0 * 1e9) - 1000, int(t.t1 * 1e9) + 1000) or None


def read(ctx):
    recs = program_spans(ctx)
    calls = sum(r.name == "egr.node.upscale" for r in recs) if recs else 0
    if not calls:
        return None
    t = ctx.trace
    idle = sum((r.t1_ns - r.t0_ns) * 1e-9 - t.busy_in(r.t0_ns * 1e-9, r.t1_ns * 1e-9)
               for r in recs if r.name in WIRE)
    return 1e3 * idle / calls
