"""forward_idle_ms_per_chunk (ms, moves audio_rtf): the card's idle time
inside the program's ``egr.forward`` spans (the chunk forward: log-mel,
VAE, UNet, vocoder and the crossover merge, launched from the host), over
the chunk rows that the program counted (``rows``) on the ``egr.process``
spans of the same calls, in the traced window.  The spans are read from
``egregora_tpu_torch.utils.profiling``, stamped on the profiler's clock;
None where the program records none or the window holds no device
events."""
from perfbench.metrics.wire_idle_ms import program_spans


def read(ctx):
    recs = program_spans(ctx) or []
    rows = {}
    for r in recs:
        if r.name == "egr.process":
            rows[r.call] = rows.get(r.call, 0) + r.counts.get("rows", 0)
    fwd = [r for r in recs if r.name == "egr.forward" and r.call in rows]
    n = sum(rows.values())
    if not fwd or not n:
        return None
    t = ctx.trace
    idle = sum((r.t1_ns - r.t0_ns) * 1e-9 - t.busy_in(r.t0_ns * 1e-9, r.t1_ns * 1e-9)
               for r in fwd)
    return 1e3 * idle / n
