"""codec_idle_ms (ms, moves audio_rtf): the card's idle time inside the
program's two node spans (``egr.node.dac_encode``, ``egr.node.dac_decode``:
the AUDIO conversion in, the resample where the rates differ, the codes
dict's host copies out, the latents' copy back in, the AUDIO dict out)
outside its three model spans (``egr.dac.encoder``, ``egr.dac.rvq``,
``egr.dac.decoder``), per encode call.  None where the program records no
node span."""

NODES = ("egr.node.dac_encode", "egr.node.dac_decode")
MODELS = ("egr.dac.encoder", "egr.dac.rvq", "egr.dac.decoder")


def _idle(t, names) -> float:
    return sum((b - a) - t.busy_in(a, b) for n in names for a, b in t.spans.get(n, ()))


def read(ctx):
    t = ctx.trace
    calls = len(t.spans.get(NODES[0], ())) if t is not None and len(t.dev) else 0
    if not calls:
        return None
    return 1e3 * (_idle(t, NODES) - _idle(t, MODELS)) / calls
