"""call_host_ms (ms, moves file_p95_s): a node call's wall time less the
device-busy time inside it, as a mean over the traced window's calls.
The host's share of a call: the entry and conversion in the node, the
pcm16 wire, launches and waits that leave the card idle."""


def read(ctx):
    t = ctx.trace
    calls = t.spans.get("pb.node.run") if t is not None else None
    if calls is None or not len(calls) or not len(t.dev):
        return None
    idle = [(b - a) - t.busy_in(a, b) for a, b in calls]
    return 1e3 * sum(idle) / len(idle)
