"""dac_encoder_ms_per_s (ms/s, moves audio_rtf): device time of the
kernels launched under the program's ``egr.dac.encoder`` spans (the DAC
encoder's convs and Snakes), per second of one channel's audio that the
window's calls served (codec frames times channels, times the hop, over
the codec's rate).  None where the program records no such span."""


def device_ms_per_channel_s(ctx, span: str):
    """Device ms under ``span`` per channel-second served, or None (also
    read by ``dac_rvq_ms_per_s`` and ``dac_decoder_ms_per_s``)."""
    t = ctx.trace
    rows = ctx.rows_done()
    if t is None or not rows or not len(t.dev) or not len(t.spans.get(span, ())):
        return None
    g = ctx.config["geometry"]
    hop = 1
    for s in g["strides"]:
        hop *= int(s)
    return 1e3 * t.device_time(span) / (rows * hop / float(g["sample_rate"]))


def read(ctx):
    return device_ms_per_channel_s(ctx, "egr.dac.encoder")
