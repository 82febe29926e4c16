"""dsp_ms_per_chunk (ms, moves audio_rtf): device time of the kernels
launched under the pipeline's ``process`` but outside ``synthesize`` (the
wire's conversion, resampling, chunking, the log-mel front end, the
crossover merge's STFTs and inverse, the overlap-add), per chunk row."""


def read(ctx):
    t = ctx.trace
    rows = ctx.rows_done()
    if t is None or not rows or not len(t.dev) or not len(t.spans.get("pb.process", ())):
        return None
    return 1e3 * (t.device_time("pb.process") - t.device_time("pb.synthesize")) / rows
