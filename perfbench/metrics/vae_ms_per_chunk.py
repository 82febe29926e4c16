"""vae_ms_per_chunk (ms, moves audio_rtf): device time of the kernels
launched under the VAE's ``encode`` and ``decode``, per chunk row."""


def read(ctx):
    t = ctx.trace
    rows = ctx.rows_done()
    if t is None or not rows or not len(t.dev) or not len(t.spans.get("pb.vae.encode", ())):
        return None
    return 1e3 * t.device_time("pb.vae.encode", "pb.vae.decode") / rows
