"""unet_ms_per_chunk (ms, moves audio_rtf): device time of the kernels
launched under the UNet's forward (the one-step latent denoiser, with its
attention), per chunk row."""


def read(ctx):
    t = ctx.trace
    rows = ctx.rows_done()
    if t is None or not rows or not len(t.dev) or not len(t.spans.get("pb.unet", ())):
        return None
    return 1e3 * t.device_time("pb.unet") / rows
