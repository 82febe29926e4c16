"""peak_mem_gib (GiB, lower): ``torch.cuda.max_memory_allocated()`` over
the window, the counter reset after set-up."""


def read(ctx):
    return ctx.memory_peak_bytes / 2.0 ** 30 if ctx.memory_peak_bytes else None
