"""audio_rtf (x, higher): seconds of input audio over seconds of wall time,
all files completed in the window over the whole time from the window's
start to the last completion (host clock)."""


def read(ctx):
    w = ctx.window
    done = sum(c.seconds for c in w.calls if c.ok)
    return done / (w.t_end - w.t0) if done else None
