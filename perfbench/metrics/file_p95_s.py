"""file_p95_s (s, lower): the 95th percentile of one node call's wall time,
from the call to the returned AUDIO dict, over every call of the window
(host clock; a failed call counts at its time)."""
import numpy as np


def read(ctx):
    walls = [c.wall for c in ctx.window.calls]
    return float(np.percentile(walls, 95)) if walls else None
