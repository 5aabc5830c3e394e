"""The 95th percentile of every item's host-clock time in the traced
window (``traced_p95_ms.served``): the tail of a cell whose untraced
p95 spreads too widely from run to run to hold a bound. Read under the
profiler, so it sits above the untraced tail; absent where the window
kept no item."""

import numpy as np


def read(ctx):
    ms = ctx.get("item_ms")
    if not ms:
        return None
    return float(np.percentile(np.asarray(ms, np.float64), 95))
