"""The 95th percentile, in milliseconds, of every frame of the window, each
timed on the host clock from the call to the synchronise that ends it."""

import numpy as np

UNIT = "ms"


def read(window):
    if not window.latency_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(window.latency_s, dtype=np.float64), 95))
