"""The 95th percentile, in milliseconds, of every request due in the
window, each from its due time on the open-loop schedule to its image on
the host; a request never delivered counts at infinite latency."""

import numpy as np

UNIT = "ms"


def read(window):
    if not window.latency_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(window.latency_s, dtype=np.float64), 95))
