"""Share of the profiled frames (torch.profiler, from the first to the last) in which
no kernel, copy or memset ran on the card."""

LAYER = "device"
UNIT = "%"
MOVES = "fps"


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
