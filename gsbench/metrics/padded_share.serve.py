"""Share of the lanes rendered that were padding: every dispatch pads its
bucket to ``max_batch`` (the server's counters: padded lanes over
requests plus padded lanes)."""

LAYER = "serving (serving/server.py, serving/bucketing.py)"
UNIT = "%"
MOVES = "req_p95_ms"


def read(trace):
    lanes = trace.lanes
    total = lanes.get("completed", 0) + lanes.get("padded", 0)
    if total <= 0:
        return None
    return 100.0 * lanes["padded"] / total
