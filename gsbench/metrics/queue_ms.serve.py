"""Mean milliseconds from a served request's due time on the open-loop
schedule to the start of its dispatch (the server's ``dispatch`` stamp,
the start of its ``serve/dispatch`` span): the wait behind the dispatch in
flight, the scheduler's bucketing and ``max_wait``."""

LAYER = "serving (serving/server.py, serving/bucketing.py)"
UNIT = "ms"
MOVES = "req_p95_ms"


def read(trace):
    if not trace.queue_s:
        return None
    return 1e3 * sum(trace.queue_s) / len(trace.queue_s)
