"""Mean milliseconds of a dispatch: the server's ``serve/dispatch`` span,
``render_batch`` of the padded bucket and the images' copy to the host."""

LAYER = "engine (engine/handle.py, engine/stream.py, core/pipeline.py)"
UNIT = "ms"
MOVES = "req_p95_ms"


def read(trace):
    if not trace.dispatch_s:
        return None
    return 1e3 * sum(trace.dispatch_s) / len(trace.dispatch_s)
