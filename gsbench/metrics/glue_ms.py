"""Mean milliseconds of a timed frame outside the six stage spans: the
benchmark's own span around the call into the engine (from the call to
the synchronise that ends the frame) less the program's ``stage/<name>``
spans inside it. The engine's dispatch, the stage wrappers' host work, the
stream's cache look-up and the fences' own cost."""

LAYER = "engine (engine/handle.py, engine/stream.py, core/pipeline.py)"
UNIT = "ms"
MOVES = "fps"


def read(trace):
    frames = trace.frames_b
    if not frames:
        return None
    return 1e3 * sum(f["wall_s"] - sum(f["spans"].values()) for f in frames) / len(frames)
