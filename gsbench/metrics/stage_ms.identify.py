"""Mean milliseconds a frame spends in the identify stage: the program's fenced
``stage/identify`` spans (``RenderConfig(timing=True)``, core/stages.py
TimedBackend) of the timed frames, summed and divided by the frames (a
frame that skips the stage adds nothing)."""

LAYER = "identify (core/grouping.py identify)"
UNIT = "ms"
MOVES = "fps"
STAGE = "identify"


def read(trace):
    frames = trace.frames_b
    if not frames:
        return None
    return 1e3 * sum(f["spans"].get(STAGE, 0.0) for f in frames) / len(frames)
