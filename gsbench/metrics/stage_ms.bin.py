"""Mean milliseconds a frame spends in the bin stage: the program's fenced
``stage/bin`` spans (``RenderConfig(timing=True)``, core/stages.py
TimedBackend) of the timed frames, summed and divided by the frames (a
frame that skips the stage adds nothing)."""

LAYER = "bin (core/grouping.py bin_pairs, two stable sorts)"
UNIT = "ms"
MOVES = "fps"
STAGE = "bin"


def read(trace):
    frames = trace.frames_b
    if not frames:
        return None
    return 1e3 * sum(f["spans"].get(STAGE, 0.0) for f in frames) / len(frames)
