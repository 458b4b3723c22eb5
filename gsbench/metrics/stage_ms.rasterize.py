"""Mean milliseconds a frame spends in the rasterize stage: the program's fenced
``stage/rasterize`` spans (``RenderConfig(timing=True)``, core/stages.py
TimedBackend) of the timed frames, summed and divided by the frames (a
frame that skips the stage adds nothing)."""

LAYER = "rasterize (core/stages.py CudaBackend.rasterize_groups: feature pack + fused RM)"
UNIT = "ms"
MOVES = "fps"
STAGE = "rasterize"


def read(trace):
    frames = trace.frames_b
    if not frames:
        return None
    return 1e3 * sum(f["spans"].get(STAGE, 0.0) for f in frames) / len(frames)
