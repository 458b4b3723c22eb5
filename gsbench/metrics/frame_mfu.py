"""Share of the card's peak that whole frames reach: the least time the
card could take for the work the checked frames' inputs need (the scene
read once, the image written once, the bitmask's and the blend's
operations; ``gsbench/work.py``) over those frames' host-clock time."""

from gsbench import work

LAYER = "whole frame"
UNIT = "%"
MOVES = "fps"


def read(trace):
    frames = [f for f in trace.frames_a if f["counts"] is not None]
    if not frames:
        return None
    least = sum(work.least_seconds(*work.frame(f["counts"], trace.scene_bytes, trace.width,
                                               trace.height))[0] for f in frames)
    return 100.0 * least / sum(f["wall_s"] for f in frames)
