"""Mean sort keys a frame: ``RenderStats.n_pairs_sort`` of the timed
frames, the (gaussian, group) pairs the frame's lists were sorted from
(the paper's redundancy axis, a count)."""

LAYER = "bin (core/grouping.py bin_pairs, two stable sorts)"
UNIT = "keys"
MOVES = "fps"


def read(trace):
    frames = trace.frames_b
    if not frames:
        return None
    return sum(f["stats"]["n_pairs_sort"] for f in frames) / len(frames)
