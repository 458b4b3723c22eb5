"""Share of its roofline that the fused group rasterizer reaches: the least time the card
could take for the work the checked frames' inputs need
(``gsbench/work.py``, from the reference's own counts), over the
kernel's device time in those frames (torch.profiler, by name)."""

from gsbench import work

LAYER = "fused RM kernel (kernels/raster_tile.py, csrc/raster_tile.cu)"
UNIT = "%"
MOVES = "fps"
KERNEL = "raster_group_fused"


def read(trace):
    frames = [f for f in trace.frames_a if f["counts"] is not None]
    spent = sum(trace.kernel_seconds(f, KERNEL) for f in frames)
    if not frames or spent <= 0:
        return None
    least = sum(work.least_seconds(*work.fused_rm(f["counts"], trace.width, trace.height))[0] for f in frames)
    return 100.0 * least / spent
