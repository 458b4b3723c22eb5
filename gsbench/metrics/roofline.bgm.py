"""Share of its roofline that the bitmask kernel reaches: the least time the card
could take for the work the checked frames' inputs need
(``gsbench/work.py``, from the reference's own counts), over the
kernel's device time in those frames (torch.profiler, by name)."""

from gsbench import work

LAYER = "BGM kernel (kernels/bitmask_gen.py, csrc/bitmask_gen.cu)"
UNIT = "%"
MOVES = "fps"
KERNEL = "bitmask_gen_kernel"


def read(trace):
    frames = [f for f in trace.frames_a if f["counts"] is not None]
    spent = sum(trace.kernel_seconds(f, KERNEL) for f in frames)
    if not frames or spent <= 0:
        return None
    least = sum(work.least_seconds(*work.bgm(f["counts"]))[0] for f in frames)
    return 100.0 * least / spent
