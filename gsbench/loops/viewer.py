"""One viewer, closed loop, through ``engine.open(scene, cfg).render(cam)``:
a new frame on the orbit as soon as the last one's image is complete on
the card (``gsbench/drive.py`` ``ClosedLoop``; the poses from the mix's
``step_deg`` and holds)."""

from gsbench.drive import ClosedLoop


class Loop(ClosedLoop):
    def open_frame(self, handle):
        return handle.render
