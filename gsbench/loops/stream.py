"""One viewer, closed loop, through ``Renderer.open_stream(**stream).render``:
the stream's exact-pose frontend cache and its speculation on the next
pose (``stream`` holds the ``open_stream`` arguments). The warm-up runs on
a stream of its own, closed before the window, so the window's stream
starts with an empty cache."""

from gsbench.drive import ClosedLoop


class Loop(ClosedLoop):
    def open_frame(self, handle):
        return handle.open_stream(**self.cell.traffic["stream"]).render

    def warmed(self, handle, azimuths, n):
        warm = handle.open_stream(**self.cell.traffic["stream"])
        self.warm(warm.render, azimuths, n)
        warm.close()
        return self.open_frame(handle)
