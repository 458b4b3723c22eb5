"""Frames a second: the frames whose image was complete on the card
(synchronised) inside the window, over the window's seconds; all frames
over all the time."""

UNIT = "frames/s"


def read(window):
    if window.span_s <= 0:
        return None
    return sum(1 for t in window.latency_s if t != float("inf")) / window.span_s
