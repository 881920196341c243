"""Host ms of the program's ``graphs.launch`` span a frame (the event
before the graph and ``CUDAGraph.replay``), the mean over the window's
frames."""

from perfbench.spans import window_ms


def read(st):
    return window_ms(st, "graphs.launch", "render")
