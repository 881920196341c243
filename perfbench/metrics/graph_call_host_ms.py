"""Host ms of the program's ``graphs.call`` span a frame (the key, the
copy-in, the graph's launch, the clone), the mean over the window's
frames, which run before the profiler attaches."""

from perfbench.spans import window_ms


def read(st):
    return window_ms(st, "graphs.call", "render")
