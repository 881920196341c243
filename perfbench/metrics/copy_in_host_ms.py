"""Host ms of the program's ``graphs.copy_in`` span a frame (each scene,
camera and input tensor copied into the graph's static one), the mean
over the window's frames."""

from perfbench.spans import window_ms


def read(st):
    return window_ms(st, "graphs.copy_in", "render")
