"""Device ms a frame from the graph's first node to its last, gaps
between its kernels included: ``replay_ms`` of the program's
``graphs.launch``, the mean over the window's timed frames."""

from perfbench.spans import device_ms


def read(st):
    return device_ms(st, "graphs.launch", "replay_ms")
