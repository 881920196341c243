"""Device ms a frame of BDPT's s = 0 and vertex-connection strategies,
the phases ``bdpt.s0`` and ``bdpt.connect`` of each graph replay, over
the frame's chunks: the mean over the window's timed frames."""

from perfbench.phases import device_ms_sum


def read(st):
    return device_ms_sum(st, ("bdpt.s0", "bdpt.connect"))
