"""Device ms a frame of BDPT's t = 1 light-tracing splats, the phase
``bdpt.splat`` of each graph replay, over the frame's chunks: the mean
over the window's timed frames."""

from perfbench.phases import device_ms_sum


def read(st):
    return device_ms_sum(st, ("bdpt.splat",))
