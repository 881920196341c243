"""Device ms a frame of BDPT's two subpath walks, the phases
``bdpt.eye_walk`` and ``bdpt.light_walk`` of each graph replay, over the
frame's chunks: the mean over the window's timed frames."""

from perfbench.phases import device_ms_sum


def read(st):
    return device_ms_sum(st, ("bdpt.eye_walk", "bdpt.light_walk"))
