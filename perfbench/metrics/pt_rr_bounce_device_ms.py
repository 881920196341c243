"""Device ms a frame of PT's bounces after Russian roulette first acts,
the phases ``pt.bounce.<b>`` for rr_start < b <= max_bounces of each
graph replay, over the frame's chunks: the mean over the window's timed
frames."""

from perfbench.phases import device_ms_sum
from perfbench.pt_bounces import rr_bounces


def read(st):
    bounces = rr_bounces(st)
    return None if not bounces else device_ms_sum(
        st, [f"pt.bounce.{b}" for b in bounces])
