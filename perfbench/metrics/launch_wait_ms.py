"""Device ms a frame between the event recorded on the stream just
before the graph's launch and the graph's first node (the device, done
with the copy-in, waiting for the graph): ``wait_ms`` of the program's
``graphs.launch``, the mean over the window's timed frames."""

from perfbench.spans import device_ms


def read(st):
    return device_ms(st, "graphs.launch", "wait_ms")
