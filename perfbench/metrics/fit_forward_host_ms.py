"""Host ms of a fit step's forward (the render and the loss): the
program's ``grad.forward`` span, the mean over the window's steps."""

from perfbench.spans import window_ms


def read(st):
    return window_ms(st, "grad.forward", "fit")
