"""Host ms of a fit step's backward (``torch.autograd.grad``): the
program's ``grad.backward`` span, the mean over the window's steps."""

from perfbench.spans import window_ms


def read(st):
    return window_ms(st, "grad.backward", "fit")
