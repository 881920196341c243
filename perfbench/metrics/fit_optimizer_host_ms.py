"""Host ms of a fit step's optimizer (the gradients handed over, Adam's
step, zero_grad, the projection): the program's ``fit.optimizer`` span,
the mean over the window's steps."""

from perfbench.spans import window_ms


def read(st):
    return window_ms(st, "fit.optimizer", "fit")
