"""Seconds of set-up in making the fit's optimizer (``fit._adam``, whose
first call imports ``torch._dynamo``): every untraced record of the
program's ``fit.make_optimizer``, summed."""

from perfbench.spans import setup_s


def read(st):
    return setup_s(st, ("fit.make_optimizer",), "fit")
