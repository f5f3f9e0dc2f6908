"""Set-up: kernel builds, weights, quantisation, sessions and warm-up ticks, s."""

from benchmark import readers


def read(ctx):
    return ctx["setup_s"]
