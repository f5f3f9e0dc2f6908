"""User audio fully processed in the window per second of window, s/s."""

from benchmark import readers


def read(ctx):
    return ctx["win"]["stream_rate"]
