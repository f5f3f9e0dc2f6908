"""Model FLOPs of the traced steps' valid work over the traced window at the bf16 peak, %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
