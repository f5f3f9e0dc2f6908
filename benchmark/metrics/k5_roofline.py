"""K5 (grouped int4 weight-only projections): bound over device time in the traced steps, %."""

from benchmark import readers


def read(ctx):
    return readers.linear_roofline(ctx, "k5")
