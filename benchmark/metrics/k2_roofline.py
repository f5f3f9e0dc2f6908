"""K2 (int8-KV prefill attention): bound over device time in the traced steps, %."""

from benchmark import readers


def read(ctx):
    return readers.k2_roofline(ctx)
