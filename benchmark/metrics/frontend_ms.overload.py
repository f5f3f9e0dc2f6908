"""Mean host time of a ticking step before its tick_submit (the frontend loop), ms."""

from benchmark import readers


def read(ctx):
    return readers.span_ms(ctx, "frontend")
