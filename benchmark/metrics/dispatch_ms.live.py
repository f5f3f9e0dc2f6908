"""Mean host time of ServingEngine.tick_submit plus its handle's deliver a step, ms."""

from benchmark import readers


def read(ctx):
    return readers.span_ms(ctx, "dispatch")
