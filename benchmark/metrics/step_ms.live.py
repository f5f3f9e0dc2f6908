"""Mean host time of a DuplexService.step that ran a tick, ms (live cell)."""

from benchmark import readers


def read(ctx):
    return readers.span_ms(ctx, "step")
