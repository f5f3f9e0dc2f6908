"""Share of the traced window with no operation on the device, %."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx)
