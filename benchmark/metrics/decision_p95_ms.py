"""95th percentile over the user chunks decided in the window of the time
from the due time of the message that released the chunk to the delivery
of its dialog_state_update, ms."""

import numpy as np


def read(ctx):
    lat = ctx["win"]["latencies"]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
