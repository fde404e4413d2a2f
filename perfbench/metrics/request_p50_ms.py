"""The median latency over all requests of the window, in ms (host clock
around each request, which ends in the copy of its outputs to the host)."""

import numpy as np


def read(records):
    lat = records["window"]["latencies_s"]
    return 1e3 * float(np.percentile(lat, 50)) if lat else None
