"""The 95th percentile of the latency over all requests of the window, in
ms."""

import numpy as np


def read(records):
    lat = records["window"]["latencies_s"]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
