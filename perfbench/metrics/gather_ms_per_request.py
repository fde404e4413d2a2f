"""Host clock around ``parallel/sharding.gather`` (it ends in the copy of
the gathered outputs to the host), in ms, as a mean over the window's
requests on rank 0."""

import statistics


def read(records):
    g = records.get("gather_s")
    return 1e3 * statistics.fmean(g) if g else None
