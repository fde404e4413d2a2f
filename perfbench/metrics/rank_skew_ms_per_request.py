"""The ranks' skew a request, in ms: for each request of the window, the
slowest rank's ``server.run`` span less the fastest rank's (each rank
timed on its own clock), mean over the window's requests.  The slowest
rank's excess is what the others wait for in ``sharding.gather``'s
``gather.sizes``.  Nothing on one card.  Read only through
``perfbench/spans.py``."""

import statistics

from perfbench import spans


def read(records):
    runs = [w["per_request_ms"]["server.run"] for w in spans.windows(records)]
    if len(runs) < 2 or not all(runs):
        return None
    k = min(len(r) for r in runs)
    return statistics.fmean(max(r[i] for r in runs) - min(r[i] for r in runs)
                            for i in range(k))
