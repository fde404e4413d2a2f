"""Host time a request: each traced request's wall minus the union of the
device's activity inside it, in ms, as a mean over the requests; on
several cards, the mean over the ranks."""

import statistics


def read(records):
    per_rank = [statistics.fmean(w - b for w, b in zip(
        r["request_wall_ns"], r["request_busy_ns"])) / 1e6
        for r in records["ranks"] if r.get("requests")]
    return statistics.fmean(per_rank) if per_rank else None
