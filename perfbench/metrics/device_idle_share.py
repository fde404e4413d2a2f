"""The device's idle share of the traced stretch, in %: 1 minus the union
of its activity intervals (kernels and copies) over the stretch, from the
first traced request's start to the last one's end; on several cards, the
mean over the ranks (each rank's in the run's detail file)."""

import statistics


def read(records):
    shares = [100.0 * (1.0 - r["busy_ns"] / r["window_ns"])
              for r in records["ranks"] if r.get("requests")]
    return statistics.fmean(shares) if shares else None
