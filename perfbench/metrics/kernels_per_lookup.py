"""Device kernels (the program's and torch's operators; copies and sets
left out) in the traced stretch, over its lookups; on several cards, the
mean over the ranks of each rank's kernels over its shard's lookups."""

import statistics


def read(records):
    per_rank = [r["kernels"] / r["lookups"] for r in records["ranks"]
                if r.get("requests") and r["lookups"]]
    return statistics.fmean(per_rank) if per_rank else None
