"""The blind rotates' share of their roofline, in %: the least time the
traced stretch's blind rotates could take (``perfbench/roofline.py``, from
the keyset and each blind rotate's batch alone) over the device time of
the blind-rotate kernels (``perfbench/blind_rotate_kernels.txt``, the union
of their intervals).  Nothing when no such kernel ran."""

import statistics

from perfbench import roofline


def read(records):
    shares = []
    for r in records["ranks"]:
        if not r.get("requests") or not r.get("br_busy_ns"):
            continue
        ks = r["keyset"]
        floor = sum(count * roofline.blind_rotate_floor_s(
            ks["n_small"], ks["glwe_dimension"], ks["polynomial_size"],
            ks["pbs_level"], batch) for count, batch in r["blind_rotates"])
        shares.append(100.0 * floor / (r["br_busy_ns"] / 1e9))
    return statistics.fmean(shares) if shares else None
