"""Ciphertext bytes copied between host and card a request on rank 0, in
10^6 B: the port's counters ``bytes.h2d`` and ``bytes.d2h`` (``Server.run``'s
uploads and download, ``sharding.gather``'s upload and download) over the
window, over the window's requests.  Read only through
``perfbench/spans.py``."""

from perfbench import spans


def read(records):
    w = spans.windows(records)
    if not w or not w[0]["requests"]:
        return None
    c = w[0]["counters"]
    return (c.get("bytes.h2d", 0) + c.get("bytes.d2h", 0)) \
        / w[0]["requests"] / 1e6
