"""Device idle time a request inside ``pbs_batch`` (``core/kernels.py``:
keyswitch, modulus switch and LUT rotation, the blind-rotate dispatch,
sample extract), in ms: each traced request's idle stretches of the device
while the serving thread's innermost open port span is ``pbs`` or one of
its stages, mean over the requests; on several cards, the mean over the
ranks.  Read only through ``perfbench/spans.py``, which turns the port's
spans on."""

from perfbench import spans


def read(records):
    return spans.idle_ms(records, "pbs")
