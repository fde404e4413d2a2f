"""Device idle time a request in the serving layers (``compilation/
circuit.py``, ``server.py``, ``executor.py``: the spans ``circuit.*``,
``server.*`` and ``node.*`` outside ``pbs``), in ms: as ``idle_in_pbs_ms``,
for those spans.  Read only through ``perfbench/spans.py``."""

from perfbench import spans


def read(records):
    return spans.idle_ms(records, "serve")
