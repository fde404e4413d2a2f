#!/usr/bin/env python3
"""The noise model's failure rates of the multi-partition model circuits.

    python3 tools/multi_noise.py [--json PATH]

Compiles (host work only, on the CPU) the three multi-partition circuits
the smoke serves, ``PrimeMatch(10, 10, 10, 50)``, ``PrimeMatch(5, 5, 4,
7)`` and ``HammingDistance(32, 4)`` with ``via="xor"``, at the default
``Configuration()``, and prints for each: its partitions and conversion
keys; every decision point's partition, width, count a request and
failure probability under the compiled parameters
(``compilation.multi.decision_failures``: the lookup input patterns of
``Graph.variance_pairs`` at their partition's atomic-pattern variance,
the crossings' downstream decisions with the conversion keyswitch, the
output decodes); the expected failing decisions a request; and the
figure ``Circuit.p_error`` reports for a multi circuit (each partition's
``CryptoParams.p_error`` at min(id, 8) bits and its largest norm2), which
is not a decision point's.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PRIME_MATCH = {"prime_match_10": (10, 10, 10, 50),
               "prime_match_5": (5, 5, 4, 7)}
HAMMING_XOR = (32, 4)


def circuits():
    """{name: compile()} of the three multi circuits (device="cpu": the
    compile is host work)."""
    from concrete_tpu_torch import models as tm
    out = {name: (lambda a=args: tm.PrimeMatch(*a).compile(device="cpu"))
           for name, args in PRIME_MATCH.items()}
    out["hamming_xor"] = lambda: tm.HammingDistance(*HAMMING_XOR).compile(
        via="xor", device="cpu")
    return out


def report(circuit) -> dict:
    from concrete_tpu_torch.compilation.multi import (decision_failures,
                                                      expected_failures)
    specs = circuit.client_specs
    records = decision_failures(circuit.graph, specs)
    return {"partitions": {w: str(p) for w, p in specs.partitions.items()},
            "conversions": {f"{s}->{d}": list(g) for (s, d), g
                            in (specs.conversions or {}).items()},
            "partition_norm2": specs.partition_norm2,
            "decisions": records,
            "expected_failures_per_request": expected_failures(records),
            "circuit_p_error": circuit.p_error,
            "per_partition_formula": {
                w: specs.partitions[w].p_error(
                    min(w, 8), norm2=(specs.partition_norm2 or {}).get(w, 1))
                for w in specs.partitions}}


def main() -> None:
    out = {}
    for name, make in circuits().items():
        circuit = make()
        rec = out[name] = report(circuit)
        print(f"{name}: partitions {rec['partitions']}; conversions "
              f"{rec['conversions']}; Circuit.p_error {rec['circuit_p_error']:.4g}"
              f" (per partition {rec['per_partition_formula']})", flush=True)
        for r in rec["decisions"]:
            print(f"  {r['kind']:>13} uid {r['uid']:>4}: partition {r['pid']}"
                  f" -> {r['dst']}, {r['bits']} bits, {r['elements']} a "
                  f"request, p {r['p']:.3e}, crossing {r['p_crossing']:.3e}",
                  flush=True)
        print(f"  expected failing decisions a request: "
              f"{rec['expected_failures_per_request']:.4e}", flush=True)
    if "--json" in sys.argv:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as f:
            json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
