#!/usr/bin/env python3
"""Kernels A and B at PrimeMatch(5, 5, 4, 7)'s banded partition, kernels
1, 3 and 4 at PrimeMatch(10, 10, 10, 50)'s N=8192 partition, at
``radix_add``'s and the TFHE-rs ``FheUint8`` circuit's lookups, and the
fused persistent kernel at ``Sha1``'s, on one GPU.

    python3 tools/multi_shape_bounds.py

Compiles both circuits with the port (host code) and reads each lookup
partition's shape: its parameters, its lookup batch and the key form and
truncation its packing rule gives.  Then, at the banded partition of
k+1 = 6 (N=256, B=25), kernels A and B of one blind-rotate step, and at the
fused partition of N=8192 (B=100), kernels 1, 3 and 4 over two steps, each
held bit-exact to its plain version on random operands of those shapes and
timed beside it (CUDA events), with the bound ``chip_smoke.py`` computes
from the shape (bytes over the memory rate, operations over the peak rate
of their type) and, for kernel B, ``torch._int_mm`` of the same product on
the pre-built Toeplitz matrix.  The shapes of the smoke's later phases
are the served circuits' own, as their packing rule keys them (2048 and
16384 take the special primes' first 2 or 3): kernels 1, 3 and 4 over two
steps at ``radix_add``'s (B=512, N=2048, l=2, base 2^10, 2 primes, 28
bits truncated, acc32) and at the ``FheUint8`` circuit's (N=16384, l=2,
base 2^15, 3 primes, 5 bits truncated, acc32; B=128 and B=32); the fused
persistent kernel (``blind_rotate_fused_latency``) over a whole lookup of
``Sha1``'s (B=1, N=2048, l=2, base 2^10, 728 steps, acc32) on the rule's
key (2 primes, 28 bits truncated) and the exact one (3 primes), against
the three-kernel loop on the card, timed beside it.  Prints one JSON line
and writes chiprun_out/multi_shape_bounds.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (the checks and their bounds)


def lookup_shapes(circuit) -> dict:
    """{partition id: (params, largest lookup batch)} of the partitions
    that run a lookup."""
    import numpy as np
    from concrete_tpu_torch.compilation.widths import (TLU_OPS,
                                                       tlu_input_partition)
    default = circuit.client_specs.message_bits
    out = {}
    for node in circuit.graph.topological_order():
        if node.name not in TLU_OPS or not any(
                p.output.is_encrypted
                for p in circuit.graph.ordered_preds_of(node)):
            continue
        pid = tlu_input_partition(circuit.graph, node, default)
        batch = max(int(np.prod(node.output.shape)), 1)
        p = circuit.client_specs.params_for_width(pid)
        out[pid] = (p, max(batch, out.get(pid, (p, 0))[1]))
    return out


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    from concrete_tpu_torch import models as tm
    from concrete_tpu_torch.compilation.widths import part_width
    from concrete_tpu_torch.core import limbs as lb
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.optimizer.v0 import use_fused
    from concrete_tpu_torch.params import choose_truncate_limbs
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(cs.SEED)
    rec = {"card": cs.card()}
    print(f"card: {rec['card']}", flush=True)
    clock, mix = cs.sm_clock(), cs.sass_mix()
    pm5_circuit = tm.PrimeMatch(*cs.PRIME_MATCH_5).compile()
    pm5 = lookup_shapes(pm5_circuit)
    pm10_circuit = tm.PrimeMatch(*cs.PRIME_MATCH_10).compile()
    pm10 = lookup_shapes(pm10_circuit)
    banded = [(pid, p, b) for pid, (p, b) in pm5.items()
              if p.glwe_dimension + 1 == 6
              and not use_fused(p, part_width(pid))]
    fused = [(pid, p, b) for pid, (p, b) in pm10.items()
             if p.polynomial_size == 8192 and use_fused(p, part_width(pid))]
    if len(banded) != 1 or len(fused) != 1:
        cs.fail(f"expected one banded k+1=6 partition in PrimeMatch 5 and "
                f"one fused N=8192 partition in PrimeMatch 10, got {pm5}, "
                f"{pm10}")
    pid, p, batch = banded[0]
    t = choose_truncate_limbs(
        p, part_width(pid),
        norm2=(pm5_circuit.client_specs.partition_norm2 or {}).get(pid, 1))
    kp1, a_limbs = p.glwe_dimension + 1, lb.num_digit_limbs(p.pbs_base_log)
    shape = {"partition": pid, "params": str(p), "batch": batch,
             "truncate_limbs": t}
    rec["prime_match_5"] = {
        "shape": shape,
        "rotate_decompose": cs.check_rotate_decompose(
            rng, rows=batch * kp1, n=p.polynomial_size,
            base_log=p.pbs_base_log, levels=p.pbs_level, a_limbs=a_limbs,
            timed=True),
        "external_product_accumulate": cs.check_external_product(
            rng, batch=batch, levels=p.pbs_level, kp1=kp1,
            n=p.polynomial_size, a_limbs=a_limbs, s_planes=8 - t,
            keep=8 - t, limb_offset=t, timed=True)}
    pid, p, batch = fused[0]
    primes, trunc = host.choose_fused_primes(
        p, part_width(pid),
        norm2=(pm10_circuit.client_specs.partition_norm2 or {}).get(pid, 1))
    acc32 = host.digits_lo_free(p.pbs_base_log, p.pbs_level)
    rec["prime_match_10"] = {
        "shape": {"partition": pid, "params": str(p), "batch": batch,
                  "primes": list(primes), "trunc_bits": trunc,
                  "acc32": acc32},
        **cs.check_fused_steps(
            rng, batch=batch, n=p.polynomial_size, levels=p.pbs_level,
            base_log=p.pbs_base_log, primes=primes, trunc_bits=trunc,
            acc32=acc32, steps=2, clock=clock, mix=mix, timed=True)}
    # the shapes of the bigint, tfhers and module phases
    fused = dict(levels=2, acc32=True, steps=2, clock=clock, mix=mix,
                 timed=True)
    rec["radix_add"] = cs.check_fused_steps(
        rng, batch=512, n=2048, base_log=10,
        primes=host.special_ntt_primes(2048, 128)[:2], trunc_bits=28,
        **fused)
    for batch in (128, 32):
        rec[f"fheuint8_b{batch}"] = cs.check_fused_steps(
            rng, batch=batch, n=16384, base_log=15,
            primes=host.special_ntt_primes(16384, 128)[:3], trunc_bits=5,
            **fused)
    for n_p, trunc in ((2, 28), (3, 0)):
        rec[f"sha1_{n_p}_primes"] = cs.check_fused_latency(
            rng, batch=1, n=2048, kp1=2, levels=2, base_log=10, n_primes=n_p,
            trunc_bits=trunc, acc32=True, n_small=728, plain=False,
            timed=True, clock=clock, mix=mix)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "multi_shape_bounds.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
