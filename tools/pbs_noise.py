#!/usr/bin/env python3
"""The output noise of one programmable bootstrap, by key form, on the card.

    python3 tools/pbs_noise.py [prime_match_10] [prime_match_5] [hamming_xor]
        [--batch=B]

For each partition that runs a PBS in the named multi-partition circuits
(``chip_smoke.py``'s sizes, compiled by the port at the default
``Configuration()``, keyed from the smoke's seed): B fresh encryptions of
random p-bit values (p: the partition's narrowest decision width, at
most 7) go through ``core.kernels.pbs_batch`` with the identity table, on
the partition's keys packed four ways: the packing rule's fused key and
the exact one (no bits dropped, the fewest primes holding the product),
each with the accumulator in the acc32 mode (its top 32 bits, the default
where the digits read only the top word) and exact (int64).  Prints, per
variant, the output's phase error (mean, standard deviation, largest, in
torus units) beside the noise model's blind-rotate standard deviation.
Writes chiprun_out/pbs_noise.json.
"""

from __future__ import annotations

import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (the circuits' sizes, the seed)

BATCH = int(next((a.split("=")[1] for a in sys.argv
                  if a.startswith("--batch=")), 256))


def circuits():
    from concrete_tpu_torch import models as tm
    return {"prime_match_10": lambda: tm.PrimeMatch(
                *cs.PRIME_MATCH_10).compile(),
            "prime_match_5": lambda: tm.PrimeMatch(
                *cs.PRIME_MATCH_5).compile(),
            "hamming_xor": lambda: tm.HammingDistance(*cs.HAMMING).compile(
                via="xor")}


def measure(circuit, pid, bits, rng) -> dict:
    import numpy as np
    import torch
    from concrete_tpu_torch.compilation.multi import _partition_noise
    from concrete_tpu_torch.compilation.widths import part_width
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import fused_ntt as fn
    specs, dev = circuit.client_specs, circuit.device
    p = specs.partitions[pid]
    keys = circuit.keys.keys_for(pid)
    norm2 = (specs.partition_norm2 or {}).get(pid, 1)
    ksk = kn.pack_ksk(keys.server.ksk, p, device=dev)
    rule = host.choose_fused_primes(p, part_width(pid), norm2)
    pool = host.special_ntt_primes(p.polynomial_size, 128)
    count = next(c for c in range(2, len(pool) + 1)
                 if math.prod(pool[:c]).bit_length() - 1
                 >= host.required_bits(p, 0))
    vals = rng.integers(0, 1 << bits, BATCH)
    ct = kg.encrypt_lwe_batch(cs_rng(), keys.secret.lwe_big,
                              ref.encode(vals, bits), p.glwe_std)
    ct_t = torch.from_numpy(ct.view(np.int64)).to(dev)
    lut = ref.encode_expand_lut(np.arange(1 << bits, dtype=np.uint64),
                                p.polynomial_size, bits, out_bits=bits)
    lut_t = torch.from_numpy(lut.view(np.int64)).to(dev)
    v_br, _, _ = _partition_noise(p)
    out = {"params": str(p), "bits": bits, "batch": BATCH,
           "model_std": math.sqrt(v_br), "variants": {}}
    for kname, (primes, t) in (("rule", rule), ("exact",
                                                 (tuple(pool[:count]), 0))):
        bsk = fn.pack_bsk_fused(keys.server.bsk, p, primes=primes,
                                trunc_bits=t, device=dev)
        for mode, scale in (("acc32", None), ("int64", 0)):
            if mode == "acc32" and not fn.acc32_eligible(bsk):
                continue
            small = kn.keyswitch(ct_t, ksk)
            acc = kn.blind_rotate(small, bsk, lut_t, p, min_scale_log=scale)
            res = kn.sample_extract(acc, 0).cpu().numpy().view(np.uint64)
            err = (ref.lwe_decrypt(keys.secret.lwe_big, res)
                   - ref.encode(vals, bits)).view(np.int64) / 2.0 ** 64
            label = f"{kname} ({len(primes)} primes, t={t}), {mode}"
            out["variants"][label] = {
                "mean": float(err.mean()), "std": float(err.std()),
                "max_abs": float(np.abs(err).max())}
            print(f"  partition {pid} N={p.polynomial_size} l={p.pbs_level} "
                  f"base 2^{p.pbs_base_log}, {label}: phase error mean "
                  f"{err.mean():.3e}, std {err.std():.3e}, max "
                  f"{np.abs(err).max():.3e} (the model's std "
                  f"{out['model_std']:.3e})", flush=True)
    return out


def cs_rng():
    from concrete_tpu_torch.utils.csprng import SecureGenerator
    return SecureGenerator()


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    from concrete_tpu_torch.compilation.multi import decision_failures
    from concrete_tpu_torch.ops import _build
    _build.library()
    print(f"card: {cs.card()}", flush=True)
    names = [a for a in sys.argv[1:] if not a.startswith("--")] \
        or list(circuits())
    rng = np.random.default_rng(cs.SEED)
    rec = {"card": cs.card()}
    for name in names:
        circuit = circuits()[name]()
        circuit.keygen(seed=cs.SEED)
        widths = {}
        for r in decision_failures(circuit.graph, circuit.client_specs):
            if r["kind"] != "decode":
                widths[r["pid"]] = min(widths.get(r["pid"], 7), r["bits"])
        print(f"{name}: decision widths by partition {widths}", flush=True)
        rec[name] = {pid: measure(circuit, pid, bits, rng)
                     for pid, bits in widths.items()
                     if circuit.client_specs.partitions[pid].polynomial_size
                     >= 1024}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "pbs_noise.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
