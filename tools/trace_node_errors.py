#!/usr/bin/env python3
"""Decrypt every node of one request of a model circuit served by the port,
against the graph's clear evaluation, on the card.

    python3 tools/trace_node_errors.py [--no-cpu] [--exact] [--repeat=K] pir ...

Each named model (the sizes of ``chip_smoke.py``'s models and multi
phases: gol, levenshtein, kvdb, hamming, pir, prime_match_10,
prime_match_5, hamming_xor) is compiled at the default
``Configuration()``, keyed from a seed and run once through
``Server.run`` with every node's value kept; each encrypted node is
decrypted at its encoding width (a multi-partition circuit's under its
partition's key) and compared with the clear value, modulo the encoding;
its phase error's standard deviation is printed in torus units, a lookup
output's beside the noise model's blind-rotate standard deviation in its
input partition (with the conversion keyswitch's where it crosses a
frontier).  A root is a wrong node whose inputs decrypt right and lie
within the bounds the inputset measured.  The first root lookup is run
again on the card with the bootstrap key packed other ways (its phase
error by key form, prime count, truncation and acc32 mode), and unless
``--no-cpu``, on CPU copies of its inputs and keys (every kernel's plain
version): equal bits put the fault outside the card's kernels, different
bits in them.  ``--exact`` serves on the exact keys where the packing
rule truncates a fused key (``chip_smoke.exact_keys``,
``multi_exact_keys``).  Writes chiprun_out/trace_node_errors.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (the models' sizes, cpu_keys)
#: ``--no-cpu`` skips the plain path's run of the first root lookup
CPU_RERUN = "--no-cpu" not in sys.argv
#: ``--exact``: the exact fused keys in place of truncated ones
EXACT = "--exact" in sys.argv
#: ``--repeat=K``: up to K requests (fresh encryptions) until one has a
#: wrong lookup whose inputs decrypt right
REPEAT = int(next((a.split("=")[1] for a in sys.argv
                   if a.startswith("--repeat=")), 1))


def models(rng):
    """{name: (compile, arguments)} at chip_smoke.py's sizes."""
    from concrete_tpu_torch import models as tm
    kvdb = tm.StaticKeyValueDatabase(cs.KVDB_KEYS, cs.KVDB_VALUES)
    words, bits = cs.HAMMING
    return {
        "gol": (tm.GameOfLife(*cs.GOL_SIZE).compile,
                (rng.integers(0, 2, cs.GOL_SIZE),)),
        "levenshtein": (
            tm.LevenshteinDistance(*cs.LEVENSHTEIN).compile,
            tuple(rng.integers(0, 1 << cs.LEVENSHTEIN[2], n)
                  for n in cs.LEVENSHTEIN[:2])),
        "kvdb": (kvdb.compile, (int(rng.integers(0, cs.KVDB_KEYS[-1] + 2)),)),
        "hamming": (lambda: tm.HammingDistance(words, bits).compile(
            via="packed"), tuple(rng.integers(0, 1 << bits, words)
                                 for _ in range(2))),
        "pir": (tm.PrivateInformationRetrieval(
            rng.integers(0, 16, cs.PIR_SHAPE)).compile,
                (int(rng.integers(0, cs.PIR_SHAPE[0])),)),
        **{name: (tm.PrimeMatch(*sizes).compile, prime_match_args(
            rng, sizes)) for name, sizes in (
                ("prime_match_10", cs.PRIME_MATCH_10),
                ("prime_match_5", cs.PRIME_MATCH_5))},
        "hamming_xor": (lambda: tm.HammingDistance(words, bits).compile(
            via="xor"), tuple(rng.integers(0, 1 << bits, words)
                              for _ in range(2))),
    }


def prime_match_args(rng, sizes):
    b, c, s, q = sizes
    return (rng.integers(0, 2, b), rng.integers(0, s, b),
            rng.integers(1, q + 1, b), rng.integers(0, 2, c),
            rng.integers(0, s, c), rng.integers(1, q + 1, c))


def model_std(ex, node, fks) -> float:
    """The noise model's standard deviation of a lookup's fresh output in
    torus units: its input partition's blind rotate, plus the conversion
    keyswitch where its output crosses a frontier."""
    import math
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.compilation.multi import _partition_noise
    pid = ex.lookup_partition(node)
    p = ex.params_for_width(pid)
    v_br, _, _ = _partition_noise(p)
    dst = ex.part_of(node)
    if ex.partitions and (pid, dst) in (fks or {}):
        lvl, base = ex.conversions[(pid, dst)]
        v_br += pp.variance_keyswitch(p.n_big, base, lvl,
                                      ex.params_for_width(dst).glwe_std ** 2)
    return math.sqrt(v_br)


def trace(name, compile_fn, args):
    import numpy as np
    import torch
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.compilation.executor import RunKeys
    circuit = compile_fn()
    specs, graph = circuit.client_specs, circuit.graph
    circuit.keygen(seed=20261016)
    multi = specs.is_multi
    if multi:     # the packing rule's keys, as Circuit.run serves them
        keys = circuit._evaluation_keys()
        if EXACT:
            keys = cs.multi_exact_keys(circuit, keys) or keys
        ksk, bsk = keys[:2]
    else:
        ksk, bsk = keys = circuit.keys.evaluation_for(
            specs.message_bits, norm2=graph.max_norm2(),
            device=circuit.device)
        if EXACT:
            ksk, bsk = keys = cs.exact_keys(circuit, keys) or keys

    def secret(node):
        return circuit.keys.secret_for(ex.part_of(node)).lwe_big if multi \
            else circuit.keys.secret.lwe_big
    server = circuit.server
    ex = server._executor
    kept = {}
    run_node = ex._run_node

    def keep(node, preds, args_, flags, *rest):
        out = run_node(node, preds, args_, flags, *rest)
        kept[node] = (out, args_, flags)
        return out
    ex._run_node = keep
    # fresh encryptions of the same arguments until a request has a root
    for attempt in range(1, REPEAT + 1):
        kept.clear()
        enc = circuit.encrypt(*args)
        enc = enc if isinstance(enc, tuple) else (enc,)
        server.run(*enc, evaluation_keys=keys)
        if attempt == REPEAT or any_root(circuit, ex, kept, args, secret):
            break
    ex._run_node = run_node
    clear = graph.evaluate(*args)
    rows, first, bad = [], None, set()
    for node in graph.topological_order():
        if node not in kept or not node.output.is_encrypted:
            continue
        value = kept[node][0].cpu().numpy().view(np.uint64)
        width = ex.width_of(node)
        # equal modulo 2^width (decode folds the padding bit away): a
        # levelled value outside its type's range keeps its residue
        phase = ref.lwe_decrypt(secret(node), value)
        got = ref.decode(phase, width).astype(np.int64)
        want = np.asarray(clear[node]).astype(np.int64)
        noise = (np.atleast_1d(phase) - np.atleast_1d(ref.encode(
            want, width))).view(np.int64) / 2.0 ** 64
        wrong = int(np.count_nonzero(
            (got.reshape(-1) - want.reshape(-1)) % (1 << width)))
        # a value outside the bounds the inputset measured: the compiled
        # widths and tables do not cover it
        preds = graph.ordered_preds_of(node)
        covered = all(
            pr.bounds is None or (np.asarray(clear[pr]).min() >= pr.bounds[0]
                                  and np.asarray(clear[pr]).max()
                                  <= pr.bounds[1]) for pr in preds)
        # a root: wrong, though its inputs decrypt right and lie in bounds
        root = bool(wrong) and covered and not any(pr in bad for pr in preds)
        if wrong:
            bad.add(node)
        rows.append({"uid": node.uid, "name": node.name, "width": width,
                     "partition": ex.part_of(node),
                     "size": int(want.size), "wrong": wrong,
                     "inputs_in_measured_bounds": covered, "root": root,
                     "phase_std": float(noise.std()),
                     "phase_max_abs": float(np.abs(noise).max()),
                     "margin": 2.0 ** -(width + 2)})
        if node.uid in {**ex.tlu_specs, **ex.multivariate_specs}:
            rows[-1]["model_output_std"] = model_std(
                ex, node, keys[3] if multi else None)
        if root and first is None:
            first = node
    forms = {w: cs.key_form(b) for w, b in bsk.items()} if multi \
        else cs.key_form(bsk)
    rec = {"requests": attempt,
           "params": str(specs.params), "message_bits": specs.message_bits,
           "bsk": forms, "p_error": circuit.p_error,
           "nodes": len(rows), "wrong_nodes": [r for r in rows if r["wrong"]]}
    outside = [r for r in rows if not r["inputs_in_measured_bounds"]]
    rec["nodes_with_inputs_outside_bounds"] = len(outside)
    rec["roots"] = [r for r in rows if r["root"]]
    print(f"{name}: {specs.params}, {forms}, p_error "
          f"{circuit.p_error:.3g}; request {attempt} of at most {REPEAT}: "
          f"{len(rec['wrong_nodes'])} of {len(rows)} "
          f"encrypted nodes decrypt wrong; {len(outside)} read values "
          f"outside the inputset's bounds; {len(rec['roots'])} wrong with "
          f"right inputs in bounds", flush=True)
    for r in rec["roots"][:12]:
        print(f"  root {r}", flush=True)
    for r in [r for r in rec["wrong_nodes"]
              if not r["inputs_in_measured_bounds"]][:4]:
        print(f"  outside bounds {r}", flush=True)
    for r in rows:
        print(f"  %{r['uid']} {r['name']} ({r['size']}, {r['width']} bits, "
              f"partition {r['partition']}): {r['wrong']} wrong, phase "
              f"error std {r['phase_std']:.3e} (max {r['phase_max_abs']:.3e}"
              f", margin {r['margin']:.3e})"
              + (f", the model's lookup output std "
                 f"{r['model_output_std']:.3e}" if "model_output_std" in r
                 else ""), flush=True)
    if multi:       # the key variants and the CPU rerun are mono tools
        return rec
    if first is not None and first.uid in {**ex.tlu_specs,
                                           **ex.multivariate_specs}:
        out, args_, flags = kept[first]
        polys = {u: q.cpu() for u, q in server._lut_polys.items()}
        rec["phase_errors"] = key_variants(circuit, ex, first, args_, flags,
                                           clear, polys)
        if not CPU_RERUN:
            return rec
        t0 = time.perf_counter()
        cpu = ex._run_node(first, graph.ordered_preds_of(first),
                           [a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in args_], flags,
                           RunKeys(*cs.cpu_keys(ksk, bsk)), polys, "cpu",
                           ({}, {}))
        same = bool(torch.equal(cpu, out.cpu()))
        rec["first_wrong_lookup_equal_on_cpu"] = same
        print(f"  first wrong lookup %{first.uid} ({first.name}) on CPU "
              f"copies ({time.perf_counter() - t0:.1f} s): "
              f"{'equal' if same else 'DIFFERENT'} bits", flush=True)
    return rec


def any_root(circuit, ex, kept, args, secret) -> bool:
    """Whether a kept lookup output decrypts wrong while its inputs
    decrypt right (inputs within the bounds or not); secret(node) is the
    key its value decrypts under."""
    import numpy as np
    from concrete_tpu_torch.core import refimpl as ref
    clear = circuit.graph.evaluate(*args)

    def right(node):
        if node not in kept:
            return True
        w = ex.width_of(node)
        got = ref.decode(ref.lwe_decrypt(
            secret(node), kept[node][0].cpu().numpy().view(np.uint64)), w)
        return not np.any((got.astype(np.int64).reshape(-1) - np.asarray(
            clear[node]).astype(np.int64).reshape(-1)) % (1 << w))
    return any(not right(n) and all(map(right, circuit.graph.ordered_preds_of(
        n))) for n in kept if n.name in ("tlu", "univariate", "multivariate"))


def phase_error(sk, value, want, width) -> dict:
    """The output's phase minus its exact encoding, in message steps
    (2^(63 - width)): a decryption fails beyond half a step."""
    import numpy as np
    from concrete_tpu_torch.core import refimpl as ref
    phase = ref.lwe_decrypt(sk, value.cpu().numpy().view(np.uint64))
    err = (phase - ref.encode(want, width)).view(np.int64) \
        / float(1 << (63 - width))
    return {"mean": float(err.mean()), "std": float(err.std()),
            "max_abs": float(np.abs(err).max())}


def key_variants(circuit, ex, node, args_, flags, clear, polys) -> dict:
    """The lookup `node` run on the card again with the bootstrap key
    packed other ways: its phase error by key (as packed; fused with every
    prime and no truncation; fused without the acc32 mode; banded)."""
    import numpy as np
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import fused_ntt as fn
    p = circuit.client_specs.params
    server_keys = circuit.keys.server
    ksk = kn.pack_ksk(server_keys.ksk, p, device=circuit.device)
    primes, t = host.choose_fused_primes(p, circuit.client_specs.message_bits,
                                         circuit.graph.max_norm2())
    full = host.choose_fused_primes(p, None)
    dev = circuit.device
    variants = {"banded, untruncated": kn.pack_bsk(server_keys.bsk, p, 0,
                                                   device=dev)}
    if p.polynomial_size >= 1024:
        variants.update({
            f"fused, {len(primes)} primes, t={t}": fn.pack_bsk_fused(
                server_keys.bsk, p, primes=primes, trunc_bits=t, device=dev),
            f"fused, {len(full[0])} primes, t={full[1]}": fn.pack_bsk_fused(
                server_keys.bsk, p, primes=full[0], trunc_bits=full[1],
                device=dev)})
    sk = circuit.keys.secret.lwe_big
    width, want = ex.width_of(node), np.asarray(clear[node])
    preds = circuit.graph.ordered_preds_of(node)
    out = {"input": phase_error(sk, args_[0], np.asarray(clear[preds[0]]),
                                ex.width_of(preds[0]))}
    print(f"  %{node.uid}'s input: phase error in message steps "
          f"{out['input']}", flush=True)
    from concrete_tpu_torch.compilation.executor import RunKeys
    for name, bsk in variants.items():
        value = ex._run_node(node, preds, args_, flags, RunKeys(ksk, bsk),
                             {u: q.to(dev) for u, q in polys.items()}, dev,
                             ({}, {}))
        out[name] = phase_error(sk, value, want, width)
        print(f"  %{node.uid} with the key {name}: phase error in message "
              f"steps {out[name]}", flush=True)
    if p.polynomial_size >= 1024:
        orig = fn.acc32_eligible
        fn.acc32_eligible = lambda bsk, *scale: False
        try:
            value = ex._run_node(
                node, preds, args_, flags, RunKeys(
                    ksk, variants[f"fused, {len(primes)} primes, t={t}"]),
                {u: q.to(dev) for u, q in polys.items()}, dev, ({}, {}))
        finally:
            fn.acc32_eligible = orig
        out["as packed, no acc32"] = phase_error(sk, value, want, width)
        print(f"  %{node.uid} as packed without acc32: "
              f"{out['as packed, no acc32']}", flush=True)
    return out


def main():
    import numpy as np
    rng = np.random.default_rng(1)
    table = models(rng)
    names = [a for a in sys.argv[1:] if not a.startswith("--")] \
        or list(table)
    out = {name: trace(name, *table[name]) for name in names}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "trace_node_errors.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
