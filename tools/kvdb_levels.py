#!/usr/bin/env python3
"""The key-value database's query on one card, level by level.

    python3 tools/kvdb_levels.py [--entries E] [--requests R] [--out NAME]

Compiles ``models.KeyValueDatabase(E)``'s query (default E = 256) at the
default ``Configuration()``, generates the keys from a fixed seed and
serves R queries (default 4) through ``Circuit.run``, each decrypted and
held to ``models/kvdb_reference.query``.  Then:

- one query with the port's tracing on: the ``pbs`` spans' ``rows`` (the
  levels) and the counters (``pbs.crt_ntt_rows`` and the others);
- one query with every ``pbs_batch`` call between two synchronisations:
  each level's rows and ms (keyswitch, blind rotate and extract);
- one more query with each level's one-launch blind rotate
  (``ops/crt_scan.py``, where ``ops/fused_ntt.blind_rotate_form`` takes
  the level) between two CUDA events, and every launch of kernels 1, 3
  and 4 of the CRT-NTT loop (``ops/fused_ntt.scan_steps``) too: each
  form's ms a launch at each level's rows, B (k+1);
- then, on each one-launch blind rotate's own inputs, the loop, each
  launch of its kernels between two CUDA events, its result held to the
  one launch's bit for bit.  Where the host launches slower than the card
  runs (the narrow level), an event pair also holds the wait for the
  launch.

Prints one JSON line, with the card's name and power limit, and writes it
to ``chiprun_out/NAME.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def option(args: list, name: str, default):
    if name in args:
        i = args.index(name)
        value = args[i + 1]
        del args[i:i + 2]
        return type(default)(value)
    return default


def main() -> None:
    args = sys.argv[1:]
    entries = option(args, "--entries", 256)
    requests = option(args, "--requests", 4)
    name = option(args, "--out", "kvdb_levels")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no GPU: this tool times the card")
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.models import KeyValueDatabase
    from concrete_tpu_torch.models import kvdb_reference as ref
    from concrete_tpu_torch.ops import crt_scan as cs
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.utils import telemetry as tm

    rec = {"card": card(), "entries": entries}
    db = KeyValueDatabase(entries)
    t0 = time.perf_counter()
    circuit = db.compile()
    rec["compile_s"] = time.perf_counter() - t0
    p = circuit.client_specs.params
    rec["keyset"] = [p.n_small, p.glwe_dimension, p.polynomial_size,
                     p.pbs_level, p.pbs_base_log, p.ks_level, p.ks_base_log]
    rec["lookups"] = int(circuit.programmable_bootstrap_count)
    t0 = time.perf_counter()
    circuit.keygen(force=True, seed=20261018)
    packed = circuit._evaluation_keys()
    torch.cuda.synchronize()
    rec["keys_s"] = time.perf_counter() - t0
    rec["bsk_form"] = type(packed[1]).__name__
    samples = db.inputset("query", max(requests, 2), seed=7)
    enc = [circuit.encrypt(*s) for s in samples]

    def serve(i):
        return circuit.run(*enc[i % len(enc)])

    wrong, ms = 0, []
    for i in range(requests):
        t0 = time.perf_counter()
        out = serve(i)
        ms.append(1e3 * (time.perf_counter() - t0))
        want = ref.query(*(torch.as_tensor(a) for a in samples[i])).numpy()
        wrong += int(np.count_nonzero(circuit.decrypt(out) != want))
    rec["request_ms"], rec["wrong_values"] = ms, wrong

    tm.reset()
    tm.enable()
    try:
        serve(0)
        torch.cuda.synchronize()
        snap = tm.snapshot()
    finally:
        tm.disable()
        tm.reset()
    rec["pbs_span_rows"] = [s["attrs"]["rows"] for s in snap["spans"]
                            if s["name"] == "pbs"]
    rec["counters"] = dict(snap["counters"])

    levels, launches = [], []
    pbs_batch = kn.pbs_batch

    def timed_pbs(ct, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pbs_batch(ct, *a, **k)
        torch.cuda.synchronize()
        levels.append([int(ct.shape[0]), 1e3 * (time.perf_counter() - t0)])
        return out

    def timed(kernel, label, rows_of):
        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*a, **k)
            end.record()
            launches.append((label, rows_of(a), start, end))
            return out
        return wrapper

    kn.pbs_batch = timed_pbs
    try:
        serve(1)
    finally:
        kn.pbs_batch = pbs_batch
    rec["levels_rows_ms"] = levels

    saved = (fn.step.rotate_decompose_digits, fn.crt_external_product,
             fn.garner_accumulate)
    wrapped = (timed(saved[0], "kernel 1", lambda a: a[0].shape[0]),
               timed(saved[1], "kernel 3", lambda a: a[0].shape[1]),
               timed(saved[2], "kernel 4", lambda a: a[1].shape[0]))
    one_launch, kept = cs.blind_rotate_crt_scan, []

    def timed_scan(a_t, acc, *args, **kw):
        a_in, acc_in = a_t.clone(), acc.clone()
        out = timed(one_launch, "one-launch scan",
                    lambda a: a[1].shape[0] * a[1].shape[1])(
            a_t, acc, *args, **kw)
        kept.append((a_in, acc_in, args, kw, out.clone()))
        return out

    (fn.step.rotate_decompose_digits, fn.crt_external_product,
     fn.garner_accumulate) = wrapped
    cs.blind_rotate_crt_scan = timed_scan
    try:
        serve(1)
        torch.cuda.synchronize()
        mismatch = 0
        for a_t, acc, (spec_val, spec_sh), kw, want in kept:
            bsk = fn.FusedBSK(spec_val=spec_val, spec_sh=spec_sh, **kw)
            mismatch += not torch.equal(fn.scan_steps(a_t, acc, bsk), want)
        torch.cuda.synchronize()
    finally:
        (fn.step.rotate_decompose_digits, fn.crt_external_product,
         fn.garner_accumulate) = saved
        cs.blind_rotate_crt_scan = one_launch
    rec["loop_differs_from_one_launch"] = mismatch
    per = {}
    for label, rows, start, end in launches:
        acc = per.setdefault(f"{label} rows={rows}", [0, 0.0])
        acc[0] += 1
        acc[1] += start.elapsed_time(end)
    rec["kernel_ms_a_launch"] = {k: {"launches": c, "ms": s / c,
                                     "total_ms": s}
                                 for k, (c, s) in sorted(per.items())}
    rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    line = json.dumps(rec)
    print(line, flush=True)
    path = os.path.join(ROOT, "chiprun_out", name + ".json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
