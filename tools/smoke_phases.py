#!/usr/bin/env python3
"""Run some phases of ``chip_smoke.py`` alone on one NVIDIA GPU.

    python3 tools/smoke_phases.py [keygen] [models] [multi] [multi_wop]
                                  [module] [kinds] [fused] [crt_scan] [wop]
                                  [bigint]
                                  [tfhers] [scheduler] [cli] [parallel]

Builds the port's kernels from ``concrete_tpu_torch/csrc``, then runs the
named phases of the smoke (``keygen``: the key bodies on the card
against the host's keygen, and the product timed; ``models``: the five
model circuits and the
2-key database against the CPU; ``multi``: PrimeMatch at two sizes and
HammingDistance with via="xor", multi-partition circuits, and the
circuit with a WoP partition (``multi_wop`` alone); ``module``:
fhe.module's composition cases and Sha1 over encrypted words, a whole
digest of b"abc" held to hashlib, and its digest in the default simulate
mode on the host; ``kinds``: the node-kinds circuits;
``fused``: the CRT-NTT blind rotate at B <= 4 in one launch at the models'
shapes, with its variant builds; ``crt_scan``: the CRT-NTT blind rotate of
a batch in one launch at the batch shapes its rule takes, timed against
the three-kernel loop; ``wop``: the WoP vertical packing's
kernel entries and PrivateInformationRetrieval at 32 and 64 rows
served; ``bigint``: 16-bit radix addition at B=512 and a radix_mul,
radix_lt and radix_eq circuit; ``tfhers``: a TFHE-rs FheUint8 bincode round
trip through the bridge; ``scheduler``: run_async chains and concurrent
calls against sequential runs; ``cli``: python -m concrete_tpu_torch's
four verbs as subprocesses; ``parallel``: one rank per visible card in an
NCCL group, the batch-sharded PBS, the table archive on the shards and
the limb-sharded PBS at N=4096, against one card; several ranks only
where the machine has several GPUs; ``models`` and ``kinds`` when none is
named),
each as the whole smoke runs it, with its checks.
It prints no kernel line and no result line, so it proves nothing about
the rest of the smoke.  Writes chiprun_out/smoke_phases.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (the phases and their checks)


def fused_phase(rng):
    """chip_smoke.py's fused_latency_phase, with its variant and
    instrumented builds."""
    import shutil
    import tempfile
    from concrete_tpu_torch.utils.csprng import BUILD_DIR
    var_dir = tempfile.mkdtemp(dir=BUILD_DIR)
    builds = cs.fused_latency_builds(var_dir)
    rec = cs.fused_latency_phase(rng, cs.sm_clock(), cs.sass_mix(),
                                 *builds())
    shutil.rmtree(var_dir)
    return rec


def crt_scan_phase(rng):
    """chip_smoke.py's crt_scan_phase, with the card's clock and the
    probes' instruction mix for the bounds."""
    return cs.crt_scan_phase(rng, cs.sm_clock(), cs.sass_mix())


def wop_phase(rng):
    """chip_smoke.py's checks of the WoP vertical packing's kernel entries,
    then its wop phase."""
    return {"kernels": cs.wop_keyed_checks(rng, cs.sm_clock(),
                                           cs.sass_mix()),
            "phase": cs.wop_phase(rng)}


PHASES = {"keygen": cs.keygen_checks, "models": cs.models_phase,
          "multi": cs.multi_phase, "multi_wop": cs.multi_wop_phase,
          "module": cs.module_phase, "kinds": cs.kinds_phase,
          "fused": fused_phase, "crt_scan": crt_scan_phase,
          "wop": wop_phase,
          "bigint": cs.bigint_phase, "tfhers": cs.tfhers_phase,
          "scheduler": cs.scheduler_phase, "cli": cs.cli_phase,
          "parallel": cs.parallel_phase}
DEFAULT = ("models", "kinds")


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: these phases need a GPU")
    names = sys.argv[1:] or list(DEFAULT)
    if not set(names) <= set(PHASES):
        cs.fail(f"unknown phases {sorted(set(names) - set(PHASES))}: give "
                f"any of {sorted(PHASES)}")
    from concrete_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(cs.SEED)
    rec = {"card": cs.card()}
    print(f"card: {rec['card']}", flush=True)
    for name in names:
        rec[name] = PHASES[name](rng)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "smoke_phases.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"phases {names}: passed", flush=True)


if __name__ == "__main__":
    main()
