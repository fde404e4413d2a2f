#!/usr/bin/env python3
"""Time kernel 3 (the CRT-NTT external product's BSK entry) of one checkout
on one GPU.

    python3 tools/time_crt_kernel.py [ROOT] [--out NAME]

Builds the kernels of the ``concrete_tpu_torch`` found under ROOT (by
default this checkout), then times ``ops.fused_ntt.crt_external_product``
on random operands from a fixed seed (CUDA events behind a spin kernel,
as ``chip_smoke.py`` times it) at the QuantizedMLP archive's step (B=256,
N=4096, k+1=2, l=2, base 2^8, its 3 primes) and at Levenshtein's B=1 step
(N=1024, k+1=3, l=2, base 2^11), and prints ptxas's registers and spills
of the k+1 = 2 instantiation at N=4096.  Run it on two checkouts in turns
(parent, change, change, parent) in one call to compare them on one card.
Prints one JSON line and writes it to chiprun_out/NAME.json.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"mlp": dict(batch=256, n=4096, kp1=2, levels=2, base_log=8),
          "levenshtein_b1": dict(batch=1, n=1024, kp1=3, levels=2,
                                 base_log=11)}


def main() -> None:
    args = sys.argv[1:]
    name = "time_crt_kernel"
    if "--out" in args:
        i = args.index("--out")
        name = args[i + 1]
        del args[i:i + 2]
    root = os.path.abspath(args[0]) if args else HERE
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no GPU: this tool times the card")
    import concrete_tpu_torch
    if not concrete_tpu_torch.__file__.startswith(root):
        sys.exit(f"concrete_tpu_torch was not found under {root}")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import fused_ntt as fn
    t0 = time.perf_counter()
    _build.library()
    # ptxas: kernel 3's instantiations at N = 4096 (G = 1, LOG_N = 12),
    # the k+1 = 2 one (WIDE false) first
    kernel3 = re.compile(r"crt_external_product_kernelILi1ELi12E")
    rec = {"root": root, "card": cs.card(),
           "build_s": time.perf_counter() - t0,
           "ptxas_n4096": [line for line in cs.ptxas_summary(
               _build.BUILD_INFO.get("log", "")) if kernel3.search(line)],
           "ms": {}}
    rng = np.random.default_rng(cs.SEED)
    for label, sh in SHAPES.items():
        n, kp1, levels = sh["n"], sh["kp1"], sh["levels"]
        primes = host.special_ntt_primes(n, 128)[:3]
        bsk = rng.integers(0, 1 << 64, (1, levels, kp1, kp1, n),
                           dtype=np.uint64)
        fbsk = fn.pack_bsk_fused(bsk, cs.fused_params(
            n, levels, sh["base_log"], 1, kp1), primes=primes, trunc_bits=0,
            device="cuda")
        digits = torch.from_numpy(rng.integers(
            -(1 << (sh["base_log"] - 1)), 1 << (sh["base_log"] - 1),
            (levels, sh["batch"] * kp1, n)).astype(np.int32)).cuda()
        sv, ss = fbsk.spec_val[0], fbsk.spec_sh[0]
        rec["ms"][label] = cs.cuda_ms(lambda: fn.crt_external_product(
            digits, sv, ss, primes, kp1), 50)
    line = json.dumps(rec)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{name}.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
