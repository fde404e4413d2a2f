#!/usr/bin/env python3
"""Time the persistent latency blind rotate of one checkout on one GPU.

    python3 tools/time_latency_kernel.py [ROOT] [--out NAME]

Builds the kernels of the ``concrete_tpu_torch`` found under ROOT (by
default this checkout), then times ``ops.latency.blind_rotate_latency``
on random operands from a fixed seed (CUDA events behind a spin kernel,
as ``chip_smoke.py`` times it) at the shapes that both this tree and
older ones take: the N=1024 latency shape (B = 1 and 4, 710 steps) and
the compiled ``examples/table_lookup.py``'s (B = 1, k+1 = 5, N = 256,
610 steps); and at GameOfLife's N=2048 shape (758 steps) where the
checkout's rule takes it.  Run it on two checkouts in turns (parent,
change, change, parent) in one call to compare them on one card.
Prints one JSON line and writes it to chiprun_out/NAME.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {
    "latency_b1": dict(batch=1, kp1=2, levels=4, n=1024, s_key=4,
                       base_log=5, n_small=710, limb_offset=4),
    "latency_b4": dict(batch=4, kp1=2, levels=4, n=1024, s_key=4,
                       base_log=5, n_small=710, limb_offset=4),
    "table_lookup": dict(batch=1, kp1=5, levels=3, n=256, s_key=4,
                         base_log=5, n_small=610, limb_offset=4),
    "gol_b1": dict(batch=1, kp1=2, levels=2, n=2048, s_key=5, base_log=7,
                   n_small=758, limb_offset=3),
}


def main() -> None:
    args = sys.argv[1:]
    name = "time_latency_kernel"
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
    from concrete_tpu_torch.core import limbs as lb
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import latency as lat
    t0 = time.perf_counter()
    _build.library()
    rec = {"root": root, "card": cs.card(), "build_s":
           time.perf_counter() - t0, "ms": {}}
    rng = np.random.default_rng(cs.SEED)
    for label, sh in SHAPES.items():
        batch, n, kp1 = sh["batch"], sh["n"], sh["kp1"]
        if lat.plan(batch, n, kp1, sh["levels"],
                    lb.num_digit_limbs(sh["base_log"]), sh["s_key"]) is None:
            rec["ms"][label] = None
            continue
        cin = sh["levels"] * kp1
        a_t = torch.from_numpy(rng.integers(0, 2 * n, (batch, sh["n_small"]))
                               .astype(np.int32)).cuda()
        acc = cs.rand_torus(rng, (kp1, batch, n), "cuda")
        planes = lat.with_tail(cs.rand_i8(
            rng, (sh["n_small"], cin, kp1, sh["s_key"], 2 * n - 1), "cuda"))
        kw = dict(kp1=kp1, levels=sh["levels"], base_log=sh["base_log"],
                  limb_offset=sh["limb_offset"])
        rec["ms"][label] = cs.cuda_ms(lambda: lat.blind_rotate_latency(
            a_t, acc, planes, **kw), 10)
    line = json.dumps(rec)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{name}.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
