"""The benchmark of concrete_tpu_torch on NVIDIA cards: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells are BENCHMARK.json's workloads.
A run sets the cell up (compile, keygen from the seed, the key pack, a
pool of encrypted requests, warm-up), drives a closed loop for the window,
judges every output against the plain reference, and prints one JSON line
as the last line of its standard output, the numbers it compared beside
their limits as the last lines of its standard error.  With --trace 1 the
line holds the per-layer metrics, read from a profiled stretch of the
window, and without it the end-to-end ones.  It writes a detail file
(set-up spans, the keys' own seconds, per-rank traces) to --detail.

Without the cards the cell asks for it exits with 2 and prints no result;
it exits with 3 if a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--detail", default=None,
                   help="the run's detail file (default: perfbench_runs/ "
                        "in the checkout)")
    # a rank of a several-card cell, started by rank 0 (perfbench/ranks.py)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    # a CPU rehearsal (the tests): JSON of an insecure parameter set's
    # name and a request shape; no metric is read
    p.add_argument("--rehearse", default=None, help=argparse.SUPPRESS)
    # the control of the comparison that decides `correct`: the window
    # served on a key one precision step below the program's truncation
    # rule (harness.control_key); the benchmark's own runs never set it
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import harness
    if not os.path.isdir(os.path.join(harness.ROOT, harness.PROGRAM)):
        print(f"no {harness.PROGRAM}/ beside perfbench/: nothing to "
              f"measure", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_spec(), args.workload)
    rehearse = json.loads(args.rehearse) if args.rehearse else None
    if not rehearse:
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); this "
                  f"machine shows "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    trace = bool(args.trace)
    from perfbench import ranks
    if args.rank > 0:
        ranks.run_rank(cell, args.rank, args.seed, args.seconds, trace,
                       args.port, T0, rehearse, control=bool(args.control))
        bad = harness.forbidden_modules()
        if bad:
            print(f"rank {args.rank} loaded {bad}", file=sys.stderr)
            return 3
        return 0
    detail = {"workload": cell.name, "seed": args.seed,
              "seconds": args.seconds, "trace": trace}
    control = bool(args.control)
    if cell.chips > 1:
        result = ranks.run_rank0(cell, args.seed, args.seconds, trace, T0,
                                 rehearse, detail, control)
    else:
        result = harness.run_one_chip(cell, args.seed, args.seconds, trace,
                                      T0, rehearse, detail, control)
    bad = sorted(set(detail.get("forbidden", []))
                 | set(harness.forbidden_modules()))
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    path = args.detail or os.path.join(
        harness.ROOT, "perfbench_runs",
        f"{cell.name}-s{args.seed}-t{int(trace)}"
        f"{'-control' if control else ''}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({**detail, "result": result}, f, indent=1, default=str)
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
