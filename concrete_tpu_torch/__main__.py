"""concrete_tpu_torch command-line interface.

Counterpart of ``concrete_tpu/__main__.py`` (the analog of the reference's
`concretecompiler` CLI, compilers/concrete-compiler/compiler/src/main.cpp):
compile a decorated function from a Python file into a deployment archive,
inspect artifacts, generate keys, and run encrypted computations from the
shell.  The archive and key files are the JAX package's formats.

    python -m concrete_tpu_torch compile circuit.py --function f \
        --inputset 0:8 --output server.zip
    python -m concrete_tpu_torch inspect server.zip
    python -m concrete_tpu_torch keygen server.zip --output keys.bin
    python -m concrete_tpu_torch run server.zip --keys keys.bin --args 3,4

Every verb takes ``--device`` (default: the card, CUDA; it fails without
one): the device the compiled circuit's server is built for and ``run``
runs on; ``cpu`` runs the plain PyTorch path on the host.  ``compile``,
``inspect`` and ``keygen`` run nothing on the device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys


def _load_compiler(path: str, function: str):
    spec = importlib.util.spec_from_file_location("user_circuit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    obj = getattr(mod, function)
    from concrete_tpu_torch.compilation.compiler import Compiler
    if not isinstance(obj, Compiler):
        raise SystemExit(
            f"{function} is not an @fhe.compiler-decorated function")
    return obj


def _parse_inputset(spec: str):
    # "0:8" -> range, "0:8,0:4" -> product of ranges (two args)
    parts = spec.split(",")
    ranges = []
    for p in parts:
        lo, hi = p.split(":")
        ranges.append(range(int(lo), int(hi)))
    if len(ranges) == 1:
        return list(ranges[0])
    import itertools
    return list(itertools.product(*ranges))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="concrete_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compile", help="compile a circuit to an archive")
    c.add_argument("file")
    c.add_argument("--function", required=True)
    c.add_argument("--inputset", required=True,
                   help="e.g. 0:8 or 0:8,0:4 for two args")
    c.add_argument("--output", default="server.zip")

    i = sub.add_parser("inspect", help="show archive statistics")
    i.add_argument("archive")

    k = sub.add_parser("keygen", help="generate keys for an archive")
    k.add_argument("archive")
    k.add_argument("--output", default="keys.bin")
    k.add_argument("--seed", type=int, default=None)

    r = sub.add_parser("run", help="encrypt+run+decrypt against an archive")
    r.add_argument("archive")
    r.add_argument("--keys", required=True)
    r.add_argument("--args", required=True, help="comma-separated integers")

    for verb in (c, i, k, r):
        verb.add_argument("--device", default=None,
                          help="torch device (default: CUDA, which must be "
                               "available; 'cpu' for the host)")

    args = ap.parse_args(argv)

    from concrete_tpu_torch.compilation.client import Client
    from concrete_tpu_torch.compilation.keys import Keys
    from concrete_tpu_torch.compilation.server import Server
    from concrete_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)

    if args.cmd == "compile":
        comp = _load_compiler(args.file, args.function)
        circuit = comp.compile(_parse_inputset(args.inputset), device=device)
        circuit.server.save(args.output)
        print(f"compiled {args.function} -> {args.output} "
              f"(precision {circuit.client_specs.message_bits} bits, "
              f"{circuit.programmable_bootstrap_count} PBS)")
        return 0

    server = Server.load(args.archive, device=device)
    specs = server.client_specs

    if args.cmd == "inspect":
        print(json.dumps({
            "message_bits": specs.message_bits,
            "inputs": [str(v) for v in specs.inputs],
            "outputs": [str(v) for v in specs.outputs],
            "params": {"n_small": specs.params.n_small,
                       "glwe_dimension": specs.params.glwe_dimension,
                       "polynomial_size": specs.params.polynomial_size},
            "pbs_count": server.programmable_bootstrap_count(),
            "complexity_macs": server.complexity,
        }, indent=2))
        return 0

    if args.cmd == "keygen":
        keys = Keys(specs.params)
        keys.generate(args.seed, device=device)
        keys.save(args.output)
        print(f"keys -> {args.output}")
        return 0

    if args.cmd == "run":
        keys = Keys(specs.params)
        keys.load(args.keys)
        client = Client(specs, keys)
        values = [int(v) for v in args.args.split(",")]
        enc = client.encrypt(*values)
        if len(specs.inputs) == 1:
            enc = (enc,)
        out = server.run(*enc, evaluation_keys=keys.evaluation_for(
            specs.message_bits, device=device))
        dec = client.decrypt(*out)
        print(dec)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
