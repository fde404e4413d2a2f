"""Write the deployment archive that the PyTorch port serves.

The circuit is ``table[x] - y`` with ``table = [(3v + 1) % 16]`` over two
encrypted ``(1024,)`` tensors, compiled by the JAX package with the default
``Configuration()``: the optimizer picks 128-bit parameters with N = 1024,
so every request is 1024 table lookups through the banded blind rotate.

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [out.zip]

writes ``concrete_tpu_torch/fixtures/table_sub_u4_b1024.zip`` by default.
``tests/test_torch_server.py`` recompiles the circuit through
``compile_circuit`` and checks that the committed archive is reproduced.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "concrete_tpu_torch", "fixtures",
                       "table_sub_u4_b1024.zip")
SIZE = 1024
TABLE = [(3 * v + 1) % 16 for v in range(16)]


def inputset():
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 16, SIZE), rng.integers(0, 16, SIZE))
             for _ in range(4)]
    ramp = np.arange(SIZE) % 16
    return pairs + [(ramp, ramp)]


def compile_circuit():
    import concrete_tpu as fhe
    table = fhe.LookupTable(TABLE)

    @fhe.compiler({"x": "encrypted", "y": "encrypted"})
    def table_sub(x, y):
        return table[x] - y

    return table_sub.compile(inputset(), fhe.Configuration())


def main(path: str = FIXTURE) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    circuit = compile_circuit()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    circuit.server.save(path)
    print(path, os.path.getsize(path), "bytes")
    print(circuit.server.client_specs.params)


if __name__ == "__main__":
    main(*sys.argv[1:])
