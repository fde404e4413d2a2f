"""Write the deployment archives that the PyTorch port serves.

- ``table_sub_u4_b1024.zip``: ``table[x] - y`` with
  ``table = [(3v + 1) % 16]`` over two encrypted ``(1024,)`` tensors,
  compiled with the default ``Configuration()``: 128-bit parameters with
  N = 1024, so every request is 1024 table lookups through the banded
  blind rotate.
- ``mlp_q2_b64.zip``: the repo's benchmark ``QuantizedMLP()`` (d_in=8,
  d_hidden=4, d_out=2, 2-bit weights and activations, ``bench.py``'s
  ``bench_mlp``) over a batch of 64 samples, default ``Configuration()``:
  128-bit parameters with N = 4096 and 6-bit messages, so every request is
  256 lookups through the fused CRT-NTT blind rotate.

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [out_dir]

writes both into ``concrete_tpu_torch/fixtures/`` by default.
``tests/test_torch_server.py`` recompiles each circuit through
``compile_circuit`` / ``compile_mlp`` and checks that the committed
archives are reproduced.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "concrete_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "table_sub_u4_b1024.zip")
MLP_FIXTURE = os.path.join(FIXTURES, "mlp_q2_b64.zip")
SIZE = 1024
TABLE = [(3 * v + 1) % 16 for v in range(16)]
MLP_BATCH = 64


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


def compile_mlp():
    import concrete_tpu as fhe
    from concrete_tpu.models import QuantizedMLP
    return QuantizedMLP().compile(fhe.Configuration(), batch_size=MLP_BATCH)


def main(out_dir: str = FIXTURES) -> None:
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(out_dir, exist_ok=True)
    for name, compile_fn in ((FIXTURE, compile_circuit),
                             (MLP_FIXTURE, compile_mlp)):
        path = os.path.join(out_dir, os.path.basename(name))
        circuit = compile_fn()
        circuit.server.save(path)
        print(path, os.path.getsize(path), "bytes")
        print(circuit.server.client_specs.params)


if __name__ == "__main__":
    main(*sys.argv[1:])
