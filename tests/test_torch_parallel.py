"""The port's batch sharding (parallel/sharding.py, parallel/distributed.py)
against the JAX package, on the CPU, bit for bit.

Two gloo ranks (``torch_ranks.spawn``: spawned processes that import only
the port, joined through a file store under the test's tmp_path) run a
sharded PBS on keys from the JAX package's keygen, with the keys packed on
rank 0 and broadcast (``replicate_keys``), and a compiled circuit on the
shards of a batch; the outputs, gathered on every rank, must equal the
JAX package's unsharded ``pbs_batch`` and ``Circuit.run``.  The cases of
``tests/test_parallel.py`` and ``tests/test_distributed_2proc.py``.  The
PBS's key is truncated and its 9 ciphertexts split 5 and 4: a shard of
``LATENCY_BATCH_MAX`` rows must still take the whole batch's blind rotate,
whose bits the latency form's would not equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import concrete_tpu as fhe
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import kernels as JK
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY as P

from torch_ranks import REPO, spawn
from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.parallel import distributed

BITS = 3
BATCH = 9                  # the PBS's: shards of 5 and 4
CIRCUIT_BATCH = 15         # the circuit's: shards of 8 and 7
TRUNCATE = 4               # the PBS key's limb truncation
TABLE = [(v + 3) % 8 for v in range(8)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks over every input; the JAX references."""
    rng = np.random.default_rng(3)
    sk, server = jkg.keygen(rng, P)
    lut = np.array([(3 * v + 1) % 8 for v in range(8)], dtype=np.uint64)
    lut_poly = jref.encode_expand_lut(lut, P.polynomial_size, BITS)
    msgs = rng.integers(0, 8, BATCH)
    ct = jkg.encrypt_lwe_batch(rng, sk.lwe_big, jref.encode(msgs, BITS),
                               P.lwe_std / 1024)
    want = np.asarray(jax.jit(JK.pbs_batch, static_argnums=(4, 5))(
        jnp.asarray(ct), JK.pack_ksk(server.ksk, P),
        JK.pack_bsk(server.bsk, P, TRUNCATE), jnp.asarray(lut_poly), P, BITS))

    table = fhe.LookupTable(TABLE)

    @fhe.compiler({"x": "encrypted"})
    def f(x):
        return table[x] + 1

    inputset = [rng.integers(0, 8, CIRCUIT_BATCH) for _ in range(4)]
    circuit = f.compile(inputset, fhe.Configuration(forced_parameters=P))
    circuit.keygen(seed=13)
    cmsgs = rng.integers(0, 8, CIRCUIT_BATCH)
    cct = np.asarray(circuit.encrypt(cmsgs))
    circuit_want = np.asarray(circuit.run(cct))
    outs = spawn("batch", 2, tmp_path_factory.mktemp("batch"), {
        "ksk": server.ksk, "bsk": server.bsk, "lut_poly": lut_poly,
        "ct": ct, "bits": BITS, "truncate": TRUNCATE,
        "table": np.array(TABLE),
        "inputset": np.stack(inputset), "seed": 13, "circuit_ct": cct})
    return {"outs": outs, "want": want, "sk": sk, "msgs": msgs, "lut": lut,
            "circuit": circuit, "cmsgs": cmsgs,
            "circuit_want": circuit_want}


def test_sharded_pbs_matches_unsharded_reference(two_ranks):
    want = two_ranks["want"]
    for out in two_ranks["outs"]:         # gathered on every rank
        assert out["pbs"].dtype == np.uint64
        assert np.array_equal(out["pbs"], want)
    dec = jref.decode(jref.lwe_decrypt(two_ranks["sk"].lwe_big, want), BITS)
    assert np.array_equal(dec, two_ranks["lut"][two_ranks["msgs"]])


def test_shards_split_the_batch_and_keys_replicate(two_ranks):
    outs = two_ranks["outs"]
    assert [int(o["shard_rows"]) for o in outs] == [5, 4]
    assert [int(o["circuit_shard_rows"]) for o in outs] == [8, 7]
    # rank 1 received rank 0's packed keys, equal to its own pack
    assert all(bool(o["keys_equal"]) for o in outs)


def test_sharded_circuit_run_matches_reference(two_ranks):
    want = two_ranks["circuit_want"]
    for out in two_ranks["outs"]:
        assert np.array_equal(out["circuit"], want)
    got = two_ranks["circuit"].decrypt(two_ranks["outs"][0]["circuit"])
    assert np.array_equal(got, (two_ranks["cmsgs"] + 3) % 8 + 1)


@pytest.mark.parametrize("batch", [10, 3, 12])
def test_local_batch_slice_covers_every_element(batch):
    covered = []
    for rank in range(3):
        s = distributed.local_batch_slice(batch, 3, rank)
        covered.extend(range(s.start, s.stop))
    assert covered == list(range(batch))


def test_single_process_defaults():
    assert not distributed.initialize()        # no WORLD_SIZE: a no-op
    assert distributed.local_batch_slice(7) == slice(0, 7)
    report = distributed.scaling_report(100.0, 90.0)
    assert report["devices"] == 1 and report["hosts"] == 1
    assert report["scaling_efficiency"] == pytest.approx(0.9)
    assert distributed.device_for_rank("cpu").type == "cpu"


def test_parallel_modules_import_no_jax():
    """A fresh interpreter importing the port's distribution modules loads
    no jax and nothing of the JAX package."""
    code = ("import sys\n"
            "import concrete_tpu_torch.parallel\n"
            "from concrete_tpu_torch.parallel import distributed, sharding, "
            "limb_sharding\n"
            "from concrete_tpu_torch.core import ntt_fourstep\n"
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'concrete_tpu')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
