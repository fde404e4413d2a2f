"""The port's limb sharding (parallel/limb_sharding.py) against the JAX
package's ``core/ntt_tpu.py`` and ``pbs_batch``, on the CPU, bit for bit.

One spawn per mesh size D = 1, 2 and 4 (gloo ranks that import only the
port, ``torch_ranks.spawn``) runs the limb-sharded external product, blind
rotate and full PBS at ``TEST_PARAMS_TINY`` (N=64: n1 = n2 = 8), the keys
packed on rank 0 and broadcast; every rank's output must equal the JAX
package's single-device result, and each rank holds its k1 block of the
BSK spectra, (primes, n, Cin, k+1, n1/D, n2).  The cases of
``tests/test_limb_sharding.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import kernels as JK
from concrete_tpu.core import ntt_tpu as jnt
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY as P
from concrete_tpu.parallel import limb_sharding as jls

from torch_ranks import spawn
from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.parallel import limb_sharding as tls

BITS = 3
TABLE = np.array([(2 * v + 1) % 8 for v in range(8)], dtype=np.uint64)
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def reference():
    """The inputs and the JAX package's single-device results."""
    rng = np.random.default_rng(5)
    n, k, l = P.polynomial_size, P.glwe_dimension, P.pbs_level
    cin = l * (k + 1)
    primes = jnt.choose_primes(P)
    ext_bsk = rng.integers(0, 1 << 64, (3, l, k + 1, k + 1, n),
                           dtype=np.uint64)
    digits = rng.integers(-(1 << (P.pbs_base_log - 1)),
                          1 << (P.pbs_base_log - 1),
                          (3, cin, n)).astype(np.int32)
    ext = np.asarray(jax.jit(jnt.external_product_ntt, static_argnums=(
        2, 3))(jnp.asarray(digits), jnt.pack_bsk_ntt(ext_bsk, P).spectra[:, 1],
               primes, P))
    sk, server = jkg.keygen(rng, P)
    nbsk = jnt.pack_bsk_ntt(server.bsk, P)
    lut_poly = jref.encode_expand_lut(TABLE, n, BITS)
    msgs_small = rng.integers(0, 8, 2)
    ct_small = jkg.encrypt_lwe_batch(rng, sk.lwe_small,
                                     jref.encode(msgs_small, BITS),
                                     P.lwe_std)
    acc = np.asarray(jax.jit(jnt.blind_rotate_ntt, static_argnums=(3,))(
        jnp.asarray(ct_small), nbsk, jnp.asarray(lut_poly), P))
    msgs = rng.integers(0, 8, 4)
    ct_big = jkg.encrypt_lwe_batch(rng, sk.lwe_big, jref.encode(msgs, BITS),
                                   P.lwe_std / 1024)
    pbs = np.asarray(jax.jit(JK.pbs_batch, static_argnums=(4, 5))(
        jnp.asarray(ct_big), JK.pack_ksk(server.ksk, P),
        JK.pack_bsk(server.bsk, P), jnp.asarray(lut_poly), P, BITS))
    inputs = {"ext_bsk": ext_bsk, "digits": digits, "ksk": server.ksk,
              "bsk": server.bsk, "lut_poly": lut_poly, "ct_small": ct_small,
              "ct_big": ct_big, "bits": BITS}
    return {"inputs": inputs, "ext": ext, "acc": acc, "pbs": pbs,
            "spectra": np.asarray(nbsk.spectra), "sk": sk, "msgs": msgs,
            "primes": primes}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """world size -> every rank's outputs, one spawn each, all at once."""
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(spawn, "limb", w,
                               tmp_path_factory.mktemp(f"limb{w}"),
                               reference["inputs"]) for w in WORLDS}
        return {w: run.result() for w, run in runs.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_external_product_matches_reference(ranks, reference, world):
    for out in ranks[world]:
        assert np.array_equal(out["ext"], reference["ext"])


@pytest.mark.parametrize("world", WORLDS)
def test_blind_rotate_matches_reference(ranks, reference, world):
    for out in ranks[world]:
        assert np.array_equal(out["acc"], reference["acc"])


@pytest.mark.parametrize("world", WORLDS)
def test_full_pbs_matches_reference_and_decrypts(ranks, reference, world):
    for out in ranks[world]:
        assert np.array_equal(out["pbs"], reference["pbs"])
    dec = jref.decode(jref.lwe_decrypt(reference["sk"].lwe_big,
                                       ranks[world][0]["pbs"]), BITS)
    assert np.array_equal(dec, TABLE[reference["msgs"]])


@pytest.mark.parametrize("world", WORLDS)
def test_spectrum_shard_is_the_ranks_k1_block(ranks, reference, world):
    plan = jnt.build_plan(P.polynomial_size, reference["primes"][0])
    n1, n2, blk = plan.n1, plan.n2, plan.n1 // world
    full = reference["spectra"].reshape(
        reference["spectra"].shape[:-1] + (n1, n2))
    for rank, out in enumerate(ranks[world]):
        shard = out["shard"]
        assert shard.shape == full.shape[:-2] + (blk, n2)
        assert np.array_equal(shard.astype(np.uint32),
                              full[..., rank * blk:(rank + 1) * blk, :])


def test_check_limb_shardable_matches_reference(ranks):
    for d in (1, 2, 4, 8, 16):
        assert tls.check_limb_shardable(P, d) == jls.check_limb_shardable(
            P, d)
    want = [jls.check_limb_shardable(P, d) for d in (1, 2, 4, 8, 16)]
    for outs in ranks.values():
        assert outs[0]["shardable"].tolist() == want
