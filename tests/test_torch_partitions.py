"""The port's ``core/partitions.py`` against the JAX package's, on CPU.

The cases of ``tests/test_partitions.py``: keysets for a TINY and a
TINY_WIDE partition with conversion keys both ways, from one numpy seed in
each package (the same keys), and cross-partition lookups through them.
Every output ciphertext of ``cross_partition_pbs`` equals the JAX
package's bit for bit, then decrypts to the table's value; the precision
guard refuses the same input.  The port runs with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest

from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import partitions as jpt
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.core import limbs as tlb
from concrete_tpu_torch.core import partitions as tpt
from concrete_tpu_torch.params import CryptoParams as TParams

SPECS = {"small": (TEST_PARAMS_TINY, 3), "big": (TEST_PARAMS_TINY_WIDE, 6)}
CONVERSIONS = [("small", "big"), ("big", "small")]


def _tparams(p):
    return TParams(**dataclasses.asdict(p))


@pytest.fixture(scope="module")
def keysets():
    """(encryption rng, JAX keyset, port keyset), both from seed 77."""
    jks = jpt.keygen_partitioned(np.random.default_rng(77), SPECS,
                                 CONVERSIONS)
    tks = tpt.keygen_partitioned(
        np.random.default_rng(77),
        {k: (_tparams(p), b) for k, (p, b) in SPECS.items()}, CONVERSIONS,
        device="cpu")
    return np.random.default_rng(78), jks, tks


def _encrypt(rng, part, xs, bits):
    return jkg.encrypt_lwe_batch(rng, part.secret.lwe_big,
                                 jref.encode(xs, bits),
                                 part.params.lwe_std / 64)


def _both(jks, tks, src, dst, ct, table, in_bits, out_bits):
    """cross_partition_pbs in both packages; their outputs must be equal."""
    want = jpt.cross_partition_pbs(jks, src, dst, ct, table,
                                   in_bits=in_bits, out_bits=out_bits)
    got = tpt.cross_partition_pbs(tks, src, dst, ct, table,
                                  in_bits=in_bits, out_bits=out_bits)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, np.asarray(want))
    return got


def test_keygen_partitioned_matches_reference(keysets):
    """The same numpy seed gives the same keys in both packages, and the
    conversion keys pack to the same limb planes at the destination's
    keyswitch gadget."""
    _, jks, tks = keysets
    for name in SPECS:
        jp, tp = jks.partition(name), tks.partition(name)
        for field in ("lwe_small", "glwe"):
            np.testing.assert_array_equal(getattr(tp.secret, field),
                                          getattr(jp.secret, field))
        for field in ("bsk", "ksk"):
            np.testing.assert_array_equal(getattr(tp.server, field),
                                          getattr(jp.server, field))
    for key in CONVERSIONS:
        jk, tk = jks.conversion[key], tks.conversion[key]
        assert (tk.base_log, tk.levels) == (jk.base_log, jk.levels) \
            == (SPECS[key[1]][0].ks_base_log, SPECS[key[1]][0].ks_level)
        assert tk.device.type == "cpu"
        np.testing.assert_array_equal(tk.planes.numpy(),
                                      np.asarray(jk.planes))
    # the partitions' own keys pack for the card's layout on demand
    ksk, _ = tks.partition("big").packed()
    np.testing.assert_array_equal(
        ksk.planes.numpy(),
        tlb.u64_to_balanced_i8(jks.partition("big").server.ksk))


def test_cross_partition_square(keysets):
    """3-bit values in partition 'small' -> v^2 (6 bits) in partition
    'big', bit-equal to the JAX package's."""
    rng, jks, tks = keysets
    a, b = jks.partition("small"), jks.partition("big")
    xs = np.arange(8)
    table = np.array([v * v for v in range(8)])
    for _ in range(3):
        ct = _encrypt(rng, a, xs, a.message_bits)
        out = _both(jks, tks, "small", "big", ct, table, 3, 6)
        dec = jref.decode(jref.lwe_decrypt(b.secret.lwe_big, out), 6)
        if np.array_equal(dec, xs * xs):
            return
    raise AssertionError(dec)


def test_round_trip_partitions(keysets):
    """small -> big -> small keeps values intact (mod 8 on the way back),
    each crossing bit-equal to the JAX package's."""
    rng, jks, tks = keysets
    a = jks.partition("small")
    xs = np.arange(8)
    up_table = np.array([(5 * v) % 8 for v in range(8)])
    down_table = np.array([(v + 1) % 8 for v in range(8)])
    for _ in range(4):
        ct = _encrypt(rng, a, xs, a.message_bits)
        up = _both(jks, tks, "small", "big", ct, up_table, 3, 3)
        down = _both(jks, tks, "big", "small", up, down_table, 3, 3)
        dec = jref.decode(jref.lwe_decrypt(a.secret.lwe_big, down), 3)
        if np.array_equal(dec, ((5 * xs) % 8 + 1) % 8):
            return
    raise AssertionError(dec)


def test_partition_precision_guard(keysets):
    rng, jks, tks = keysets
    ct = _encrypt(rng, jks.partition("small"), 0, 3)
    for pt, ks in ((jpt, jks), (tpt, tks)):
        with pytest.raises(ValueError, match="cannot"):
            pt.cross_partition_pbs(ks, "big", "small", ct[None],
                                   np.arange(64), in_bits=6, out_bits=3)
