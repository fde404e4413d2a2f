"""The PyTorch port's kernels against the JAX package, bit for bit, on CPU.

Inputs come from numpy seeds and go through both packages; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas_*.py do.
On the CPU the port's wrappers run their kernels' plain PyTorch versions,
which are what these tests hold to the reference; the CUDA kernels are held
to those plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import concrete_tpu.jax_config  # noqa: F401
import jax
import jax.numpy as jnp

from concrete_tpu.core import kernels as kn
from concrete_tpu.core import limbs as jlb
from concrete_tpu.core import refimpl as ref
from concrete_tpu.ops import pallas_dot_recombine as pdr
from concrete_tpu.ops import pallas_step as ps
from concrete_tpu.params import (TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE,
                                 CryptoParams, choose_truncate_limbs)
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.core import limbs as tlb
from concrete_tpu_torch.ops import external_product as txp
from concrete_tpu_torch.ops import step as tstep


def t64(a) -> torch.Tensor:
    """u64 numpy -> int64 torch (same bits, own memory: the kernels
    update accumulators in place)."""
    return torch.from_numpy(
        np.asarray(a, dtype=np.uint64).view(np.int64).copy())


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


@pytest.mark.parametrize("base_log,levels", [(5, 4), (12, 2), (2, 8),
                                             (23, 1), (8, 7), (1, 63)])
def test_decompose(base_log, levels):
    v = rand_u64(np.random.default_rng(base_log), (6, 64))
    got = tk.decompose(t64(v), base_log, levels).numpy()
    assert np.array_equal(got, np.asarray(kn.decompose(jnp.asarray(v),
                                                       base_log, levels)))
    assert np.array_equal(got, ref.decompose(v, base_log, levels))


@pytest.mark.parametrize("base_log,levels", [(5, 4), (2, 8), (12, 2),
                                             (31, 1)])
def test_decompose_hi32(base_log, levels):
    v = rand_u64(np.random.default_rng(levels), (6, 64))
    v[0, :4] = [0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF00000000, 0x7FFFFFFFFFFFFFFF, 0]
    got = tk.decompose_hi32(t64(v), base_log, levels).numpy()
    assert np.array_equal(got, np.asarray(kn.decompose_hi32(
        jnp.asarray(v), base_log, levels)))
    assert np.array_equal(got, ref.decompose(v, base_log, levels))


@pytest.mark.parametrize("log2n", [6, 8, 10])
def test_modulus_switch(log2n):
    v = rand_u64(np.random.default_rng(log2n), (5, 33))
    got = tk.modulus_switch(t64(v), log2n).numpy()
    assert np.array_equal(got, np.asarray(kn.modulus_switch(
        jnp.asarray(v), log2n)))
    assert np.array_equal(got.astype(np.uint64), ref.modulus_switch(v, log2n))


def test_monomial_mul():
    rng = np.random.default_rng(3)
    polys = rand_u64(rng, (7, 64))
    r = rng.integers(0, 128, 7).astype(np.int32)
    r[:3] = [0, 64, 127]
    got = u64(tk.monomial_mul_batch(t64(polys), torch.from_numpy(r)))
    assert np.array_equal(got, np.asarray(kn.monomial_mul_batch(
        jnp.asarray(polys), jnp.asarray(r))))
    for i in range(7):
        assert np.array_equal(got[i], ref.monomial_mul(polys[i], int(r[i])))


@pytest.mark.parametrize("signed", [False, True])
def test_encode_expand_lut(signed):
    rng = np.random.default_rng(4)
    table = rng.integers(-40, 40, 16)
    got = u64(tk.encode_expand_lut(torch.from_numpy(table), 256, 4, 5,
                                   signed=signed))
    assert np.array_equal(got, np.asarray(kn.encode_expand_lut_jnp(
        jnp.asarray(table), 256, 4, 5, signed=signed)))
    wrapped = (table & ((1 << 6) - 1)).astype(np.uint64)
    assert np.array_equal(got, ref.encode_expand_lut(
        wrapped, 256, 4, signed=signed, out_bits=5))


@pytest.mark.parametrize("index", [0, 5])
def test_sample_extract(index):
    acc = rand_u64(np.random.default_rng(index), (3, 3, 64))
    got = u64(tk.sample_extract(t64(acc), index))
    assert np.array_equal(got, np.asarray(kn.sample_extract(
        jnp.asarray(acc), index)))
    assert np.array_equal(got, ref.sample_extract(acc, index))


@pytest.mark.parametrize("truncate", [0, 4])
def test_pack_keys(truncate):
    rng = np.random.default_rng(5)
    p = TEST_PARAMS_TINY
    bsk = rand_u64(rng, (3, p.pbs_level, 3, 3, p.polynomial_size))
    ksk = rand_u64(rng, (10, p.ks_level, 5))
    assert np.array_equal(tk.pack_bsk(bsk, p, truncate).planes.numpy(),
                          np.asarray(kn.pack_bsk(bsk, p, truncate).planes))
    assert np.array_equal(tk.pack_ksk(ksk, p).planes.numpy(),
                          np.asarray(kn.pack_ksk(ksk, p).planes))


@pytest.mark.parametrize("ks_level,ks_base_log", [(2, 8), (8, 2), (4, 10)])
def test_keyswitch(ks_level, ks_base_log):
    rng = np.random.default_rng(ks_level)
    p = CryptoParams(n_small=16, glwe_dimension=1, polynomial_size=64,
                     pbs_level=2, pbs_base_log=12, ks_level=ks_level,
                     ks_base_log=ks_base_log, lwe_std=0.0, glwe_std=0.0,
                     security_level=0)
    ksk = rand_u64(rng, (64, ks_level, 17))
    ct = rand_u64(rng, (9, 65))
    got = u64(tk.keyswitch(t64(ct), tk.pack_ksk(ksk, p)))
    assert np.array_equal(got, np.asarray(kn.keyswitch(
        jnp.asarray(ct), kn.pack_ksk(ksk, p))))
    assert np.array_equal(got, ref.keyswitch(ct, ksk, ks_base_log, ks_level))


@pytest.mark.parametrize("base_log,levels", [(5, 4), (12, 2), (23, 1),
                                             (8, 2)])
def test_rotate_decompose_plain(base_log, levels):
    """Kernel A's plain version == rotate_decompose_limbs (and the _hi
    variant wherever the accumulator's low word is zero)."""
    rng = np.random.default_rng(base_log)
    rows, n = 8, 128
    a_limbs = jlb.num_digit_limbs(base_log)
    acc = rand_u64(rng, (rows, n))
    a_rows = rng.integers(0, 2 * n, rows).astype(np.int32)
    got = tstep.rotate_decompose(t64(acc), torch.from_numpy(a_rows),
                                 base_log=base_log, levels=levels,
                                 a_limbs=a_limbs).numpy()
    lo, hi = ps.split_u64(jnp.asarray(acc))
    want = ps.rotate_decompose_limbs(lo, hi, jnp.asarray(a_rows),
                                     base_log=base_log, levels=levels,
                                     a_limbs=a_limbs, interpret=True)
    assert np.array_equal(got, np.stack([np.asarray(w) for w in want]))
    if ps.digits_lo_free(base_log, levels):
        acc_hi = acc & np.uint64(0xFFFFFFFF00000000)
        got = tstep.rotate_decompose(t64(acc_hi), torch.from_numpy(a_rows),
                                     base_log=base_log, levels=levels,
                                     a_limbs=a_limbs).numpy()
        want = ps.rotate_decompose_limbs_hi(
            ps.split_u64(jnp.asarray(acc_hi))[1], jnp.asarray(a_rows),
            base_log=base_log, levels=levels, a_limbs=a_limbs,
            interpret=True)
        assert np.array_equal(got, np.stack([np.asarray(w) for w in want]))


# built eagerly, the Toeplitz rhs is hundreds of small slice ops
_build_fused_rhs = jax.jit(pdr.build_fused_rhs, static_argnums=(1, 2),
                           static_argnames=("a_limbs",))
_banded_fused = jax.jit(kn.negacyclic_banded_matmul_fused,
                        static_argnums=(2,), static_argnames=("out_planes",))


def _reference_lhs(planes, levels, a_limbs, kp1, b):
    """The JAX blind rotate's lhs construction (_blind_rotate_pallas)."""
    n = planes.shape[-1]
    lhs_list = [np.concatenate([planes[lev * a_limbs + a].reshape(b, kp1, n)
                                for lev in range(levels)], axis=1)
                .reshape(b, levels * kp1 * n) for a in range(a_limbs)]
    return lhs_list, np.concatenate(lhs_list, axis=1)


@pytest.mark.parametrize("a_limbs", [1, 2])
@pytest.mark.parametrize("limb_offset", [0, 4])
@pytest.mark.parametrize("levels,kp1,keep,n,b", [(4, 2, 4, 256, 16),
                                                 (2, 2, 3, 128, 8)])
def test_external_product_plain(levels, kp1, keep, n, b, limb_offset,
                                a_limbs):
    """Kernel B's plain version == dot_recombine, the shipped fused-dot +
    recombine_accumulate composition, and (acc lo = 0, offset 4)
    dot_recombine_hi."""
    rng = np.random.default_rng(17 * a_limbs + limb_offset + n)
    cin = levels * kp1
    s_planes = 8 - limb_offset
    vv = rng.integers(-128, 128, (cin, kp1, s_planes, 2 * n - 1)) \
        .astype(np.int8)
    planes = rng.integers(-128, 128, (levels * a_limbs, b * kp1, n)) \
        .astype(np.int8)
    acc = rand_u64(rng, (b * kp1, n))
    lhs_list, lhs = _reference_lhs(planes, levels, a_limbs, kp1, b)
    s_keep = min(keep, s_planes + a_limbs - 1)

    got = t64(acc)
    txp.external_product_accumulate(torch.from_numpy(planes),
                                    torch.from_numpy(vv), got, keep=keep,
                                    limb_offset=limb_offset)
    lo, hi = ps.split_u64(jnp.asarray(acc))
    rhs = _build_fused_rhs(jnp.asarray(vv), 128, s_keep, a_limbs=a_limbs)
    lo2, hi2 = pdr.dot_recombine(
        jnp.asarray(lhs), rhs, lo.reshape(b, kp1 * n),
        hi.reshape(b, kp1 * n), keep=s_keep, limb_offset=limb_offset,
        block_b=b, block_k=a_limbs * cin * n, interpret=True)
    want = np.asarray(ps.merge_u64(lo2, hi2)).reshape(b * kp1, n)
    assert np.array_equal(u64(got), want)

    fused = _banded_fused(
        [jnp.asarray(x) for x in lhs_list], jnp.asarray(vv), 128,
        out_planes=keep)
    lo3, hi3 = ps.recombine_accumulate(
        fused.reshape(b * kp1, -1, n), lo, hi, limb_offset=limb_offset,
        interpret=True)
    assert np.array_equal(u64(got), np.asarray(ps.merge_u64(lo3, hi3)))

    if limb_offset == 4:
        acc_hi = acc & np.uint64(0xFFFFFFFF00000000)
        got = t64(acc_hi)
        txp.external_product_accumulate(torch.from_numpy(planes),
                                        torch.from_numpy(vv), got,
                                        keep=keep, limb_offset=limb_offset)
        segs = [jnp.asarray(planes[lev * a_limbs + a].reshape(b, kp1 * n))
                for a in range(a_limbs) for lev in range(levels)]
        hi4 = pdr.dot_recombine_hi(
            segs, rhs, ps.split_u64(jnp.asarray(acc_hi))[1].reshape(
                b, kp1 * n), keep=s_keep, limb_offset=limb_offset,
            block_b=b, interpret=True)
        want = (np.asarray(hi4).astype(np.uint64) << np.uint64(32)) \
            .reshape(b * kp1, n)
        assert np.array_equal(u64(got), want)


def _keys(params, seed):
    return ref.keygen(np.random.default_rng(seed), params)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("truncate", [0, 3, "acc32"])
@pytest.mark.parametrize("params", [TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE],
                         ids=["tiny", "tiny_wide"])
def test_pbs_batch(params, truncate, signed):
    """pbs_batch (and so blind_rotate) == the JAX package's pbs_batch (XLA
    on CPU, six ciphertexts: its throughput path) and, for the untruncated
    BSK, refimpl.pbs.  "acc32" is the truncation keys get here, which
    makes the TPU run its hi-word kernels."""
    p_bits = 3
    sk, server = _keys(params, params.polynomial_size + signed)
    rng = np.random.default_rng(7)
    msgs = rng.integers(-4 if signed else 0, 4 if signed else 8, 6)
    ct = ref.lwe_encrypt(rng, sk.lwe_big, ref.encode(msgs, p_bits),
                         params.glwe_std)
    table = np.array([(3 * v + 1) % 8 for v in range(8)], dtype=np.uint64)
    lut_poly = ref.encode_expand_lut(table, params.polynomial_size, p_bits,
                                     signed=signed)
    if truncate == "acc32":
        truncate = choose_truncate_limbs(params, p_bits)
        assert truncate == 4 and ps.digits_lo_free(params.pbs_base_log,
                                                   params.pbs_level)
    got = u64(tk.pbs_batch(
        t64(ct), tk.pack_ksk(server.ksk, params),
        tk.pack_bsk(server.bsk, params, truncate), t64(lut_poly), params,
        p_bits, signed=signed))
    want = np.asarray(kn.pbs_batch(
        jnp.asarray(ct), kn.pack_ksk(server.ksk, params),
        kn.pack_bsk(server.bsk, params, truncate), jnp.asarray(lut_poly),
        params, p_bits, signed=signed))
    assert np.array_equal(got, want)
    if not truncate:
        for i in range(2):
            assert np.array_equal(got[i], ref.pbs(
                ct[i], server, table, params, p_bits, signed=signed))
