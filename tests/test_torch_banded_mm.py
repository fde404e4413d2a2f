"""Kernel 9 (banded matmul), the standalone recombine-accumulate, the
banded-matmul modes and the latency blind rotate of the PyTorch port,
against the JAX package, bit for bit, on the CPU.

Inputs come from numpy seeds and go through both packages.  The JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas_step.py
does.  On the CPU the port's wrappers run their kernels' plain PyTorch
versions; chip_smoke.py holds the CUDA kernels to those on the card.  All
of it is integer arithmetic, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import concrete_tpu.jax_config  # noqa: F401
import jax.numpy as jnp

from concrete_tpu.core import kernels as kn
from concrete_tpu.core import refimpl as ref
from concrete_tpu.ops import pallas_step as ps
from concrete_tpu.ops.pallas_banded_mm import banded_matmul_fused
from concrete_tpu.params import (TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE,
                                 choose_truncate_limbs)
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.ops import banded_mm as tbm
from concrete_tpu_torch.ops import recombine as trc


def t64(a) -> torch.Tensor:
    """u64 numpy -> int64 torch (same bits, own memory)."""
    return torch.from_numpy(
        np.asarray(a, dtype=np.uint64).view(np.int64).copy())


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def rand_i8(rng, shape) -> np.ndarray:
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("cin,cout,s_limbs,a_limbs,n", [
    (2, 2, 6, 1, 256), (3, 3, 6, 3, 256), (2, 1, 3, 2, 128)])
def test_banded_matmul_plain_matches_pallas(cin, cout, s_limbs, a_limbs, n):
    """banded_matmul_plain == banded_matmul_fused in interpret mode, at the
    shapes of the JAX package's own kernel test."""
    rng = np.random.default_rng(21)
    lhs = rand_i8(rng, (a_limbs, 8, cin * n))
    vv = rand_i8(rng, (cin, cout, s_limbs, 2 * n - 1))
    got = tbm.banded_matmul(torch.from_numpy(lhs), torch.from_numpy(vv))
    want = banded_matmul_fused([jnp.asarray(x) for x in lhs],
                               jnp.asarray(vv), 128, interpret=True, b_tile=8)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,cout,s_limbs,a_limbs,n", [
    (2, 1, 1, 4, 64), (2, 4, 2, 8, 128), (6, 2, 4, 1, 384)])
def test_banded_matmul_plain_latency_shapes(rows, cout, s_limbs, a_limbs, n):
    """The plain version == banded_matmul_fused in interpret mode at the
    latency path's shapes (k+1 rows, Cout = B, up to 8 lhs limbs), at
    N < 128 and at N a multiple of 128 above it."""
    rng = np.random.default_rng(rows * n + a_limbs)
    cin = 4
    lhs = rand_i8(rng, (a_limbs, rows, cin * n))
    vv = rand_i8(rng, (cin, cout, s_limbs, 2 * n - 1))
    got = tbm.banded_matmul(torch.from_numpy(lhs), torch.from_numpy(vv))
    want = banded_matmul_fused([jnp.asarray(x) for x in lhs],
                               jnp.asarray(vv), min(128, n), interpret=True,
                               b_tile=8)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("levels,kp1,a_limbs,n", [
    (4, 2, 1, 128), (3, 2, 2, 128), (1, 3, 2, 64)])
def test_banded_matmul_digit_planes_match_pallas(levels, kp1, a_limbs, n):
    """With `levels`, the lhs is kernel A's digit planes (l*A, B*(k+1), N)
    read in place; the result == banded_matmul_fused in interpret mode on
    the JAX package's per-limb concatenation of those planes."""
    rng = np.random.default_rng(60 + levels * kp1 + a_limbs)
    b_ct, s_limbs = 8, 4
    planes = rand_i8(rng, (levels * a_limbs, b_ct * kp1, n))
    vv = rand_i8(rng, (levels * kp1, kp1, s_limbs, 2 * n - 1))
    got = tbm.banded_matmul(torch.from_numpy(planes), torch.from_numpy(vv),
                            levels=levels)
    lhs_list = [np.concatenate(
        [planes[lev * a_limbs + a].reshape(b_ct, kp1, n)
         for lev in range(levels)], axis=1).reshape(b_ct, levels * kp1 * n)
        for a in range(a_limbs)]
    want = banded_matmul_fused([jnp.asarray(x) for x in lhs_list],
                               jnp.asarray(vv), min(128, n), interpret=True,
                               b_tile=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    stacked = tbm.stacked_lhs(torch.from_numpy(planes), kp1, levels)
    assert np.array_equal(stacked.numpy(), np.stack(lhs_list))


def test_banded_matmul_rejects_mismatched_operands():
    lhs = torch.zeros((1, 2, 3 * 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="does not match"):
        tbm.banded_matmul(lhs, torch.zeros((2, 1, 1, 127), dtype=torch.int8))
    with pytest.raises(ValueError, match="does not match"):
        tbm.banded_matmul(torch.zeros((4, 6, 64), dtype=torch.int8),
                          torch.zeros((3, 2, 1, 127), dtype=torch.int8),
                          levels=2)
    with pytest.raises(ValueError, match="unsupported device"):
        tbm.banded_matmul(lhs.to("meta"),
                          torch.zeros((3, 1, 1, 127), dtype=torch.int8))


@pytest.mark.parametrize("limb_offset", [0, 3, 4])
def test_recombine_accumulate_plain_matches_pallas(limb_offset):
    """The plain recombine_accumulate == ps.recombine_accumulate in
    interpret mode, planes kept to 8 - limb_offset as the JAX path cuts
    them."""
    rng = np.random.default_rng(40 + limb_offset)
    rows, n = 16, 128
    keep = 8 - limb_offset
    planes = rng.integers(-(1 << 31), 1 << 31, (rows, keep, n)) \
        .astype(np.int32)
    acc = rng.integers(0, 1 << 64, (rows, n), dtype=np.uint64)
    got = trc.recombine_accumulate(torch.from_numpy(planes), t64(acc),
                                   limb_offset=limb_offset)
    lo, hi = ps.split_u64(jnp.asarray(acc))
    lo2, hi2 = ps.recombine_accumulate(jnp.asarray(planes), lo, hi,
                                       limb_offset=limb_offset,
                                       interpret=True)
    assert np.array_equal(u64(got), np.asarray(ps.merge_u64(lo2, hi2)))


def test_recombine_accumulate_ignores_planes_past_64_bits():
    """Planes at shifts >= 64 add nothing: passing the uncut S+A-1 planes
    equals passing the kept ones (the port's banded step relies on it)."""
    rng = np.random.default_rng(3)
    planes = rng.integers(-(1 << 31), 1 << 31, (4, 6, 64)).astype(np.int32)
    acc = rng.integers(0, 1 << 64, (4, 64), dtype=np.uint64)
    full = trc.recombine_accumulate(torch.from_numpy(planes), t64(acc),
                                    limb_offset=4)
    cut = trc.recombine_accumulate(torch.from_numpy(planes[:, :4].copy()),
                                   t64(acc), limb_offset=4)
    assert torch.equal(full, cut)
    with pytest.raises(ValueError, match="limb_offset"):
        trc.recombine_accumulate(torch.from_numpy(planes), t64(acc),
                                 limb_offset=8)


def _keys(params, seed):
    return ref.keygen(np.random.default_rng(seed), params)


def _small_cts(params, server, sk, batch, seed, p_bits=3):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 1 << p_bits, batch)
    ct = ref.lwe_encrypt(rng, sk.lwe_big, ref.encode(msgs, p_bits),
                         params.glwe_std)
    return ref.keyswitch(ct, server.ksk, params.ks_base_log, params.ks_level)


@pytest.fixture(scope="module")
def wide_keys():
    return _keys(TEST_PARAMS_TINY_WIDE, 256)


@pytest.mark.parametrize("truncate", [0, 3])
@pytest.mark.parametrize("mode", tk.BANDED_MM_MODES)
def test_blind_rotate_modes_match_xla(mode, truncate, wide_keys,
                                      monkeypatch):
    """Every banded mode of the port's blind rotate == the JAX package's
    _blind_rotate_xla (six ciphertexts: the throughput path)."""
    params = TEST_PARAMS_TINY_WIDE
    sk, server = wide_keys
    ct_small = _small_cts(params, server, sk, 6, 11 + truncate)
    table = np.array([(3 * v + 1) % 8 for v in range(8)], dtype=np.uint64)
    lut_poly = ref.encode_expand_lut(table, params.polynomial_size, 3)
    monkeypatch.setattr(tk, "BANDED_MM_MODE", mode)
    got = u64(tk.blind_rotate(t64(ct_small),
                              tk.pack_bsk(server.bsk, params, truncate,
                                          device="cpu"),
                              t64(lut_poly), params))
    want = np.asarray(kn._blind_rotate_xla(
        jnp.asarray(ct_small), kn.pack_bsk(server.bsk, params, truncate),
        jnp.asarray(lut_poly), params))
    assert np.array_equal(got, want)


def test_unknown_banded_mode_raises(wide_keys, monkeypatch):
    params = TEST_PARAMS_TINY_WIDE
    sk, server = wide_keys
    ct_small = _small_cts(params, server, sk, 6, 1)
    monkeypatch.setattr(tk, "BANDED_MM_MODE", "dense")
    with pytest.raises(ValueError, match="unknown banded-matmul mode"):
        tk.blind_rotate(t64(ct_small),
                        tk.pack_bsk(server.bsk, params, device="cpu"),
                        t64(np.zeros(params.polynomial_size, np.uint64)),
                        params)


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("truncate", [0, 3, "acc32"])
@pytest.mark.parametrize("params", [TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE],
                         ids=["tiny", "tiny_wide"])
def test_pbs_batch_latency_matches_jax(params, truncate, batch):
    """pbs_batch at B <= LATENCY_BATCH_MAX == the JAX package's pbs_batch,
    which takes its latency blind rotate there; with a truncated key that
    path's bits differ from the throughput path's, so this fails unless
    the port follows it."""
    p_bits = 3
    sk, server = _keys(params, params.polynomial_size + 1)
    rng = np.random.default_rng(batch)
    msgs = rng.integers(0, 8, batch)
    ct = ref.lwe_encrypt(rng, sk.lwe_big, ref.encode(msgs, p_bits),
                         params.glwe_std)
    table = np.array([(5 * v + 2) % 8 for v in range(8)], dtype=np.uint64)
    lut_poly = ref.encode_expand_lut(table, params.polynomial_size, p_bits)
    if truncate == "acc32":
        truncate = choose_truncate_limbs(params, p_bits)
    assert batch <= tk.LATENCY_BATCH_MAX == kn.LATENCY_BATCH_MAX
    got = u64(tk.pbs_batch(
        t64(ct), tk.pack_ksk(server.ksk, params, device="cpu"),
        tk.pack_bsk(server.bsk, params, truncate, device="cpu"),
        t64(lut_poly), params, p_bits))
    want = np.asarray(kn.pbs_batch(
        jnp.asarray(ct), kn.pack_ksk(server.ksk, params),
        kn.pack_bsk(server.bsk, params, truncate), jnp.asarray(lut_poly),
        params, p_bits))
    assert np.array_equal(got, want)
    dec = ref.decode(ref.lwe_decrypt(sk.lwe_big, got), p_bits)
    assert np.count_nonzero(dec != table[msgs]) <= 1
