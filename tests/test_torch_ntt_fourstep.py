"""The port's four-step CRT-NTT (core/ntt_fourstep.py) against the JAX
package's ``core/ntt_tpu.py``, on the CPU, bit for bit.

Primes, plans (every table), the mod-p arithmetic, the limb-plane matmul,
both transforms, the Garner recombination, the packed BSK spectra, the
external product and the blind rotate: the same inputs, made with numpy
from a seed, through both packages, at ``TEST_PARAMS_TINY`` (N=64, three
primes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import ntt_tpu as jnt
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY as P

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.core import ntt_fourstep as tnt

CPU = torch.device("cpu")
N = P.polynomial_size
PRIMES = jnt.choose_primes(P)


def _t(a) -> torch.Tensor:
    """A numpy integer array as a CPU tensor (u64 as int64, u32 as int64)."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).view(np.uint64)


@pytest.mark.parametrize("n,bits", [(64, 70), (64, 86), (1024, 101),
                                    (4096, 101), (16384, 130)])
def test_primes_match_reference(n, bits):
    assert tnt.ntt_primes_near_pow2(n, bits) == jnt.ntt_primes_near_pow2(
        n, bits)
    assert tnt.SHIFT_PRIMES == jnt.SHIFT_PRIMES


def test_crt_bits_and_primes_of_params_match_reference():
    from concrete_tpu_torch.params import BENCH_PARAMS_6BIT as T6
    from concrete_tpu.params import BENCH_PARAMS_6BIT as J6
    for tp, jp in ((P, P), (T6, J6)):
        assert tnt.required_crt_bits(tp) == jnt.required_crt_bits(jp)
        assert tnt.choose_primes(tp) == jnt.choose_primes(jp)


@pytest.mark.parametrize("n", [64, 256])
def test_build_plan_matches_reference(n):
    for p in jnt.ntt_primes_near_pow2(n, 86):
        want = jnt.build_plan(n, p)
        got = tnt.build_plan(n, p, device="cpu")
        assert (got.p, got.n1, got.n2, got.hi31) == (want.p, want.n1,
                                                     want.n2, want.hi31)
        for name in ("dft1", "dft2", "idft2", "idft1", "tw_f", "tw_i",
                     "pow8"):
            assert np.array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name))), name
        assert got.device == CPU


def test_mod_arithmetic_matches_reference(rng):
    p = PRIMES[0]
    jplan, tplan = jnt.build_plan(N, p), tnt.build_plan(N, p, device="cpu")
    a = rng.integers(0, p, 500, dtype=np.uint64)
    b = rng.integers(0, p, 500, dtype=np.uint64)
    big = rng.integers(0, 1 << 62, 500, dtype=np.uint64)
    assert np.array_equal(
        tnt._mul_mod32(_t(a), _t(b), tplan).numpy(),
        np.asarray(jnt._mul_mod32(jnp.asarray(a.astype(np.uint32)),
                                  jnp.asarray(b.astype(np.uint32)), jplan)))
    assert np.array_equal(
        tnt._mul_mod(_t(a), _t(b), tplan).numpy(),
        np.asarray(jnt._mul_mod(jnp.asarray(a), jnp.asarray(b), jplan)))
    assert np.array_equal(
        tnt._add_mod32(_t(a), _t(b), tplan).numpy(),
        np.asarray(jnt._add_mod32(jnp.asarray(a.astype(np.uint32)),
                                  jnp.asarray(b.astype(np.uint32)), jplan)))
    assert np.array_equal(
        tnt._fold(_t(big), tplan).numpy(),
        np.asarray(jnt._fold(jnp.asarray(big), jplan, 1 << 62)))


def test_balanced_limbs_match_the_carry_chain(rng):
    """The matmul's limb split equals the port's and the JAX package's
    carry-chain split of centred residues (|v| < 2^30)."""
    from concrete_tpu.core import limbs as jlb
    from concrete_tpu_torch.core import limbs as tlb
    v = np.concatenate([rng.integers(-(1 << 30) + 1, 1 << 30, 5000),
                        [-(1 << 30) + 1, (1 << 30) - 1, 0, -1, 127, 128,
                         -128, -129, 32767, 32768, -32769]]).astype(np.int64)
    got = tnt._balanced_limbs(torch.from_numpy(v))
    assert torch.equal(got, tlb.i32_digits_to_balanced_i8(
        torch.from_numpy(v), 4))
    assert np.array_equal(got.numpy(), jlb.i32_digits_to_balanced_i8(
        v.astype(np.int32), 4))


def test_matmul_mod_matches_reference_and_exact(rng):
    """Every prime's limb-plane matmul, alone and as one stack, against
    the JAX package's and the exact product mod p."""
    k_dim, l_dim = 8, 12
    mats, xs, wants = [], [], []
    for p in PRIMES:
        jplan, tplan = jnt.build_plan(N, p), tnt.build_plan(N, p,
                                                            device="cpu")
        x = rng.integers(0, p, (5, 3, k_dim), dtype=np.uint64)
        mat = rng.integers(0, p, (k_dim, l_dim), dtype=np.int64)
        planes = jnt._split_planes(mat, p)
        assert np.array_equal(tnt._split_planes(mat, p), planes)
        want = np.asarray(jnt._matmul_mod(jnp.asarray(x.astype(np.uint32)),
                                          jnp.asarray(planes), jplan))
        got = tnt._matmul_mod(_t(x), torch.from_numpy(planes), tplan)
        assert np.array_equal(got.numpy(), want)
        exact = (x.astype(object) @ mat.astype(object)) % p
        assert np.array_equal(want, exact.astype(np.uint32))
        mats.append(planes)
        xs.append(x)
        wants.append(want)
    stack = tnt._stack(N, PRIMES, CPU)
    got = tnt._mm_mod(_t(np.stack(xs)),
                      torch.from_numpy(np.concatenate(mats, axis=1)),
                      stack.p, stack.pow8)
    assert np.array_equal(got.numpy(), np.stack(wants))


def test_fwd_inv_match_reference(rng):
    for p in PRIMES:
        jplan, tplan = jnt.build_plan(N, p), tnt.build_plan(N, p,
                                                            device="cpu")
        x = rng.integers(0, p, (3, 2, N), dtype=np.uint64)
        want = np.asarray(jnt.ntt_fwd(jnp.asarray(x), jplan))
        got = tnt.ntt_fwd(_t(x), tplan)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        back = tnt.ntt_inv(got, tplan)
        assert np.array_equal(back.numpy(), x.astype(np.int64))
        assert np.array_equal(
            back.numpy(),
            np.asarray(jnt.ntt_inv(jnp.asarray(want), jplan)).astype(
                np.int64))


def test_garner_matches_reference(rng):
    vals = np.concatenate([
        np.array([-1, -(1 << 40), 1 << 40, 0, 7, -(1 << 62),
                  (1 << 63) - 1, -(1 << 63)], dtype=np.int64),
        rng.integers(-(1 << 63), (1 << 63) - 1, 200, dtype=np.int64)])
    for primes in (PRIMES, jnt.ntt_primes_near_pow2(64, 70)):
        plans = [jnt.build_plan(64, p) for p in primes]
        res = [(vals.astype(object) % p).astype(np.uint64) for p in primes]
        want = np.asarray(jnt.garner_to_u64([jnp.asarray(r) for r in res],
                                            primes, plans))
        got = tnt.garner_to_u64([_t(r) for r in res], primes)
        assert np.array_equal(_u64(got), want)
    # within the primes' range the value itself comes back, signed
    assert np.array_equal(got.numpy()[:5], vals[:5])


@pytest.fixture(scope="module")
def tiny_keys():
    rng = np.random.default_rng(7)
    sk, server = jkg.keygen(rng, P)
    return rng, sk, server


def test_pack_bsk_ntt_matches_reference(tiny_keys):
    _, _, server = tiny_keys
    want = jnt.pack_bsk_ntt(server.bsk, P)
    got = tnt.pack_bsk_ntt(server.bsk, P, device="cpu")
    assert got.primes == want.primes == PRIMES
    assert (got.base_log, got.levels, got.n_small) == (
        want.base_log, want.levels, want.n_small)
    assert got.spectra.dtype == torch.int32
    assert np.array_equal(got.spectra.numpy(),
                          np.asarray(want.spectra).astype(np.int64))


def test_external_product_matches_reference(rng):
    l, kp1 = P.pbs_level, P.glwe_dimension + 1
    cin = l * kp1
    bsk = rng.integers(0, 1 << 64, (3, l, kp1, kp1, N), dtype=np.uint64)
    jpacked = jnt.pack_bsk_ntt(bsk, P)
    tpacked = tnt.pack_bsk_ntt(bsk, P, device="cpu")
    digits = rng.integers(-(1 << (P.pbs_base_log - 1)),
                          1 << (P.pbs_base_log - 1),
                          (4, cin, N)).astype(np.int32)
    want = np.asarray(jax.jit(jnt.external_product_ntt, static_argnums=(
        2, 3))(jnp.asarray(digits), jpacked.spectra[:, 1], PRIMES, P))
    got = tnt.external_product_ntt(torch.from_numpy(digits),
                                   tpacked.spectra[:, 1], PRIMES, P)
    assert got.shape == (4, kp1, N) and got.dtype == torch.int64
    assert np.array_equal(_u64(got), want)


def test_blind_rotate_ntt_matches_reference_and_decrypts(tiny_keys):
    rng, sk, server = tiny_keys
    bits = 3
    table = np.array([(3 * v + 1) % 8 for v in range(8)], dtype=np.uint64)
    lut_poly = jref.encode_expand_lut(table, N, bits)
    msgs = np.arange(6) % 8
    small = jkg.encrypt_lwe_batch(rng, sk.lwe_small, jref.encode(msgs, bits),
                                  P.lwe_std / 1024)
    want = np.asarray(jax.jit(jnt.blind_rotate_ntt, static_argnums=(3,))(
        jnp.asarray(small), jnt.pack_bsk_ntt(server.bsk, P),
        jnp.asarray(lut_poly), P))
    tbsk = tnt.pack_bsk_ntt(server.bsk, P, device="cpu")
    got = tnt.blind_rotate_ntt(_t(small), tbsk, _t(lut_poly), P)
    assert np.array_equal(_u64(got), want)
    # the port's banded blind rotate on the same key gives the same bits
    banded = tk.blind_rotate(_t(small), tk.pack_bsk(server.bsk, P,
                                                    device="cpu"),
                             _t(lut_poly), P)
    assert torch.equal(got, banded)
    out = _u64(tk.sample_extract(got))
    dec = jref.decode(jref.lwe_decrypt(sk.lwe_big, out), bits)
    assert np.array_equal(dec, table[msgs])


def test_tables_default_to_the_card():
    if torch.cuda.is_available():
        assert tnt.build_plan(N, PRIMES[0]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnt.build_plan(N, PRIMES[0])
