"""The port's CRT-NTT blind rotate against the JAX package, bit for bit, on CPU.

Inputs come from numpy seeds and go through both packages.  The port's
wrappers run their kernels' plain PyTorch versions on CPU tensors; those
are held here to the JAX package's numpy oracles (``refimpl.blind_rotate``
on the truncated key, ``blind_rotate_acc32_oracle``, the host NTT) and, in
a few cases, to its Pallas kernels in interpret mode.  The CUDA kernels are
held to the plain versions on the card by chip_smoke.py.
"""

import dataclasses
import math
import os
import re
import zipfile

import numpy as np
import pytest
import torch

import concrete_tpu.jax_config  # noqa: F401
import jax.numpy as jnp

from concrete_tpu import params as jpp
from concrete_tpu.compilation.specs import ClientSpecs as JSpecs
from concrete_tpu.core import ntt as jntt_host
from concrete_tpu.core import ntt_tpu as jnt
from concrete_tpu.core import refimpl as ref
from concrete_tpu.ops import pallas_fused_ntt as jfn
from concrete_tpu.ops import pallas_ntt as jpn
from concrete_tpu.ops import pallas_step as jps
from concrete_tpu.optimizer import v0 as jv0
from concrete_tpu.params import BENCH_PARAMS_6BIT, CryptoParams

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch import params as tpp
from concrete_tpu_torch.compilation.specs import ClientSpecs as TSpecs
from concrete_tpu_torch.core import ntt as tntt
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.ops import crt_scan as tcs
from concrete_tpu_torch.ops import fused_latency as tfl
from concrete_tpu_torch.ops import fused_ntt as tfn
from concrete_tpu_torch.ops import ntt as tn
from concrete_tpu_torch.ops import step as tstep
from concrete_tpu_torch.optimizer import v0 as tv0
from concrete_tpu_torch.params import CryptoParams as TParams
from concrete_tpu_torch.utils import telemetry as tm

# the QuantizedMLP benchmark's parameters (the committed mlp_q2_b64 archive)
MLP_PARAMS = CryptoParams.make(
    n_small=822, glwe_dimension=1, polynomial_size=4096, pbs_level=2,
    pbs_base_log=8, ks_level=8, ks_base_log=2)
MLP_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "concrete_tpu_torch", "fixtures",
    "mlp_q2_b64.zip")


def _tparams(p) -> TParams:
    return TParams(**dataclasses.asdict(p))


def t64(a) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(a, dtype=np.uint64).view(np.int64).copy())


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _params(n, n_small=2, levels=2, base_log=8):
    return CryptoParams(
        n_small=n_small, glwe_dimension=1, polynomial_size=n,
        pbs_level=levels, pbs_base_log=base_log, ks_level=2, ks_base_log=8,
        lwe_std=2.0 ** -25, glwe_std=2.0 ** -35, security_level=0)


def _random_inputs(rng, params, b_ct):
    kp1 = params.glwe_dimension + 1
    bsk = rng.integers(0, 1 << 64, (params.n_small, params.pbs_level, kp1,
                                    kp1, params.polynomial_size),
                       dtype=np.uint64)
    ct = rng.integers(0, 1 << 64, (b_ct, params.n_small + 1),
                      dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, params.polynomial_size, dtype=np.uint64)
    return bsk, ct, lut


def _four_step(port_spec: np.ndarray, n: int) -> np.ndarray:
    """The port's bit-reversed spectrum in the JAX kernels' four-step
    order (n1 = N / 128)."""
    nat = port_spec[..., tntt.bit_reverse(n)]
    return nat[..., jfn._plan_perm(n, n // jpn.N2)]


@pytest.mark.parametrize("n", [256, 512])
def test_ntt_matches_pallas_and_round_trips(n):
    rng = np.random.default_rng(n)
    p = jnt.ntt_primes_near_pow2(n, 60)[0]
    digits = rng.integers(-(1 << 20), 1 << 20, (8, n)).astype(np.int32)
    got = tn.ntt_forward(torch.from_numpy(digits), (p,))
    plan = jpn.build_pallas_plan(n, p)
    want = np.asarray(jpn.ntt_fwd_pallas(jnp.asarray(digits), plan,
                                         interpret=True))
    assert np.array_equal(_four_step(got[0].numpy(), n).astype(np.uint32),
                          want)
    nat = jntt_host.ntt_forward(digits.astype(np.int64) % p, n, p)
    assert np.array_equal(got[0].numpy()[:, tntt.bit_reverse(n)], nat)
    back = tn.ntt_inverse(got, (p,))
    assert np.array_equal(back[0].numpy(), digits.astype(np.int64) % p)


def test_ntt_several_primes_wide_inputs():
    """Signed 64-bit inputs reduce exactly, per prime, both directions."""
    n = 1024
    primes = tntt.special_ntt_primes(n, 128)[:3]
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 63), 1 << 63, (3, n), dtype=np.int64)
    x[0, :3] = [-(1 << 63), (1 << 63) - 1, -1]
    spec = tn.ntt_forward(torch.from_numpy(x), primes)
    for i, p in enumerate(primes):
        nat = jntt_host.ntt_forward(x % p, n, p)
        assert np.array_equal(spec[i].numpy()[:, tntt.bit_reverse(n)], nat)
    assert np.array_equal(tn.ntt_inverse(spec, primes).numpy(),
                          np.stack([x % p for p in primes]))


@pytest.mark.parametrize("base_log,levels", [(8, 2), (5, 4), (12, 3),
                                             (22, 1)])
def test_rotate_decompose_digits_plain(base_log, levels):
    """Kernel 1's plain version == pallas_step.rotate_decompose_digits,
    and its acc32 form (int32 top words) == the same with a zero low
    word, where the digits read only the top word."""
    rng = np.random.default_rng(base_log)
    rows, n = 8, 256
    acc = rng.integers(0, 1 << 64, (rows, n), dtype=np.uint64)
    a_rows = rng.integers(0, 2 * n, rows).astype(np.int32)
    kw = dict(base_log=base_log, levels=levels)
    got = tstep.rotate_decompose_digits(t64(acc), torch.from_numpy(a_rows),
                                        **kw).numpy()
    lo, hi = jps.split_u64(jnp.asarray(acc))
    want = jps.rotate_decompose_digits(lo, hi, jnp.asarray(a_rows),
                                       interpret=True, **kw)
    assert np.array_equal(got, np.stack([np.asarray(w) for w in want]))
    if jps.digits_lo_free(base_log, levels):
        top = (acc >> np.uint64(32)).astype(np.uint32)
        got = tstep.rotate_decompose_digits(
            torch.from_numpy(top.view(np.int32)), torch.from_numpy(a_rows),
            **kw).numpy()
        want = jps.rotate_decompose_digits(
            jnp.zeros_like(lo), jnp.asarray(top), jnp.asarray(a_rows),
            interpret=True, **kw)
        assert np.array_equal(got, np.stack([np.asarray(w) for w in want]))


@pytest.mark.parametrize("n_primes", [3, 2])
def test_pack_bsk_fused_matches_reference(n_primes):
    """The port's spectra (bit-reversed) == the JAX spec_val and spec_sh
    (four-step), for an untruncated and a truncated key."""
    params = _params(1024, n_small=2)
    rng = np.random.default_rng(11 + n_primes)
    bsk, _, _ = _random_inputs(rng, params, 1)
    primes = tntt.special_ntt_primes(1024, 128)[:n_primes]
    t = max(0, tntt.required_bits(params, 0)
            - (math.prod(primes).bit_length() - 1))
    assert (t > 0) == (n_primes == 2)
    got = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                             trunc_bits=t, device="cpu")
    want = jfn.pack_bsk_fused(bsk, params, primes=primes, trunc_bits=t)
    for g, w in ((got.spec_val, want.spec_val), (got.spec_sh, want.spec_sh)):
        assert np.array_equal(
            _four_step(g.numpy().view(np.uint32), 1024), np.asarray(w))
    assert (got.primes, got.trunc_bits) == (want.primes, want.trunc_bits)


def _oracle_case(n, n_primes, acc32):
    params = _params(n, n_small=2)
    rng = np.random.default_rng(n + 10 * n_primes + acc32)
    bsk, ct, lut = _random_inputs(rng, params, 2)
    primes = tntt.special_ntt_primes(n, 128)[:n_primes]
    t = max(0, tntt.required_bits(params, 0)
            - (math.prod(primes).bit_length() - 1))
    fbsk = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                              trunc_bits=t, device="cpu")
    got = u64(tfn.blind_rotate_fused(t64(ct), fbsk, t64(lut),
                                     _tparams(params), acc32=acc32))
    return params, bsk, ct, lut, primes, t, got


@pytest.mark.parametrize("n_primes", [3, 2], ids=["t0", "truncated"])
@pytest.mark.parametrize("n", [1024, 2048])
def test_blind_rotate_fused_full_mode_matches_oracle(n, n_primes):
    """Full u64 accumulator == refimpl.blind_rotate on truncate_bsk_u64."""
    params, bsk, ct, lut, _, t, got = _oracle_case(n, n_primes, False)
    assert (t > 0) == (n_primes == 2)
    oracle_bsk = jfn.truncate_bsk_u64(bsk, t)
    for b in range(ct.shape[0]):
        assert np.array_equal(got[b], ref.blind_rotate(ct[b], oracle_bsk,
                                                       lut, params))


@pytest.mark.parametrize("n_primes", [3, 2], ids=["t0", "truncated"])
@pytest.mark.parametrize("n", [1024, 2048])
def test_blind_rotate_fused_acc32_matches_oracle(n, n_primes):
    """Top-word accumulator == blind_rotate_acc32_oracle (which mirrors the
    JAX kernel's truncated arithmetic and its H offset)."""
    params, bsk, ct, lut, primes, t, got = _oracle_case(n, n_primes, True)
    for b in range(ct.shape[0]):
        assert np.array_equal(got[b], jfn.blind_rotate_acc32_oracle(
            ct[b], bsk, lut, params, primes, t))


def test_blind_rotate_fused_matches_pallas_interpret():
    """One cross-check against the JAX kernel itself (interpret mode) at
    its smallest supported shape, in its default (acc32) mode."""
    params = CryptoParams(
        n_small=6, glwe_dimension=1, polynomial_size=1024,
        pbs_level=2, pbs_base_log=8, ks_level=2, ks_base_log=8,
        lwe_std=2.0 ** -25, glwe_std=2.0 ** -35, security_level=0)
    rng = np.random.default_rng(5)
    bsk, ct, lut = _random_inputs(rng, params, 2)
    primes, t = jfn.choose_fused_primes(params, message_bits=3)
    assert (primes, t) == tntt.choose_fused_primes(_tparams(params), 3)
    jbsk = jfn.pack_bsk_fused(bsk, params, primes=primes, trunc_bits=t)
    tbsk = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                              trunc_bits=t, device="cpu")
    assert jfn.acc32_eligible(jbsk) and tfn.acc32_eligible(tbsk)
    want = np.asarray(jfn.blind_rotate_fused(
        jnp.asarray(ct), jbsk, jnp.asarray(lut), params, interpret=True))
    got = u64(tfn.blind_rotate_fused(t64(ct), tbsk, t64(lut),
                                     _tparams(params)))
    assert np.array_equal(got, want)


def _grid():
    cases = [(BENCH_PARAMS_6BIT, 6), (BENCH_PARAMS_6BIT, None),
             (MLP_PARAMS, 6), (MLP_PARAMS, None)]
    for n in (1024, 2048, 4096, 8192, 16384):
        for levels, base_log in ((1, 22), (2, 8), (3, 7), (4, 5)):
            p = CryptoParams.make(
                n_small=760, glwe_dimension=1, polynomial_size=n,
                pbs_level=levels, pbs_base_log=base_log, ks_level=5,
                ks_base_log=3)
            cases += [(p, mb) for mb in (None, 4, 6)]
    return cases


@pytest.mark.parametrize("params,message_bits", _grid())
def test_prime_choice_and_bsk_form_match_reference(params, message_bits):
    tp = _tparams(params)
    assert tntt.choose_fused_primes(tp, message_bits) == \
        jfn.choose_fused_primes(params, message_bits)
    assert tv0.fused_ntt_preferred(tp, message_bits) == \
        jv0.fused_ntt_preferred(params, message_bits)


def test_mlp_parameters_take_the_fused_acc32_path():
    """The slice's archive: 3 primes, no truncation, acc32, fused."""
    tp = _tparams(MLP_PARAMS)
    primes, t = tntt.choose_fused_primes(tp, 6, norm2=4.36)
    assert primes == (2147352577, 2147205121, 2147074049) and t == 0
    assert tv0.fused_ntt_preferred(tp, 6)
    assert tntt.digits_lo_free(tp.pbs_base_log, tp.pbs_level)


def test_mlp_blind_rotate_noise_matches_reference():
    """The figures chip_smoke.py holds its direct 6-bit lookups to: at the
    MLP archive's parameters the port's blind-rotate variance equals the
    JAX package's and the one its optimizer charges (the atomic pattern's
    variance less the keyswitch and modulus-switch terms), and so does the
    6-bit decode's error rate, about a third."""
    with zipfile.ZipFile(MLP_FIXTURE) as z:
        blob = z.read("client.specs.json").decode()
    jp, tp = JSpecs.deserialize(blob).params, TSpecs.deserialize(blob).params
    assert (jp.n_small, jp.polynomial_size, jp.pbs_level) == (822, 4096, 2)

    def v_br(pp, p):
        return pp.variance_blind_rotate(
            p.n_small, p.glwe_dimension, p.polynomial_size, p.pbs_base_log,
            p.pbs_level, p.glwe_std ** 2, p.q_log)

    v_t, v_j = v_br(tpp, tp), v_br(jpp, jp)
    assert v_t == v_j
    v_opt = (jp.atomic_pattern_variance(1)
             - jpp.variance_keyswitch(jp.n_big, jp.ks_base_log, jp.ks_level,
                                      jp.lwe_std ** 2, jp.q_log)
             - jpp.variance_modulus_switch(jp.n_small,
                                           jp.log2_polynomial_size, jp.q_log))
    assert v_t == pytest.approx(v_opt, rel=1e-9)
    p6 = tpp.p_error_from_variance(v_t, 6)
    assert p6 == jpp.p_error_from_variance(v_j, 6)
    assert 0.33 < p6 < 0.34
    assert tpp.p_error_from_variance(v_t, 3) < 1e-12


def test_garner_exact_at_the_boundary():
    """Kernel 4's plain version == (z << t) mod 2^64 (full mode) and the
    acc32 update, for random and |z| -> P/4 edge values of the product."""
    primes = tntt.special_ntt_primes(4096, 128)[:3]
    p_prod = math.prod(primes)
    h_half = (p_prod - 1) // 2
    rng = np.random.default_rng(7)
    z = rng.integers(-(1 << 62), 1 << 62, (8, 256)).astype(object)
    edge = [(p_prod >> 2) - 1, -(p_prod >> 2), (p_prod >> 2) - 999,
            -((p_prod >> 2) - 3), 1, -1, 0, (p_prod >> 3) * 2 - 3]
    z[0, :len(edge)] = edge
    res = torch.from_numpy(np.stack([
        np.vectorize(lambda v, p=p: int(v) % p, otypes=[np.int64])(z)
        for p in primes]).astype(np.int32))
    start = rng.integers(0, 1 << 64, z.shape, dtype=np.uint64)
    for shift in (0, 9, 40):
        acc = tfn.garner_accumulate(res, t64(start), primes, shift)
        add = np.vectorize(lambda v: (int(v) << shift) % (1 << 64),
                           otypes=[object])(z)
        assert np.array_equal(u64(acc), ((start.astype(object) + add)
                                         % (1 << 64)).astype(np.uint64))
        top = (start >> np.uint64(32)).astype(np.uint32)
        acc32 = tfn.garner_accumulate(res, torch.from_numpy(
            top.view(np.int32).copy()), primes, shift)
        htop = (((h_half << shift) % (1 << 64)) >> 32)
        add32 = np.vectorize(
            lambda v: ((((int(v) + h_half) << shift) % (1 << 64)) >> 32)
            - htop, otypes=[object])(z)
        want = ((top.astype(object) + add32) % (1 << 32)).astype(np.uint32)
        assert np.array_equal(acc32.numpy().view(np.uint32), want)


def test_poly_sizes_outside_the_fused_range_raise():
    params = _tparams(_params(512))
    with pytest.raises(ValueError, match="N in 1024"):
        tfn.pack_bsk_fused(np.zeros((1, 2, 2, 2, 512), np.uint64), params,
                           primes=(2147352577,), trunc_bits=0,
                           device="cpu")


# ---------------------------------------------------------------------------
# Kernel 3's register schedule, rehearsed in numpy
# ---------------------------------------------------------------------------
#
# csrc/crt_external_product.cu runs each transform as passes of up to 4
# radix-2 stages on the 16 residues a thread holds, with an exchange through
# a swizzled shared-memory buffer between passes.  The emulation below runs
# every thread's group at once, reads the twiddles from ``pair_tables`` at
# the indices the kernel computes, and moves the residues through the
# swizzled buffer, with Shoup's products as the kernel computes them.

E = 16                  # residues per thread and group (the kernel's E)
M32 = np.uint64(0xFFFFFFFF)


def register_passes(n):
    """The kernel's schedule for size N: per pass, (first stage, stages,
    log2 of the stride between a group's residues).  Pass q runs stages
    4q .. 4q+R-1 in registers; group g's residue k sits at _pos(g, ls, k)
    (pass_ls / pass_stages in the kernel)."""
    log_n = n.bit_length() - 1
    return [(4 * q, min(4, log_n - 4 * q), max(0, log_n - 4 * q - 4))
            for q in range((log_n + 3) // 4)]


def _swz(j):
    return j ^ ((j >> 4) & 31)


def _pos(g, ls, k):
    return ((g >> ls) << (ls + 4)) + (g & ((1 << ls) - 1)) + (k << ls)


def _shoup(a, w, w_sh, p):
    r = (a * w - ((a * w_sh) >> np.uint64(32)) * p) & M32
    return np.where(r >= p, r - p, r)


def _sched_pass(x, ls, s0, r, tw, p, inverse):
    """pass<R, INV>: stages s0 .. s0+R-1 on every group's 16 residues (x is
    (groups, 16) u64), twiddle pairs tw (N, 2) u64."""
    blk = np.arange(x.shape[0]) >> ls
    for qq in range(r):
        q = r - 1 - qq if inverse else qq
        base = (1 << (s0 + q)) + (blk << (4 - r + q))
        dk = 1 << (r - 1 - q)
        for k in range(E):
            if k & dk:
                continue
            s, s_sh = tw[base + (k >> (r - q))].T
            u, v = x[:, k], x[:, k + dk]
            if inverse:
                d = (u + p - v) % p
                x[:, k], x[:, k + dk] = (u + v) % p, _shoup(d, s, s_sh, p)
            else:
                sv = _shoup(v, s, s_sh, p)
                x[:, k], x[:, k + dk] = (u + sv) % p, (u + p - sv) % p


def _exchange(x, ls_from, ls_to):
    """The residues through the swizzled buffer, from one pass's layout to
    the next's."""
    g = np.arange(x.shape[0])[:, None]
    k = np.arange(E)[None, :]
    buf = np.full(x.size, np.uint64(1 << 40))
    buf[_swz(_pos(g, ls_from, k))] = x
    return buf[_swz(_pos(g, ls_to, k))]


def _sched_forward(coeffs, tw, p, n):
    passes = register_passes(n)
    g = np.arange(n // E)[:, None]
    x = coeffs[_pos(g, passes[0][2], np.arange(E)[None, :])]
    for q, (s0, r, ls) in enumerate(passes):
        if q:
            x = _exchange(x, passes[q - 1][2], ls)
        _sched_pass(x, ls, s0, r, tw, p, inverse=False)
    return x          # group g holds spectrum residues 16g .. 16g+15


def _sched_inverse(x, tw, p, n, n_inv, n_inv_sh):
    passes = register_passes(n)
    for q in range(len(passes) - 1, -1, -1):
        if q < len(passes) - 1:
            x = _exchange(x, passes[q + 1][2], passes[q][2])
        s0, r, ls = passes[q]
        _sched_pass(x, ls, s0, r, tw, p, inverse=True)
    out = np.empty(n, np.uint64)
    g = np.arange(n // E)[:, None]
    out[_pos(g, passes[0][2], np.arange(E)[None, :])] = \
        _shoup(x, n_inv, n_inv_sh, p)
    return out


def _pairs(n, primes):
    return tn.pair_tables(n, primes, "cpu").numpy().view(np.uint32) \
        .astype(np.uint64)


@pytest.mark.parametrize("n", [1024, 4096, 16384])
def test_register_schedule_covers_every_stage(n):
    """The passes split log2 N stages 4 at a time, the last pass's groups
    are 16 consecutive residues, and the swizzled exchange is a bijection
    whose stores and loads are free of bank conflicts in every pass."""
    passes = register_passes(n)
    assert [s0 for s0, _, _ in passes] == list(range(0, n.bit_length() - 1,
                                                     4))
    assert sum(r for _, r, _ in passes) == n.bit_length() - 1
    assert passes[-1][2] == 0
    assert np.array_equal(np.sort(_swz(np.arange(n))), np.arange(n))
    lanes = np.arange(32)
    for _, _, ls in passes:
        for warp in range(0, n // E, 32):
            for k in range(E):
                banks = _swz(_pos(warp + lanes, ls, k)) % 32
                assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("n", [1024, 4096])
def test_register_schedule_matches_transforms(n):
    """The kernel's schedule == ntt_forward_plain (bit-reversed spectrum)
    and the JAX package's host transform (natural order); its inverse ==
    ntt_inverse_plain and gives the coefficients back."""
    primes = tntt.special_ntt_primes(n, 128)[:2]
    rng = np.random.default_rng(n + 1)
    digits = rng.integers(-128, 128, (1, n)).astype(np.int32)
    pairs = _pairs(n, primes)
    cst = tntt.prime_constants(n, primes).astype(np.uint64)
    want = tn.ntt_forward_plain(torch.from_numpy(digits), primes).numpy() \
        .view(np.uint32)
    back_want = tn.ntt_inverse_plain(torch.from_numpy(want.view(np.int32)),
                                     primes).numpy().view(np.uint32)
    for i, p in enumerate(primes):
        coeffs = (digits[0].astype(np.int64) % p).astype(np.uint64)
        spec = _sched_forward(coeffs, pairs[i, 0], np.uint64(p), n)
        assert np.array_equal(spec.reshape(-1), want[i, 0])
        nat = jntt_host.ntt_forward(digits[0].astype(np.int64) % p, n, p)
        assert np.array_equal(spec.reshape(-1)[tntt.bit_reverse(n)], nat)
        back = _sched_inverse(spec, pairs[i, 1], np.uint64(p), n, cst[i, 1],
                              cst[i, 2])
        assert np.array_equal(back, back_want[i, 0])
        assert np.array_equal(back, coeffs)


def test_register_schedule_matches_crt_external_product_plain():
    """One blind-rotate step as the kernel runs it per (ciphertext, prime):
    forward transforms of the Cin digit rows, the multiply-add with the
    key spectra read at 16g .. 16g+15, the k+1 inverses and the 1/N
    scaling, stored at the first pass's positions; == the plain version."""
    _rehearse_step(kp1=2, b_ct=2)


@pytest.mark.parametrize("kp1", [3, 4])
def test_register_schedule_with_shared_accumulators(kp1):
    """k >= 2: the accumulators beyond the kernel's two in registers live
    in shared memory, residue k of thread t's group i of accumulator 2 + c
    at ((c G + i) 16 + k) T + t; the slots are a bijection onto (k-1) N
    words, each thread's own, and the step still == the plain version."""
    _rehearse_step(kp1=kp1, b_ct=3)


def test_kernel_shape_limits():
    """Kernel 3 takes every k+1 >= 2 up to N=16384: one group of output
    components while its accumulators fit one block (k+1 <= 3 at
    N=16384, <= 7 at N=8192), and beyond that as few groups as fit, each
    block holding its group's accumulators only; k+1 < 2 is still refused
    with the reason."""
    for n, kp1 in ((16384, 3), (8192, 7), (4096, 14), (2048, 7),
                   (4096, 2)):
        assert tfn.kernel_groups(n, kp1) == (1, kp1)
    assert tfn.kernel_groups(16384, 4) == (2, 2)
    assert tfn.kernel_groups(8192, 8) == (2, 4)
    with pytest.raises(ValueError, match="k\\+1 >= 2"):
        tfn.kernel_groups(1024, 1)


def _rehearse_step(kp1, b_ct, smem_bytes=tfn.XP_SMEM_BYTES):
    """Kernel 3's step in numpy, block by block: per (prime, ciphertext,
    group of output components), the register schedule's forward
    transforms of every digit polynomial, the group's first two
    accumulators in registers and the rest in its shared-memory slots,
    and the inverse transforms, == crt_external_product_plain."""
    n, levels = 1024, 2
    params = dataclasses.replace(_params(n, n_small=1),
                                 glwe_dimension=kp1 - 1)
    rng = np.random.default_rng(17 + kp1)
    bsk, _, _ = _random_inputs(rng, params, 1)
    primes = tntt.special_ntt_primes(n, 128)[:3]
    fbsk = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                              trunc_bits=0, device="cpu")
    digits = rng.integers(-128, 128, (levels, b_ct * kp1, n)).astype(np.int32)
    spec = fbsk.spec_val[0].numpy().view(np.uint32).astype(np.uint64)
    spec_sh = fbsk.spec_sh[0].numpy().view(np.uint32).astype(np.uint64)
    want = tfn.crt_external_product_plain(
        torch.from_numpy(digits), fbsk.spec_val[0], fbsk.spec_sh[0], primes,
        kp1).numpy().view(np.uint32)
    pairs = _pairs(n, primes)
    cst = tntt.prime_constants(n, primes).astype(np.uint64)
    cin = levels * kp1
    threads, kr = n // E, 2            # one group per thread below N=16384
    groups, co_group = tfn.kernel_groups(n, kp1, smem_bytes)
    # a block's shared memory: two exchange buffers and its group's
    # accumulators past the two in registers
    assert (2 + max(co_group - kr, 0)) * n * 4 <= smem_bytes
    got = np.full((len(primes), b_ct * kp1, n), 1 << 40, np.uint64)
    for z in range(groups):
        co0 = z * co_group
        ng = min(co_group, kp1 - co0)
        # the shared accumulators' slots: [c][k][t] -> ((c G + i) E + k) T
        # + t
        c, k, t = np.meshgrid(np.arange(max(ng - kr, 0)), np.arange(E),
                              np.arange(threads), indexing="ij")
        slot = (c * E + k) * threads + t
        assert np.array_equal(np.sort(slot.reshape(-1)),
                              np.arange(max(ng - kr, 0) * n))
        for pr, p in enumerate(primes):
            p64 = np.uint64(p)
            for b in range(b_ct):
                acc = np.zeros((kr, n // E, E), np.uint64)
                shared = np.full(max(ng - kr, 0) * n, np.uint64(1 << 40))
                shared[slot] = 0
                for ci in range(cin):
                    lev, comp = divmod(ci, kp1)
                    d = digits[lev, b * kp1 + comp].astype(np.int64)
                    x = _sched_forward(
                        np.where(d < 0, d + p, d).astype(np.uint64),
                        pairs[pr, 0], p64, n)
                    for co in range(ng):
                        row = (pr * cin + ci) * kp1 + co0 + co
                        kv = spec[row].reshape(n // E, E)
                        ks = spec_sh[row].reshape(n // E, E)
                        prod = _shoup(x, kv, ks, p64)
                        if co < kr:
                            acc[co] = (acc[co] + prod) % p64
                        else:   # slot[c, k, t] holds thread t's residue k
                            s = slot[co - kr]
                            shared[s] = (shared[s] + prod.T) % p64
                for co in range(ng):
                    a = acc[co] if co < kr else shared[slot[co - kr]].T
                    got[pr, b * kp1 + co0 + co] = _sched_inverse(
                        a.copy(), pairs[pr, 1], p64, n, cst[pr, 1],
                        cst[pr, 2])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kp1,groups", [(4, 2), (5, 3)])
def test_register_schedule_in_output_groups(kp1, groups):
    """Kernel 3 in output-component groups, rehearsed at N=1024 with a
    shared-memory budget forced down to the two exchange buffers: each
    group's block keeps its (at most two) accumulators in registers and
    the step still == the plain version."""
    smem = 2 * 1024 * 4
    assert tfn.kernel_groups(1024, kp1, smem)[0] == groups
    _rehearse_step(kp1=kp1, b_ct=2, smem_bytes=smem)


# ---------------------------------------------------------------------------
# The one-launch scan of a batch (ops/crt_scan.py, csrc/blind_rotate_crt_scan.cu)
# ---------------------------------------------------------------------------

#: the key-value query's blind rotate (N, k+1, l, P, acc32)
KVDB32 = (2048, 2, 1, 3, True)


def test_crt_scan_rule_takes_the_batches():
    """The rule (ops.fused_ntt.blind_rotate_form): the key-value query's
    shape at B = 2,048 and 256 (and 5, 300; either accumulator mode) and
    radix_add's B = 512 on 2 primes take the one-launch scan; B <=
    LATENCY_BATCH_MAX keeps the fused persistent kernel where its plan
    takes the shape, and takes the scan where it does not (l = 2, base
    2^16 at B = 1: its ring and threads); shapes the kernel does not take
    keep the loop: the MLP's N = 4096, PrimeMatch 10's N = 8192, N = 1024
    and 16384, k+1 = 3, 4 primes."""
    n, kp1, levels, n_p, acc32 = KVDB32
    form = tfn.blind_rotate_form
    for batch in (2048, 256, 5, 300):
        assert form(batch, n, kp1, levels, n_p, acc32) == "crt_ntt_scan"
        assert form(batch, n, kp1, levels, n_p, False) == "crt_ntt_scan"
    assert form(512, 2048, 2, 2, 2, True) == "crt_ntt_scan"
    for batch in range(1, tk.LATENCY_BATCH_MAX + 1):
        assert tfl.plan(batch, n, kp1, levels, n_p, acc32) is not None
        assert form(batch, n, kp1, levels, n_p, acc32) == "fused_latency"
    assert tfl.plan(1, 2048, 2, 4, 3, False) is None
    assert form(1, 2048, 2, 4, 3, False) == "crt_ntt_scan"
    for shape in ((256, 4096, 2, 2, 3, True), (100, 8192, 2, 2, 3, True),
                  (256, 1024, 2, 2, 3, True), (128, 16384, 2, 2, 3, True),
                  (256, 2048, 3, 1, 3, True), (256, 2048, 2, 1, 4, True)):
        assert tcs.plan(*shape) is None, shape
        assert form(*shape) == "crt_ntt_loop", shape


def _csrc(name):
    return open(os.path.join(os.path.dirname(tcs.__file__), os.pardir,
                             "csrc", name)).read()


def test_crt_scan_plan_is_the_kernels():
    """plan()'s limits are the kernel's CS_* constants (shared memory,
    groups a block, N); its shared memory is make_plan's sum: the
    accumulator (4 or 8 bytes a word) and a pair of exchange buffers a
    prime's group; the key-value query's block is 64 KB of 384 threads,
    the launch bound's 3 groups."""
    src = _csrc("blind_rotate_crt_scan.cu")
    consts = {name: math.prod(int(f) for f in expr.split("*"))
              for name, expr in re.findall(
                  r"constexpr \w+ CS_(\w+) = ([\d *]+);", src)}
    assert consts == {"MAX_SMEM": tcs.MAX_SMEM,
                      "MAX_PRIMES": tcs.MAX_PRIMES, "LOG_N": tcs.LOG_N}
    assert "constexpr int CS_KP1 = KR;" in src and tcs.KP1 == 2
    assert "__launch_bounds__(CS_MAX_PRIMES * ((1 << LOG_N) / E), 1)" in src
    for levels, n_p, acc32 in ((1, 3, True), (2, 3, False), (1, 2, True),
                               (2, 1, False)):
        pl = tcs.plan(7, 2048, 2, levels, n_p, acc32)
        assert pl.threads == n_p * 2048 // tcs.E
        assert pl.off_exch == 2 * 2048 * (4 if acc32 else 8)
        assert pl.smem == pl.off_exch + n_p * 2 * 2048 * 4
    assert tcs.plan(2048, *KVDB32) == tcs.Plan(threads=384, off_exch=16384,
                                               smem=65536)


def emulate_crt_scan(a_t, acc, fbsk, mutation=None):
    """The kernel's data movement on the CPU, group by group: per step
    each prime's group takes every digit polynomial from the block's
    accumulator, transforms it, multiplies it with its prime's key rows,
    inverts, and leaves its residue rows in its own buffers; after the
    barrier the block recombines every quad (Garner) from the groups'
    buffers and updates the accumulator in place.  `mutation` plants a
    fault: a group's residues read from the next group's buffers, the
    last quad left out, or the Garner run on the accumulator of the step
    before."""
    primes, n_p = fbsk.primes, len(fbsk.primes)
    b_ct, kp1, n = acc.shape
    out = acc.clone()
    for b in range(b_ct):
        block, before = out[b], out[b].clone()
        for i in range(fbsk.n_small):
            a = a_t[b, i].repeat(kp1)
            bufs = []
            for gp in range(n_p):
                prime = (primes[gp],)
                d = tstep.rotate_decompose_digits_plain(
                    block, a, base_log=fbsk.base_log,
                    levels=fbsk.levels)                 # (l, k+1, N)
                dhat = tn.ntt_forward_plain(d.reshape(-1, n), prime)[0]
                key = (fbsk.spec_val[i].to(torch.int64) & 0xFFFFFFFF) \
                    .view(n_p, -1, kp1, n)[gp]          # (Cin, k+1, N)
                hat = (dhat.to(torch.int64)[:, None] * key % primes[gp]) \
                    .sum(0) % primes[gp]
                bufs.append(tn.ntt_inverse_plain(
                    hat[None].to(torch.int32), prime)[0].reshape(-1))
            if mutation == "prime":
                bufs = bufs[1:] + bufs[:1]
            hi = kp1 * n - 4 * (mutation == "gap")
            old = before if mutation == "step_before" else block
            new = block.clone()
            new.view(-1)[:hi] = tfn.garner_accumulate_plain(
                torch.stack([r[:hi] for r in bufs]),
                old.view(-1)[:hi].clone(), primes, fbsk.trunc_bits)
            before = block.clone()
            block.copy_(new)
    return out


def _scan_case(batch, levels, base_log, n_p, acc32, n=2048, steps=2,
               seed=0):
    params = _params(n, n_small=steps, levels=levels, base_log=base_log)
    rng = np.random.default_rng([batch, levels, n_p, acc32, seed])
    bsk, ct, lut = _random_inputs(rng, params, batch)
    primes = tntt.special_ntt_primes(n, 128)[:n_p]
    t = max(0, tntt.required_bits(params, 0)
            - (math.prod(primes).bit_length() - 1))
    fbsk = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                              trunc_bits=t, device="cpu")
    a_t, acc = tfn.first_accumulator(t64(ct), fbsk, t64(lut),
                                     _tparams(params), acc32)
    return params, fbsk, ct, lut, a_t, acc


@pytest.mark.parametrize("batch,levels,base_log,n_p,acc32", [
    (1, 1, 23, 3, True), (2, 2, 16, 3, False), (1, 1, 23, 2, True)],
    ids=["kvdb32", "u64", "p2"])
def test_crt_scan_design_matches_plain(batch, levels, base_log, n_p, acc32):
    """The rehearsed kernel == its plain version over 2 steps at N=2048:
    the key-value query's shape, a u64-accumulator shape (the digits read
    the low word), a 2-prime shape."""
    _, fbsk, _, _, a_t, acc = _scan_case(batch, levels, base_log, n_p, acc32)
    kw = dict(primes=fbsk.primes, trunc_bits=fbsk.trunc_bits,
              base_log=fbsk.base_log, levels=fbsk.levels)
    want = tcs.blind_rotate_crt_scan_plain(a_t, acc, fbsk.spec_val,
                                           fbsk.spec_sh, **kw)
    assert torch.equal(emulate_crt_scan(a_t, acc, fbsk), want)
    assert not torch.equal(want, acc)


@pytest.mark.parametrize("mutation", ["gap", "prime", "step_before"])
def test_crt_scan_design_mutations_fail(mutation):
    """The rehearsal has teeth: the last quad left out of the Garner, a
    prime's residues read from the next group's buffers, or the Garner
    run on the accumulator of the step before, each gives another
    accumulator."""
    _, fbsk, _, _, a_t, acc = _scan_case(1, 1, 23, 3, True)
    kw = dict(primes=fbsk.primes, trunc_bits=fbsk.trunc_bits,
              base_log=fbsk.base_log, levels=fbsk.levels)
    want = tcs.blind_rotate_crt_scan_plain(a_t, acc, fbsk.spec_val,
                                           fbsk.spec_sh, **kw)
    assert not torch.equal(emulate_crt_scan(a_t, acc, fbsk, mutation), want)


def test_digit_top_is_the_digit_of_the_top_word():
    """csrc/digits.cuh digit_top (the acc32 mode's 32-bit digits) gives
    digit()'s bits on v = h 2^32 for every (lev + 1) base_log <= 31, the
    edge words included."""
    rng = np.random.default_rng(31)

    def digit(v, lev, bl):
        w0 = ((v >> (63 - lev * bl)) + 1) >> 1
        w1 = ((v >> (63 - (lev + 1) * bl)) + 1) >> 1
        return (w1 - (w0 << bl)) & 0xFFFFFFFF

    def digit_top(h, lev, bl):
        u0, u1 = h >> (31 - lev * bl), h >> (31 - (lev + 1) * bl)
        w0, w1 = (u0 >> 1) + (u0 & 1), (u1 >> 1) + (u1 & 1)
        return (w1 - (w0 << bl)) & 0xFFFFFFFF

    words = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF] + [
        int(h) for h in rng.integers(0, 1 << 32, 400, dtype=np.uint64)]
    for bl in range(1, 32):
        for lev in range(31 // bl):
            for h in words:
                assert digit_top(h, lev, bl) == digit(h << 32, lev, bl), \
                    (h, lev, bl)


def test_blind_rotate_fused_picks_its_form_and_counts_rows(monkeypatch):
    """blind_rotate_fused on the CPU by the rule: B = 2 at N=2048 through
    the fused persistent kernel's plain version, B = 5 through the
    one-launch scan's, B = 5 at N=1024 through the loop; every form gives
    the loop's bits; with tracing on, the span's form and the counters:
    pbs.crt_ntt_rows counts the rows of both forms above the latency rule,
    pbs.crt_ntt_scan_rows those of the one-launch scan alone."""
    calls = []
    for module, name in ((tfl, "blind_rotate_fused_latency_plain"),
                         (tcs, "blind_rotate_crt_scan_plain")):
        plain = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _p=plain, _n=name,
                            **k: calls.append(_n) or _p(*a, **k))
    tm.reset()
    tm.enable()
    try:
        forms = []
        for batch, n in ((2, 2048), (5, 2048), (5, 1024)):
            params, fbsk, ct, lut, a_t, acc = _scan_case(
                batch, 1, 23, 3, True, n=n)
            got = tfn.blind_rotate_fused(t64(ct), fbsk, t64(lut),
                                         _tparams(params))
            loop = tfn.scan_steps(a_t, acc.clone(), fbsk)
            assert torch.equal(got, tfn.last_accumulator(loop))
            forms.append(tfn.blind_rotate_form(batch, n, 2, 1, 3, True))
        snap = tm.snapshot()
    finally:
        tm.disable()
        tm.reset()
    assert forms == ["fused_latency", "crt_ntt_scan", "crt_ntt_loop"]
    assert calls == ["blind_rotate_fused_latency_plain",
                     "blind_rotate_crt_scan_plain"]
    assert [s["attrs"]["form"] for s in snap["spans"]
            if s["name"] == "pbs.blind_rotate"] == forms
    assert snap["counters"] == {"pbs.fused_latency_rows": 2,
                                "pbs.crt_ntt_rows": 10,
                                "pbs.crt_ntt_scan_rows": 5}
