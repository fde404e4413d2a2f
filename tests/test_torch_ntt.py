"""Kernel 2 (csrc/ntt.cu, csrc/ntt_inverse.cu) rehearsed in numpy, on CPU.

The kernel cannot run here, so its arithmetic and layout are emulated with
u32 words held in numpy uint64, as the kernel computes them: the
division-free reduction of a signed 64-bit input to a residue, the key
pack's Shoup companions from a reciprocal, the register schedule of
csrc/ntt_regs.cuh (kernel 3's, emulated in tests/test_torch_fused_ntt.py),
each block's loads and stores, and the pack's row map into the FusedBSK
layout.  Each emulation is held to the port's plain versions (ops/ntt.py)
and to the JAX package (its host NTT, its ``pack_bsk_fused``), and each
check is shown to fail under a named mutation of the kernel's arithmetic.
chip_smoke.py holds the CUDA kernel to the plain versions on the card.
"""

import math

import numpy as np
import pytest
import torch

import concrete_tpu.jax_config  # noqa: F401
from concrete_tpu.core import ntt as jntt_host
from concrete_tpu.ops import pallas_fused_ntt as jfn

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.core import ntt as tntt
from concrete_tpu_torch.ops import fused_ntt as tfn
from concrete_tpu_torch.ops import ntt as tn

from test_torch_fused_ntt import (E, M32, _four_step, _pairs, _params,
                                  _pos, _random_inputs, _sched_forward,
                                  _sched_inverse, _shoup, _tparams,
                                  register_passes)

MLP_PRIMES = tntt.special_ntt_primes(4096, 128)[:3]
# primes far below 2^31 (2N | p - 1 at N = 1024, 16 and 4): the high word
# of an input holds many multiples of them
SMALL_PRIMES = (12289, 40961, 97, 17)
EDGES = [-(1 << 63), (1 << 63) - 1, -1, 0, 1, -(1 << 32), (1 << 32) - 1,
         1 << 32, -(1 << 31), (1 << 31) - 1]
U31 = np.uint64(1 << 31)


def _consts(primes, n=16):
    """Kernel 2's (P, 8) constant rows as uint64 words."""
    return tntt.forward_constants(n, tuple(primes)).astype(np.uint64)


def _reduce_once(x, p):
    return np.where(x >= p, x - p, x)


def _residue(v, c, mutation=None):
    """csrc/ntt.cu residue(): the int64 values v as lo and hi words,
    Shoup products of hi by 2^32 mod p and of lo by 1, summed, and 2^64
    mod p taken off a negative v."""
    p, c32, c32_sh, r_hi, c64 = c[0], c[3], c[4], c[5], c[7]
    u = np.asarray(v, dtype=np.int64).view(np.uint64)
    lo, hi = u & M32, u >> np.uint64(32)
    r = _reduce_once(_shoup(hi, c32, c32_sh, p)
                     + _shoup(lo, np.uint64(1), r_hi, p), p)
    if mutation == "no_sign_correction":
        return r
    return np.where(hi >= U31, _reduce_once(r + p - c64, p), r)


def _companion(v, c, mutation=None):
    """csrc/ntt.cu companion(): floor(v 2^32 / p) for v < p from the
    reciprocal floor(2^64 / p) = r_hi 2^32 + r_lo and one correction."""
    p, r_hi, r_lo = c[0], c[5], c[6]
    q = (v * r_hi + ((v * r_lo) >> np.uint64(32))) & M32
    if mutation == "companion_no_correction":
        return q
    if mutation == "companion_plus_one":
        return (q + np.uint64(1)) & M32
    rem = (np.uint64(0) - q * p) & M32          # v 2^32 - q p, in [0, 2p)
    return np.where(rem >= p, q + np.uint64(1), q)


def _pack_row(m, pr, rows, n_primes, n_small, mutation=None):
    """The pack's output row of polynomial m = s rows + r mod prime pr:
    (s P + pr) rows + r, the FusedBSK row (pr Cin + ci)(k+1) + co of step
    s.  (The standalone transform passes rows = M: row pr M + m.)"""
    s, r = divmod(m, rows)
    if mutation == "transposed_row":
        return (pr * n_small + s) * rows + r
    return (s * n_primes + pr) * rows + r


def _forward_block(x_row, pr, primes, n, shift=0, mutation=None):
    """One block of ntt_forward_kernel for one prime: its groups' int64
    inputs at the first pass's positions, >> shift, reduced, through the
    register schedule; returns the row as stored (thread g's residues at
    16g .. 16g+15)."""
    c = _consts(primes, n)[pr]
    g = np.arange(n // E)[:, None]
    ls0 = register_passes(n)[0][2]
    idx = _pos(g, ls0, np.arange(E)[None, :])
    coeffs = np.empty(n, np.uint64)
    coeffs[idx] = _residue(x_row[idx] >> shift, c, mutation)
    return _sched_forward(coeffs, _pairs(n, primes)[pr, 0], c[0],
                          n).reshape(-1)


def _case(n, primes, polys, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 63), 1 << 63, (polys, n), dtype=np.int64)
    flat = x.reshape(-1)
    flat[:len(EDGES)] = EDGES[:flat.size]
    return x


@pytest.mark.parametrize("mutation", [None, "no_sign_correction"])
@pytest.mark.parametrize("primes", [MLP_PRIMES, SMALL_PRIMES],
                         ids=["mlp", "small"])
def test_residue_is_division_free_and_exact(primes, mutation):
    """The residue of every signed 64-bit edge value (-2^63, 2^63 - 1, -1,
    the word boundaries) and of random ones, for the MLP archive's primes
    and for primes far below 2^31, equals v mod p; leaving out the sign
    correction breaks it."""
    rng = np.random.default_rng(5)
    v = np.concatenate([np.array(EDGES, dtype=np.int64),
                        rng.integers(-(1 << 63), 1 << 63, 4096,
                                     dtype=np.int64)])
    v_int = [int(a) for a in v]
    ok = True
    for pr, p in enumerate(primes):
        got = _residue(v, _consts(primes)[pr], mutation)
        ok &= [int(a) for a in got] == [a % p for a in v_int]
    assert ok == (mutation is None)


@pytest.mark.parametrize("mutation", [None, "companion_no_correction",
                                      "companion_plus_one"])
def test_companion_is_exact(mutation):
    """floor(v 2^32 / p) from the reciprocal equals the integer division
    at v = 0, 1, p - 1 and at random v < p, for every prime; the
    quotient without its correction, or one past it, does not."""
    rng = np.random.default_rng(6)
    primes = MLP_PRIMES + SMALL_PRIMES
    ok = True
    for pr, p in enumerate(primes):
        v = np.concatenate([np.array([0, 1, p - 1]),
                            rng.integers(0, p, 8192)]).astype(np.uint64)
        got = _companion(v, _consts(primes)[pr], mutation)
        ok &= np.array_equal(got, (v << np.uint64(32)) // np.uint64(p))
    assert ok == (mutation is None)


@pytest.mark.parametrize("n", [16, 64, 1024, 16384])
def test_forward_blocks_match_plain_and_host(n):
    """The kernel's blocks over signed 64-bit inputs (edge values
    included) == ntt_forward_plain at (P, M, N), row pr M + m, and the JAX
    package's host transform in natural order; for a prime near 2^31 and
    one far below it."""
    small = next(p for p in SMALL_PRIMES if (p - 1) % (2 * n) == 0) \
        if n <= 1024 else None
    primes = tntt.special_ntt_primes(n, 128)[:1] + ((small,) if small
                                                    else ())
    polys = 2 if n < 16384 else 1
    x = _case(n, primes, polys, n)
    got = np.zeros((len(primes) * polys, n), np.uint64)
    for m in range(polys):
        for pr in range(len(primes)):
            got[_pack_row(m, pr, polys, len(primes), 1)] = \
                _forward_block(x[m], pr, primes, n)
    got = got.reshape(len(primes), polys, n)
    want = tn.ntt_forward_plain(torch.from_numpy(x), primes).numpy() \
        .view(np.uint32)
    assert np.array_equal(got, want)
    if n <= 1024:
        for pr, p in enumerate(primes):
            nat = jntt_host.ntt_forward(x % p, n, p)
            assert np.array_equal(got[pr][:, tntt.bit_reverse(n)], nat)


@pytest.mark.parametrize("n", [16, 1024, 16384])
def test_inverse_blocks_match_plain(n):
    """ntt_inverse_kernel: each thread reads residues 16g .. 16g+15 (the
    forward's store), runs the passes backward and stores the 1/N-scaled
    residues at the first pass's positions; == ntt_inverse_plain, and the
    coefficients come back."""
    primes = tntt.special_ntt_primes(n, 128)[:2]
    x = _case(n, primes, 1, n + 1)
    spec = tn.ntt_forward_plain(torch.from_numpy(x), primes)
    want = tn.ntt_inverse_plain(spec, primes).numpy().view(np.uint32)
    cst = _consts(primes, n)
    for pr, p in enumerate(primes):
        rows = spec[pr].numpy().view(np.uint32).astype(np.uint64)
        got = _sched_inverse(rows[0].reshape(n // E, E),
                             _pairs(n, primes)[pr, 1], cst[pr, 0], n,
                             cst[pr, 1], cst[pr, 2])
        assert np.array_equal(got, want[pr, 0])
        assert [int(a) for a in got] == [int(a) % p for a in x[0]]


@pytest.mark.parametrize("n_primes,mutation", [
    (3, None), (2, None), (3, "transposed_row"), (3, "no_sign_correction"),
    (3, "companion_plus_one")])
def test_pack_rehearsal_matches_fused_bsk(n_primes, mutation):
    """The pack entry block by block: each BSK polynomial >> t
    (arithmetic), reduced, transformed, its spectrum and companions stored
    at the FusedBSK row of its step and prime; == pack_bsk_fused's plain
    path and the JAX package's spec_val and spec_sh, for an untruncated
    key (3 primes) and a truncated one (2 primes).  A transposed row, a
    missing sign correction or an off-by-one companion breaks it."""
    n = 1024
    params = _params(n, n_small=2)
    bsk, _, _ = _random_inputs(np.random.default_rng(21 + n_primes), params,
                               1)
    primes = tntt.special_ntt_primes(n, 128)[:n_primes]
    t = max(0, tntt.required_bits(params, 0)
            - (math.prod(primes).bit_length() - 1))
    assert (t > 0) == (n_primes == 2)
    n_small, levels, kp1 = bsk.shape[:3]
    rows = levels * kp1 * kp1
    x = bsk.view(np.int64).reshape(-1, n)
    cst = _consts(primes, n)
    val = np.full((n_small * n_primes * rows, n), 1 << 40, np.uint64)
    sh = val.copy()
    for m in range(x.shape[0]):
        for pr in range(n_primes):
            row = _pack_row(m, pr, rows, n_primes, n_small, mutation)
            val[row] = _forward_block(x[m], pr, primes, n, t, mutation)
            sh[row] = _companion(val[row], cst[pr], mutation)
    val = val.reshape(n_small, n_primes * rows, n)
    sh = sh.reshape(val.shape)
    got = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                             trunc_bits=t, device="cpu")
    want = jfn.pack_bsk_fused(bsk, params, primes=primes, trunc_bits=t)
    same = (np.array_equal(val, got.spec_val.numpy().view(np.uint32))
            and np.array_equal(sh, got.spec_sh.numpy().view(np.uint32)))
    assert same == (mutation is None)
    if mutation is None:
        for g, w in ((val, want.spec_val), (sh, want.spec_sh)):
            assert np.array_equal(_four_step(g.astype(np.uint32), n),
                                  np.asarray(w))


@pytest.mark.parametrize("n", [4, 8])
def test_tiny_sizes_match_host_and_round_trip(n):
    """N = 4 and 8, which the card runs one thread per transform with the
    plain version's butterflies: the spectra equal the JAX package's host
    transform and the inverse gives the residues back."""
    primes = (17, 97)
    x = _case(n, primes, 3, n)
    spec = tn.ntt_forward(torch.from_numpy(x), primes)
    for pr, p in enumerate(primes):
        nat = jntt_host.ntt_forward(x % p, n, p)
        assert np.array_equal(spec[pr].numpy()[:, tntt.bit_reverse(n)], nat)
    assert np.array_equal(tn.ntt_inverse(spec, primes).numpy(),
                          np.stack([x % p for p in primes]))


def test_pack_wrapper_plain_is_the_pack_layout():
    """ntt_forward_pack on CPU tensors (the plain version) gives the
    standalone transform's spectra moved into the FusedBSK rows, with
    companions by integer division."""
    n, rows, primes, t = 1024, 4, MLP_PRIMES, 5
    x = torch.from_numpy(_case(n, primes, 2 * rows, 9))
    val, sh = tn.ntt_forward_pack(x, primes, rows, t)
    spec = tn.ntt_forward(x >> t, primes)
    for m in range(x.shape[0]):
        for pr, p in enumerate(primes):
            s, r = divmod(m, rows)
            assert torch.equal(val[s, pr * rows + r], spec[pr, m])
            v = val[s, pr * rows + r].to(torch.int64) & 0xFFFFFFFF
            assert torch.equal(sh[s, pr * rows + r].to(torch.int64)
                               & 0xFFFFFFFF, (v << 32) // p)


def _staged_store(rows, mutation=None):
    """store_spectrum in csrc/ntt.cu for one warp: lane l holds the 16
    residues of row l (16 l .. 16 l + 15 of the warp's 512 words); it
    writes them as four 16-byte slots at 4 l + ((q + (l >> 1)) & 3) of the
    warp's shared region, and store j then has lane l read slot q' = l & 3
    of row r = 8 j + (l >> 2) and write words 128 j + 4 l .. 4 l + 3.
    Returns the 512 words as stored and, per access, the 16-byte bank
    groups of each phase of 8 lanes."""
    lanes = np.arange(32)
    region = np.full((128, 4), -1, np.int64)
    banks = []
    for q in range(4):
        slot = 4 * lanes + ((q + (lanes >> 1)) & 3)
        region[slot] = rows[:, 4 * q:4 * q + 4]
        banks.append(slot % 8)
    out = np.full(512, -1, np.int64)
    for j in range(4):
        r, qq = 8 * j + (lanes >> 2), lanes & 3
        slot = 4 * r + (qq if mutation == "unrotated_read"
                        else (qq + (r >> 1)) & 3)
        out.reshape(128, 4)[32 * j + lanes] = region[slot]
        banks.append(slot % 8)
    return out, banks


@pytest.mark.parametrize("mutation", [None, "unrotated_read"])
def test_staged_store_layout(mutation):
    """A warp's staged stores write its 512 words in order (store j, lane l
    at words 128 j + 4 l), and every 16-byte shared-memory access of
    either side is free of bank conflicts (8 lanes a phase, 8 distinct
    4-bank groups); reading the slots without their rotation scrambles
    the row."""
    rows = np.arange(512).reshape(32, 16)
    out, banks = _staged_store(rows, mutation)
    for b in banks:
        for phase in range(4):
            assert len(set(b[8 * phase:8 * phase + 8].tolist())) == 8
    assert np.array_equal(out, np.arange(512)) == (mutation is None)


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 16384])
def test_last_pass_twiddles_are_consecutive(n):
    """last_pass in csrc/ntt.cu reads stage q's 2^(4-R+q) pairs of group g
    from 2^(s0+q) + g 2^(4-R+q) by 16-byte loads: the same pairs, in the
    same order, as pass's index 2^(s0+q) + (blk << (4-R+q)) + (k >> (R-q))
    with blk = g (the last pass has stride 1), and 16-byte aligned
    wherever there are two or more."""
    s0, r, ls = register_passes(n)[-1]
    assert ls == 0
    g = np.arange(n // E)[:, None]
    for q in range(r):
        pairs = 1 << (4 - r + q)
        k = np.arange(E)[None, :]
        want = (1 << (s0 + q)) + (g << (4 - r + q)) + (k >> (r - q))
        start = (1 << (s0 + q)) + g * pairs
        assert np.array_equal(start + (k >> (r - q)), want)
        assert (want - start).max() < pairs
        if pairs > 1:
            assert not (start % 2).any()
