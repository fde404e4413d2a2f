"""The CRT-NTT blind rotate at B <= LATENCY_BATCH_MAX in one launch
(``ops.fused_latency``, ``csrc/blind_rotate_fused_latency.cu``), on the CPU.

On the CPU ``blind_rotate_fused_latency`` runs its plain version, the
three-kernel scan on the plain versions of kernels 1, 3 and 4; the port's
``blind_rotate`` takes it for a fused key at B <= 4 where the shape rule
takes the shape, and is held here to the JAX package's oracles
(``blind_rotate_acc32_oracle``, ``refimpl.blind_rotate`` on the truncated
key) and, once each, to its ``blind_rotate_fused`` and ``pbs_batch`` in
interpret mode.  The rehearsal moves data as the CUDA kernel does: one
cluster per ciphertext of one block per (prime, output component); each
block takes its row's digits of every level from its own copy of the row,
runs their forward transforms on the register schedule of
``csrc/ntt_regs.cuh`` (tests/test_torch_fused_ntt.py's emulation), keeps
the spectra for the other blocks of its prime to read, multiplies them
with its key rows from a 2-slot ring, runs the inverse, and keeps the
residues for the other blocks of its row, which recombine the whole row
(Garner) from the P blocks'.  The blocks of a phase run one after another
and a barrier is the end of a phase, so a read before a barrier shows.
chip_smoke.py holds the CUDA kernel to the plain version and to the
three-kernel loop on the card.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import concrete_tpu.jax_config  # noqa: F401
import jax.numpy as jnp

import test_torch_fused_ntt as fnt
from concrete_tpu.core import kernels as kn
from concrete_tpu.core import refimpl as ref
from concrete_tpu.ops import pallas_fused_ntt as jfn
from concrete_tpu.params import CryptoParams
from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch import params as tpp
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.core import ntt as tntt
from concrete_tpu_torch.ops import fused_latency as tfl
from concrete_tpu_torch.ops import fused_ntt as tfn
from concrete_tpu_torch.ops import ntt as tn

M32 = (1 << 32) - 1
E = fnt.E


def _primes_and_shift(n, kp1, levels, base_log, n_primes):
    """The first `n_primes` special primes at N and the truncation their
    range needs (core.ntt's rule without the noise check): 0 where they
    hold the exact product."""
    params = tpp.CryptoParams(
        n_small=1, glwe_dimension=kp1 - 1, polynomial_size=n,
        pbs_level=levels, pbs_base_log=base_log, ks_level=1, ks_base_log=2,
        lwe_std=0.0, glwe_std=0.0, security_level=0)
    primes = tntt.special_ntt_primes(n, 128)[:n_primes]
    cap = math.prod(primes).bit_length() - 1
    return primes, max(0, tntt.required_bits(params, 0) - cap)


def _case(rng, batch, kp1, levels, n, n_primes, base_log, n_small, acc32):
    """The kernel's operands: a_t (B, n_small) int32, a random first
    accumulator (B, k+1, N) (uint32 top words or uint64), the spectra and
    companions of a random key (n_small, P Cin (k+1), N) uint32, the
    primes and the truncation."""
    primes, t = _primes_and_shift(n, kp1, levels, base_log, n_primes)
    a_t = rng.integers(0, 2 * n, (batch, n_small)).astype(np.int32)
    acc = rng.integers(0, 1 << (32 if acc32 else 64), (batch, kp1, n),
                       dtype=np.uint64)
    acc = acc.astype(np.uint32) if acc32 else acc
    bsk = rng.integers(0, 1 << 64, (n_small * levels * kp1 * kp1, n),
                       dtype=np.uint64)
    spec, sh = tn.ntt_forward_pack_plain(
        torch.from_numpy(bsk.view(np.int64)), primes, levels * kp1 * kp1, t)
    return (a_t, acc, spec.numpy().view(np.uint32),
            sh.numpy().view(np.uint32), primes, t)


def _plain(a_t, acc, spec, sh, *, primes, trunc_bits, base_log, levels):
    dt = np.int32 if acc.dtype == np.uint32 else np.int64
    out = tfl.blind_rotate_fused_latency_plain(
        torch.from_numpy(a_t), torch.from_numpy(acc.view(dt)),
        torch.from_numpy(spec.view(np.int32)),
        torch.from_numpy(sh.view(np.int32)), primes=primes,
        trunc_bits=trunc_bits, base_log=base_log, levels=levels)
    return out.numpy().view(acc.dtype)


def _digit(v, lev, base_log):
    """csrc/digits.cuh digit(): level lev's digit of v (u64) alone, from
    the rounded prefixes of levels lev - 1 and lev, as int64."""
    one = np.uint64(1)
    w_prev = ((v >> np.uint64(63 - lev * base_log)) + one) >> one
    w = ((v >> np.uint64(63 - (lev + 1) * base_log)) + one) >> one
    d = (w - (w_prev << np.uint64(base_log))) & np.uint64(M32)
    return d.astype(np.uint32).view(np.int32).astype(np.int64)


def _rotate_diff(row, a, top):
    """csrc/digits.cuh rotate_diff() at every t: X^a row - row (mod 2^64),
    row's values shifted up by `top` bits (32: the acc32 top words)."""
    n = row.shape[0]
    t = np.arange(n)
    s = (t - a) % (2 * n)
    v = row.astype(np.uint64) << np.uint64(top)
    x = v[np.where(s >= n, s - n, s)]
    return np.where(s >= n, np.uint64(0) - x, x) - v


def _garner(residues, acc_row, primes, shift, acc32, skip=None):
    """csrc/garner.cuh on one row: the residues (P, N) of the P blocks in
    prime order (prime `skip` left out) recombined and added to acc_row."""
    g = tntt.garner_constants(tuple(primes))
    w = np.zeros(acc_row.shape, np.uint64)
    frac = np.zeros(acc_row.shape, np.float64)
    for i, p in enumerate(primes):
        if i == skip:
            continue
        p64 = np.uint64(p)
        c = (fnt._shoup(residues[i].astype(np.uint64), np.uint64(g.inv[i]),
                        np.uint64(g.inv_sh[i]), p64) + np.uint64(g.hinv[i]))
        c = np.where(c >= p64, c - p64, c)
        w += c * np.uint64(g.m64[i])
        frac += c.astype(np.float64) * (1.0 / p)
    w -= frac.astype(np.uint64) * np.uint64(g.p64)
    if acc32:
        top = ((w << np.uint64(shift)) >> np.uint64(32)).astype(np.uint32)
        return acc_row + (top - np.uint32(tntt.h_top(primes, shift)))
    return acc_row + ((w - np.uint64(g.h64)) << np.uint64(shift))


def emulate_fused_latency(a_t, acc0, spec, sh, *, primes, trunc_bits,
                          base_log, levels, mutation=None):
    """The kernel's result (B, k+1, N), block by block.  `mutation`:
    "early_residues" (a block recombines its row right after its own
    inverse, before the residues' barrier: the other blocks' residues of
    the step may not be in), "slot_off_by_one" (the multiply-add reads the
    ring slot of the next step), "prime_left_out" (every block's Garner
    leaves the last prime out), "shift_off_by_one" (the truncation shift
    one bit further)."""
    batch, kp1, n = acc0.shape
    n_small = a_t.shape[1]
    n_p, cin = len(primes), levels * kp1
    acc32 = acc0.dtype == np.uint32
    top = 32 if acc32 else 0
    shift = trunc_bits + (mutation == "shift_off_by_one")
    pairs = fnt._pairs(n, primes)
    cst = tntt.prime_constants(n, primes).astype(np.uint64)
    blocks = [(pr, co) for pr in range(n_p) for co in range(kp1)]
    ring = [None, None]

    def stage_key(i):
        """Step i's 2 Cin rows of each block (p, co) into slot i & 1: row
        2 ci the spectrum, 2 ci + 1 the companions of key row (p Cin + ci)
        (k+1) + co."""
        if i >= n_small:
            return
        ring[i & 1] = {
            (pr, co): np.stack([(sh if r & 1 else spec)[i][
                (pr * cin + (r >> 1)) * kp1 + co]
                for r in range(2 * cin)]).astype(np.uint64)
            for pr, co in blocks}

    out = np.empty_like(acc0)
    for b in range(batch):
        # each block's own copy of its row co, on chip across the steps
        rows = {(pr, co): acc0[b, co].copy() for pr, co in blocks}
        spec_sm, res_sm = {}, {blk: np.zeros(n, np.uint64) for blk in blocks}
        ring[:] = [None, None]
        stage_key(0)
        stage_key(1)
        for i in range(n_small):
            if i >= 1:
                stage_key(i + 1)
            a = int(a_t[b, i])
            # 1. level lev's digits of the block's row, their forward
            #    transform (group lev), the spectrum kept for the others
            for pr, co in blocks:
                p = np.uint64(primes[pr])
                v = _rotate_diff(rows[pr, co], a, top)
                spec_sm[pr, co] = []
                for lev in range(levels):
                    d = _digit(v, lev, base_log)
                    x = np.where(d < 0, d + int(p), d).astype(np.uint64)
                    spec_sm[pr, co].append(fnt._sched_forward(
                        x, pairs[pr, 0], p, n).reshape(-1))
            # --- barrier: every block's spectra in
            for pr, co in blocks:
                p = np.uint64(primes[pr])
                slot = ring[(i + 1) & 1 if mutation == "slot_off_by_one"
                            else i & 1][pr, co]
                # 2. the multiply-add, spectrum lev of block (pr, comp) for
                #    ci = lev (k+1) + comp, 4 coefficients a thread
                hat = np.zeros(n, np.uint64)
                for ci in range(cin):
                    lev, comp = divmod(ci, kp1)
                    prod = fnt._shoup(spec_sm[pr, comp][lev], slot[2 * ci],
                                      slot[2 * ci + 1], p)
                    hat = hat + prod
                    hat = np.where(hat >= p, hat - p, hat)
                # 3. group 0: the inverse of hat, 16 g .. 16 g + 15 in
                #    thread g, stored at pass 0's positions
                res_sm[pr, co] = fnt._sched_inverse(
                    hat.reshape(n // E, E).copy(), pairs[pr, 1], p, n,
                    cst[pr, 1], cst[pr, 2])
                if mutation == "early_residues":
                    rows[pr, co] = _garner(
                        np.stack([res_sm[q, co] for q in range(n_p)]),
                        rows[pr, co], primes, shift, acc32)
            if mutation == "early_residues":
                continue
            # --- barrier: every block's residues in
            for pr, co in blocks:
                # 4. the Garner of the block's whole row from the P blocks
                #    (q, co) of the row
                rows[pr, co] = _garner(
                    np.stack([res_sm[q, co] for q in range(n_p)]),
                    rows[pr, co], primes, shift, acc32,
                    skip=n_p - 1 if mutation == "prime_left_out" else None)
        for co in range(kp1):
            # the P copies of a row are one accumulator
            assert all(np.array_equal(rows[pr, co], rows[0, co])
                       for pr in range(n_p)) or mutation
            out[b, co] = rows[0, co]
    return out


DESIGN_CASES = [
    # batch, kp1, levels, n, n_primes, base_log, n_small, acc32
    (1, 2, 2, 256, 3, 8, 4, True),      # exact key, even n_small
    (2, 3, 1, 256, 2, 12, 3, False),    # truncated key, odd n_small
    (3, 3, 2, 128, 3, 10, 2, False),    # exact, full mode
    (4, 2, 1, 256, 2, 20, 3, True),     # truncated, acc32
]


@pytest.mark.parametrize(
    "batch,kp1,levels,n,n_primes,base_log,n_small,acc32", DESIGN_CASES,
    ids=["b1-k2-p3-acc32", "b2-k3-p2-full", "b3-k3-p3-full",
         "b4-k2-p2-acc32"])
def test_fused_design_matches_plain(batch, kp1, levels, n, n_primes,
                                    base_log, n_small, acc32):
    """The rehearsed kernel == blind_rotate_fused_latency_plain over 2-4
    steps: clusters of 4-9 blocks (k+1 = 2 and 3, P = 2 and 3), B = 1 ..
    4, one and two levels, both accumulator modes, an exact and a
    truncated key, an even and an odd step count."""
    rng = np.random.default_rng(batch * 100 + n + kp1)
    a_t, acc, spec, sh, primes, t = _case(rng, batch, kp1, levels, n,
                                          n_primes, base_log, n_small, acc32)
    assert (t > 0) == (n_primes == 2)
    kw = dict(primes=primes, trunc_bits=t, base_log=base_log, levels=levels)
    want = _plain(a_t, acc, spec, sh, **kw)
    got = emulate_fused_latency(a_t, acc, spec, sh, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mutation", ["early_residues", "slot_off_by_one",
                                      "prime_left_out", "shift_off_by_one"])
def test_fused_design_mutations_fail(mutation):
    """The rehearsal has teeth: a row recombined before the residues'
    barrier, the key ring's slot a step off, a prime left out of the
    Garner, or the truncation shift one bit off, each gives another
    accumulator."""
    batch, kp1, levels, n, n_primes, base_log, n_small, acc32 = \
        DESIGN_CASES[3]
    rng = np.random.default_rng(11)
    a_t, acc, spec, sh, primes, t = _case(rng, batch, kp1, levels, n,
                                          n_primes, base_log, n_small, acc32)
    kw = dict(primes=primes, trunc_bits=t, base_log=base_log, levels=levels)
    want = _plain(a_t, acc, spec, sh, **kw)
    got = emulate_fused_latency(a_t, acc, spec, sh, mutation=mutation, **kw)
    assert not np.array_equal(got, want)


# the models' CRT-NTT lookups (N, k+1, l, P, acc32) at the default
# Configuration(): LevenshteinDistance(8, 8, 2), StaticKeyValueDatabase
# over 16 keys, and over keys 0 and 30
MODEL_SHAPES = {"levenshtein": (1024, 3, 2, 3, True),
                "kvdb_16": (2048, 2, 1, 3, True),
                "kvdb_2": (2048, 2, 2, 2, True)}


def test_plan_takes_the_model_shapes():
    """The shape rule takes the three models' B = 1 lookups at B = 1 .. 4
    in both modes (clusters of 9, 6 and 4 blocks) and the rehearsal's
    N = 1024 shapes below; the MLP's N = 4096, k+1 = 2, l = 2 shape it
    refuses: its key ring of two steps is 256 KB."""
    for name, (n, kp1, levels, n_p, _) in MODEL_SHAPES.items():
        for batch in (1, 2, 3, 4):
            for acc32 in (True, False):
                pl = tfl.plan(batch, n, kp1, levels, n_p, acc32)
                assert pl is not None, (name, batch, acc32)
                assert pl.cluster == n_p * kp1 and pl.smem <= tfl.MAX_SMEM
                assert pl.threads == levels * n // 16
    assert tfl.plan(1, 1024, 3, 2, 3, True).ring_slot == 48 * 1024
    assert tfl.plan(1, 4096, 2, 2, 3, True) is None
    assert 2 * 2 * 4 * 4096 * 4 > tfl.MAX_SMEM
    for n, kp1, levels, n_p in ((1024, 2, 2, 3), (1024, 3, 2, 2),
                                (2048, 2, 2, 3)):
        assert tfl.plan(4, n, kp1, levels, n_p, False) is not None


def _csrc(name):
    return (Path(tfl.__file__).parent.parent / "csrc" / name).read_text()


def test_plan_layout_is_the_kernels():
    """plan()'s limits are the kernel's FL_MAX_* constants, its transform
    sizes the kernel's FL_CASE instantiations and make_plan's bounds, its
    E csrc/ntt_regs.cuh's; it lays shared memory out as make_plan does:
    the accumulator row (4 or 8 bytes a word), l spectra, l pairs of
    exchange buffers, the sums, the residues, two ring slots of 2 Cin
    rows, four mbarriers; every region 16-byte aligned."""
    src = _csrc("blind_rotate_fused_latency.cu")
    consts = {name: math.prod(int(f) for f in expr.split("*"))
              for name, expr in re.findall(
                  r"constexpr \w+ FL_(MAX_\w+) = ([\d *]+);", src)}
    assert consts == {name: getattr(tfl, name) for name in (
        "MAX_SMEM", "MAX_CLUSTER", "MAX_PRIMES", "MAX_THREADS",
        "MAX_BATCH")}
    log_n = tuple(int(x) for x in re.findall(r"FL_CASE\((\d+)\)", src))
    assert log_n == tfl.LOG_N
    assert f"log_n < {min(log_n)} || log_n > {max(log_n)}" in src
    assert f"constexpr int E = {tfl.E};" in _csrc("ntt_regs.cuh")
    n, kp1, levels, n_p = 2048, 2, 2, 2
    for acc32, word in ((True, 4), (False, 8)):
        pl = tfl.plan(1, n, kp1, levels, n_p, acc32)
        assert pl.off_spec == n * word
        assert pl.off_exch - pl.off_spec == levels * n * 4
        assert pl.off_hat - pl.off_exch == levels * 2 * n * 4
        assert pl.off_res - pl.off_hat == n * 4
        assert pl.off_ring - pl.off_res == n * 4
        assert pl.ring_slot == 2 * levels * kp1 * n * 4
        assert pl.off_bar - pl.off_ring == 2 * pl.ring_slot
        assert pl.smem == pl.off_bar + 32
        assert all(o % 16 == 0 for o in (pl.off_spec, pl.off_exch,
                                         pl.off_hat, pl.off_res,
                                         pl.off_ring, pl.off_bar))
    # KVDB with keys 0 and 30 at full mode: 208 KB of the 227
    assert tfl.plan(1, 2048, 2, 2, 2, False).smem == 213024


@pytest.mark.parametrize("batch,n,kp1,levels,n_p", [
    (9, 1024, 3, 2, 3),         # more clusters than the card holds at once
    (1, 1024, 3, 2, 6),         # a cluster of 18 blocks
    (1, 8192, 2, 1, 2),         # N beyond the compiled transform sizes
    (1, 512, 2, 2, 3),          # N below them
    (1, 4096, 2, 2, 3),         # the MLP's ring: 256 KB
    (1, 1024, 2, 5, 2),         # 5 levels: 320 threads and a producer
], ids=["b9", "cluster18", "n8192", "n512", "mlp", "threads"])
def test_plan_refuses_oversized_shapes(batch, n, kp1, levels, n_p):
    """Beyond the rule the three-kernel loop runs."""
    assert tfl.plan(batch, n, kp1, levels, n_p, True) is None


def test_blind_rotate_fused_latency_rejects_mismatched_operands():
    a_t = torch.zeros((2, 3), dtype=torch.int32)
    acc = torch.zeros((2, 2, 1024), dtype=torch.int32)
    spec = torch.zeros((3, 2 * 2 * 2 * 2, 1024), dtype=torch.int32)
    kw = dict(primes=(1, 2), trunc_bits=0, base_log=8, levels=2)
    with pytest.raises(ValueError, match="do not match"):
        tfl.blind_rotate_fused_latency(a_t, acc, spec[:2], spec[:2], **kw)
    with pytest.raises(ValueError, match="do not match"):
        tfl.blind_rotate_fused_latency(a_t, acc, spec, spec,
                                       **{**kw, "levels": 1})
    with pytest.raises(ValueError, match="do not match"):
        tfl.blind_rotate_fused_latency(a_t[:1], acc, spec, spec, **kw)
    with pytest.raises(ValueError, match="must be"):
        tfl.blind_rotate_fused_latency(a_t[0], acc, spec, spec, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        tfl.blind_rotate_fused_latency(a_t, acc.to("meta"), spec, spec,
                                       **kw)


def _params(n_small, levels=2, base_log=8, kp1=2):
    return CryptoParams(
        n_small=n_small, glwe_dimension=kp1 - 1, polynomial_size=1024,
        pbs_level=levels, pbs_base_log=base_log, ks_level=2, ks_base_log=8,
        lwe_std=2.0 ** -25, glwe_std=2.0 ** -35, security_level=0)


def _tparams(p):
    return tpp.CryptoParams(**dataclasses.asdict(p))


def _route(monkeypatch):
    """Calls of blind_rotate_fused_latency's plain version."""
    calls = []
    plain = tfl.blind_rotate_fused_latency_plain

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return plain(*args, **kw)
    monkeypatch.setattr(tfl, "blind_rotate_fused_latency_plain", spy)
    return calls


@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_blind_rotate_takes_the_kernel_and_matches_oracles(batch,
                                                           monkeypatch):
    """The port's blind_rotate on a FusedBSK at B = 1 .. 4 takes
    blind_rotate_fused_latency (its plain version on the CPU): in the
    acc32 mode (the default here) == blind_rotate_acc32_oracle, and in
    full mode (blind_rotate_fused's acc32=False, by the same route) ==
    refimpl.blind_rotate on truncate_bsk_u64(bsk, t); k+1 = 3
    at B = 3 and 4, a truncated key (2 primes) at B = 2 and 4."""
    kp1 = 3 if batch >= 3 else 2
    params = _params(n_small=3, kp1=kp1)
    tparams = _tparams(params)
    rng = np.random.default_rng(70 + batch)
    bsk = rng.integers(0, 1 << 64, (params.n_small, params.pbs_level, kp1,
                                    kp1, 1024), dtype=np.uint64)
    ct = rng.integers(0, 1 << 64, (batch, params.n_small + 1),
                      dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, 1024, dtype=np.uint64)
    primes, t = _primes_and_shift(1024, kp1, 2, 8, 2 if batch % 2 == 0
                                  else 3)
    fbsk = tfn.pack_bsk_fused(bsk, tparams, primes=primes, trunc_bits=t,
                              device="cpu")
    calls = _route(monkeypatch)
    got = tk.blind_rotate(torch.from_numpy(ct.view(np.int64)), fbsk,
                          torch.from_numpy(lut.view(np.int64)), tparams)
    assert calls == [batch] and tfn.acc32_eligible(fbsk)
    got = got.numpy().view(np.uint64)
    full = tfn.blind_rotate_fused(
        torch.from_numpy(ct.view(np.int64)), fbsk,
        torch.from_numpy(lut.view(np.int64)), tparams, acc32=False)
    assert calls == [batch, batch]
    full = full.numpy().view(np.uint64)
    oracle_bsk = jfn.truncate_bsk_u64(bsk, t)
    for b in range(batch):
        assert np.array_equal(got[b], jfn.blind_rotate_acc32_oracle(
            ct[b], bsk, lut, params, primes, t))
        assert np.array_equal(full[b], ref.blind_rotate(ct[b], oracle_bsk,
                                                        lut, params))


def test_blind_rotate_keeps_the_loop_past_the_rule(monkeypatch):
    """Above LATENCY_BATCH_MAX, and at a shape the rule refuses, a fused
    key keeps ops.fused_ntt.blind_rotate_fused's loop (same bits)."""
    params = _params(n_small=2)
    tparams = _tparams(params)
    rng = np.random.default_rng(3)
    bsk = rng.integers(0, 1 << 64, (2, 2, 2, 2, 1024), dtype=np.uint64)
    ct = rng.integers(0, 1 << 64, (5, 3), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, 1024, dtype=np.uint64)
    primes = tntt.special_ntt_primes(1024, 128)[:3]
    fbsk = tfn.pack_bsk_fused(bsk, tparams, primes=primes, trunc_bits=0,
                              device="cpu")
    calls = _route(monkeypatch)
    ct_t = torch.from_numpy(ct.view(np.int64))
    lut_t = torch.from_numpy(lut.view(np.int64))
    loop = tk.blind_rotate(ct_t, fbsk, lut_t, tparams)
    assert calls == [] and tk.LATENCY_BATCH_MAX == 4
    monkeypatch.setattr(tfl, "MAX_CLUSTER", 4)        # refuses 3 x 2 blocks
    refused = tk.blind_rotate(ct_t[:2], fbsk, lut_t, tparams)
    monkeypatch.undo()
    calls = _route(monkeypatch)
    taken = tk.blind_rotate(ct_t[:2], fbsk, lut_t, tparams)
    assert calls == [2]
    assert torch.equal(refused, taken) and torch.equal(loop[:2], taken)


def test_blind_rotate_matches_pallas_interpret(monkeypatch):
    """One case against the JAX package's blind_rotate_fused itself
    (interpret mode) at N = 1024, 4 steps, B = 1, its default acc32
    mode."""
    params = _params(n_small=4)
    rng = np.random.default_rng(21)
    bsk = rng.integers(0, 1 << 64, (4, 2, 2, 2, 1024), dtype=np.uint64)
    ct = rng.integers(0, 1 << 64, (1, 5), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, 1024, dtype=np.uint64)
    primes, t = jfn.choose_fused_primes(params, message_bits=3)
    jbsk = jfn.pack_bsk_fused(bsk, params, primes=primes, trunc_bits=t)
    tbsk = tfn.pack_bsk_fused(bsk, _tparams(params), primes=primes,
                              trunc_bits=t, device="cpu")
    want = np.asarray(jfn.blind_rotate_fused(
        jnp.asarray(ct), jbsk, jnp.asarray(lut), params, interpret=True))
    calls = _route(monkeypatch)
    got = tk.blind_rotate(torch.from_numpy(ct.view(np.int64)), tbsk,
                          torch.from_numpy(lut.view(np.int64)),
                          _tparams(params))
    assert calls == [1]
    assert np.array_equal(got.numpy().view(np.uint64), want)


def test_pbs_batch_b1_fused_matches_jax(monkeypatch):
    """pbs_batch at B = 1 on a fused key == the JAX package's pbs_batch
    (its blind_rotate_fused in interpret mode), N = 1024, 3 steps, the
    keys from refimpl.keygen."""
    params = _params(n_small=3)
    tparams = _tparams(params)
    sk, server = ref.keygen(np.random.default_rng(9), params)
    rng = np.random.default_rng(10)
    ct = ref.lwe_encrypt(rng, sk.lwe_big, ref.encode(np.array([5]), 3),
                         params.glwe_std)
    table = np.array([(3 * v + 1) % 8 for v in range(8)], dtype=np.uint64)
    lut = ref.encode_expand_lut(table, 1024, 3)
    primes, t = jfn.choose_fused_primes(params, message_bits=3)
    calls = _route(monkeypatch)
    got = tk.pbs_batch(
        torch.from_numpy(ct.view(np.int64)),
        tk.pack_ksk(server.ksk, tparams, device="cpu"),
        tfn.pack_bsk_fused(server.bsk, tparams, primes=primes,
                           trunc_bits=t, device="cpu"),
        torch.from_numpy(lut.view(np.int64)), tparams, 3)
    want = np.asarray(kn.pbs_batch(
        jnp.asarray(ct), kn.pack_ksk(server.ksk, params),
        jfn.pack_bsk_fused(server.bsk, params, primes=primes, trunc_bits=t),
        jnp.asarray(lut), params, 3))
    assert calls == [1]
    assert np.array_equal(got.numpy().view(np.uint64), want)
