"""The port's latency blind rotate (B <= LATENCY_BATCH_MAX) against the JAX
package, bit for bit, on the CPU, and the persistent kernel's design
(``csrc/blind_rotate_latency.cu``) rehearsed in numpy.

On the CPU ``ops.latency.blind_rotate_latency`` runs its plain version, the
three-kernel step loop on the plain versions of kernel 1, kernel 9's
latency form and the recombine; here it is held to the JAX package's
``_blind_rotate_xla_latency``.  The rehearsal moves data as the CUDA kernel
does: one cluster of blocks per ciphertext, each block a slice of the
outputs t holding its slice of the accumulator in two buffers; per step
each block copies in every block's buffer of the step, recomputes every
digit, builds kernel 9's band views for its t slice
(tests/test_torch_banded_mm.py's emulation of ``csrc/banded_latency.cuh``),
and runs kernel 9's fragments warp by warp: 16 K chunks over all 4
t-tiles, tiles 2 and 3 taking the A fragments tiles 0 and 1 had a k-step
before; the partials are kept in C-fragment order and read back by the
recombine's index arithmetic into the other buffer.  The key rows come
from each block's ring of two whole steps, or of one where two do not fit
(the shape rule forced down at small shapes), refilled as the kernel's
producer warp refills it.  The blocks of a step run one after another, so
a single accumulator buffer would show.  chip_smoke.py holds the CUDA
kernel to the plain version on the card.
"""

import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import concrete_tpu.jax_config  # noqa: F401
import jax.numpy as jnp

import test_torch_banded_mm as bmt
from concrete_tpu.core import kernels as kn
from concrete_tpu.params import CryptoParams
from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch import params as tpp
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.core import limbs as tlb
from concrete_tpu_torch.ops import latency as tlat

M32 = (1 << 32) - 1


def _csrc(name):
    return (Path(tlat.__file__).parent.parent / "csrc" / name).read_text()


def _case(rng, batch, kp1, levels, n, s_key, base_log, n_small):
    """The persistent kernel's operands: a_t (B, n_small) int32 in [0,
    2N), a random first accumulator (k+1, B, N) and a packed BSK (n_small,
    Cin, k+1, S, 2N-1) int8."""
    a_t = rng.integers(0, 2 * n, (batch, n_small)).astype(np.int32)
    acc = rng.integers(0, 1 << 64, (kp1, batch, n), dtype=np.uint64)
    planes = rng.integers(-128, 128, (n_small, levels * kp1, kp1, s_key,
                                      2 * n - 1)).astype(np.int8)
    return a_t, acc, planes


def _plain(a_t, acc, planes, kp1, levels, base_log, limb_offset):
    return tlat.blind_rotate_latency_plain(
        torch.from_numpy(a_t), torch.from_numpy(acc.view(np.int64)),
        torch.from_numpy(planes), kp1=kp1, levels=levels,
        base_log=base_log, limb_offset=limb_offset).numpy().view(np.uint64)


def _digits(cur, a, levels, base_log):
    """Kernel 1's arithmetic on one ciphertext's rows cur (k+1, N) u64:
    the digits dig[lev (k+1) + r] of X^a cur[r] - cur[r] as int32."""
    kp1, n = cur.shape
    t = np.arange(n)
    s = (t - a) % (2 * n)
    src = cur[:, np.where(s >= n, s - n, s)]
    x = np.where(s >= n, np.uint64(0) - src, src)
    v = x - cur
    w_prev = ((v >> np.uint64(63)) + np.uint64(1)) >> np.uint64(1)
    dig = np.zeros((levels, kp1, n), np.int32)
    for lev in range(levels):
        shift = np.uint64(63 - (lev + 1) * base_log)
        w = ((v >> shift) + np.uint64(1)) >> np.uint64(1)
        d = (w - (w_prev << np.uint64(base_log))) & np.uint64(M32)
        dig[lev] = d.astype(np.uint32).view(np.int32)
        w_prev = w
    return dig.reshape(levels * kp1, n)


LANES = np.arange(32)
G, TG = LANES >> 2, LANES & 3


def _a_regs(views, y0, word):
    """A-fragment registers of every lane (4, 32) at `word` (the lane's
    y0 // 4 + 4 q - 8 ks): view y0 mod 4, words +0, +2, -4, -2."""
    v = y0 & 3
    return np.stack([views[v, word + dq] for dq in (0, 2, -4, -2)])


def _a_block(regs):
    """The (16 t, 32 j) int8 block the registers hold: a0 row g, bytes of
    j = 4 tg ..; a1 row g + 8; a2, a3 the same rows at j = 16 + 4 tg .."""
    block = np.zeros((16, 32), np.int8)
    for reg in range(4):
        for i in range(4):
            block[G + 8 * (reg & 1), 16 * (reg >> 1) + 4 * TG + i] = \
                bmt._bytes_of(regs[reg], i)
    return block


def _b_block(rows, ks):
    """The (32 j, 8 columns) int8 B fragment at k-step ks: column g's
    staged row (words lw, offset m past its 16-byte boundary, or None
    past the live columns), bytes o = m + j by funnel shifts."""
    block = np.zeros((32, 8), np.int8)
    for g in range(8):
        if rows[g] is None:
            continue
        lw, m = rows[g]
        o0 = m + 4 * np.arange(4)
        ob, sh = (o0 >> 2) + 8 * ks, np.uint64(8 * (m & 3))
        for half in range(2):
            val = bmt._funnel(lw[ob + 4 * half], lw[ob + 4 * half + 1], sh)
            for i in range(4):
                block[16 * half + 4 * np.arange(4) + i, g] = \
                    bmt._bytes_of(val, i)
    return block


KCHUNKS = 16


def emulate_persistent(a_t, acc0, planes, *, kp1, levels, base_log,
                       limb_offset, mutation=None, seed=0):
    """The persistent kernel's result (k+1, B, N) u64, block by block and
    warp by warp.  `mutation`: "single_buffer" (each step reads and writes
    one accumulator buffer), "slot_off_by_one" (the product reads the ring
    slot of the next step), "limb_offset" (the recombine shifts one limb
    further), "no_reuse_shift" (tiles 2, 3 take tiles 0, 1's A fragments
    of the same k-step instead of the previous one), "early_refill" (a
    one-slot ring refilled with step i + 1's rows before the last pass of
    step i has read it)."""
    batch, n_small = a_t.shape
    n = acc0.shape[2]
    s_key = planes.shape[3]
    d_limbs = tlb.num_digit_limbs(base_log)
    pl = tlat.plan(batch, n, kp1, levels, d_limbs, s_key)
    assert pl is not None
    js, cin, ltb = pl.js, levels * kp1, pl.ltb
    jblocks, kps = n // js, js // 32
    ksteps = pl.slices * kps
    per_chunk = -(-ksteps // KCHUNKS)
    ncols = kp1 * s_key
    ntiles = -(-ncols // 8)
    n_out = s_key + d_limbs - 1
    off = limb_offset + (mutation == "limb_offset")
    used = min(8 - limb_offset, n_out)
    bw = (js + ltb) // 4 + 1
    mem = planes.reshape(-1).view(np.uint8)
    vlen = 2 * n - 1
    step_bytes = cin * kp1 * s_key * vlen
    strides = (vlen, s_key * vlen, kp1 * s_key * vlen)   # a, r, ci
    y0 = G - 4 * TG + js - 3
    passes = ltb // 64 * d_limbs * ntiles
    staged = {}

    def key_rows(i):
        """Step i's key rows as the producer stages them: each from the
        16-byte boundary at or below its start, js + 16 bytes, zeros past
        the storage, as words; with its offset m past the boundary."""
        if i in staged:
            return staged[i]
        rows = {}
        for sl in range(pl.slices):
            ci, jb = divmod(sl, jblocks)
            for c in range(ncols):
                addr = i * step_bytes + n - 1 + jb * js \
                    + np.dot(strides, (c % s_key, c // s_key, ci))
                idx = (addr & ~15) + np.arange(js + 16)
                win = np.where(idx < len(mem),
                               mem[np.minimum(idx, len(mem) - 1)], 0)
                rows[sl, c] = (win.astype(np.uint8).view("<u4")
                               .astype(np.uint64), addr & 15)
        staged[i] = rows
        return rows

    # ring[b][rank]: that block's slots, each the step whose rows it holds
    ring = [[[None] * pl.slots for _ in range(pl.cluster)]
            for _ in range(batch)]

    def stage_key(b, rank, i):
        """Step i's key rows into block (b, rank)'s slot i mod slots."""
        if i < n_small:
            ring[b][rank][i % pl.slots] = i

    # mine[b][rank]: that block's two buffers of its t slice (k+1, ltb)
    mine = [[[acc0[:, b, rank * ltb:(rank + 1) * ltb].copy(),
              np.zeros((kp1, ltb), np.uint64)]
             for rank in range(pl.cluster)] for b in range(batch)]
    for b in range(batch):
        for rank in range(pl.cluster):
            for i in range(pl.slots):
                stage_key(b, rank, i)
    order = np.random.default_rng(seed)
    for i in range(n_small):
        cur, nxt = (0, 0) if mutation == "single_buffer" else \
            (i & 1, (i + 1) & 1)
        slot = (i + 1 if mutation == "slot_off_by_one" else i) % pl.slots
        for b in order.permutation(batch):
            for rank in range(pl.cluster):
                tb = rank * ltb
                if pl.slots == 2 and i >= 1:
                    # during step i, step i + 1's rows into the slot that
                    # step i - 1 has left
                    stage_key(b, rank, i + 1)
                # every block's slice of buffer `cur`, as the block reads it
                whole = np.concatenate([mine[b][r][cur]
                                        for r in range(pl.cluster)], axis=1)
                dig = _digits(whole, int(a_t[b, i]), levels, base_log)
                views = []
                for sl in range(pl.slices):
                    ci, jb = divmod(sl, jblocks)
                    words = bmt._band_words_digits(dig[ci], tb - jb * js - js,
                                                   bw, n, d_limbs)
                    views.append([bmt._band_views(words[s])
                                  for s in range(d_limbs)])
                # the int32 planes in C-fragment order: per pass (64-t
                # group, digit limb, n tile), word (q 4 + e) 32 + lane
                red = np.zeros((ltb // 64, d_limbs, ntiles, 512), np.int64)
                done = 0                 # passes of step i run
                for t0 in range(0, ltb, 64):
                    for s in range(d_limbs):
                        for nt in range(ntiles):
                            if mutation == "early_refill" \
                                    and done == passes - 1:
                                stage_key(b, rank, i + 1)
                            rows = key_rows(ring[b][rank][slot])
                            done += 1
                            for kc in range(KCHUNKS):
                                # warp kc: K chunk kc, every t-tile
                                acc = np.zeros((4, 16, 8), np.int64)
                                af = [None] * 4
                                sl = -1
                                for kg in range(kc * per_chunk, min(
                                        (kc + 1) * per_chunk, ksteps)):
                                    new_slice = sl != kg // kps
                                    sl, ks = divmod(kg, kps)
                                    vw = views[sl][s]
                                    word = ((y0 + t0) >> 2) - 8 * ks
                                    if new_slice:   # tiles 2, 3 at ks
                                        af[2], af[3] = (
                                            _a_regs(vw, y0, word + 4 * q)
                                            for q in (2, 3))
                                    else:           # tiles 0, 1 at ks - 1
                                        af[2], af[3] = af[0], af[1]
                                    af[0], af[1] = (
                                        _a_regs(vw, y0, word + 4 * q)
                                        for q in (0, 1))
                                    if mutation == "no_reuse_shift":
                                        af[2], af[3] = af[0], af[1]
                                    cols = [rows[sl, nt * 8 + g]
                                            if nt * 8 + g < ncols else None
                                            for g in range(8)]
                                    b_op = _b_block(cols, ks).astype(np.int64)
                                    for q in range(4):
                                        acc[q] += _a_block(af[q]).astype(
                                            np.int64) @ b_op
                                # the warp's C fragments: lane (g, tg)
                                # holds rows g, g + 8, columns 2 tg, 2 tg + 1
                                for q in range(4):
                                    for e in range(4):
                                        red[t0 // 64, s, nt,
                                            (q * 4 + e) * 32 + LANES] += \
                                            acc[q][G + 8 * (e >> 1),
                                                   2 * TG + (e & 1)]
                if pl.slots == 1:
                    # every warp has arrived on the slot's empty barrier:
                    # step i + 1's rows into it, during the recombine
                    stage_key(b, rank, i + 1)
                new = mine[b][rank][cur].copy()
                tl = np.arange(ltb)
                q, row = (tl & 63) >> 4, tl & 15
                for r in range(kp1):
                    add = np.zeros(ltb, np.uint64)
                    for p in range(used):
                        plane = np.zeros(ltb, np.int64)
                        for s in range(d_limbs):
                            a = p - s
                            if 0 <= a < s_key:
                                col = r * s_key + a
                                fe = 2 * (row >> 3) + (col & 1)
                                fl = (row & 7) * 4 + ((col & 7) >> 1)
                                plane += red[tl // 64, s, col >> 3,
                                             (q * 4 + fe) * 32 + fl]
                        plane = (plane + (1 << 31)) % (1 << 32) - (1 << 31)
                        add += plane.astype(np.uint64) << np.uint64(
                            8 * (p + off))
                    new[r] += add
                mine[b][rank][nxt] = new
    last = n_small & 1 if mutation != "single_buffer" else 0
    return np.stack([np.concatenate([mine[b][r][last]
                                     for r in range(pl.cluster)], axis=1)
                     for b in range(batch)], axis=1)


DESIGN_CASES = [
    # batch, kp1, levels, n, s_key, base_log, n_small, limb_offset
    (1, 2, 2, 128, 4, 5, 4, 4),
    (4, 2, 1, 256, 4, 5, 5, 4),
    (2, 3, 2, 128, 2, 10, 4, 6),
    (3, 3, 1, 256, 3, 5, 5, 0),
]


@pytest.mark.parametrize(
    "batch,kp1,levels,n,s_key,base_log,n_small,limb_offset", DESIGN_CASES,
    ids=["b1-k2", "b4-k2-n256", "b2-k3-2limbs", "b3-k3-n256-full"])
def test_persistent_design_matches_plain(batch, kp1, levels, n, s_key,
                                         base_log, n_small, limb_offset):
    """The rehearsed persistent kernel == blind_rotate_latency_plain over
    4-5 steps: clusters of 2-4 blocks (N=128, 256), B = 1 .. 4, k+1 = 2
    and 3, one and two digit limbs, a truncated and a full key, an even
    and an odd step count (the result in either buffer)."""
    rng = np.random.default_rng(batch * 1000 + n + kp1)
    a_t, acc, planes = _case(rng, batch, kp1, levels, n, s_key, base_log,
                             n_small)
    want = _plain(a_t, acc, planes, kp1, levels, base_log, limb_offset)
    with threadpool_limits(1):
        got = emulate_persistent(a_t, acc, planes, kp1=kp1, levels=levels,
                                 base_log=base_log, limb_offset=limb_offset)
    assert np.array_equal(got, want)


def _force_rule(monkeypatch, case, slots, cluster):
    """Force the shape rule down at a small shape: clusters of at most
    `cluster` blocks (more outputs t a block), and a key ring of one slot
    where two would fit (the budget cut to the one-slot layout)."""
    batch, kp1, levels, n, s_key, base_log = case[:6]
    args = (batch, n, kp1, levels, tlb.num_digit_limbs(base_log), s_key)
    if cluster is not None:
        monkeypatch.setattr(tlat, "MAX_CLUSTER", cluster)
    pl = tlat.plan(*args)
    if slots == 1 and pl.slots == 2:
        monkeypatch.setattr(tlat, "MAX_SMEM", pl.smem - pl.ring_slot)
    pl = tlat.plan(*args)
    assert pl.slots == slots
    return pl


FORCED_CASES = [
    # DESIGN_CASES[0] + (slots, most blocks a cluster)
    (*DESIGN_CASES[0], 1, None),
    # GameOfLife's key form: l = 2, base 2^7, 5 key limbs at offset 3;
    # two 64-t groups a block, as at its N=2048
    (2, 2, 2, 256, 5, 7, 3, 3, 1, 2),
    (1, 2, 1, 256, 4, 5, 3, 4, 2, 2),
]


@pytest.mark.parametrize(
    "batch,kp1,levels,n,s_key,base_log,n_small,limb_offset,slots,cluster",
    FORCED_CASES, ids=["b1-k2-one-slot", "b2-gol-form-ltb128-one-slot",
                       "b1-ltb128-two-slots"])
def test_persistent_design_forced_rule_matches_plain(
        batch, kp1, levels, n, s_key, base_log, n_small, limb_offset, slots,
        cluster, monkeypatch):
    """The rehearsal under the rule forced down == the plain version: a key
    ring of one slot, refilled with step i + 1's rows once step i's last
    pass has read it, and blocks of 128 outputs t (two 64-t groups, as
    GameOfLife's N=2048 gives), with one slot and with two."""
    case = (batch, kp1, levels, n, s_key, base_log)
    pl = _force_rule(monkeypatch, case, slots, cluster)
    assert pl.ltb == (64 if cluster is None else n // cluster)
    rng = np.random.default_rng(batch * 1000 + n + s_key)
    a_t, acc, planes = _case(rng, batch, kp1, levels, n, s_key, base_log,
                             n_small)
    want = _plain(a_t, acc, planes, kp1, levels, base_log, limb_offset)
    with threadpool_limits(1):
        got = emulate_persistent(a_t, acc, planes, kp1=kp1, levels=levels,
                                 base_log=base_log, limb_offset=limb_offset)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mutation", ["single_buffer", "sign_at_zero",
                                      "limb_offset", "slot_off_by_one",
                                      "no_reuse_shift", "early_refill"])
def test_persistent_design_mutations_fail(mutation, monkeypatch):
    """The rehearsal has teeth: one accumulator buffer read after another
    block's write, the band's sign boundary moved to u <= 0, the recombine
    one limb off, the key ring's slot a step off, the reused A fragments
    taken from the same k-step, or a one-slot ring refilled with the next
    step's rows before the step's last pass has read it, each gives
    another accumulator."""
    batch, kp1, levels, n, s_key, base_log, n_small, limb_offset = \
        DESIGN_CASES[0]
    if mutation == "early_refill":
        _force_rule(monkeypatch, DESIGN_CASES[0], 1, None)
    rng = np.random.default_rng(3)
    a_t, acc, planes = _case(rng, batch, kp1, levels, n, s_key, base_log,
                             n_small)
    want = _plain(a_t, acc, planes, kp1, levels, base_log, limb_offset)
    kw = dict(kp1=kp1, levels=levels, base_log=base_log,
              limb_offset=limb_offset)
    if mutation == "sign_at_zero":
        monkeypatch.setattr(sys.modules[bmt.__name__], "SIGN_BELOW", 1)
        mutation = None
    with threadpool_limits(1):
        got = emulate_persistent(a_t, acc, planes, mutation=mutation, **kw)
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("truncate,levels,base_log", [
    (0, 3, 6), (4, 3, 6),
    # GameOfLife's key form: 5 kept limbs, l = 2, base 2^7
    (3, 2, 7)], ids=["full", "truncated", "gol-form"])
@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_blind_rotate_latency_plain_matches_jax(batch, truncate, levels,
                                                base_log, monkeypatch):
    """The port's latency blind rotate on the CPU, which takes the plain
    version of the persistent kernel, == the JAX package's
    _blind_rotate_xla_latency at B = 1 .. 4, with and without a truncated
    key, and at GameOfLife's key form (the persistent kernel's one-slot
    shape on the card) at a small N."""
    shape = dict(n_small=6, glwe_dimension=1, polynomial_size=256,
                 pbs_level=levels, pbs_base_log=base_log, ks_level=2,
                 ks_base_log=4)
    params = CryptoParams.make(**shape)
    tparams = tpp.CryptoParams.make(**shape)
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    rng = np.random.default_rng(40 + batch + truncate)
    ct = rng.integers(0, 1 << 64, (batch, params.n_small + 1),
                      dtype=np.uint64)
    bsk = rng.integers(0, 1 << 64, (params.n_small, params.pbs_level, kp1,
                                    kp1, n), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    calls = []
    plain = tlat.blind_rotate_latency_plain

    def spy(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    monkeypatch.setattr(tlat, "blind_rotate_latency_plain", spy)
    got = tk._blind_rotate_latency(
        torch.from_numpy(ct.view(np.int64)),
        tk.pack_bsk(bsk, tparams, truncate, device="cpu"),
        torch.from_numpy(lut.view(np.int64)), tparams)
    want = kn._blind_rotate_xla_latency(
        jnp.asarray(ct), kn.pack_bsk(bsk, params, truncate),
        jnp.asarray(lut), params)
    assert calls == [1]
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(want))


def test_plan_takes_the_latency_shapes():
    """The shape rule takes B = 1 .. 4 at BENCH_PARAMS_4BIT_TPUOPT (N=1024,
    k+1 = 2, l = 4, 1 digit limb, 4 kept key limbs; the table archive's
    parameters are the same), k+1 = 3 with two digit limbs at N=1024, and
    the rehearsal's small shapes; at N=1024 a cluster of 16 blocks of 64
    outputs each."""
    p = tpp.BENCH_PARAMS_4BIT_TPUOPT
    keep = 8 - tpp.choose_truncate_limbs(p, 4)
    assert keep == 4
    for batch in (1, 2, 3, 4):
        pl = tlat.plan(batch, p.polynomial_size, p.glwe_dimension + 1,
                       p.pbs_level, tlb.num_digit_limbs(p.pbs_base_log), keep)
        assert pl is not None and (pl.cluster, pl.ltb) == (16, 64)
        # the layout the kernel has had since it was written: two slots
        assert (pl.slots, pl.smem) == (2, 203808)
    assert tlat.plan(2, 1024, 3, 2, 2, 4) is not None
    for case in DESIGN_CASES:
        batch, kp1, levels, n, s_key, base_log = case[:6]
        assert tlat.plan(batch, n, kp1, levels,
                         tlb.num_digit_limbs(base_log), s_key) is not None


def test_plan_takes_gol_shape_with_one_slot():
    """GameOfLife(16, 16)'s lookups as the port compiles them at the
    default Configuration() (N=2048, k+1 = 2, l = 2, base 2^7: one digit
    limb, 5 kept key limbs) fit with a key ring of one slot, at B = 1 ..
    4: two steps' rows (2 x 83,200 bytes) would take 241,184 bytes; and
    blocks of 128 outputs t, 16 to a cluster."""
    for batch in (1, 2, 3, 4):
        pl = tlat.plan(batch, 2048, 2, 2, 1, 5)
        assert pl is not None
        assert (pl.cluster, pl.ltb, pl.slots) == (16, 128, 1)
        assert (pl.ring_slot, pl.smem) == (83200, 157984)
    # 4 key limbs at the same N keep their two slots
    assert tlat.plan(1, 2048, 2, 2, 1, 4).slots == 2


@pytest.mark.parametrize("batch,n,kp1,levels,d_limbs,s_key,smem", [
    (1, 1024, 2, 4, 1, 8, 203808),  # the latency shape's untruncated key
    (4, 1024, 2, 4, 1, 8, 203808),
    (1, 2048, 2, 2, 1, 8, 207904),  # N=2048, l = 2, 8 key limbs
    (1, 256, 5, 3, 1, 8, 216096),   # examples/table_lookup.py's, untruncated
], ids=["latency-s8", "latency-s8-b4", "n2048-s8", "table-lookup-s8"])
def test_plan_takes_untruncated_keys_with_one_slot(batch, n, kp1, levels,
                                                   d_limbs, s_key, smem):
    """8 kept key limbs fit with one slot where they would not with two:
    the latency shape's and table_lookup's untruncated keys (the compile
    phase's) run in one launch too."""
    pl = tlat.plan(batch, n, kp1, levels, d_limbs, s_key)
    assert pl is not None and (pl.slots, pl.smem) == (1, smem)
    assert pl.smem + pl.ring_slot > tlat.MAX_SMEM


def test_plan_layout_is_the_kernels():
    """plan()'s limits are the kernel's constants, and it lays shared
    memory out and picks the ring's slots as make_plan does: the region,
    the accumulator slice's two buffers, the bands, `slots` ring slots of
    a whole step and 4 mbarriers; two slots where they fit, else one."""
    src = _csrc("blind_rotate_latency.cu")
    consts = {name: math.prod(int(f) for f in expr.split("*"))
              for name, expr in re.findall(
                  r"constexpr \w+ (MAX_\w+) = ([\d *]+);", src)}
    assert consts == {"MAX_SMEM": tlat.MAX_SMEM,
                      "MAX_CLUSTER": tlat.MAX_CLUSTER}
    shared = _csrc("banded_latency.cuh")
    assert f"constexpr int LT = {tlat.LT};" in shared
    assert f"constexpr int JS_MAX = {tlat.JS_MAX};" in shared
    rule = re.sub(r"\s+", " ", src[src.index("bool make_plan("):])
    for line in (
            "const size_t fixed = (size_t)pl.region + 2 * (size_t)kp1 * "
            "pl.ltb * 8 + pl.bands + 32;",
            "pl.slots = fixed + 2 * (size_t)pl.ring_slot <= MAX_SMEM ? 2 : 1;",
            "pl.smem = fixed + pl.slots * (size_t)pl.ring_slot;",
            "return pl.smem <= MAX_SMEM;"):
        assert line in rule, line
    for args in ((1, 1024, 2, 4, 1, 4), (1, 2048, 2, 2, 1, 5),
                 (1, 256, 5, 3, 1, 8), (2, 1024, 3, 2, 2, 4)):
        batch, n, kp1, levels, d_limbs, s_key = args
        pl = tlat.plan(*args)
        fixed = pl.region + 2 * kp1 * pl.ltb * 8 + max(
            pl.slices * pl.band_bytes, kp1 * n * 8) + 32
        assert pl.slots == (2 if fixed + 2 * pl.ring_slot <= tlat.MAX_SMEM
                            else 1)
        assert pl.smem == fixed + pl.slots * pl.ring_slot
        assert pl.ring_slot == pl.slices * kp1 * s_key * (pl.js + 16)
        assert all(x % 16 == 0 for x in (pl.region, pl.band_bytes,
                                         pl.ring_slot))


@pytest.mark.parametrize("batch,n,kp1,levels,d_limbs,s_key", [
    (1, 2048, 2, 4, 1, 4),      # l = 4: 278,560 bytes with one ring slot
    (2, 1024, 3, 4, 1, 4),      # Cin = 12, 12 columns: 255,776 with one
    (9, 1024, 2, 4, 1, 4),      # more clusters than the card holds at once
    (1, 32, 2, 1, 1, 4),        # fewer outputs than one 64-t group
    (1, 1000, 2, 4, 1, 4),      # N not a multiple of the 64-t group
], ids=["n2048", "k3-l4", "b9", "n32", "n1000"])
def test_plan_refuses_oversized_shapes(batch, n, kp1, levels, d_limbs,
                                       s_key):
    """Beyond the rule the step loop runs: a block that would need more
    than the H100's 227 KB of shared memory, a batch past MAX_BATCH, an N
    below or not a multiple of a 64-t group."""
    assert tlat.plan(batch, n, kp1, levels, d_limbs, s_key) is None


def test_blind_rotate_latency_rejects_mismatched_operands():
    a_t = torch.zeros((2, 3), dtype=torch.int32)
    acc = torch.zeros((2, 2, 128), dtype=torch.int64)
    planes = torch.zeros((3, 4, 2, 4, 255), dtype=torch.int8)
    kw = dict(kp1=2, levels=2, base_log=5, limb_offset=4)
    with pytest.raises(ValueError, match="do not match"):
        tlat.blind_rotate_latency(a_t, acc, planes[:2], **kw)
    with pytest.raises(ValueError, match="do not match"):
        tlat.blind_rotate_latency(a_t, acc, planes, **{**kw, "levels": 3})
    with pytest.raises(ValueError, match="do not match"):
        tlat.blind_rotate_latency(a_t[:1], acc, planes, **kw)
    with pytest.raises(ValueError, match="must be"):
        tlat.blind_rotate_latency(a_t[0], acc, planes, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        tlat.blind_rotate_latency(a_t, acc.to("meta"), planes, **kw)


def test_pack_bsk_leaves_the_key_tail():
    """The packed key's storage reaches KEY_TAIL bytes past its end: the
    persistent kernel copies each key row from the 16-byte boundary below
    it, a multiple of 16 bytes long, so the last row may read past the
    key; ``with_tail`` gives any tensor such a tail, with the same
    values."""
    params = tpp.CryptoParams.make(
        n_small=3, glwe_dimension=1, polynomial_size=64, pbs_level=2,
        pbs_base_log=5, ks_level=2, ks_base_log=4)
    rng = np.random.default_rng(5)
    bsk = rng.integers(0, 1 << 64, (3, 2, 2, 2, 64), dtype=np.uint64)
    planes = tk.pack_bsk(bsk, params, 4, device="cpu").planes
    assert planes.is_contiguous()
    assert tlat.tail_bytes(planes) >= tlat.KEY_TAIL
    t = torch.arange(10, dtype=torch.int8).view(2, 5)
    assert tlat.tail_bytes(t) == 0
    tailed = tlat.with_tail(t)
    assert torch.equal(tailed, t) and tlat.tail_bytes(tailed) == 16
