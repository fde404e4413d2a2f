"""Kernel 9 (banded matmul), the standalone recombine-accumulate, the
banded-matmul modes and the latency blind rotate of the PyTorch port,
against the JAX package, bit for bit, on the CPU.

Inputs come from numpy seeds and go through both packages.  The JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas_step.py
does.  On the CPU the port's wrappers run their kernels' plain PyTorch
versions; chip_smoke.py holds the CUDA kernels to those on the card.  All
of it is integer arithmetic, so every comparison is exact.

Kernel 9's two CUDA forms are rehearsed in numpy here too, moving bytes as
they do: the table form through the shared wgmma main loop of
``csrc/banded_wgmma.cuh`` (``core_sums`` of
tests/test_torch_external_product.py) with the JAX package's stacked lhs
and a plane-store epilogue; the latency form (``csrc/banded_mm_latency.cu``)
with its band words built from int32 digits, its rows on the MMA's n side
and its split-K partials reduced in a shuffled order.
"""

import functools
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import concrete_tpu.jax_config  # noqa: F401
import jax
import jax.numpy as jnp

import test_torch_external_product as kb
from concrete_tpu.core import kernels as kn
from concrete_tpu.core import limbs as jlb
from concrete_tpu.core import refimpl as ref
from concrete_tpu.ops import pallas_step as ps
from concrete_tpu.ops.pallas_banded_mm import banded_matmul_fused
from concrete_tpu.params import (TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE,
                                 choose_truncate_limbs)
from torch_threads import one_intra_op_thread  # noqa: F401
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


# --- the latency step's product: plain version against the JAX pieces ---

def _latency_case(rng, batch, kp1, levels, n, s_key, base_log):
    """Kernel 1's digits (l, (k+1)*B, N) int32 in [-2^(base_log-1),
    2^(base_log-1)] and one BSK step (Cin, k+1, S, 2N-1) int8."""
    half = 1 << (base_log - 1)
    digits = rng.integers(-half, half + 1, (levels, kp1 * batch, n)) \
        .astype(np.int32)
    w_vv = rand_i8(rng, (levels * kp1, kp1, s_key, 2 * n - 1))
    return digits, w_vv


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_latency_step(digits, w_vv, kp1, levels, base_log):
    """The JAX package's latency step pieces (core/kernels.py
    _blind_rotate_xla_latency): ext_d, the limb split after the negation,
    the raw BSK rows as lhs_list, negacyclic_banded_matmul_planes."""
    _, rows, n = digits.shape
    b_ct, cin = rows // kp1, levels * kp1
    d = digits.reshape(levels, kp1, b_ct, n).transpose(2, 0, 1, 3) \
        .reshape(b_ct, cin, n)
    ext_d = jnp.concatenate([-d[..., 1:], d], axis=-1)
    d_limbs = jlb.i32_digits_to_balanced_i8(
        ext_d, jlb.num_digit_limbs(base_log))
    vv_d = jnp.transpose(d_limbs, (1, 0, 3, 2))
    w_raw = w_vv[:, :, :, n - 1:]
    lhs_list = [jnp.transpose(w_raw[:, :, s, :], (1, 0, 2)).reshape(kp1, -1)
                for s in range(w_raw.shape[2])]
    return kn.negacyclic_banded_matmul_planes(lhs_list, vv_d, n)


@pytest.mark.parametrize("base_log", [5, 10], ids=["1limb", "2limbs"])
@pytest.mark.parametrize("kp1", [2, 3])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_banded_matmul_latency_plain_matches_jax(batch, kp1, base_log):
    """banded_matmul_latency's plain version (the step's glue and
    banded_matmul_plain) == the JAX package's latency step pieces on the
    same digits and BSK step."""
    rng = np.random.default_rng(100 * batch + 10 * kp1 + base_log)
    levels, n, s_key = 2, 64, 4
    digits, w_vv = _latency_case(rng, batch, kp1, levels, n, s_key, base_log)
    got = tbm.banded_matmul_latency(
        torch.from_numpy(digits), torch.from_numpy(w_vv), kp1=kp1,
        levels=levels, base_log=base_log)
    want = np.asarray(_jax_latency_step(
        jnp.asarray(digits), jnp.asarray(w_vv), kp1, levels, base_log))
    n_out = s_key + jlb.num_digit_limbs(base_log) - 1
    assert got.shape == (kp1, batch, n_out, n) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_banded_matmul_latency_rejects_mismatched_operands():
    digits = torch.zeros((2, 4, 64), dtype=torch.int32)
    w_vv = torch.zeros((4, 2, 4, 127), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not match"):
        tbm.banded_matmul_latency(digits, w_vv, kp1=2, levels=3, base_log=5)
    with pytest.raises(ValueError, match="do not match"):
        tbm.banded_matmul_latency(digits, w_vv[..., :125], kp1=2, levels=2,
                                  base_log=5)
    with pytest.raises(ValueError, match="unsupported device"):
        tbm.banded_matmul_latency(digits.to("meta"), w_vv, kp1=2, levels=2,
                                  base_log=5)


# --- the latency form's design, rehearsed in numpy ---

# csrc/banded_mm_latency.cu's constants
LT, JS_MAX, MAX_CL, KH = 64, 1024, 8, 2
# the band's sign boundary (a word at u0 < SIGN_BELOW is negated) and its
# limb carry; the mutation test moves them
SIGN_BELOW = 0
BALANCED_CARRY = True


def _funnel(lo, hi, shift):
    """__funnelshift_r(lo, hi, shift) on u64-held u32 words."""
    return (((hi << np.uint64(32)) | lo) >> shift) & np.uint64(0xFFFFFFFF)


def _bytes_of(words, i):
    return ((words >> np.uint64(8 * i)) & np.uint64(0xFF)) \
        .astype(np.uint8).view(np.int8)


def _band_words_digits(row_d, u_lo, bw, n, s_planes):
    """The band rows' words as stage_band<DIGITS> packs them: word w of
    limb row s packs L_s(E(u0 + i)), i < 4, u0 = u_lo + 4w, from one
    16-byte load of 4 digits, negated below the sign boundary, then split
    into limbs (bw + 1 words: the views of word w read word w + 1)."""
    u0 = u_lo + 4 * np.arange(bw + 1)
    idx = np.where(u0 < 0, u0 + n, np.where(u0 >= n, u0 - n, u0))
    x = row_d[idx[:, None] + np.arange(4)].astype(np.int64)
    x = np.where((u0 < SIGN_BELOW)[:, None], -x, x)
    words = np.zeros((s_planes, bw + 1), np.uint64)
    for s in range(s_planes):
        byte = x & 0xFF
        words[s] = (byte.astype(np.uint64)
                    << (8 * np.arange(4, dtype=np.uint64))).sum(1)
        x = (x - np.where(byte >= 128, byte - 256, byte)) >> 8 \
            if BALANCED_CARRY else x >> 8
    return words


def _band_words_vv(vrows, u_lo, bw, n):
    """stage_band<false>: the int8 band rows vv[s, N-1 + u] (zero outside
    the row) packed 4 bytes a word (bw + 1 words)."""
    y = n - 1 + u_lo + 4 * np.arange(bw + 1)[:, None] + np.arange(4)
    inside = (y >= 0) & (y < 2 * n - 1)
    b = np.where(inside[None], vrows[:, np.clip(y, 0, 2 * n - 2)], 0)
    return (b.astype(np.uint8).astype(np.uint64)
            << (8 * np.arange(4, dtype=np.uint64))).sum(-1)


def _band_views(words):
    """stage_band's 4 views of a row's words (bw + 1 of them): view k word
    w = bytes 4w+k .. 4w+k+3 reversed, a byte-reversed funnel shift of
    words w and w + 1 -> (4, bw)."""
    return np.stack([kb._band_word(words[:-1], words[1:], np.uint64(8 * k))
                     for k in range(4)])


def _latency_a_tile(views, js, kh):
    """The (LT, js) band operand the A-fragment registers of K half `kh`
    hold (its k-steps' columns; zero elsewhere): a0 at y, a1 y + 8, a2
    y - 16, a3 y - 8, word y // 4 of view y mod 4, y = 16 warp + g - 4 tg
    + js - 3 - 32 ks."""
    half = js // 32 // KH
    ks, w, lane = np.meshgrid(np.arange(kh * half, (kh + 1) * half),
                              np.arange(4), np.arange(32), indexing="ij")
    g, tg = lane >> 2, lane & 3
    y0 = 16 * w + g - 4 * tg + js - 3
    q = (y0 >> 2) - 8 * ks
    tile = np.zeros((LT, js), np.int8)
    for reg, dq in enumerate((0, 2, -4, -2)):
        val = views[y0 & 3, q + dq]
        row = 16 * w + g + 8 * (reg & 1)
        for i in range(4):
            tile[row, 32 * ks + 16 * (reg >> 1) + 4 * tg + i] = \
                _bytes_of(val, i)
    return tile


def _latency_b_tile(mem, lhs_end, addrs, js, ncp):
    """The (js, ncp) lhs operand the B-fragment registers hold: column c's
    staged row, 16-byte pieces from the boundary below its start (zeros
    past the storage), bytes m + j by funnel shifts of its words."""
    ks, tg = np.meshgrid(np.arange(js // 32), np.arange(4), indexing="ij")
    tile = np.zeros((js, ncp), np.int8)
    for c, addr in enumerate(addrs):
        m, base = addr & 15, addr & ~15
        idx = base + np.arange(js + 16)
        win = np.where(idx < lhs_end, mem[np.minimum(idx, len(mem) - 1)], 0)
        lw = win.astype(np.uint8).view("<u4").astype(np.uint64)
        o0 = m + 4 * tg
        ob, sh = (o0 >> 2) + 8 * ks, np.uint64(8 * (m & 3))
        for half in range(2):
            val = _funnel(lw[ob + 4 * half], lw[ob + 4 * half + 1], sh)
            for i in range(4):
                tile[32 * ks + 16 * half + 4 * tg + i, c] = _bytes_of(val, i)
    return tile


def emulate_latency(mem, lhs_end, offset, strides, kp1, band, *, a_limbs,
                    rows, cin, batch, s_planes, n, seed=0):
    """The latency form's result (rows, B, A+S-1, N) int32: per cluster of
    (t-tile, b), each rank's partial tiles over its K slices, one per K
    half of its warps, then the outputs summed over the ranks and halves
    in a shuffled order.  `band(ci, b, u_lo,
    bw)` gives the (S, bw) band words; lhs[a, r, ci, j] lies at byte
    offset + strides . (a, r, ci // kp1, ci % kp1) + j of `mem`."""
    js = JS_MAX
    while n % js:
        js //= 2
    jblocks = n // js
    slices = cin * jblocks
    cl = min(slices, MAX_CL)
    ncols = rows * a_limbs
    ncp = -(-ncols // 8) * 8
    n_out = a_limbs + s_planes - 1
    bw = (js + LT) // 4 + 1
    out = np.zeros((rows, batch, n_out, n), np.int64)
    order = np.random.default_rng(seed)
    for t0 in range(0, n, LT):
        for b in range(batch):
            red = np.zeros((cl, KH, s_planes, ncp, LT), np.int64)
            for rank in range(cl):
                for sl in range(rank, slices, cl):
                    ci, jb = divmod(sl, jblocks)
                    words = band(ci, b, t0 - jb * js - js, bw)
                    addrs = [offset + np.dot(strides, (c % a_limbs,
                                                       c // a_limbs,
                                                       ci // kp1, ci % kp1))
                             + jb * js for c in range(ncols)]
                    b_op = _latency_b_tile(mem, lhs_end, addrs, js, ncp)
                    for s in range(s_planes):
                        views = _band_views(words[s])
                        for kh in range(KH):
                            a_op = _latency_a_tile(views, js, kh)
                            red[rank, kh, s] += (
                                a_op.astype(np.float64)
                                @ b_op.astype(np.float64)).astype(np.int64).T
            for i in order.permutation(cl * KH):
                rank, kh = divmod(i, KH)
                for r in range(rows):
                    for p in range(n_out):
                        for s in range(s_planes):
                            if 0 <= p - s < a_limbs:
                                out[r, b, p, t0:t0 + LT] += \
                                    red[rank, kh, s, r * a_limbs + p - s]
    return out.astype(np.int32)


def _emulate_latency_step(digits, w_vv, kp1, levels, base_log, misalign):
    """banded_matmul_latency's kernel: kernel 1's digits in place, the BSK
    step's raw rows read with strides from `misalign` bytes past a 16-byte
    boundary."""
    _, rows, n = digits.shape
    batch, cin, s_key = rows // kp1, levels * kp1, w_vv.shape[2]
    d_cb = digits.reshape(cin, batch, n)
    s_planes = jlb.num_digit_limbs(base_log)
    mem = np.zeros(misalign + w_vv.size, np.uint8)
    mem[misalign:] = w_vv.reshape(-1).view(np.uint8)
    vlen = 2 * n - 1
    with threadpool_limits(1):
        return emulate_latency(
            mem, len(mem), misalign + n - 1,
            (vlen, s_key * vlen, 0, kp1 * s_key * vlen), cin,
            lambda ci, b, u_lo, bw: _band_words_digits(d_cb[ci, b], u_lo, bw,
                                                       n, s_planes),
            a_limbs=s_key, rows=kp1, cin=cin, batch=batch,
            s_planes=s_planes, n=n)


@pytest.mark.parametrize("batch,kp1,levels,n,s_key,base_log,misalign", [
    (2, 2, 2, 128, 4, 5, 3), (3, 3, 1, 256, 4, 10, 0),
    (1, 3, 4, 128, 2, 5, 9), (1, 2, 1, 2048, 4, 5, 1)],
    ids=["k2-b2-n128", "k3-b3-2limbs", "cin12", "n2048-two-j-slices"])
def test_latency_design_matches_plain(batch, kp1, levels, n, s_key, base_log,
                                      misalign):
    """The rehearsed latency form == banded_matmul_latency's plain version:
    (r, a) columns on n (8 live at k+1 = 2, 12 of 16 at k+1 = 3), two digit
    limbs, more K slices than a cluster's 8 blocks (Cin = 12), and N =
    2048 in two 1024-j slices per ci."""
    rng = np.random.default_rng(7 * n + batch + kp1)
    digits, w_vv = _latency_case(rng, batch, kp1, levels, n, s_key, base_log)
    got = _emulate_latency_step(digits, w_vv, kp1, levels, base_log,
                                misalign)
    want = tbm.banded_matmul_latency_plain(
        torch.from_numpy(digits), torch.from_numpy(w_vv), kp1=kp1,
        levels=levels, base_log=base_log)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("levels", [None, 2])
def test_latency_design_with_int8_band(levels):
    """banded_matmul's few-row route: the rehearsed latency form with the
    int8 vv given as the band and the lhs as the JAX package's stacked
    rows (or kernel A's planes with `levels`) == banded_matmul_plain."""
    rng = np.random.default_rng(5 if levels is None else 6)
    a_limbs, rows, cin, cout, s_planes, n = 3, 2, 4, 3, 2, 128
    vv = rand_i8(rng, (cin, cout, s_planes, 2 * n - 1))
    if levels is None:
        lhs = rand_i8(rng, (a_limbs, rows, cin * n))
        plane, kp1 = rows * cin * n, cin
        strides = (plane, cin * n, 0, n)
    else:
        kp1 = cin // levels
        lhs = rand_i8(rng, (levels * a_limbs, rows * kp1, n))
        plane = rows * kp1 * n
        strides = (plane, kp1 * n, a_limbs * plane, n)
    mem = lhs.reshape(-1).view(np.uint8)
    with threadpool_limits(1):
        got = emulate_latency(
            mem, len(mem), 0, strides, kp1,
            lambda ci, b, u_lo, bw: _band_words_vv(vv[ci, b], u_lo, bw, n),
            a_limbs=a_limbs, rows=rows, cin=cin, batch=cout,
            s_planes=s_planes, n=n)
    want = tbm.banded_matmul_plain(torch.from_numpy(lhs),
                                   torch.from_numpy(vv), levels=levels)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("mutation", ["sign_at_zero", "no_carry"])
def test_latency_design_mutations_fail(mutation, monkeypatch):
    """The rehearsal has teeth: negating the word at u = 0 too, or a limb
    split without the balanced carry, gives another product."""
    rng = np.random.default_rng(11)
    kp1, levels, n, base_log = 2, 1, 128, 10
    digits, w_vv = _latency_case(rng, 1, kp1, levels, n, 4, base_log)
    want = tbm.banded_matmul_latency_plain(
        torch.from_numpy(digits), torch.from_numpy(w_vv), kp1=kp1,
        levels=levels, base_log=base_log).numpy()
    assert np.array_equal(
        _emulate_latency_step(digits, w_vv, kp1, levels, base_log, 0), want)
    if mutation == "sign_at_zero":
        monkeypatch.setattr(sys.modules[__name__], "SIGN_BELOW", 1)
    else:
        monkeypatch.setattr(sys.modules[__name__], "BALANCED_CARRY", False)
    got = _emulate_latency_step(digits, w_vv, kp1, levels, base_log, 0)
    assert not np.array_equal(got, want)


# --- the table form: the shared wgmma main loop, rehearsed ---

def emulate_table(lhs, vv, levels, misalign):
    """Kernel 9's table form: csrc/banded_wgmma.cuh's main loop (kernel B's
    rehearsal, ``core_sums``) over the lhs as the header addresses it (the
    stacked (A, B, Cin*N) layout is one level of kp1 = Cin rows), then the
    plane-store epilogue: out[b, cout, p, t] = d_p (int32)."""
    cin, cout_n, s_planes, _ = vv.shape
    if levels is None:
        a_limbs, batch, _ = lhs.shape
        kp1, planes = cin, lhs.reshape(a_limbs, batch * cin, -1)
    else:
        kp1 = cin // levels
        planes, batch = lhs, lhs.shape[1] // kp1
        a_limbs = lhs.shape[0] // levels
    n = planes.shape[2]
    n_out = s_planes + a_limbs - 1
    out = np.zeros((batch, cout_n, n_out, n), np.int32)
    with threadpool_limits(1):
        for b0, t0, cout, p_lo, d in kb.core_sums(
                planes, vv, kp1, n_out, lambda p: p < n_out, misalign):
            nb = min(kb.BN, batch - b0)
            for wg in range(d.shape[0]):
                if p_lo + wg < n_out:
                    out[b0:b0 + nb, cout, p_lo + wg, t0:t0 + kb.TM] = \
                        d[wg].astype(np.int32).T[:nb]
    return out


@pytest.mark.parametrize("a_limbs,batch,cin,cout,s_planes,levels", [
    (1, 130, 4, 2, 4, None), (2, 5, 4, 2, 5, None), (2, 3, 4, 2, 3, 2)],
    ids=["stacked-ragged130", "stacked-6planes", "digit-planes"])
def test_table_design_matches_plain(a_limbs, batch, cin, cout, s_planes,
                                    levels):
    """The rehearsed table form == banded_matmul_plain: the stacked lhs
    with a ragged last 128-row tile, 6 output planes (two plane groups of
    4 warpgroups), and kernel A's planes read in place (Cout = 2 key rows
    per cin, k+1 = 2)."""
    rng = np.random.default_rng(a_limbs * batch + s_planes)
    n = 256
    vv = rand_i8(rng, (cin, cout, s_planes, 2 * n - 1))
    if levels is None:
        lhs = rand_i8(rng, (a_limbs, batch, cin * n))
    else:
        lhs = rand_i8(rng, (levels * a_limbs, batch * cin // levels, n))
    got = emulate_table(lhs, vv, levels, misalign=3)
    want = tbm.banded_matmul_plain(torch.from_numpy(lhs),
                                   torch.from_numpy(vv), levels=levels)
    assert np.array_equal(got, want.numpy())
