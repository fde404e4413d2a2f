"""Kernel B's operand plan, rehearsed in numpy on CPU.

``csrc/external_product.cu`` runs the banded external product on Hopper's
wgmma, through the main loop of ``csrc/banded_wgmma.cuh`` (shared with
kernel 9's table form, whose rehearsal in tests/test_torch_banded_mm.py
calls ``core_sums`` below with its own addressing and epilogue): the key band is the register operand A (M = 64 output coefficients
t, K = j), each fragment register a funnel shift of two aligned words of
the key window staged as it lies in vv, byte-reversed; the digits are the
shared-memory operand B (N = 128 ciphertexts, K-major, 128-byte swizzle),
staged 256 j at a time in 16-byte cp.async pieces; each kept plane has its
own int32 accumulator in its own warpgroup; the epilogue shift-adds the
planes into acc.  The emulation below moves the bytes as the kernel does:
window words from the aligned address below the window (vv at every
misalignment), the fragment registers in the m16n8k32 A layout, the digit
tile through the piece mapping and read back through the wgmma
descriptor's swizzled addressing (start address plus row offset, then
address bits 4-6 XOR bits 7-9), the plane sums per warpgroup and the
epilogue's shifts.  It must equal the kernel's plain version and the JAX
package's ``dot_recombine`` (interpret mode), so a layout error shows here
before the card.
"""

import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import concrete_tpu.jax_config  # noqa: F401
import jax
import jax.numpy as jnp

from concrete_tpu.ops import pallas_dot_recombine as pdr
from concrete_tpu.ops import pallas_step as ps
from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.ops import external_product as txp

# the kernel's tile constants (csrc/banded_wgmma.cuh, and the
# epilogue's padded row of csrc/external_product.cu)
TM, BN, JC, MAX_WG, WIN_PAD = 64, 128, 256, 4, 80
KSTEPS, JQ = JC // 32, JC // 16
STAGES, RED = 4, TM + 4       # ring slots; the epilogue's padded row
MAX_SMEM = 227 * 1024 - 2 * STAGES * 8   # dynamic shared memory per block
SBO = 1024                    # the digit descriptor's stride byte offset
SWIZZLE = True                # its layout type: the 128-byte swizzle
M64 = (1 << 64) - 1

_build_fused_rhs = jax.jit(pdr.build_fused_rhs, static_argnums=(1, 2),
                           static_argnames=("a_limbs",))


def _band_word(lo, hi, shift):
    """band_word: funnel shift right of hi:lo, then bytes reversed."""
    v = ((hi << np.uint64(32)) | lo) >> shift & np.uint64(M64 >> 32)
    b = [(v >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
    return (b[0] << np.uint64(24)) | (b[1] << np.uint64(16)) | \
        (b[2] << np.uint64(8)) | b[3]


def _fragments_to_tile(regs: np.ndarray) -> np.ndarray:
    """(4 warps, 32 lanes, 4 registers) u32 -> the (64, 32) int8 A tile
    they hold in the m16n8k32 layout: a0 row g bytes 4tg.., a1 row g+8,
    a2 row g bytes 16+4tg.., a3 row g+8."""
    wi, lane, reg, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(4),
                                   np.arange(4), indexing="ij")
    g, tg = lane >> 2, lane & 3
    row = 16 * wi + g + 8 * (reg & 1)
    col = 16 * (reg >> 1) + 4 * tg + i
    tile = np.zeros((64, 32), np.int8)
    tile[row, col] = ((regs[..., None] >> (8 * i).astype(np.uint64))
                      & np.uint64(0xFF)).astype(np.uint8).view(np.int8)
    return tile


def _stage_tile(row_of, b0, jc, batch):
    """The digit tile as issue_chunk's 16-byte pieces lay it out: piece i
    holds bytes jq*16.. of ciphertext row b0 + rb (zeros past the batch),
    at piece_dst: 128-j atom column, 8-row atom, row, chunk ^ row."""
    i = np.arange(BN * JC // 16)
    lane, q = i & 31, i >> 5
    grp, r8 = q // (JQ // 4), lane & 7
    rb, jq = grp * 8 + r8, (lane >> 3) + 4 * (q % (JQ // 4))
    dst = (jq >> 3) * (BN * 128) + grp * 1024 + r8 * 128 \
        + (((jq & 7) ^ r8) << 4)
    tile = np.zeros(BN * JC, np.int8)
    live = b0 + rb < batch
    rows = row_of(b0 + rb[live])                        # (pieces, N)
    cols = jc * JC + jq[live, None] * 16 + np.arange(16)
    tile[dst[live, None] + np.arange(16)] = np.take_along_axis(rows, cols, 1)
    return tile


def _descriptor_read(tile, kk):
    """The (32 k, 128 n) B operand of k-step kk through the K-major
    descriptor: start address kstep_addr (atom column kk // 4, 32 bytes per
    k-step inside it), rows 128 bytes apart in 8-row atoms SBO apart, then
    the swizzle on the address bits (the tile starts on 1024 bytes)."""
    k, col = np.arange(32)[:, None], np.arange(BN)[None, :]
    addr = (kk >> 2) * (BN * 128) + (kk & 3) * 32 + (col // 8) * SBO \
        + (col % 8) * 128 + k
    if SWIZZLE:
        addr = addr ^ (((addr >> 7) & 7) << 4)
    return tile[addr]


def _window_words(mem, start, win_len, vv_end):
    """A staged key window as u32 words: 4-byte copies from the aligned
    address `start`, bytes at or past the end of vv left zero."""
    idx = start + np.arange(win_len)
    win = np.where(idx < vv_end, mem[np.minimum(idx, len(mem) - 1)], 0)
    return win.astype(np.uint8).view("<u4").astype(np.uint64)


def _band_registers(w32, m, n, jc):
    """(KSTEPS k-steps, 4 warps, 32 lanes, 4 registers) of the key band,
    as the kernel's fragment loop computes them from the window words."""
    kk, wi, lane = np.meshgrid(np.arange(KSTEPS), np.arange(4),
                               np.arange(32), indexing="ij")
    g, tg = lane >> 2, lane & 3
    y = m + 16 * wi + g + n - 4 - (jc * JC + 32 * kk) - 4 * tg
    q, sh = (y >> 2) - 4, (8 * (y & 3)).astype(np.uint64)
    regs = np.zeros(kk.shape + (4,), np.uint64)
    for reg, off in ((2, 0), (3, 2), (0, 4), (1, 6)):
        regs[..., reg] = _band_word(w32[q + off], w32[q + off + 1], sh)
    return regs


def planes_per_block(n, used):
    """The kernel's host rule for its warpgroups per block: one per kept
    plane, at most MAX_WG, fewer while the ring, their key windows (or the
    epilogue's staging) and 1024 bytes of alignment exceed MAX_SMEM."""
    win_slots = 2 if n // JC >= 3 else STAGES

    def smem(wg):
        return max(STAGES * BN * JC + win_slots * wg * (n + WIN_PAD),
                   wg * BN * RED * 4) + 1024
    n_wg = min(used, MAX_WG)
    while n_wg > 1 and smem(n_wg) > MAX_SMEM:
        n_wg -= 1
    return n_wg


def emulate(planes, vv, acc, keep, limb_offset, misalign, n_wg=None):
    """acc (u64) += kernel B's result, moving bytes as the kernel does;
    vv lies `misalign` bytes past a 4-byte boundary; `n_wg` planes per
    block (default: the kernel's rule).  One BLAS thread: its products
    are small, and the test workers share the host's cores."""
    kp1 = vv.shape[1]
    used = min(keep, 8 - limb_offset)
    out = acc.copy()
    with threadpool_limits(1):
        for b0, t0, cout, p_lo, d in core_sums(
                planes, vv, kp1, used,
                lambda p: p < keep and 8 * (p + limb_offset) < 64,
                misalign, n_wg):
            # the shift-add epilogue: the planes' int32 sums, shifted, into
            # acc (u64 arithmetic wraps mod 2^64, as the kernel's does)
            d32 = d.astype(np.int32).astype(np.int64).view(np.uint64)
            add = np.zeros((TM, BN), np.uint64)
            for wg in range(d.shape[0]):
                p = p_lo + wg
                if p < keep and 8 * (p + limb_offset) < 64:
                    add += d32[wg] << np.uint64(8 * (p + limb_offset))
            nb = min(BN, planes.shape[1] // kp1 - b0)
            rows = (b0 + np.arange(nb)) * kp1 + cout
            out[rows, t0:t0 + TM] += add[:, :nb].T
    return out


def core_sums(planes, vv, kp1, used, live, misalign, n_wg=None):
    """The main loop of csrc/banded_wgmma.cuh, moving bytes as it does:
    yields (b0, t0, cout, p_lo, d) per block, d (n_wg, TM, BN) the int64
    sums of its warpgroups' planes p_lo + wg (zero where not `live`).
    The lhs is addressed as the header does, planes (l*A, B*kp1, N) with
    Cin = l*kp1 (the JAX package's stacked lhs is one level of kp1 = Cin
    rows); vv (Cin, Cout, S, 2N-1) lies `misalign` bytes past a 4-byte
    boundary; `used` planes, `n_wg` per block (default: the kernel's
    rule)."""
    la, rows, n = planes.shape
    cin_n, cout_n, s_planes, _ = vv.shape
    levels, batch = cin_n // kp1, rows // kp1
    a_limbs = la // levels
    if n_wg is None:
        n_wg = planes_per_block(n, used)
    groups = -(-used // n_wg)
    mem = np.zeros(misalign + vv.size + 8, np.uint8)
    mem[misalign:misalign + vv.size] = vv.reshape(-1).view(np.uint8)
    vv_end, vrow = misalign + vv.size, 2 * n - 1
    win_len = n + WIN_PAD
    chunks = a_limbs * cin_n * (n // JC)
    for b0 in range(0, batch, BN):
        tiles = []
        for c in range(chunks):
            jc, ac = c % (n // JC), c // (n // JC)
            cin, a = ac % cin_n, ac // cin_n
            lev, r = cin // kp1, cin % kp1
            tiles.append(_stage_tile(
                lambda b, i=lev * a_limbs + a, r=r: planes[i, b * kp1 + r],
                b0, jc, batch))
        for t0 in range(0, n, TM):
            for z in range(cout_n * groups):
                cout, p_lo = z % cout_n, (z // cout_n) * n_wg
                d = np.zeros((n_wg, TM, BN), np.int64)
                for c in range(chunks):
                    jc, ac = c % (n // JC), c // (n // JC)
                    cin, a = ac % cin_n, ac // cin_n
                    for wg in range(n_wg):
                        p = p_lo + wg
                        s = p - a
                        if not live(p) or not 0 <= s < s_planes:
                            continue
                        row = misalign + ((cin * cout_n + cout) * s_planes
                                          + s) * vrow + t0
                        w32 = _window_words(mem, row & ~3, win_len, vv_end)
                        regs = _band_registers(w32, row & 3, n, jc)
                        # the KSTEPS k-steps as one product (exact in
                        # float64: every partial sum is below 2^53)
                        a_op = np.concatenate([_fragments_to_tile(regs[kk])
                                               for kk in range(KSTEPS)], 1)
                        b_op = np.concatenate([_descriptor_read(tiles[c], kk)
                                               for kk in range(KSTEPS)], 0)
                        d[wg] += (a_op.astype(np.float64)
                                  @ b_op.astype(np.float64)).astype(np.int64)
                yield b0, t0, cout, p_lo, d


def _case(n, a_limbs, keep, batch, levels=2, kp1=2, seed=0):
    rng = np.random.default_rng(seed + n + 7 * a_limbs + keep + batch)
    limb_offset = 8 - keep
    s_planes = keep
    cin = levels * kp1
    vv = rng.integers(-128, 128, (cin, kp1, s_planes, 2 * n - 1)) \
        .astype(np.int8)
    planes = rng.integers(-128, 128, (levels * a_limbs, batch * kp1, n)) \
        .astype(np.int8)
    acc = rng.integers(0, 1 << 64, (batch * kp1, n), dtype=np.uint64)
    return planes, vv, acc, limb_offset


def _plain(planes, vv, acc, keep, limb_offset):
    got = torch.from_numpy(acc.view(np.int64).copy())
    txp.external_product_accumulate_plain(
        torch.from_numpy(planes), torch.from_numpy(vv), got, keep=keep,
        limb_offset=limb_offset)
    return got.numpy().view(np.uint64)


@pytest.mark.parametrize("misalign", [0, 3])
@pytest.mark.parametrize("n,a_limbs,keep,batch", [
    (256, 1, 4, 5), (256, 2, 8, 3), (512, 1, 8, 3), (512, 2, 4, 2),
    (256, 1, 4, 130)], ids=["n256-a1-k4", "n256-a2-k8", "n512-a1-k8",
                            "n512-a2-k4", "n256-ragged130"])
def test_operand_plan_matches_plain(n, a_limbs, keep, batch, misalign):
    """The emulated kernel == external_product_accumulate_plain, with vv
    aligned and 3 bytes past a word boundary (a step of the packed BSK)."""
    planes, vv, acc, limb_offset = _case(n, a_limbs, keep, batch)
    got = emulate(planes, vv, acc, keep, limb_offset, misalign)
    assert np.array_equal(got, _plain(planes, vv, acc, keep, limb_offset))


@pytest.mark.parametrize("n,used,n_wg", [(1024, 4, 4), (8192, 4, 4),
                                         (8192, 8, 4), (16384, 4, 3),
                                         (32768, 4, 1), (256, 2, 2)])
def test_planes_per_block(n, used, n_wg):
    """Four planes' key windows fit a block up to N=8192; at N=16384
    three, at N=32768 one."""
    assert planes_per_block(n, used) == n_wg


@pytest.mark.parametrize("n_wg", [3, 1])
def test_operand_plan_with_fewer_planes_per_block(n_wg):
    """Fewer warpgroups than kept planes (as at N >= 16384): the planes
    take more blocks, the last partly idle, and their sums meet in acc."""
    planes, vv, acc, limb_offset = _case(256, 1, 4, 5, seed=2)
    got = emulate(planes, vv, acc, 4, limb_offset, misalign=2, n_wg=n_wg)
    assert np.array_equal(got, _plain(planes, vv, acc, 4, limb_offset))


@pytest.mark.parametrize("n,a_limbs,keep,batch", [(256, 2, 4, 5),
                                                  (512, 1, 8, 3)])
def test_operand_plan_matches_dot_recombine(n, a_limbs, keep, batch):
    """The emulated kernel == the JAX package's dot_recombine (interpret
    mode), the shipped TPU kernel it replaces."""
    levels, kp1 = 2, 2
    planes, vv, acc, limb_offset = _case(n, a_limbs, keep, batch, seed=1)
    got = emulate(planes, vv, acc, keep, limb_offset, misalign=1)
    lhs = np.concatenate([
        np.concatenate([planes[lev * a_limbs + a].reshape(batch, kp1, n)
                        for lev in range(levels)], axis=1)
        .reshape(batch, levels * kp1 * n) for a in range(a_limbs)], axis=1)
    s_keep = min(keep, vv.shape[2] + a_limbs - 1)
    lo, hi = ps.split_u64(jnp.asarray(acc))
    rhs = _build_fused_rhs(jnp.asarray(vv), 128, s_keep, a_limbs=a_limbs)
    lo2, hi2 = pdr.dot_recombine(
        jnp.asarray(lhs), rhs, lo.reshape(batch, kp1 * n),
        hi.reshape(batch, kp1 * n), keep=s_keep, limb_offset=limb_offset,
        block_b=batch, block_k=a_limbs * levels * kp1 * n, interpret=True)
    want = np.asarray(ps.merge_u64(lo2, hi2)).reshape(batch * kp1, n)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mutation", ["stride", "no_swizzle"])
def test_descriptor_mutations_fail(mutation, monkeypatch):
    """The rehearsal has teeth: the digit tile read with the no-swizzle
    group stride (128 bytes), or without the swizzle, gives another
    product."""
    planes, vv, acc, limb_offset = _case(256, 1, 4, 9)
    want = _plain(planes, vv, acc, 4, limb_offset)
    if mutation == "stride":
        monkeypatch.setattr(sys.modules[__name__], "SBO", 128)
    else:
        monkeypatch.setattr(sys.modules[__name__], "SWIZZLE", False)
    got = emulate(planes, vv, acc, 4, limb_offset, misalign=0)
    assert not np.array_equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """N not a multiple of the 128-j digit tile is refused on the card;
    the CPU path (the plain version) takes any N."""
    planes, vv, acc, limb_offset = _case(256, 1, 4, 2)
    small = np.ascontiguousarray(planes[..., :64])
    got = torch.from_numpy(acc[:, :64].view(np.int64).copy())
    txp.external_product_accumulate(
        torch.from_numpy(small), torch.from_numpy(
            np.ascontiguousarray(vv[..., 256 - 64:256 + 63])), got, keep=4,
        limb_offset=limb_offset)
    assert got.shape == (4, 64)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="unsupported shape"):
            txp.external_product_accumulate(
                torch.from_numpy(small).cuda(), torch.from_numpy(
                    np.ascontiguousarray(vv[..., 256 - 64:256 + 63])).cuda(),
                got.cuda(), keep=4, limb_offset=limb_offset)
