"""The latency blind rotate (B <= ``LATENCY_BATCH_MAX``) in one launch.

Counterpart of the JAX package's ``_blind_rotate_xla_latency`` scan: per
step i of n_small, kernel 1's digits of X^{a_i} acc - acc, kernel 9's
latency-form product of the BSK step's kept limb rows with the band built
from them, and the recombine's shift-add into acc.  The CUDA kernel
(``csrc/blind_rotate_latency.cu``, its header says what bounds it and how)
runs all n_small steps for all B ciphertexts in one launch: one
thread-block cluster per ciphertext, its blocks splitting the outputs t,
each block's slice of the accumulator double-buffered in its shared
memory and read by the others through distributed shared memory, the key
rows staged in a ring of two whole steps, or of one where two do not fit.
Its plain version is that scan on the plain versions of kernel 1, kernel
9's latency form and the recombine.

``plan`` is the shape rule: the shapes whose block fits the card's shared
memory.  Two ring slots: the B <= 4 latency shape (N=1024, k+1 = 2, l = 4,
4 kept key limbs), k+1 = 3 with two digit limbs, N=2048 at l = 2 and 4 key
limbs.  One slot: GameOfLife's lookups (N=2048, k+1 = 2, l = 2, base 2^7,
5 kept key limbs), N=2048 at l = 2 up to 8 key limbs, the latency shape's
untruncated key (8 limbs) and ``examples/table_lookup.py``'s (k+1 = 5,
N=256, l = 3, 8 limbs).  ``core.kernels`` sends a CUDA accumulator at any
other shape to the three-kernel step loop.  This is the banded key's
form; a fused (CRT-NTT) key at B <= 4 takes
``ops.fused_latency``'s kernel, and its three-kernel loop
(``ops.fused_ntt``) elsewhere.
``blind_rotate_latency`` launches the kernel on CUDA tensors, raises at a
shape the rule refuses, and runs the plain version on CPU ones; there is
no other fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import _build
from concrete_tpu_torch.ops import banded_mm as bm
from concrete_tpu_torch.ops import recombine as rc
from concrete_tpu_torch.ops import step

NAME = "blind_rotate_latency"
#: csrc/blind_rotate_latency.cu's and csrc/banded_latency.cuh's constants
MAX_SMEM = 227 * 1024           # shared memory per block, H100 (opt-in)
MAX_CLUSTER = 16                # blocks per cluster, the non-portable most
LT, JS_MAX = 64, 1024           # t per group of 4 m16 tiles, j per K slice
#: clusters of MAX_CLUSTER blocks, one block per SM, all on the card at once
MAX_BATCH = 8
#: bytes past the packed key's end that the kernel's bulk copy of a key
#: row (from the 16-byte boundary below it, a multiple of 16 bytes) may read
KEY_TAIL = 16


def with_tail(planes: torch.Tensor, device=None) -> torch.Tensor:
    """`planes` copied to `device` (default: its own) as a contiguous
    tensor whose storage holds KEY_TAIL more bytes past its end
    (``core.kernels.pack_bsk`` packs the key so)."""
    flat = torch.empty(planes.numel() * planes.element_size() + KEY_TAIL,
                       dtype=torch.int8, device=device or planes.device)
    out = flat[:planes.numel() * planes.element_size()].view(
        planes.dtype).view(planes.shape)
    return out.copy_(planes)


def tail_bytes(t: torch.Tensor) -> int:
    """Bytes of `t`'s storage past its end."""
    return t.untyped_storage().nbytes() - (
        t.storage_offset() + t.numel()) * t.element_size()


@dataclasses.dataclass(frozen=True)
class Plan:
    """One block's layout: `cluster` blocks per ciphertext, `ltb` outputs
    t each (a power of two); K slices of `js` j (`slices` of them); shared
    memory `smem` = `region` (digits, then the int32 planes) + the
    accumulator slice's two buffers + the slices' bands (first the whole
    accumulator's copy) + `slots` x `ring_slot` (the key ring, a whole
    step's rows a slot: two slots where they fit, step i + 1 staged while
    step i computes, else one, refilled once step i's product has read
    it) + the ring's 4 mbarriers."""
    cluster: int
    ltb: int
    js: int
    slices: int
    band_bytes: int
    region: int
    ring_slot: int
    slots: int
    smem: int


def plan(batch: int, n: int, kp1: int, levels: int, d_limbs: int,
         s_key: int) -> Plan | None:
    """The shape rule of the persistent kernel: its plan at B ciphertexts,
    N, k+1, l, `d_limbs` digit limbs and `s_key` kept key limbs, or None
    where it does not run (the kernel's make_plan computes the same)."""
    if not (1 <= batch <= MAX_BATCH and kp1 >= 1 and levels >= 1
            and 1 <= d_limbs <= 4 and 1 <= s_key <= 8 and n >= LT
            and n % LT == 0):
        return None
    cluster = min(MAX_CLUSTER, n // LT)
    ltb = n // cluster
    if n % cluster or ltb % LT or ltb & (ltb - 1):
        return None
    js = JS_MAX
    while n % js:
        js //= 2
    cin = levels * kp1
    slices = cin * (n // js)
    ncols = kp1 * s_key
    ncp = -(-ncols // 8) * 8
    # a view's words, at a stride of 8 or 24 modulo 32 words: the A
    # fragments' loads from the 4 views fall in distinct banks
    band_words = (js + ltb) // 4 + 1
    band_words += (8 - band_words) % 16
    band_bytes = -(-(4 * d_limbs * band_words * 4) // 16) * 16
    slice_bytes = ncols * (js + 16)
    dig = cin * n * 4
    # the int32 planes in C-fragment order, one 4 x 4 x 32-word block per
    # pass (64-t group, digit limb, n tile), then 8 warps' slots
    red = ((ltb // LT) * d_limbs * (ncp // 8) + 8) * 512 * 4
    region = -(-max(dig, red) // 16) * 16
    ring_slot = slices * slice_bytes
    bands = max(slices * band_bytes, kp1 * n * 8)   # or the acc's copy
    fixed = region + 2 * kp1 * ltb * 8 + bands + 32
    slots = 2 if fixed + 2 * ring_slot <= MAX_SMEM else 1
    smem = fixed + slots * ring_slot
    if smem > MAX_SMEM:
        return None
    return Plan(cluster=cluster, ltb=ltb, js=js, slices=slices,
                band_bytes=band_bytes, region=region, ring_slot=ring_slot,
                slots=slots, smem=smem)


def _shape(a_t: torch.Tensor, acc: torch.Tensor, planes: torch.Tensor,
           kp1: int, levels: int):
    """(batch, n_small, s_key, n) of the operands."""
    if a_t.ndim != 2 or acc.ndim != 3 or planes.ndim != 5:
        raise ValueError(f"{NAME}: a_t must be (B, n_small), acc (k+1, B, "
                         f"N) and planes (n_small, Cin, k+1, S, 2N-1), got "
                         f"{tuple(a_t.shape)}, {tuple(acc.shape)} and "
                         f"{tuple(planes.shape)}")
    batch, n_small = a_t.shape
    n = acc.shape[2]
    if (tuple(acc.shape[:2]) != (kp1, batch) or n_small == 0
            or tuple(planes.shape[:3]) != (n_small, levels * kp1, kp1)
            or planes.shape[4] != 2 * n - 1 or planes.shape[3] == 0):
        raise ValueError(f"{NAME}: a_t {tuple(a_t.shape)}, acc "
                         f"{tuple(acc.shape)} and planes "
                         f"{tuple(planes.shape)} do not match (l={levels}, "
                         f"k+1={kp1})")
    return batch, n_small, planes.shape[3], n


def blind_rotate_latency_plain(a_t: torch.Tensor, acc: torch.Tensor,
                               planes: torch.Tensor, *, kp1: int,
                               levels: int, base_log: int,
                               limb_offset: int) -> torch.Tensor:
    """Plain PyTorch version: the three-kernel step loop on the plain
    versions of kernel 1, kernel 9's latency form and the recombine."""
    batch, n_small, _, n = _shape(a_t, acc, planes, kp1, levels)
    acc = acc.reshape(kp1 * batch, n).clone()
    a_rows = a_t.t().repeat(1, kp1).contiguous()    # row r*B + b: a_t[b]
    for i in range(n_small):
        digits = step.rotate_decompose_digits_plain(
            acc, a_rows[i], base_log=base_log, levels=levels)
        prods = bm.banded_matmul_latency_plain(
            digits, planes[i], kp1=kp1, levels=levels, base_log=base_log)
        rc.recombine_accumulate_plain(prods.view(kp1 * batch, -1, n), acc,
                                      limb_offset=limb_offset)
    return acc.view(kp1, batch, n)


def blind_rotate_latency(a_t: torch.Tensor, acc: torch.Tensor,
                         planes: torch.Tensor, *, kp1: int, levels: int,
                         base_log: int, limb_offset: int) -> torch.Tensor:
    """a_t (B, n_small) int32 switched mask, acc (k+1, B, N) int64 first
    accumulator (rows (r, b)), planes the packed BSK (n_small, Cin, k+1, S,
    2N-1) int8 -> the accumulator after n_small steps, (k+1, B, N), into
    `acc` in place; on the card one launch."""
    if acc.device.type == "cpu":
        return acc.copy_(blind_rotate_latency_plain(
            a_t, acc, planes, kp1=kp1, levels=levels, base_log=base_log,
            limb_offset=limb_offset))
    if acc.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {acc.device}")
    batch, n_small, s_key, n = _shape(a_t, acc, planes, kp1, levels)
    d_limbs = lb.num_digit_limbs(base_log)
    pl = plan(batch, n, kp1, levels, d_limbs, s_key)
    if pl is None or levels * base_log > 63:
        raise ValueError(f"{NAME}: the persistent kernel does not take B="
                         f"{batch}, N={n}, k+1={kp1}, l={levels}, "
                         f"{d_limbs} digit limbs, {s_key} key limbs")
    if not 0 <= limb_offset < lb.N_LIMBS_U64:
        raise ValueError(f"{NAME}: limb_offset {limb_offset} outside [0, 8)")
    for name, t, dtype in (("a_t", a_t, torch.int32), ("acc", acc,
                                                        torch.int64),
                           ("planes", planes, torch.int8)):
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != acc.device:
            raise ValueError(f"{NAME}: {name} must be contiguous {dtype} on "
                             f"{acc.device}")
    if planes.data_ptr() % 16 or tail_bytes(planes) < KEY_TAIL:
        raise ValueError(f"{NAME}: planes must be 16-byte aligned, with "
                         f"{KEY_TAIL} bytes of storage past its end "
                         f"(with_tail)")
    _build.check(NAME, _build.library().blind_rotate_latency(
        a_t.data_ptr(), acc.data_ptr(), planes.data_ptr(),
        planes.data_ptr() + planes.numel(), batch, n_small, kp1, levels,
        base_log, d_limbs, s_key, n, limb_offset, pl.cluster,
        _build.stream_of(acc)))
    _build.count(NAME)
    return acc
