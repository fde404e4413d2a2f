"""Batched TFHE kernels in PyTorch — counterpart of ``concrete_tpu/core/kernels.py``.

Every function matches ``concrete_tpu_torch.core.refimpl`` (the numpy
oracle) and the JAX package's kernels bit for bit; tests/test_torch_kernels.py
holds them to it.  Torus values are int64 tensors (mod 2^64 wrap, logical
right shifts through ``limbs.srl``); shapes use B = batch, n = small LWE dim,
k = GLWE dim, N = poly size, l = decomposition levels.

The blind rotate dispatches as the JAX package does.  A ``FusedBSK`` at a
batch of at most ``LATENCY_BATCH_MAX`` runs ``ops.fused_latency``'s
kernel, on the card one launch for all n_small steps, at the shapes its
rule takes; at any other, ``ops.crt_scan``'s kernel, also one launch for
all steps, at the shapes its plan takes; elsewhere the CRT-NTT loop
``ops.fused_ntt.scan_steps`` (a host loop of three kernels per step:
digits, CRT-NTT external product, Garner);
``ops.fused_ntt.blind_rotate_fused`` chooses (``blind_rotate_form``).  A banded
``LimbBSK`` at a batch of at most ``LATENCY_BATCH_MAX`` runs
``_blind_rotate_latency``: on the card one launch of ``ops.latency``'s
persistent kernel for all n_small steps, at the shapes its rule takes.
Above that batch, a host loop whose step runs ``ops.step.rotate_decompose``
(X^a * acc - acc, gadget digits, int8 limbs) and then the product selected by ``BANDED_MM_MODE``:

- ``"auto"``, ``"fusedrecombine"``: ``ops.external_product``'s kernel B,
  the product shift-added into acc in place;
- ``"pallas"``: ``ops.banded_mm.banded_matmul`` (kernel 9), then
  ``ops.recombine.recombine_accumulate``;
- ``"fuseddot"``: one ``torch._int_mm`` against the Toeplitz rhs, then
  ``recombine_accumulate``;
- ``"planes"``: one ``torch._int_mm`` per J-block and digit limb
  (``banded_matmul_plain``), then ``recombine_accumulate``.

Every mode gives the same bits.  Kernels run on a CUDA accumulator, their
plain PyTorch versions on a CPU one.

Keyswitch, modulus switch, LUT expansion and sample extract stay plain torch
ops, as they stay plain XLA in the JAX package, but for one route of
``pbs_batch`` (``prologue_route``): CUDA ciphertexts on a ``LimbBSK`` at B
<= ``LATENCY_BATCH_MAX`` run keyswitch, modulus switch and the first
accumulator in one launch (``ops.prologue``), whose outputs go straight to
the latency blind rotate.  At such a batch the keyswitch is a memory-bound
matrix-vector product; above it, a GEMM, and it keeps ``torch._int_mm``.

``pbs_batch`` records the spans ``pbs`` (attribute ``rows``, the batch) and
its stages ``pbs.keyswitch`` (attribute ``form``: ``prologue``, the one
launch, init included, or ``torch``), ``pbs.init`` (modulus switch and LUT
rotation; not on the prologue route), ``pbs.blind_rotate`` (attribute
``form``: ``banded_scan``, ``latency_persistent``, ``latency_steps``,
``fused_latency``, ``crt_ntt_scan`` or ``crt_ntt_loop``) and ``pbs.extract``
(``utils/telemetry``), none inside a step loop, and counts the rows that
took the prologue route in ``pbs.prologue_rows``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import banded_mm as bm
from concrete_tpu_torch.ops import external_product as xp
from concrete_tpu_torch.ops import latency as lat
from concrete_tpu_torch.ops import prologue as pro
from concrete_tpu_torch.ops import recombine as rc
from concrete_tpu_torch.ops import step
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils import telemetry as tm
from concrete_tpu_torch.utils.device import resolve_device

_Q_LOG = 64
_M32 = 0xFFFFFFFF

#: the JAX package's banded-matmul switch (its core/kernels.py), read from
#: the same environment variables: ``CONCRETE_TPU_FUSED_MM=1`` makes
#: "pallas" the default of ``CONCRETE_TPU_BANDED_MM``
USE_FUSED_BANDED_MM = os.environ.get("CONCRETE_TPU_FUSED_MM", "0") == "1"
BANDED_MM_MODE = os.environ.get(
    "CONCRETE_TPU_BANDED_MM", "pallas" if USE_FUSED_BANDED_MM else "auto")
BANDED_MM_MODES = ("auto", "fusedrecombine", "pallas", "fuseddot", "planes")

#: banded blind rotates of at most this many ciphertexts take the latency
#: path (band stacks built from the digits, the BSK step as the lhs)
LATENCY_BATCH_MAX = int(os.environ.get("CONCRETE_TPU_LATENCY_BATCH_MAX",
                                       "4"))


# ---------------------------------------------------------------------------
# Elementwise torus ops (match refimpl exactly)
# ---------------------------------------------------------------------------

def decompose(v: torch.Tensor, base_log: int, levels: int) -> torch.Tensor:
    """Balanced gadget decomposition -> int32 digits (..., levels).

    d_j = w_j - (w_{j-1} << B) with w_j = round_half_up(v / 2^(64 - jB)).
    """
    assert levels * base_log <= 63
    ws = [lb.srl(lb.srl(v, _Q_LOG - j * base_log - 1) + 1, 1)
          for j in range(levels + 1)]
    # digits are tiny: the low 32 bits carry the signed value
    return torch.stack([(ws[j] - (ws[j - 1] << base_log)).to(torch.int32)
                        for j in range(1, levels + 1)], dim=-1)


def decompose_hi32(v: torch.Tensor, base_log: int,
                   levels: int) -> torch.Tensor:
    """decompose() from the top 32-bit word alone, in u32 arithmetic (held
    in int64 and masked) — exact whenever levels * base_log <= 31."""
    assert levels * base_log <= 31, (base_log, levels)
    hi = lb.srl(v, 32)
    ws = [hi >> 31]
    for j in range(1, levels + 1):
        t = hi >> (_Q_LOG - j * base_log - 33)
        u = (t + 1) & _M32
        ov = (t == _M32).to(torch.int64)
        ws.append((u >> 1) | (ov << 31))
    return torch.stack([((ws[j] - (ws[j - 1] << base_log)) & _M32)
                        .to(torch.int32) for j in range(1, levels + 1)],
                       dim=-1)


def modulus_switch(v: torch.Tensor, log2_poly_size: int) -> torch.Tensor:
    """Torus -> [0, 2N) int32 with round-half-up (simulation.cpp:60-75)."""
    v = lb.srl(v, _Q_LOG - log2_poly_size - 2)
    v = lb.srl(v + (v & 1), 1)
    return (v & ((1 << (log2_poly_size + 1)) - 1)).to(torch.int32)


def monomial_mul_batch(polys: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X^r * poly mod (X^N + 1) for polys (..., N) and per-row rotations
    r (...,) in [0, 2N), as one gather (the JAX package's masked rolls
    exist only because TPU gathers are slow)."""
    n = polys.shape[-1]
    j = torch.arange(n, device=polys.device)
    src = torch.remainder(j - r[..., None].to(torch.int64), 2 * n)
    neg = src >= n
    out = torch.gather(polys, -1, torch.where(neg, src - n, src))
    return torch.where(neg, -out, out)


def encode_expand_lut(table_vals: torch.Tensor, poly_size: int,
                      message_bits: int, out_bits: int,
                      signed: bool = False) -> torch.Tensor:
    """refimpl.encode_expand_lut on a tensor of raw table entries (..., 2^p),
    wrapped mod 2^(out_bits+1), on the tensor's device: the (..., N)
    accumulator polynomials of a lookup (the counterpart of the JAX
    package's ``encode_expand_lut_jnp``, which dynamic table lookups run)."""
    lut = table_vals.to(torch.int64) & ((1 << (out_bits + 1)) - 1)
    assert lut.shape[-1] == 1 << message_bits
    if signed:
        half = lut.shape[-1] // 2
        lut = torch.cat([lut[..., half:], lut[..., :half]], dim=-1)
    scaled = lut << (_Q_LOG - out_bits - 1)
    mega = poly_size // lut.shape[-1]
    naive = torch.repeat_interleave(scaled, mega, dim=-1)
    ext = torch.cat([naive, -naive], dim=-1)            # negacyclic ext
    return torch.roll(ext, 2 * poly_size - mega // 2,
                      dims=-1)[..., :poly_size]


# ---------------------------------------------------------------------------
# Key material pre-processing (host numpy, then one copy to the device)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LimbBSK:
    """Bootstrap key as negacyclically-extended int8 limb planes:
    (n, Cin=(k+1)l, Cout=k+1, S=8-truncate_limbs, 2N-1), the layout of
    ``concrete_tpu.core.kernels.pack_bsk``."""
    planes: torch.Tensor
    base_log: int
    levels: int
    truncate_limbs: int = 0

    @property
    def n_small(self) -> int:
        return self.planes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.planes.device


@dataclasses.dataclass(frozen=True)
class LimbKSK:
    """Keyswitch key as int8 limb planes (n_in, l, n_out+1, 8)."""
    planes: torch.Tensor
    base_log: int
    levels: int

    @property
    def device(self) -> torch.device:
        return self.planes.device


def pack_bsk(bsk_u64: np.ndarray, params: CryptoParams,
             truncate_limbs: int = 0, device=None) -> LimbBSK:
    """u64 BSK (n, l, k+1, k+1, N) -> banded limb planes (n, Cin, Cout, S,
    2N-1) with Cin = lev * (k+1) + r and the last axis the negacyclic
    extension [-(w[1:]), w] (u64 negation first, then the limb split).
    `truncate_limbs` drops that many low limb planes (S = 8 - t).  The
    key is uploaded as u64 to `device`, CUDA by default
    (``resolve_device``), and extended and split there
    (``limbs.split_u64_limbs``, bit for bit the host's
    ``u64_to_balanced_i8``)."""
    device = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(
        bsk_u64, dtype=np.uint64).view(np.int64)).to(device)
    n, l, kp1, _, big_n = x.shape
    # int64 negation wraps as u64 negation does
    ext = torch.cat([-x[..., 1:], x], dim=-1)
    limbs = lb.split_u64_limbs(ext).movedim(-1, -2)
    limbs = limbs.reshape(n, l * kp1, kp1, 8, 2 * big_n - 1)
    # with the tail the latency kernel's bulk copies may read
    return LimbBSK(planes=lat.with_tail(limbs[:, :, :, truncate_limbs:, :]),
                   base_log=params.pbs_base_log, levels=params.pbs_level,
                   truncate_limbs=truncate_limbs)


def pack_ksk(ksk_u64: np.ndarray, params: CryptoParams,
             device=None) -> LimbKSK:
    """u64 KSK (n_in, l, n_out+1) -> int8 limb planes (n_in, l, n_out+1, 8)
    on `device`, CUDA by default (``resolve_device``): uploaded as u64 and
    split there (``limbs.split_u64_limbs``, bit for bit the host's
    ``u64_to_balanced_i8``)."""
    device = resolve_device(device)
    u64 = torch.from_numpy(np.ascontiguousarray(
        ksk_u64, dtype=np.uint64).view(np.int64))
    return LimbKSK(planes=lb.split_u64_limbs(u64.to(device)),
                   base_log=params.ks_base_log, levels=params.ks_level)


# ---------------------------------------------------------------------------
# Keyswitch
# ---------------------------------------------------------------------------

def keyswitch(ct: torch.Tensor, ksk: LimbKSK) -> torch.Tensor:
    """Batched LWE keyswitch: (B, n_in+1) -> (B, n_out+1).

    out = (0.., b) - sum_{i,j} Decomp_j(a_i) * KSK[i][j], the products as one
    int8 GEMM per digit limb, (B, n_in*l) @ (n_in*l, (n_out+1)*8), shifted
    into int32 planes and recombined mod 2^64.
    """
    n_in, levels, n_out_p1, _ = ksk.planes.shape
    b_ct = ct.shape[0]
    a, body = ct[:, :n_in], ct[:, n_in]
    if levels * ksk.base_log <= 31:
        digits = decompose_hi32(a, ksk.base_log, levels)
    else:
        digits = decompose(a, ksk.base_log, levels)          # (B, n_in, l)
    a_limbs = lb.num_digit_limbs(ksk.base_log)
    d_limbs = lb.i32_digits_to_balanced_i8(digits, a_limbs).reshape(
        b_ct, n_in * levels, a_limbs)
    k_planes = ksk.planes.reshape(n_in * levels, n_out_p1 * 8)
    planes = torch.zeros((b_ct, n_out_p1, 8 + a_limbs - 1),
                         dtype=torch.int32, device=ct.device)
    for a_idx in range(a_limbs):
        prod = lb.int8_matmul(d_limbs[:, :, a_idx], k_planes)
        planes[:, :, a_idx:a_idx + 8] += prod.view(b_ct, n_out_p1, 8)
    acc = lb.recombine_i32_planes_to_u64(planes[:, :, :8])
    out = torch.zeros((b_ct, n_out_p1), dtype=torch.int64, device=ct.device)
    out[:, -1] = body
    return out - acc


# ---------------------------------------------------------------------------
# Blind rotation and the full PBS
# ---------------------------------------------------------------------------

def _lut_rows(lut_poly: torch.Tensor, b_ct: int, n: int) -> torch.Tensor:
    """Broadcast a shared (N,) or per-batch (B, N) LUT poly to (B, N)."""
    if lut_poly.ndim == 1:
        return lut_poly.expand(b_ct, n)
    return lut_poly.reshape(b_ct, n)


def _switch_and_init(ct_small: torch.Tensor, lut_poly: torch.Tensor,
                     params: CryptoParams):
    """The switched mask (B, n) int32 and the first accumulator (B, k+1, N):
    the trivial GLWE of X^{-b~} * LUT."""
    b_ct = ct_small.shape[0]
    n = params.polynomial_size
    k = params.glwe_dimension
    switched = modulus_switch(ct_small, params.log2_polynomial_size)
    a_t, b_t = switched[:, :-1], switched[:, -1]
    body0 = monomial_mul_batch(_lut_rows(lut_poly, b_ct, n),
                               (2 * n - b_t) % (2 * n))
    acc = torch.zeros((b_ct, k + 1, n), dtype=torch.int64,
                      device=ct_small.device)
    acc[:, k, :] = body0
    return a_t, acc


def blind_rotate(ct_small: torch.Tensor, bsk, lut_poly: torch.Tensor,
                 params: CryptoParams,
                 min_scale_log: int = None) -> torch.Tensor:
    """Batched blind rotation: (B, n+1) ct, (N,) or (B, N) LUT ->
    accumulator (B, k+1, N), dispatched as in the JAX package: a
    ``FusedBSK`` runs the CRT-NTT scan at any batch, at B <=
    ``LATENCY_BATCH_MAX`` in one launch of ``ops.fused_latency``'s kernel
    where its rule (``ops.fused_latency.plan``) takes the shape, else in
    one launch of ``ops.crt_scan``'s where ``ops.crt_scan.plan`` takes it,
    else in ``ops.fused_ntt.scan_steps``'s loop (``blind_rotate_fused``
    chooses, by ``blind_rotate_form``); a ``LimbBSK`` runs ``_blind_rotate_latency`` at B <=
    ``LATENCY_BATCH_MAX``, else the banded scan in ``BANDED_MM_MODE``.

    `min_scale_log`, the smallest output scale of the rows (the WoP sign
    PBS passes it; native lookups pass nothing and keep the JAX package's
    rule), holds a fused key's acc32 mode to ``ops.fused_ntt.
    acc32_eligible``'s message-scale gate; a banded key's accumulator is
    exact and ignores it.

    Banded, per step i: acc += recombine(Decomp(X^{a_i} acc - acc) (.)
    BSK_i), the kept limb planes shifted by 8*(s + truncate_limbs).  The
    accumulator is one (B*(k+1), N) int64 tensor, updated in place by
    kernel B or by ``recombine_accumulate``.
    """
    from concrete_tpu_torch.ops.fused_ntt import (FusedBSK, acc32_eligible,
                                                  blind_rotate_fused)
    if isinstance(bsk, FusedBSK):
        acc32 = None if min_scale_log is None \
            else acc32_eligible(bsk, min_scale_log)
        return blind_rotate_fused(ct_small, bsk, lut_poly, params,
                                  acc32=acc32)
    if not isinstance(bsk, LimbBSK):
        raise TypeError(f"unknown bootstrap key type {type(bsk).__name__}")
    mode = BANDED_MM_MODE
    if mode not in BANDED_MM_MODES:
        raise ValueError(f"unknown banded-matmul mode {mode!r}; choose from "
                         f"{BANDED_MM_MODES}")
    if ct_small.shape[0] <= LATENCY_BATCH_MAX:
        return _blind_rotate_latency(ct_small, bsk, lut_poly, params)
    b_ct = ct_small.shape[0]
    n = params.polynomial_size
    kp1 = params.glwe_dimension + 1
    levels = params.pbs_level
    with tm.span("pbs.init") if tm.on else tm.OFF:
        a_t, acc = _switch_and_init(ct_small, lut_poly, params)
    with tm.span("pbs.blind_rotate", form="banded_scan") if tm.on \
            else tm.OFF:
        _banded_scan(a_t, acc.view(b_ct * kp1, n), bsk, params, mode)
    return acc


def _banded_scan(a_t: torch.Tensor, acc: torch.Tensor, bsk: LimbBSK,
                 params: CryptoParams, mode: str) -> None:
    """The banded blind rotate's step loop at B > ``LATENCY_BATCH_MAX`` in
    ``mode``: a_t (B, n_small) int32, acc (B*(k+1), N) int64 updated in
    place."""
    n = params.polynomial_size
    kp1 = params.glwe_dimension + 1
    levels = params.pbs_level
    b_ct = a_t.shape[0]
    # per-step rotation of every accumulator row: (n_small, B*(k+1))
    a_rows = a_t.t().repeat_interleave(kp1, dim=1).contiguous()
    a_limbs = lb.num_digit_limbs(params.pbs_base_log)
    keep = 8 - bsk.truncate_limbs
    for i in range(bsk.n_small):
        planes = step.rotate_decompose(
            acc, a_rows[i], base_log=params.pbs_base_log, levels=levels,
            a_limbs=a_limbs)
        w_vv = bsk.planes[i]
        if mode in ("auto", "fusedrecombine"):
            xp.external_product_accumulate(planes, w_vv, acc, keep=keep,
                                           limb_offset=bsk.truncate_limbs)
            continue
        if mode == "fuseddot":
            prods = lb.int8_matmul(xp.digit_lhs(planes, kp1, levels),
                                   xp.toeplitz_rhs(w_vv, a_limbs, keep))
        else:
            matmul = bm.banded_matmul if mode == "pallas" \
                else bm.banded_matmul_plain
            prods = matmul(planes, w_vv, levels=levels)
        # planes past keep sit at shifts >= 64 and add nothing
        rc.recombine_accumulate(prods.view(b_ct * kp1, -1, n), acc,
                                limb_offset=bsk.truncate_limbs)


def _blind_rotate_latency(ct_small: torch.Tensor, bsk: LimbBSK,
                          lut_poly: torch.Tensor,
                          params: CryptoParams) -> torch.Tensor:
    """Latency-mode banded blind rotate for B <= LATENCY_BATCH_MAX, the
    counterpart of the JAX package's ``_blind_rotate_xla_latency`` and bit
    for bit its output.

    The roles of the product are swapped: the band stacks come from the
    rotated digits, ext_d = [-d[..., 1:], d] negated as signed int32 digits
    before the limb split, and the BSK step's raw limb rows w_vv[..., N-1:]
    are the lhs, one (k+1, Cin*N) block per kept BSK limb plane.  With a
    truncated key the low limbs of -w then differ from those the throughput
    path reads, so the two paths' bits differ.  The accumulator rows are
    ordered (r, b), the order of the product's planes.  A CUDA accumulator
    at a shape ``ops.latency.plan`` takes runs every step in one launch of
    the persistent kernel (``ops.latency.blind_rotate_latency``); at any
    other shape, the step loop (``_blind_rotate_latency_steps``); a CPU one,
    the plain version of the persistent kernel.
    """
    with tm.span("pbs.init") if tm.on else tm.OFF:
        a_t, acc = _switch_and_init(ct_small, lut_poly, params)
        acc = acc.transpose(0, 1).contiguous()      # (k+1, B, N)
    return _rotate_latency(a_t, acc, bsk, params)


def _rotate_latency(a_t: torch.Tensor, acc: torch.Tensor, bsk: LimbBSK,
                    params: CryptoParams) -> torch.Tensor:
    """The latency blind rotate from the switched mask a_t (B, n_small)
    int32 and the first accumulator (k+1, B, N) int64 -> (B, k+1, N): the
    persistent kernel, or the step loop where ``ops.latency.plan`` refuses
    the shape on the card."""
    b_ct = a_t.shape[0]
    n = params.polynomial_size
    kp1 = params.glwe_dimension + 1
    levels = params.pbs_level
    steps = acc.device.type == "cuda" and lat.plan(
        b_ct, n, kp1, levels, lb.num_digit_limbs(params.pbs_base_log),
        bsk.planes.shape[3]) is None
    with tm.span("pbs.blind_rotate", form="latency_steps" if steps
                 else "latency_persistent") if tm.on else tm.OFF:
        if steps:
            acc = _blind_rotate_latency_steps(a_t, acc, bsk, params)
        else:
            acc = lat.blind_rotate_latency(
                a_t.contiguous(), acc, bsk.planes, kp1=kp1, levels=levels,
                base_log=params.pbs_base_log,
                limb_offset=bsk.truncate_limbs)
        return acc.transpose(0, 1).contiguous()


def _blind_rotate_latency_steps(a_t: torch.Tensor, acc: torch.Tensor,
                                bsk: LimbBSK,
                                params: CryptoParams) -> torch.Tensor:
    """The latency blind rotate as a step loop of three kernels per step:
    kernel 1 (``rotate_decompose_digits``), kernel 9's latency form
    (``banded_matmul_latency``, which builds the band from the digits and
    reads the BSK step in place) and ``recombine_accumulate``.  a_t (B,
    n_small) int32, acc (k+1, B, N) int64 -> (k+1, B, N), acc updated in
    place."""
    kp1, b_ct, n = acc.shape
    levels = params.pbs_level
    acc = acc.view(kp1 * b_ct, n)
    a_rows = a_t.t().repeat(1, kp1).contiguous()    # row r*B + b: a_t[b]
    for i in range(bsk.n_small):
        digits = step.rotate_decompose_digits(
            acc, a_rows[i], base_log=params.pbs_base_log, levels=levels)
        prods = bm.banded_matmul_latency(
            digits, bsk.planes[i], kp1=kp1, levels=levels,
            base_log=params.pbs_base_log)            # (k+1, B, S+A-1, N)
        rc.recombine_accumulate(prods.view(kp1 * b_ct, -1, n), acc,
                                limb_offset=bsk.truncate_limbs)
    return acc.view(kp1, b_ct, n)


def sample_extract(acc: torch.Tensor, index: int = 0) -> torch.Tensor:
    """Batched sample extract: (B, k+1, N) -> (B, k*N+1)."""
    b_ct, kp1, n = acc.shape
    k = kp1 - 1
    t = torch.arange(n, device=acc.device)
    src = torch.remainder(index - t, 2 * n)
    neg = src >= n
    vals = acc[:, :k, :][..., torch.where(neg, src - n, src)]
    vals = torch.where(neg, -vals, vals)
    return torch.cat([vals.reshape(b_ct, k * n), acc[:, k, index, None]],
                     dim=-1)


def prologue_route(device: torch.device, bsk, b_ct: int) -> bool:
    """``pbs_batch`` runs ``ops.prologue``'s one launch, then the latency
    blind rotate, for `b_ct` ciphertexts on `device` with key `bsk`: on
    the card, on a banded key, at B <= ``LATENCY_BATCH_MAX`` (the blind
    rotate's own latency bound) and the kernel's ``MAX_BATCH``."""
    return device.type == "cuda" and isinstance(bsk, LimbBSK) \
        and b_ct <= min(LATENCY_BATCH_MAX, pro.MAX_BATCH)


def pbs_batch(ct_big: torch.Tensor, ksk: LimbKSK, bsk,
              lut_poly: torch.Tensor, params: CryptoParams,
              message_bits: int, signed: bool = False) -> torch.Tensor:
    """Batched programmable bootstrap: (B, n_big+1) -> (B, n_big+1).

    KS -> modswitch -> BR -> sample extract, matching refimpl.pbs bit for
    bit, with the signed quarter-torus offset (FHEToTFHEScalar.cpp:395-411).
    """
    b_ct = ct_big.shape[0]
    offset = pro.body_offset(message_bits, signed)
    with tm.span("pbs", rows=b_ct) if tm.on else tm.OFF:
        if prologue_route(ct_big.device, bsk, b_ct):
            with tm.span("pbs.keyswitch", form="prologue") if tm.on \
                    else tm.OFF:
                a_t, acc = pro.pbs_prologue(ct_big, ksk, lut_poly, params,
                                            offset)
                if tm.on:
                    tm.count("pbs.prologue_rows", b_ct)
            acc = _rotate_latency(a_t, acc, bsk, params)
        else:
            with tm.span("pbs.keyswitch", form="torch") if tm.on \
                    else tm.OFF:
                if offset:
                    ct_big = ct_big.clone()
                    ct_big[:, -1] += offset
                ct_small = keyswitch(ct_big, ksk)
            acc = blind_rotate(ct_small, bsk, lut_poly, params)
        with tm.span("pbs.extract") if tm.on else tm.OFF:
            return sample_extract(acc, 0)
