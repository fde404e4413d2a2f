"""Batched TFHE kernels in PyTorch — counterpart of ``concrete_tpu/core/kernels.py``.

Every function matches ``concrete_tpu_torch.core.refimpl`` (the numpy
oracle) and the JAX package's kernels bit for bit; tests/test_torch_kernels.py
holds them to it.  Torus values are int64 tensors (mod 2^64 wrap, logical
right shifts through ``limbs.srl``); shapes use B = batch, n = small LWE dim,
k = GLWE dim, N = poly size, l = decomposition levels.

The blind rotate is a Python loop over the n mask coefficients.  Each step
calls the two hand-written CUDA kernels of ``ops/`` on a CUDA accumulator
(their plain PyTorch versions on a CPU one):

- ``ops.step.rotate_decompose``: X^a * acc - acc, gadget digits, int8 limbs;
- ``ops.external_product.external_product_accumulate``: the digit limbs
  times one step of the banded BSK, shift-added into acc in place.

Keyswitch, modulus switch, LUT expansion and sample extract stay plain torch
ops, as they stay plain XLA in the JAX package.  Only the banded ``LimbBSK``
path (N <= 1024) exists; the fused CRT-NTT path is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import external_product as xp
from concrete_tpu_torch.ops import step
from concrete_tpu_torch.params import CryptoParams

_Q_LOG = 64
_M32 = 0xFFFFFFFF


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
    """refimpl.encode_expand_lut on a tensor of raw table entries (wrapped
    mod 2^(out_bits+1)): the (N,) accumulator polynomial of a lookup."""
    lut = table_vals.to(torch.int64) & ((1 << (out_bits + 1)) - 1)
    assert lut.shape[-1] == 1 << message_bits
    if signed:
        half = lut.shape[-1] // 2
        lut = torch.cat([lut[half:], lut[:half]])
    scaled = lut << (_Q_LOG - out_bits - 1)
    mega = poly_size // lut.shape[-1]
    naive = torch.repeat_interleave(scaled, mega)
    ext = torch.cat([naive, -naive])                    # negacyclic ext
    return torch.roll(ext, 2 * poly_size - mega // 2)[:poly_size]


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


@dataclasses.dataclass(frozen=True)
class LimbKSK:
    """Keyswitch key as int8 limb planes (n_in, l, n_out+1, 8)."""
    planes: torch.Tensor
    base_log: int
    levels: int


def pack_bsk(bsk_u64: np.ndarray, params: CryptoParams,
             truncate_limbs: int = 0, device="cpu") -> LimbBSK:
    """u64 BSK (n, l, k+1, k+1, N) -> banded limb planes (n, Cin, Cout, S,
    2N-1) with Cin = lev * (k+1) + r and the last axis the negacyclic
    extension [-(w[1:]), w] (u64 negation first, then the limb split).
    `truncate_limbs` drops that many low limb planes (S = 8 - t)."""
    bsk_u64 = np.asarray(bsk_u64)
    n, l, kp1, _, big_n = bsk_u64.shape
    ext = np.concatenate(
        [(np.uint64(0) - bsk_u64[..., 1:]), bsk_u64], axis=-1)
    limbs = np.moveaxis(lb.u64_to_balanced_i8(ext), -1, -2)
    limbs = limbs.reshape(n, l * kp1, kp1, 8, 2 * big_n - 1)
    limbs = np.ascontiguousarray(limbs[:, :, :, truncate_limbs:, :])
    return LimbBSK(planes=torch.from_numpy(limbs).to(device),
                   base_log=params.pbs_base_log, levels=params.pbs_level,
                   truncate_limbs=truncate_limbs)


def pack_ksk(ksk_u64: np.ndarray, params: CryptoParams,
             device="cpu") -> LimbKSK:
    """u64 KSK (n_in, l, n_out+1) -> int8 limb planes (n_in, l, n_out+1, 8)."""
    limbs = lb.u64_to_balanced_i8(np.asarray(ksk_u64))
    return LimbKSK(planes=torch.from_numpy(limbs).to(device),
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


def blind_rotate(ct_small: torch.Tensor, bsk: LimbBSK,
                 lut_poly: torch.Tensor,
                 params: CryptoParams) -> torch.Tensor:
    """Batched blind rotation, ``_blind_rotate_xla`` semantics:
    (B, n+1) ct, (N,) or (B, N) LUT -> accumulator (B, k+1, N).

    Per step i: acc += recombine(Decomp(X^{a_i} acc - acc) (.) BSK_i), the
    kept limb planes shifted by 8*(s + truncate_limbs).  The accumulator is
    one (B*(k+1), N) int64 tensor that kernel B updates in place.
    """
    if not isinstance(bsk, LimbBSK):
        raise NotImplementedError(
            "only the banded LimbBSK blind rotate is ported; the fused "
            "CRT-NTT path waits for ROADMAP queue 1 item 4")
    b_ct = ct_small.shape[0]
    n = params.polynomial_size
    k = params.glwe_dimension
    kp1 = k + 1
    switched = modulus_switch(ct_small, params.log2_polynomial_size)
    a_t, b_t = switched[:, :-1], switched[:, -1]
    body0 = monomial_mul_batch(_lut_rows(lut_poly, b_ct, n),
                               (2 * n - b_t) % (2 * n))
    acc = torch.zeros((b_ct, kp1, n), dtype=torch.int64,
                      device=ct_small.device)
    acc[:, k, :] = body0
    acc = acc.view(b_ct * kp1, n)
    # per-step rotation of every accumulator row: (n_small, B*(k+1))
    a_rows = a_t.t().repeat_interleave(kp1, dim=1).contiguous()
    a_limbs = lb.num_digit_limbs(params.pbs_base_log)
    keep = 8 - bsk.truncate_limbs
    for i in range(bsk.n_small):
        planes = step.rotate_decompose(
            acc, a_rows[i], base_log=params.pbs_base_log,
            levels=params.pbs_level, a_limbs=a_limbs)
        xp.external_product_accumulate(planes, bsk.planes[i], acc,
                                       keep=keep,
                                       limb_offset=bsk.truncate_limbs)
    return acc.view(b_ct, kp1, n)


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


def pbs_batch(ct_big: torch.Tensor, ksk: LimbKSK, bsk: LimbBSK,
              lut_poly: torch.Tensor, params: CryptoParams,
              message_bits: int, signed: bool = False) -> torch.Tensor:
    """Batched programmable bootstrap: (B, n_big+1) -> (B, n_big+1).

    KS -> modswitch -> BR -> sample extract, matching refimpl.pbs bit for
    bit, with the signed quarter-torus offset (FHEToTFHEScalar.cpp:395-411).
    """
    if signed:
        ct_big = ct_big.clone()
        ct_big[:, -1] += (1 << (message_bits - 1)) << (
            _Q_LOG - message_bits - 1)
    ct_small = keyswitch(ct_big, ksk)
    acc = blind_rotate(ct_small, bsk, lut_poly, params)
    return sample_extract(acc, 0)
