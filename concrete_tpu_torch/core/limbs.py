"""Limb decompositions: u64 <-> balanced int8 planes, and recombination.

Counterpart of ``concrete_tpu/core/limbs.py``.  Every hot multiplication is
expressed over *balanced base-256 limbs*:

    x  =  sum_j  limb_j * 2^(8 j)   (mod 2^64),   limb_j in [-128, 127]

so products fit an int8 x int8 -> int32 datapath (``torch._int_mm``, or the
``dp4a`` of the port's external-product kernel) and the recombination
``sum_s P_s << 8s (mod 2^64)`` only needs planes s in [0, 8).

Torus values are carried as torch ``int64``: torch has no uint64 arithmetic,
and int64 addition, subtraction and multiplication wrap mod 2^64 exactly as
u64 does.  Only right shifts differ, so they go through ``srl`` (logical).
Key material is split on the host with numpy (``u64_to_balanced_i8``) or,
uploaded as u64, on its device (``split_u64_limbs``, bit for bit the same).
"""

from __future__ import annotations

import numpy as np
import torch

N_LIMBS_U64 = 8


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 torus values (u64 ``>>``)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def u64_to_balanced_i8(x: np.ndarray, num_limbs: int = N_LIMBS_U64):
    """Split numpy u64 values into `num_limbs` balanced base-256 limbs
    (int8), stacked on a new trailing axis: the host split, which the
    device's (``split_u64_limbs``) is held to."""
    v = np.asarray(x).astype(np.uint64)
    limbs = []
    for _ in range(num_limbs):
        d = (v & np.uint64(0xFF)).astype(np.int32)
        carry = (d >= 128).astype(np.uint64)
        d = d - (carry.astype(np.int32) << 8)
        v = (v >> np.uint64(8)) + carry
        limbs.append(d.astype(np.int8))
    return np.stack(limbs, axis=-1)


def split_u64_limbs(x: torch.Tensor, num_limbs: int = N_LIMBS_U64):
    """``u64_to_balanced_i8`` as int64 torch ops on x's device: u64 values
    (as int64) -> balanced base-256 int8 limbs on a new trailing axis, bit
    for bit the host split."""
    v = x
    limbs = []
    for _ in range(num_limbs):
        d = v & 0xFF
        carry = (d >= 128).to(torch.int64)
        limbs.append((d - (carry << 8)).to(torch.int8))
        v = srl(v, 8) + carry
    return torch.stack(limbs, dim=-1)


def i32_digits_to_balanced_i8(d: torch.Tensor, num_limbs: int):
    """Split signed int32 digits (|d| <= 2^(8*num_limbs - 1)) into balanced
    base-256 int8 limbs on a new trailing axis, exactly."""
    v = d.to(torch.int64)
    limbs = []
    for i in range(num_limbs):
        if i < num_limbs - 1:
            lo = v & 0xFF
            carry = (lo >= 128).to(torch.int64)
            lo = lo - (carry << 8)
            v = (v >> 8) + carry
        else:
            lo = v          # top limb takes the remainder
        limbs.append(lo.to(torch.int8))
    return torch.stack(limbs, dim=-1)


def num_digit_limbs(base_log: int) -> int:
    """Limbs needed for balanced gadget digits with |d| <= 2^(base_log-1)."""
    return -(-(base_log + 1) // 8)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly.

    ``torch._int_mm``: cuBLAS has no int32/int64 GEMM, and ``@`` on int8
    returns int8.  On CUDA it needs M > 16 and K, N multiples of 8, so the
    operands are zero-padded to that and the result cut back.
    """
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        pm, pk, pn = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        if (pm, pk) != (m, k):
            a = torch.nn.functional.pad(a, (0, pk - k, 0, pm - m))
        if (pk, pn) != (k, n):
            b = torch.nn.functional.pad(b, (0, pn - n, 0, pk - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def recombine_i32_planes_to_u64(planes: torch.Tensor, axis: int = -1,
                                limb_offset: int = 0) -> torch.Tensor:
    """sum_s planes[..., s] << (8 (s + limb_offset))  (mod 2^64), as int64.

    `planes` are int32 (sign-extended); the limb axis is `axis`.  Only planes
    with 8*(s + limb_offset) < 64 contribute mod 2^64.
    """
    planes = planes.movedim(axis, -1)
    num = min(planes.shape[-1], N_LIMBS_U64 - limb_offset)
    out = None
    for s in range(num):
        term = planes[..., s].to(torch.int64) << (8 * (s + limb_offset))
        out = term if out is None else out + term
    return out
