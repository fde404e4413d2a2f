"""The blind-rotate step's front: rotate, subtract, decompose.

Kernel A (``rotate_decompose``) splits the digits into int8 limbs for the
banded path: counterpart of ``concrete_tpu/ops/pallas_step.py``
``rotate_decompose_limbs`` and ``rotate_decompose_limbs_hi``.  Kernel 1 of
the CRT-NTT path (``rotate_decompose_digits``) writes the int32 digits
themselves: counterpart of ``rotate_decompose_digits`` and of the
``rotate_diff_digits(_hi)`` front of ``blind_rotate_fused``.  Both are in
``csrc/rotate_decompose.cu`` (its comments say what bounds them and how).

Each wrapper launches its kernel on a CUDA accumulator and runs its plain
version on a CPU one; there is no other fallback.
"""

from __future__ import annotations

import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import _build

NAME = "rotate_decompose"


def rotate_decompose_plain(acc: torch.Tensor, a_rows: torch.Tensor, *,
                           base_log: int, levels: int,
                           a_limbs: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same inputs, same output)."""
    from concrete_tpu_torch.core.kernels import decompose, monomial_mul_batch
    rows, n = acc.shape
    diff = monomial_mul_batch(acc, a_rows) - acc
    digits = decompose(diff, base_log, levels)              # (rows, N, l)
    limbs = lb.i32_digits_to_balanced_i8(digits, a_limbs)   # (rows, N, l, A)
    return limbs.permute(2, 3, 0, 1).reshape(levels * a_limbs, rows, n)


def rotate_decompose(acc: torch.Tensor, a_rows: torch.Tensor, *,
                     base_log: int, levels: int,
                     a_limbs: int) -> torch.Tensor:
    """acc (rows, N) int64 accumulator rows, a_rows (rows,) int32 rotations
    in [0, 2N) -> (levels * a_limbs, rows, N) int8 limb planes, plane index
    lev * a_limbs + limb (the order of the JAX package's tuple of planes)."""
    if acc.device.type == "cpu":
        return rotate_decompose_plain(acc, a_rows, base_log=base_log,
                                      levels=levels, a_limbs=a_limbs)
    if acc.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {acc.device}")
    rows, n = acc.shape
    if acc.dtype != torch.int64 or not acc.is_contiguous():
        raise ValueError(f"{NAME}: acc must be contiguous int64")
    if (a_rows.dtype != torch.int32 or a_rows.shape != (rows,)
            or a_rows.device != acc.device or not a_rows.is_contiguous()):
        raise ValueError(f"{NAME}: a_rows must be ({rows},) int32 on "
                         f"{acc.device}")
    if n % 4 or levels * base_log > 63:
        raise ValueError(f"{NAME}: needs N % 4 == 0 and levels*base_log "
                         f"<= 63 (N={n}, {levels}x{base_log})")
    out = torch.empty((levels * a_limbs, rows, n), dtype=torch.int8,
                      device=acc.device)
    lib = _build.library()
    _build.check(NAME, lib.rotate_decompose(
        acc.data_ptr(), a_rows.data_ptr(), out.data_ptr(), rows, n,
        base_log, levels, a_limbs, _build.stream_of(acc)))
    _build.count(NAME)
    return out


DIGITS = "rotate_decompose_digits"


def rotate_decompose_digits_plain(acc: torch.Tensor, a_rows: torch.Tensor, *,
                                  base_log: int,
                                  levels: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 1 (same inputs, same output)."""
    from concrete_tpu_torch.core.kernels import decompose, monomial_mul_batch
    v = acc
    if acc.dtype == torch.int32:     # acc32 top words: the u64 hi * 2^32
        v = (acc.to(torch.int64) & 0xFFFFFFFF) << 32
    digits = decompose(monomial_mul_batch(v, a_rows) - v, base_log, levels)
    return digits.permute(2, 0, 1).contiguous()          # (l, rows, N)


def rotate_decompose_digits(acc: torch.Tensor, a_rows: torch.Tensor, *,
                            base_log: int, levels: int) -> torch.Tensor:
    """acc (rows, N) int64 accumulator rows, or int32 top words in the
    acc32 mode (then levels * base_log <= 31), a_rows (rows,) int32
    rotations -> (levels, rows, N) int32 gadget digits of X^a acc - acc."""
    if acc.device.type == "cpu":
        return rotate_decompose_digits_plain(acc, a_rows, base_log=base_log,
                                             levels=levels)
    if acc.device.type != "cuda":
        raise ValueError(f"{DIGITS}: unsupported device {acc.device}")
    rows, n = acc.shape
    acc32 = acc.dtype == torch.int32
    if acc.dtype not in (torch.int64, torch.int32) or not acc.is_contiguous():
        raise ValueError(f"{DIGITS}: acc must be contiguous int64 or int32")
    if (a_rows.dtype != torch.int32 or a_rows.shape != (rows,)
            or a_rows.device != acc.device or not a_rows.is_contiguous()):
        raise ValueError(f"{DIGITS}: a_rows must be ({rows},) int32 on "
                         f"{acc.device}")
    if n % 4 or levels * base_log > (31 if acc32 else 63):
        raise ValueError(f"{DIGITS}: needs N % 4 == 0 and levels*base_log "
                         f"<= {31 if acc32 else 63} (N={n}, "
                         f"{levels}x{base_log})")
    out = torch.empty((levels, rows, n), dtype=torch.int32,
                      device=acc.device)
    _build.check(DIGITS, _build.library().rotate_decompose_digits(
        acc.data_ptr(), int(acc32), a_rows.data_ptr(), out.data_ptr(), rows,
        n, base_log, levels, _build.stream_of(acc)))
    _build.count(DIGITS)
    return out
