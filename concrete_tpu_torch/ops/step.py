"""Kernel A of the blind-rotate step: rotate, subtract, decompose, limb-split.

Counterpart of ``concrete_tpu/ops/pallas_step.py`` ``rotate_decompose_limbs``
and ``rotate_decompose_limbs_hi``; the CUDA source is
``csrc/rotate_decompose.cu`` (its header says what bounds it and how).

``rotate_decompose`` launches the kernel on a CUDA accumulator and runs
``rotate_decompose_plain`` on a CPU one; there is no other fallback.
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
    _build.LAUNCHES[NAME] += 1
    return out
