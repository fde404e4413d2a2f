"""Kernel B of the blind-rotate step: external product + recombine-accumulate.

Counterpart of ``concrete_tpu/ops/pallas_dot_recombine.py`` (``dot_recombine``
and ``dot_recombine_hi``) and of ``pallas_step.recombine_accumulate``; the
CUDA source is ``csrc/external_product.cu`` (its header says what bounds it
and how).  The kernel reads the banded BSK step directly and never builds
the Toeplitz rhs; the plain version does build it, for ``torch._int_mm``.

``external_product_accumulate`` launches the kernel on CUDA tensors and runs
``external_product_accumulate_plain`` on CPU ones; there is no other
fallback.  Both update ``acc`` in place and return it.
"""

from __future__ import annotations

import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import _build

NAME = "external_product_accumulate"


def _shape(planes: torch.Tensor, vv: torch.Tensor):
    """(batch, levels, a_limbs, kp1, n, s_planes) from the operands."""
    la, rows, n = planes.shape
    cin, kp1, s_planes, two_n_m1 = vv.shape
    levels = cin // kp1
    if (cin % kp1 or la % levels or rows % kp1 or two_n_m1 != 2 * n - 1):
        raise ValueError(f"{NAME}: planes {tuple(planes.shape)} do not "
                         f"match the BSK step {tuple(vv.shape)}")
    return rows // kp1, levels, la // levels, kp1, n, s_planes


def toeplitz_rhs(vv: torch.Tensor, a_limbs: int, keep: int) -> torch.Tensor:
    """The banded BSK step as one int8 matrix (A*Cin*N, Cout*keep*N):
    rhs[(a, cin, j), (cout, p, t)] = vv[cin, cout, p - a, N-1+t-j] where
    0 <= p - a < S, else 0 — the product's rows follow the digit planes,
    its columns the output planes."""
    cin, cout, s_planes, two_n_m1 = vv.shape
    n = (two_n_m1 + 1) // 2
    t = torch.arange(n, device=vv.device)
    band = vv[..., (n - 1) + t[None, :] - t[:, None]]   # (Cin,Cout,S,j,t)
    rhs = torch.zeros((a_limbs, cin, n, cout, keep, n), dtype=torch.int8,
                      device=vv.device)
    for a in range(a_limbs):
        for p in range(a, min(keep, a + s_planes)):
            rhs[a, :, :, :, p, :] = band[:, :, p - a].permute(0, 2, 1, 3)
    return rhs.reshape(a_limbs * cin * n, cout * keep * n)


def digit_lhs(planes: torch.Tensor, kp1: int, levels: int) -> torch.Tensor:
    """Kernel A's planes (l*A, B*(k+1), N) as the (B, A*Cin*N) int8 lhs,
    rows ordered (a, cin = lev*(k+1) + r, j)."""
    la, rows, n = planes.shape
    a_limbs, b_ct = la // levels, rows // kp1
    return (planes.view(levels, a_limbs, b_ct, kp1, n)
            .permute(2, 1, 0, 3, 4).reshape(b_ct, la * kp1 * n))


def external_product_accumulate_plain(planes: torch.Tensor, vv: torch.Tensor,
                                      acc: torch.Tensor, *, keep: int,
                                      limb_offset: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int8 GEMM against the
    materialised Toeplitz rhs, then the int64 shift-add."""
    b_ct, levels, a_limbs, kp1, n, _ = _shape(planes, vv)
    prod = lb.int8_matmul(digit_lhs(planes, kp1, levels),
                          toeplitz_rhs(vv, a_limbs, keep))
    add = lb.recombine_i32_planes_to_u64(prod.view(b_ct, kp1, keep, n),
                                         axis=-2, limb_offset=limb_offset)
    acc.view(b_ct, kp1, n).add_(add)
    return acc


def external_product_accumulate(planes: torch.Tensor, vv: torch.Tensor,
                                acc: torch.Tensor, *, keep: int,
                                limb_offset: int) -> torch.Tensor:
    """acc (B*(k+1), N) int64 += the external product of the digit limb
    planes (l*A, B*(k+1), N) int8 with one BSK step vv (Cin, Cout, S, 2N-1)
    int8, keeping product planes p < keep at shifts 8*(p + limb_offset)."""
    if planes.device.type == "cpu":
        return external_product_accumulate_plain(
            planes, vv, acc, keep=keep, limb_offset=limb_offset)
    if planes.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {planes.device}")
    b_ct, levels, a_limbs, kp1, n, s_planes = _shape(planes, vv)
    for name, t, dtype in (("planes", planes, torch.int8),
                           ("vv", vv, torch.int8), ("acc", acc, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != planes.device:
            raise ValueError(f"{NAME}: {name} must be contiguous {dtype} on "
                             f"{planes.device}")
    if acc.shape != (b_ct * kp1, n) or planes.data_ptr() % 4:
        raise ValueError(f"{NAME}: acc must be ({b_ct * kp1}, {n}) and "
                         "planes 4-byte aligned")
    if n % 4 or (n > 128 and n % 128) or not 1 <= keep <= 8 \
            or b_ct > 4 * 65535:
        raise ValueError(f"{NAME}: unsupported shape N={n}, keep={keep}, "
                         f"batch={b_ct}")
    lib = _build.library()
    _build.check(NAME, lib.external_product_accumulate(
        planes.data_ptr(), vv.data_ptr(), acc.data_ptr(), b_ct, levels,
        a_limbs, kp1, n, s_planes, keep, limb_offset,
        _build.stream_of(acc)))
    _build.LAUNCHES[NAME] += 1
    return acc
