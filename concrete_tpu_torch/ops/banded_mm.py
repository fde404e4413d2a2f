"""Kernel 9: the negacyclic banded int8 matmul of the external product.

Counterpart of ``concrete_tpu/ops/pallas_banded_mm.py``
``banded_matmul_fused``, with its layout: ``lhs`` is the JAX package's
``lhs_list`` stacked, (A, B, Cin*N) int8, ``vv`` the negacyclic extension
(Cin, Cout, S, 2N-1) int8, and the result (B, Cout, S+A-1, N) int32 with

    out[b, co, a+s, t] = sum_{ci, j} lhs[a, b, ci*N + j] * vv[ci, co, s, N-1+t-j]

The CUDA source is ``csrc/banded_mm.cu`` (its header says what bounds it and
how).  The plain version is the JAX package's
``negacyclic_banded_matmul_planes``: per J-block of 128 outputs, one int8
GEMM per digit limb against the stacked band tiles, added into the planes.

With ``levels`` given, ``lhs`` is instead kernel A's digit planes
(l*A, B*(k+1), N), Cin = l*(k+1): the banded blind rotate's step passes
them as they are, and the kernel reads row (lev, r) of ciphertext b from
plane lev*A + a, row b*(k+1) + r, where the JAX package concatenates.

``banded_matmul`` launches the kernel on CUDA tensors and runs
``banded_matmul_plain`` on CPU ones; there is no other fallback.
"""

from __future__ import annotations

import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import _build

NAME = "banded_matmul"
#: the kernel's tile of output coefficients; N must be a multiple of it
BLOCK = 128


def _shape(lhs: torch.Tensor, vv: torch.Tensor, levels: int | None):
    """(a_limbs, rows, cin, kp1, cout, s_planes, n) from the operands; kp1
    is Cin in the (A, B, Cin*N) layout."""
    if lhs.ndim != 3 or vv.ndim != 4:
        raise ValueError(f"{NAME}: lhs must be (A, B, Cin*N) or (l*A, "
                         f"B*(k+1), N) and vv (Cin, Cout, S, 2N-1), got "
                         f"{tuple(lhs.shape)} and {tuple(vv.shape)}")
    cin, cout, s_planes, two_n_m1 = vv.shape
    n = (two_n_m1 + 1) // 2
    if levels is None:
        a_limbs, rows, k_len = lhs.shape
        kp1, fits = cin, k_len == cin * n
    else:
        la, lhs_rows, lhs_n = lhs.shape
        kp1 = cin // levels
        fits = (levels > 0 and cin % levels == 0 and la % levels == 0
                and lhs_rows % kp1 == 0 and lhs_n == n)
        a_limbs, rows = la // levels, lhs_rows // kp1
    if not fits or two_n_m1 != 2 * n - 1 or 0 in lhs.shape or 0 in vv.shape:
        raise ValueError(f"{NAME}: lhs {tuple(lhs.shape)} does not match vv "
                         f"{tuple(vv.shape)} (levels={levels})")
    return a_limbs, rows, cin, kp1, cout, s_planes, n


def stacked_lhs(planes: torch.Tensor, kp1: int, levels: int) -> torch.Tensor:
    """Kernel A's planes (l*A, B*(k+1), N) in the JAX package's layout
    (A, B, Cin*N), Cin = lev*(k+1) + r: its per-limb concatenation over
    the levels (a copy)."""
    la, rows, n = planes.shape
    a_limbs = la // levels
    return (planes.view(levels, a_limbs, rows // kp1, kp1, n)
            .permute(1, 2, 0, 3, 4)
            .reshape(a_limbs, rows // kp1, levels * kp1 * n))


def banded_matmul_plain(lhs: torch.Tensor, vv: torch.Tensor, *,
                        levels: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's per-J-block formulation
    (``negacyclic_banded_matmul_planes``) with ``lb.int8_matmul``."""
    a_limbs, rows, cin, kp1, cout, s_planes, n = _shape(lhs, vv, levels)
    if levels is not None:
        lhs = stacked_lhs(lhs, kp1, levels)
    block = min(BLOCK, n)
    nb = n // block
    if n % block:
        raise ValueError(f"{NAME}: N={n} is not a multiple of {block}")
    planes = torch.zeros((rows, cout, s_planes + a_limbs - 1, nb, block),
                         dtype=torch.int32, device=lhs.device)
    i_blk = torch.arange(nb, device=lhs.device)[:, None, None]
    r = torch.arange(block, device=lhs.device)[None, :, None]
    t = torch.arange(block, device=lhs.device)[None, None, :]
    for j_blk in range(nb):
        # band tile (I -> J): T[r, t] = vv[.., N-1 + (J-I)*block + t - r]
        band = vv[..., (n - 1) + (j_blk - i_blk) * block + t - r]
        rhs = band.permute(0, 3, 4, 1, 2, 5).reshape(
            cin * n, cout * s_planes * block)        # rows (ci, I, r)
        for a in range(a_limbs):
            prod = lb.int8_matmul(lhs[a], rhs)
            planes[:, :, a:a + s_planes, j_blk] += prod.view(
                rows, cout, s_planes, block)
    return planes.view(rows, cout, s_planes + a_limbs - 1, n)


def banded_matmul(lhs: torch.Tensor, vv: torch.Tensor, *,
                  levels: int | None = None) -> torch.Tensor:
    """(A, B, Cin*N) int8 x (Cin, Cout, S, 2N-1) int8 -> (B, Cout, S+A-1,
    N) int32 negacyclic banded limb-product planes; with `levels`, lhs is
    kernel A's digit planes (l*A, B*(k+1), N)."""
    if lhs.device.type == "cpu":
        return banded_matmul_plain(lhs, vv, levels=levels)
    if lhs.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {lhs.device}")
    a_limbs, rows, cin, kp1, cout, s_planes, n = _shape(lhs, vv, levels)
    for name, t in (("lhs", lhs), ("vv", vv)):
        if t.dtype != torch.int8 or not t.is_contiguous() \
                or t.device != lhs.device:
            raise ValueError(f"{NAME}: {name} must be contiguous int8 on "
                             f"{lhs.device}")
    n_out = s_planes + a_limbs - 1
    if n % BLOCK or lhs.data_ptr() % 16 or cout * n_out > 65535 \
            or rows > 64 * 65535 or rows * kp1 * n >= 1 << 32:
        raise ValueError(f"{NAME}: unsupported shape N={n} (a multiple of "
                         f"{BLOCK} on the card), Cout x planes = "
                         f"{cout * n_out}, B={rows} (an lhs plane under 4 "
                         "GB), or lhs not 16-byte aligned")
    out = torch.empty((rows, cout, n_out, n), dtype=torch.int32,
                      device=lhs.device)
    _build.check(NAME, _build.library().banded_matmul(
        lhs.data_ptr(), vv.data_ptr(), out.data_ptr(), a_limbs, rows, cin,
        kp1, cout, s_planes, n, _build.stream_of(lhs)))
    _build.LAUNCHES[NAME] += 1
    return out
