"""Kernel 9: the negacyclic banded int8 matmul of the external product.

Counterpart of ``concrete_tpu/ops/pallas_banded_mm.py``
``banded_matmul_fused``, with its layout: ``lhs`` is the JAX package's
``lhs_list`` stacked, (A, B, Cin*N) int8, ``vv`` the negacyclic extension
(Cin, Cout, S, 2N-1) int8, and the result (B, Cout, S+A-1, N) int32 with

    out[b, co, a+s, t] = sum_{ci, j} lhs[a, b, ci*N + j] * vv[ci, co, s, N-1+t-j]

The plain version is the JAX package's ``negacyclic_banded_matmul_planes``:
per J-block of 128 outputs, one int8 GEMM per digit limb against the
stacked band tiles, added into the planes.

With ``levels`` given, ``lhs`` is instead kernel A's digit planes
(l*A, B*(k+1), N), Cin = l*(k+1): the banded blind rotate's step passes
them as they are, and the kernel reads row (lev, r) of ciphertext b from
plane lev*A + a, row b*(k+1) + r, where the JAX package concatenates.

Two CUDA forms (their source headers say what bounds them and how):
``csrc/banded_mm.cu``, the table form, kernel B's ``wgmma`` main loop
(``csrc/banded_wgmma.cuh``) with a plane-store epilogue, for more than
``LATENCY_ROWS`` lhs rows; and ``csrc/banded_mm_latency.cu``, the latency
form, for at most that many: the lhs rows and limbs on the MMA's n side,
K split across a thread-block cluster.  ``banded_matmul_latency`` is the
latency blind rotate's step product: it reads kernel 1's int32 digits and
the BSK step in place and builds the band (ext_d, the limb split) in the
kernel; its plain version is the step's glue and ``banded_matmul_plain``.

The wrappers launch a kernel on CUDA tensors and run the plain version on
CPU ones; there is no other fallback.
"""

from __future__ import annotations

import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import _build

NAME = "banded_matmul"
LATENCY = "banded_matmul_latency"
#: the plain version's tile of output coefficients (a multiple of it, or N)
BLOCK = 128
#: lhs rows up to which the card runs the latency form
LATENCY_ROWS = 8
#: N must be a multiple of these on the card: the table form's j tile and
#: the latency form's t tile
TABLE_TILE, LATENCY_TILE = 256, 64


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


def _check_cuda(name: str, tensors, device) -> None:
    for tname, t, dtype in tensors:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: {tname} must be contiguous {dtype} on "
                             f"{device}")


def _launch_latency(out: torch.Tensor, lhs: torch.Tensor, offset: int,
                    strides: tuple, kp1: int, digits, vv, *, a_limbs: int,
                    rows: int, cin: int, batch: int, s_planes: int,
                    n: int) -> torch.Tensor:
    """The latency form: lhs[a, r, ci, j] at byte `offset` + strides
    (a, r, ci // kp1, ci % kp1) of `lhs`'s storage, the band from int32
    `digits` (Cin, B, N) or int8 `vv` (Cin, B, S, 2N-1)."""
    if n % LATENCY_TILE or batch > 65535:
        raise ValueError(f"{LATENCY}: unsupported shape N={n} (a multiple "
                         f"of {LATENCY_TILE} on the card), B={batch}")
    base = lhs.data_ptr()
    _build.check(LATENCY, _build.library().banded_matmul_latency(
        base + offset, base + lhs.numel(), *strides,
        digits.data_ptr() if digits is not None else None,
        vv.data_ptr() if vv is not None else None, out.data_ptr(), a_limbs,
        rows, cin, kp1, batch, s_planes, n, _build.stream_of(out)))
    _build.count(LATENCY)
    return out


def banded_matmul(lhs: torch.Tensor, vv: torch.Tensor, *,
                  levels: int | None = None) -> torch.Tensor:
    """(A, B, Cin*N) int8 x (Cin, Cout, S, 2N-1) int8 -> (B, Cout, S+A-1,
    N) int32 negacyclic banded limb-product planes; with `levels`, lhs is
    kernel A's digit planes (l*A, B*(k+1), N).  On the card, B <=
    LATENCY_ROWS runs the latency form with vv as the band, larger B the
    table form."""
    if lhs.device.type == "cpu":
        return banded_matmul_plain(lhs, vv, levels=levels)
    if lhs.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {lhs.device}")
    a_limbs, rows, cin, kp1, cout, s_planes, n = _shape(lhs, vv, levels)
    _check_cuda(NAME, (("lhs", lhs, torch.int8), ("vv", vv, torch.int8)),
                lhs.device)
    n_out = s_planes + a_limbs - 1
    out = torch.empty((rows, cout, n_out, n), dtype=torch.int32,
                      device=lhs.device)
    if rows <= LATENCY_ROWS:
        plane = lhs.shape[1] * lhs.shape[2]          # one lhs plane's bytes
        # (a, r, lev, r_in) strides: the stacked layout is one level of
        # Cin rows; kernel A's planes put level lev A planes further on
        strides = (plane, cin * n, 0, n) if levels is None else \
            (plane, kp1 * n, a_limbs * plane, n)
        return _launch_latency(out, lhs, 0, strides, kp1, None, vv,
                               a_limbs=a_limbs, rows=rows, cin=cin,
                               batch=cout, s_planes=s_planes, n=n)
    # the table form stages the lhs 256 j at a time in 16-byte pieces, 128
    # rows a block, and its shared memory holds 4 tiles and the key windows
    # of as many planes as fit: 1 at N=32768
    if n % TABLE_TILE or n > 32768 or lhs.data_ptr() % 16 \
            or cout * n_out > 65535 or rows > 128 * 65535:
        raise ValueError(f"{NAME}: unsupported shape N={n} (a multiple of "
                         f"{TABLE_TILE} up to 32768 on the card), Cout x "
                         f"planes = {cout * n_out}, B={rows}, or lhs not "
                         "16-byte aligned")
    _build.check(NAME, _build.library().banded_matmul(
        lhs.data_ptr(), vv.data_ptr(), out.data_ptr(), a_limbs, rows, cin,
        kp1, cout, s_planes, n, _build.stream_of(lhs)))
    _build.count(NAME)
    return out


def _latency_shape(digits: torch.Tensor, w_vv: torch.Tensor, kp1: int,
                   levels: int):
    """(batch, cin, s_key, n) of the latency step's operands."""
    cin = levels * kp1
    if digits.ndim != 3 or w_vv.ndim != 4:
        raise ValueError(f"{LATENCY}: digits must be (l, (k+1)*B, N) and "
                         f"w_vv (Cin, k+1, S, 2N-1), got "
                         f"{tuple(digits.shape)} and {tuple(w_vv.shape)}")
    lev, rows, n = digits.shape
    if (lev != levels or rows % kp1 or rows == 0
            or tuple(w_vv.shape[:2]) != (cin, kp1)
            or w_vv.shape[3] != 2 * n - 1 or w_vv.shape[2] == 0):
        raise ValueError(f"{LATENCY}: digits {tuple(digits.shape)} do not "
                         f"match w_vv {tuple(w_vv.shape)} (l={levels}, "
                         f"k+1={kp1})")
    return rows // kp1, cin, w_vv.shape[2], n


def banded_matmul_latency_plain(digits: torch.Tensor, w_vv: torch.Tensor, *,
                                kp1: int, levels: int,
                                base_log: int) -> torch.Tensor:
    """Plain PyTorch version: the latency step's glue (the JAX package's
    ``_blind_rotate_xla_latency``) and ``banded_matmul_plain``."""
    b_ct, cin, _, n = _latency_shape(digits, w_vv, kp1, levels)
    a_limbs = lb.num_digit_limbs(base_log)
    d = (digits.view(levels, kp1, b_ct, n).permute(2, 0, 1, 3)
         .reshape(b_ct, cin, n))                     # Cin = lev*(k+1) + r
    ext_d = torch.cat([-d[..., 1:], d], dim=-1)      # (B, Cin, 2N-1)
    vv_d = lb.i32_digits_to_balanced_i8(ext_d, a_limbs) \
        .permute(1, 0, 3, 2).contiguous()            # (Cin, B, A, 2N-1)
    w_raw = w_vv[..., n - 1:]                        # (Cin, k+1, S, N)
    lhs = w_raw.permute(2, 1, 0, 3).reshape(-1, kp1, cin * n) \
        .contiguous()                                # (S, k+1, Cin*N)
    return banded_matmul_plain(lhs, vv_d)            # (k+1, B, S+A-1, N)


def banded_matmul_latency(digits: torch.Tensor, w_vv: torch.Tensor, *,
                          kp1: int, levels: int,
                          base_log: int) -> torch.Tensor:
    """The latency blind rotate's step product: kernel 1's digits (l,
    (k+1)*B, N) int32 (rows ordered (lev, r, b)) and one BSK step w_vv
    (Cin, k+1, S, 2N-1) int8 -> (k+1, B, S+A-1, N) int32 planes, A =
    num_digit_limbs(base_log), with the band ext_d = [-d[1:], d] split into
    A limbs after the negation and the lhs the raw rows w_vv[..., N-1:]."""
    if digits.device.type == "cpu":
        return banded_matmul_latency_plain(digits, w_vv, kp1=kp1,
                                           levels=levels, base_log=base_log)
    if digits.device.type != "cuda":
        raise ValueError(f"{LATENCY}: unsupported device {digits.device}")
    b_ct, cin, s_key, n = _latency_shape(digits, w_vv, kp1, levels)
    _check_cuda(LATENCY, (("digits", digits, torch.int32),
                          ("w_vv", w_vv, torch.int8)), digits.device)
    if digits.data_ptr() % 16:
        raise ValueError(f"{LATENCY}: digits must be 16-byte aligned")
    d_limbs = lb.num_digit_limbs(base_log)
    out = torch.empty((kp1, b_ct, s_key + d_limbs - 1, n), dtype=torch.int32,
                      device=digits.device)
    vlen = 2 * n - 1
    # lhs[a, r, ci, j] = w_vv[ci, r, a, N-1 + j], ci one level of Cin rows
    return _launch_latency(out, w_vv, n - 1,
                           (vlen, s_key * vlen, 0, kp1 * s_key * vlen), cin,
                           digits, None, a_limbs=s_key, rows=kp1, cin=cin,
                           batch=b_ct, s_planes=d_limbs, n=n)
