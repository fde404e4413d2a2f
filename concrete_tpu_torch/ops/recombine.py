"""Recombine-accumulate: int32 limb-product planes shift-added into acc.

Counterpart of ``concrete_tpu/ops/pallas_step.py`` ``recombine_accumulate``
(the step's epilogue in the JAX package's "pallas", "fuseddot" and "planes"
banded modes); the CUDA source is ``csrc/recombine_accumulate.cu`` (its
header says what bounds it and how).  Kernel B
(``ops/external_product.py``) does the same shift-add inside its own
epilogue; this one stands alone, after a separate product.

``recombine_accumulate`` launches the kernel on CUDA tensors and runs
``recombine_accumulate_plain`` on CPU ones; there is no other fallback.
Both update ``acc`` in place and return it.
"""

from __future__ import annotations

import torch

from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.ops import _build

NAME = "recombine_accumulate"


def _check_offset(limb_offset: int) -> None:
    if not 0 <= limb_offset < lb.N_LIMBS_U64:
        raise ValueError(f"{NAME}: limb_offset {limb_offset} outside [0, 8)")


def recombine_accumulate_plain(planes: torch.Tensor, acc: torch.Tensor, *,
                               limb_offset: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the int64 shift-add."""
    _check_offset(limb_offset)
    acc.add_(lb.recombine_i32_planes_to_u64(planes, axis=-2,
                                            limb_offset=limb_offset))
    return acc


def recombine_accumulate(planes: torch.Tensor, acc: torch.Tensor, *,
                         limb_offset: int) -> torch.Tensor:
    """acc (rows, N) int64 += sum_p planes[:, p] << 8*(p + limb_offset)
    (mod 2^64) for planes (rows, P, N) int32.  Planes whose shift reaches
    64 bits add nothing, so P may exceed the 8 - limb_offset kept."""
    if planes.device.type == "cpu":
        return recombine_accumulate_plain(planes, acc,
                                          limb_offset=limb_offset)
    if planes.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {planes.device}")
    _check_offset(limb_offset)
    if planes.ndim != 3 or planes.shape[1] < 1:
        raise ValueError(f"{NAME}: planes must be (rows, P >= 1, N), got "
                         f"{tuple(planes.shape)}")
    rows, n_planes, n = planes.shape
    for name, t, dtype in (("planes", planes, torch.int32),
                           ("acc", acc, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != planes.device:
            raise ValueError(f"{NAME}: {name} must be contiguous {dtype} on "
                             f"{planes.device}")
    if acc.shape != (rows, n) or rows * n >= 2 ** 31:
        raise ValueError(f"{NAME}: acc must be ({rows}, {n}) with fewer "
                         f"than 2^31 elements, got {tuple(acc.shape)}")
    _build.check(NAME, _build.library().recombine_accumulate(
        planes.data_ptr(), acc.data_ptr(), rows, n_planes, n, limb_offset,
        _build.stream_of(acc)))
    _build.count(NAME)
    return acc
