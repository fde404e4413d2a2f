"""The PBS prologue at small batch in one launch: keyswitch, modulus switch
and the first accumulator, in the latency blind rotate's layout.

``core.kernels.pbs_batch`` takes this route for CUDA ciphertexts on a
banded key (``LimbBSK``) at B <= ``LATENCY_BATCH_MAX`` and ``MAX_BATCH``:
there the keyswitch is a memory-bound matrix-vector product
and its torch composition, about 140 small launches, kept the host busy
while the card waited for the blind rotate.  The CUDA source is
``csrc/pbs_prologue.cu`` (its header says what bounds it and how); it
replaces no TPU kernel.  Its plain version is that torch composition:
``core.kernels.keyswitch``, ``_switch_and_init``, then the accumulator
transposed to (k+1, B, N), bit for bit what the kernel writes.

``pbs_prologue`` launches the kernel on CUDA tensors and runs
``pbs_prologue_plain`` on CPU ones; there is no other fallback.  The kernel
sums across blocks into a per-stream u64 scratch, which its last block
leaves zeroed for the next launch.
"""

from __future__ import annotations

import threading

import torch

from concrete_tpu_torch.ops import _build

NAME = "pbs_prologue"
#: the kernel's largest batch (csrc/pbs_prologue.cu instantiates 1 to 4):
#: above it the keyswitch is a GEMM and keeps ``torch._int_mm``
MAX_BATCH = 4

#: (device index, stream) -> zeroed int64 scratch: [0] the ticket counter,
#: then MAX_BATCH x (n_out + 1) sums, grown to the widest key seen
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def body_offset(message_bits: int, signed: bool) -> int:
    """The signed quarter-torus offset added to the body before the
    keyswitch (FHEToTFHEScalar.cpp:395-411), 0 when unsigned."""
    if not signed:
        return 0
    return (1 << (message_bits - 1)) << (64 - message_bits - 1)


def pbs_prologue_plain(ct: torch.Tensor, ksk, lut_poly: torch.Tensor,
                       params, offset: int):
    """Plain PyTorch version: the torch composition of ``pbs_batch``."""
    from concrete_tpu_torch.core import kernels as kn
    if offset:
        ct = ct.clone()
        ct[:, -1] += offset
    a_t, acc = kn._switch_and_init(kn.keyswitch(ct, ksk), lut_poly, params)
    return a_t.contiguous(), acc.transpose(0, 1).contiguous()


def _scratch(device: torch.device, stream: int, words: int) -> torch.Tensor:
    with _SCRATCH_LOCK:
        buf = _SCRATCH.get((device.index, stream))
        if buf is None or buf.numel() < words:
            buf = _SCRATCH[(device.index, stream)] = torch.zeros(
                words, dtype=torch.int64, device=device)
    return buf


def pbs_prologue(ct: torch.Tensor, ksk, lut_poly: torch.Tensor, params,
                 offset: int):
    """ct (B, n_in+1) int64 big ciphertexts, ksk a ``LimbKSK`` (planes
    (n_in, l, n_out+1, 8) int8), lut_poly (N,) or (B, N) int64, `offset`
    added to each body first -> (a_t (B, n_out) int32, the switched mask;
    acc (k+1, B, N) int64, the trivial GLWE of X^{-b~} * LUT); on the card
    one launch."""
    if ct.device.type == "cpu":
        return pbs_prologue_plain(ct, ksk, lut_poly, params, offset)
    if ct.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {ct.device}")
    planes = ksk.planes
    n_in, levels, cols, limbs = planes.shape
    batch = ct.shape[0]
    n = params.polynomial_size
    kp1 = params.glwe_dimension + 1
    if not 1 <= batch <= MAX_BATCH or tuple(ct.shape) != (batch, n_in + 1) \
            or limbs != 8 or levels * ksk.base_log > 63 or cols < 2:
        raise ValueError(f"{NAME}: takes B in [1, {MAX_BATCH}] ciphertexts "
                         f"(B, n_in+1) and a key (n_in, l, n_out+1, 8) with "
                         f"l * base_log <= 63, got {tuple(ct.shape)} and "
                         f"{tuple(planes.shape)}, base 2^{ksk.base_log}")
    if lut_poly.shape not in ((n,), (batch, n)):
        raise ValueError(f"{NAME}: lut_poly must be ({n},) or ({batch}, "
                         f"{n}), got {tuple(lut_poly.shape)}")
    ct, lut_poly = ct.contiguous(), lut_poly.contiguous()
    for name, t, dtype in (("ct", ct, torch.int64), ("planes", planes,
                                                      torch.int8),
                           ("lut_poly", lut_poly, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != ct.device:
            raise ValueError(f"{NAME}: {name} must be contiguous {dtype} on "
                             f"{ct.device}")
    if planes.data_ptr() % 8:
        raise ValueError(f"{NAME}: planes must be 8-byte aligned")
    stream = _build.stream_of(ct)
    scratch = _scratch(ct.device, stream, 1 + MAX_BATCH * cols)
    a_t = torch.empty((batch, cols - 1), dtype=torch.int32, device=ct.device)
    acc = torch.empty((kp1, batch, n), dtype=torch.int64, device=ct.device)
    _build.check(NAME, _build.library().pbs_prologue(
        ct.data_ptr(), planes.data_ptr(), lut_poly.data_ptr(),
        n if lut_poly.ndim == 2 else 0, a_t.data_ptr(), acc.data_ptr(),
        scratch.data_ptr(), batch, n_in, levels, ksk.base_log, cols, kp1, n,
        params.log2_polynomial_size, offset, stream))
    _build.count(NAME)
    return a_t, acc
