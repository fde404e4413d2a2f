"""Kernel 2 of the CRT-NTT path: negacyclic NTT and inverse NTT per prime.

Counterpart of ``concrete_tpu/ops/pallas_ntt.py`` ``ntt_fwd_pallas`` and
``ntt_inv_pallas``; the CUDA source is ``csrc/ntt.cu`` with the transform
itself in ``csrc/ntt.cuh`` (shared with the external-product kernel).
The forward output is in bit-reversed order (``core.ntt.bit_reverse``
maps it to natural frequencies), the inverse takes that order back.

``ntt_forward`` / ``ntt_inverse`` launch the kernel on CUDA tensors and run
the ``_plain`` versions (the same butterflies in int64 torch, exact since
p < 2^31) on CPU ones; there is no other fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.ops import _build

FORWARD, INVERSE = "ntt_forward", "ntt_inverse"
_TABLES: dict = {}


def tables(n: int, primes: tuple, device) -> tuple:
    """(twiddles (P, 4, N), constants (P, 3)) as int32 tensors holding the
    u32 tables of ``core.ntt`` on `device`, cached."""
    key = (n, tuple(primes), str(device))
    if key not in _TABLES:
        tw = host.twiddle_tables(n, tuple(primes))
        cst = host.prime_constants(n, tuple(primes))
        _TABLES[key] = (torch.from_numpy(tw.view(np.int32)).to(device),
                        torch.from_numpy(cst.view(np.int32)).to(device))
    return _TABLES[key]


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def ntt_forward_plain(x: torch.Tensor, primes: tuple) -> torch.Tensor:
    """Plain PyTorch version: (M, N) signed integers -> (P, M, N) int32
    canonical residues of their negacyclic spectra, bit-reversed order."""
    m_polys, n = x.shape
    tw = _u32(tables(n, primes, x.device)[0])
    outs = []
    for pi, p in enumerate(primes):
        a = torch.remainder(x.to(torch.int64), p)
        w = tw[pi, 0]
        m, t = 1, n
        while m < n:
            t //= 2
            a = a.view(m_polys, m, 2, t)
            u, v = a[:, :, 0], a[:, :, 1] * w[m:2 * m, None] % p
            a = torch.stack([(u + v) % p, (u - v) % p], dim=2)
            m *= 2
        outs.append(a.reshape(m_polys, n))
    return torch.stack(outs).to(torch.int32)


def ntt_inverse_plain(spec: torch.Tensor, primes: tuple) -> torch.Tensor:
    """Plain PyTorch version: (P, M, N) spectra in the forward's order ->
    (P, M, N) int32 canonical coefficient residues, natural order."""
    n_p, m_polys, n = spec.shape
    tw = _u32(tables(n, primes, spec.device)[0])
    cst = host.prime_constants(n, tuple(primes))
    outs = []
    for pi, p in enumerate(primes):
        a = _u32(spec[pi])
        w = tw[pi, 2]
        h, t = n // 2, 1
        while h >= 1:
            a = a.view(m_polys, h, 2, t)
            u, v = a[:, :, 0], a[:, :, 1]
            a = torch.stack([(u + v) % p, (u - v) % p * w[h:2 * h, None] % p],
                            dim=2)
            h, t = h // 2, t * 2
        outs.append(a.reshape(m_polys, n) * int(cst[pi, 1]) % p)
    return torch.stack(outs).to(torch.int32)


def _launch(name: str, src: torch.Tensor, out: torch.Tensor, primes: tuple,
            polys: int) -> torch.Tensor:
    n = out.shape[-1]
    if n & (n - 1) or not 4 <= n <= host.MAX_POLY_SIZE:
        raise ValueError(f"{name}: N must be a power of two in 4.."
                         f"{host.MAX_POLY_SIZE}, got {n}")
    tw, cst = tables(n, primes, src.device)
    _build.check(name, getattr(_build.library(), name)(
        src.data_ptr(), out.data_ptr(), tw.data_ptr(), cst.data_ptr(),
        polys, len(primes), n.bit_length() - 1, _build.stream_of(src)))
    _build.LAUNCHES[name] += 1
    return out


def ntt_forward(x: torch.Tensor, primes: tuple) -> torch.Tensor:
    """(M, N) int64 (or int32) signed coefficients -> (P, M, N) int32
    canonical residues of the negacyclic spectrum mod each prime,
    bit-reversed order.  N a power of two up to 16384."""
    if x.device.type == "cpu":
        return ntt_forward_plain(x, primes)
    if x.device.type != "cuda":
        raise ValueError(f"{FORWARD}: unsupported device {x.device}")
    if x.dtype == torch.int32:
        x = x.to(torch.int64)
    if x.dtype != torch.int64 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{FORWARD}: x must be a contiguous (M, N) int64 "
                         "tensor")
    out = torch.empty((len(primes),) + tuple(x.shape), dtype=torch.int32,
                      device=x.device)
    return _launch(FORWARD, x, out, tuple(primes), x.shape[0])


def ntt_inverse(spec: torch.Tensor, primes: tuple) -> torch.Tensor:
    """(P, M, N) int32 spectra (canonical residues, the forward's order)
    -> (P, M, N) int32 canonical coefficient residues."""
    if spec.device.type == "cpu":
        return ntt_inverse_plain(spec, primes)
    if spec.device.type != "cuda":
        raise ValueError(f"{INVERSE}: unsupported device {spec.device}")
    if (spec.dtype != torch.int32 or spec.ndim != 3
            or spec.shape[0] != len(primes) or not spec.is_contiguous()):
        raise ValueError(f"{INVERSE}: spec must be a contiguous "
                         f"({len(primes)}, M, N) int32 tensor")
    return _launch(INVERSE, spec, torch.empty_like(spec), tuple(primes),
                   spec.shape[1])
