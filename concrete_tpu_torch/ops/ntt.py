"""Kernel 2 of the CRT-NTT path: negacyclic NTT and inverse NTT per prime,
and the bootstrap-key pack.

Counterpart of ``concrete_tpu/ops/pallas_ntt.py`` ``ntt_fwd_pallas`` and
``ntt_inv_pallas``; the CUDA sources are ``csrc/ntt.cu`` (the forward, one
template with the standalone and the pack epilogue) and
``csrc/ntt_inverse.cu``, both on the register-resident transform schedule
of ``csrc/ntt_regs.cuh`` that kernel 3 shares.  The forward output is in
bit-reversed order (``core.ntt.bit_reverse`` maps it to natural
frequencies), the inverse takes that order back.

``ntt_forward`` / ``ntt_inverse`` / ``ntt_forward_pack`` launch the kernel
on CUDA tensors and run the ``_plain`` versions (the same butterflies in
int64 torch, exact since p < 2^31) on CPU ones; there is no other
fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.ops import _build

FORWARD, INVERSE, PACK = "ntt_forward", "ntt_inverse", "ntt_forward_pack"
_M32 = 0xFFFFFFFF
_CACHE: dict = {}


def _cached(kind: str, n: int, primes: tuple, device, make) -> torch.Tensor:
    key = (kind, n, tuple(primes), str(device))
    if key not in _CACHE:
        _CACHE[key] = torch.from_numpy(
            np.ascontiguousarray(make()).view(np.int32)).to(device)
    return _CACHE[key]


def pair_tables(n: int, primes: tuple, device) -> torch.Tensor:
    """The twiddles kernels 2 and 3 read: (P, 2, N, 2) int32 holding u32,
    [pr, 0, i] = (psi^bitrev(i), its Shoup companion) and [pr, 1, i] the
    same for psi^-bitrev(i) — the rows of ``core.ntt.twiddle_tables``
    paired, so one 8-byte load gives a butterfly both words; cached."""
    def make():
        tw = host.twiddle_tables(n, tuple(primes))        # (P, 4, N)
        return np.stack([tw[:, 0::2], tw[:, 1::2]], axis=-1)
    return _cached("pairs", n, primes, device, make)


def constants(n: int, primes: tuple, device) -> torch.Tensor:
    """Kernel 2's per-prime constants, (P, 8) int32 holding u32
    (``core.ntt.forward_constants``); cached."""
    return _cached("constants", n, primes, device,
                   lambda: host.forward_constants(n, tuple(primes)))


def prime_constants(n: int, primes: tuple, device) -> torch.Tensor:
    """Kernel 3's per-prime constants, (P, 3) int32 holding u32: p,
    N^-1 mod p and its companion (``core.ntt.prime_constants``); cached."""
    return _cached("prime", n, primes, device,
                   lambda: host.prime_constants(n, tuple(primes)))


def _twiddles(n: int, primes: tuple, device) -> torch.Tensor:
    return _cached("twiddles", n, primes, device,
                   lambda: host.twiddle_tables(n, tuple(primes))) \
        .to(torch.int64) & _M32


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & _M32


def ntt_forward_plain(x: torch.Tensor, primes: tuple) -> torch.Tensor:
    """Plain PyTorch version: (M, N) signed integers -> (P, M, N) int32
    canonical residues of their negacyclic spectra, bit-reversed order."""
    m_polys, n = x.shape
    tw = _twiddles(n, primes, x.device)
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
    tw = _twiddles(n, primes, spec.device)
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


def ntt_forward_pack_plain(x: torch.Tensor, primes: tuple, rows: int,
                           trunc_bits: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain PyTorch version of the key pack: the spectra of x >> t
    (arithmetic) moved into the FusedBSK layout (n_small, P * rows, N),
    and their Shoup companions floor(v * 2^32 / p) by integer division."""
    m_polys, n = x.shape
    spec = ntt_forward_plain(x >> trunc_bits, primes)   # (P, M, N)
    spec = spec.view(len(primes), m_polys // rows, rows, n).transpose(0, 1) \
        .reshape(m_polys // rows, len(primes) * rows, n)
    p_rows = torch.tensor(primes, dtype=torch.int64, device=x.device) \
        .repeat_interleave(rows).view(-1, 1)
    sh = ((_u32(spec) << 32) // p_rows).to(torch.int32)
    return spec, sh


def _check_n(name: str, n: int, low: int = 4) -> None:
    if n & (n - 1) or not low <= n <= host.MAX_POLY_SIZE:
        raise ValueError(f"{name}: N must be a power of two in {low}.."
                         f"{host.MAX_POLY_SIZE}, got {n}")


def _check_x(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype == torch.int32:
        x = x.to(torch.int64)
    if x.dtype != torch.int64 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (M, N) int64 "
                         "tensor")
    return x


def ntt_forward(x: torch.Tensor, primes: tuple) -> torch.Tensor:
    """(M, N) int64 (or int32) signed coefficients -> (P, M, N) int32
    canonical residues of the negacyclic spectrum mod each prime,
    bit-reversed order.  N a power of two in 4..16384."""
    if x.device.type == "cpu":
        return ntt_forward_plain(x, primes)
    x = _check_x(FORWARD, x)
    polys, n = x.shape
    _check_n(FORWARD, n)
    primes = tuple(primes)
    out = torch.empty((len(primes), polys, n), dtype=torch.int32,
                      device=x.device)
    if polys:
        _build.check(FORWARD, _build.library().ntt_forward(
            x.data_ptr(), out.data_ptr(),
            pair_tables(n, primes, x.device).data_ptr(),
            constants(n, primes, x.device).data_ptr(), polys, len(primes),
            n.bit_length() - 1, _build.stream_of(x)))
        _build.count(FORWARD)
    return out


def ntt_forward_pack(x: torch.Tensor, primes: tuple, rows: int,
                     trunc_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bootstrap key's polynomials x (n_small * rows, N) int64, the u64
    key as uploaded -> (spec_val, spec_sh), each (n_small, P * rows, N)
    int32 holding u32: the bit-reversed spectra of x >> trunc_bits
    (arithmetic) mod each prime, row pr * rows + r of each step, and
    their Shoup companions floor(v * 2^32 / p).  One launch on CUDA; N a
    power of two in 256..16384 (the BSK's sizes, 1024 up, and the WoP
    runtime GGSWs' at N = 256 and 512)."""
    if x.device.type == "cpu":
        return ntt_forward_pack_plain(x, primes, rows, trunc_bits)
    x = _check_x(PACK, x)
    polys, n = x.shape
    _check_n(PACK, n, host.RUNTIME_MIN_POLY_SIZE)
    if rows < 1 or polys % rows:
        raise ValueError(f"{PACK}: {polys} polynomials are not whole steps "
                         f"of {rows} rows")
    if not 0 <= trunc_bits < 64:
        raise ValueError(f"{PACK}: shift {trunc_bits} out of range")
    primes = tuple(primes)
    shape = (polys // rows, len(primes) * rows, n)
    val = torch.empty(shape, dtype=torch.int32, device=x.device)
    sh = torch.empty(shape, dtype=torch.int32, device=x.device)
    if polys:
        _build.check(PACK, _build.library().ntt_forward_pack(
            x.data_ptr(), val.data_ptr(), sh.data_ptr(),
            pair_tables(n, primes, x.device).data_ptr(),
            constants(n, primes, x.device).data_ptr(), polys, rows,
            len(primes), n.bit_length() - 1, trunc_bits,
            _build.stream_of(x)))
        _build.count(PACK)
    return val, sh


def ntt_inverse(spec: torch.Tensor, primes: tuple) -> torch.Tensor:
    """(P, M, N) int32 spectra (canonical residues, the forward's order)
    -> (P, M, N) int32 canonical coefficient residues."""
    if spec.device.type == "cpu":
        return ntt_inverse_plain(spec, primes)
    if spec.device.type != "cuda":
        raise ValueError(f"{INVERSE}: unsupported device {spec.device}")
    primes = tuple(primes)
    if (spec.dtype != torch.int32 or spec.ndim != 3
            or spec.shape[0] != len(primes) or not spec.is_contiguous()
            or spec.data_ptr() % 16):
        raise ValueError(f"{INVERSE}: spec must be a contiguous, 16-byte "
                         f"aligned ({len(primes)}, M, N) int32 tensor")
    polys, n = spec.shape[1:]
    _check_n(INVERSE, n)
    out = torch.empty_like(spec)
    if polys:
        _build.check(INVERSE, _build.library().ntt_inverse(
            spec.data_ptr(), out.data_ptr(),
            pair_tables(n, primes, spec.device).data_ptr(),
            constants(n, primes, spec.device).data_ptr(), polys,
            len(primes), n.bit_length() - 1, _build.stream_of(spec)))
        _build.count(INVERSE)
    return out
