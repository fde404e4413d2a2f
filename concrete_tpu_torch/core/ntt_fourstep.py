"""Four-step CRT-NTT external product: counterpart of ``concrete_tpu/core/ntt_tpu.py``.

The JAX package keeps this O(N sqrt(N)) form of the exact external
product only behind its limb-sharded layout (``parallel/limb_sharding.py``,
ported as ``concrete_tpu_torch/parallel/limb_sharding.py``): a negacyclic
transform of N = n1 n2 points runs as two small DFT stages, each an int8
limb-plane matmul, with a twiddle product between them, so the polynomial
axis can be split over devices between the stages.  The port's own CRT-NTT
blind rotate (``ops/fused_ntt.py``, radix-2 kernels) is a different
design with other primes; this module computes the JAX package's.

Per CRT prime p = 1 (mod 2N) just below 2^31 (``ntt_primes_near_pow2``):

  - the stage matrices are split host-side into int8 "limb-convolution"
    matrices (``_split_planes``); one int8 matmul of the centred residues'
    four balanced limbs against one gives all seven 2^(8s) product planes
    (``torch._int_mm``, int8 in, int32 out), which are recombined mod p;
  - residues between stages are int32 (p < 2^31), products int64, and every
    reduction ends in the canonical residue, so each result equals the JAX
    package's bit for bit whatever the order of its reductions;
  - the Garner/CRT recombination gives the exact centred value mod 2^64
    (int64 wraps as u64 does).

Every function takes a prime axis in front where the JAX package loops over
primes (``_Stack``): one matmul serves every prime (their stage matrices
side by side), so a step's launches do not grow with the prime count.
Tables live on an explicit device, cached per (N, p, device).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.ops import step
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Prime / plan construction (host side)
# ---------------------------------------------------------------------------

#: Shift-friendly NTT primes: p = 2^31 - (2^k - 1), so 2^31 = 2^k - 1
#: (mod p).  Tuples (p, k); the fallback when the near-2^31 search comes
#: up short, as in the JAX package.
SHIFT_PRIMES: tuple = (
    (2147352577, 17),
    (2146959361, 19),
    (2130706433, 24),
    (2113929217, 25),
)


@functools.lru_cache(maxsize=None)
def ntt_primes_near_pow2(n: int, min_total_bits: int,
                         max_hi_bits: int = 22) -> tuple[int, ...]:
    """NTT primes p = 1 (mod 2n) just below 2^31 with 2^31 mod p <
    2^max_hi_bits, product >= min_total_bits; falls back to SHIFT_PRIMES
    if the search fails (the JAX package's primes, in its order)."""
    out = []
    total = 0
    k = (1 << 31) // (2 * n)
    k_min = ((1 << 31) - (1 << max_hi_bits)) // (2 * n)
    while total < min_total_bits and k >= k_min:
        p = k * 2 * n + 1
        if p < (1 << 31) and host._is_prime(p):
            out.append(p)
            total += p.bit_length() - 1
        k -= 1
    if total < min_total_bits:
        out = []
        total = 0
        for p, _k in SHIFT_PRIMES:
            if (p - 1) % (2 * n) == 0:
                out.append(p)
                total += p.bit_length() - 1
                if total >= min_total_bits:
                    return tuple(out)
        raise ValueError(
            f"not enough near-2^31 NTT primes for N={n} "
            f"(need {min_total_bits} bits, found {len(out)} primes)")
    return tuple(out)


def _center(vals: np.ndarray, p: int) -> np.ndarray:
    v = np.asarray(vals, dtype=np.int64) % p
    return np.where(v > p // 2, v - p, v)


def _split_planes(mat: np.ndarray, p: int) -> np.ndarray:
    """(K, L) mod-p matrix -> (K*4, L*7) int8 limb-convolution matrix W
    with W[k*4+a, l*7+(a+b)] = limb_b(centered(mat[k, l])): one int8
    matmul X(M, K*4) @ W yields all seven 2^(8s) product planes."""
    c = torch.from_numpy(_center(mat, p).astype(np.int32))
    limbs = lb.i32_digits_to_balanced_i8(c, 4).numpy()   # (K, L, 4)
    k_dim, l_dim = mat.shape
    w = np.zeros((k_dim, 4, l_dim, 7), dtype=np.int8)
    for a in range(4):
        for b in range(4):
            w[:, a, :, a + b] = limbs[:, :, b]
    return np.ascontiguousarray(w.reshape(k_dim * 4, l_dim * 7))


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Per-(N, prime) four-step tables on one device.  The negacyclic psi
    and psi^-1/N twists are fused into the stage matrices and twiddles:

      fwd:  dft1[i1,k1] *= psi^(i1*n2);  tw_f[i2,k1] = psi^i2 * w^(i2*k1)
      inv:  tw_i[k1,i2] = w^(-i2*k1) * psi^-i2 / N;
            idft1[k1,i1] *= psi^(-i1*n2)
    """
    p: int
    n1: int
    n2: int
    hi31: int                 # 2^31 mod p
    dft1: torch.Tensor        # (n1*4, n1*7) int8 limb-conv [i1 -> k1]
    dft2: torch.Tensor        # (n2*4, n2*7) int8 [i2 -> k2]
    idft2: torch.Tensor       # (n2*4, n2*7) int8 [k2 -> i2]
    idft1: torch.Tensor       # (n1*4, n1*7) int8 [k1 -> i1]
    tw_f: torch.Tensor        # (n2, n1) int32 combined forward twiddle
    tw_i: torch.Tensor        # (n1, n2) int32 combined inverse twiddle
    pow8: torch.Tensor        # (7,) int64: 2^(8s) mod p

    @property
    def device(self) -> torch.device:
        return self.dft1.device


def build_plan(n: int, p: int, device=None) -> NttPlan:
    """The tables of N and p on `device` (the card by default), cached."""
    return _build_plan(n, p, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _build_plan(n: int, p: int, device: torch.device) -> NttPlan:
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    g = host._primitive_root(p)
    psi = pow(g, (p - 1) // (2 * n), p)
    assert pow(psi, n, p) == p - 1
    w = psi * psi % p
    wi = pow(w, -1, p)
    psi_i = pow(psi, -1, p)
    w1, w2 = pow(w, n2, p), pow(w, n1, p)       # n1-th, n2-th roots
    w1i, w2i = pow(w1, -1, p), pow(w2, -1, p)
    n_inv = pow(n, -1, p)

    def dft_mat(m, root, row_scale=None, col_scale=None):
        pows = np.array([pow(root, int(e), p) for e in range(m)],
                        dtype=np.int64)
        mat = pows[np.multiply.outer(np.arange(m), np.arange(m)) % m]
        if row_scale is not None:
            mat = mat * row_scale[:, None] % p
        if col_scale is not None:
            mat = mat * col_scale[None, :] % p
        return mat

    psi_i1n2 = np.array([pow(psi, i1 * n2, p) for i1 in range(n1)],
                        dtype=np.int64)
    ipsi_i1n2 = np.array([pow(psi_i, i1 * n2, p) for i1 in range(n1)],
                         dtype=np.int64)
    i2k1 = np.multiply.outer(np.arange(n2), np.arange(n1)) % n
    tw_f = np.array([[pow(w, int(e), p) * pow(psi, i2, p) % p
                      for e in row]
                     for i2, row in enumerate(i2k1)], dtype=np.int32)
    k1i2 = np.multiply.outer(np.arange(n1), np.arange(n2)) % n
    tw_i = np.array([[pow(wi, int(e), p)
                      * (pow(psi_i, i2, p) * n_inv % p) % p
                      for i2, e in enumerate(row)]
                     for row in k1i2], dtype=np.int32)
    pow8 = np.array([(1 << (8 * s)) % p for s in range(7)], dtype=np.int64)

    def on(a):
        return torch.from_numpy(a).to(device)
    return NttPlan(
        p=p, n1=n1, n2=n2, hi31=(1 << 31) % p,
        dft1=on(_split_planes(dft_mat(n1, w1, row_scale=psi_i1n2), p)),
        dft2=on(_split_planes(dft_mat(n2, w2), p)),
        idft2=on(_split_planes(dft_mat(n2, w2i), p)),
        idft1=on(_split_planes(dft_mat(n1, w1i, col_scale=ipsi_i1n2), p)),
        tw_f=on(tw_f), tw_i=on(tw_i), pow8=on(pow8))


@dataclasses.dataclass(frozen=True)
class _Stack:
    """The plans of several primes side by side: p (P,) and pow8 (P, 7)
    int64, twiddles (P, ...) int32, and each stage's limb-convolution
    matrices concatenated along their columns, (K*4, P*L*7) int8."""
    n1: int
    n2: int
    primes: tuple
    p: torch.Tensor
    pow8: torch.Tensor
    dft1: torch.Tensor
    dft2: torch.Tensor
    idft2: torch.Tensor
    idft1: torch.Tensor
    tw_f: torch.Tensor
    tw_i: torch.Tensor


@functools.lru_cache(maxsize=None)
def _stack(n: int, primes: tuple, device: torch.device) -> _Stack:
    plans = [_build_plan(n, p, device) for p in primes]

    def cat(name):
        return torch.cat([getattr(pl, name) for pl in plans], dim=1)
    return _Stack(
        n1=plans[0].n1, n2=plans[0].n2, primes=tuple(primes),
        p=torch.tensor(primes, dtype=torch.int64, device=device),
        pow8=torch.stack([pl.pow8 for pl in plans]),
        dft1=cat("dft1"), dft2=cat("dft2"), idft2=cat("idft2"),
        idft1=cat("idft1"),
        tw_f=torch.stack([pl.tw_f for pl in plans]),
        tw_i=torch.stack([pl.tw_i for pl in plans]))


def _stack_of(plan: NttPlan) -> _Stack:
    return _stack(plan.n1 * plan.n2, (plan.p,), plan.device)


# ---------------------------------------------------------------------------
# Elementwise mod-p arithmetic (int64; p broadcast over a prime axis)
# ---------------------------------------------------------------------------

def _col(p, ndim: int):
    """A prime, or primes (P,) as a (P, 1, ..., 1) column of `ndim` axes."""
    return p if isinstance(p, int) else p.view((-1,) + (1,) * (ndim - 1))


def _fold(c: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """c (int64, any sign) -> c mod p in [0, p): the canonical residue the
    JAX package's lazy fold ends in (its pass count, set by a bound on c,
    is that of a reduction the TPU does without a divide)."""
    return torch.remainder(c, plan.p)


def _mulmod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    return torch.remainder(a.to(torch.int64) * b.to(torch.int64),
                           _col(p, max(a.dim(), b.dim())))


def _mul_mod(a: torch.Tensor, b: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Residues in [0, p) -> a*b mod p as int64 (product < 2^62)."""
    return _mulmod(a, b, plan.p)


def _mul_mod32(a: torch.Tensor, b: torch.Tensor,
               plan: NttPlan) -> torch.Tensor:
    """Residues in [0, p) -> a*b mod p as int32."""
    return _mulmod(a, b, plan.p).to(torch.int32)


def _add_mod32(a: torch.Tensor, b: torch.Tensor,
               plan: NttPlan) -> torch.Tensor:
    """Residues in [0, p) -> (a + b) mod p as int32."""
    s = a.to(torch.int64) + b
    return torch.where(s >= plan.p, s - plan.p, s).to(torch.int32)


# ---------------------------------------------------------------------------
# Mod-p matmul on int8 limb planes
# ---------------------------------------------------------------------------

#: 128 in each of the three low bytes: added, it turns the balanced digits
#: of a value into the plain bytes of the sum
_LIMB_BIAS = 0x808080
_LIMB_SHIFTS: dict = {}


def _balanced_limbs(v: torch.Tensor) -> torch.Tensor:
    """int64 values |v| < 2^30 -> their four balanced base-256 limbs (three
    in [-128, 127], the top one the rest) on a new last axis, int8: the
    split of ``limbs.i32_digits_to_balanced_i8`` in a few tensor ops
    rather than a carry chain."""
    key = v.device
    if key not in _LIMB_SHIFTS:
        _LIMB_SHIFTS[key] = torch.tensor([0, 8, 16, 24], device=v.device)
    w = (v[..., None] + _LIMB_BIAS) >> _LIMB_SHIFTS[key]
    low = (w[..., :3] & 255) - 128
    return torch.cat([low, w[..., 3:]], dim=-1).to(torch.int8)


def _mm_mod(x: torch.Tensor, rhs: torch.Tensor, p: torch.Tensor,
            pow8: torch.Tensor) -> torch.Tensor:
    """x (P, ..., K) residues of each prime @ that prime's (K, L) matrix
    -> (P, ..., L) int32 residues.  rhs (K*4, P*L*7): the primes'
    ``_split_planes`` side by side.  One ``torch._int_mm`` multiplies every
    prime's limbs by every prime's matrix; the (prime, prime) diagonal
    blocks are the products."""
    shape = x.shape
    n_p, k_dim = shape[0], shape[-1]
    l_dim = rhs.shape[1] // (7 * n_p)
    pc = _col(p, 3)
    xc = x.reshape(n_p, -1, k_dim).to(torch.int64)
    xc = torch.where(xc > pc // 2, xc - pc, xc)           # centred
    m_dim = xc.shape[1]
    x8 = _balanced_limbs(xc).view(n_p * m_dim, k_dim * 4)
    planes = lb.int8_matmul(x8, rhs).view(n_p, m_dim, n_p, l_dim, 7)
    planes = torch.diagonal(planes, dim1=0, dim2=2).permute(3, 0, 1, 2)
    c = (planes.to(torch.int64) * pow8.view(n_p, 1, 1, 7)).sum(-1)
    return torch.remainder(c, pc).to(torch.int32).view(
        shape[:-1] + (l_dim,))


def _matmul_mod(x_res: torch.Tensor, rhs_planes: torch.Tensor,
                plan: NttPlan) -> torch.Tensor:
    """(..., K) residues in [0, p) @ (K, L) mod-p matrix -> (..., L) int32;
    rhs_planes: its (K*4, L*7) limb-convolution matrix (``_split_planes``)."""
    return _mm_mod(x_res[None], rhs_planes,
                   torch.tensor([plan.p], device=x_res.device),
                   plan.pow8[None])[0]


# ---------------------------------------------------------------------------
# Four-step negacyclic NTT
# ---------------------------------------------------------------------------

def _swap(y: torch.Tensor) -> torch.Tensor:
    """(P, R, a, b) -> (P, R, b, a): the layout change between the two
    stages on one device (limb_sharding's exchange in the sharded form)."""
    return y.transpose(-1, -2).contiguous()


def _fwd(x3: torch.Tensor, st: _Stack, tw_f: torch.Tensor,
         swap=_swap) -> torch.Tensor:
    """(P, R, n1, n2) residues [i1, i2] -> (P, R, n1, n2) int32 spectra
    [k1, k2].  Sharded, the leading n1 is this rank's block, tw_f its rows
    and `swap` the all-to-all exchange."""
    y = swap(x3)                                          # [i2, i1]
    y = _mm_mod(y, st.dft1, st.p, st.pow8)                # [i2, k1]
    y = _mulmod(y, tw_f[:, None], st.p).to(torch.int32)
    y = swap(y)                                           # [k1, i2]
    return _mm_mod(y, st.dft2, st.p, st.pow8)             # [k1, k2]


def _inv(z3: torch.Tensor, st: _Stack, tw_i: torch.Tensor,
         swap=_swap) -> torch.Tensor:
    """Inverse of ``_fwd``: (P, R, n1, n2) spectra -> coefficients."""
    z = _mm_mod(z3, st.idft2, st.p, st.pow8)              # [k1, i2]
    z = _mulmod(z, tw_i[:, None], st.p).to(torch.int32)
    z = swap(z)                                           # [i2, k1]
    z = _mm_mod(z, st.idft1, st.p, st.pow8)               # [i2, i1]
    return swap(z)                                        # [i1, i2]


def ntt_fwd(x_res: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """(..., N) residues in [0, p) -> (..., N) int32 spectrum (four-step
    layout: flat index k1*n2 + k2 holds natural frequency k2*n1 + k1)."""
    st = _stack_of(plan)
    y = _fwd(x_res.reshape(1, -1, plan.n1, plan.n2), st, st.tw_f)
    return y.reshape(x_res.shape)


def ntt_inv(x_freq: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse of ntt_fwd (the psi^-i / N scaling fused into its tables)."""
    st = _stack_of(plan)
    y = _inv(x_freq.reshape(1, -1, plan.n1, plan.n2), st, st.tw_i)
    return y.reshape(x_freq.shape)


# ---------------------------------------------------------------------------
# Garner / CRT recombination to u64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _garner_consts(primes: tuple):
    """Mixed-radix constants: inverses inv[p_i mod p_j] for i<j, the digits
    of (P-1)//2 (for sign centering) and P mod 2^64."""
    n = len(primes)
    inv = {}
    for j in range(1, n):
        for i in range(j):
            inv[(i, j)] = pow(primes[i], -1, primes[j])
    total = 1
    for p in primes:
        total *= p
    half = (total - 1) // 2
    h_digits = []
    rem = half
    for p in primes:
        h_digits.append(int(rem % p))
        rem //= p
    return inv, tuple(h_digits), total % (1 << 64)


def garner_to_u64(residues: list, primes: tuple) -> torch.Tensor:
    """Per-prime residues in [0, p_i) -> the exact centred value mod 2^64,
    as int64."""
    inv, h_digits, total64 = _garner_consts(tuple(primes))
    res = [r.to(torch.int64) for r in residues]
    digits = [res[0]]
    for j in range(1, len(primes)):
        t = res[j]
        for i in range(j):
            t = torch.remainder(t - digits[i], primes[j])
            t = torch.remainder(t * inv[(i, j)], primes[j])
        digits.append(t)
    v = digits[-1]                      # Horner; int64 wraps mod 2^64
    for j in range(len(primes) - 2, -1, -1):
        v = v * primes[j] + digits[j]
    gt = None                           # digits > those of (P-1)/2
    for j, h in enumerate(h_digits):
        gt_j = digits[j] > h
        gt = gt_j if gt is None else gt_j | ((digits[j] == h) & gt)
    total = total64 - (1 << 64) if total64 >= 1 << 63 else total64
    return v - total * gt.to(torch.int64)


# ---------------------------------------------------------------------------
# BSK pre-transform and the external product
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NttBSK:
    """Bootstrap key pre-transformed per CRT prime: spectra (primes, n,
    Cin, k+1, N) int32, the four-step-layout NTTs of the centred BSK
    polynomials mod each prime; Cin = lev*(k+1) + r."""
    spectra: torch.Tensor
    primes: tuple
    base_log: int
    levels: int

    @property
    def n_small(self) -> int:
        return self.spectra.shape[1]

    @property
    def device(self) -> torch.device:
        return self.spectra.device


def required_crt_bits(params: CryptoParams) -> int:
    """|coeff| of sum_cin digit (*) bsk <= Cin * N * 2^(base_log-1) * 2^63."""
    cin = params.pbs_level * (params.glwe_dimension + 1)
    return (64 + (params.pbs_base_log - 1)
            + (params.polynomial_size * cin).bit_length() + 2)


def choose_primes(params: CryptoParams) -> tuple[int, ...]:
    return ntt_primes_near_pow2(params.polynomial_size,
                                required_crt_bits(params))


#: polynomials a chunk of the key's transform, times N
_PACK_CHUNK = 1 << 22


def pack_bsk_ntt(bsk_u64: np.ndarray, params: CryptoParams,
                 primes: tuple = None, device=None) -> NttBSK:
    """Pre-transform a u64 BSK (n, l, k+1, k+1, N) per CRT prime: uploaded
    to `device` (the card by default) and transformed there by ``ntt_fwd``
    in chunks, prime by prime (the JAX package transforms on the host; the
    spectra are the same integers)."""
    device = resolve_device(device)
    if primes is None:
        primes = choose_primes(params)
    primes = tuple(int(p) for p in primes)
    x = torch.from_numpy(np.ascontiguousarray(
        bsk_u64, dtype=np.uint64).view(np.int64)).to(device)  # centred
    n_small, levels, kp1, _, n = x.shape
    flat = x.view(-1, n)
    out = torch.empty((len(primes), flat.shape[0], n), dtype=torch.int32,
                      device=device)
    chunk = max(1, _PACK_CHUNK // n)
    for pi, p in enumerate(primes):
        plan = _build_plan(n, p, device)
        for lo in range(0, flat.shape[0], chunk):
            out[pi, lo:lo + chunk] = ntt_fwd(
                torch.remainder(flat[lo:lo + chunk], p), plan)
    return NttBSK(spectra=out.view(len(primes), n_small, levels * kp1, kp1,
                                   n),
                  primes=primes, base_log=params.pbs_base_log,
                  levels=params.pbs_level)


def _contract(d_hat: torch.Tensor, spec: torch.Tensor,
              p: torch.Tensor) -> torch.Tensor:
    """Pointwise GGSW contraction: d_hat (P, B, Cin, ...) and spec (P, Cin,
    k+1, ...) spectra -> (P, B, k+1, ...) int32, sum_cin d_hat * spec mod p."""
    prod = _mulmod(d_hat[:, :, :, None], spec[:, None], p)
    return torch.remainder(prod.sum(2), _col(p, prod.dim() - 1)).to(
        torch.int32)


def _digit_residues(d3: torch.Tensor, st: _Stack) -> torch.Tensor:
    """(B, Cin, a, n2) int32 signed digits -> (P, B*Cin, a, n2) residues
    mod each prime."""
    b, cin, a, n2 = d3.shape
    return torch.remainder(d3[None].to(torch.int64), _col(st.p, 5)).view(
        len(st.primes), b * cin, a, n2)


def external_product_ntt(digits: torch.Tensor, bsk_step: torch.Tensor,
                         primes: tuple, params: CryptoParams) -> torch.Tensor:
    """One CMUX external product via CRT-NTT.

    digits: (B, Cin, N) int32 balanced gadget digits of the rotated diff;
    bsk_step: (primes, Cin, k+1, N) int32 spectra (one step's slice).
    Returns (B, k+1, N) int64, the exact product mod 2^64.
    """
    n = params.polynomial_size
    st = _stack(n, tuple(primes), digits.device)
    b, cin, _ = digits.shape
    n_p, kp1 = len(primes), bsk_step.shape[2]
    d_hat = _fwd(_digit_residues(digits.view(b, cin, st.n1, st.n2), st),
                 st, st.tw_f)
    prod = _contract(d_hat.view(n_p, b, cin, st.n1, st.n2),
                     bsk_step.reshape(n_p, cin, kp1, st.n1, st.n2), st.p)
    res = _inv(prod.view(n_p, -1, st.n1, st.n2), st, st.tw_i)
    return garner_to_u64(list(res.view(n_p, b, kp1, n)), primes)


def step_digits(rows: torch.Tensor, a_row: torch.Tensor, batch: int,
                params: CryptoParams) -> torch.Tensor:
    """A blind-rotate step's front on kernel 1 (``ops.step.
    rotate_decompose_digits``): rows (B*(k+1), N) int64 accumulator rows,
    a_row (B*(k+1),) int32 rotations -> (B, Cin, N) int32 gadget digits of
    X^a acc - acc, Cin = lev*(k+1) + c (the JAX package's order,
    ntt_tpu.py:497-499, from kernel 1's (l, rows, N))."""
    d = step.rotate_decompose_digits(rows, a_row,
                                     base_log=params.pbs_base_log,
                                     levels=params.pbs_level)
    levels, _, n = d.shape
    return d.view(levels, batch, -1, n).transpose(0, 1).reshape(batch, -1, n)


def step_rotations(a_t: torch.Tensor, kp1: int) -> torch.Tensor:
    """The switched mask (B, n) -> (n, B*(k+1)) int32: each step's rotation
    of every accumulator row (row b*(k+1) + c)."""
    return a_t.t().repeat_interleave(kp1, dim=1).to(torch.int32).contiguous()


def blind_rotate_ntt(ct_small: torch.Tensor, bsk: NttBSK,
                     lut_poly: torch.Tensor,
                     params: CryptoParams) -> torch.Tensor:
    """Batched blind rotation with the CRT-NTT external product: (B, n+1)
    int64 + (N,) LUT -> accumulator (B, k+1, N) int64, bit-identical to
    ``kernels.blind_rotate`` on the same key.  A step: kernel 1's digits,
    ``external_product_ntt``, the add."""
    a_t, acc = kn._switch_and_init(ct_small, lut_poly, params)
    b_ct, kp1, n = acc.shape
    rows = acc.view(b_ct * kp1, n)
    a_rows = step_rotations(a_t, kp1)
    for i in range(bsk.n_small):
        d = step_digits(rows, a_rows[i], b_ct, params)
        acc += external_product_ntt(d, bsk.spectra[:, i], bsk.primes, params)
    return acc
