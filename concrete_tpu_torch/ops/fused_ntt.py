"""The CRT-NTT blind rotate (N >= 1024): bootstrap-key packing and the scan.

Counterpart of ``concrete_tpu/ops/pallas_fused_ntt.py`` (``FusedBSK``,
``pack_bsk_fused``, ``blind_rotate_fused``, ``acc32_eligible``).  The TPU
runs the whole scan in one ``pallas_call``.  Here ``blind_rotate_fused``
is the one entry, and ``blind_rotate_form`` its rule, by shape alone: a
blind rotate of at most ``core.kernels.LATENCY_BATCH_MAX`` ciphertexts
runs the scan in one launch of ``ops.fused_latency``'s kernel (one cluster
of P (k+1) blocks a ciphertext, for latency) at the shapes its plan takes
(the models' B = 1 lookups); any other, in one launch of
``ops.crt_scan``'s kernel (one block of P thread groups a ciphertext, for
a batch's throughput) at the shapes its plan takes (k+1 = 2, N = 2048,
P <= 3: the key-value query's batches); the rest as a host
loop of three hand-written CUDA kernels per step (``scan_steps``), whose
plain versions are also the plain version of both one-launch forms
(``scan_plain``):

1. ``ops.step.rotate_decompose_digits`` (``csrc/rotate_decompose.cu``):
   X^a acc - acc and its int32 gadget digits;
2. ``crt_external_product`` (``csrc/crt_external_product.cu``): per prime,
   the digits' forward NTTs, the multiply-accumulate with the step's BSK
   spectra and the inverse NTTs, as residues of the exact product; each
   thread carries 16 residues through up to 4 butterfly stages in
   registers between exchanges (``ops.ntt.pair_tables`` gives the
   twiddles as the kernel reads them); any k+1 >= 2, the output
   components split into groups whose accumulators fit a block
   (``kernel_groups``);
3. ``garner_accumulate`` (``csrc/garner_accumulate.cu``): explicit CRT,
   the truncation shift, and the update of the accumulator in place.

``pack_bsk_fused`` transforms every BSK polynomial on the device with one
launch of kernel 2's pack entry, ``ops.ntt.ntt_forward_pack``
(``csrc/ntt.cu``), which writes the spectra and their Shoup companions
straight into the ``FusedBSK`` layout.

Results are bit-identical to the JAX package: in full mode to
``refimpl.blind_rotate`` on ``truncate_bsk_u64(bsk, t)``, in the acc32 mode
(the accumulator kept as its top u32 words, default wherever the digits
read only the top word) to ``blind_rotate_acc32_oracle``.  Each wrapper
launches its kernel on CUDA tensors and runs its plain PyTorch version on
CPU ones; there is no other fallback.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch

from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.ops import _build
from concrete_tpu_torch.ops import ntt as tn
from concrete_tpu_torch.ops import step
from concrete_tpu_torch.utils import telemetry as tm
from concrete_tpu_torch.utils.device import resolve_device

XP, GARNER = "crt_external_product", "garner_accumulate"
_M32 = 0xFFFFFFFF
_GARNER_CONSTANTS: dict = {}
XP_SMEM_BYTES = 227 * 1024      # shared memory per block, H100 (opt-in)


@dataclasses.dataclass(frozen=True)
class FusedBSK:
    """BSK spectra per CRT prime: spec_val, spec_sh (n, P * Cin * (k+1), N)
    int32 holding u32 — the canonical NTT residues of the centred,
    t-bit-truncated, down-shifted BSK polynomials in the forward
    transform's bit-reversed order, and their Shoup companions
    floor(v * 2^32 / p); row (pr * Cin + ci) * (k+1) + co, the JAX
    package's row order."""
    spec_val: torch.Tensor
    spec_sh: torch.Tensor
    primes: tuple
    trunc_bits: int
    base_log: int
    levels: int

    @property
    def n_small(self) -> int:
        return self.spec_val.shape[0]

    @property
    def device(self) -> torch.device:
        return self.spec_val.device


def pack_bsk_fused(bsk_u64: np.ndarray, params, message_bits: int = None,
                   norm2: float = 1, primes: tuple = None,
                   trunc_bits: int = None, device=None) -> FusedBSK:
    """u64 BSK (n, l, k+1, k+1, N) -> FusedBSK on `device`, CUDA by
    default (``utils.device.resolve_device``).  The truncation is part of
    the key (the oracle is refimpl on truncate_bsk_u64(bsk, t)); the
    transforms run where the key goes; a key for the card is refused here
    at a shape kernel 3 cannot run (``kernel_groups``)."""
    device = resolve_device(device)
    if primes is None or trunc_bits is None:
        primes, trunc_bits = host.choose_fused_primes(params, message_bits,
                                                      norm2)
    primes = tuple(int(p) for p in primes)
    host.check_poly_size(params.polynomial_size)
    bsk_u64 = np.ascontiguousarray(bsk_u64, dtype=np.uint64)
    n_small, levels, kp1, _, n = bsk_u64.shape
    if device.type == "cuda":
        kernel_groups(n, kp1)
    raw = torch.from_numpy(bsk_u64.view(np.int64)).to(device).view(-1, n)
    spec, sh = tn.ntt_forward_pack(raw, primes, levels * kp1 * kp1,
                                   trunc_bits)
    return FusedBSK(spec_val=spec, spec_sh=sh, primes=primes,
                    trunc_bits=int(trunc_bits),
                    base_log=params.pbs_base_log, levels=params.pbs_level)


#: accumulators kernel 3 keeps in registers; the rest of a block's live in
#: shared memory beside its two exchange buffers
XP_REGISTER_ACCS = 2


def kernel_groups(n: int, kp1: int,
                  smem_bytes: int = XP_SMEM_BYTES) -> tuple[int, int]:
    """Kernel 3's plan at N, k+1: (groups, co_group), the k+1 output
    components split into `groups` blocks' worth of at most `co_group`
    each.  A block holds the accumulators of its group only (two in
    registers, the rest in shared memory beside two N-word exchange
    buffers, (2 + co_group - 2) N 4 bytes within `smem_bytes`) and
    recomputes the digits' forward transforms.  Every k+1 that fits one
    block keeps one group, today's kernel (k+1 <= 3 at N=16384, <= 7 at
    N=8192); beyond, as few groups as fit, as even as can be (k+1 = 4 at
    N=16384: 2 of 2; k+1 = 8 at N=8192: 2 of 4; the last group may be
    smaller).  Refuses k+1 < 2."""
    per = XP_REGISTER_ACCS + smem_bytes // (4 * n) - 2
    if kp1 < 2 or per < 1:
        raise ValueError(
            f"{XP}: k+1={kp1} at N={n} does not run: kernel 3 needs k+1 >= "
            f"2 and two N-word exchange buffers within {smem_bytes} bytes "
            f"of shared memory")
    groups = -(-kp1 // per)
    return groups, -(-kp1 // groups)


#: bits between the acc32 mode's perturbation bound and the smallest
#: message scale it may serve (the JAX package's docstring claim)
ACC32_MARGIN_BITS = 13


def acc32_min_scale_log(n_small: int) -> int:
    """The smallest output scale log2 the acc32 mode may serve: its
    perturbation is bounded by (n_small + 2) 2^32 a coefficient, and the
    scale must sit ``ACC32_MARGIN_BITS`` above that (55 at n_small=822)."""
    return math.ceil(math.log2((n_small + 2) * 2.0 ** 32)) \
        + ACC32_MARGIN_BITS


def acc32_eligible(bsk: FusedBSK, min_scale_log: int = None) -> bool:
    """The acc32 mode is the default wherever the digits read only the
    top word (``blind_rotate_fused``'s ``acc32=`` overrides it), the JAX
    package's rule.  A caller that knows the smallest message scale of its
    rows (the WoP sign PBS, ``core/kernels_wop.sign_pbs_batch``) passes it
    as `min_scale_log`, and the mode is then also held to
    ``acc32_min_scale_log``: the JAX package's claim that its perturbation
    sits 2^13 below every message scale fails at a deep circuit-bootstrap
    level (PIR 32's 2^49 against a 2^41.7 bound)."""
    if not host.digits_lo_free(bsk.base_log, bsk.levels):
        return False
    return min_scale_log is None \
        or min_scale_log >= acc32_min_scale_log(bsk.n_small)


# ---------------------------------------------------------------------------
# Kernel 3: the external product per prime
# ---------------------------------------------------------------------------

def crt_external_product_plain(digits: torch.Tensor, spec: torch.Tensor,
                               spec_sh: torch.Tensor, primes: tuple,
                               kp1: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 3 (the Shoup companions are not
    needed for int64 arithmetic)."""
    levels, rows, n = digits.shape
    b_ct, cin, n_p = rows // kp1, levels * kp1, len(primes)
    d = digits.view(levels, b_ct, kp1, n).transpose(0, 1) \
        .reshape(b_ct * cin, n)                     # row b * Cin + ci
    dhat = tn.ntt_forward_plain(d, primes).view(n_p, b_ct, cin, 1, n)
    key = (spec.to(torch.int64) & _M32).view(n_p, 1, cin, kp1, n)
    prods = []
    for pi, p in enumerate(primes):
        prod = dhat[pi].to(torch.int64) * key[pi] % p   # (B, Cin, k+1, N)
        prods.append((prod.sum(dim=1) % p).view(rows, n))
    return tn.ntt_inverse_plain(torch.stack(prods).to(torch.int32), primes)


def crt_external_product(digits: torch.Tensor, spec: torch.Tensor,
                         spec_sh: torch.Tensor, primes: tuple,
                         kp1: int) -> torch.Tensor:
    """digits (l, B*(k+1), N) int32, one step's spectra spec/spec_sh
    (P * l(k+1) * (k+1), N) int32 -> (P, B*(k+1), N) int32 canonical
    residues of the exact external product."""
    if digits.device.type == "cpu":
        return crt_external_product_plain(digits, spec, spec_sh, primes, kp1)
    if digits.device.type != "cuda":
        raise ValueError(f"{XP}: unsupported device {digits.device}")
    levels, rows, n = digits.shape
    n_p = len(primes)
    host.check_poly_size(n)
    if rows % kp1:
        raise ValueError(f"{XP}: {rows} rows are not a multiple of "
                         f"k+1={kp1}")
    _, co_group = kernel_groups(n, kp1)
    for name, t in (("digits", digits), ("spec", spec),
                    ("spec_sh", spec_sh)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != digits.device:
            raise ValueError(f"{XP}: {name} must be contiguous int32 on "
                             f"{digits.device}")
    if spec.shape != (n_p * levels * kp1 * kp1, n) \
            or spec_sh.shape != spec.shape:
        raise ValueError(f"{XP}: spectra {tuple(spec.shape)} do not match "
                         f"{n_p} primes, {levels} levels, k+1={kp1}, N={n}")
    tw = tn.pair_tables(n, primes, digits.device)
    cst = tn.prime_constants(n, primes, digits.device)
    out = torch.empty((n_p, rows, n), dtype=torch.int32, device=digits.device)
    _build.check(XP, _build.library().crt_external_product(
        digits.data_ptr(), spec.data_ptr(), spec_sh.data_ptr(),
        out.data_ptr(), tw.data_ptr(), cst.data_ptr(), rows // kp1, levels,
        kp1, n_p, n.bit_length() - 1, co_group, _build.stream_of(digits)))
    _build.count(XP)
    return out


XPK = "crt_external_product_keyed"


def crt_external_product_keyed_plain(digits: torch.Tensor,
                                     spec: torch.Tensor,
                                     spec_sh: torch.Tensor,
                                     key_index: torch.Tensor, primes: tuple,
                                     kp1: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 3's runtime-key entry: ciphertext b
    reads the stack's key ``key_index[b]`` (the Shoup companions are not
    needed for int64 arithmetic)."""
    levels, rows, n = digits.shape
    b_ct, cin, n_p = rows // kp1, levels * kp1, len(primes)
    d = digits.view(levels, b_ct, kp1, n).transpose(0, 1) \
        .reshape(b_ct * cin, n)                     # row b * Cin + ci
    dhat = tn.ntt_forward_plain(d, primes).view(n_p, b_ct, cin, 1, n)
    keys = spec.view(spec.shape[0], n_p, cin, kp1, n)[key_index.long()]
    prods = []
    for pi, p in enumerate(primes):
        key = keys[:, pi].to(torch.int64) & _M32        # (B, Cin, k+1, N)
        prod = dhat[pi].to(torch.int64) * key % p
        prods.append((prod.sum(dim=1) % p).view(rows, n))
    return tn.ntt_inverse_plain(torch.stack(prods).to(torch.int32), primes)


def crt_external_product_keyed(digits: torch.Tensor, spec: torch.Tensor,
                               spec_sh: torch.Tensor,
                               key_index: torch.Tensor, primes: tuple,
                               kp1: int) -> torch.Tensor:
    """digits (l, B*(k+1), N) int32, a stack of keys spec/spec_sh (n_keys,
    P * l(k+1) * (k+1), N) int32 (kernel 2's pack layout), key_index (B,)
    int32 -> (P, B*(k+1), N) int32 canonical residues of each ciphertext's
    exact external product with its own key (``csrc/
    crt_external_product_keyed.cu``, N a power of two in 256..16384)."""
    if digits.device.type == "cpu":
        return crt_external_product_keyed_plain(digits, spec, spec_sh,
                                                key_index, primes, kp1)
    if digits.device.type != "cuda":
        raise ValueError(f"{XPK}: unsupported device {digits.device}")
    levels, rows, n = digits.shape
    n_p = len(primes)
    if n & (n - 1) or not host.RUNTIME_MIN_POLY_SIZE <= n \
            <= host.MAX_POLY_SIZE:
        raise ValueError(f"{XPK}: N must be a power of two in "
                         f"{host.RUNTIME_MIN_POLY_SIZE}..{host.MAX_POLY_SIZE}"
                         f", got {n}")
    if rows % kp1:
        raise ValueError(f"{XPK}: {rows} rows are not a multiple of "
                         f"k+1={kp1}")
    _, co_group = kernel_groups(n, kp1)
    for name, t in (("digits", digits), ("spec", spec),
                    ("spec_sh", spec_sh), ("key_index", key_index)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != digits.device:
            raise ValueError(f"{XPK}: {name} must be contiguous int32 on "
                             f"{digits.device}")
    if spec.ndim != 3 or spec.shape[1:] != (n_p * levels * kp1 * kp1, n) \
            or spec_sh.shape != spec.shape:
        raise ValueError(f"{XPK}: spectra {tuple(spec.shape)} are not a "
                         f"stack of {n_p} primes, {levels} levels, "
                         f"k+1={kp1}, N={n}")
    if key_index.shape != (rows // kp1,):
        raise ValueError(f"{XPK}: key_index must be ({rows // kp1},)")
    tw = tn.pair_tables(n, primes, digits.device)
    cst = tn.prime_constants(n, primes, digits.device)
    out = torch.empty((n_p, rows, n), dtype=torch.int32, device=digits.device)
    _build.check(XPK, _build.library().crt_external_product_keyed(
        digits.data_ptr(), spec.data_ptr(), spec_sh.data_ptr(),
        out.data_ptr(), tw.data_ptr(), cst.data_ptr(), key_index.data_ptr(),
        rows // kp1, levels, kp1, n_p, n.bit_length() - 1, co_group,
        _build.stream_of(digits)))
    _build.count(XPK)
    return out


# ---------------------------------------------------------------------------
# Kernel 4: explicit CRT + accumulate
# ---------------------------------------------------------------------------

def _s64(v: int) -> int:
    """u64 value as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def garner_constants(primes: tuple, trunc_bits: int, device) -> torch.Tensor:
    """Kernel 4's constant array (the layout csrc/garner_accumulate.cu
    reads), int64 on `device`, cached."""
    key = (tuple(primes), trunc_bits, str(device))
    if key not in _GARNER_CONSTANTS:
        g = host.garner_constants(tuple(primes))
        vals = []
        for i, p in enumerate(primes):
            inv_p = struct.unpack("<q", struct.pack("<d", 1.0 / p))[0]
            vals += [p, g.inv[i], g.inv_sh[i], g.hinv[i], _s64(g.m64[i]),
                     inv_p]
        vals += [_s64(g.p64), _s64(g.h64), host.h_top(primes, trunc_bits)]
        _GARNER_CONSTANTS[key] = torch.tensor(vals, dtype=torch.int64,
                                              device=device)
    return _GARNER_CONSTANTS[key]


def garner_accumulate_plain(res: torch.Tensor, acc: torch.Tensor,
                            primes: tuple, trunc_bits: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 4: the same explicit CRT in int64
    (wrapping mod 2^64) and float64."""
    g = host.garner_constants(tuple(primes))
    w = torch.zeros(res.shape[1:], dtype=torch.int64, device=res.device)
    frac = torch.zeros(res.shape[1:], dtype=torch.float64, device=res.device)
    for i, p in enumerate(primes):
        r = res[i].to(torch.int64) & _M32
        c = (r * g.inv[i] % p + g.hinv[i]) % p
        w += c * _s64(g.m64[i])
        frac += c.to(torch.float64) * (1.0 / p)
    w -= frac.floor().to(torch.int64) * _s64(g.p64)
    if acc.dtype == torch.int32:
        top = ((w << trunc_bits) >> 32) & _M32          # logical top word
        add = top - host.h_top(primes, trunc_bits)
        acc.copy_(((acc.to(torch.int64) + add) & _M32).to(torch.int32))
    else:
        acc.add_((w - _s64(g.h64)) << trunc_bits)
    return acc


def garner_accumulate(res: torch.Tensor, acc: torch.Tensor, primes: tuple,
                      trunc_bits: int) -> torch.Tensor:
    """acc (rows, N) += the exact external product z << trunc_bits (mod
    2^64) from its residues res (P, rows, N) int32; for an int32 acc (the
    acc32 mode) += top32((z + H) << t) - top32(H << t).  In place."""
    if res.device.type == "cpu":
        return garner_accumulate_plain(res, acc, primes, trunc_bits)
    if res.device.type != "cuda":
        raise ValueError(f"{GARNER}: unsupported device {res.device}")
    n_p = len(primes)
    if (res.dtype != torch.int32 or not res.is_contiguous()
            or res.shape != (n_p,) + tuple(acc.shape)):
        raise ValueError(f"{GARNER}: res must be contiguous ({n_p}, "
                         f"{tuple(acc.shape)}) int32")
    if acc.dtype not in (torch.int64, torch.int32) or not acc.is_contiguous() \
            or acc.device != res.device:
        raise ValueError(f"{GARNER}: acc must be contiguous int64 or int32 "
                         f"on {res.device}")
    if not 0 <= trunc_bits < 64:
        raise ValueError(f"{GARNER}: shift {trunc_bits} out of range")
    cst = garner_constants(tuple(primes), trunc_bits, res.device)
    _build.check(GARNER, _build.library().garner_accumulate(
        res.data_ptr(), acc.data_ptr(), cst.data_ptr(), n_p, acc.numel(),
        trunc_bits, int(acc.dtype == torch.int32), _build.stream_of(res)))
    _build.count(GARNER)
    return acc


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

def first_accumulator(ct_small: torch.Tensor, bsk: FusedBSK,
                      lut_poly: torch.Tensor, params,
                      acc32: bool = None) -> tuple:
    """The scan's start: (a_t, acc), the switched mask (B, n) int32 and
    the first accumulator (B, k+1, N), the trivial GLWE of X^{-b~} LUT, as
    int32 top words in the acc32 mode (the default wherever the digits
    read only the top word) or int64."""
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import limbs as lb
    n = params.polynomial_size
    host.check_poly_size(n)
    if acc32 is None:
        acc32 = acc32_eligible(bsk)
    if acc32 and not host.digits_lo_free(bsk.base_log, bsk.levels):
        raise ValueError("the acc32 mode needs levels * base_log <= 31")
    b_ct = ct_small.shape[0]
    k = params.glwe_dimension
    switched = kn.modulus_switch(ct_small, params.log2_polynomial_size)
    a_t, b_t = switched[:, :-1], switched[:, -1]
    rot = (2 * n - b_t) % (2 * n)
    lut = kn._lut_rows(lut_poly, b_ct, n)
    if acc32:
        # the LUT is cut to its top word BEFORE the b rotation, as the
        # JAX kernel does (exact for encode_expand_lut outputs)
        body0 = (kn.monomial_mul_batch(lb.srl(lut, 32), rot) & _M32) \
            .to(torch.int32)
    else:
        body0 = kn.monomial_mul_batch(lut, rot)
    acc = torch.zeros((b_ct, k + 1, n), dtype=body0.dtype,
                      device=ct_small.device)
    acc[:, k, :] = body0
    return a_t.to(torch.int32).contiguous(), acc


def last_accumulator(acc: torch.Tensor) -> torch.Tensor:
    """The scan's result (B, k+1, N) int64 from its accumulator: top
    words (int32, the acc32 mode) back in place, or acc itself."""
    if acc.dtype == torch.int32:
        return (acc.to(torch.int64) & _M32) << 32
    return acc


def scan_steps(a_t: torch.Tensor, acc: torch.Tensor, bsk: FusedBSK,
               kernels: tuple = None) -> torch.Tensor:
    """The scan's steps on a_t (B, n_small) int32 and acc (B, k+1, N)
    (int32 top words or int64), in place: a step calls the three functions
    of `kernels` (digits, product, Garner), by default kernels 1, 3 and 4's
    wrappers, three launches a step."""
    digits_of, product, garner = kernels or (
        step.rotate_decompose_digits, crt_external_product,
        garner_accumulate)
    b_ct, kp1, n = acc.shape
    rows = acc.view(b_ct * kp1, n)
    a_rows = a_t.t().repeat_interleave(kp1, dim=1).contiguous()
    for i in range(bsk.n_small):
        digits = digits_of(rows, a_rows[i], base_log=bsk.base_log,
                           levels=bsk.levels)
        res = product(digits, bsk.spec_val[i], bsk.spec_sh[i], bsk.primes,
                      kp1)
        garner(res, rows, bsk.primes, bsk.trunc_bits)
    return acc


# ---------------------------------------------------------------------------
# The scan in one launch: what its two forms share
# ---------------------------------------------------------------------------

def scan_shape(name: str, a_t: torch.Tensor, acc: torch.Tensor,
               spec_val: torch.Tensor, spec_sh: torch.Tensor,
               n_primes: int, levels: int) -> tuple:
    """(batch, n_small, k+1, N) of a one-launch scan's operands; raises
    where they do not match."""
    if a_t.ndim != 2 or acc.ndim != 3 or spec_val.ndim != 3:
        raise ValueError(f"{name}: a_t must be (B, n_small), acc (B, k+1, "
                         f"N) and the spectra (n_small, P Cin (k+1), N), "
                         f"got {tuple(a_t.shape)}, {tuple(acc.shape)} and "
                         f"{tuple(spec_val.shape)}")
    batch, kp1, n = acc.shape
    n_small = a_t.shape[1]
    if (a_t.shape[0] != batch or n_small == 0
            or tuple(spec_val.shape) != (n_small, n_primes * levels * kp1
                                         * kp1, n)
            or spec_sh.shape != spec_val.shape):
        raise ValueError(f"{name}: a_t {tuple(a_t.shape)}, acc "
                         f"{tuple(acc.shape)} and the spectra "
                         f"{tuple(spec_val.shape)} do not match (P="
                         f"{n_primes}, l={levels})")
    return batch, n_small, kp1, n


def scan_plain(name: str, a_t: torch.Tensor, acc: torch.Tensor,
               spec_val: torch.Tensor, spec_sh: torch.Tensor, *,
               primes: tuple, trunc_bits: int, base_log: int,
               levels: int) -> torch.Tensor:
    """The plain version of both one-launch forms (``ops.fused_latency``,
    ``ops.crt_scan``): the three-kernel scan on the plain versions of
    kernels 1, 3 and 4; returns the last accumulator (B, k+1, N), `acc`
    left as it was."""
    scan_shape(name, a_t, acc, spec_val, spec_sh, len(primes), levels)
    bsk = FusedBSK(spec_val=spec_val, spec_sh=spec_sh, primes=primes,
                   trunc_bits=trunc_bits, base_log=base_log, levels=levels)
    return scan_steps(a_t, acc.clone(), bsk, (
        step.rotate_decompose_digits_plain, crt_external_product_plain,
        garner_accumulate_plain))


def launch_scan(name: str, plan, a_t: torch.Tensor, acc: torch.Tensor,
                spec_val: torch.Tensor, spec_sh: torch.Tensor, *,
                primes: tuple, trunc_bits: int, base_log: int,
                levels: int) -> torch.Tensor:
    """One launch of the library entry `name` (both one-launch forms take
    the same C arguments) on CUDA operands, the accumulator updated in
    place; raises at a shape its `plan` (batch, N, k+1, l, P, acc32)
    refuses and on operands the kernel does not take."""
    if acc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {acc.device}")
    primes = tuple(int(p) for p in primes)
    batch, n_small, kp1, n = scan_shape(name, a_t, acc, spec_val, spec_sh,
                                        len(primes), levels)
    acc32 = acc.dtype == torch.int32
    if plan(batch, n, kp1, levels, len(primes), acc32) is None:
        raise ValueError(f"{name}: the kernel does not take B={batch}, "
                         f"N={n}, k+1={kp1}, l={levels}, {len(primes)} "
                         f"primes, {'acc32' if acc32 else 'full'} mode")
    if base_log < 1 or levels * base_log > (31 if acc32 else 63):
        raise ValueError(f"{name}: levels*base_log must be <= "
                         f"{31 if acc32 else 63} (got {levels}x{base_log})")
    if not 0 <= trunc_bits < 64:
        raise ValueError(f"{name}: shift {trunc_bits} out of range")
    for what, t, dtypes in (("a_t", a_t, (torch.int32,)),
                            ("acc", acc, (torch.int32, torch.int64)),
                            ("spec_val", spec_val, (torch.int32,)),
                            ("spec_sh", spec_sh, (torch.int32,))):
        if t.dtype not in dtypes or not t.is_contiguous() \
                or t.device != acc.device:
            raise ValueError(f"{name}: {what} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on "
                             f"{acc.device}")
    if spec_val.data_ptr() % 16 or spec_sh.data_ptr() % 16:
        raise ValueError(f"{name}: the spectra must be 16-byte aligned")
    tw = tn.pair_tables(n, primes, acc.device)
    pcst = tn.prime_constants(n, primes, acc.device)
    gcst = garner_constants(primes, trunc_bits, acc.device)
    _build.check(name, getattr(_build.library(), name)(
        a_t.data_ptr(), acc.data_ptr(), spec_val.data_ptr(),
        spec_sh.data_ptr(), tw.data_ptr(), pcst.data_ptr(), gcst.data_ptr(),
        batch, n_small, kp1, levels, base_log, len(primes),
        n.bit_length() - 1, trunc_bits, int(acc32), _build.stream_of(acc)))
    _build.count(name)
    return acc


def blind_rotate_form(batch: int, n: int, kp1: int, levels: int,
                      n_primes: int, acc32: bool) -> str:
    """The rule that routes a blind rotate on a fused key, by its shape
    and accumulator mode alone: ``fused_latency`` (one launch of
    ``ops.fused_latency``'s kernel) at B <= ``LATENCY_BATCH_MAX`` where
    ``ops.fused_latency.plan`` takes the shape; else ``crt_ntt_scan`` (one
    launch of ``ops.crt_scan``'s kernel) where ``ops.crt_scan.plan`` takes
    it; else ``crt_ntt_loop`` (``scan_steps``, three launches a step)."""
    from concrete_tpu_torch.core.kernels import LATENCY_BATCH_MAX
    from concrete_tpu_torch.ops import crt_scan as cs
    from concrete_tpu_torch.ops import fused_latency as fl
    if batch <= LATENCY_BATCH_MAX and fl.plan(
            batch, n, kp1, levels, n_primes, acc32) is not None:
        return "fused_latency"
    if cs.plan(batch, n, kp1, levels, n_primes, acc32) is not None:
        return "crt_ntt_scan"
    return "crt_ntt_loop"


def blind_rotate_fused(ct_small: torch.Tensor, bsk: FusedBSK,
                       lut_poly: torch.Tensor, params,
                       acc32: bool = None) -> torch.Tensor:
    """Batched blind rotation: (B, n+1) ct, (N,) or (B, N) LUT ->
    accumulator (B, k+1, N) int64, in the form ``blind_rotate_form``
    gives: one launch of ``ops.fused_latency``'s kernel, one launch of
    ``ops.crt_scan``'s, or ``scan_steps``, three kernel launches a step.
    A shape rule, not a fallback.  With tracing on, the rows are counted
    in ``pbs.fused_latency_rows`` or ``pbs.crt_ntt_rows`` (both forms
    above the latency rule), those of the one-launch scan also in
    ``pbs.crt_ntt_scan_rows``; the ``pbs.blind_rotate`` span's ``form`` is
    the form."""
    from concrete_tpu_torch.ops import crt_scan as cs
    from concrete_tpu_torch.ops import fused_latency as fl
    with tm.span("pbs.init") if tm.on else tm.OFF:
        a_t, acc = first_accumulator(ct_small, bsk, lut_poly, params, acc32)
    b_ct, kp1, n = acc.shape
    form = blind_rotate_form(b_ct, n, kp1, bsk.levels, len(bsk.primes),
                             acc.dtype == torch.int32)
    if tm.on:
        tm.count("pbs.fused_latency_rows" if form == "fused_latency"
                 else "pbs.crt_ntt_rows", b_ct)
        if form == "crt_ntt_scan":
            tm.count("pbs.crt_ntt_scan_rows", b_ct)
    with tm.span("pbs.blind_rotate", form=form) if tm.on else tm.OFF:
        if form == "crt_ntt_loop":
            scan_steps(a_t, acc, bsk)
        else:
            one_launch = fl.blind_rotate_fused_latency \
                if form == "fused_latency" else cs.blind_rotate_crt_scan
            one_launch(a_t, acc, bsk.spec_val, bsk.spec_sh,
                       primes=bsk.primes, trunc_bits=bsk.trunc_bits,
                       base_log=bsk.base_log, levels=bsk.levels)
        return last_accumulator(acc)
