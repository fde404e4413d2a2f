"""Batched WoP-PBS kernels in PyTorch — counterpart of
``concrete_tpu/core/kernels_wop.py``.

The large-precision table lookup: bit extraction -> circuit bootstrap
(sign PBS + private functional packing keyswitch) -> vertical packing,
bit for bit the numpy oracle ``core/wop.py`` and the JAX package's
batched kernels (tests/test_torch_wop.py holds them to both).  Torus
values are int64 tensors (mod 2^64), as everywhere in the port.

- The sign PBS of the bit extraction and of the circuit bootstrap run
  through the port's ``core.kernels.keyswitch`` and ``blind_rotate`` with
  per-row test polynomials, so they reuse the blind-rotate kernels of the
  key's form.  They pass the smallest output scale of their rows, and a
  fused key takes its acc32 mode only where ``ops.fused_ntt.
  acc32_eligible``'s message-scale gate allows it (the JAX package's rule
  lets the mode perturb a deep circuit-bootstrap level; ROADMAP queue 3).
- The PFPKSK application is one int8 limb GEMM a digit limb, (rows,
  (n_big+1) l) @ ((n_big+1) l, (k+1)^2 N 8), through ``core.limbs.
  int8_matmul``; the JAX package computes this product with ``jnp.matmul``
  outside any Pallas kernel.  The key is packed once into balanced limb
  planes on the device (``pack_pfpksk``), its K padded to a multiple of 8
  there, so no call pads the key again.
- The external products by runtime GGSWs (the circuit bootstrap's outputs)
  run on the CRT-NTT kernels, where the JAX package runs a grouped exact
  int8 limb convolution: the GGSW stack has a BSK step's layout, so one
  launch of kernel 2's pack entry (``ops.ntt.ntt_forward_pack``, no
  truncation) a chunk transforms it for every table looked up on the same
  bits (a ``crt_tlu``'s residues), at the primes the exact product needs
  (``core.ntt.runtime_primes``: the cbs gadget, full u64 entries). Each
  CMUX of the vertical packing's rotation phase is then a blind-rotate
  step with a per-ciphertext key: kernel 1 (rotate by X^(2N - 2^t),
  subtract, decompose at the cbs gadget), kernel 3's keyed entry
  (``ops.fused_ntt.crt_external_product_keyed``, ciphertext b reads the
  GGSW of its bit) and kernel 4 (Garner, no shift, into the int64
  accumulator in place): three launches a bit whatever the batch. The tree
  phase (nb > log2 N) takes its digits of ct1 - ct0 from
  ``core.kernels.decompose`` and runs kernels 3 and 4 the same way. Both
  compute the exact negacyclic product mod 2^64, so the bits are the JAX
  convolution's.
- The circuit bootstrap and vertical packings run in chunks over the batch
  whose GGSWs stay under ``CONCRETE_TPU_WOP_CHUNK_MB`` (default 1024), as
  in the JAX package; ``check_wop_memory`` refuses a lookup whose chunk and
  packed PFPKSK do not fit the device's free memory before any key is
  generated or packed (the JAX package's 100 GB host-RSS fault: fail
  fast, with the estimate).  The PFPKSK is generated on the device it is
  packed for (``core.wop.pfpksk_gen_device``), so the estimate counts the
  u64 key and its generation there.

Shapes: B = batch, nb = extracted bits, n_big = big LWE dim, k = GLWE dim,
N = poly size, l = gadget levels (cbs or pfks by context).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import limbs as lb
from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.core.wop import WopParams, crt_block_bits
from concrete_tpu_torch.ops import fused_ntt as fnt
from concrete_tpu_torch.ops import ntt as tn
from concrete_tpu_torch.ops import step
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils.device import resolve_device

_Q_LOG = 64


# ---------------------------------------------------------------------------
# Key packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LimbPFPKSK:
    """The PFPKSK as int8 limb planes ((n_big+1) l padded to a multiple of
    8, (k+1) (k+1) N 8), the JAX package's layout: row i * l + j (input
    digit i, level j), column ((r (k+1) + c) N + t) 8 + s for output row
    r, GLWE component c, coefficient t, limb s; the padding rows are
    zero."""
    planes: torch.Tensor
    base_log: int
    levels: int
    glwe_dimension: int
    polynomial_size: int

    @property
    def device(self) -> torch.device:
        return self.planes.device


#: the device split of u64 key material (``core.limbs``), by this name for
#: the PFPKSK, the conversion keys and the TFHE-rs bridge's keys
split_u64_limbs = lb.split_u64_limbs


def pack_pfpksk(pfpksk, wp: WopParams, device=None) -> LimbPFPKSK:
    """The (k+1, n_big+1, l, k+1, N) u64 PFPKSK (numpy, or an int64 tensor
    already on the device) -> int8 limb planes on `device`, CUDA by
    default: uploaded as u64 and split there, one output row r at a
    time."""
    if isinstance(pfpksk, torch.Tensor):
        x = pfpksk if device is None else pfpksk.to(resolve_device(device))
    else:
        x = torch.from_numpy(np.ascontiguousarray(
            pfpksk, dtype=np.uint64).view(np.int64)).to(
                resolve_device(device))
    kp1, n_in, levels, _, n = x.shape
    k_rows = n_in * levels
    planes = torch.zeros((-(-k_rows // 8) * 8, kp1 * kp1 * n * 8),
                         dtype=torch.int8, device=x.device)
    view = planes[:k_rows].view(n_in, levels, kp1, kp1 * n * 8)
    for r in range(kp1):
        view[:, :, r] = split_u64_limbs(x[r]).view(n_in, levels,
                                                    kp1 * n * 8)
    return LimbPFPKSK(planes=planes, base_log=wp.pfks_base_log,
                      levels=wp.pfks_level, glwe_dimension=kp1 - 1,
                      polynomial_size=n)


def unpack_pfpksk(packed: LimbPFPKSK, n_in: int) -> np.ndarray:
    """The u64 PFPKSK (k+1, n_in, l, k+1, N) on the host from its limb
    planes (n_in = n_big + 1): every limb is kept, so sum_s limb_s << 8s
    gives the key back exactly.  A row block at a time on the planes'
    device, so no temporary of the whole key's size is made there."""
    kp1 = packed.glwe_dimension + 1
    n, levels = packed.polynomial_size, packed.levels
    view = packed.planes[:n_in * levels].view(n_in, levels, kp1, kp1, n, 8)
    out = np.empty((kp1, n_in, levels, kp1, n), dtype=np.uint64)
    step_rows = max(1, (1 << 24) // (levels * kp1 * kp1 * n))
    for i0 in range(0, n_in, step_rows):
        block = view[i0:i0 + step_rows]
        vals = lb.recombine_i32_planes_to_u64(block, axis=-1)
        out[:, i0:i0 + step_rows] = vals.permute(2, 0, 1, 3, 4).cpu() \
            .numpy().view(np.uint64)
    return out


def private_packing_keyswitch_batch(lwe_ct: torch.Tensor,
                                    pfpksk: LimbPFPKSK) -> torch.Tensor:
    """Batched PFPKSK: (B, n_big+1) -> (B, k+1, k+1, N).

    out[b, r] is the GLWE of the input message multiplied by the key's
    secret function v_r (oracle: wop.private_packing_keyswitch per r): the
    digits' balanced limbs times the key planes, one int8 GEMM a digit
    limb, shift-added into int32 planes and recombined mod 2^64."""
    b_ct, n_in = lwe_ct.shape
    kp1 = pfpksk.glwe_dimension + 1
    n = pfpksk.polynomial_size
    digits = kn.decompose(lwe_ct, pfpksk.base_log, pfpksk.levels)
    a_limbs = lb.num_digit_limbs(pfpksk.base_log)
    d_limbs = lb.i32_digits_to_balanced_i8(digits, a_limbs).reshape(
        b_ct, n_in * pfpksk.levels, a_limbs)
    pad = pfpksk.planes.shape[0] - d_limbs.shape[1]
    if pad:
        d_limbs = torch.nn.functional.pad(d_limbs, (0, 0, 0, pad))
    planes = torch.zeros((b_ct, kp1 * kp1 * n, 8 + a_limbs - 1),
                         dtype=torch.int32, device=lwe_ct.device)
    for a in range(a_limbs):
        prod = lb.int8_matmul(d_limbs[:, :, a].contiguous(), pfpksk.planes)
        planes[:, :, a:a + 8] += prod.view(b_ct, kp1 * kp1 * n, 8)
    out = lb.recombine_i32_planes_to_u64(planes[:, :, :8])
    return out.view(b_ct, kp1, kp1, n)


# ---------------------------------------------------------------------------
# The external product with runtime GGSWs, on the CRT-NTT kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GGSWSpectra:
    """A stack of runtime GGSWs in the CRT-NTT kernels' form: spec and
    spec_sh (n_keys, P * l(k+1) * (k+1), N) int32, key j the GGSW of
    flattened position j of the stack's leading `shape` ((B, nb) for a
    vertical packing)."""
    spec: torch.Tensor
    spec_sh: torch.Tensor
    primes: tuple
    shape: tuple


def ggsw_spectra(ggsws: torch.Tensor, base_log: int,
                 levels: int) -> GGSWSpectra:
    """(..., l, k+1, k+1, N) int64 GGSWs -> their spectra, one launch of
    kernel 2's pack entry (no truncation) at ``core.ntt.runtime_primes``."""
    kp1, n = ggsws.shape[-2], ggsws.shape[-1]
    primes = host.runtime_primes(n, kp1, base_log, levels)
    spec, sh = tn.ntt_forward_pack(ggsws.reshape(-1, n).contiguous(),
                                   primes, levels * kp1 * kp1, 0)
    return GGSWSpectra(spec=spec, spec_sh=sh, primes=primes,
                       shape=tuple(ggsws.shape[:-4]))


def _keyed_accumulate(digits: torch.Tensor, keys: GGSWSpectra,
                      key_index: torch.Tensor, rows: torch.Tensor,
                      kp1: int) -> None:
    """rows (R (k+1), N) int64 += the exact product of each ciphertext's
    digits (l, R (k+1), N) with its key (kernels 3 and 4), in place."""
    res = fnt.crt_external_product_keyed(digits, keys.spec, keys.spec_sh,
                                         key_index, keys.primes, kp1)
    fnt.garner_accumulate(res, rows, keys.primes, 0)


def external_product_batch(ggsw: torch.Tensor, glwe: torch.Tensor,
                           base_log: int, levels: int) -> torch.Tensor:
    """Batched GGSW (.) GLWE: ggsw (B, l, k+1, k+1, N), glwe (B, k+1, N)
    -> (B, k+1, N), exact mod 2^64."""
    b_ct, _, kp1, _, n = ggsw.shape
    keys = ggsw_spectra(ggsw, base_log, levels)
    digits = kn.decompose(glwe.reshape(b_ct * kp1, n), base_log, levels)
    out = torch.zeros((b_ct * kp1, n), dtype=torch.int64, device=glwe.device)
    _keyed_accumulate(digits.permute(2, 0, 1).contiguous(), keys,
                      torch.arange(b_ct, dtype=torch.int32,
                                   device=glwe.device), out, kp1)
    return out.view(b_ct, kp1, n)


def cmux_batch(ggsw: torch.Tensor, ct0: torch.Tensor, ct1: torch.Tensor,
               base_log: int, levels: int) -> torch.Tensor:
    """ct0 + GGSW (.) (ct1 - ct0), batched."""
    return ct0 + external_product_batch(ggsw, ct1 - ct0, base_log, levels)


# ---------------------------------------------------------------------------
# Sign PBS (batched, per-row output scales)
# ---------------------------------------------------------------------------

def sign_pbs_batch(lwe_big: torch.Tensor, ksk: kn.LimbKSK, bsk,
                   params: CryptoParams, out_scale_logs) -> torch.Tensor:
    """Batched bit-cleaning bootstrap: rows encrypt bit*2^63 (+ noise); the
    output encrypts bit * 2^out_scale_logs[row] exactly.

    Oracle: wop._sign_pbs (quarter-torus centering, constant test poly
    -2^(out-1), plaintext half added back).  The smallest scale of the
    rows gates a fused key's acc32 mode (``core.kernels.blind_rotate``'s
    `min_scale_log`)."""
    scales = [int(s) for s in np.asarray(out_scale_logs).reshape(-1)]
    b_ct = lwe_big.shape[0]
    n = params.polynomial_size
    halves = torch.tensor([1 << (s - 1) for s in scales], dtype=torch.int64,
                          device=lwe_big.device)
    ct = lwe_big.clone()
    ct[:, -1] += 1 << 62
    ct_small = kn.keyswitch(ct, ksk)
    test_polys = (-halves)[:, None].expand(b_ct, n).contiguous()
    acc = kn.blind_rotate(ct_small, bsk, test_polys, params,
                          min_scale_log=min(scales))
    out = kn.sample_extract(acc, 0)
    out[:, -1] += halves
    return out


# ---------------------------------------------------------------------------
# 1. Bit extraction (batched over ciphertexts)
# ---------------------------------------------------------------------------

def extract_bits_batch(lwe_big: torch.Tensor, nb_bits: int, delta_log: int,
                       ksk: kn.LimbKSK, bsk,
                       params: CryptoParams) -> torch.Tensor:
    """(B, n_big+1) -> (B, nb_bits, n_big+1), row 0 = MSB (packing order).

    LSB-first peel, two fused sign-PBS rows per bit (output scale 63 for the
    packing copy, scale pos for the cleaning copy) except the last."""
    b_ct, width = lwe_big.shape
    acc = lwe_big
    out = torch.empty((b_ct, nb_bits, width), dtype=torch.int64,
                      device=lwe_big.device)
    for i in range(nb_bits):
        pos = delta_log + i
        shifted = acc << (_Q_LOG - 1 - pos)
        if i < nb_bits - 1:
            both = sign_pbs_batch(torch.cat([shifted, shifted]), ksk, bsk,
                                  params, [63] * b_ct + [pos] * b_ct)
            out[:, nb_bits - 1 - i] = both[:b_ct]
            acc = acc - both[b_ct:]
        else:
            out[:, nb_bits - 1 - i] = sign_pbs_batch(shifted, ksk, bsk,
                                                     params, [63] * b_ct)
    return out


def extract_bits_to(lwe_big: torch.Tensor, positions, out_scale_logs,
                    delta_log: int, ksk: kn.LimbKSK, bsk,
                    params: CryptoParams) -> torch.Tensor:
    """Cheap bit extraction: peel LSB-first, emit requested bits re-encoded.

    positions: ascending message-relative bit indices; out_scale_logs[j] is
    the torus scale of returned bit j.  Returns (B, len(positions),
    n_big+1).  One sign PBS per peeled bit for cleaning plus one per
    requested bit, shared when the requested scale equals the peel scale
    (the JAX package's ``extract_bits_to``)."""
    b_ct = lwe_big.shape[0]
    acc = lwe_big
    positions = tuple(int(p) for p in positions)
    out_of = {p: i for i, p in enumerate(positions)}
    outs: dict[int, torch.Tensor] = {}
    max_bit = max(positions)
    for i in range(max_bit + 1):
        pos = delta_log + i
        shifted = acc << (_Q_LOG - 1 - pos)
        want = i in out_of
        out_scale = int(out_scale_logs[out_of[i]]) if want else None
        need_clean = i < max_bit
        if want and need_clean and out_scale == pos:
            both = sign_pbs_batch(shifted, ksk, bsk, params, [pos] * b_ct)
            outs[i] = both
            acc = acc - both
            continue
        rows, scales, tags = [], [], []
        if want:
            rows.append(shifted)
            scales += [out_scale] * b_ct
            tags.append("out")
        if need_clean:
            rows.append(shifted)
            scales += [pos] * b_ct
            tags.append("clean")
        if not rows:
            continue
        res = sign_pbs_batch(torch.cat(rows), ksk, bsk, params, scales)
        for j, tag in enumerate(tags):
            chunk = res[j * b_ct:(j + 1) * b_ct]
            if tag == "out":
                outs[i] = chunk
            else:
                acc = acc - chunk
    return torch.stack([outs[p] for p in positions], dim=1)


# ---------------------------------------------------------------------------
# 2. Circuit bootstrap (all bits x levels in one PBS batch)
# ---------------------------------------------------------------------------

def circuit_bootstrap_batch(bit_lwes: torch.Tensor, ksk: kn.LimbKSK, bsk,
                            pfpksk: LimbPFPKSK,
                            wp: WopParams) -> torch.Tensor:
    """(B, nb, n_big+1) bit ciphertexts -> (B, nb, l_cbs, k+1, k+1, N)
    GGSWs: one sign-PBS batch of B nb l rows (row scale 2^(64 - (j+1)
    base)), then one PFPKSK batch over all rows."""
    params = wp.base
    b_ct, nb, width = bit_lwes.shape
    levels, base = wp.cbs_level, wp.cbs_base_log
    kp1 = params.glwe_dimension + 1
    rows = bit_lwes[:, :, None, :].expand(b_ct, nb, levels, width) \
        .reshape(-1, width)
    scales = [_Q_LOG - (j + 1) * base for j in range(levels)] * (b_ct * nb)
    lev = sign_pbs_batch(rows, ksk, bsk, params, scales)
    glwes = private_packing_keyswitch_batch(lev, pfpksk)
    return glwes.view(b_ct, nb, levels, kp1, kp1, params.polynomial_size)


# ---------------------------------------------------------------------------
# 3. Vertical packing (CMUX tree + GGSW blind rotation)
# ---------------------------------------------------------------------------

def vertical_packing_batch(lut_torus: torch.Tensor, keys: GGSWSpectra,
                           wp: WopParams) -> torch.Tensor:
    """lut (2^nb,) int64 torus values shared across the batch, or (B, 2^nb)
    per-element tables; keys the spectra (``ggsw_spectra``) of the
    (B, nb, l, k+1, k+1, N) GGSWs of the index bits, MSB-first, so that
    one transform serves every table looked up on the same bits.  Returns
    the extracted (B, n_big+1) LWE of lut[m].

    The tree phase (nb > log2 N) merges chunk pairs with the pair axis
    folded into the batch, the rotation phase runs one keyed blind-rotate
    step per low bit."""
    params = wp.base
    n = params.polynomial_size
    k = params.glwe_dimension
    kp1 = k + 1
    levels, base = wp.cbs_level, wp.cbs_base_log
    b_ct, nb = keys.shape
    device = keys.spec.device
    lut = lut_torus.to(device)
    if lut.ndim == 1:
        lut = lut.expand(b_ct, -1)
    n_in_chunk = min(nb, n.bit_length() - 1)
    n_tree = nb - n_in_chunk
    first = torch.arange(b_ct, dtype=torch.int32, device=device) * nb

    chunks = lut.reshape(b_ct, 1 << n_tree, -1)
    layer = torch.zeros((b_ct, 1 << n_tree, kp1, n), dtype=torch.int64,
                        device=device)
    layer[:, :, k, :chunks.shape[2]] = chunks
    for t in range(n_tree):
        half = layer.shape[1] // 2
        ct0 = layer[:, 0::2].contiguous()
        diff = (layer[:, 1::2] - ct0).reshape(b_ct * half * kp1, n)
        digits = kn.decompose(diff, base, levels).permute(2, 0, 1)
        rows = ct0.view(b_ct * half * kp1, n)
        _keyed_accumulate(digits.contiguous(), keys,
                          (first + n_tree - 1 - t).repeat_interleave(half),
                          rows, kp1)
        layer = ct0
    rows = layer[:, 0].contiguous().view(b_ct * kp1, n)
    for t in range(n_in_chunk):
        a_rows = torch.full((b_ct * kp1,), 2 * n - (1 << t),
                            dtype=torch.int32, device=device)
        digits = step.rotate_decompose_digits(rows, a_rows, base_log=base,
                                              levels=levels)
        _keyed_accumulate(digits, keys, first + nb - 1 - t, rows, kp1)
    return kn.sample_extract(rows.view(b_ct, kp1, n), 0)


# ---------------------------------------------------------------------------
# Memory: the chunks and the fail-fast check
# ---------------------------------------------------------------------------

def chunk_size(wp: WopParams, nb: int) -> int:
    """Batch elements per circuit-bootstrap chunk: their u64 GGSWs within
    ``CONCRETE_TPU_WOP_CHUNK_MB`` (default 1024), as in the JAX package."""
    params = wp.base
    kp1 = params.glwe_dimension + 1
    per_elem = nb * wp.cbs_level * kp1 * kp1 * params.polynomial_size * 8
    budget = int(os.environ.get("CONCRETE_TPU_WOP_CHUNK_MB", "1024")) << 20
    return max(1, budget // max(per_elem, 1))


def wop_memory_estimate(wp: WopParams, nb: int, batch: int) -> dict:
    """Modeled device bytes of one WoP lookup of `batch` elements: its
    largest chunk's working set (the GGSWs twice, their spectra and
    companions, the PFPKSK product's int32 planes), the PFPKSK packed, the
    PFPKSK as the u64 key that is generated on the device before its
    split (or uploaded, from a host copy: the same bytes), and the key
    generation's working set (``core.keygen``: the key's f64 Toeplitz
    matrices and one chunk's masks, limbs, products, messages and
    noise)."""
    from concrete_tpu_torch.core.keygen import CHUNK_WORDS
    params = wp.base
    kp1 = params.glwe_dimension + 1
    n = params.polynomial_size
    cs = min(batch, chunk_size(wp, nb))
    ggsw_words = cs * nb * wp.cbs_level * kp1 * kp1 * n
    n_p = len(host.runtime_primes(n, kp1, wp.cbs_base_log, wp.cbs_level))
    a_limbs = lb.num_digit_limbs(wp.pfks_base_log)
    rows = cs * nb * wp.cbs_level
    chunk = (2 * 8 * ggsw_words + 2 * 4 * n_p * ggsw_words
             + rows * kp1 * kp1 * n * (8 + a_limbs - 1 + 8) * 4)
    k_rows = (params.n_big + 1) * wp.pfks_level
    packed = -(-k_rows // 8) * 8 * kp1 * kp1 * n * 8
    u64 = kp1 * k_rows * kp1 * n * 8
    k = kp1 - 1
    gen_rows = min(kp1 * k_rows, max(1, CHUNK_WORDS // (k * n)))
    keygen = k * n * n * 8 + gen_rows * n * 8 * (k + 15)
    return {"chunk": chunk, "pfpksk": packed, "pfpksk_u64": u64,
            "keygen": keygen, "total": chunk + packed + u64 + keygen}


def free_memory(device) -> int:
    """Free bytes where `device`'s tensors live: the card's free memory,
    or the host's available physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def check_wop_memory(wp: WopParams, nb: int, batch: int, device,
                     free_bytes: int = None) -> dict:
    """Refuse, before anything is allocated, a WoP lookup whose modeled
    bytes (``wop_memory_estimate``) exceed the free memory (`free_bytes`,
    else ``free_memory(device)``); returns the estimate."""
    est = wop_memory_estimate(wp, nb, batch)
    free = free_memory(device) if free_bytes is None else free_bytes
    if est["total"] > free:
        raise MemoryError(
            f"a WoP-PBS lookup of {batch} elements at {nb} bits needs about "
            f"{est['total']} bytes on {device} (chunk {est['chunk']}, "
            f"PFPKSK {est['pfpksk']} packed + {est['pfpksk_u64']} as u64, "
            f"its generation {est['keygen']}), {free} are free; lower "
            "CONCRETE_TPU_WOP_CHUNK_MB or the batch")
    return est


# ---------------------------------------------------------------------------
# Full batched WoP-PBS
# ---------------------------------------------------------------------------

def lut_torus(lut, out_bits: int, device) -> torch.Tensor:
    """Raw integer table entries -> torus values at out_bits (value <<
    (64 - out_bits - 1), wrapped mod 2^(out_bits+1))."""
    t = lut if isinstance(lut, torch.Tensor) \
        else torch.from_numpy(np.asarray(lut, dtype=np.int64))
    return (t.to(device=device, dtype=torch.int64)
            & ((1 << (out_bits + 1)) - 1)) << (_Q_LOG - out_bits - 1)


def wop_pbs_crt_batch(res_cts: torch.Tensor, luts, moduli: tuple,
                      ksk: kn.LimbKSK, bsk, pfpksk: LimbPFPKSK,
                      wp: WopParams) -> torch.Tensor:
    """Batched CRT TLU: (n_blocks, B, n_big+1) residue ciphertexts ->
    (n_blocks, B, n_big+1) output residues (native encoding).

    luts: (n_blocks, 2^total_bits) raw integer tables (wop.crt_lut_tables).
    One shared bit extraction + circuit bootstrap (chunked) feeds one
    vertical packing per output block; oracle: wop.wop_pbs_crt."""
    bits = crt_block_bits(moduli)
    chunks = []
    for j in reversed(range(len(moduli))):     # block n-1 first: the MSBs
        chunks.append(extract_bits_batch(res_cts[j], bits[j],
                                         _Q_LOG - bits[j] - 1, ksk, bsk,
                                         wp.base))
    return _cbs_vp_chunked(
        torch.cat(chunks, dim=1),
        [lut_torus(luts[j], bits[j], res_cts.device)
         for j in range(len(moduli))], ksk, bsk, pfpksk, wp)


def wop_pbs_batch(lwe_big: torch.Tensor, lut, nb_bits: int, delta_log: int,
                  out_bits: int, ksk: kn.LimbKSK, bsk, pfpksk: LimbPFPKSK,
                  wp: WopParams) -> torch.Tensor:
    """Batched large-precision TLU: (B, n_big+1) -> (B, n_big+1).

    `lut` holds raw integer entries, (2^nb_bits,) shared or (B, 2^nb_bits)
    per-element tables; the output is encoded at out_bits.  Oracle:
    wop.wop_pbs."""
    bits = extract_bits_batch(lwe_big, nb_bits, delta_log, ksk, bsk,
                              wp.base)
    return _cbs_vp_chunked(bits, [lut_torus(lut, out_bits, lwe_big.device)],
                           ksk, bsk, pfpksk, wp)[0]


def _cbs_vp_chunked(bits: torch.Tensor, luts, ksk: kn.LimbKSK, bsk,
                    pfpksk: LimbPFPKSK, wp: WopParams) -> torch.Tensor:
    """Circuit bootstrap + vertical packing over chunks of the batch
    (``chunk_size``), so that one chunk's GGSWs and their spectra are live
    at a time; each chunk's spectra serve the vertical packing of every
    table in `luts` (torus values, (2^nb,) shared or (B, 2^nb) each).
    bits (B, nb, n_big+1) -> (len(luts), B, n_big+1)."""
    b_ct, nb = bits.shape[:2]
    cs = chunk_size(wp, nb)
    outs = []
    for s in range(0, b_ct, cs):
        ggsws = circuit_bootstrap_batch(bits[s:s + cs], ksk, bsk, pfpksk,
                                        wp)
        keys = ggsw_spectra(ggsws, wp.cbs_base_log, wp.cbs_level)
        del ggsws
        outs.append(torch.stack([
            vertical_packing_batch(lut[s:s + cs] if lut.ndim == 2 else lut,
                                   keys, wp) for lut in luts]))
        del keys
    return torch.cat(outs, dim=1)
