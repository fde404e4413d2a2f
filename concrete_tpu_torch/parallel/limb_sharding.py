"""GLWE polynomial-limb sharding: counterpart of ``concrete_tpu/parallel/limb_sharding.py``.

The NTT external product over a mesh of D ranks, with all-to-all
exchanges between the four-step NTT's stages (``core/ntt_fourstep.py``):
the scale-out axis for *latency* (small-batch) work, where batch sharding
(``parallel/sharding.py``) has nothing to split.  The polynomial
coefficient axis of every transform is split over the mesh's "limb"
axis, so each rank does 1/D of each transform's matmuls.

Per step, for every CRT prime at once (residues int32; the same integers
as ``ntt_fourstep.blind_rotate_ntt``):

  digits: kernel 1 (``ops.step.rotate_decompose_digits``) on the
    replicated accumulator; this rank keeps its block of n1/D rows
    (coefficients i1 * n2 + i2 of its i1 block, a contiguous block)
  (P, R, n1/D, n2) --all_to_all--> (P, R, n2/D, n1), stage 1 over i1,
    the twiddle (this rank's rows) --all_to_all--> (P, R, n1/D, n2),
    stage 2 over i2: the spectrum's k1 block
  pointwise GGSW contraction with this rank's k1 block of the BSK spectra
    (sharded once, ``spectrum_shard``): local
  the inverse mirrors the exchanges back to i1-blocked coefficients
  Garner: kernel 4 (``ops.fused_ntt.garner_accumulate``) adds the exact
    product into this rank's block of the accumulator; one all_gather
    re-replicates the accumulator.

Each exchange is one ``dist.all_to_all_single`` on the mesh's group,
with the transpose to the layout of the stage that follows.  The
accumulator stays replicated: at latency batch sizes it is KBs, and the
data-dependent negacyclic rotations act on whole polynomials.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import ntt_fourstep as nt
from concrete_tpu_torch.ops import fused_ntt as fn
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.parallel.distributed import all_gather_into
from concrete_tpu_torch.parallel.sharding import make_mesh

LIMB_AXIS = "limb"


def make_limb_mesh(n_devices: int = None, axis_name: str = LIMB_AXIS):
    """A 1-D mesh named "limb" over every rank (``sharding.make_mesh``)."""
    return make_mesh(n_devices, axis_name)


def check_limb_shardable(params: CryptoParams, n_devices: int,
                         primes: tuple = None) -> bool:
    """True when both four-step factors are divisible by the mesh size
    (they depend on N alone; `primes` is the JAX signature's)."""
    n = params.polynomial_size
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1 % n_devices == 0 and (n // n1) % n_devices == 0


def _mesh_rank(mesh, axis_name: str, params: CryptoParams):
    """(group, D, this rank) of `mesh`, refusing a size that does not
    divide the transform."""
    d = mesh.size()
    if not check_limb_shardable(params, d):
        raise ValueError(f"N={params.polynomial_size} does not split over "
                         f"{d} ranks: both four-step factors must divide")
    return mesh.get_group(axis_name), d, mesh.get_local_rank(axis_name)


# ---------------------------------------------------------------------------
# Per-rank transform stages
# ---------------------------------------------------------------------------

def _exchange(y: torch.Tensor, group) -> torch.Tensor:
    """(P, R, a, b), this rank's block of the first axis (a), the second
    whole -> (P, R, b/D, D*a): its block of the second axis, the first
    whole, in the swapped layout the next stage reads (``jax.lax.
    all_to_all(split_axis=3, concat_axis=2)`` then ``jnp.swapaxes``)."""
    d = dist.get_world_size(group)
    n_p, r, a, b = y.shape
    send = y.view(n_p, r, a, d, b // d).permute(3, 0, 1, 2, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 4, 0, 3).reshape(n_p, r, b // d, d * a)


def _fwd_local(x3: torch.Tensor, twf_local: torch.Tensor, st,
               group) -> torch.Tensor:
    """(P, R, n1/D, n2) i1-blocked residues -> (P, R, n1/D, n2) k1-blocked
    spectrum, exchanging stage layouts all-to-all over `group`."""
    return nt._fwd(x3, st, twf_local, functools.partial(_exchange,
                                                        group=group))


def _inv_local(z3: torch.Tensor, twi_local: torch.Tensor, st,
               group) -> torch.Tensor:
    """(P, R, n1/D, n2) k1-blocked spectrum -> (P, R, n1/D, n2) i1-blocked
    coefficients (mirror of _fwd_local)."""
    return nt._inv(z3, st, twi_local, functools.partial(_exchange,
                                                        group=group))


def _ext_local(d3: torch.Tensor, spec: torch.Tensor, st, twf: torch.Tensor,
               twi: torch.Tensor, group) -> torch.Tensor:
    """Per-rank external product body.

    d3:   (B, Cin, n1/D, n2) int32 gadget digits, this rank's i1 block
    spec: (P, Cin, k+1, n1/D, n2) int32 BSK spectra, its k1 block
    twf:  (P, n2/D, n1) forward twiddles (its i2 rows)
    twi:  (P, n1/D, n2) inverse twiddles (its k1 rows)
    Returns (P, B*(k+1), n1/D, n2) int32: the residues of the product's
    coefficients in this rank's block.
    """
    b, cin, a, n2 = d3.shape
    n_p = len(st.primes)
    d_hat = _fwd_local(nt._digit_residues(d3, st), twf, st, group)
    prod = nt._contract(d_hat.view(n_p, b, cin, a, n2), spec, st.p)
    return _inv_local(prod.view(n_p, -1, a, n2), twi, st, group)


def _accumulate(res: torch.Tensor, rows: torch.Tensor, primes: tuple,
                group, d: int, r: int) -> None:
    """rows (R, N) int64 += the product whose residues (P, R, n1/D, n2)
    are this rank's block: kernel 4 on the block, then one all_gather
    re-replicates rows on every rank."""
    n_rows, n = rows.shape
    blk = n // d
    local = rows.view(n_rows, d, blk)[:, r].contiguous()
    fn.garner_accumulate(res.reshape(len(primes), n_rows, blk), local,
                         primes, 0)
    out = torch.empty((d, n_rows, blk), dtype=rows.dtype, device=rows.device)
    all_gather_into(out, local, group)
    rows.copy_(out.permute(1, 0, 2).reshape(n_rows, n))


def _local_tables(st, d: int, r: int) -> tuple:
    """This rank's rows of the twiddles: tw_f's i2 block, tw_i's k1 block."""
    b2, b1 = st.n2 // d, st.n1 // d
    return (st.tw_f[:, r * b2:(r + 1) * b2].contiguous(),
            st.tw_i[:, r * b1:(r + 1) * b1].contiguous())


def spectrum_shard(spectra: torch.Tensor, n1: int, d: int,
                   r: int) -> torch.Tensor:
    """(P, ..., N) four-step spectra -> (P, ..., n1/D, n2): rank r's k1
    block, a contiguous copy."""
    shape = spectra.shape[:-1]
    blk = n1 // d
    full = spectra.view(shape + (n1, spectra.shape[-1] // n1))
    return full[..., r * blk:(r + 1) * blk, :].contiguous()


def external_product_limb_sharded(mesh, digits: torch.Tensor,
                                  bsk_step: torch.Tensor,
                                  params: CryptoParams, primes: tuple,
                                  axis_name: str = LIMB_AXIS) -> torch.Tensor:
    """One CMUX external product with the polynomial axis sharded.

    digits: (B, Cin, N) int32; bsk_step: (primes, Cin, k+1, N) int32
    spectra (one blind-rotate step), both whole on every rank.  Returns
    (B, k+1, N) int64 on every rank, bit-identical to
    ``ntt_fourstep.external_product_ntt``.
    """
    primes = tuple(primes)
    group, d, r = _mesh_rank(mesh, axis_name, params)
    st = nt._stack(params.polynomial_size, primes, digits.device)
    b, cin, n = digits.shape
    kp1 = bsk_step.shape[2]
    blk = st.n1 // d
    d3 = digits.view(b, cin, st.n1, st.n2)[:, :, r * blk:(r + 1) * blk]
    res = _ext_local(d3, spectrum_shard(bsk_step, st.n1, d, r), st,
                     *_local_tables(st, d, r), group)
    out = torch.zeros((b * kp1, n), dtype=torch.int64, device=digits.device)
    _accumulate(res, out, primes, group, d, r)
    return out.view(b, kp1, n)


def blind_rotate_limb_sharded(mesh, ct_small: torch.Tensor, bsk: nt.NttBSK,
                              lut_poly: torch.Tensor, params: CryptoParams,
                              axis_name: str = LIMB_AXIS) -> torch.Tensor:
    """Batched blind rotation with the limb-sharded external product:
    (B, n+1) int64 + (N,) LUT -> accumulator (B, k+1, N) int64 on every
    rank, bit-identical to ``ntt_fourstep.blind_rotate_ntt``.  `bsk` is the
    whole key; this rank keeps its k1 block of the spectra."""
    group, d, r = _mesh_rank(mesh, axis_name, params)
    st = nt._stack(params.polynomial_size, bsk.primes, ct_small.device)
    blk = st.n1 // d
    spec = spectrum_shard(bsk.spectra, st.n1, d, r)
    twf, twi = _local_tables(st, d, r)
    a_t, acc = kn._switch_and_init(ct_small, lut_poly, params)
    b_ct, kp1, n = acc.shape
    rows = acc.view(b_ct * kp1, n)
    a_rows = nt.step_rotations(a_t, kp1)
    for i in range(bsk.n_small):
        digits = nt.step_digits(rows, a_rows[i], b_ct, params)
        d3 = digits.view(b_ct, -1, st.n1, st.n2)[:, :, r * blk:(r + 1) * blk]
        res = _ext_local(d3, spec[:, i], st, twf, twi, group)
        _accumulate(res, rows, bsk.primes, group, d, r)
    return acc


def pbs_batch_limb_sharded(mesh, ct_big: torch.Tensor, ksk: kn.LimbKSK,
                           bsk: nt.NttBSK, lut_poly: torch.Tensor,
                           params: CryptoParams, message_bits: int,
                           signed: bool = False,
                           axis_name: str = LIMB_AXIS) -> torch.Tensor:
    """Full PBS (keyswitch + limb-sharded blind rotate + sample extract),
    bit-identical to ``kernels.pbs_batch`` on an exact key.  Latency-
    oriented: for large batches prefer batch sharding."""
    if signed:
        ct_big = ct_big.clone()
        ct_big[:, -1] += (1 << (message_bits - 1)) << (
            64 - message_bits - 1)
    ct_small = kn.keyswitch(ct_big, ksk)
    acc = blind_rotate_limb_sharded(mesh, ct_small, bsk, lut_poly, params,
                                    axis_name=axis_name)
    return kn.sample_extract(acc)
