"""The CRT-NTT blind rotate at B <= ``LATENCY_BATCH_MAX`` in one launch.

Counterpart, at a small batch, of the JAX package's ``blind_rotate_fused``
(``concrete_tpu/ops/pallas_fused_ntt.py``), which runs the whole scan in
one ``pallas_call``: per step i of n_small, kernel 1's digits of
X^{a_i} acc - acc, kernel 3's forward transforms, multiply-add with the
step's key spectra and inverse transforms per prime, and kernel 4's Garner
update of acc.  The CUDA kernel (``csrc/blind_rotate_fused_latency.cu``,
its header says what bounds it and how) runs all n_small steps for all B
ciphertexts in one launch: one thread-block cluster per ciphertext, one
block per (prime, output component), the spectra and the residues
exchanged through distributed shared memory, each block's accumulator row
on chip across the steps, its key rows staged in a 2-slot ring.  Its plain
version is ``ops.fused_ntt``'s three-kernel scan on the plain versions of
kernels 1, 3 and 4 (``ops.fused_ntt.scan_plain``), which gives the same
bits.

``plan`` is the shape rule: the shapes whose cluster and block fit the
card (the models' B = 1 lookups: N = 1024, k+1 = 3, l = 2 and N = 2048,
k+1 = 2, l = 1 or 2, at 2 or 3 primes).  ``ops.fused_ntt.blind_rotate_fused``
(what ``core.kernels.blind_rotate`` runs on a fused key) sends a blind
rotate of at most ``LATENCY_BATCH_MAX`` ciphertexts to
``blind_rotate_fused_latency`` where the rule takes the shape, and any
other to ``ops.crt_scan``'s one launch or ``ops.fused_ntt.scan_steps``'s
loop (``ops.fused_ntt.blind_rotate_form``).  ``blind_rotate_fused_latency``
launches the kernel on CUDA tensors, raises at a shape the rule refuses,
and runs the plain version on CPU ones; there is no other fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from concrete_tpu_torch.ops import fused_ntt as fn

NAME = "blind_rotate_fused_latency"
#: csrc/blind_rotate_fused_latency.cu's constants
MAX_SMEM = 227 * 1024           # shared memory per block, H100 (opt-in)
MAX_CLUSTER = 16                # blocks per cluster, the non-portable most
MAX_PRIMES = 8                  # residues a Garner thread holds
MAX_THREADS = 288               # a block's threads, producer warp included
MAX_BATCH = 8                   # clusters, all on the card at once
LOG_N = (10, 11, 12)            # the transform sizes it is compiled for
E = 16                          # residues a thread holds in a transform


@dataclasses.dataclass(frozen=True)
class Plan:
    """One cluster per ciphertext of `cluster` = P (k+1) blocks, block
    (p, co) at rank p (k+1) + co; `threads` computing threads a block (l
    groups of N/16) and a producer warp; shared memory `smem`: the
    accumulator row, the l spectra at `off_spec`, the l pairs of exchange
    buffers at `off_exch`, the multiply-add's sums at `off_hat`, the
    residues at `off_res`, the key ring of two `ring_slot`-byte slots at
    `off_ring`, its mbarriers at `off_bar`."""
    cluster: int
    threads: int
    off_spec: int
    off_exch: int
    off_hat: int
    off_res: int
    off_ring: int
    off_bar: int
    ring_slot: int
    smem: int


def plan(batch: int, n: int, kp1: int, levels: int, n_primes: int,
         acc32: bool) -> Plan | None:
    """The kernel's plan at B ciphertexts, N, k+1, l, P primes and the
    accumulator mode, or None where it does not run (the kernel's
    make_plan computes the same)."""
    if not (1 <= batch <= MAX_BATCH and n in [1 << k for k in LOG_N]
            and kp1 >= 1 and levels >= 1 and 1 <= n_primes <= MAX_PRIMES):
        return None
    cluster, threads = n_primes * kp1, levels * (n // E)
    if cluster > MAX_CLUSTER or threads + 32 > MAX_THREADS:
        return None
    off_spec = n * (4 if acc32 else 8)
    off_exch = off_spec + levels * n * 4
    off_hat = off_exch + levels * 2 * n * 4
    off_res = off_hat + n * 4
    off_ring = off_res + n * 4
    ring_slot = 2 * levels * kp1 * n * 4
    off_bar = off_ring + 2 * ring_slot
    smem = off_bar + 32
    if smem > MAX_SMEM:
        return None
    return Plan(cluster=cluster, threads=threads, off_spec=off_spec,
                off_exch=off_exch, off_hat=off_hat, off_res=off_res,
                off_ring=off_ring, off_bar=off_bar, ring_slot=ring_slot,
                smem=smem)


def blind_rotate_fused_latency_plain(a_t: torch.Tensor, acc: torch.Tensor,
                                     spec_val: torch.Tensor,
                                     spec_sh: torch.Tensor, *, primes: tuple,
                                     trunc_bits: int, base_log: int,
                                     levels: int) -> torch.Tensor:
    """Plain PyTorch version: the three-kernel scan on the plain versions
    of kernels 1, 3 and 4 (``ops.fused_ntt.scan_plain``); returns the last
    accumulator (B, k+1, N)."""
    return fn.scan_plain(NAME, a_t, acc, spec_val, spec_sh, primes=primes,
                         trunc_bits=trunc_bits, base_log=base_log,
                         levels=levels)


def blind_rotate_fused_latency(a_t: torch.Tensor, acc: torch.Tensor,
                               spec_val: torch.Tensor, spec_sh: torch.Tensor,
                               *, primes: tuple, trunc_bits: int,
                               base_log: int, levels: int) -> torch.Tensor:
    """a_t (B, n_small) int32 switched mask, acc (B, k+1, N) first
    accumulator, int32 top words (the acc32 mode) or int64, spec_val and
    spec_sh a FusedBSK's spectra and companions (n_small, P Cin (k+1), N)
    int32 -> the accumulator after n_small steps, into `acc` in place; on
    the card one launch."""
    kw = dict(primes=primes, trunc_bits=trunc_bits, base_log=base_log,
              levels=levels)
    if acc.device.type == "cpu":
        return acc.copy_(blind_rotate_fused_latency_plain(
            a_t, acc, spec_val, spec_sh, **kw))
    return fn.launch_scan(NAME, plan, a_t, acc, spec_val, spec_sh, **kw)
