"""The CRT-NTT blind rotate of a batch in one launch.

Counterpart, at a batch, of the JAX package's ``blind_rotate_fused``
(``concrete_tpu/ops/pallas_fused_ntt.py``), which runs the whole scan in
one ``pallas_call``: per step i of n_small, kernel 1's digits of
X^{a_i} acc - acc, kernel 3's forward transforms, multiply-add with the
step's key spectra and inverse transforms per prime, and kernel 4's Garner
update of acc.  The CUDA kernel (``csrc/blind_rotate_crt_scan.cu``, its
header says what bounds it and how) runs all n_small steps for all B
ciphertexts in one launch: one block per ciphertext of one thread group
per CRT prime, the ciphertext's accumulator in shared memory from the
first step to the last, the Garner by the whole block from the groups'
residues.  Where ``ops.fused_latency`` spends a cluster of P (k+1)
blocks on a ciphertext to cut a lookup's latency, this form spends one
block, for a batch's throughput.  Its plain version is ``ops.fused_ntt``'s
three-kernel scan on the plain versions of kernels 1, 3 and 4
(``ops.fused_ntt.scan_plain``, which ``ops.fused_latency`` shares), which
gives the same bits.

``plan`` is the kernel's shape limit (its ``make_plan``): k+1 = 2, N =
2048, 1 to 3 primes (P N/16 threads a block, each at 168 registers: no
more fit an SM's register file), both accumulator modes.
``ops.fused_ntt.blind_rotate_form`` is the rule that routes a blind
rotate here: where ``ops.fused_latency``'s rule does not take it (B >
``LATENCY_BATCH_MAX``, or its plan refuses the shape) and ``plan`` does;
any other shape keeps ``ops.fused_ntt.scan_steps``'s loop.
``blind_rotate_crt_scan`` launches the kernel on CUDA tensors, raises at a
shape ``plan`` refuses, and runs the plain version on CPU ones; there is
no other fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from concrete_tpu_torch.ops import fused_ntt as fn

NAME = "blind_rotate_crt_scan"
#: csrc/blind_rotate_crt_scan.cu's constants
MAX_SMEM = 227 * 1024           # shared memory per block, H100 (opt-in)
MAX_PRIMES = 3                  # thread groups a block
KP1 = 2                         # output components, both in registers
LOG_N = 11                      # the transform size it is compiled for
E = 16                          # residues a thread holds in a transform


@dataclasses.dataclass(frozen=True)
class Plan:
    """One block per ciphertext of P groups of N/16 threads, `threads` in
    all; shared memory `smem`: the accumulator ((k+1) N words of 4 or 8
    bytes), then, at `off_exch`, a pair of N-word exchange buffers a
    group, which hold its prime's residues after each step's last
    exchange."""
    threads: int
    off_exch: int
    smem: int


def plan(batch: int, n: int, kp1: int, levels: int, n_primes: int,
         acc32: bool) -> Plan | None:
    """The kernel's plan at B ciphertexts, N, k+1, l, P primes and the
    accumulator mode, or None where it does not run (the kernel's
    make_plan computes the same)."""
    if not (batch >= 1 and n == 1 << LOG_N and kp1 == KP1 and levels >= 1
            and 1 <= n_primes <= MAX_PRIMES):
        return None
    off_exch = kp1 * n * (4 if acc32 else 8)
    smem = off_exch + n_primes * 2 * n * 4
    if smem > MAX_SMEM:
        return None
    return Plan(threads=n_primes * n // E, off_exch=off_exch, smem=smem)


def blind_rotate_crt_scan_plain(a_t: torch.Tensor, acc: torch.Tensor,
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


def blind_rotate_crt_scan(a_t: torch.Tensor, acc: torch.Tensor,
                          spec_val: torch.Tensor, spec_sh: torch.Tensor, *,
                          primes: tuple, trunc_bits: int, base_log: int,
                          levels: int) -> torch.Tensor:
    """a_t (B, n_small) int32 switched mask, acc (B, k+1, N) first
    accumulator, int32 top words (the acc32 mode) or int64, spec_val and
    spec_sh a FusedBSK's spectra and companions (n_small, P Cin (k+1), N)
    int32 -> the accumulator after n_small steps, into `acc` in place; on
    the card one launch (counted in ``_build.LAUNCHES[NAME]``)."""
    kw = dict(primes=primes, trunc_bits=trunc_bits, base_log=base_log,
              levels=levels)
    if acc.device.type == "cpu":
        return acc.copy_(blind_rotate_crt_scan_plain(
            a_t, acc, spec_val, spec_sh, **kw))
    return fn.launch_scan(NAME, plan, a_t, acc, spec_val, spec_sh, **kw)
