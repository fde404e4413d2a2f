"""Which blind rotate a keyset packs for: banded or fused CRT-NTT.

A copy of the decision rule of the JAX package's
``concrete_tpu/optimizer/v0.py`` (``fused_ntt_preferred`` with the cost
functions it reads, :97-255).  The rate constants and op counts below are
the JAX package's TPU calibration (v5e MAC and vector-instruction rates,
the round-5 kernel's op counts).  They are kept only so that the port packs
the same BSK form as the reference for every parameter set, which keeps the
two packages' outputs comparable bit for bit; they make no claim about the
H100, whose kernel times are in PERF.md.

``CONCRETE_TPU_FUSED_NTT=0`` forces the banded form and ``=1`` the fused
form, as in the JAX package's ``Keys.evaluation_for``.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from concrete_tpu_torch import params as pp
from concrete_tpu_torch.core import limbs as lb

#: the JAX package's TPU calibration (see the module docstring)
BANDED_FUSEDDOT_PENALTY = 2.29
BANDED_MAC_RATE = 184e12
FUSED_VPU_RATE = 1.77e9
FUSED_NTT_MAX_POLY_SIZE = 16384


def cost_pbs_macs(n, k: int, big_n: int, br_l: int, br_b: int,
                  precision: int = None, p_error: float = 6.3e-5):
    """The JAX package's modeled int8 MACs of one banded blind rotate,
    with its noise-aware BSK limb truncation and slab-size penalty."""
    a_limbs = lb.num_digit_limbs(br_b)
    keep = 8
    if precision is not None:
        budget = pp.safe_variance_bound(precision, p_error) * 0.05
        for t in range(1, 7):
            v = pp.variance_bsk_limb_truncation(int(np.max(n)), k, big_n,
                                                br_b, br_l, t)
            if v <= budget:
                keep = 8 - t
            else:
                break
    macs = n * float((k + 1) * br_l * (k + 1) * a_limbs * keep) * big_n ** 2
    k_dim = a_limbs * br_l * (k + 1) * big_n
    if big_n % 128 or k_dim * keep > 8192 * 4:
        macs = macs * BANDED_FUSEDDOT_PENALTY
    return macs


@functools.lru_cache(maxsize=None)
def _fused_ntt_plan(k: int, big_n: int, br_l: int, br_b: int, n_rep: int,
                    precision: int):
    """(n_primes, trunc_bits) the fused packer would choose."""
    from concrete_tpu_torch.core.ntt import choose_fused_primes
    params = pp.CryptoParams(
        n_small=n_rep, glwe_dimension=k, polynomial_size=big_n,
        pbs_level=br_l, pbs_base_log=br_b, ks_level=1, ks_base_log=2,
        lwe_std=math.sqrt(pp.minimal_variance_lwe(n_rep, 128)),
        glwe_std=math.sqrt(pp.minimal_variance_glwe(k, big_n, 128)),
        security_level=0)
    primes, t = choose_fused_primes(params, message_bits=precision)
    return len(primes), t


def _fused_vpu_ops_per_coef(n_p: int, br_l: int, kp1: int, dl: int,
                            log2n: int, acc32: bool) -> float:
    """The JAX package's per-phase op counts of its TPU fused kernel."""
    rot = kp1 * (2 * log2n + (12 if acc32 else 22))
    fwd = n_p * br_l * kp1 * (78 + 3 * dl)
    pw = n_p * br_l * kp1 * kp1 * 15
    inv = n_p * kp1 * 96
    gar = n_p * kp1 * 30 + kp1 * 25
    return float(rot + fwd + pw + inv + gar)


def cost_pbs_macs_fused_ntt(n, k: int, big_n: int, br_l: int, br_b: int,
                            precision: int = None,
                            p_error: float = 6.3e-5):
    """The JAX package's modeled cost of one fused blind rotate, in
    banded MAC units."""
    n = np.asarray(n, dtype=np.float64)
    if big_n % 128 or big_n // 128 < 8 or big_n > FUSED_NTT_MAX_POLY_SIZE:
        return np.full_like(n, math.inf)
    dl = max(1, -(-(br_b + 1) // 8))
    kp1 = k + 1
    n_rep = int(np.max(n))
    n_p, _ = _fused_ntt_plan(k, big_n, br_l, br_b, n_rep,
                             precision if precision is not None else 8)
    acc32 = br_l * br_b <= 31
    ops = _fused_vpu_ops_per_coef(n_p, br_l, kp1, dl,
                                  int(math.log2(big_n)), acc32)
    time_per_step_row = big_n * ops / (1024.0 * FUSED_VPU_RATE)
    return n * (time_per_step_row * BANDED_MAC_RATE)


def fused_ntt_preferred(params, message_bits: int = None) -> bool:
    """True where the JAX package packs a FusedBSK for these parameters."""
    n = np.array([params.n_small], dtype=np.float64)
    c_b = cost_pbs_macs(n, params.glwe_dimension, params.polynomial_size,
                        params.pbs_level, params.pbs_base_log,
                        precision=message_bits)
    c_n = cost_pbs_macs_fused_ntt(
        n, params.glwe_dimension, params.polynomial_size,
        params.pbs_level, params.pbs_base_log, precision=message_bits)
    return bool(c_n[0] < c_b[0])


def use_fused(params, message_bits: int = None) -> bool:
    """The BSK form to pack: the environment override, else the rule."""
    forced = os.environ.get("CONCRETE_TPU_FUSED_NTT")
    if forced is not None:
        return forced == "1"
    return fused_ntt_preferred(params, message_bits)
