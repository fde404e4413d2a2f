"""V0 parameter optimizer: pick crypto parameters for the KS->BR atomic
pattern given (precision, norm2) under a p_error constraint.

A copy of ``concrete_tpu/optimizer/v0.py``, the JAX package's
re-implementation of the reference optimizer's atomic-pattern search
(compilers/concrete-optimizer/concrete-optimizer/src/optimization/
atomic_pattern.rs and dag/solo_key/optimize.rs:405): the same noise model
(``params``), the same feasibility predicate, the same candidate order and
tie-breaks, so that both packages choose the same ``CryptoParams`` and the
same BSK form (``fused_ntt_preferred``) for every circuit.

**The cost model is the JAX package's, not the H100's.**  The rate
constants and op counts below (``BANDED_MAC_RATE``, ``FUSED_VPU_RATE``,
``BANDED_FUSEDDOT_PENALTY``, ``_fused_vpu_ops_per_coef``) are its TPU
calibration (v5e MAC and vector-instruction rates, the round-5 kernel's op
counts).  They are kept only so that the search and the BSK-form rule pick
what the reference picks, which keeps the two packages' outputs comparable
bit for bit; they make no claim about the H100, whose kernel times are in
PERF.md.  A cost model measured on the card would change both packages
together (ROADMAP).

``CONCRETE_TPU_FUSED_NTT=0`` forces the banded form and ``=1`` the fused
form, as in the JAX package's ``Keys.evaluation_for`` (``use_fused``).

WoP-PBS gadget selection (``choose_wop_gadgets``) returns the port's
``core/wop.WopParams``.

Vectorized numpy search over (k, logN, n, br, ks); milliseconds per query,
lru-cached.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from concrete_tpu_torch import params as pp
from concrete_tpu_torch.core import limbs as lb
# the port's params module holds these two (choose_truncate_limbs needs
# them); the search reads them from here, as in the JAX package
from concrete_tpu_torch.params import (kappa_of_p_error,  # noqa: F401
                                       safe_variance_bound)


def pattern_variance(params: "pp.CryptoParams", pattern: tuple,
                     ks_ms_weight: float = 1.0) -> float:
    """Achieved decision variance of one (precision, in_sq, lut_sq) atomic
    pattern under concrete `params` — mirrors the optimizer's feasibility
    expression (i_sq * var_bsk + l_sq * v_br + w * (v_ks + v_ms)), so the
    achieved per-PBS p_error of a solution can be computed after the fact
    (the reference reads it off DagSolution.p_error; we recompute).

    ks_ms_weight mirrors the solver's noise-only handling: native TLU
    input patterns pay the full keyswitch + modulus-switch noise (1.0);
    noise-only patterns (WoP inputs, output decodes) pay 4^-p of it."""
    _p, i_sq, l_sq = pattern
    var_bsk = params.glwe_std ** 2
    var_lwe = params.lwe_std ** 2
    n_big = params.glwe_dimension * params.polynomial_size
    v_br = params.n_small * pp.variance_external_product(
        params.glwe_dimension, params.polynomial_size,
        params.pbs_base_log, params.pbs_level, var_bsk)
    v_ks = pp.variance_keyswitch(n_big, params.ks_base_log,
                                 params.ks_level, var_lwe)
    v_ms = pp.variance_modulus_switch(params.n_small,
                                      params.log2_polynomial_size)
    return i_sq * var_bsk + l_sq * v_br + ks_ms_weight * (v_ks + v_ms)


def p_error_of_variance(precision: int, variance: float) -> float:
    """Gaussian decision-failure probability at the 2-padding-bit margin
    (inverse of safe_variance_bound)."""
    margin = 2.0 ** (-(precision + 2))
    return math.erfc(margin / math.sqrt(2.0 * variance))


def achieved_p_error(params: "pp.CryptoParams", patterns,
                     noise_only=()) -> float:
    """Worst achieved per-decision p_error across atomic patterns under
    params.  `noise_only` patterns (WoP TLU inputs, output decodes —
    widths.tlu_pattern_split's wide_in) are decision points too: their
    decode risk must enter the global-p_error calibration even though
    they carry no KS/MS (round-5 regression fix — moving the output
    patterns out of `native` silently removed the v_br-dominated output
    decode from the achieved computation)."""
    pats = [_normalize_pattern(pt) for pt in patterns]
    nops = [_normalize_pattern(pt) for pt in noise_only]
    vals = [p_error_of_variance(p, pattern_variance(params, (p, i, s)))
            for p, i, s in pats]
    vals += [p_error_of_variance(
        p, pattern_variance(params, (p, i, s), ks_ms_weight=4.0 ** -p))
        for p, i, s in nops]
    return max(vals)


#: (the JAX package's TPU calibration, see the module docstring)
#: throughput penalty of the banded step when the single-slab
#: dot+recombine kernel is NOT eligible (K*keep exceeds one VMEM rhs
#: slab: the fuseddot fallback round-trips its int32 planes through
#: HBM).  Calibrated at the measured 5-bit N=2048 point (banded 520.4
#: PBS/s vs 1190 modeled at full rate, round 5); the same factor
#: reproduces the measured 6-bit N=4096 banded rate (73-82 vs 148
#: modeled).
BANDED_FUSEDDOT_PENALTY = 2.29


def cost_pbs_macs(n, k: int, big_n: int, br_l: int, br_b: int,
                  precision: int = None, p_error: float = 6.3e-5):
    """int8 MACs of one PBS blind rotate with the banded-matmul kernel.

    When `precision` is given, the cost accounts for noise-budget-aware BSK
    limb truncation (kept weight limb planes = 8 - t_max): small gadget
    bases tolerate deep truncation, which is why the optimizer prefers them
    on the TPU the model was calibrated for (see
    params.choose_truncate_limbs).

    Shapes whose (K, keep*128) rhs slab exceeds the dot+recombine
    kernel's VMEM budget (kernels._blind_rotate_pallas's
    k_dim*keep <= 8192*4 gate) fall back to the HBM-round-tripping
    fuseddot path and pay BANDED_FUSEDDOT_PENALTY on the effective MAC
    rate — without this regime term the model predicted banded wins at
    N=2048 where the hardware measures the fused NTT ahead
    (tests/test_dispatch_calibration.py)."""
    a_limbs = lb.num_digit_limbs(br_b)
    keep = 8
    if precision is not None:
        budget = safe_variance_bound(precision, p_error) * 0.05
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


def cost_ks_macs(n_big: int, n_small, ks_l: int, ks_b: int):
    a_limbs = lb.num_digit_limbs(ks_b)
    return float(n_big) * ks_l * a_limbs * 8 * (n_small + 1)


#: (the JAX package's TPU calibration, see the module docstring)
#: sustained int8 MAC rate of the banded path's production dot
#: (hardware-measured in the round-5 hi-only kernel: 184 Tmac/s = 93% of
#: v5e's 197 Tmac/s int8 peak).  The banded cost model counts MACs, so
#: this is the time scale its unit carries.
BANDED_MAC_RATE = 184e12

#: (the JAX package's TPU calibration, see the module docstring)
#: effective vreg-instruction rate of the fused CRT-NTT kernel (the
#: kernel is VPU-instruction-bound — round-4 ablations measured MXU ~11%
#: busy), calibrated so _fused_vpu_ops_per_coef reproduces the measured
#: 6-bit N=4096 acc32 point (317.8 PBS/s, BENCH round 5).  The raw VPU
#: instruction rate probes at ~2.4e9 vreg-instr/s; the effective rate is lower
#: because DMA/MXU phases overlap imperfectly.
FUSED_VPU_RATE = 1.77e9

#: largest polynomial size the fused-NTT cost model offers the search:
#: N=1024..16384 are covered by interpret-mode bit-exactness tests
#: (tests/test_fused_ntt.py, incl. the n1=128 N=16384 tables) and
#: N=2048/4096 by hardware runs.
FUSED_NTT_MAX_POLY_SIZE = 16384


@functools.lru_cache(maxsize=None)
def _fused_ntt_plan(k: int, big_n: int, br_l: int, br_b: int, n_rep: int,
                    precision: int):
    """(n_primes, trunc_bits) the fused-NTT packer would choose for these
    macro parameters (the cost model's mirror of the port's
    core/ntt.choose_fused_primes; n_rep is a representative
    n_small for the truncation-noise budget check)."""
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
    """The JAX package's modeled VPU vreg-op count per output coefficient
    per scan step of its TPU fused CRT-NTT kernel — that kernel's real
    resource (it is VPU-instruction-bound; MXU MACs are ~11%-busy
    background).  Per-phase
    weights are the hand op counts of the round-5 kernel (RESULTS.md):

    - rotate/digits/update: 2 ops per roll stage (roll + select) on each
      accumulator plane + negate/diff/decompose glue; the hi-only (acc32)
      mode runs one u32 plane instead of the (lo, hi) pair;
    - forward per (prime, level, component): stage-1 pair assembly +
      pair-twiddle (2 lazy Shoup muls) + biased limb split + stage-2
      combine (~78 ops, + 3 per digit limb);
    - pointwise per (prime, level, comp_in, comp_out): one lazy Shoup
      multiply + lazy add (~15);
    - inverse per (prime, component): limb splits + idft2 pair-twiddle +
      table-LHS combine (~96);
    - Garner per (prime, component): ~30, plus ~25 shared k-estimate /
      k*P / accumulate ops."""
    rot = kp1 * (2 * log2n + (12 if acc32 else 22))
    fwd = n_p * br_l * kp1 * (78 + 3 * dl)
    pw = n_p * br_l * kp1 * kp1 * 15
    inv = n_p * kp1 * 96
    gar = n_p * kp1 * 30 + kp1 * 25
    return float(rot + fwd + pw + inv + gar)


def cost_pbs_macs_fused_ntt(n, k: int, big_n: int, br_l: int, br_b: int,
                            precision: int = None,
                            p_error: float = 6.3e-5):
    """The JAX package's modeled cost of one PBS blind rotate with its
    TPU fused CRT-NTT kernel (concrete_tpu/ops/pallas_fused_ntt.py),
    expressed in banded-dot MAC units so min(banded, fused) compares on
    TIME: the fused kernel is VPU-instruction-bound, so its time is
    n_small * N * ops_per_coef / (1024 lanes * FUSED_VPU_RATE), converted
    at BANDED_MAC_RATE.  Replaces the round-4 single-scalar
    FUSED_NTT_MAC_EFFICIENCY=0.2 (one hardware point, MAC-proportional —
    wrong scaling in n_p/l/dl) with the structured VPU-op model
    calibrated at the measured 6-bit N=4096 point and validated against
    the measured banded-vs-fused winners at N=1024/2048/4096
    (tests/test_dispatch_calibration.py)."""
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


def fused_ntt_preferred(params: "pp.CryptoParams",
                        message_bits: int = None) -> bool:
    """True when the fused CRT-NTT blind rotate is modeled cheaper than
    the banded path for these parameters — the SAME comparison the
    optimizer's search uses, so compile-time parameter choice and
    runtime kernel dispatch stay consistent (keys.py evaluation())."""
    n = np.array([params.n_small], dtype=np.float64)
    c_b = cost_pbs_macs(n, params.glwe_dimension, params.polynomial_size,
                        params.pbs_level, params.pbs_base_log,
                        precision=message_bits)
    c_n = cost_pbs_macs_fused_ntt(
        n, params.glwe_dimension, params.polynomial_size,
        params.pbs_level, params.pbs_base_log, precision=message_bits)
    return bool(c_n[0] < c_b[0])


def optimize_v0(precision: int, norm2: int = 1, p_error: float = 6.3e-5,
                security_level: int = 128) -> pp.CryptoParams:
    """Minimal-cost feasible CryptoParams for (precision, norm2, p_error)."""
    return optimize_v0_multi(((precision, norm2),), p_error=p_error,
                             security_level=security_level)


def _normalize_pattern(pat) -> tuple[int, float, float]:
    """Pattern -> (p, in_sq, lut_sq): squared noise coefficients on the
    fresh-encryption variance and the blind-rotate output variance.

    Legacy (p, norm2) pairs put the whole (squared) amplification on the
    BR variance — conservative, since v_fresh <= v_br for every candidate.
    Triples come from Graph.variance_pairs() (reference
    dag/solo_key/analyze.rs SymbolicVariance) and are exact.
    """
    if len(pat) == 2:
        p, n2 = pat
        return (int(p), 0.0, float(n2) ** 2)
    p, in_sq, lut_sq = pat
    return (int(p), float(in_sq), float(lut_sq))


def pareto_patterns(patterns) -> tuple[tuple[int, float, float], ...]:
    """Normalize patterns to (p, in_sq, lut_sq) and drop those dominated by
    another (all components smaller-or-equal): a dominated pattern's
    feasibility constraint is implied."""
    pats = sorted(set(_normalize_pattern(p) for p in patterns))
    keep = []
    for t in pats:
        if not any(all(b >= a for a, b in zip(t, u)) and u != t
                   for u in pats):
            keep.append(t)
    return tuple(keep)


#: deep WoP gadget used as the feasibility probe inside the base search:
#: if the WoP output constraint fails with THIS gadget, no gadget fixes it
#: (choose_wop_gadgets later picks the *cheapest* feasible one).
_WOP_PROBE_CBS = (12, 3)     # (level, base_log)
_WOP_PROBE_PFKS = (10, 4)


@functools.lru_cache(maxsize=None)
def optimize_v0_multi(patterns: tuple, p_error: float = 6.3e-5,
                      security_level: int = 128,
                      noise_only: tuple = (),
                      wop_patterns: tuple = (),
                      frontier: tuple = (),
                      ks_ms_caps: tuple = (),
                      restriction=None) -> pp.CryptoParams:
    """Minimal-cost CryptoParams feasible for EVERY (precision, norm2)
    atomic pattern simultaneously.

    The multi-precision analog of the reference's DAG-mono optimization
    (dag/solo_key/optimize.rs:405): each TLU and each output contributes a
    constraint  v_br*norm2_i^2 + v_ks + v_ms < safe_variance(p_i); params
    must satisfy the intersection, and cost is the per-PBS cost (identical
    across patterns under one keyset, so the cheapest feasible point wins).

    `noise_only` patterns constrain the noise like `patterns` but do NOT
    force a native LUT (no N >= 2^(p+1) requirement): they come from
    WoP-PBS TLU inputs.  Bit extraction shifts the value UP by 63-pos
    before its sign-PBS, so the accumulated noise v_br*norm2^2 must be
    decodable at width p, while the sign-PBS's own keyswitch/modswitch
    noise is added *after* the shift and compares to the quarter-torus
    margin — i.e. enters the constraint scaled by 4^-p.

    `wop_patterns` are (nb_bits, out_width, out_norm2) triples, one per
    WoP TLU: the vertical-packing output noise (driven by the base BR
    gadget through the circuit-bootstrap sign-PBS) must satisfy the
    consumers' decision margins.  Probed with the deep _WOP_PROBE gadget;
    the actual gadget is chosen afterwards by choose_wop_gadgets.

    `ks_ms_caps` are hard upper bounds on this partition's own
    (v_ks + v_ms): a partition that is the DESTINATION of a multi-partition
    crossing must leave headroom in the crossing's decision margin for the
    source partition's BR noise and the conversion keyswitch
    (compilation/multi.py reserves half the margin this way; without the
    reservation the destination's cost-minimal solution saturates the
    margin and the fixed-point iteration deadlocks infeasible).

    `frontier` patterns are (width, norm2, extra_var) triples from
    multi-partition crossings (compilation/multi.py): this partition's BR
    output crosses into another partition, so the decision constraint is
    v_br * norm2^2 + extra_var < safe_variance(width), where extra_var is
    the destination's conversion-keyswitch + keyswitch + modswitch noise
    (fixed w.r.t. this search).  No native-LUT N requirement.  The
    reference analog is the multi-parameter optimizer's cross-partition
    noise expressions (dag/multi_parameters/analyze.rs).
    """
    patterns = pareto_patterns(patterns)
    noise_only = pareto_patterns(noise_only) if noise_only else ()
    p_max = max(p for p, _, _ in patterns)
    all_patterns = patterns + noise_only
    safe_vars = [safe_variance_bound(p, p_error)
                 for p, _, _ in all_patterns]
    in_sqs = [i for _, i, _ in all_patterns]
    lut_sqs = [s for _, _, s in all_patterns]
    # weight of the (v_ks + v_ms) term per pattern (see noise_only above)
    ks_ms_w = [1.0] * len(patterns) + [4.0 ** -p
                                       for p, _, _ in noise_only]
    # the patterns' constraints as columns, checked against every n and
    # keyswitch gadget at once (the same float operations, in the same
    # order, as one pattern and one gadget at a time)
    sv_col = np.array(safe_vars, dtype=np.float64)[:, None]
    in_col = np.array(in_sqs, dtype=np.float64)[:, None]
    lut_col = np.array(lut_sqs, dtype=np.float64)[:, None]
    w_col = np.array(ks_ms_w, dtype=np.float64)[:, None]
    frontier_bounds = [safe_variance_bound(int(fp), p_error)
                       for fp, _, _ in frontier]
    # the BSK-truncation budget in the cost model must hold for every
    # pattern: use the tightest precision
    best = None
    best_cost = math.inf

    ns = np.arange(450, 1400, 2, dtype=np.float64)

    # Configuration.range_restriction (reference restriction.rs
    # RangeRestriction): empty axis = unrestricted
    def _allowed(values, axis):
        allowed = tuple(getattr(restriction, axis, ()) or ()) \
            if restriction is not None else ()
        if not allowed:
            return values
        return [v for v in values if (v[0] if isinstance(v, tuple) else v)
                in allowed]

    if restriction is not None and restriction.internal_lwe_dimensions:
        ns = np.array([n for n in ns
                       if int(n) in restriction.internal_lwe_dimensions],
                      dtype=np.float64)
        if ns.size == 0:
            ns = np.array(sorted(restriction.internal_lwe_dimensions),
                          dtype=np.float64)
    var_lwe = np.array([pp.minimal_variance_lwe(int(n), security_level)
                        for n in ns])

    ks_candidates = [(l, b) for l in (1, 2, 3, 4, 5, 6, 8)
                     for b in range(2, 9) if l * b <= 40]
    br_candidates = [(l, b) for l in (1, 2, 3, 4)
                     for b in range(5, 24) if l * b <= 53]
    if restriction is not None:
        ks_candidates = [
            (l, b) for l, b in ks_candidates
            if (not restriction.ks_level_count
                or l in restriction.ks_level_count)
            and (not restriction.ks_base_log
                 or b in restriction.ks_base_log)]
        br_candidates = [
            (l, b) for l, b in br_candidates
            if (not restriction.pbs_level_count
                or l in restriction.pbs_level_count)
            and (not restriction.pbs_base_log
                 or b in restriction.pbs_base_log)]

    log_ns = _allowed(list(range(8, 16)), "glwe_log_polynomial_sizes")
    ks_allowed = _allowed(list(range(1, 7)), "glwe_dimensions")
    for log_n in log_ns:
        big_n = 1 << log_n
        if big_n < (1 << (p_max + 1)):
            continue  # LUT mega-cases must be even: N >= 2^(p+1)
        v_ms = ((1.0 / 12.0 + ns / 24.0) / (2.0 ** (log_n + 1)) ** 2
                + (-1.0 / 12.0 + ns / 48.0) / 2.0 ** 128)
        if any(w * v_ms.min() > sv
               for sv, w in zip(safe_vars, ks_ms_w)):
            continue
        if ks_ms_caps and v_ms.min() >= min(ks_ms_caps):
            continue
        for k in ks_allowed:
            n_big = k * big_n
            if n_big > (1 << 17):
                continue
            var_bsk = pp.minimal_variance_glwe(k, big_n, security_level)
            # keyswitch variance and cost per candidate (rows) and n
            v_ks_all = np.stack([_variance_keyswitch_vec(
                n_big, ks_b, ks_l, var_lwe)
                for ks_l, ks_b in ks_candidates])
            v_ks_ms = v_ks_all + v_ms
            ks_costs = np.stack([cost_ks_macs(n_big, ns, ks_l, ks_b)
                                 for ks_l, ks_b in ks_candidates])
            for br_l, br_b in br_candidates:
                v_cmux = pp.variance_external_product(k, big_n, br_b, br_l,
                                                      var_bsk)
                v_br_unit = ns * v_cmux
                noise = in_col * var_bsk + lut_col * v_br_unit
                base_ok = (noise + w_col * v_ms < sv_col).all(axis=0)
                for (_, fn2, fextra), bound in zip(frontier,
                                                   frontier_bounds):
                    base_ok &= (v_br_unit * float(fn2) ** 2 + float(fextra)
                                < bound)
                if not base_ok.any():
                    continue
                # dispatch-aware cost: the runtime picks the cheaper of the
                # banded and fused-NTT blind rotates for the chosen
                # parameters (keys.py uses the SAME comparison via
                # fused_ntt_preferred), so the search minimizes the min
                c_br = np.minimum(
                    cost_pbs_macs(
                        ns, k, big_n, br_l, br_b,
                        precision=max(p for p, _, _ in all_patterns),
                        p_error=p_error),
                    cost_pbs_macs_fused_ntt(
                        ns, k, big_n, br_l, br_b,
                        precision=max(p for p, _, _ in all_patterns),
                        p_error=p_error))
                if c_br[base_ok].min() >= best_cost:
                    continue
                if wop_patterns:
                    # WoP output noise with the probe gadgets (vector in ns
                    # through the sign-PBS BR output variance v_br_unit)
                    cbs_l_p, cbs_b_p = _WOP_PROBE_CBS
                    pfks_l_p, pfks_b_p = _WOP_PROBE_PFKS
                    v_pfks = pp.variance_private_packing_keyswitch(
                        n_big, k, big_n, pfks_b_p, pfks_l_p, var_bsk)
                    v_ggsw = v_br_unit * 0.5 + v_pfks
                    # external product variance is affine in var_ggsw
                    ep0 = pp.variance_external_product(
                        k, big_n, cbs_b_p, cbs_l_p, 0.0)
                    ep1 = pp.variance_external_product(
                        k, big_n, cbs_b_p, cbs_l_p, 1.0) - ep0
                    wop_outs = [
                        (float(nb) * (ep1 * v_ggsw + ep0), float(n2o) ** 2,
                         safe_variance_bound(po, p_error))
                        for nb, po, n2o in wop_patterns]
                # (candidates, n): every keyswitch gadget at once
                feasible = base_ok & (
                    noise[:, None, :] + w_col[:, :, None] * v_ks_ms
                    < sv_col[:, :, None]).all(axis=0)
                for cap in ks_ms_caps:
                    feasible &= v_ks_ms < cap
                if wop_patterns:
                    for v_out, n2sq_o, sv_o in wop_outs:
                        feasible &= v_out * n2sq_o + v_ks_all + v_ms < sv_o
                if not feasible.any():
                    continue
                cost = np.where(feasible, c_br + ks_costs, math.inf)
                # the first least cost in the candidates' order, as the
                # candidate-by-candidate strict comparison keeps
                c_i, i = divmod(int(np.argmin(cost)), ns.size)
                if cost[c_i, i] < best_cost:
                    ks_l, ks_b = ks_candidates[c_i]
                    best_cost = float(cost[c_i, i])
                    best = pp.CryptoParams(
                        n_small=int(ns[i]), glwe_dimension=k,
                        polynomial_size=big_n, pbs_level=br_l,
                        pbs_base_log=br_b, ks_level=ks_l,
                        ks_base_log=ks_b,
                        lwe_std=math.sqrt(float(var_lwe[i])),
                        glwe_std=math.sqrt(var_bsk),
                        security_level=security_level)
    if best is None:
        raise ValueError(
            f"no feasible parameters for patterns={patterns}, "
            f"p_error={p_error}")
    return best


def _variance_keyswitch_vec(n_big: int, log2_base: int, level: int,
                            variance_ksk: np.ndarray) -> np.ndarray:
    """Vectorized reference keyswitch variance (params.variance_keyswitch)."""
    q_sq = 2.0 ** 128
    var_key = 0.25 / q_sq
    sq_exp = 0.25 / q_sq
    base = 2.0 ** log2_base
    b2l = 2.0 ** (2 * log2_base * level)
    res_2 = (q_sq / (12.0 * b2l) - 1.0 / 12.0) * (var_key + sq_exp)
    res_3 = 0.25 * var_key
    res_4 = level * variance_ksk * (base ** 2 + 2.0) / 12.0
    return n_big * (res_2 + res_3 + res_4)


# ---------------------------------------------------------------------------
# Partition-conversion ("fast") keyswitch gadget selection
# ---------------------------------------------------------------------------

def cost_fks_macs(n_big_src: int, n_big_dst: int, level: int,
                  base_log: int) -> float:
    """int8 MACs of one big->big conversion keyswitch application."""
    a_limbs = lb.num_digit_limbs(base_log)
    return float(n_big_src) * level * a_limbs * 8 * (n_big_dst + 1)


@functools.lru_cache(maxsize=None)
def choose_fks_raw(n_src: int, n_dst: int, dst_std: float,
                   budget: float) -> tuple[int, int, float]:
    """Cheapest (level, base_log, variance) for an n_src -> n_dst big-key
    conversion keyswitch with variance <= budget, on raw dimensions.

    THE single conversion-gadget search: multi-partition crossings
    (choose_fks) and the TFHE-rs bridge's external-partition KSKs
    (tfhers/bridge.py) both route through here — the reference analog is
    multi_parameters/optimize.rs's FKS decomposition search, which external
    partitions share (keys_spec.rs ConversionKeySwitchKey).
    """
    best = None
    best_cost = math.inf
    for level in (1, 2, 3, 4, 5, 6, 8, 10, 12):
        for base in range(2, 25):
            if level * base > 60:
                continue
            v = pp.variance_keyswitch(n_src, base, level, dst_std ** 2)
            if v > budget:
                continue
            cost = cost_fks_macs(n_src, n_dst, level, base)
            if cost < best_cost:
                best_cost = cost
                best = (level, base, float(v))
    if best is None:
        raise ValueError(
            f"no conversion keyswitch meets variance budget {budget:.3e} "
            f"for {n_src} -> {n_dst}")
    return best


def choose_fks(src: pp.CryptoParams, dst: pp.CryptoParams,
               budget: float) -> tuple[int, int, float]:
    """Cheapest (level, base_log, variance) for the src.big -> dst.big
    conversion keyswitch with variance <= budget.

    The multi-partition analog of the reference optimizer's fast-keyswitch
    parameter search (multi_parameters/optimize.rs FKS decomposition); key
    entries are encrypted under dst's big (GLWE) key, so their noise is
    dst.glwe_std.
    """
    return choose_fks_raw(src.n_big, dst.n_big, dst.glwe_std, budget)


# ---------------------------------------------------------------------------
# WoP-PBS gadget selection (the WoP atomic pattern)
# ---------------------------------------------------------------------------

def cost_wop_macs(params: pp.CryptoParams, nb_bits: int, cbs_level: int,
                  pfks_level: int, cbs_base_log: int = 0,
                  pfks_base_log: int = 0) -> float:
    """int8 MACs of one WoP-PBS TLU with our batched kernels.

    extract: ~2 sign-PBS per bit; CBS: cbs_level sign-PBS + one PFPKSK
    matmul per bit; vertical packing: nb CMUXes of the grouped limb conv.
    """
    p = params
    per_pbs = (cost_pbs_macs(p.n_small, p.glwe_dimension, p.polynomial_size,
                             p.pbs_level, p.pbs_base_log)
               + cost_ks_macs(p.n_big, p.n_small, p.ks_level, p.ks_base_log))
    n_sign_pbs = 2 * nb_bits - 1 + nb_bits * cbs_level
    a_pfks = lb.num_digit_limbs(pfks_base_log) if pfks_base_log else 1
    c_pfks = ((p.n_big + 1) * pfks_level
              * (p.glwe_dimension + 1) ** 2 * p.polynomial_size * 8 * a_pfks)
    kp1 = p.glwe_dimension + 1
    a_cbs = 2  # runtime conv uses 2 digit limbs
    c_cmux = (cbs_level * kp1 * kp1 * a_cbs * 8
              * float(p.polynomial_size) ** 2)
    return (n_sign_pbs * per_pbs + nb_bits * cbs_level * c_pfks
            + nb_bits * c_cmux)


@functools.lru_cache(maxsize=None)
def choose_wop_gadgets(params: pp.CryptoParams, nb_bits_max: int,
                       out_constraints: tuple, p_error: float = 6.3e-5):
    """Pick (cbs, pfks) gadget parameters for WoP-PBS on top of `params`.

    out_constraints: ((width, norm2), ...) decision points the WoP output
    noise must satisfy (its consumers' TLU inputs / circuit outputs):
    var_wop * norm2^2 + v_ks + v_ms < safe_variance(width).  Minimizes the
    kernel MAC cost.  The reference analog is the WoP atomic-pattern search
    (concrete-optimizer/src/optimization/wop_atomic_pattern/optimize.rs).
    """
    from concrete_tpu_torch.core.wop import WopParams
    out_constraints = pareto_patterns(out_constraints) or ((1, 0.0, 1.0),)
    v_fresh = params.glwe_std ** 2
    v_ks = pp.variance_keyswitch(params.n_big, params.ks_base_log,
                                 params.ks_level, params.lwe_std ** 2)
    v_ms = pp.variance_modulus_switch(params.n_small,
                                      params.log2_polynomial_size)
    best = None
    best_cost = math.inf
    for cbs_l in (1, 2, 3, 4, 5, 6, 8, 10, 12, 14):
        for cbs_b in range(2, 17):
            if cbs_l * cbs_b > 63:
                continue
            for pfks_l in (1, 2, 3, 4, 5, 6, 8, 10):
                for pfks_b in range(2, 11):
                    if pfks_l * pfks_b > 40:
                        continue
                    v_wop = pp.wop_output_variance(
                        params, nb_bits_max, cbs_b, cbs_l, pfks_b, pfks_l)
                    ok = all(
                        i_sq * v_fresh + l_sq * v_wop + v_ks + v_ms
                        < safe_variance_bound(w, p_error)
                        for w, i_sq, l_sq in out_constraints)
                    if not ok:
                        continue
                    cost = cost_wop_macs(params, nb_bits_max, cbs_l, pfks_l,
                                         cbs_b, pfks_b)
                    if cost < best_cost:
                        best_cost = cost
                        best = WopParams(base=params, cbs_level=cbs_l,
                                         cbs_base_log=cbs_b,
                                         pfks_level=pfks_l,
                                         pfks_base_log=pfks_b)
    if best is None:
        raise ValueError(
            f"no feasible WoP gadgets for nb_bits={nb_bits_max}, "
            f"constraints={out_constraints} on {params}")
    return best


def use_fused(params, message_bits: int = None) -> bool:
    """The BSK form to pack: the environment override, else the rule."""
    forced = os.environ.get("CONCRETE_TPU_FUSED_NTT")
    if forced is not None:
        return forced == "1"
    return fused_ntt_preferred(params, message_bits)
