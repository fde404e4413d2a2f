"""Multi-partition parameter planning (DAG_MULTI-lite).

A copy of the planner of ``concrete_tpu/compilation/multi.py``.  The
default ``Configuration()`` selects parameters with the MULTI strategy, so
every compile runs it: for a circuit whose cheapest grouping is mono it
returns None, and the compiler's mono search then chooses the JAX
package's parameters.  A multi-partition result is served by
``MultiKeys`` and the executor's multi mode, a WoP partition with the
gadgets the planner chooses here (``optimizer.v0.choose_wop_gadgets``).
Beyond the copy, ``decision_failures`` reads the noise model at every
decision point of a compiled circuit under its compiled parameters.

The reference optimizer's PRECISION cut (concrete-optimizer/src/optimization/
dag/multi_parameters/partitionning.rs): circuit values are grouped into
partitions by precision, each partition gets its own crypto parameters and
keyset, and conversion keyswitch keys carry values across partition
frontiers (keys_spec.rs ConversionKeySwitchKey).

Here the partition of a value IS its encoding width (compilation/widths.py
assigns per-class widths; classes of equal width share parameters, so the
width is the partition key).  A TLU runs its KS->BR entirely inside its
*input* class's partition; when its output class lives in a different
partition, a big->big "fast" conversion keyswitch (optimizer.choose_fks)
moves the fresh ciphertext across the frontier — the same shape as the
reference's FKS edges in the multi-parameter noise model
(dag/multi_parameters/analyze.rs).

Parameter search: each partition is optimized independently with
optimize_v0_multi on its own atomic patterns, plus `frontier` constraints
for crossings (v_br(src) * norm2^2 + v_fks + v_ks(dst) + v_ms(dst) <
safe_variance(width)); since the frontier extra-variance depends on the
other partition's parameters, the solve iterates to a fixed point (2-3
rounds in practice) and ends with an exact feasibility assertion.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from concrete_tpu_torch import params as pp
from concrete_tpu_torch.compilation.widths import (MAX_NATIVE_TLU_BITS,
                                                   TLU_OPS,
                                                   decision_constraints_split,
                                                   encoding_width, part_width,
                                                   partition_of,
                                                   tlu_effective_input_width,
                                                   tlu_input_partition,
                                                   wop_nb_bits)
from concrete_tpu_torch.representation.graph import norm2_of_manp
from concrete_tpu_torch.optimizer.v0 import (choose_fks, optimize_v0_multi,
                                             safe_variance_bound)
from concrete_tpu_torch.representation import Graph


@dataclasses.dataclass
class Crossing:
    """A partition frontier: a PBS in partition `src` whose output value
    lives in partition `dst`, with the downstream decision constraints
    (width, norm2) its noise must satisfy after conversion.  src_wop_nb
    is the bit count when the source PBS is a WoP TLU (whose fresh noise
    is the vertical-packing variance, not one blind rotate), else 0.

    `tlu_constraints` is the subset of `constraints` whose decision is a
    destination TLU input (margin shared with the destination's KS+MS);
    the rest are output decodes, which see no KS/MS at all
    (widths.decision_constraints_split)."""
    src: int
    dst: int
    constraints: tuple  # ((width, norm2), ...)
    src_wop_nb: int = 0
    tlu_constraints: tuple = ()


@dataclasses.dataclass
class PartitionPatterns:
    native: list
    wide_in: list
    wop: list
    max_norm2: float = 1.0   # linear 2-norm (sqrt of the MANP accumulation)


@dataclasses.dataclass
class PartitionPlan:
    """The compiled multi-partition parameter solution."""
    params: dict  # width -> CryptoParams
    wop_gadgets: dict  # width -> (cbs_l, cbs_b, pfks_l, pfks_b) or absent
    fks: dict  # (src_width, dst_width) -> (level, base_log)
    norm2: dict  # width -> max norm2 (BSK truncation budgeting)
    #: width -> tuple of native (p, in_sq, lut_sq) atomic patterns the
    #: partition was solved against — lets the caller recompute ACHIEVED
    #: per-PBS p_error after the fact (global-p_error calibration)
    patterns: dict = dataclasses.field(default_factory=dict)
    #: width -> tuple of noise-only (p, in_sq, lut_sq) patterns (WoP
    #: inputs, output decodes) — decision points for the achieved-error
    #: computation that carry no KS/MS
    noise_patterns: dict = dataclasses.field(default_factory=dict)
    #: (src, dst) -> worst achieved p_error across the crossing's decision
    #: constraints under the final parameters (computed in the exact
    #: feasibility check)
    crossing_p_error: dict = dataclasses.field(default_factory=dict)

    @property
    def widths(self):
        return sorted(self.params)


def partition_pattern_split(graph: Graph):
    """Group the graph's PBS constraints by partition id.

    Returns (patterns: {pid: PartitionPatterns}, crossings: [Crossing]).
    Same constraint semantics as widths.tlu_pattern_split, but keyed by the
    partition each PBS runs in.  Partition ids come from
    widths.partition_of: the encoding width under the PRECISION cut, or
    synthetic (width, norm2-bucket) ids when assign_norm2_partitions ran
    (the PRECISION_AND_NORM2 cut).
    """
    pairs, bpairs = graph.variance_pairs()
    manp = {n: max(c[0] + c[1], 1) for n, c in pairs.items()}
    boundary = {n: max(c[0] + c[1], 1) for n, c in bpairs.items()}
    default = graph.max_bit_width
    patterns: dict[int, PartitionPatterns] = {}
    crossings: list[Crossing] = []

    def part(w: int) -> PartitionPatterns:
        if w not in patterns:
            patterns[w] = PartitionPatterns([], [], [])
        return patterns[w]

    for node in graph.topological_order():
        if node.name not in TLU_OPS:
            continue
        preds = [p for p in graph.ordered_preds_of(node)
                 if p.output.is_encrypted]
        if not preds:
            continue
        w_in = tlu_input_partition(graph, node, default)
        w_out = partition_of(node, default)
        p_eff = tlu_effective_input_width(graph, node, default)
        n2 = norm2_of_manp(boundary.get(node, 1))
        in_c, lut_c = bpairs.get(node, (0, 1))
        pt = part(w_in)
        pt.max_norm2 = max(pt.max_norm2, n2)
        if node.name == "extract_bits":
            pt.wide_in.append((p_eff, in_c, lut_c))
        elif p_eff > MAX_NATIVE_TLU_BITS:
            pt.wide_in.append((p_eff, in_c, lut_c))
            nb = wop_nb_bits(graph, node, default)
            tl, dc = decision_constraints_split(
                graph, node, default, (manp, boundary))
            for w, n2o in tl + dc:
                pt.wop.append((nb, w, n2o))
        else:
            pt.native.append((p_eff, in_c, lut_c))
        if w_out != w_in:
            tlu_cons, dec_cons = decision_constraints_split(
                graph, node, default, (manp, boundary))
            # extract_bits never lowers to WoP-PBS (its source noise is a
            # sign-PBS output, mirroring tlu_pattern_split's wide_in-only
            # treatment), so only genuine wide TLUs tag the crossing
            crossings.append(Crossing(
                src=w_in, dst=w_out,
                constraints=tuple(tlu_cons) + tuple(dec_cons),
                src_wop_nb=wop_nb_bits(graph, node, default)
                if (p_eff > MAX_NATIVE_TLU_BITS
                    and node.name != "extract_bits") else 0,
                tlu_constraints=tuple(tlu_cons)))
    for node in graph.ordered_outputs:
        if node.output.is_encrypted:
            pid = partition_of(node, default)
            w = encoding_width(node, default)
            n2 = norm2_of_manp(manp.get(node, 1))
            in_c, lut_c = pairs.get(node, (0, 1))
            if (in_c, lut_c) == (0, 0):
                in_c = 1
            pt = part(pid)
            # outputs only need decodable noise at their width: no
            # native-LUT N >= 2^(w+1) requirement and no v_ks/v_ms term
            # (widths.tlu_pattern_split has the full rationale — the
            # round-5 MULTI bench's output-only 7-bit partition was
            # escalated to N=16384 by the old native classification)
            pt.wide_in.append((w, in_c, lut_c))
            pt.max_norm2 = max(pt.max_norm2, n2)
    # encrypted inputs whose partition has no PBS still need params (for
    # encryption + leveled ops + decode at the consumer's frontier)
    for node in graph.ordered_inputs:
        if node.output.is_encrypted:
            part(partition_of(node, default))
    for pt in patterns.values():
        if not pt.native:
            pt.native.append((1, 1))
    return patterns, crossings


def _partition_noise(params: pp.CryptoParams):
    """(v_br, v_ks, v_ms) of one partition's atomic pattern stages."""
    v_br = pp.variance_blind_rotate(
        params.n_small, params.glwe_dimension, params.polynomial_size,
        params.pbs_base_log, params.pbs_level, params.glwe_std ** 2)
    v_ks = pp.variance_keyswitch(params.n_big, params.ks_base_log,
                                 params.ks_level, params.lwe_std ** 2)
    v_ms = pp.variance_modulus_switch(params.n_small,
                                      params.log2_polynomial_size)
    return v_br, v_ks, v_ms


def _solve_plan(patterns: dict, crossings: list, p_error: float,
                security_level: int, max_iterations: int,
                restriction) -> PartitionPlan:
    """Fixed-point parameter solve for one partition grouping."""
    # A crossing's TLU decision margin sv(p) is shared by three stages:
    # src BR (after the n2 dot), the conversion keyswitch, and the dst's
    # own KS+MS.  Reserve it up front — half for the destination's KS+MS,
    # a quarter for the FKS — or the destination's cost-minimal solution
    # saturates the margin and the source solve becomes infeasible.
    # DECODE decisions (circuit outputs) see no destination KS/MS at all
    # — reserving for them forced every output-only destination partition
    # to giant parameters (the round-5 MULTI bench's N=16384 partition).
    caps_by_w: dict[int, list] = {}
    for c in crossings:
        caps_by_w.setdefault(c.dst, []).extend(
            0.5 * safe_variance_bound(p, p_error)
            for p, _ in c.tlu_constraints)

    def solve(frontier_by_w: dict):
        out = {}
        for w, pt in patterns.items():
            out[w] = optimize_v0_multi(
                tuple(pt.native), p_error=p_error,
                security_level=security_level,
                noise_only=tuple(pt.wide_in),
                wop_patterns=tuple(pt.wop),
                frontier=tuple(frontier_by_w.get(w, ())),
                ks_ms_caps=tuple(sorted(caps_by_w.get(w, ()))[:1]),
                restriction=restriction)
        return out

    params = solve({})
    fks: dict[tuple, tuple] = {}
    for _ in range(max_iterations):
        # pick conversion gadgets against the current destination params:
        # the FKS may consume at most 1/8 of the tightest decision budget
        # downstream of each crossing
        budgets: dict[tuple, float] = {}
        for c in crossings:
            key = (c.src, c.dst)
            b = min(safe_variance_bound(p, p_error) / float(n2) ** 2
                    for p, n2 in c.constraints) / 4.0
            budgets[key] = min(budgets.get(key, b), b)
        fks = {}
        fks_var: dict[tuple, float] = {}
        for (src, dst), budget in budgets.items():
            lvl, base, var = choose_fks(params[src], params[dst], budget)
            fks[(src, dst)] = (lvl, base)
            fks_var[(src, dst)] = var
        # frontier constraints for the next solve round: TLU decisions in
        # the destination pay its KS+MS; decode decisions only the FKS
        frontier_by_w: dict[int, list] = {}
        for c in crossings:
            _, v_ks_d, v_ms_d = _partition_noise(params[c.dst])
            v_f = fks_var[(c.src, c.dst)]
            tlu_set = set(c.tlu_constraints)
            frontier_by_w.setdefault(c.src, []).extend(
                (p, n2, v_f * float(n2) ** 2
                 + ((v_ks_d + v_ms_d) if (p, n2) in tlu_set else 0.0))
                for p, n2 in c.constraints)
        new_params = solve(frontier_by_w)
        if new_params == params:
            break
        params = new_params

    wop_gadgets = {}
    for w, pt in patterns.items():
        wop_cons = list(pt.wop)
        # crossings sourced at this partition's WoP TLUs constrain the
        # gadget choice too (conservatively, without the dst extras — the
        # exact check below raises if the margin is actually violated)
        for c in crossings:
            if c.src == w and c.src_wop_nb:
                wop_cons.extend((c.src_wop_nb, p, n2)
                                for p, n2 in c.constraints)
        if wop_cons:
            from concrete_tpu_torch.optimizer.v0 import choose_wop_gadgets
            nb_max = max(nb for nb, _, _ in wop_cons)
            cons = tuple(sorted({(p, n2) for _, p, n2 in wop_cons}))
            wp = choose_wop_gadgets(params[w], nb_max, cons, p_error=p_error)
            wop_gadgets[w] = (wp.cbs_level, wp.cbs_base_log,
                              wp.pfks_level, wp.pfks_base_log)

    # exact feasibility check of every crossing with the final parameters
    from concrete_tpu_torch.optimizer.v0 import p_error_of_variance
    crossing_pe: dict[tuple, float] = {}
    for c in crossings:
        if c.src_wop_nb and c.src in wop_gadgets:
            cbs_l, cbs_b, pfks_l, pfks_b = wop_gadgets[c.src]
            v_src = pp.wop_output_variance(params[c.src], c.src_wop_nb,
                                           cbs_b, cbs_l, pfks_b, pfks_l)
        else:
            v_src, _, _ = _partition_noise(params[c.src])
        _, v_ks_d, v_ms_d = _partition_noise(params[c.dst])
        lvl, base = fks[(c.src, c.dst)]
        v_fks = pp.variance_keyswitch(params[c.src].n_big, base, lvl,
                                      params[c.dst].glwe_std ** 2)
        key = (c.src, c.dst)
        tlu_set = set(c.tlu_constraints)
        for p, n2 in c.constraints:
            # decode decisions (outputs) see no destination KS/MS
            total = ((v_src + v_fks) * float(n2) ** 2
                     + ((v_ks_d + v_ms_d) if (p, n2) in tlu_set else 0.0))
            if total >= safe_variance_bound(p, p_error):
                raise ValueError(
                    f"multi-partition plan infeasible: crossing "
                    f"{c.src}->{c.dst} violates the {p}-bit decision margin "
                    f"(noise {total:.3e} >= "
                    f"{safe_variance_bound(p, p_error):.3e})")
            crossing_pe[key] = max(crossing_pe.get(key, 0.0),
                                   p_error_of_variance(p, total))
    return PartitionPlan(
        params=params, wop_gadgets=wop_gadgets, fks=fks,
        norm2={w: pt.max_norm2 for w, pt in patterns.items()},
        patterns={w: tuple(pt.native) for w, pt in patterns.items()},
        noise_patterns={w: tuple(pt.wide_in) for w, pt in patterns.items()},
        crossing_p_error=crossing_pe)


# ---------------------------------------------------------------------------
# Joint (mergeable) partition planning
# ---------------------------------------------------------------------------
#
# The reference optimizer searches macro parameters JOINTLY across
# partitions and keeps a cut only when it is modeled cheaper than
# unification (multi_parameters/optimize/mod.rs:1009 optimize_macro /
# best_candidate comparison across partitionings).  Here the same decision
# is made explicitly: starting from the finest cut (one partition per
# width/norm2 class), greedily merge the pair of partitions whose merge
# reduces the modeled per-evaluation MAC cost the most, down to mono if
# mono wins.  A 2-bit + 7-bit circuit therefore compiles mono when paying
# 7-bit parameters for the 2-bit TLUs is cheaper than a second keyset +
# conversion keyswitches — and multi when it is not.


def _tlu_instructions(graph: Graph):
    """(pid_in, pid_out, p_eff, weight, wop_nb) per PBS-bearing node.

    `weight` counts PBS instructions (tensor size; extract_bits scaled by
    its bit count, mirroring compiler.pbs_of)."""
    default = graph.max_bit_width
    instrs = []
    for node in graph.topological_order():
        if node.name not in TLU_OPS:
            continue
        preds = [p for p in graph.ordered_preds_of(node)
                 if p.output.is_encrypted]
        if not preds:
            continue
        weight = max(int(np.prod(node.output.shape)), 1)
        if node.name == "extract_bits":
            pos = node.properties["kwargs"]["positions"]
            weight *= max(int(q) for q in pos) + 1
        p_eff = tlu_effective_input_width(graph, node, default)
        nb = wop_nb_bits(graph, node, default) \
            if (p_eff > MAX_NATIVE_TLU_BITS
                and node.name != "extract_bits") else 0
        instrs.append((tlu_input_partition(graph, node, default),
                       partition_of(node, default), p_eff, weight, nb))
    return instrs


def _modeled_cost(instrs, group: dict, plan: PartitionPlan) -> float:
    """Modeled int8-MAC cost of one circuit evaluation under `plan` with
    partitions merged per `group` (pid -> gid)."""
    from concrete_tpu_torch.optimizer.v0 import (cost_fks_macs, cost_ks_macs,
                                                 cost_pbs_macs, cost_wop_macs)
    total = 0.0
    for pid_in, pid_out, p_eff, weight, nb in instrs:
        g = group[pid_in]
        pr = plan.params[g]
        if nb:
            gad = plan.wop_gadgets.get(g)
            if gad is None:
                continue  # infeasible grouping caught by the solver
            cbs_l, cbs_b, pfks_l, pfks_b = gad
            total += weight * float(cost_wop_macs(
                pr, nb, cbs_l, pfks_l, cbs_b, pfks_b))
        else:
            total += weight * (
                float(cost_ks_macs(pr.n_big, pr.n_small, pr.ks_level,
                                   pr.ks_base_log))
                + float(np.asarray(cost_pbs_macs(
                    np.array([pr.n_small], dtype=np.float64),
                    pr.glwe_dimension, pr.polynomial_size, pr.pbs_level,
                    pr.pbs_base_log, precision=min(p_eff, 8)))[0]))
        gd = group[pid_out]
        if gd != g:
            lvl, base = plan.fks[(g, gd)]
            total += weight * float(cost_fks_macs(
                pr.n_big, plan.params[gd].n_big, lvl, base))
    return total


def _merge_grouping(patterns: dict, crossings: list, group: dict):
    """Relabel the finest-cut patterns/crossings under pid -> gid."""
    merged: dict[int, PartitionPatterns] = {}
    for pid, pt in patterns.items():
        g = group[pid]
        if g not in merged:
            merged[g] = PartitionPatterns([], [], [])
        mp = merged[g]
        mp.native.extend(pt.native)
        mp.wide_in.extend(pt.wide_in)
        mp.wop.extend(pt.wop)
        mp.max_norm2 = max(mp.max_norm2, pt.max_norm2)
    for mp in merged.values():
        if not mp.native:
            mp.native.append((1, 1))
    mcross = [dataclasses.replace(c, src=group[c.src], dst=group[c.dst])
              for c in crossings if group[c.src] != group[c.dst]]
    return merged, mcross


def _gid_of(members, widths: dict) -> int:
    """Merged-group id: the widest member's pid (part_width stays the
    group's message width; ties break on the larger pid)."""
    return max(members, key=lambda pid: (widths[pid], pid))


def achieved_global_p_error(plan: PartitionPlan, graph: Graph) -> float:
    """Exact-product achieved global failure rate of a solved plan.

    Per PBS instruction: the worst achieved per-PBS p_error of its input
    partition's native atomic patterns under that partition's parameters
    (optimizer.v0.achieved_p_error), or the crossing's achieved error when
    the instruction's output lands in another partition — compounded
    exactly over instruction counts (1 - prod(1-ach_i)^w_i).  The multi
    analog of the mono calibration at compiler.py (reference
    V0Parameters.cpp:70-119 reads the same quantity off
    DagSolution.global_p_error).  Call AFTER plan_partitions persisted the
    merged grouping (instruction pids are then plan group ids).
    """
    import math

    from concrete_tpu_torch.optimizer.v0 import achieved_p_error
    log_ok = 0.0
    for pid_in, pid_out, _p_eff, weight, _nb in _tlu_instructions(graph):
        pr = plan.params.get(pid_in)
        pats = plan.patterns.get(pid_in)
        if pr is None or not pats:
            continue
        ach = achieved_p_error(pr, pats,
                               plan.noise_patterns.get(pid_in, ()))
        if pid_out != pid_in:
            ach = max(ach, plan.crossing_p_error.get((pid_in, pid_out), 0.0))
        if ach >= 1.0:
            return 1.0
        log_ok += weight * math.log1p(-ach)
    return -math.expm1(log_ok)


def plan_partitions(graph: Graph, p_error: float = 6.3e-5,
                    security_level: int = 128,
                    max_iterations: int = 4,
                    restriction=None) -> PartitionPlan | None:
    """Joint multi-partition planning: solve the finest width/norm2 cut,
    then greedily merge partitions (down to mono) whenever the merge
    lowers the modeled per-evaluation cost.

    Returns None when mono is the chosen (or only) grouping — the caller's
    mono path then solves the union of patterns, which is exactly the
    single-group solution.  Raises if no feasible grouping exists.
    """
    patterns, crossings = partition_pattern_split(graph)
    if len(patterns) < 2:
        return None
    instrs = _tlu_instructions(graph)
    widths = {pid: part_width(pid) for pid in patterns}

    def evaluate(group: dict):
        mpat, mcross = _merge_grouping(patterns, crossings, group)
        try:
            plan = _solve_plan(mpat, mcross, p_error, security_level,
                               max_iterations, restriction)
        except ValueError:
            return None, np.inf
        return plan, _modeled_cost(instrs, group, plan)

    group = {pid: pid for pid in patterns}
    plan, cost = evaluate(group)
    while len(set(group.values())) > 1:
        gids = sorted(set(group.values()))
        best = None
        for i in range(len(gids)):
            for j in range(i + 1, len(gids)):
                a, b = gids[i], gids[j]
                members = [pid for pid in group if group[pid] in (a, b)]
                gid = _gid_of(members, widths)
                cand = {pid: gid if group[pid] in (a, b) else group[pid]
                        for pid in group}
                cplan, ccost = evaluate(cand)
                if ccost < cost and (best is None or ccost < best[1]):
                    best = (cand, ccost, cplan)
        if best is None:
            break
        group, cost, plan = best
    if plan is None:
        raise ValueError("no feasible partition grouping "
                         "(finest multi cut and all merges failed)")
    if len(set(group.values())) == 1:
        return None                       # mono is modeled cheapest
    if any(group[pid] != pid for pid in group):
        # persist the merge: partition ids are read from node properties
        # everywhere downstream (widths.partition_of)
        default = graph.max_bit_width
        for node in graph.graph.nodes:
            if node.output.is_encrypted:
                pid = partition_of(node, default)
                node.properties["partition"] = group.get(pid, pid)
    return plan


def decision_failures(graph: Graph, specs) -> list:
    """The noise model's failure probability at every decision point of a
    compiled multi-partition circuit, under its compiled parameters.

    Returns one dict per lookup node ("kind": its name) and per encrypted
    output ("kind": "decode"): "pid" (the partition the decision is made
    in), "bits" (the decision's width), "elements" (decisions a request)
    and "p" (each one's failure probability).  A lookup's decision is its
    input pattern (p_eff, in_sq, lut_sq) under its input partition's
    parameters (optimizer.v0.pattern_variance); where its output crosses a
    frontier, "p_crossing" is the worst of the decisions downstream of the
    crossing as ``_solve_plan``'s exact check computes them: the source
    blind rotate and the conversion keyswitch at the compiled gadget,
    scaled by norm2^2, plus the destination's KS+MS before a lookup.  An
    output's decode pays no KS+MS (noise-only pattern)."""
    from concrete_tpu_torch.optimizer.v0 import (p_error_of_variance,
                                                 pattern_variance)
    pairs, bpairs = graph.variance_pairs()
    manp = {n: max(c[0] + c[1], 1) for n, c in pairs.items()}
    boundary = {n: max(c[0] + c[1], 1) for n, c in bpairs.items()}
    default = graph.max_bit_width
    params, conv = specs.partitions, specs.conversions or {}
    out = []
    for node in graph.topological_order():
        if node.name not in TLU_OPS or not any(
                p.output.is_encrypted for p in graph.ordered_preds_of(node)):
            continue
        pid = tlu_input_partition(graph, node, default)
        dst = partition_of(node, default)
        p_eff = tlu_effective_input_width(graph, node, default)
        in_c, lut_c = bpairs.get(node, (0, 1))
        weight = max(int(np.prod(node.output.shape)), 1)
        if node.name == "extract_bits":
            pos = node.properties["kwargs"]["positions"]
            weight *= max(int(q) for q in pos) + len(pos)
        rec = {"kind": node.name, "uid": node.uid, "pid": pid, "dst": dst,
               "bits": p_eff, "elements": weight,
               "p": p_error_of_variance(p_eff, pattern_variance(
                   params[pid], (p_eff, in_c, lut_c))),
               "p_crossing": 0.0}
        if dst != pid and (pid, dst) in conv:
            v_src, _, _ = _partition_noise(params[pid])
            _, v_ks_d, v_ms_d = _partition_noise(params[dst])
            lvl, base = conv[(pid, dst)]
            v_fks = pp.variance_keyswitch(params[pid].n_big, base, lvl,
                                          params[dst].glwe_std ** 2)
            tlu_cons, dec_cons = decision_constraints_split(
                graph, node, default, (manp, boundary))
            for (w, n2), ks_ms in [(c, v_ks_d + v_ms_d) for c in tlu_cons] \
                    + [(c, 0.0) for c in dec_cons]:
                rec["p_crossing"] = max(rec["p_crossing"], p_error_of_variance(
                    w, (v_src + v_fks) * float(n2) ** 2 + ks_ms))
        out.append(rec)
    for node in graph.ordered_outputs:
        if not node.output.is_encrypted:
            continue
        pid = partition_of(node, default)
        w = encoding_width(node, default)
        in_c, lut_c = pairs.get(node, (0, 1))
        if (in_c, lut_c) == (0, 0):
            in_c = 1
        out.append({"kind": "decode", "uid": node.uid, "pid": pid,
                    "dst": pid, "bits": w,
                    "elements": max(int(np.prod(node.output.shape)), 1),
                    "p": p_error_of_variance(w, pattern_variance(
                        params[pid], (w, in_c, lut_c),
                        ks_ms_weight=4.0 ** -w)),
                    "p_crossing": 0.0})
    return out


def expected_failures(records: list) -> float:
    """Expected failing decisions a request: every decision's elements
    times its worse probability (a crossing's downstream decisions counted
    once more at the source, so an upper bound)."""
    return sum(r["elements"] * (r["p"] + r["p_crossing"]) for r in records)
