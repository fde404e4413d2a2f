"""Per-value encoding-width assignment (multi-precision mono compilation).

The reference assigns every value its own bit width with a z3 optimizer
(frontends/concrete-python/concrete/fhe/mlir/processors/assign_bit_widths.py:18):
equality constraints tie together the operands/results of leveled ops, while
table lookups may change width freely (the PBS re-encodes its output).  Under
single-keyset ("mono") semantics the optimal solution of that constraint
system is simply the maximum width within each equivalence class, which the
union-find below computes directly — no solver needed.

Classes ("encoding partitions") are the connected components of encrypted
values linked by non-TLU ops; a TLU's output starts a fresh class.  Each
node gets `properties["encoding_width"]`; TLUs then build 2^{p_in}-entry
tables and encode outputs at p_out, so a circuit mixing 2-bit and 8-bit
TLUs runs each PBS at its own width instead of the global max (the verdictly
biggest cost distortion of round 1).
"""

from __future__ import annotations

from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.representation import Graph, Node, Operation
from concrete_tpu_torch.representation.graph import norm2_of_manp

# ops whose (encrypted) output is a *fresh* encoding — everything else keeps
# its operands' encoding
TLU_OPS = ("tlu", "univariate", "multivariate", "extract_bits",
           "dynamic_tlu", "crt_tlu")


class _UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def find(self, x: int) -> int:
        root = x
        while self.parent.setdefault(root, root) != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def packed_width(graph: Graph, node: Node) -> int:
    """Bit width of a multivariate node's packed operand (sum of operand
    widths from measured bounds, executor.packed_layout)."""
    total = 0
    for pr in graph.ordered_preds_of(node):
        lo, hi = pr.bounds
        total += max(int(hi - lo).bit_length(), 1)
    return total


def _link_encoding_classes(graph: Graph, composable: bool) -> _UnionFind:
    """Union-find of encoding classes: encrypted values linked by leveled
    ops share a class (= they are literally the same ciphertexts under one
    key); a TLU's output starts a fresh class."""
    uf = _UnionFind()
    for node in graph.topological_order():
        if node.output.is_encrypted:
            uf.find(node.uid)

    if composable:
        boundary = [n for n in list(graph.input_nodes.values())
                    + list(graph.ordered_outputs) if n.output.is_encrypted]
        for a, b in zip(boundary, boundary[1:]):
            uf.union(a.uid, b.uid)

    for node in graph.topological_order():
        preds = [p for p in graph.ordered_preds_of(node)
                 if p.output.is_encrypted]
        if node.name == "multivariate":
            # packed operands share one encoding; output is fresh
            for a, b in zip(preds, preds[1:]):
                uf.union(a.uid, b.uid)
            continue
        if node.name in TLU_OPS:
            continue  # output re-encoded by the PBS
        if not node.output.is_encrypted:
            continue
        for p in preds:
            uf.union(node.uid, p.uid)
    return uf


def assign_encoding_widths(graph: Graph,
                           composable: bool = False) -> dict[Node, int]:
    """Compute and store each encrypted node's encoding width.

    Returns the node -> width mapping; also sets
    node.properties["encoding_width"].  Must run after
    update_dtypes_from_bounds (widths come from measured dtypes).

    composable: tie every encrypted input and output into ONE width class,
    so circuit outputs are valid circuit inputs (reference
    Configuration.composable / the composition ClosedRange constraint in
    assign_bit_widths.py:84 — outputs must share the inputs' encoding).
    """
    enc_nodes = [n for n in graph.topological_order()
                 if n.output.is_encrypted]
    uf = _link_encoding_classes(graph, composable)

    # class width = max member width, plus multivariate packing minimums
    width_of_root: dict[int, int] = {}
    for node in enc_nodes:
        root = uf.find(node.uid)
        w = node.output.dtype.bit_width \
            if isinstance(node.output.dtype, Integer) else 1
        width_of_root[root] = max(width_of_root.get(root, 1), w)
    for node in graph.topological_order():
        if node.name == "multivariate":
            preds = [p for p in graph.ordered_preds_of(node)
                     if p.output.is_encrypted]
            if preds:
                root = uf.find(preds[0].uid)
                width_of_root[root] = max(width_of_root.get(root, 1),
                                          packed_width(graph, node))

    result: dict[Node, int] = {}
    for node in enc_nodes:
        w = width_of_root[uf.find(node.uid)]
        node.properties["encoding_width"] = w
        result[node] = w
    return result


def encoding_width(node: Node, default: int) -> int:
    """The node's assigned encoding width (falling back to the circuit-wide
    message_bits for graphs compiled/serialized before width assignment)."""
    return int(node.properties.get("encoding_width", default))


# -- partition ids (MULTI parameter selection) --------------------------------
#
# A partition id is an int.  Under the PRECISION cut it IS the encoding
# width; the PRECISION_AND_NORM2 cut (reference multi_parameters/
# partition_cut.rs PrecisionAndNorm2) splits same-width encoding classes by
# their norm2 bucket into synthetic ids `width + (rank << PART_SHIFT)`.
# Rank 0 (the highest-norm2 bucket) keeps the plain width, so anything that
# still resolves a partition by width lands on the most conservative
# parameters of that width.

PART_SHIFT = 8


def part_width(pid: int) -> int:
    """Message width of a partition id (the low byte)."""
    return int(pid) & ((1 << PART_SHIFT) - 1)


def partition_of(node: Node, default: int) -> int:
    """The partition id of a node's value (= its encoding width unless a
    norm2 cut assigned a synthetic id)."""
    return int(node.properties.get("partition",
                                   encoding_width(node, default)))


def tlu_input_partition(graph: Graph, node: Node, default: int) -> int:
    """The partition the node's PBS runs in: its encrypted operands' class
    partition (all encrypted operands of one op share a class)."""
    preds = [p for p in graph.ordered_preds_of(node)
             if p.output.is_encrypted]
    if not preds:
        return default
    widest = max(preds, key=lambda p: encoding_width(p, default))
    return partition_of(widest, default)


def assign_norm2_partitions(graph: Graph, composable: bool = False) -> dict:
    """PRECISION_AND_NORM2 cut: split same-width encoding classes whose
    norm2 buckets differ into separate partitions.

    Sets node.properties["partition"] on every encrypted node and returns
    the node -> partition-id map.  A class's bucket is
    ceil(log2(max norm2)) over the decision points it feeds (TLU inputs in
    the class + circuit outputs in the class) — the same norm2 the
    reference's PrecisionAndNorm2 cut keys on (partition_cut.rs).  Must run
    after assign_encoding_widths (uses the same class structure).
    """
    import math

    uf = _link_encoding_classes(graph, composable)
    default = graph.max_bit_width
    pairs, bpairs = graph.variance_pairs()
    boundary = {n: max(c[0] + c[1], 1) for n, c in bpairs.items()}
    manp = {n: max(c[0] + c[1], 1) for n, c in pairs.items()}

    # max norm2 each class must survive
    class_n2: dict[int, float] = {}

    def feed(member: Node, n2: float):
        root = uf.find(member.uid)
        class_n2[root] = max(class_n2.get(root, 1.0), n2)

    for node in graph.topological_order():
        if node.name in TLU_OPS:
            preds = [p for p in graph.ordered_preds_of(node)
                     if p.output.is_encrypted]
            if preds:
                feed(preds[0], norm2_of_manp(boundary.get(node, 1)))
    for node in graph.ordered_outputs:
        if node.output.is_encrypted:
            feed(node, norm2_of_manp(manp.get(node, 1)))

    # group classes by (width, bucket); rank buckets per width descending
    # so rank 0 (pid = width) is the most conservative
    groups: dict[tuple[int, int], list[int]] = {}
    enc_nodes = [n for n in graph.topological_order()
                 if n.output.is_encrypted]
    root_width: dict[int, int] = {}
    for node in enc_nodes:
        root = uf.find(node.uid)
        root_width[root] = max(root_width.get(root, 1),
                               encoding_width(node, default))
    for root, w in root_width.items():
        n2 = class_n2.get(root, 1.0)
        bucket = max(0, math.ceil(math.log2(n2))) if n2 > 1 else 0
        groups.setdefault((w, bucket), []).append(root)

    pid_of_root: dict[int, int] = {}
    by_width: dict[int, list[int]] = {}
    for (w, bucket) in groups:
        by_width.setdefault(w, []).append(bucket)
    for w, buckets in by_width.items():
        for rank, bucket in enumerate(sorted(buckets, reverse=True)):
            pid = w + (rank << PART_SHIFT)
            for root in groups[(w, bucket)]:
                pid_of_root[root] = pid

    result: dict[Node, int] = {}
    for node in enc_nodes:
        pid = pid_of_root[uf.find(node.uid)]
        node.properties["partition"] = pid
        result[node] = pid
    return result


def output_encoding_width(node: Node, default: int) -> int:
    """Encoding width for a circuit OUTPUT.  Clear outputs are never
    assigned widths by the noise-driven pass (they carry no noise), but
    their trivial encryption must still cover the value range — otherwise
    a clear value wider than the encrypted default decodes to garbage."""
    w = encoding_width(node, default)
    if not node.output.is_encrypted and isinstance(node.output.dtype,
                                                   Integer):
        w = max(w, node.output.dtype.bit_width)
    return w


ROUNDING_OPS = ("round_bit_pattern", "truncate_bit_pattern")


def tlu_fused_lsbs(graph: Graph, node: Node) -> int:
    """lsbs rounded away for free by this TLU's modulus switch (0 if the
    TLU's input is not a fused round/truncate_bit_pattern node)."""
    if node.name not in ("tlu", "univariate"):
        return 0
    preds = graph.ordered_preds_of(node)
    if len(preds) == 1 and preds[0].name in ROUNDING_OPS:
        return int(preds[0].properties["kwargs"]["lsbs_to_remove"])
    return 0


def tlu_effective_input_width(graph: Graph, node: Node, default: int) -> int:
    """The width at which this TLU's PBS actually runs: the input
    partition's encoding width, minus any fused rounding (ProcessRounding —
    the LUT index domain shrinks, mega-cases grow, noise tolerance rises)."""
    preds = [p for p in graph.ordered_preds_of(node)
             if p.output.is_encrypted]
    if not preds:
        return default
    p_in = max(encoding_width(p, default) for p in preds)
    return max(p_in - tlu_fused_lsbs(graph, node), 1)


#: widest TLU the native KS->BR path runs (the reference lowers >8-bit TLUs
#: through the CRT/WoP pipeline for the same reason: mega-case LUTs need
#: N >= 2^(p+1), FHEToTFHECrt.cpp); wider TLUs lower to WoP-PBS here.
MAX_NATIVE_TLU_BITS = 8


def tlu_input_width(graph: Graph, node: Node, default: int) -> int:
    """The (pre-rounding-fusion) input partition width of a TLU node."""
    preds = [p for p in graph.ordered_preds_of(node)
             if p.output.is_encrypted]
    if not preds:
        return default
    return max(encoding_width(p, default) for p in preds)


def is_wide_tlu(graph: Graph, node: Node, default: int,
                max_native: int = MAX_NATIVE_TLU_BITS) -> bool:
    """True if this TLU must lower to WoP-PBS (input too wide for one
    blind-rotate LUT)."""
    if node.name not in TLU_OPS:
        return False
    return tlu_effective_input_width(graph, node, default) > max_native


def wop_nb_bits(graph: Graph, node: Node, default: int) -> int:
    """Bits to extract for a wide TLU: the effective width, plus one for
    the sign position of signed inputs (the encoding's p+1-bit pattern)."""
    p_eff = tlu_effective_input_width(graph, node, default)
    signed = node.inputs and isinstance(node.inputs[0].dtype, Integer) \
        and node.inputs[0].dtype.is_signed
    return p_eff + (1 if signed else 0)


def decision_constraints_split(graph: Graph, node: Node,
                               default: int,
                               manp_pair=None):
    """Decision points consuming `node`'s output, split by kind:
    (tlu_constraints, decode_constraints) as (width, norm2) lists.

    TLU constraints are successor TLU inputs (walked through leveled
    ops) — their decision margin is consumed by a keyswitch + modulus
    switch before the bootstrap.  Decode constraints are circuit outputs
    reached through leveled ops — the client decrypts the big-key LWE
    directly, so NO keyswitch/modswitch noise applies (a multi-partition
    destination that only decodes must not have KS+MS margin reserved
    for it — the round-5 MULTI root cause, see multi._solve_plan).

    manp_pair: precomputed graph.manp_map() result — callers iterating
    many TLUs pass it to avoid one full dataflow pass per call."""
    manp, boundary = manp_pair if manp_pair is not None \
        else graph.manp_map()
    tlu_out: list[tuple[int, int]] = []
    dec_out: list[tuple[int, int]] = []
    seen = {node}
    leveled_reach = {node}   # node + leveled ops its raw noise flows through
    frontier = [node]
    while frontier:
        cur = frontier.pop()
        for succ in graph.graph.successors(cur):
            if succ in seen:
                continue
            seen.add(succ)
            if succ.name in TLU_OPS:
                tlu_out.append(
                    (tlu_effective_input_width(graph, succ, default),
                     norm2_of_manp(boundary.get(succ, 1))))
            else:
                frontier.append(succ)
                leveled_reach.add(succ)
    for out_node in graph.ordered_outputs:
        # decode constraints apply only where `node`'s own noise reaches
        # the output through leveled ops (including the node itself being
        # an output); a successor TLU's output re-encodes the noise, and
        # its input constraint was already recorded above
        if out_node in leveled_reach and out_node.output.is_encrypted:
            dec_out.append((encoding_width(out_node, default),
                            norm2_of_manp(manp.get(out_node, 1))))
    if not tlu_out and not dec_out:
        dec_out.append((1, 1))
    return tlu_out, dec_out


def decision_constraints_after(graph: Graph, node: Node,
                               default: int,
                               manp_pair=None) -> list[tuple[int, int]]:
    """(width, norm2) decision points consuming `node`'s output —
    decision_constraints_split flattened (TLU + decode)."""
    tlu_out, dec_out = decision_constraints_split(graph, node, default,
                                                 manp_pair)
    return (tlu_out + dec_out) or [(1, 1)]


def tlu_pattern_split(graph: Graph):
    """Split the graph's PBS constraints for the optimizer.

    Returns (native_patterns, wide_input_patterns, wop_triples):
      native_patterns:      (p, in_sq, lut_sq) for <=8-bit TLUs + encrypted
                            outputs (full atomic patterns: N >= 2^(p+1));
      wide_input_patterns:  (p_in, in_sq, lut_sq) for WoP TLU inputs
                            (noise-only);
      wop_triples:          (nb_bits, out_width, out_norm2) per WoP TLU.

    The (in_sq, lut_sq) components are Graph.variance_pairs() coefficients
    (reference dag/solo_key/analyze.rs): squared accumulated weights on the
    fresh-encryption variance and the blind-rotate output variance — exact
    per-node noise, not the worst-case MANP bound.
    """
    pairs, bpairs = graph.variance_pairs()
    manp = {n: max(c[0] + c[1], 1) for n, c in pairs.items()}
    boundary = {n: max(c[0] + c[1], 1) for n, c in bpairs.items()}
    default = graph.max_bit_width
    native: list[tuple] = []
    wide_in: list[tuple] = []
    wop: list[tuple] = []
    for node in graph.topological_order():
        if node.name in TLU_OPS:
            preds = [p for p in graph.ordered_preds_of(node)
                     if p.output.is_encrypted]
            if not preds:
                continue
            p_in = tlu_effective_input_width(graph, node, default)
            in_c, lut_c = bpairs.get(node, (0, 1))
            if node.name == "extract_bits":
                # bit-peel cascade: decodability at p_in, no native LUT
                wide_in.append((p_in, in_c, lut_c))
            elif node.name == "crt_tlu":
                # CRT TLU: per-residue extraction (noise-only at the
                # residue width) + one WoP vertical packing over the
                # concatenated residue bits (wrappers.cpp:855-998)
                raise NotImplementedError(
                    "CRT table lookups are not ported yet "
                    "(ROADMAP queue 1 item 7)")
            elif p_in > MAX_NATIVE_TLU_BITS:
                wide_in.append((p_in, in_c, lut_c))
                nb = wop_nb_bits(graph, node, default)
                for w, n2o in decision_constraints_after(
                        graph, node, default, (manp, boundary)):
                    wop.append((nb, w, n2o))
            else:
                native.append((p_in, in_c, lut_c))
    for node in graph.ordered_outputs:
        if not node.output.is_encrypted:
            continue
        in_c, lut_c = pairs.get(node, (0, 1))
        if (in_c, lut_c) == (0, 0):
            in_c = 1   # trivially-encrypted clear path: decode fresh noise
        # outputs only need decodable noise — they pass through no further
        # LUT (no N >= 2^(p+1) mega-case requirement) and no
        # keyswitch/modulus-switch (the client decrypts the big-key LWE
        # directly), so they are noise-only constraints at every width.
        # Classifying <=8-bit outputs as native used to charge them the
        # PBS input path's v_ks + v_ms, which a 7-bit output turns into an
        # N=16384 escalation (round-5 MULTI bench root cause); leveled
        # amplification after the last PBS is still counted via the
        # variance pair.
        wide_in.append((encoding_width(node, default), in_c, lut_c))
    return (tuple(native) or ((1, 0, 1),), tuple(wide_in), tuple(wop))


def tlu_atomic_patterns(graph: Graph) -> list[tuple[int, int]]:
    """(precision, norm2) pairs the crypto parameters must satisfy.

    One per TLU (input-class width + accumulated MANP entering it, the
    packed norm for multivariate TLUs) plus one per encrypted output (decode
    margin at the output's width).  The reference optimizer builds the same
    per-PBS constraints from its operation DAG (dag/solo_key/analyze.rs);
    here MANP comes from the graph's norm2 dataflow.
    """
    manp, boundary = graph.manp_map()
    default = graph.max_bit_width
    patterns: list[tuple[int, int]] = []
    for node in graph.topological_order():
        if node.name in TLU_OPS:
            preds = [p for p in graph.ordered_preds_of(node)
                     if p.output.is_encrypted]
            if not preds:
                continue
            p_in = tlu_effective_input_width(graph, node, default)
            patterns.append((p_in, norm2_of_manp(boundary.get(node, 1))))
    for node in graph.ordered_outputs:
        if node.output.is_encrypted:
            patterns.append((encoding_width(node, default),
                             norm2_of_manp(manp.get(node, 1))))
    return patterns or [(1, 1)]
