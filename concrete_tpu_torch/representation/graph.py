"""The computation DAG: evaluation, bounds measurement, bit-width assignment.

Reference: frontends/concrete-python/concrete/fhe/representation/graph.py:27
(networkx MultiDiGraph of Nodes, topological `evaluate` at graph.py:89-120,
bounds measurement over inputsets, pruning/formatting).  Bit-width assignment
here is the max-over-measured-bounds rule (the reference's z3-based
AssignBitWidths pass, mlir/processors/assign_bit_widths.py:18, solves the same
constraint system; with single-keyset "mono" semantics the solution is the
partition max, which is what we compute).
"""

from __future__ import annotations


import networkx as nx
import numpy as np

from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.representation.node import Node, Operation


def norm2_of_manp(manp_value) -> float:
    """Linear 2-norm from a squared MANP accumulation.

    manp_map accumulates ||w||^2; the optimizer/noise APIs take the linear
    norm and square it internally (amp = norm2^2), so conversions must take
    the square root exactly once — the reference's MANP.cpp does
    ceil(sqrt(sqMANP)) at the same boundary."""
    import math
    return math.sqrt(max(float(manp_value), 1.0))


class Graph:
    def __init__(self, graph: nx.MultiDiGraph, input_nodes: dict[int, Node],
                 output_nodes: dict[int, Node], name: str = "main"):
        self.graph = graph
        self.input_nodes = input_nodes        # position -> Node
        self.output_nodes = output_nodes      # position -> Node
        self.name = name

    # -- structure ---------------------------------------------------------

    def topological_order(self) -> list[Node]:
        return list(nx.topological_sort(self.graph))

    def ordered_preds_of(self, node: Node) -> list[Node]:
        edges = sorted(self.graph.in_edges(node, data="input_idx"),
                       key=lambda e: e[2])
        return [e[0] for e in edges]

    @property
    def ordered_inputs(self) -> list[Node]:
        return [self.input_nodes[i] for i in sorted(self.input_nodes)]

    @property
    def ordered_outputs(self) -> list[Node]:
        return [self.output_nodes[i] for i in sorted(self.output_nodes)]

    # -- evaluation (reference graph.py:89-120) ----------------------------

    def evaluate(self, *inputs) -> dict[Node, np.ndarray]:
        """Plaintext evaluation; returns every node's value."""
        results: dict[Node, np.ndarray] = {}
        for node in self.topological_order():
            if node.operation == Operation.Input:
                pos = next(p for p, n in self.input_nodes.items() if n is node)
                results[node] = np.asarray(inputs[pos])
            elif node.operation == Operation.Constant:
                results[node] = node()
            else:
                args = [results[p] for p in self.ordered_preds_of(node)]
                results[node] = np.asarray(node(*args))
        return results

    def __call__(self, *inputs):
        results = self.evaluate(*inputs)
        outs = tuple(results[n] for n in self.ordered_outputs)
        return outs[0] if len(outs) == 1 else outs

    # -- bounds measurement ------------------------------------------------

    def measure_bounds(self, inputset) -> None:
        """Run every inputset sample, recording per-node (min, max).

        Reference: FunctionDef.evaluate (compilation/module_compiler.py:153).
        """
        for sample in inputset:
            if not isinstance(sample, tuple):
                sample = (sample,)
            results = self.evaluate(*sample)
            for node, value in results.items():
                arr = np.asarray(value)
                lo, hi = int(arr.min()), int(arr.max())
                if node.bounds is None:
                    node.bounds = (lo, hi)
                else:
                    node.bounds = (min(node.bounds[0], lo),
                                   max(node.bounds[1], hi))

    def update_dtypes_from_bounds(self) -> None:
        """Assign each node's Integer dtype from measured bounds (and refresh
        every node's view of its predecessors' descriptions)."""
        for node in self.topological_order():
            if node.bounds is None:
                raise RuntimeError(
                    f"node {node.name} has no measured bounds; "
                    "was measure_bounds called with a non-empty inputset?")
            dtype = Integer.that_can_represent(list(node.bounds))
            node.output = type(node.output)(
                dtype=dtype, shape=node.output.shape,
                is_encrypted=node.output.is_encrypted)
        for node in self.topological_order():
            preds = self.ordered_preds_of(node)
            if preds:
                node.inputs = [p.output for p in preds]

    @property
    def max_bit_width(self) -> int:
        """Mono-keyset precision: max over encrypted nodes (multivariate
        nodes count their packed operand width)."""
        width = 1
        for node in self.graph.nodes:
            if node.output.is_encrypted and isinstance(node.output.dtype,
                                                       Integer):
                width = max(width, node.output.dtype.bit_width)
            if node.name == "multivariate":
                packed = 0
                for pr in self.ordered_preds_of(node):
                    lo, hi = pr.bounds
                    packed += max(int(hi - lo).bit_length(), 1)
                width = max(width, packed)
        return width

    # -- MANP (norm2) analysis ---------------------------------------------

    def max_norm2(self) -> float:
        """LINEAR 2-norm of integer weights accumulated since the last
        table lookup, maximized over TLU/output boundaries.

        The TPU-native equivalent of the reference's MANP forward dataflow
        analysis (lib/Dialect/FHE/Analysis/MANP.cpp:55) used to pick the
        optimizer's noise factor.  manp_map accumulates SQUARED norms; every
        norm2-typed consumer (optimizer patterns, key truncation budgets)
        squares its argument, so this returns sqrt(manp) — the reference's
        MANP pass does the same (ceil'd to int; we keep the exact float).
        """
        manp, boundary = self.manp_map()
        worst = max(boundary.values(), default=1)
        for node in self.ordered_outputs:
            worst = max(worst, manp.get(node, 1))
        return norm2_of_manp(worst)

    #: TLU-family ops whose output is a fresh PBS encoding (mirrors
    #: compilation.widths.TLU_OPS; kept here to avoid a cycle)
    _PBS_OPS = ("tlu", "univariate", "multivariate", "dynamic_tlu",
                "crt_tlu")

    def variance_pairs(self) -> tuple[dict[Node, tuple],
                                      dict[Node, tuple]]:
        """Per-node noise coefficients as (input_coeff, pbs_coeff) pairs.

        The per-node variance analysis of the reference optimizer
        (concrete-optimizer/src/optimization/dag/solo_key/analyze.rs
        SymbolicVariance { input_coeff, lut_coeff }): each node's noise
        variance is  input_coeff * v_fresh + pbs_coeff * v_br  where
        v_fresh is the fresh-encryption variance and v_br the blind-rotate
        (or sign-PBS) output variance.  Coefficients are SQUARED accumulated
        weights, propagated with the same rules as MANP but seeded per
        source class — this lets the optimizer charge large weights on
        fresh inputs against the (much smaller) encryption variance instead
        of the worst-case PBS variance.

        Returns (pairs, boundary): pairs[node] = (in_c, pbs_c) of the
        node's value; boundary[tlu] = the pair entering that TLU (packed
        pair for multivariate nodes).  manp_map() is the componentwise sum.
        """
        pairs: dict[Node, tuple] = {}
        boundary: dict[Node, tuple] = {}
        ZERO = (0, 0)

        def add(a, b):
            return (a[0] + b[0], a[1] + b[1])

        def scale(a, s):
            return (a[0] * s, a[1] * s)

        def pmax(a, b):
            return (max(a[0], b[0]), max(a[1], b[1]))

        for node in self.topological_order():
            preds = self.ordered_preds_of(node)
            name = node.name
            if node.operation is Operation.Input:
                pairs[node] = (1, 0) if node.output.is_encrypted else ZERO
            elif node.operation is Operation.Constant:
                pairs[node] = ZERO
            elif name in ("tlu", "univariate", "dynamic_tlu", "crt_tlu"):
                b = ZERO
                for p in preds:
                    if p.output.is_encrypted:
                        b = pmax(b, pairs[p])
                boundary[node] = b if b != ZERO else (0, 1)
                pairs[node] = (0, 1)
            elif name == "extract_bits":
                # PBS boundary; output = sum of len(positions) fresh
                # sign-PBS outputs
                b = ZERO
                for p in preds:
                    if p.output.is_encrypted:
                        b = pmax(b, pairs[p])
                boundary[node] = b if b != ZERO else (0, 1)
                pairs[node] = (0, max(
                    len(node.properties["kwargs"]["positions"]), 1))
            elif name == "multivariate":
                # packed = sum (x_i - min_i) << off_i: scaled pairs add
                packed = ZERO
                acc_off = 0
                for pr in reversed(preds):
                    lo, hi = pr.bounds
                    packed = add(packed, scale(pairs[pr],
                                               (1 << acc_off) ** 2))
                    acc_off += max(int(hi - lo).bit_length(), 1)
                boundary[node] = packed if packed != ZERO else (0, 1)
                pairs[node] = (0, 1)
            elif name in ("add", "subtract"):
                s = ZERO
                for p in preds:
                    if p.output.is_encrypted:
                        s = add(s, pairs[p])
                pairs[node] = s if s != ZERO else ZERO
            elif name == "negative":
                pairs[node] = pairs[preds[0]]
            elif name == "multiply":
                # encrypted * clear: scale by max |constant|^2
                enc = [p for p in preds if p.output.is_encrypted]
                clear = [p for p in preds if not p.output.is_encrypted]
                s = 1
                for c in clear:
                    hi = max(abs(c.bounds[0]), abs(c.bounds[1])) \
                        if c.bounds else max(abs(c.output.dtype.min),
                                             abs(c.output.dtype.max))
                    s *= hi * hi
                pairs[node] = scale(pairs[enc[0]], s) if enc else ZERO
            elif name in ("matmul", "dot"):
                enc = [p for p in preds if p.output.is_encrypted]
                clear = [p for p in preds if not p.output.is_encrypted]
                if enc and clear:
                    cnode = clear[0]
                    const = cnode.properties.get("constant")
                    if const is not None:
                        w = np.asarray(const, dtype=np.int64)
                        if w.ndim == 2:
                            # contraction axis follows the executor's
                            # orientation: ct @ w contracts w's axis 0,
                            # w @ ct (clear on the left) contracts axis 1
                            axis = 1 if preds[0] is cnode else 0
                            norm = int((w.astype(object) ** 2)
                                       .sum(axis=axis).max())
                        else:
                            norm = int((w.astype(object) ** 2).sum())
                    else:
                        hi = max(abs(cnode.output.dtype.min),
                                 abs(cnode.output.dtype.max))
                        size = max(cnode.output.size, 1)
                        norm = hi * hi * size
                    pairs[node] = scale(pairs[enc[0]], norm)
                else:
                    pairs[node] = ZERO
            elif name == "sum":
                size = max(preds[0].output.size, 1)
                pairs[node] = scale(pairs[preds[0]], size)
            else:
                m = ZERO
                for p in preds:
                    m = pmax(m, pairs.get(p, ZERO))
                pairs[node] = m
        return pairs, boundary

    def manp_map(self) -> tuple[dict[Node, int], dict[Node, int]]:
        """Per-node MANP plus per-TLU boundary norms.

        Returns (manp, boundary): manp[node] is the squared 2-norm
        accumulated on the node's value since the last TLU; boundary[tlu]
        is the norm entering that TLU (the packed norm for multivariate
        nodes).  The componentwise sum of variance_pairs() — kept for
        norm2-typed consumers (key truncation budgets, display).
        """
        pairs, bpairs = self.variance_pairs()
        manp = {n: max(c[0] + c[1], 1) for n, c in pairs.items()}
        boundary = {n: max(c[0] + c[1], 1) for n, c in bpairs.items()}
        return manp, boundary

    # -- formatting --------------------------------------------------------

    def to_dot(self) -> str:
        """Graphviz DOT text of the computation graph (the dependency-free
        core of the reference's Graph.draw; render with `dot -Tpng`)."""
        lines = ["digraph G {", "  rankdir=TB;",
                 "  node [shape=box, fontname=monospace];"]
        order = self.topological_order()
        ids = {n: i for i, n in enumerate(order)}
        for n in order:
            enc = "enc" if n.output.is_encrypted else "clear"
            label = f"%{ids[n]} {n.name}\\n{enc} {n.output.dtype} " \
                f"{tuple(n.output.shape)}"
            style = ' style=filled fillcolor="#e8f0fe"' \
                if n.output.is_encrypted else ""
            lines.append(f'  n{ids[n]} [label="{label}"{style}];')
        for u, v, data in self.graph.edges(data=True):
            lines.append(f"  n{ids[u]} -> n{ids[v]} "
                         f"[label=\"{data.get('input_idx', 0)}\"];")
        lines.append("}")
        return "\n".join(lines)

    def draw(self, path: str = None) -> str:
        """Write the DOT drawing (reference Graph.draw analog).  Returns
        the path written; renders to an image instead when `path` ends in
        .png/.svg and the graphviz `dot` binary exists."""
        import shutil
        import subprocess
        import tempfile
        dot = self.to_dot()
        if path is None:
            path = tempfile.mktemp(suffix=".dot")
        if path.endswith((".png", ".svg")) and shutil.which("dot"):
            fmt = path.rsplit(".", 1)[1]
            subprocess.run(["dot", f"-T{fmt}", "-o", path],
                           input=dot.encode(), check=True)
        else:
            if path.endswith((".png", ".svg")):
                path = path.rsplit(".", 1)[0] + ".dot"
            with open(path, "w") as f:
                f.write(dot)
        return path

    def format(self) -> str:
        lines = []
        names: dict[Node, str] = {}
        for i, node in enumerate(self.topological_order()):
            names[node] = f"%{i}"
            preds = [names[p] for p in self.ordered_preds_of(node)]
            lines.append(f"{names[node]} = {node.format(preds)}")
        outs = ", ".join(names[n] for n in self.ordered_outputs)
        lines.append(f"return {outs}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()
