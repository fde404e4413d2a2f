"""Graph rewrite passes (pre-lowering).

A copy of ``concrete_tpu/compilation/transforms.py``: the passes create
nodes and constants in the JAX package's order and dtypes, so both
packages compile one function to the same graph.  They are the analog of
the reference's FHE-level transform passes
(lib/Support/Pipeline.cpp:234-299 — EncryptedMulToDoubleTLU, FHEMaxTransform,
boolean/bigint transforms): rewrites run on the traced Graph *before* bounds
measurement, so inserted nodes get measured bounds and bit widths like any
user node.
"""

from __future__ import annotations

import networkx as nx
import numpy as np

from concrete_tpu_torch.representation import Graph, Node, Operation
from concrete_tpu_torch.values import ValueDescription


def _square_div4(v):
    v = np.asarray(v, dtype=np.int64)
    return (v * v) // 4


def lower_encrypted_multiplication(graph: Graph) -> None:
    """multiply(enc, enc) -> tlu((x+y)^2/4) - tlu((x-y)^2/4).

    Reference: EncryptedMulToDoubleTLU (lib/Conversion/utils, invoked from
    Pipeline.cpp:234 transformHighLevelFHEOps); exact for integers because
    x+y and x-y share parity.
    """
    g = graph.graph
    targets = [n for n in list(g.nodes)
               if n.name == "multiply"
               and len(n.inputs) == 2
               and all(v.is_encrypted for v in n.inputs)]
    for node in targets:
        preds = graph.ordered_preds_of(node)
        x_node, y_node = preds[0], preds[1]

        def vd(shape, encrypted=True):
            return ValueDescription(dtype=None, shape=shape,
                                    is_encrypted=encrypted)

        shape = node.output.shape
        add_n = Node.generic("add", [x_node.output, y_node.output],
                             vd(shape), lambda x, y: x + y)
        sub_n = Node.generic("subtract", [x_node.output, y_node.output],
                             vd(shape), lambda x, y: x - y)
        sq1 = Node.generic("univariate", [add_n.output], vd(shape),
                           lambda v: _square_div4(v), function=_square_div4)
        sq2 = Node.generic("univariate", [sub_n.output], vd(shape),
                           lambda v: _square_div4(v), function=_square_div4)
        out_n = Node.generic("subtract", [sq1.output, sq2.output],
                             vd(shape), lambda a, b: a - b)

        for new in (add_n, sub_n, sq1, sq2, out_n):
            g.add_node(new)
        g.add_edge(x_node, add_n, input_idx=0)
        g.add_edge(y_node, add_n, input_idx=1)
        g.add_edge(x_node, sub_n, input_idx=0)
        g.add_edge(y_node, sub_n, input_idx=1)
        g.add_edge(add_n, sq1, input_idx=0)
        g.add_edge(sub_n, sq2, input_idx=0)
        g.add_edge(sq1, out_n, input_idx=0)
        g.add_edge(sq2, out_n, input_idx=1)

        # rewire consumers of the multiply node
        for _, succ, key, data in list(g.out_edges(node, keys=True,
                                                   data=True)):
            g.add_edge(out_n, succ, **data)
        g.remove_node(node)
        for pos, n2 in list(graph.output_nodes.items()):
            if n2 is node:
                graph.output_nodes[pos] = out_n


_NONLINEAR_BINARY = ("mod", "floor_divide", "power")


def lower_nonlinear_binary_ops(graph: Graph) -> None:
    """Rewrite non-linear integer binary ops (mod, floor_divide, power) into
    table lookups.

    encrypted op clear-scalar-constant -> one univariate TLU (the constant is
    baked into the table); encrypted op encrypted -> one packed multivariate
    TLU.  Reference: these ops lower to `FHE.apply_lookup_table` /
    multivariate packing in the MLIR converter (mlir/context.py mod/
    floor_divide strategies); here it is a graph rewrite so the inserted
    nodes get measured bounds like any user node.
    """
    from concrete_tpu_torch.dtypes import Float

    g = graph.graph
    targets = [n for n in list(g.nodes)
               if n.name in _NONLINEAR_BINARY
               and not isinstance(n.output.dtype, Float)
               and any(v.is_encrypted for v in n.inputs)]
    for node in targets:
        preds = graph.ordered_preds_of(node)
        enc_flags = [p.output.is_encrypted for p in preds]
        ev = node.evaluator
        if all(enc_flags):
            new_node = Node.generic(
                "multivariate", [p.output for p in preds], node.output, ev,
                function=lambda a, b, ev=ev: int(ev(np.int64(a),
                                                    np.int64(b))))
            sources = preds
        else:
            enc_idx = enc_flags.index(True)
            const_node = preds[1 - enc_idx]
            if const_node.operation != Operation.Constant:
                raise RuntimeError(
                    f"'{node.name}' between an encrypted value and a "
                    "non-constant clear value is not supported; make the "
                    "clear side a constant or encrypt it")
            const = np.asarray(const_node.properties["constant"])
            if const.size != 1:
                raise RuntimeError(
                    f"'{node.name}' with a non-scalar clear constant needs "
                    "per-element tables; not supported yet")
            c = const.reshape(()).item()
            if enc_idx == 0:
                fn = (lambda v, ev=ev, c=c: ev(v, c))
            else:
                fn = (lambda v, ev=ev, c=c: ev(c, v))
            new_node = Node.generic(
                "univariate", [preds[enc_idx].output], node.output, fn,
                function=lambda v, fn=fn: int(fn(np.int64(v))))
            sources = [preds[enc_idx]]

        g.add_node(new_node)
        for i, src in enumerate(sources):
            g.add_edge(src, new_node, input_idx=i)
        for _, succ, key, data in list(g.out_edges(node, keys=True,
                                                   data=True)):
            g.add_edge(new_node, succ, **data)
        g.remove_node(node)
        for pos, n2 in list(graph.output_nodes.items()):
            if n2 is node:
                graph.output_nodes[pos] = new_node
        for pr in preds:
            _prune_backwards(graph, pr)


def fuse_float_subgraphs(graph: Graph) -> None:
    """Collapse float subgraphs with a single integer source and a single
    integer terminal into one univariate TLU node.

    Reference: compilation/utils.py:208 `fuse` /
    `find_float_subgraph_with_unique_terminal_node` — the mechanism that makes
    arbitrary univariate float numpy code compilable.  Here the subgraph is
    replayed through the nodes' own evaluators to build the fused function.
    """
    from concrete_tpu_torch.dtypes import Float

    g = graph.graph

    def is_float(node):
        return isinstance(node.output.dtype, Float)

    # terminals: integer-valued nodes whose predecessors include float nodes
    changed = True
    while changed:
        changed = False
        for node in list(nx.topological_sort(g)):
            preds = graph.ordered_preds_of(node)
            if not preds or not any(is_float(p) for p in preds):
                continue
            if is_float(node):
                continue
            # walk the float region backwards to find integer sources
            region = set()
            sources = set()
            stack = [p for p in preds if is_float(p)]
            while stack:
                cur = stack.pop()
                if cur in region:
                    continue
                region.add(cur)
                for q in graph.ordered_preds_of(cur):
                    if is_float(q):
                        stack.append(q)
                    elif q.operation == Operation.Constant:
                        region.add(q)
                    else:
                        sources.add(q)
            int_preds = [p for p in preds
                         if not is_float(p)
                         and p.operation != Operation.Constant]
            sources |= set(int_preds)
            if len(sources) != 1:
                raise RuntimeError(
                    "cannot fuse float subgraph: it depends on "
                    f"{len(sources)} integer sources (only single-source "
                    "float subgraphs are fusable, like the reference)")
            source = next(iter(sources))
            # replay function: evaluate region + node with source value v
            chain = [n for n in nx.topological_sort(g)
                     if n in region or n is node]
            pred_map = {n: graph.ordered_preds_of(n) for n in chain}

            def fused(v, chain=chain, pred_map=pred_map, source=source):
                values = {source: np.asarray(v)}
                for n in chain:
                    if n.operation == Operation.Constant:
                        values[n] = n()
                    else:
                        args = [values[q] for q in pred_map[n]]
                        values[n] = n(*args)
                return values[chain[-1]]

            new_node = Node.generic(
                "univariate", [source.output], node.output, fused,
                function=lambda s, fused=fused: int(np.rint(
                    np.asarray(fused(s), dtype=np.float64))))
            g.add_node(new_node)
            g.add_edge(source, new_node, input_idx=0)
            for _, succ, key, data in list(g.out_edges(node, keys=True,
                                                       data=True)):
                g.add_edge(new_node, succ, **data)
            for pos, n2 in list(graph.output_nodes.items()):
                if n2 is node:
                    graph.output_nodes[pos] = new_node
            g.remove_node(node)
            # drop now-orphaned float nodes
            for n in list(region):
                if n in g and not any(True for _ in g.out_edges(n)):
                    _prune_backwards(graph, n)
            changed = True
            break


def _prune_backwards(graph: Graph, node) -> None:
    g = graph.graph
    preds = graph.ordered_preds_of(node)
    if node in g and not any(True for _ in g.out_edges(node)) \
            and node not in graph.output_nodes.values() \
            and node not in graph.input_nodes.values():
        g.remove_node(node)
        for p in preds:
            _prune_backwards(graph, p)


ROUNDING_OPS = ("round_bit_pattern", "truncate_bit_pattern")


def process_rounding(graph: Graph) -> None:
    """Decide fusion for round/truncate_bit_pattern nodes.

    Reference: mlir/processors/process_rounding.py:17.  A pattern node whose
    consumers are ALL table lookups survives as-is: the executor lowers it to
    (at most) a ciphertext bias and each consumer TLU is built at the reduced
    width p - lsbs, so the PBS's modulus switch performs the rounding for
    free.  Any other use (arithmetic, output, packing) needs the rounded
    *value*, which costs one explicit TLU — demote those to univariate.
    """
    g = graph.graph
    for node in list(g.nodes):
        if node.name not in ROUNDING_OPS:
            continue
        consumers = [v for _, v in g.out_edges(node)]
        fusable = (consumers
                   and all(c.name in ("tlu", "univariate")
                           for c in consumers)
                   and node not in graph.output_nodes.values())
        if fusable:
            continue
        fn = node.properties["kwargs"]["function"]
        node.properties["name"] = "univariate"
        node.properties["kwargs"] = {"function": fn}


def check_integer_only(graph: Graph) -> None:
    """Post-fusing validation (reference CheckIntegerOnly processor)."""
    from concrete_tpu_torch.dtypes import Float
    for node in graph.graph.nodes:
        if isinstance(node.output.dtype, Float):
            raise RuntimeError(
                f"float operation '{node.name}' survives fusing; only float "
                "subgraphs with one integer input and one integer output "
                "can be compiled (wrap with .astype(np.int64))")


def run_default_transforms(graph: Graph, enable_tlu_fusing: bool = True,
                           print_tlu_fusing: bool = False,
                           approximate_rounding: bool = False) -> None:
    """The default pass pipeline (reference Pipeline.cpp high-level FHE
    transforms + the frontend graph processors).

    enable_tlu_fusing / print_tlu_fusing: gate and trace float-subgraph
    fusing (Configuration.enable_tlu_fusing).  approximate_rounding marks
    truncate nodes so the executor skips the half-step bias correction
    (Configuration.rounding_exactness = Exactness.APPROXIMATE).
    """
    lower_encrypted_multiplication(graph)
    lower_nonlinear_binary_ops(graph)
    if enable_tlu_fusing:
        before = len(graph.graph.nodes)
        fuse_float_subgraphs(graph)
        if print_tlu_fusing:
            print(f"tlu fusing: {before} -> {len(graph.graph.nodes)} nodes")
    process_rounding(graph)
    if approximate_rounding:
        for node in graph.graph.nodes:
            if node.name in ROUNDING_OPS:
                node.properties["approximate"] = True
    check_integer_only(graph)


def _vd(shape, bits):
    from concrete_tpu_torch.dtypes import Integer
    return ValueDescription(dtype=Integer(bits, False), shape=shape,
                            is_encrypted=True)


def _add_node(g, node, lo, hi, *preds):
    node.bounds = (lo, hi)
    g.add_node(node)
    for idx, p in enumerate(preds):
        g.add_edge(p, node, input_idx=idx)
    return node


def _unsigned_operand_widths(diff, ops):
    """(diff_width, max operand width) for an all-encrypted unsigned
    subtract, or None when bounds are missing / an operand is signed
    (signed operands keep the one-TLU lowering)."""
    from concrete_tpu_torch.dtypes import Integer
    if diff.bounds is None or any(q.bounds is None for q in ops):
        return None
    d_lo, d_hi = diff.bounds
    diff_width = Integer.that_can_represent(
        np.array([d_lo, d_hi])).bit_width
    widths = []
    for q in ops:
        lo, hi = q.bounds
        if lo < 0:
            return None
        widths.append(max(int(hi).bit_length(), 1))
    return diff_width, max(widths)


def _chunk_extract(graph, src, i, c):
    """Per-chunk extraction TLU: (src >> c*i) & (2^c - 1).  Keeps the
    OPERAND's own shape (sizing by the consumer's broadcast shape would
    overcount PBS work)."""
    mask = (1 << c) - 1
    shift = c * i
    fn = (lambda s: (lambda v: (np.asarray(v) >> s) & mask))(shift)
    n2 = Node.generic("univariate", [src.output],
                      _vd(src.output.shape, c),
                      lambda v, f=fn: f(v).astype(np.int64),
                      function=fn)
    return _add_node(graph.graph, n2, 0, mask, src)


def _sign_fold_acc(graph, x_node, y_node, shape, c, n_chunks):
    """Chunked three-way comparison: per-chunk packed sign TLUs
    (0 eq, 1 gt, 2 lt) MSB-first-folded into one accumulator node.
    Also returns the per-operand chunk extraction nodes for reuse."""
    g = graph.graph

    def sign_fn(a, b):
        return 0 if a == b else (1 if a > b else 2)

    signs, xs, ys = [], [], []
    for i in range(n_chunks):
        xi = _chunk_extract(graph, x_node, i, c)
        yi = _chunk_extract(graph, y_node, i, c)
        xs.append(xi)
        ys.append(yi)
        sn = Node.generic(
            "multivariate", [xi.output, yi.output], _vd(shape, 2),
            lambda a, b: np.vectorize(sign_fn, otypes=[np.int64])(a, b),
            function=sign_fn)
        signs.append(_add_node(g, sn, 0, 2, xi, yi))

    acc = signs[-1]                       # most significant chunk
    for sn in reversed(signs[:-1]):
        def fold_fn(a, s):
            return a if a != 0 else s
        an = Node.generic(
            "multivariate", [acc.output, sn.output], _vd(shape, 2),
            lambda a, s: np.vectorize(fold_fn, otypes=[np.int64])(a, s),
            function=fold_fn)
        acc = _add_node(g, an, 0, 2, acc, sn)
    return acc, xs, ys


def _replace_node(graph, node, new_node):
    g = graph.graph
    for _, succ, key, data in list(g.out_edges(node, keys=True, data=True)):
        g.add_edge(new_node, succ, **data)
    g.remove_node(node)
    for pos, n2 in list(graph.output_nodes.items()):
        if n2 is node:
            graph.output_nodes[pos] = new_node


def _prune_dead(graph):
    """Remove nodes left with no consumers after a rewrite (a dead wide
    subtract would otherwise inflate its operands' encoding-width class)."""
    g = graph.graph
    protected = set(graph.output_nodes.values()) \
        | set(graph.input_nodes.values())
    changed = True
    while changed:
        changed = False
        for n in list(g.nodes):
            if n not in protected and g.out_degree(n) == 0:
                g.remove_node(n)
                changed = True


def chunk_wide_comparisons(graph: Graph, native_bits: int = 8,
                           force: bool = False) -> int:
    """Chunked comparison strategy for unsigned operands (reference
    mlir/context.py:880 ComparisonStrategy CHUNKED).

    A comparison traces as univariate(x - y) — one TLU at the *promoted
    difference* width.  When that width exceeds `native_bits` (so the
    one-TLU form would need a WoP-PBS) but each operand fits natively, the
    node is rewritten into per-chunk native TLUs:

      x_i, y_i   <- chunk extraction TLUs (width of x / y)
      sign_i     <- multivariate packed TLU on (x_i, y_i): 0 eq, 1 gt, 2 lt
      acc        <- MSB-first fold: acc = acc if acc != 0 else sign_i
      result     <- verdict TLU on the final acc

    ~4*ceil(w/c) native TLUs instead of one (w+1)-bit WoP-PBS — and no
    PFPKSK/WoP keys needed.  `force=True` (the explicit
    ComparisonStrategy.CHUNKED preference) chunks even when the one-TLU
    form fits natively.  Runs AFTER bounds measurement (it needs widths);
    inserted nodes get explicit bounds/dtypes.  Returns the number of
    comparisons rewritten.
    """
    g = graph.graph
    c = native_bits // 2
    rewritten = 0

    targets = [n for n in list(g.nodes)
               if n.properties.get("comparison")
               and n.name == "univariate"]
    for node in targets:
        diff = graph.ordered_preds_of(node)
        if len(diff) != 1 or diff[0].name != "subtract":
            continue
        diff = diff[0]
        ops = graph.ordered_preds_of(diff)
        if len(ops) != 2 or not all(q.output.is_encrypted for q in ops):
            continue
        x_node, y_node = ops
        dw = _unsigned_operand_widths(diff, ops)
        if dw is None:
            continue
        diff_width, w = dw
        if (diff_width <= native_bits and not force) or w > native_bits:
            continue  # native one-TLU is fine / operands too wide anyway
        if w <= c and force:
            continue  # single-chunk "chunked" degenerates to one TLU pair

        kind = node.properties["comparison"]
        shape = node.output.shape
        n_chunks = -(-w // c)

        acc, _, _ = _sign_fold_acc(graph, x_node, y_node, shape, c,
                                   n_chunks)
        verdict = {
            "equal": lambda s: int(s == 0),
            "not_equal": lambda s: int(s != 0),
            "greater": lambda s: int(s == 1),
            "greater_equal": lambda s: int(s != 2),
            "less": lambda s: int(s == 2),
            "less_equal": lambda s: int(s != 1),
        }[kind]
        out_n = Node.generic(
            "univariate", [acc.output], _vd(shape, 1),
            lambda v: np.vectorize(verdict, otypes=[np.int64])(v),
            function=verdict)
        _add_node(g, out_n, 0, 1, acc)
        out_n.properties["tag"] = node.properties.get("tag", "")
        _replace_node(graph, node, out_n)
        rewritten += 1

    if rewritten:
        _prune_dead(graph)
    return rewritten


def chunk_wide_minmax(graph: Graph, native_bits: int = 8,
                      force: bool = False) -> int:
    """Chunked min/max strategy for unsigned operands (reference
    mlir/context.py minimum/maximum, MinMaxStrategy.CHUNKED).

    min/max trace as `y + relu(x - y)` / `x - relu(x - y)` (FHEMaxTransform
    semantics) — one relu TLU at the promoted signed-difference width.
    When that width exceeds `native_bits` (the one-TLU form would need a
    WoP-PBS) but each operand fits natively, the relu node is rewritten
    chunk-wise:

      gt          <- chunked comparison boolean x > y (sign TLUs + fold)
      out_i       <- mv(gt, x_i): gt ? x_i : 0   +   mv(gt, y_i): gt ? 0 : y_i
      max(x, y)   <- sum_i out_i << (c*i)          (linear recombination)
      relu(x - y) <- max(x, y) - y                 (linear)

    so the surrounding `y + relu(...)` / `x - relu(...)` reconstruction
    keeps working unchanged.  ~(4*ceil(w/c) + ceil(w/c)) native TLUs, no
    WoP keys.  `force=True` (explicit MinMaxStrategy.CHUNKED preference)
    chunks even when the one-TLU form fits.  Returns the number of relu
    nodes rewritten.
    """
    g = graph.graph
    c = native_bits // 2
    rewritten = 0

    targets = [n for n in list(g.nodes)
               if n.properties.get("minmax_relu")
               and n.name == "univariate"]
    for node in targets:
        diff = graph.ordered_preds_of(node)
        if len(diff) != 1 or diff[0].name != "subtract":
            continue
        diff = diff[0]
        ops = graph.ordered_preds_of(diff)
        if len(ops) != 2 or not all(q.output.is_encrypted for q in ops):
            continue
        x_node, y_node = ops
        dw = _unsigned_operand_widths(diff, ops)
        if dw is None:
            continue
        diff_width, w = dw
        if (diff_width <= native_bits and not force) or w > native_bits:
            continue
        if w <= c and force:
            continue

        shape = node.output.shape
        n_chunks = -(-w // c)
        mask = (1 << c) - 1

        acc, xs, ys = _sign_fold_acc(graph, x_node, y_node, shape, c,
                                     n_chunks)
        gt_n = Node.generic(
            "univariate", [acc.output], _vd(shape, 1),
            lambda v: (np.asarray(v) == 1).astype(np.int64),
            function=lambda s: int(s == 1))
        gt = _add_node(g, gt_n, 0, 1, acc)

        def sel(flag_wanted, chunk, shift, hi):
            # the chunk's positional shift is baked into the TLU output
            # (free, and TLU output noise is fresh regardless of output
            # magnitude — a multiply-by-2^shift node would amplify norm2)
            fn = (lambda fw, sh: (
                lambda cc, v: (int(v) << sh) if cc == fw else 0))(
                flag_wanted, shift)
            mv = Node.generic(
                "multivariate", [gt.output, chunk.output],
                _vd(shape, max(int(hi << shift).bit_length(), 1)),
                lambda cc, v, f=fn:
                    np.vectorize(f, otypes=[np.int64])(cc, v),
                function=fn)
            return _add_node(g, mv, 0, hi << shift, gt, chunk)

        # max(x, y) = sum_i ((gt ? x_i : 0) + (gt ? 0 : y_i)) << c*i.
        # Bounds are TIGHT, not naive-sum: exactly one select branch per
        # position is nonzero (both are keyed on the same gt), and the
        # top chunk of a w'-bit operand is narrower than the chunk mask —
        # loose bounds here would inflate y's encoding-width class past
        # the native TLU limit and force the extractions onto WoP.
        x_hi = int(x_node.bounds[1])
        y_hi = int(y_node.bounds[1])
        maxv, hi_sum = None, 0
        for i in range(n_chunks):
            xc_hi = min(mask, x_hi >> (c * i))
            yc_hi = min(mask, y_hi >> (c * i))
            sx = sel(1, xs[i], c * i, xc_hi)
            sy = sel(0, ys[i], c * i, yc_hi)
            pair_hi = max(xc_hi, yc_hi) << (c * i)
            pn = Node.generic(
                "add", [sx.output, sy.output],
                _vd(shape, max(int(pair_hi).bit_length(), 1)),
                lambda a, b: a + b)
            pair = _add_node(g, pn, 0, pair_hi, sx, sy)
            if maxv is None:
                maxv, hi_sum = pair, pair_hi
            else:
                hi_sum += pair_hi
                an = Node.generic(
                    "add", [maxv.output, pair.output],
                    _vd(shape, max(int(hi_sum).bit_length(), 1)),
                    lambda a, b: a + b)
                maxv = _add_node(g, an, 0, hi_sum, maxv, pair)
        # relu(x - y) = max(x, y) - y (linear; the surrounding min/max
        # reconstruction `y + relu` / `x - relu` keeps working unchanged)
        relu_n = Node.generic(
            "subtract", [maxv.output, y_node.output],
            node.output, lambda a, b: a - b)
        relu_out = _add_node(g, relu_n, *node.bounds, maxv, y_node)
        relu_out.properties["tag"] = node.properties.get("tag", "")
        _replace_node(graph, node, relu_out)
        rewritten += 1

    if rewritten:
        _prune_dead(graph)
    return rewritten


def chunk_wide_encrypted_shifts(graph: Graph, native_bits: int = 8) -> int:
    """Chunked strategy for `enc << enc` / `enc >> enc` whose packed
    one-TLU form would exceed the native TLU width (reference
    mlir/context.py:3472 `shift`, CHUNKED branch).

    A traced encrypted shift is a packed multivariate TLU over
    (x * 2^pb + b) — fine while px + pb <= native_bits.  Beyond that the
    node is rewritten with the reference's per-bit trick: for each bit i
    of b (MSB first),

      y = (b_i ? (x << 2^i) - x : 0) + x          (left)
      y = x - (b_i ? x - (x >> 2^i) : 0)          (right)

    where the parenthesized "shifter" value is produced by per-chunk
    native TLUs on x, each packed with the 1-bit `b_i` TLU.

    Only RIGHT shifts are rewritten: a right shift never grows x, so all
    chunk TLUs stay native.  A left shift grows x by up to 2^pb - 1 bits,
    and whenever the chunked intermediates would still fit natively the
    packed form (px + pb bits) also fits — i.e. chunked left shifts would
    only ever run with wide (WoP) intermediate TLUs, which cost MORE than
    the single packed WoP TLU they replace; wide `enc << enc` therefore
    keeps the packed lowering on the CRT/WoP path.  (The reference can
    profit from chunked left shifts because its native TLU ceiling is 16
    bits; ours is 8 with WoP beyond.)  Runs after bounds measurement;
    returns the rewrite count.
    """
    from concrete_tpu_torch.dtypes import Integer

    g = graph.graph
    rewritten = 0

    def vd(shape, bits):
        return ValueDescription(dtype=Integer(bits, False), shape=shape,
                                is_encrypted=True)

    def add_node(node, lo, hi, *preds):
        node.bounds = (int(lo), int(hi))
        g.add_node(node)
        for idx, p in enumerate(preds):
            g.add_edge(p, node, input_idx=idx)
        return node

    targets = [n for n in list(g.nodes)
               if n.properties.get("shift") == "right"
               and n.name == "multivariate"]
    for node in targets:
        preds = graph.ordered_preds_of(node)
        if len(preds) != 2 or node.bounds is None \
                or any(q.bounds is None for q in preds):
            continue
        x_node, b_node = preds
        if any(q.bounds[0] < 0 for q in preds):
            continue                     # unsigned only, like the reference
        px = max(int(x_node.bounds[1]).bit_length(), 1)
        pb = max(int(b_node.bounds[1]).bit_length(), 1)
        if px + pb <= native_bits or pb > native_bits:
            continue                     # packed one-TLU stays / b too wide
        shape = node.output.shape
        # chunk TLU packs with the 1-bit b_i; staying one bit BELOW the
        # native edge keeps the packed TLU off the modulus-switch noise
        # cliff (a packed width == native runs at kappa ~1 on small N)
        chunk_in = native_bits - 2

        cur = x_node
        cur_hi = int(x_node.bounds[1])
        for i in reversed(range(pb)):
            to_check = 1 << i

            def shifter(v, t=to_check):
                return np.int64(v) - (np.int64(v) >> t)
            shifter_hi = cur_hi - (cur_hi >> to_check)
            shifter_bits = max(int(shifter_hi).bit_length(), 1)

            should = add_node(Node.generic(
                "univariate", [b_node.output], vd(b_node.output.shape, 1),
                lambda v, t=to_check: ((np.asarray(v) & t) > 0)
                .astype(np.int64),
                function=lambda v, t=to_check: int((int(v) & t) > 0)),
                0, 1, b_node)

            chunks = []
            for off in range(0, shifter_bits, chunk_in):
                bits_here = min(chunk_in, shifter_bits - off)
                rsh = shifter_bits - off - bits_here
                mask = (1 << bits_here) - 1

                def cfn(v, f=shifter, r=rsh, m=mask):
                    return (np.asarray(f(v), dtype=np.int64) >> r) & m
                chunk_x = add_node(Node.generic(
                    "univariate", [cur.output],
                    vd(cur.output.shape, bits_here),
                    cfn, function=lambda v, f=cfn: int(f(v))),
                    0, mask, cur)

                def efn(c, b, r=rsh):
                    return int(c) << r if int(b) else 0
                chunks.append(add_node(Node.generic(
                    "multivariate", [chunk_x.output, should.output],
                    vd(shape, max((mask << rsh).bit_length(), 1)),
                    lambda c, b: np.vectorize(efn, otypes=[np.int64])(c, b),
                    function=efn),
                    0, mask << rsh, chunk_x, should))

            diff = chunks[0]
            d_hi = diff.bounds[1]
            for ck in chunks[1:]:
                d_hi += ck.bounds[1]
                diff = add_node(Node.generic(
                    "add", [diff.output, ck.output],
                    vd(shape, max(int(d_hi).bit_length(), 1)),
                    lambda a, b: a + b), 0, d_hi, diff, ck)

            cur = add_node(Node.generic(
                "subtract", [cur.output, diff.output],
                vd(shape, max(int(cur_hi).bit_length(), 1)),
                lambda a, b: a - b), 0, cur_hi, cur, diff)

        cur.properties["tag"] = node.properties.get("tag", "")
        for _, succ, key, data in list(g.out_edges(node, keys=True,
                                                   data=True)):
            g.add_edge(cur, succ, **data)
        g.remove_node(node)
        for pos, n2 in list(graph.output_nodes.items()):
            if n2 is node:
                graph.output_nodes[pos] = cur
        rewritten += 1
    return rewritten
