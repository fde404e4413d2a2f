"""Type inference + structural validation for computation graphs.

The analog of the reference compiler's type-inference framework and op
verifiers (compilers/concrete-compiler/compiler/lib/Dialect/*: each op's
`verify()` + the TypeInference pass reject programs whose result types are
not derivable from operand types).  JAX re-checks shapes when the lowered
function is traced, but that happens late (first run) and its errors point
at jaxpr internals; and a *deserialized* graph (Server.load of a
deployment archive) carries attacker-controlled type records — this pass
makes a malformed archive fail closed at load time with a located error.

Checks per node:
- arity and operand binding (every declared input has exactly one edge);
- recorded operand types match the producing nodes' output types;
- the node's evaluator, run on neutral operands, reproduces the recorded
  output shape (shape inference);
- encryption propagation (an encrypted output needs an encrypted operand,
  except encrypted constants / inputs);
- dtype sanity (integer widths in [1, 64], encoding widths in [1, 32]).
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.representation.graph import Graph
from concrete_tpu_torch.representation.node import Node, Operation


class GraphTypeError(TypeError):
    """A node's types are inconsistent (malformed or corrupted graph)."""


#: ops whose output is encrypted without any encrypted operand
_SOURCE_OPS = ("encrypted_constant",)


def infer_output_shape(node: Node, operand_shapes: list[tuple]) -> tuple:
    """Re-derive the node's output shape by evaluating on neutral operands
    (ones — zeros would trip divide-style evaluators)."""
    args = [np.ones(s, dtype=np.int64) for s in operand_shapes]
    with np.errstate(all="ignore"):
        out = np.asarray(node(*args))
    return tuple(out.shape)


def validate_node(graph: Graph, node: Node) -> None:
    def fail(msg: str):
        raise GraphTypeError(f"%{node.uid} [{node.name}]: {msg}")

    ew = node.properties.get("encoding_width")
    if ew is not None and not (1 <= int(ew) <= 32):
        fail(f"encoding width {ew} outside [1, 32]")

    preds = graph.ordered_preds_of(node)
    if node.operation == Operation.Input:
        return
    if node.operation == Operation.Constant:
        if len(preds) != 0:
            fail("constant node has operands")
        got = tuple(np.asarray(node()).shape)
        if got != tuple(node.output.shape):
            fail(f"constant payload shape {got} != declared "
                 f"{tuple(node.output.shape)}")
        return

    if len(preds) != len(node.inputs):
        fail(f"{len(node.inputs)} declared operand(s) but {len(preds)} "
             "bound edge(s)")
    for i, (p, decl) in enumerate(zip(preds, node.inputs)):
        if tuple(p.output.shape) != tuple(decl.shape):
            fail(f"operand {i} shape {tuple(p.output.shape)} != declared "
                 f"{tuple(decl.shape)}")
        if p.output.is_encrypted != decl.is_encrypted:
            fail(f"operand {i} encryption {p.output.is_encrypted} != "
                 f"declared {decl.is_encrypted}")

    if node.output.is_encrypted and node.name not in _SOURCE_OPS \
            and not any(p.output.is_encrypted for p in preds):
        fail("encrypted output with no encrypted operand")

    dtype = node.output.dtype
    if node.output.is_encrypted and isinstance(dtype, Integer):
        if not (1 <= dtype.bit_width <= 64):
            fail(f"integer width {dtype.bit_width} outside [1, 64]")

    try:
        got = infer_output_shape(node, [tuple(p.output.shape)
                                        for p in preds])
    except GraphTypeError:
        raise
    except Exception as e:  # evaluator crashed on well-typed operands
        fail(f"evaluator failed on neutral operands: {e}")
    if got != tuple(node.output.shape):
        fail(f"inferred output shape {got} != declared "
             f"{tuple(node.output.shape)}")


def validate_graph(graph: Graph) -> None:
    """Validate every node; raises GraphTypeError on the first offender.

    Server.load runs this on deserialized archives so corrupted type
    records are rejected before any execution."""
    for pos, node in graph.input_nodes.items():
        if node not in graph.graph.nodes:
            raise GraphTypeError(f"input {pos} is not a graph node")
    for pos, node in graph.output_nodes.items():
        if node not in graph.graph.nodes:
            raise GraphTypeError(f"output {pos} is not a graph node")
    for node in graph.topological_order():
        validate_node(graph, node)
