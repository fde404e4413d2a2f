"""The tracer: builds a computation graph from a plain Python/NumPy function.

Reference: frontends/concrete-python/concrete/fhe/tracing/tracer.py:36-170 —
a proxy object overloading NumPy operators, producing a networkx DAG; rejects
data-dependent Python branching.  Same UX here: users write ordinary numpy
code over function parameters annotated "encrypted"/"clear".
"""

from __future__ import annotations

import inspect
from typing import Callable

import networkx as nx
import numpy as np

from concrete_tpu_torch.representation import Graph, Node, Operation
from concrete_tpu_torch.values import ValueDescription


class Tracer:
    """Proxy standing in for a value during tracing."""

    # -- graph construction helpers ---------------------------------------

    def __init__(self, node: Node, predecessors: list["Tracer"]):
        self.node = node
        self.predecessors = predecessors

    @staticmethod
    def _constant_tracer(value) -> "Tracer":
        return Tracer(Node.constant(value), [])

    @staticmethod
    def sanitize(value) -> "Tracer":
        return value if isinstance(value, Tracer) else \
            Tracer._constant_tracer(value)

    @classmethod
    def _generic(cls, name: str, operands: list["Tracer"],
                 evaluator: Callable, output: ValueDescription,
                 **kwargs) -> "Tracer":
        node = Node.generic(name, [t.node.output for t in operands], output,
                            evaluator, **kwargs)
        # snapshot the producing nodes NOW: a later __setitem__ rebinds the
        # operand tracers, but this node must keep its pre-assignment inputs
        node._pred_nodes = [t.node for t in operands]
        from concrete_tpu_torch.extensions.tag import current_tag
        t = current_tag()
        if t:
            node.properties["tag"] = t
        return cls(node, operands)

    @staticmethod
    def _infer_output(name: str, evaluator: Callable,
                      operands: list["Tracer"], **kwargs) -> ValueDescription:
        """Infer output shape/encryption by evaluating on zeros."""
        samples = []
        for t in operands:
            desc = t.node.output
            samples.append(np.zeros(desc.shape, dtype=np.int64)
                           if not _is_float(desc) else
                           np.zeros(desc.shape))
        result = np.asarray(evaluator(*samples))
        encrypted = any(t.node.output.is_encrypted for t in operands)
        return ValueDescription.of(result, is_encrypted=encrypted)

    # -- operator overloads ------------------------------------------------

    def _binary(self, name: str, other, evaluator, reflected=False):
        other = Tracer.sanitize(other)
        operands = [other, self] if reflected else [self, other]
        output = Tracer._infer_output(name, evaluator, operands)
        return Tracer._generic(name, operands, evaluator, output)

    def __add__(self, other):
        return self._binary("add", other, lambda x, y: x + y)

    def __radd__(self, other):
        return self._binary("add", other, lambda x, y: x + y, reflected=True)

    def __sub__(self, other):
        return self._binary("subtract", other, lambda x, y: x - y)

    def __rsub__(self, other):
        return self._binary("subtract", other, lambda x, y: x - y,
                            reflected=True)

    def __mul__(self, other):
        return self._binary("multiply", other, lambda x, y: x * y)

    def __rmul__(self, other):
        return self._binary("multiply", other, lambda x, y: x * y,
                            reflected=True)

    def __matmul__(self, other):
        other = Tracer.sanitize(other)
        if (self.node.output.is_encrypted
                and other.node.output.is_encrypted):
            return _encrypted_matmul(self, other)
        return self._binary("matmul", other, lambda x, y: x @ y)

    def __rmatmul__(self, other):
        other = Tracer.sanitize(other)
        if (self.node.output.is_encrypted
                and other.node.output.is_encrypted):
            return _encrypted_matmul(other, self)
        return self._binary("matmul", other, lambda x, y: x @ y,
                            reflected=True)

    def __neg__(self):
        output = Tracer._infer_output("negative", lambda x: -x, [self])
        return Tracer._generic("negative", [self], lambda x: -x, output)

    def __pos__(self):
        return self

    def __getitem__(self, index):
        if isinstance(index, Tracer):
            # dynamic TLU: a CLEAR runtime tensor indexed by an encrypted
            # value lowers to a PBS whose table is built at run time
            # (reference Pipeline.cpp DynamicTLU / FHE.apply_lookup_table
            # with a tensor operand)
            if self.node.output.is_encrypted:
                raise TypeError(
                    "indexing an encrypted tensor by an encrypted index is "
                    "not supported; dynamic table lookups need a CLEAR "
                    "table (or use fhe.LookupTable for static tables)")

            def ev(t, i):
                return np.asarray(t)[np.asarray(i)]

            output = Tracer._infer_output("dynamic_tlu", ev, [self, index])
            return Tracer._generic("dynamic_tlu", [self, index], ev, output)
        ev = lambda x: x[index]  # noqa: E731
        output = Tracer._infer_output("index", ev, [self])
        return Tracer._generic("index", [self], ev, output, index=index)

    def __setitem__(self, index, value):
        """x[index] = value inside a traced function (static or fancy
        assignment, reference FHELinalgOps.td fancy_assign): creates an
        `assign` node and rebinds this tracer to it — nodes created
        *before* the assignment keep the pre-assignment value (they
        snapshotted the producing node at creation)."""
        value = Tracer.sanitize(value)

        def ev(x, v):
            out = np.array(x)
            out[index] = v
            return out

        output = Tracer._infer_output("assign", ev, [self, value])
        new = Tracer._generic("assign", [self, value], ev, output,
                              index=index)
        self.node = new.node
        self.predecessors = new.predecessors

    # numpy ufunc/function protocol so np.* works on tracers ---------------

    SUPPORTED_UFUNCS = {
        np.add: ("add", lambda x, y: x + y),
        np.subtract: ("subtract", lambda x, y: x - y),
        np.multiply: ("multiply", lambda x, y: x * y),
        np.negative: ("negative", lambda x: -x),
        np.matmul: ("matmul", lambda x, y: x @ y),
        np.true_divide: ("divide", lambda x, y: x / y),
        np.floor_divide: ("floor_divide", lambda x, y: x // y),
        np.mod: ("mod", lambda x, y: x % y),
        np.power: ("power", lambda x, y: x ** y),
    }

    # float pointwise ufuncs: traceable, must later fuse into a TLU
    # (reference compilation/utils.py:208 float-subgraph fusing)
    FLOAT_UFUNCS = {
        np.sin, np.cos, np.tan, np.exp, np.log, np.log2, np.log10, np.sqrt,
        np.tanh, np.sinh, np.cosh, np.arctan, np.arcsin, np.arccos,
        np.floor, np.ceil, np.rint, np.abs, np.absolute, np.sign, np.cbrt,
        np.expm1, np.log1p,
    }

    def __array_ufunc__(self, ufunc, method, *args, **kwargs):
        if method == "__call__" and ufunc in Tracer.UFUNC_BUILDERS:
            return Tracer.UFUNC_BUILDERS[ufunc](*args)
        if method == "__call__" and ufunc in Tracer.FLOAT_UFUNCS:
            fn = ufunc

            def ev(x):
                return fn(np.asarray(x, dtype=np.float64))
            operands = [Tracer.sanitize(a) for a in args]
            output = Tracer._infer_output(ufunc.__name__, ev, operands)
            return Tracer._generic(ufunc.__name__, operands, ev, output)
        if method != "__call__" or ufunc not in Tracer.SUPPORTED_UFUNCS:
            raise RuntimeError(
                f"numpy ufunc {ufunc.__name__} is not supported on encrypted "
                "values yet; use fhe.univariate for pointwise functions")
        name, ev = Tracer.SUPPORTED_UFUNCS[ufunc]
        operands = [Tracer.sanitize(a) for a in args]
        output = Tracer._infer_output(name, ev, operands)
        return Tracer._generic(name, operands, ev, output)

    SUPPORTED_FUNCS = {}  # populated below

    def __array_function__(self, func, types, args, kwargs):
        handler = Tracer.SUPPORTED_FUNCS.get(func)
        if handler is None:
            raise RuntimeError(
                f"numpy function {func.__name__} is not supported on "
                "encrypted values yet")
        return handler(*args, **kwargs)

    def astype(self, dtype):
        """Cast; float->int rounds to nearest (reference tracer semantics:
        the cast terminates a float subgraph that fuse() collapses to a TLU).
        """
        np_dtype = np.dtype(dtype)
        if np.issubdtype(np_dtype, np.integer) or np_dtype == np.bool_:
            def ev(x):
                return np.rint(np.asarray(x)).astype(np.int64)
            output = Tracer._infer_output("astype", ev, [self])
            return Tracer._generic("astype", [self], ev, output)

        def ev(x):
            return np.asarray(x, dtype=np.float64)
        output = Tracer._infer_output("astype_float", ev, [self])
        return Tracer._generic("astype_float", [self], ev, output)

    def __truediv__(self, other):
        return self._binary("divide", other, lambda x, y: x / y)

    def __rtruediv__(self, other):
        return self._binary("divide", other, lambda x, y: x / y,
                            reflected=True)

    def __floordiv__(self, other):
        return self._binary("floor_divide", other, lambda x, y: x // y)

    def __rfloordiv__(self, other):
        return self._binary("floor_divide", other, lambda x, y: x // y,
                            reflected=True)

    def __mod__(self, other):
        return self._binary("mod", other, lambda x, y: x % y)

    def __rmod__(self, other):
        return self._binary("mod", other, lambda x, y: x % y,
                            reflected=True)

    def __pow__(self, other):
        return self._binary("power", other, lambda x, y: x ** y)

    def __rpow__(self, other):
        return self._binary("power", other, lambda x, y: x ** y,
                            reflected=True)

    def sum(self, axis=None):
        ev = lambda x: np.sum(x, axis=axis)  # noqa: E731
        output = Tracer._infer_output("sum", ev, [self])
        return Tracer._generic("sum", [self], ev, output, axis=axis)

    def transpose(self, axes=None):
        ev = lambda x: np.transpose(x, axes)  # noqa: E731
        output = Tracer._infer_output("transpose", ev, [self])
        return Tracer._generic("transpose", [self], ev, output, axes=axes)

    @property
    def T(self):  # noqa: N802
        return self.transpose()

    def min(self, axis=None):
        return _reduce_minmax(self, axis, is_max=False)

    def max(self, axis=None):
        return _reduce_minmax(self, axis, is_max=True)

    def clip(self, lo, hi):
        from concrete_tpu_torch.extensions.univariate import univariate
        return univariate(lambda v, lo=int(lo), hi=int(hi):
                          min(max(int(v), lo), hi))(self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        ev = lambda x: np.reshape(x, shape)  # noqa: E731
        output = Tracer._infer_output("reshape", ev, [self])
        return Tracer._generic("reshape", [self], ev, output, shape=shape)

    def flatten(self):
        ev = lambda x: np.reshape(x, (-1,))  # noqa: E731
        output = Tracer._infer_output("reshape", ev, [self])
        return Tracer._generic("reshape", [self], ev, output, shape=(-1,))

    @property
    def shape(self):
        return self.node.output.shape

    @property
    def ndim(self):
        return len(self.node.output.shape)

    @property
    def size(self):
        return self.node.output.size

    def __len__(self):
        if not self.node.output.shape:
            raise TypeError("len() of unsized (scalar) encrypted value")
        return self.node.output.shape[0]

    def __bool__(self):
        raise RuntimeError(
            "cannot branch on an encrypted value: FHE circuits must be "
            "data-independent (reference tracer rejects this too)")

    # comparisons: the reference's "subtraction trick" strategy
    # (mlir/context.py:700): compare via the sign of x - y, one TLU over a
    # signed (p+1)-bit difference.

    def _comparison(self, other, predicate, name):
        diff = self - other
        ev_fn = predicate

        def evaluator(v):
            return ev_fn(np.asarray(v)).astype(np.int64)

        output = Tracer._infer_output(name, evaluator, [diff])
        out = Tracer._generic("univariate", [diff], evaluator, output,
                              function=lambda v: int(ev_fn(np.asarray(v))))
        # mark for the chunked-comparison strategy (transforms.py
        # chunk_wide_comparisons; reference mlir/context.py:880 catalog)
        out.node.properties["comparison"] = name
        return out

    def __gt__(self, other):
        return self._comparison(other, lambda d: d > 0, "greater")

    def __ge__(self, other):
        return self._comparison(other, lambda d: d >= 0, "greater_equal")

    def __lt__(self, other):
        return self._comparison(other, lambda d: d < 0, "less")

    def __le__(self, other):
        return self._comparison(other, lambda d: d <= 0, "less_equal")

    def __eq__(self, other):  # noqa: A003
        return self._comparison(other, lambda d: d == 0, "equal")

    def __ne__(self, other):
        return self._comparison(other, lambda d: d != 0, "not_equal")

    __hash__ = object.__hash__

    # bitwise: packed two-operand TLU (reference bitwise strategies,
    # mlir/context.py chunked/packed lowering)

    def _bitwise(self, other, fn, name):
        from concrete_tpu_torch.extensions.multivariate import multivariate
        other = Tracer.sanitize(other)
        if not other.node.output.is_encrypted and \
                other.node.operation == Operation.Constant:
            const = other.node.properties["constant"]
            return Tracer._generic(
                "univariate", [self],
                lambda x: fn(np.asarray(x), const).astype(np.int64),
                Tracer._infer_output(name, lambda x: fn(np.asarray(x), const),
                                     [self]),
                function=lambda v: int(fn(np.int64(v), const)))
        return multivariate(lambda a, b: int(fn(np.int64(a), np.int64(b))))(
            self, other)

    def __and__(self, other):
        return self._bitwise(other, np.bitwise_and, "bitwise_and")

    def __rand__(self, other):
        return self._bitwise(other, np.bitwise_and, "bitwise_and")

    def __or__(self, other):
        return self._bitwise(other, np.bitwise_or, "bitwise_or")

    def __ror__(self, other):
        return self._bitwise(other, np.bitwise_or, "bitwise_or")

    def __xor__(self, other):
        return self._bitwise(other, np.bitwise_xor, "bitwise_xor")

    def __rxor__(self, other):
        return self._bitwise(other, np.bitwise_xor, "bitwise_xor")

    def __rshift__(self, other):
        if isinstance(other, Tracer):
            from concrete_tpu_torch.extensions.multivariate import multivariate
            out = multivariate(lambda a, b: int(a) >> int(b))(self, other)
            # tagged for transforms.chunk_wide_encrypted_shifts (reference
            # mlir/context.py:3472 shift strategies)
            out.node.properties["shift"] = "right"
            return out
        k = int(other)
        return Tracer._generic(
            "univariate", [self], lambda x: np.asarray(x) >> k,
            Tracer._infer_output("right_shift", lambda x: np.asarray(x) >> k,
                                 [self]),
            function=lambda v: int(v) >> k)

    def __lshift__(self, other):
        if isinstance(other, Tracer):
            from concrete_tpu_torch.extensions.multivariate import multivariate
            out = multivariate(lambda a, b: int(a) << int(b))(self, other)
            out.node.properties["shift"] = "left"
            return out
        return self * (1 << int(other))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- trace entry point (reference tracer.py:36) ------------------------

    @staticmethod
    def trace(function: Callable, encryption_statuses: dict[str, str],
              sample=None, name: str = None) -> Graph:
        """Trace `function` into a Graph.  `sample` (one inputset element)
        provides parameter shapes — the reference sizes parameters the same
        way from the inputset (compilation/compiler.py)."""
        sig = inspect.signature(function)
        params = list(sig.parameters)
        missing = set(params) - set(encryption_statuses)
        if missing:
            raise ValueError(
                f"encryption status not specified for parameter(s) {missing}")
        if sample is not None and not isinstance(sample, tuple):
            sample = (sample,)
        input_nodes: dict[int, Node] = {}
        arg_list = []
        for pos, pname in enumerate(params):
            status = encryption_statuses[pname]
            if sample is not None:
                desc = ValueDescription.of(
                    sample[pos], is_encrypted=(status == "encrypted"))
            else:
                desc = ValueDescription(dtype=None, shape=(),
                                        is_encrypted=(status == "encrypted"))
            node = Node.input(pname, desc)
            # snapshot: __setitem__ may rebind the tracer, but the circuit
            # input stays this Input node
            input_nodes[pos] = node
            arg_list.append(Tracer(node, []))
        result = function(*arg_list)
        outputs = result if isinstance(result, tuple) else (result,)
        outputs = tuple(Tracer.sanitize(o) for o in outputs)

        g = nx.MultiDiGraph()
        visited = set()

        def add(node: Node):
            if node in visited:
                return
            visited.add(node)
            g.add_node(node)
            for idx, pn in enumerate(getattr(node, "_pred_nodes", ())):
                add(pn)
                g.add_edge(pn, node, input_idx=idx)

        for t in outputs:
            add(t.node)
        for node in input_nodes.values():
            g.add_node(node)

        return Graph(
            g,
            input_nodes=input_nodes,
            output_nodes={i: t.node for i, t in enumerate(outputs)},
            name=name or function.__name__)


def _is_float(desc: ValueDescription) -> bool:
    from concrete_tpu_torch.dtypes import Float
    return isinstance(desc.dtype, Float)


def _reduce_minmax(t, axis, is_max: bool):
    """min/max reduction as a tree of pairwise maximum/minimum (each pair =
    one relu TLU, reference FHELinalg maxpool-style reduction)."""
    combine = _np_maximum if is_max else _np_minimum
    if t.ndim == 0:
        return t
    if axis is None:
        flat = t.flatten()
        items = [flat[i] for i in range(flat.shape[0])]
    else:
        items = [t[tuple([slice(None)] * axis + [i])]
                 for i in range(t.shape[axis])]
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(combine(items[i], items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _np_concatenate(arrays, axis=0, **kw):
    operands = [Tracer.sanitize(a) for a in arrays]
    ev = lambda *xs: np.concatenate(xs, axis=axis)  # noqa: E731
    output = Tracer._infer_output("concatenate", ev, operands)
    return Tracer._generic("concatenate", operands, ev, output, axis=axis)


def _np_transpose(a, axes=None, **kw):
    return Tracer.sanitize(a).transpose(axes)


def _np_broadcast_to(a, shape, **kw):
    a = Tracer.sanitize(a)
    ev = lambda x: np.broadcast_to(x, shape)  # noqa: E731
    output = Tracer._infer_output("broadcast_to", ev, [a])
    return Tracer._generic("broadcast_to", [a], ev, output,
                           shape=tuple(shape))


def _np_clip(a, lo, hi, **kw):
    return Tracer.sanitize(a).clip(lo, hi)


def _np_min(a, axis=None, **kw):
    return _reduce_minmax(Tracer.sanitize(a), axis, is_max=False)


def _np_max(a, axis=None, **kw):
    return _reduce_minmax(Tracer.sanitize(a), axis, is_max=True)


def _np_sum(a, axis=None, **kw):
    return a.sum(axis=axis)


def _np_reshape(a, shape, **kw):
    return a.reshape(shape)


def _np_dot(a, b, **kw):
    a = Tracer.sanitize(a)
    b = Tracer.sanitize(b)
    if a.node.output.is_encrypted and b.node.output.is_encrypted:
        return _encrypted_matmul(a, b)
    ev = lambda x, y: np.dot(x, y)  # noqa: E731
    output = Tracer._infer_output("dot", ev, [a, b])
    return Tracer._generic("dot", [a, b], ev, output)


def _encrypted_matmul(a: "Tracer", b: "Tracer"):
    """encrypted @ encrypted: decompose into broadcast enc*enc products
    (each 2 TLUs via EncryptedMulToDoubleTLU) plus a leveled sum.

    Reference: FHELinalg eint x eint matmul variants (FHELinalgOps.td
    matmul_eint_eint) lower the same way — per-pair multiplication TLUs and
    a leveled accumulation.
    """
    an = len(a.node.output.shape)
    bn = len(b.node.output.shape)
    if an == 1 and bn == 1:
        return (a * b).sum()
    if an == 2 and bn == 2:
        return (a[:, :, None] * b[None, :, :]).sum(axis=1)
    if an == 1 and bn == 2:
        return (a[:, None] * b).sum(axis=0)
    if an == 2 and bn == 1:
        return (a * b[None, :]).sum(axis=1)
    raise RuntimeError(
        "encrypted @ encrypted matmul supports 1-D and 2-D operands "
        f"(got {an}-D @ {bn}-D)")


def _relu_diff(x, y):
    """relu(x - y) as one TLU over the signed difference."""
    diff = Tracer.sanitize(x) - Tracer.sanitize(y)
    ev = lambda v: np.maximum(np.asarray(v), 0)  # noqa: E731
    output = Tracer._infer_output("relu", ev, [diff])
    out = Tracer._generic("univariate", [diff], ev, output,
                          function=lambda v: max(int(v), 0))
    # marks the min/max relu-of-difference for the chunked lowering
    # (transforms.chunk_wide_minmax, MinMaxStrategy.CHUNKED)
    out.node.properties["minmax_relu"] = True
    return out


def _np_maximum(x, y):
    """max(x, y) = y + relu(x - y) (reference FHEMaxTransform semantics)."""
    return Tracer.sanitize(y) + _relu_diff(x, y)


def _np_minimum(x, y):
    return Tracer.sanitize(x) - _relu_diff(x, y)


Tracer.UFUNC_BUILDERS = {
    np.matmul: lambda x, y: Tracer.sanitize(x).__matmul__(y),
    np.maximum: _np_maximum,
    np.minimum: _np_minimum,
    np.greater: lambda x, y: Tracer.sanitize(x).__gt__(y),
    np.greater_equal: lambda x, y: Tracer.sanitize(x).__ge__(y),
    np.less: lambda x, y: Tracer.sanitize(x).__lt__(y),
    np.less_equal: lambda x, y: Tracer.sanitize(x).__le__(y),
    np.equal: lambda x, y: Tracer.sanitize(x).__eq__(y),
    np.not_equal: lambda x, y: Tracer.sanitize(x).__ne__(y),
    np.bitwise_and: lambda x, y: Tracer.sanitize(x).__and__(y),
    np.bitwise_or: lambda x, y: Tracer.sanitize(x).__or__(y),
    np.bitwise_xor: lambda x, y: Tracer.sanitize(x).__xor__(y),
}

Tracer.SUPPORTED_FUNCS = {
    np.sum: _np_sum,
    np.reshape: _np_reshape,
    np.dot: _np_dot,
    np.matmul: lambda a, b, **kw: Tracer.sanitize(a).__matmul__(b),
    np.concatenate: _np_concatenate,
    np.transpose: _np_transpose,
    np.broadcast_to: _np_broadcast_to,
    np.clip: _np_clip,
    np.min: _np_min,
    np.max: _np_max,
    np.amin: _np_min,
    np.amax: _np_max,
}
