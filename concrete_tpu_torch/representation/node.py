"""Computation-graph nodes.

Reference: frontends/concrete-python/concrete/fhe/representation/node.py:26
(Node with Operation enum {Input, Constant, Generic} and an `evaluator`).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np

from concrete_tpu_torch.values import ValueDescription


class Operation(enum.Enum):
    Input = "input"
    Constant = "constant"
    Generic = "generic"


_UID = [0]


class Node:
    """One operation in the computation DAG.

    `properties["name"]` identifies generic ops ("add", "multiply", "tlu",
    "matmul", ...); `evaluator` computes the plaintext result from input
    plaintexts (used for inputset bounds measurement, simulation, and as the
    differential oracle in tests).
    """

    def __init__(self, operation: Operation,
                 inputs: list["ValueDescription"],
                 output: ValueDescription,
                 evaluator: Optional[Callable] = None,
                 properties: Optional[dict] = None):
        self.operation = operation
        self.inputs = inputs
        self.output = output
        self.evaluator = evaluator
        self.properties = properties or {}
        self.bounds: Optional[tuple[int, int]] = None  # measured (min, max)
        self.uid = _UID[0]
        _UID[0] += 1

    # -- constructors (reference node.py:47,74,133) ------------------------

    @classmethod
    def input(cls, name: str, value: ValueDescription) -> "Node":
        return cls(Operation.Input, [value], value,
                   evaluator=lambda x: x, properties={"name": name})

    @classmethod
    def constant(cls, constant) -> "Node":
        arr = np.asarray(constant)
        value = ValueDescription.of(arr, is_encrypted=False)
        return cls(Operation.Constant, [], value,
                   evaluator=lambda: arr, properties={"constant": arr,
                                                      "name": "constant"})

    @classmethod
    def generic(cls, name: str, inputs: list[ValueDescription],
                output: ValueDescription, evaluator: Callable,
                **kwargs) -> "Node":
        props = {"name": name, "kwargs": kwargs}
        return cls(Operation.Generic, inputs, output, evaluator=evaluator,
                   properties=props)

    # ----------------------------------------------------------------------

    @property
    def name(self) -> str:
        return self.properties.get("name", self.operation.value)

    @property
    def converted_to_table_lookup(self) -> bool:
        return self.name in ("tlu", "univariate")

    def __call__(self, *args):
        if self.operation == Operation.Constant:
            return self.evaluator()
        return self.evaluator(*args)

    def __repr__(self) -> str:
        return (f"Node<{self.name}, out={self.output}, "
                f"bounds={self.bounds}>")

    # -- pickling (deployment archives) ------------------------------------
    # Evaluators are often closures; on pickle they are dropped and rebuilt
    # from the op registry below.  Ops whose evaluator cannot be rebuilt
    # (univariate with a user callable) must be materialized into explicit
    # tables before serialization (Server.save does this).

    def __getstate__(self):
        state = self.__dict__.copy()
        props = dict(state["properties"])
        if "kwargs" in props:
            kwargs = {k: v for k, v in props["kwargs"].items()
                      if not callable(v)}
            props["kwargs"] = kwargs
        state["properties"] = props
        state["evaluator"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.evaluator = _rebuild_evaluator(
            self.operation, self.properties)

    def materialized_as_multivariate(self, table: np.ndarray, mins, widths,
                                     offsets) -> "Node":
        """Copy of a multivariate node with its packed-index table and
        layout made explicit (data-only, for deployment archives)."""
        props = {k: v for k, v in self.properties.items() if k != "kwargs"}
        props.update({"name": "multivariate",
                      "kwargs": {"table": np.asarray(table),
                                 "mins": tuple(int(m) for m in mins),
                                 "widths": tuple(int(w) for w in widths),
                                 "offsets": tuple(int(o) for o in offsets)}})
        node = Node(self.operation, self.inputs, self.output,
                    evaluator=None, properties=props)
        node.evaluator = _rebuild_evaluator(self.operation, props)
        node.bounds = self.bounds
        node.uid = self.uid
        return node

    def materialized_as_tlu(self, table: np.ndarray) -> "Node":
        """Return a copy of this univariate/tlu node with an explicit table
        (used before deployment serialization)."""
        props = {k: v for k, v in self.properties.items() if k != "kwargs"}
        props.update({"name": "tlu", "kwargs": {"table": table}})
        node = Node(self.operation, self.inputs, self.output,
                    evaluator=lambda x: table[np.asarray(x) % len(table)],
                    properties=props)
        node.bounds = self.bounds
        node.uid = self.uid
        return node

    def format(self, predecessors: list[str]) -> str:
        if self.operation == Operation.Input:
            return f"{self.properties['name']}  # {self.output}"
        if self.operation == Operation.Constant:
            c = self.properties["constant"]
            rep = np.array2string(np.asarray(c), threshold=8)
            return f"{rep}  # {self.output}"
        args = ", ".join(predecessors)
        return f"{self.name}({args})  # {self.output}"


# -- evaluator registry for unpickling ---------------------------------------

def _rebuild_evaluator(operation: Operation, properties: dict):
    name = properties.get("name")
    kwargs = properties.get("kwargs", {})
    if operation == Operation.Input:
        return lambda x: x
    if operation == Operation.Constant:
        constant = properties["constant"]
        return lambda: constant
    if name == "add":
        return lambda x, y: x + y
    if name == "subtract":
        return lambda x, y: x - y
    if name == "multiply":
        return lambda x, y: x * y
    if name == "negative":
        return lambda x: -x
    if name in ("matmul",):
        return lambda x, y: x @ y
    if name == "dot":
        return lambda x, y: np.dot(x, y)
    if name == "sum":
        axis = kwargs.get("axis")
        return lambda x: np.sum(x, axis=axis)
    if name == "reshape":
        shape = kwargs["shape"]
        return lambda x: np.reshape(x, shape)
    if name == "index":
        index = kwargs["index"]
        return lambda x: x[index]
    if name == "assign":
        index = kwargs["index"]

        def _assign(x, v, index=index):
            out = np.array(x)
            out[index] = v
            return out
        return _assign
    if name == "concatenate":
        axis = kwargs["axis"]
        return lambda *xs: np.concatenate(xs, axis=axis)
    if name == "transpose":
        axes = kwargs["axes"]
        return lambda x: np.transpose(x, axes)
    if name == "broadcast_to":
        shape = kwargs["shape"]
        return lambda x: np.broadcast_to(x, shape)
    if name == "tlu":
        table = np.asarray(kwargs["table"])
        if table.ndim > 1:
            def _mtlu(x):
                idx = (np.asarray(x) % table.shape[-1])[..., None]
                return np.take_along_axis(table, idx, axis=-1)[..., 0]
            return _mtlu
        return lambda x: table[np.asarray(x) % len(table)]
    if name == "encrypted_constant":
        value = kwargs["value"]
        return lambda: value
    if name == "round_bit_pattern":
        lsbs = kwargs["lsbs_to_remove"]
        half, step = 1 << (lsbs - 1), 1 << lsbs
        return lambda x: ((np.asarray(x, dtype=np.int64) + half)
                          // step) * step
    if name == "truncate_bit_pattern":
        lsbs = kwargs["lsbs_to_remove"]
        return lambda x: (np.asarray(x, dtype=np.int64) >> lsbs) << lsbs
    if name == "multivariate" and "table" in kwargs:
        table = np.asarray(kwargs["table"])
        mins = list(kwargs["mins"])
        offsets = list(kwargs["offsets"])

        def _mv(*xs):
            idx = 0
            for x, mn, off in zip(xs, mins, offsets):
                idx = idx + ((np.asarray(x, dtype=np.int64) - mn) << off)
            return table[idx % len(table)]
        return _mv
    if name == "dynamic_tlu":
        return lambda t, i: np.asarray(t)[np.asarray(i)]
    if name == "extract_bits":
        positions = tuple(kwargs["positions"])

        def _bits(v):
            v = np.asarray(v, dtype=np.int64)
            out = np.zeros_like(v)
            for j, b in enumerate(positions):
                out |= ((v >> np.int64(b)) & np.int64(1)) << np.int64(j)
            return out
        return _bits
    if name in ("hint", "trace_message"):
        return lambda x: x
    if name == "array":
        shape = tuple(kwargs["shape"])
        return lambda *xs: np.asarray(xs, dtype=np.int64).reshape(shape)
    if name == "conv":
        weight = np.asarray(kwargs["weight"], dtype=np.int64)
        bias = kwargs.get("bias")
        strides = tuple(kwargs.get("strides", (1, 1)))
        padding = tuple(kwargs.get("padding", (0, 0)))

        def _conv(v):
            v = np.asarray(v, dtype=np.int64)
            n, c, h, w = v.shape
            o, _i, kh, kw = weight.shape
            ph, pw = padding
            v = np.pad(v, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
            oh = (h + 2 * ph - kh) // strides[0] + 1
            ow = (w + 2 * pw - kw) // strides[1] + 1
            out = np.zeros((n, o, oh, ow), dtype=np.int64)
            for y in range(oh):
                for x in range(ow):
                    patch = v[:, :, y * strides[0]:y * strides[0] + kh,
                              x * strides[1]:x * strides[1] + kw]
                    out[:, :, y, x] = np.tensordot(
                        patch, weight, axes=([1, 2, 3], [1, 2, 3]))
            if bias is not None:
                out += np.asarray(bias, dtype=np.int64)[None, :, None, None]
            return out
        return _conv
    return None  # univariate without materialized table: not executable
