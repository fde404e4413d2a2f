"""Data-only (de)serialization of computation graphs for deployment archives.

The reference ships deployment artifacts in structured formats (capnp
ProgramInfo, tools/concrete-protocol/concrete-protocol.capnp; MLIR text for
via_mlir archives) precisely so that loading an untrusted archive never
executes code.  This module is the analog for our graph IR: nodes become
JSON records, ndarray payloads (constants, materialized tables, conv
weights) go into an npz sidecar loaded with allow_pickle=False, and
evaluators are rebuilt from the op registry (representation/node.py)
on load.  No pickle anywhere.

Univariate nodes with user callables must be materialized into explicit
tables before serialization (Server.save does this).
"""

from __future__ import annotations

import io
import json

import networkx as nx
import numpy as np

from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.representation import Graph
from concrete_tpu_torch.representation.node import Node, Operation, _rebuild_evaluator
from concrete_tpu_torch.values import ValueDescription

FORMAT_VERSION = 1


# -- JSON-safe encoding of kwargs values (ints, tuples, slices, arrays) ------

def _encode_value(v, arrays: dict, prefix: str):
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, slice):
        return {"__slice__": [_encode_value(v.start, arrays, prefix),
                              _encode_value(v.stop, arrays, prefix),
                              _encode_value(v.step, arrays, prefix)]}
    if v is Ellipsis:
        return {"__ellipsis__": True}
    if isinstance(v, (tuple, list)):
        return {"__tuple__" if isinstance(v, tuple) else "__list__":
                [_encode_value(x, arrays, f"{prefix}_{i}")
                 for i, x in enumerate(v)]}
    if isinstance(v, np.ndarray):
        key = f"{prefix}_{len(arrays)}"
        arrays[key] = v
        return {"__ndarray__": key}
    raise TypeError(
        f"cannot serialize value of type {type(v).__name__} in a deployment "
        "archive (materialize callables into tables first)")


def _decode_value(v, arrays):
    if isinstance(v, dict):
        if "__slice__" in v:
            s = [_decode_value(x, arrays) for x in v["__slice__"]]
            return slice(*s)
        if "__ellipsis__" in v:
            return Ellipsis
        if "__tuple__" in v:
            return tuple(_decode_value(x, arrays) for x in v["__tuple__"])
        if "__list__" in v:
            return [_decode_value(x, arrays) for x in v["__list__"]]
        if "__ndarray__" in v:
            return arrays[v["__ndarray__"]]
    return v


def _vd_record(v: ValueDescription) -> dict:
    return {"bit_width": v.dtype.bit_width, "is_signed": v.dtype.is_signed,
            "shape": list(v.shape), "is_encrypted": v.is_encrypted}


def _vd_from(d: dict) -> ValueDescription:
    return ValueDescription(dtype=Integer(d["bit_width"], d["is_signed"]),
                            shape=tuple(d["shape"]),
                            is_encrypted=d["is_encrypted"])


# -- graph <-> (json, arrays) -------------------------------------------------

def graph_to_records(graph: Graph) -> tuple[dict, dict[str, np.ndarray]]:
    arrays: dict[str, np.ndarray] = {}
    order = graph.topological_order()
    ids = {node: i for i, node in enumerate(order)}
    nodes = []
    for node in order:
        rec = {
            "operation": node.operation.value,
            "name": node.properties.get("name"),
            "output": _vd_record(node.output),
            "inputs": [_vd_record(v) for v in node.inputs],
            "bounds": list(node.bounds) if node.bounds is not None else None,
            "uid": node.uid,
            "tag": node.properties.get("tag"),
            "encoding_width": node.properties.get("encoding_width"),
            "partition": node.properties.get("partition"),
        }
        if node.properties.get("approximate"):
            # Exactness.APPROXIMATE on truncate_bit_pattern: without this
            # the executor re-adds the half-step bias after a Server
            # save/load round-trip
            rec["approximate"] = True
        if node.operation == Operation.Constant:
            rec["constant"] = _encode_value(
                np.asarray(node.properties["constant"]), arrays,
                f"n{ids[node]}_const")
        if "kwargs" in node.properties:
            kwargs = {}
            for k, v in node.properties["kwargs"].items():
                if callable(v):
                    # user TLU callables are materialized into tables by
                    # Server.save (tlu/wop specs); anything else callable
                    # cannot round-trip a data-only archive — fail at save,
                    # not with a NoneType error at load
                    if k == "function":
                        continue
                    raise TypeError(
                        f"node %{node.uid} [{node.name}] kwarg '{k}' is a "
                        "callable and cannot be serialized; materialize "
                        "it into data first")
                kwargs[k] = _encode_value(v, arrays, f"n{ids[node]}_{k}")
            rec["kwargs"] = kwargs
        nodes.append(rec)
    edges = [[ids[u], ids[v], int(idx)]
             for u, v, idx in graph.graph.edges(data="input_idx")]
    record = {
        "version": FORMAT_VERSION,
        "name": graph.name,
        "nodes": nodes,
        "edges": edges,
        "inputs": {str(pos): ids[n] for pos, n in graph.input_nodes.items()},
        "outputs": {str(pos): ids[n] for pos, n in graph.output_nodes.items()},
    }
    return record, arrays


def graph_from_records(record: dict, arrays) -> Graph:
    if record.get("version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"archive graph format v{record['version']} is newer than this "
            f"library supports (v{FORMAT_VERSION})")
    nodes: list[Node] = []
    for rec in record["nodes"]:
        operation = Operation(rec["operation"])
        properties: dict = {"name": rec["name"]}
        if rec.get("tag"):
            properties["tag"] = rec["tag"]
        if rec.get("encoding_width") is not None:
            properties["encoding_width"] = int(rec["encoding_width"])
        if rec.get("approximate"):
            properties["approximate"] = True
        if rec.get("partition") is not None:
            properties["partition"] = int(rec["partition"])
        if operation == Operation.Constant:
            properties["constant"] = _decode_value(rec["constant"], arrays)
        if "kwargs" in rec:
            properties["kwargs"] = {
                k: _decode_value(v, arrays) for k, v in rec["kwargs"].items()}
        node = Node(operation,
                    [_vd_from(d) for d in rec["inputs"]],
                    _vd_from(rec["output"]),
                    evaluator=None, properties=properties)
        node.evaluator = _rebuild_evaluator(operation, properties)
        node.bounds = tuple(rec["bounds"]) if rec["bounds"] else None
        node.uid = rec["uid"]
        nodes.append(node)
    g = nx.MultiDiGraph()
    g.add_nodes_from(nodes)
    for u, v, idx in record["edges"]:
        g.add_edge(nodes[u], nodes[v], input_idx=idx)
    return Graph(
        g,
        {int(p): nodes[i] for p, i in record["inputs"].items()},
        {int(p): nodes[i] for p, i in record["outputs"].items()},
        record["name"])


# -- npz helpers --------------------------------------------------------------

def arrays_to_npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def npz_bytes_to_arrays(blob: bytes) -> dict[str, np.ndarray]:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def serialize_graph(graph: Graph) -> tuple[str, bytes]:
    """-> (json text, npz bytes)."""
    record, arrays = graph_to_records(graph)
    return json.dumps(record), arrays_to_npz_bytes(arrays)


def deserialize_graph(json_text: str, npz_blob: bytes) -> Graph:
    return graph_from_records(json.loads(json_text),
                              npz_bytes_to_arrays(npz_blob))
