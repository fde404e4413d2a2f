"""Server: runs a compiled circuit on encrypted data, on a torch device.

Counterpart of ``concrete_tpu/compilation/server.py``.  ``Server.save``
writes the JAX package's data-only deployment archive (``client.specs.json``,
``graph.json``, ``graph_arrays.npz``; no pickle) byte for byte, and
``Server.load`` reads either package's archives and validates the graph
before building the executor.  Entry points run on the card unless the
caller asks for the CPU: ``device=None`` means CUDA, and raises if CUDA is
unavailable.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from concrete_tpu_torch.compilation.executor import GraphExecutor, to_torus
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.representation import Graph
from concrete_tpu_torch.utils.device import resolve_device


class Server:
    def __init__(self, graph: Graph, specs: ClientSpecs, device=None):
        self.device = resolve_device(device)
        if specs.is_multi:
            raise NotImplementedError(
                "multi-partition circuits are not ported yet "
                "(ROADMAP queue 1 item 8)")
        specs.wop_params()       # raises for circuits with WoP gadgets
        self.graph = graph
        self.client_specs = specs
        self._executor = GraphExecutor(graph, specs.params,
                                       specs.message_bits)
        specs_by_uid = {**self._executor.tlu_specs,
                        **self._executor.multivariate_specs}
        self._lut_polys = {
            uid: torch.from_numpy(np.ascontiguousarray(s.lut_poly)
                                  .view(np.int64)).to(self.device)
            for uid, s in specs_by_uid.items()}

    def run(self, *args, evaluation_keys) -> tuple:
        """Run the circuit; returns the output ciphertexts as u64 arrays
        (a clear output as a trivial ciphertext).  Clear arguments are
        numpy arrays, Python integers or CPU tensors.

        evaluation_keys: the client's ``EvaluationKeys`` (packed here with
        this circuit's BSK form and truncation) or an already packed
        (LimbKSK, LimbBSK or FusedBSK) pair on this server's device."""
        from concrete_tpu_torch.compilation.evaluation_keys import \
            EvaluationKeys
        if isinstance(evaluation_keys, EvaluationKeys):
            evaluation_keys = evaluation_keys.packed(
                self.client_specs.message_bits,
                norm2=self.graph.max_norm2(), device=self.device)
        if len(evaluation_keys) != 2:
            raise NotImplementedError(
                "only (LimbKSK, LimbBSK or FusedBSK) evaluation keys are "
                "ported; WoP and multi-partition keys are ROADMAP queue 1 "
                "items 7-8")
        ksk, bsk = evaluation_keys
        for k in (ksk, bsk):
            if k.device != self.device:
                raise ValueError(f"evaluation keys are on {k.device}, the "
                                 f"server runs on {self.device}")
        if len(args) != len(self.client_specs.inputs):
            raise ValueError(f"expected {len(self.client_specs.inputs)} "
                             f"argument(s), got {len(args)}")
        enc_inputs = {
            pos: to_torus(arg, self.device) if spec.is_encrypted
            else (arg.numpy() if isinstance(arg, torch.Tensor)
                  else np.asarray(arg))
            for pos, (arg, spec) in enumerate(zip(args,
                                                  self.client_specs.inputs))}
        outs = self._executor.run(enc_inputs, ksk, bsk, self._lut_polys)
        return tuple(o.cpu().numpy().view(np.uint64) for o in outs)

    # -- deployment (reference server.py:245-378) --------------------------

    def save(self, path: str) -> None:
        """Save a deployment archive (graph + specs) in the JAX package's
        format: univariate and multivariate nodes are materialized into
        explicit tables (a multivariate node with its packed layout) first,
        so the archive holds no Python callables."""
        import networkx as nx
        from concrete_tpu_torch.compilation.executor import (
            multivariate_raw_table, packed_layout, raw_table)
        from concrete_tpu_torch.compilation.graph_io import serialize_graph
        from concrete_tpu_torch.compilation.widths import (encoding_width,
                                                           packed_width)
        p = self.client_specs.message_bits
        mapping = {}
        for node in self.graph.graph.nodes:
            if node.name == "univariate":
                preds = self.graph.ordered_preds_of(node)
                p_in = encoding_width(preds[0], p) if preds else p
                mapping[node] = node.materialized_as_tlu(
                    raw_table(node, p_in))
            elif node.name == "multivariate" \
                    and "table" not in node.properties["kwargs"]:
                p_in = packed_width(self.graph, node)
                mins, widths, offsets = packed_layout(self.graph, node)
                mapping[node] = node.materialized_as_multivariate(
                    multivariate_raw_table(self.graph, node, p_in),
                    mins, widths, offsets)
        g2 = nx.relabel_nodes(self.graph.graph, mapping, copy=True) \
            if mapping else self.graph.graph
        graph2 = Graph(
            g2,
            {q: mapping.get(n, n) for q, n in self.graph.input_nodes.items()},
            {q: mapping.get(n, n) for q, n in self.graph.output_nodes.items()},
            self.graph.name)
        graph_json, graph_npz = serialize_graph(graph2)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("client.specs.json", self.client_specs.serialize())
            z.writestr("graph.json", graph_json)
            z.writestr("graph_arrays.npz", graph_npz)

    @classmethod
    def load(cls, path: str, device=None) -> "Server":
        """Load an archive written by either package's ``Server.save``."""
        from concrete_tpu_torch.compilation.graph_io import deserialize_graph
        from concrete_tpu_torch.representation.typing import validate_graph
        device = resolve_device(device)
        with zipfile.ZipFile(path) as z:
            specs = ClientSpecs.deserialize(
                z.read("client.specs.json").decode())
            graph = deserialize_graph(z.read("graph.json").decode(),
                                      z.read("graph_arrays.npz"))
        # archives are untrusted input: reject inconsistent type records
        validate_graph(graph)
        return cls(graph, specs, device=device)

    # -- introspection -----------------------------------------------------

    def lowering_text(self) -> str:
        """Human-readable per-node lowering plan — the analog of the
        reference's `show_mlir` dump (Configuration.show_mlir): what each
        encrypted graph node runs and at which encoding width."""
        from concrete_tpu_torch.compilation.widths import encoding_width
        lines = []
        for node in self.graph.topological_order():
            if not node.output.is_encrypted:
                continue
            w = encoding_width(node, self.client_specs.message_bits)
            kind = node.name
            s = self._executor.tlu_specs.get(node.uid)
            if s is not None:
                kind = f"keyswitch+pbs(p={s.message_bits}" \
                    + (", signed" if s.signed_input else "") + ")"
            elif node.uid in self._executor.multivariate_specs:
                kind = "packed multivariate keyswitch+pbs"
            lines.append(f"%{node.uid} = {kind} : eint{w}"
                         f"{list(node.output.shape)}")
        return "\n".join(lines)

    @property
    def complexity(self) -> float:
        """Estimated cost in the search's modeled int8 MACs (the JAX
        package's cost model, ``optimizer/v0.py``): one keyswitch and one
        blind rotate per element of every encrypted lookup, dynamic and
        multivariate ones included."""
        from concrete_tpu_torch.optimizer.v0 import (cost_ks_macs,
                                                     cost_pbs_macs)
        p = self.client_specs.params
        atomic = (cost_pbs_macs(p.n_small, p.glwe_dimension,
                                p.polynomial_size, p.pbs_level,
                                p.pbs_base_log)
                  + cost_ks_macs(p.n_big, p.n_small, p.ks_level,
                                 p.ks_base_log))
        return float(sum(max(int(np.prod(n.output.shape)), 1) * atomic
                         for n in self.graph.graph.nodes
                         if n.name in ("tlu", "univariate", "multivariate",
                                       "dynamic_tlu")
                         and n.output.is_encrypted))

    def programmable_bootstrap_count(self) -> int:
        """PBS count from the statistics grid (one source of truth with
        Circuit.programmable_bootstrap_count)."""
        from concrete_tpu_torch.compilation import statistics as st
        records = st.collect(self.graph, self._executor,
                             self.client_specs.message_bits)
        return st.total(records, st.PBS)
