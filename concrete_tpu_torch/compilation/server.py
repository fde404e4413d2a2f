"""Server: runs a compiled circuit on encrypted data, on a torch device.

Counterpart of ``concrete_tpu/compilation/server.py``.  ``Server.save``
writes the JAX package's data-only deployment archive (``client.specs.json``,
``graph.json``, ``graph_arrays.npz``; no pickle) byte for byte, and
``Server.load`` reads either package's archives and validates the graph
before building the executor.  A multi-partition circuit runs on
per-partition keys and the conversion keys of its frontiers (the JAX
package's 4-tuple of evaluation keys).  Entry points run on the card unless
the caller asks for the CPU: ``device=None`` means CUDA, and raises if CUDA
is unavailable.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from concrete_tpu_torch.compilation.executor import GraphExecutor, to_torus
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.core.compression import SeededLweCiphertext, decompress
from concrete_tpu_torch.representation import Graph
from concrete_tpu_torch.utils import telemetry as tm
from concrete_tpu_torch.utils.device import resolve_device


class Server:
    def __init__(self, graph: Graph, specs: ClientSpecs, device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.client_specs = specs
        self._executor = GraphExecutor(graph, specs.params,
                                       specs.message_bits,
                                       wop_params=specs.wop_params(),
                                       specs=specs)
        specs_by_uid = {**self._executor.tlu_specs,
                        **self._executor.multivariate_specs}
        self._lut_polys = {
            uid: torch.from_numpy(np.ascontiguousarray(s.lut_poly)
                                  .view(np.int64)).to(self.device)
            for uid, s in specs_by_uid.items()}
        self._wop_tables = {
            uid: torch.from_numpy(np.asarray(s.table, dtype=np.int64)).to(
                self.device)
            for uid, s in self._executor.wop_specs.items()}

    def check_wop_memory(self, free_bytes: int = None) -> list:
        """Refuse, before any key is generated or packed, a circuit whose
        largest WoP lookup (one chunk of its circuit bootstrap with the
        packed PFPKSK, at its partition's gadgets) does not fit this
        server's device (``core.kernels_wop.check_wop_memory``); returns
        the estimates."""
        from concrete_tpu_torch.core import kernels_wop as kw
        return [kw.check_wop_memory(wp, nb, size, self.device, free_bytes)
                for wp, nb, size in self._executor.wop_lookups()]

    def run(self, *args, evaluation_keys) -> tuple:
        """Run the circuit; returns the output ciphertexts as u64 arrays
        (a clear output as a trivial ciphertext).  Clear arguments are
        numpy arrays, Python integers or CPU tensors; an encrypted one a
        u64 array or a ``SeededLweCiphertext``, decompressed here on the
        host before the upload.

        evaluation_keys: the client's ``EvaluationKeys`` (packed here with
        this circuit's BSK form and truncation; a WoP circuit packs the
        untruncated BSK and its PFPKSK) or an already packed (LimbKSK,
        LimbBSK or FusedBSK[, LimbPFPKSK]) tuple on this server's device.
        A multi-partition circuit takes (ksk_by_partition,
        bsk_by_partition, pfpksk_by_partition or None, fks_by_frontier),
        which ``Circuit._evaluation_keys`` builds from ``MultiKeys``."""
        with tm.request("server.run") if tm.on else tm.OFF:
            return self._run(args, evaluation_keys)

    def _run(self, args, evaluation_keys) -> tuple:
        from concrete_tpu_torch.compilation.evaluation_keys import \
            EvaluationKeys
        multi = self.client_specs.is_multi
        if isinstance(evaluation_keys, EvaluationKeys) and multi:
            raise ValueError(
                "a multi-partition circuit runs on per-partition keys: pass "
                "the (ksk, bsk, pfpksk, fks) dicts of "
                "Circuit._evaluation_keys")
        if isinstance(evaluation_keys, EvaluationKeys):
            wp = self.client_specs.wop_params()
            if wp is not None:
                self.check_wop_memory()
            evaluation_keys = evaluation_keys.packed(
                None if wp is not None else self.client_specs.message_bits,
                norm2=self.graph.max_norm2(), device=self.device,
                wop_params=wp)
        if len(evaluation_keys) not in ((4,) if multi else (2, 3)):
            raise ValueError(
                "evaluation keys are (ksk_by_partition, bsk_by_partition, "
                "pfpksk_by_partition or None, fks_by_frontier) for a "
                "multi-partition circuit, else (LimbKSK, BSK[, "
                "LimbPFPKSK])")
        ksk, bsk, *rest = evaluation_keys
        pfpksk = rest[0] if rest else None
        fks = rest[1] if multi else None
        if self._executor.wop_specs and pfpksk is None:
            raise ValueError(
                "circuit contains WoP-PBS table lookups; pass the packed "
                "PFPKSK as evaluation_keys[2] (Keys.wop_evaluation)")
        every = (list(ksk.values()) + list(bsk.values())
                 + list((pfpksk or {}).values()) + list(fks.values())) \
            if multi else [ksk, bsk] + rest
        for k in every:
            if k.device != self.device:
                raise ValueError(f"evaluation keys are on {k.device}, the "
                                 f"server runs on {self.device}")
        if len(args) != len(self.client_specs.inputs):
            raise ValueError(f"expected {len(self.client_specs.inputs)} "
                             f"argument(s), got {len(args)}")
        with tm.span("server.upload") if tm.on else tm.OFF:
            # a seeded (compressed) argument grows its masks back on the
            # host
            args = [decompress(a) if isinstance(a, SeededLweCiphertext)
                    else a for a in args]
            enc_inputs = {
                pos: to_torus(arg, self.device) if spec.is_encrypted
                else (arg.numpy() if isinstance(arg, torch.Tensor)
                      else np.asarray(arg))
                for pos, (arg, spec) in enumerate(
                    zip(args, self.client_specs.inputs))}
        if tm.on:
            tm.count("bytes.h2d", sum(
                enc_inputs[pos].nbytes
                for pos, spec in enumerate(self.client_specs.inputs)
                if spec.is_encrypted))
        outs = self._executor.run(enc_inputs, ksk, bsk, self._lut_polys,
                                  self._wop_tables, pfpksk, fks=fks,
                                  device=self.device)
        with tm.span("server.download") if tm.on else tm.OFF:
            host = tuple(o.cpu().numpy().view(np.uint64) for o in outs)
        if tm.on:
            tm.count("bytes.d2h", sum(h.nbytes for h in host))
        return host

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
            if node.uid in self._executor.wop_specs:
                s = self._executor.wop_specs[node.uid]
                kind = f"wop_pbs(nb={s.nb_bits}, out={s.out_bits})"
            elif s is not None:
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
        multivariate ones included; a WoP lookup at ``cost_wop_macs``, a
        bit extraction at its sign PBS count.  A multi-partition circuit
        costs each lookup at its input partition's parameters, plus a
        conversion keyswitch (``cost_fks_macs``) per crossing element."""
        from concrete_tpu_torch.compilation.widths import \
            tlu_input_partition
        from concrete_tpu_torch.optimizer.v0 import (cost_fks_macs,
                                                     cost_ks_macs,
                                                     cost_pbs_macs,
                                                     cost_wop_macs)
        ex = self._executor
        default = self.client_specs.message_bits

        def atomic_cost(p):
            return (cost_pbs_macs(p.n_small, p.glwe_dimension,
                                  p.polynomial_size, p.pbs_level,
                                  p.pbs_base_log)
                    + cost_ks_macs(p.n_big, p.n_small, p.ks_level,
                                   p.ks_base_log))
        total = 0.0
        for n in self.graph.graph.nodes:
            if n.name not in ("tlu", "univariate", "multivariate",
                              "dynamic_tlu", "extract_bits") \
                    or not n.output.is_encrypted:
                continue
            size = max(int(np.prod(n.output.shape)), 1)
            w_in = tlu_input_partition(self.graph, n, default)
            p = ex.params_for_width(w_in)
            if n.name == "extract_bits":
                # lsb cascade: cleans + per-requested-bit sign-PBS
                positions = n.properties["kwargs"]["positions"]
                n_pbs = max(int(b) for b in positions) + len(positions)
                total += size * n_pbs * atomic_cost(p)
                continue
            spec = ex.wop_specs.get(n.uid)
            wp = ex.wop_params_for(w_in)
            if spec is not None and wp is not None:
                total += size * cost_wop_macs(
                    p, spec.nb_bits, wp.cbs_level, wp.pfks_level,
                    wp.cbs_base_log, wp.pfks_base_log)
            else:
                total += size * atomic_cost(p)
            w_out = ex.part_of(n)
            if (w_in, w_out) in ex.conversions:
                lvl, base = ex.conversions[(w_in, w_out)]
                total += size * cost_fks_macs(
                    p.n_big, ex.params_for_width(w_out).n_big, lvl, base)
        return total

    def programmable_bootstrap_count(self) -> int:
        """PBS count from the statistics grid (one source of truth with
        Circuit.programmable_bootstrap_count)."""
        from concrete_tpu_torch.compilation import statistics as st
        records = st.collect(self.graph, self._executor,
                             self.client_specs.message_bits)
        return st.total(records, st.PBS)
