"""Server: runs a deployment archive on encrypted data, on a torch device.

Counterpart of ``concrete_tpu/compilation/server.py``.  ``Server.load``
reads the data-only archives the JAX package's ``Server.save`` writes
(``client.specs.json``, ``graph.json``, ``graph_arrays.npz``; no pickle) and
validates the graph before building the executor.  Entry points run on the
card unless the caller asks for the CPU: ``device=None`` means CUDA, and
raises if CUDA is unavailable.
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
        self._lut_polys = {
            uid: torch.from_numpy(np.ascontiguousarray(s.lut_poly)
                                  .view(np.int64)).to(self.device)
            for uid, s in self._executor.tlu_specs.items()}

    def run(self, *args, evaluation_keys) -> tuple:
        """Run the circuit; returns the output ciphertexts as u64 arrays.

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
            else np.asarray(arg)
            for pos, (arg, spec) in enumerate(zip(args,
                                                  self.client_specs.inputs))}
        outs = self._executor.run(enc_inputs, ksk, bsk, self._lut_polys)
        return tuple(o.cpu().numpy().view(np.uint64) for o in outs)

    @classmethod
    def load(cls, path: str, device=None) -> "Server":
        """Load an archive written by the JAX package's ``Server.save``."""
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
