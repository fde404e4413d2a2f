"""Graph executor: runs a computation graph on torch ciphertext tensors.

Counterpart of ``concrete_tpu/compilation/executor.py`` for the first slice
of the port.  The graph is interpreted node by node (PyTorch runs eagerly;
there is no jit to build): levelled ops are int64 tensor ops (mod 2^64),
and a table lookup flattens its whole tensor into one ``pbs_batch``.

Ciphertext layout: an encrypted integer tensor of shape S is an int64
tensor of shape (*S, n_big + 1), LWE dimension last.

Ported node kinds: inputs, constants, add, subtract, negative, multiply by
a clear value, ``matmul``/``dot`` with a clear operand, and
``tlu``/``univariate`` through the native PBS.  Every
other kind raises ``NotImplementedError`` naming its ROADMAP item, when the
executor is built — before any key is packed or ciphertext is read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.representation import Graph, Node, Operation

_LEVELLED = ("add", "subtract", "negative", "multiply", "matmul", "dot")
_ITEM6 = "ROADMAP queue 1 item 6, executor ops not ported yet"
_NOT_PORTED = {
    "crt_tlu": "ROADMAP queue 1 item 7, WoP-PBS and CRT",
    "extract_bits": "ROADMAP queue 1 item 7, WoP-PBS and CRT",
    "conv": "ROADMAP queue 1 item 6; an encrypted x clear convolution in "
            "int64 (cuBLAS and cuDNN have no int64 path)",
}


def not_ported(what: str, item: str = _ITEM6) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass
class TluSpec:
    """A materialized table lookup: expanded LUT polynomial + signedness."""
    node_uid: int
    lut_poly: np.ndarray      # (N,) u64 accumulator polynomial
    signed_input: bool
    message_bits: int         # input encoding width (LUT index domain)


def raw_table(node: Node, p: int, shift: int = 0) -> np.ndarray:
    """The 2^p-entry integer table of a tlu/univariate node (index = value
    mod 2^p, as the JAX package's executor.raw_table)."""
    in_node_signed = node.inputs[0].dtype.is_signed if isinstance(
        node.inputs[0].dtype, Integer) else False
    idx = np.arange(1 << p)
    vals = np.where(idx < (1 << (p - 1)), idx, idx - (1 << p)) \
        if in_node_signed else idx
    vals = vals << shift
    if node.name == "tlu":
        table = np.asarray(node.properties["kwargs"]["table"], dtype=np.int64)
        if table.ndim > 1:
            raise not_ported("a per-element (multi) lookup table")
        return table[vals % len(table)]
    fn = node.properties["kwargs"]["function"]
    return np.vectorize(fn, otypes=[np.int64])(vals)


def _materialize_table(node: Node, p_in: int, p_out: int,
                       params: CryptoParams, lsbs: int = 0) -> TluSpec:
    in_node_signed = node.inputs[0].dtype.is_signed if isinstance(
        node.inputs[0].dtype, Integer) else False
    p_eff = max(p_in - lsbs, 1)
    lut_enc = raw_table(node, p_eff, shift=lsbs) & ((1 << (p_out + 1)) - 1)
    lut_poly = ref.encode_expand_lut(
        lut_enc.astype(np.uint64), params.polynomial_size, p_eff,
        signed=in_node_signed, out_bits=p_out)
    return TluSpec(node_uid=node.uid, lut_poly=lut_poly,
                   signed_input=in_node_signed, message_bits=p_eff)


def to_torus(value, device) -> torch.Tensor:
    """u64 numpy ciphertexts as int64 on `device`."""
    arr = np.ascontiguousarray(value)
    if arr.dtype != np.uint64:
        raise TypeError(f"ciphertext arrays are uint64, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int64)).to(device)


class GraphExecutor:
    """Node-by-node evaluation of a mono-keyset graph on torch tensors."""

    def __init__(self, graph: Graph, params: CryptoParams, p: int):
        from concrete_tpu_torch.compilation.widths import (encoding_width,
                                                           tlu_fused_lsbs)
        self.graph = graph
        self.params = params
        self.p = p
        self.width_of = lambda node: encoding_width(node, p)
        self.tlu_specs: dict[int, TluSpec] = {}
        max_native = min(8, params.polynomial_size.bit_length() - 2)
        for node in graph.topological_order():
            if node.operation in (Operation.Input, Operation.Constant):
                continue
            if not node.output.is_encrypted:
                raise not_ported(f"clear operation '{node.name}'")
            if node.name in ("tlu", "univariate"):
                preds = graph.ordered_preds_of(node)
                p_in = self.width_of(preds[0]) if preds else p
                lsbs = tlu_fused_lsbs(graph, node)
                if max(p_in - lsbs, 1) > max_native:
                    raise not_ported(f"a {p_in}-bit table lookup (WoP-PBS)",
                                     _NOT_PORTED["crt_tlu"])
                self.tlu_specs[node.uid] = _materialize_table(
                    node, p_in, self.width_of(node), params, lsbs=lsbs)
            elif node.name not in _LEVELLED:
                raise not_ported(f"operation '{node.name}'",
                                 _NOT_PORTED.get(node.name, _ITEM6))
        for node in graph.ordered_outputs:
            if not node.output.is_encrypted:
                raise not_ported("a clear circuit output")

    def _encode_clear(self, value, width: int, device) -> torch.Tensor:
        enc = ref.encode(np.asarray(value), width)
        return torch.from_numpy(np.ascontiguousarray(enc).view(np.int64)) \
            .to(device)

    @staticmethod
    def _contract(args, enc_flags, device) -> torch.Tensor:
        """matmul / dot of an encrypted operand with a clear one, as the
        JAX package computes it: an int64 elementwise multiply (mod 2^64)
        and a sum, never a GEMM (cuBLAS has no int64 GEMM).  The
        ciphertext's LWE axis stays last."""
        a, b = args
        ea, eb = enc_flags
        if ea and eb:
            raise not_ported("encrypted x encrypted matmul")

        def clear(v):
            return torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
        if ea:
            ct, w = a, clear(b)
            if w.ndim == 1:
                return (ct * w[..., None]).sum(dim=-2)
            if w.ndim == 2:
                # (..., K, d) x (K, M) -> (..., M, d)
                return (ct[..., :, None, :] * w[:, :, None]).sum(dim=-3)
            raise not_ported("matmul with a clear operand above 2-D")
        w, ct = clear(a), b
        if w.ndim == 1:
            # (K,) x (K, ..., d): contract the leading K axis
            return (w.reshape((-1,) + (1,) * (ct.ndim - 1)) * ct).sum(dim=0)
        if w.ndim == 2 and ct.ndim == 2:
            # (M, K) x (K, d) -> (M, d)
            return (w[..., None] * ct[None, ...]).sum(dim=1)
        if w.ndim == 2:
            # (M, K) x (..., K, P, d) -> (..., M, P, d)
            return (w[:, :, None, None] * ct[..., None, :, :, :]).sum(dim=-3)
        raise not_ported("matmul with a clear operand above 2-D")

    def run(self, enc_inputs: dict, ksk: kn.LimbKSK, bsk,
            lut_polys: dict) -> tuple:
        """Evaluate the graph.  enc_inputs maps input position -> int64
        ciphertext tensor (or a clear numpy array for clear inputs);
        lut_polys maps TLU node uid -> (N,) int64 LUT polynomial."""
        graph = self.graph
        values: dict[Node, object] = {}
        device = ksk.device
        for node in graph.topological_order():
            name = node.name
            if node.operation == Operation.Input:
                pos = next(q for q, n in graph.input_nodes.items()
                           if n is node)
                values[node] = enc_inputs[pos]
                continue
            if node.operation == Operation.Constant:
                values[node] = node()
                continue
            preds = graph.ordered_preds_of(node)
            args = [values[pr] for pr in preds]
            enc_flags = [pr.output.is_encrypted for pr in preds]
            if name in ("add", "subtract"):
                a, b = args
                ea, eb = enc_flags
                sign = 1 if name == "add" else -1
                if ea and eb:
                    out = a + sign * b
                elif ea:
                    out = a.clone()
                    out[..., -1] += sign * self._encode_clear(
                        b, self.width_of(node), device)
                else:                    # clear +/- encrypted
                    out = b.clone() if sign > 0 else -b
                    out[..., -1] += self._encode_clear(
                        a, self.width_of(node), device)
            elif name == "multiply":
                a, b = args
                ea, eb = enc_flags
                if ea and eb:
                    raise not_ported("encrypted x encrypted multiplication")
                ct, clear = (a, b) if ea else (b, a)
                c = torch.from_numpy(np.asarray(clear, dtype=np.int64)) \
                    .to(device)
                out = ct * c[..., None]
            elif name == "negative":
                out = -args[0]
            elif name in ("matmul", "dot"):
                out = self._contract(args, enc_flags, device)
            else:                        # tlu / univariate
                ct = args[0]
                spec = self.tlu_specs[node.uid]
                flat = ct.reshape(-1, ct.shape[-1])
                res = kn.pbs_batch(flat, ksk, bsk, lut_polys[node.uid],
                                   self.params, spec.message_bits,
                                   signed=spec.signed_input)
                out = res.reshape(ct.shape[:-1] + (res.shape[-1],))
            values[node] = out
        return tuple(values[n] for n in graph.ordered_outputs)
