"""Graph executor: runs a computation graph on torch ciphertext tensors.

Counterpart of ``concrete_tpu/compilation/executor.py``.  The graph is
interpreted node by node (PyTorch runs eagerly; there is no jit to build):
levelled ops are int64 tensor ops (mod 2^64), and a table lookup flattens
its whole tensor into one ``pbs_batch``.

Ciphertext layout: an encrypted integer tensor of shape S is an int64
tensor of shape (*S, n_big + 1), LWE dimension last.

Every node kind of the JAX package's executor runs here.  A lookup wider
than the native LUT (``tlu``, ``univariate``, ``multivariate``) runs one
``core.kernels_wop.wop_pbs_batch`` over its elements; ``crt_tlu`` shares
one bit extraction and chunked circuit bootstrap across the sibling output
residues of one ``fhe.crt_tlu`` and runs a vertical packing per residue;
``extract_bits`` (``fhe.bits``) runs the lsb cascade
``core.kernels_wop.extract_bits_to``.  A multi-partition circuit
(``ClientSpecs.partitions``) runs each lookup in its input class's
partition, with that partition's parameters, keys and WoP gadgets, and a
big->big conversion keyswitch (``core.kernels.keyswitch``, a limb GEMM)
moves each lookup output that crosses a frontier into its class's
partition, as the JAX package's multi mode does.  The JAX package's own
refusals stay: encrypted x encrypted multiply and matmul
(the transforms lower them before they get here), a clear ``matmul``
operand above 2-D, and a WoP lookup in a circuit compiled without WoP
gadgets.

Runtime clear inputs are numpy arrays, and every clear value stays one:
a fully clear node runs its own numpy evaluator on the host.  Values that
derive from a runtime clear input are tracked, so that a clear lookup
over one raises as it does in the JAX package (there the value is a jit
tracer).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.representation import Graph, Node, Operation
from concrete_tpu_torch.utils import telemetry as tm

_KINDS = (
    "tlu", "univariate", "multivariate", "dynamic_tlu", "crt_tlu",
    "extract_bits",
    "add", "subtract", "negative", "multiply", "matmul", "dot", "sum",
    "conv", "round_bit_pattern", "truncate_bit_pattern", "hint", "array",
    "trace_message", "concatenate", "transpose", "broadcast_to", "index",
    "assign", "reshape", "encrypted_constant")


@dataclasses.dataclass
class TluSpec:
    """A materialized table lookup: expanded LUT polynomial + signedness."""
    node_uid: int
    lut_poly: np.ndarray      # (N,) or (rows, N) u64 accumulator polynomial
    signed_input: bool
    message_bits: int         # input encoding width (LUT index domain)


@dataclasses.dataclass
class WopTluSpec:
    """A wide (>8-bit) table lookup lowered to WoP-PBS.

    `table` holds 2^nb_bits raw integer entries indexed by the extracted
    bit pattern of the encoding (signed inputs extract p+1 bits, negative
    values indexing the wrapped top range).  Reference: the FHEToTFHECrt
    lowering's wop_pbs path (wrappers.cpp:855)."""
    node_uid: int
    table: np.ndarray         # (2^nb,) int64 raw entries
    nb_bits: int
    delta_log: int            # bit position of the extraction LSB
    out_bits: int             # output encoding width
    # multivariate packing layout (None for univariate wide TLUs)
    mins: list = None
    offsets: list = None


@dataclasses.dataclass
class CrtTluSpec:
    """One output residue of a CRT TLU (fhe.crt_tlu), lowered to WoP-PBS:
    shared per-residue bit extraction + circuit bootstrap, one vertical
    packing per output residue.  Reference: memref_wop_pbs_crt_buffer
    (wrappers.cpp:855-998)."""
    node_uid: int
    table: np.ndarray         # (2^nb,) raw entries for THIS output residue
    nb_bits: int              # total bits over all residue blocks
    delta_log: int            # unused (per-block deltas); stats compat
    out_bits: int             # this residue's assigned encoding width
    moduli: tuple = None
    block_bits: tuple = None    # index bits per residue block
    block_widths: tuple = None  # actual encoding width per residue block
    out_index: int = 0
    mins: list = None         # WopTluSpec-compat (unused)
    offsets: list = None


def _materialize_crt_tlu(node: Node, p_out: int,
                         block_widths: tuple) -> CrtTluSpec:
    """`block_widths[j]` is residue j's ASSIGNED encoding width — the index
    bits per block are min(ceil(log2 m_j), width): a residue can't exceed
    its encoding (measured bounds), and values above m_j-1 are unreachable.
    The output residue is encoded at the node's assigned width `p_out`."""
    from concrete_tpu_torch.core.wop import crt_block_bits, crt_lut_tables
    kw = node.properties["kwargs"]
    moduli = tuple(kw["moduli"])
    j = int(kw["out_index"])
    bits = tuple(min(nb, w) for nb, w in
                 zip(crt_block_bits(moduli), block_widths))
    luts = crt_lut_tables(kw["table"], moduli, bits=bits)
    return CrtTluSpec(node_uid=node.uid, table=luts[j],
                      nb_bits=sum(bits), delta_log=0, out_bits=p_out,
                      moduli=moduli, block_bits=bits,
                      block_widths=tuple(block_widths), out_index=j)


def _materialize_wop_table(node: Node, p_in: int, p_out: int,
                           lsbs: int = 0) -> WopTluSpec:
    """Build the bit-indexed table for a wide TLU.

    Unsigned p-bit input: nb = p, index = value.  Signed: nb = p+1 (the
    encoding's p+1-bit pattern, sign wrap at the top), index =
    value mod 2^(p+1) — entries in the unused middle range are don't-care
    (filled with f of the wrapped value).

    `lsbs` > 0 is fused rounding (ProcessRounding for the WoP path): only
    the top p_in - lsbs message bits are extracted — bit extraction floors
    the value for free; entry j maps the rounded value j << lsbs."""
    signed = isinstance(node.inputs[0].dtype, Integer) \
        and node.inputs[0].dtype.is_signed
    p_eff = max(p_in - lsbs, 1)
    nb = p_eff + (1 if signed else 0)
    idx = np.arange(1 << nb)
    if signed:
        dom = 1 << nb
        sval = np.where(idx < (1 << p_eff), idx, idx - dom)
        # the middle band of the nb-bit pattern space is unreachable
        # (don't-care); clamp into the declared signed domain so partial
        # user functions are never evaluated out of range
        half = 1 << (p_eff - 1)
        sval = np.clip(sval, -half, half - 1)
    else:
        sval = idx
    sval = sval << lsbs
    if node.name == "tlu":
        table = np.asarray(node.properties["kwargs"]["table"],
                           dtype=np.int64)
        if table.ndim > 1:
            # per-element tables (apply_multi_lookup_table): one row per
            # flattened element, matching the flattened PBS batch order
            flat = table.reshape(-1, table.shape[-1])
            vals = flat[:, sval % table.shape[-1]]
        else:
            vals = table[sval % len(table)]
    else:
        fn = node.properties["kwargs"]["function"]
        vals = np.vectorize(fn, otypes=[np.int64])(sval)
    return WopTluSpec(node_uid=node.uid, table=vals.astype(np.int64),
                      nb_bits=nb, delta_log=63 - p_eff, out_bits=p_out)


def raw_table(node: Node, p: int, shift: int = 0) -> np.ndarray:
    """The 2^p-entry integer table of a tlu/univariate node (index = value
    mod 2^p, as the JAX package's executor.raw_table); a per-element
    table gives one row of entries per flattened element."""
    in_node_signed = node.inputs[0].dtype.is_signed if isinstance(
        node.inputs[0].dtype, Integer) else False
    idx = np.arange(1 << p)
    vals = np.where(idx < (1 << (p - 1)), idx, idx - (1 << p)) \
        if in_node_signed else idx
    vals = vals << shift
    if node.name == "tlu":
        table = np.asarray(node.properties["kwargs"]["table"], dtype=np.int64)
        if table.ndim > 1:
            # per-element tables (apply_multi_lookup_table): one row of
            # raw entries per flattened element
            flat = table.reshape(-1, table.shape[-1])
            return flat[:, vals % table.shape[-1]]
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


@dataclasses.dataclass
class MultivariateSpec:
    """A packed n-operand TLU: bias/shift per operand + expanded LUT.

    packed = sum_i (x_i - min_i) << offset_i; the table is indexed by the
    packed value."""
    node_uid: int
    mins: list[int]
    offsets: list[int]
    widths: list[int]
    lut_poly: np.ndarray
    message_bits: int         # packed-operand encoding width


def packed_layout(graph: Graph, node: Node):
    """(mins, widths, offsets) for a multivariate node's operands, from
    measured bounds; offsets are bit positions, operand 0 most significant."""
    mins, widths = [], []
    for pr in graph.ordered_preds_of(node):
        lo, hi = pr.bounds
        mins.append(lo)
        widths.append(max(int(hi - lo).bit_length(), 1))
    offsets, acc = [], 0
    for w in reversed(widths):
        offsets.append(acc)
        acc += w
    return mins, widths, list(reversed(offsets))


def multivariate_raw_table(graph: Graph, node: Node,
                           p_in: int) -> np.ndarray:
    """2^p_in-entry packed-index table of a multivariate node (from its
    callable, or the explicit table of a deserialized archive node)."""
    kwargs = node.properties["kwargs"]
    if "table" in kwargs:
        t = np.asarray(kwargs["table"], dtype=np.int64)
        if len(t) < (1 << p_in):
            # width class wider than the packed range: upper entries are
            # unreachable don't-cares
            t = np.resize(t, 1 << p_in)
        return t
    fn = kwargs["function"]
    mins, widths, offsets = packed_layout(graph, node)
    idx = np.arange(1 << p_in)
    operands = [((idx >> off) & ((1 << w) - 1)) + mn
                for mn, w, off in zip(mins, widths, offsets)]
    return np.vectorize(fn, otypes=[np.int64])(*operands)


def _materialize_multivariate(graph: Graph, node: Node, p_in: int,
                              p_out: int,
                              params: CryptoParams) -> MultivariateSpec:
    mins, widths, offsets = packed_layout(graph, node)
    lut_enc = multivariate_raw_table(graph, node, p_in) \
        & ((1 << (p_out + 1)) - 1)
    lut_poly = ref.encode_expand_lut(
        lut_enc.astype(np.uint64), params.polynomial_size, p_in,
        signed=False, out_bits=p_out)
    return MultivariateSpec(node_uid=node.uid, mins=mins, offsets=offsets,
                            widths=widths, lut_poly=lut_poly,
                            message_bits=p_in)


def to_torus(value, device) -> torch.Tensor:
    """u64 numpy ciphertexts as int64 on `device`."""
    arr = np.ascontiguousarray(value)
    if arr.dtype != np.uint64:
        raise TypeError(f"ciphertext arrays are uint64, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int64)).to(device)


def _is_basic(index) -> bool:
    """True for an index of ints, slices with a positive step, Ellipsis and
    None, on which torch's view indexing is numpy's."""
    for i in index:
        if isinstance(i, slice):
            if i.step is not None and int(i.step) <= 0:
                return False
        elif not (i is Ellipsis or i is None
                  or isinstance(i, (int, np.integer))
                  and not isinstance(i, (bool, np.bool_))):
            return False
    return True


def _torch_index(index: tuple) -> tuple:
    return tuple(int(i) if isinstance(i, np.integer) else i for i in index)


@dataclasses.dataclass
class RunKeys:
    """The packed keys of one run.  Mono: one (LimbKSK, BSK) pair and the
    packed PFPKSK.  Multi: dicts keyed by partition id (the PFPKSKs of the
    WoP partitions, or None) and the packed conversion keys by frontier
    (src, dst)."""
    ksk: object
    bsk: object
    pfpksk: object = None
    fks: dict = None

    def pair(self, pid: int):
        if isinstance(self.ksk, dict):
            return self.ksk[pid], self.bsk[pid]
        return self.ksk, self.bsk

    def packing(self, pid: int):
        if isinstance(self.pfpksk, dict):
            return self.pfpksk.get(pid)
        return self.pfpksk


class GraphExecutor:
    """Node-by-node evaluation of a graph on torch tensors.

    Mono mode: one keyset (`params`) serves every PBS.  Multi mode (specs
    with partitions, compilation/multi.py): each PBS runs in its *input*
    class's partition (the class's partition id keys the parameters), and
    a big->big conversion keyswitch moves a crossing output into its
    class's partition: the reference's TFHECircuitSolutionParametrization
    change-partition lowering shape."""

    def __init__(self, graph: Graph, params: CryptoParams, p: int,
                 wop_params=None, specs=None):
        from concrete_tpu_torch.compilation.widths import (encoding_width,
                                                           partition_of,
                                                           tlu_fused_lsbs)
        self.graph = graph
        self.params = params
        self.p = p
        self.width_of = lambda node: encoding_width(node, p)
        # partition id of a node's value: its width under the PRECISION
        # cut, synthetic under PRECISION_AND_NORM2 (widths.partition_of)
        self.part_of = lambda node: partition_of(node, p)
        self.partitions = dict(specs.partitions) \
            if specs is not None and specs.is_multi else None
        self.conversions = dict(specs.conversions or {}) \
            if self.partitions else {}
        self.wop_params_by_width: dict[int, object] = {}
        if self.partitions and specs.partition_wop_gadgets:
            self.wop_params_by_width = {
                w: specs.wop_params(w) for w in specs.partition_wop_gadgets}
            wop_params = None
        self.wop_params = wop_params
        self.tlu_specs: dict[int, TluSpec] = {}
        self.multivariate_specs: dict[int, MultivariateSpec] = {}
        self.wop_specs: dict[int, WopTluSpec] = {}
        for node in graph.topological_order():
            if not node.output.is_encrypted \
                    or node.operation != Operation.Generic:
                # clear-output ops never bootstrap: a lookup on a clear
                # value runs its evaluator on the host
                continue
            name = node.name
            preds = graph.ordered_preds_of(node)
            if name in ("tlu", "univariate"):
                p_in = self.width_of(preds[0]) if preds else p
                pid_in = self.lookup_partition(node)
                lsbs = tlu_fused_lsbs(graph, node)
                if max(p_in - lsbs, 1) > self.max_native_bits(pid_in):
                    self._require_wop(node, pid_in)
                    self.wop_specs[node.uid] = _materialize_wop_table(
                        node, p_in, self.width_of(node), lsbs=lsbs)
                else:
                    self.tlu_specs[node.uid] = _materialize_table(
                        node, p_in, self.width_of(node),
                        self.params_for_width(pid_in), lsbs=lsbs)
            elif name == "multivariate":
                enc = [q for q in preds if q.output.is_encrypted]
                p_in = max((self.width_of(q) for q in enc), default=p)
                pid_in = self.lookup_partition(node)
                if p_in > self.max_native_bits(pid_in):
                    self._require_wop(node, pid_in)
                    mins, _, offsets = packed_layout(graph, node)
                    self.wop_specs[node.uid] = WopTluSpec(
                        node_uid=node.uid,
                        table=multivariate_raw_table(graph, node, p_in),
                        nb_bits=p_in, delta_log=63 - p_in,
                        out_bits=self.width_of(node), mins=mins,
                        offsets=offsets)
                else:
                    self.multivariate_specs[node.uid] = \
                        _materialize_multivariate(
                            graph, node, p_in, self.width_of(node),
                            self.params_for_width(pid_in))
            elif name == "crt_tlu":
                enc = [q for q in preds if q.output.is_encrypted]
                self._require_wop(node, self.lookup_partition(node))
                self.wop_specs[node.uid] = _materialize_crt_tlu(
                    node, self.width_of(node),
                    tuple(self.width_of(q) for q in enc))
            elif name == "dynamic_tlu":
                self._check_dynamic_tlu(
                    preds, self.max_native_bits(self.lookup_partition(node)))
            elif name not in _KINDS:
                raise NotImplementedError(
                    f"operation '{name}' is not lowered yet")

    def params_for_width(self, width: int) -> CryptoParams:
        """Parameters of a partition id (= the encoding width unless the
        norm2 cut assigned synthetic ids; see widths.partition_of)."""
        if self.partitions and width in self.partitions:
            return self.partitions[width]
        return self.params

    def max_native_bits(self, pid: int) -> int:
        """Widest TLU one blind rotate serves in partition `pid`."""
        n = self.params_for_width(pid).polynomial_size
        return min(8, n.bit_length() - 2)

    def wop_params_for(self, width: int):
        if self.partitions:
            return self.wop_params_by_width.get(width)
        return self.wop_params

    def lookup_partition(self, node: Node) -> int:
        """The partition a lookup node's PBS runs in: its (first)
        encrypted operand's, the table index of a dynamic lookup."""
        preds = self.graph.ordered_preds_of(node)
        if node.name in ("tlu", "univariate"):
            return self.part_of(preds[0]) if preds else self.p
        if node.name == "dynamic_tlu":
            return self.part_of(preds[1])
        enc = [q for q in preds if q.output.is_encrypted]
        return self.part_of(enc[0]) if enc else self.p

    def _require_wop(self, node: Node, pid: int) -> None:
        if self.wop_params_for(pid) is None:
            raise ValueError(
                f"node '{node.name}' needs a WoP-PBS lowering "
                "(input wider than the native LUT) but the circuit was "
                "compiled without WoP gadget parameters")

    def wop_lookups(self) -> list:
        """(WopParams, nb_bits, elements) of every WoP lookup, with its
        partition's gadgets: what ``core.kernels_wop.check_wop_memory``
        models."""
        out = []
        for node in self.graph.graph.nodes:
            spec = self.wop_specs.get(node.uid)
            if spec is not None:
                out.append((self.wop_params_for(self.lookup_partition(node)),
                            spec.nb_bits,
                            max(int(np.prod(node.output.shape)), 1)))
        return out

    def _check_dynamic_tlu(self, preds, max_native: int) -> None:
        """The JAX package's construction-time checks of a dynamic table."""
        p_in = self.width_of(preds[1])
        if p_in > max_native:
            raise ValueError(
                f"dynamic table lookup at {p_in} bits exceeds the native "
                "LUT width; dynamic tables cannot lower to WoP-PBS (their "
                "contents are only known at run time) — round/truncate the "
                "index first")
        tshape = tuple(preds[0].output.shape)
        if len(tshape) != 1:
            raise ValueError(
                "dynamic table lookups need a 1-D clear table (got shape "
                f"{tshape}); per-element dynamic tables are not supported — "
                "use a static multi-dimensional LookupTable")
        table_len = tshape[-1] if tshape else 0
        if table_len != (1 << p_in):
            raise ValueError(
                f"dynamic table needs exactly 2^{p_in} = {1 << p_in} entries "
                f"for its {p_in}-bit index (got {table_len}); pad the table "
                "or fhe.hint the index wider")

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _encode_clear(value, width: int, device) -> torch.Tensor:
        enc = np.array(ref.encode(np.asarray(value), width), order="C")
        return torch.from_numpy(enc.view(np.int64)).to(device)

    def _trivial(self, value, width: int, device,
                 pid: int = None) -> torch.Tensor:
        """Trivial LWE encryption of clear values (mask zeros), sized for
        partition `pid` (default: the `width`-bit partition)."""
        enc = self._encode_clear(value, width, device)
        n_big = self.params_for_width(width if pid is None else pid).n_big
        out = torch.zeros(enc.shape + (n_big + 1,), dtype=torch.int64,
                          device=device)
        out[..., -1] = enc
        return out

    @staticmethod
    def _contract(args, enc_flags, device) -> torch.Tensor:
        """matmul / dot of an encrypted operand with a clear one, as the
        JAX package computes it: an int64 elementwise multiply (mod 2^64)
        and a sum, never a GEMM (cuBLAS has no int64 GEMM).  The
        ciphertext's LWE axis stays last."""
        a, b = args
        ea, eb = enc_flags
        if ea and eb:
            raise NotImplementedError("enc x enc matmul planned")

        def clear(v):
            return torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
        if ea:
            ct, w = a, clear(b)
            if w.ndim == 1:
                return (ct * w[..., None]).sum(dim=-2)
            if w.ndim == 2:
                # (..., K, d) x (K, M) -> (..., M, d)
                return (ct[..., :, None, :] * w[:, :, None]).sum(dim=-3)
        else:
            w, ct = clear(a), b
            if w.ndim == 1:
                # (K,) x (K, ..., d): contract the leading K axis
                return (w.reshape((-1,) + (1,) * (ct.ndim - 1)) * ct).sum(
                    dim=0)
            if w.ndim == 2 and ct.ndim == 2:
                # (M, K) x (K, d) -> (M, d)
                return (w[..., None] * ct[None, ...]).sum(dim=1)
            if w.ndim == 2:
                # (M, K) x (..., K, P, d) -> (..., M, P, d)
                return (w[:, :, None, None] * ct[..., None, :, :, :]).sum(
                    dim=-3)
        raise NotImplementedError(
            "matmul with a clear operand above 2-D is not lowered; reshape "
            "to a stack of 2-D matmuls")

    @staticmethod
    def _conv(ct: torch.Tensor, kw: dict) -> torch.Tensor:
        """Encrypted NCHW x clear OIHW convolution, as the JAX package
        lowers it: a loop over the kh x kw kernel positions, each one
        strided window times the weights and a sum over the input
        channels, in int64 (cuDNN has no int64 path)."""
        w = torch.from_numpy(np.asarray(kw["weight"], dtype=np.int64)).to(
            ct.device)                              # (o, c, kh, kw)
        sh, sw = kw["strides"]
        ph, pw = kw["padding"]
        _, _, h, wdt, _ = ct.shape                  # (n, c, h, w, d)
        _, _, kh, kwid = w.shape
        if ph or pw:
            ct = torch.nn.functional.pad(ct, (0, 0, pw, pw, ph, ph))
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (wdt + 2 * pw - kwid) // sw + 1
        out = None
        for ki in range(kh):
            for kj in range(kwid):
                win = ct[:, :, ki:ki + sh * (oh - 1) + 1:sh,
                         kj:kj + sw * (ow - 1) + 1:sw, :]
                term = (win[:, None] * w[None, :, :, ki, kj, None, None, None]
                        ).sum(dim=2)
                out = term if out is None else out + term
        return out

    @staticmethod
    def _index(ct: torch.Tensor, index) -> torch.Tensor:
        """x[index] over the data axes, the trailing LWE axis out of the
        index's reach, with numpy's semantics: a view for basic indices,
        else one gather of the rows numpy's own indexing selects."""
        idx_t = index if isinstance(index, tuple) else (index,)
        if _is_basic(idx_t):
            return ct[_torch_index(idx_t) + (slice(None),)]
        data = tuple(ct.shape[:-1])
        rows = np.arange(int(np.prod(data)), dtype=np.int64).reshape(data)
        sel = np.asarray(rows[index])
        flat = ct.reshape(-1, ct.shape[-1])
        picked = flat[torch.from_numpy(np.ascontiguousarray(sel).reshape(
            -1)).to(ct.device)]
        return picked.reshape(sel.shape + (ct.shape[-1],))

    @staticmethod
    def _assign(x: torch.Tensor, index, v: torch.Tensor) -> torch.Tensor:
        """A new tensor equal to x with x[index] = v (JAX's .at[].set).
        numpy resolves which row ends where, on the host: the last writer
        of a repeated index wins, as in numpy."""
        data, d = tuple(x.shape[:-1]), x.shape[-1]
        size = int(np.prod(data))
        sel = np.arange(size, dtype=np.int64).reshape(data)
        v_data = tuple(v.shape[:-1])
        sel[index] = size + np.arange(int(np.prod(v_data)),
                                      dtype=np.int64).reshape(v_data)
        rows = torch.cat([x.reshape(-1, d), v.reshape(-1, d)])
        return rows[torch.from_numpy(sel.reshape(-1)).to(x.device)].reshape(
            x.shape)

    def _lookup(self, ct, keys: RunKeys, pid: int, lut_poly,
                message_bits: int, signed: bool) -> torch.Tensor:
        """One pbs_batch over every element of `ct`, in partition `pid`."""
        ksk, bsk = keys.pair(pid)
        flat = ct.reshape(-1, ct.shape[-1]).contiguous()
        res = kn.pbs_batch(flat, ksk, bsk, lut_poly,
                           self.params_for_width(pid), message_bits,
                           signed=signed)
        return res.reshape(ct.shape[:-1] + (res.shape[-1],))

    def _cross(self, out, keys: RunKeys, w_in: int,
               w_out: int) -> torch.Tensor:
        """Move a fresh lookup output across a partition frontier: the
        big->big conversion keyswitch of (w_in, w_out), where there is
        one."""
        if self.partitions is None or w_in == w_out \
                or (w_in, w_out) not in (keys.fks or {}):
            return out
        flat = out.reshape(-1, out.shape[-1]).contiguous()
        conv = kn.keyswitch(flat, keys.fks[(w_in, w_out)])
        return conv.reshape(out.shape[:-1] + (conv.shape[-1],))

    # -- the evaluation ----------------------------------------------------

    def _run_wop(self, ct, spec: WopTluSpec, table, keys: RunKeys,
                 pid: int) -> torch.Tensor:
        """One wop_pbs_batch over every element of `ct`, in partition
        `pid`."""
        from concrete_tpu_torch.core import kernels_wop as kw
        ksk, bsk = keys.pair(pid)
        flat = ct.reshape(-1, ct.shape[-1]).contiguous()
        out = kw.wop_pbs_batch(flat, table, spec.nb_bits, spec.delta_log,
                               spec.out_bits, ksk, bsk, keys.packing(pid),
                               self.wop_params_for(pid))
        return out.reshape(ct.shape[:-1] + (out.shape[-1],))

    def _run_crt_tlu(self, node, preds, args, keys: RunKeys, pid: int,
                     wop) -> torch.Tensor:
        """One output residue of an ``fhe.crt_tlu``, in partition `pid`.
        The first residue run on a set of residue inputs extracts their
        bits and runs the chunked circuit bootstrap once for every output
        residue on those inputs (its siblings), each chunk's GGSWs serving
        all their vertical packings; the run's cache keeps the residues."""
        from concrete_tpu_torch.core import kernels_wop as kw
        wop_tables, crt_cache = wop
        ksk, bsk = keys.pair(pid)
        wp = self.wop_params_for(pid)
        if node.uid not in crt_cache:
            spec = self.wop_specs[node.uid]
            cache_key = tuple(pr.uid for pr in preds)
            siblings = [
                n for n in self.graph.graph.nodes
                if n.name == "crt_tlu" and tuple(
                    pr.uid for pr in self.graph.ordered_preds_of(n))
                == cache_key]
            chunks = []
            for j in reversed(range(len(spec.moduli))):
                flat = args[j].reshape(-1, args[j].shape[-1]).contiguous()
                # the LSB of residue j sits at 63 - its encoding width; the
                # index bits per block were clamped to that width
                chunks.append(kw.extract_bits_batch(
                    flat, spec.block_bits[j], 63 - spec.block_widths[j],
                    ksk, bsk, wp.base))
            outs = kw._cbs_vp_chunked(
                torch.cat(chunks, dim=1),
                [kw.lut_torus(wop_tables[n.uid],
                              self.wop_specs[n.uid].out_bits,
                              args[0].device) for n in siblings],
                ksk, bsk, keys.packing(pid), wp)
            crt_cache.update(zip((n.uid for n in siblings), outs))
        out = crt_cache[node.uid]
        return out.reshape(args[0].shape[:-1] + (out.shape[-1],))

    def _run_extract_bits(self, node, preds, ct, keys: RunKeys,
                          pid: int) -> torch.Tensor:
        """``fhe.bits``: the lsb cascade (``extract_bits_to``), requested
        bit j re-encoded at weight 2^j of the output width and summed, in
        partition `pid`."""
        from concrete_tpu_torch.core import kernels_wop as kw
        ksk, bsk = keys.pair(pid)
        positions = node.properties["kwargs"]["positions"]
        enc = [q for q in preds if q.output.is_encrypted]
        p_in = self.width_of(enc[0])
        p_out = self.width_of(node)
        order = sorted(range(len(positions)), key=lambda j: positions[j])
        flat = ct.reshape(-1, ct.shape[-1]).contiguous()
        bits_out = kw.extract_bits_to(
            flat, tuple(positions[j] for j in order),
            tuple(63 - p_out + j for j in order), 63 - p_in, ksk, bsk,
            self.params_for_width(pid))
        out = bits_out.sum(dim=1)
        return out.reshape(ct.shape[:-1] + (out.shape[-1],))

    def run(self, enc_inputs: dict, ksk, bsk, lut_polys: dict,
            wop_tables: dict = None, pfpksk=None, fks: dict = None,
            device=None) -> tuple:
        """Evaluate the graph on `device` (default: the keys').  enc_inputs
        maps input position -> int64 ciphertext tensor (or a clear numpy
        array for clear inputs); lut_polys maps lookup node uid -> (N,) or
        (rows, N) int64 LUT polynomial; wop_tables maps a WoP lookup's uid
        -> its raw int64 table on the device, served with the packed
        PFPKSK `pfpksk`.  Clear outputs come back as trivial ciphertexts.

        Mono: ksk/bsk are one packed key pair (pfpksk one packed PFPKSK).
        Multi-partition: ksk/bsk/pfpksk are dicts keyed by partition id
        and `fks` maps (src, dst) -> packed conversion LimbKSK."""
        from concrete_tpu_torch.compilation.widths import \
            output_encoding_width
        graph = self.graph
        values: dict[Node, object] = {}
        runtime: set[Node] = set()     # clear values from clear inputs
        keys = RunKeys(ksk, bsk, pfpksk, fks)
        if device is None:
            device = (next(iter(ksk.values())) if isinstance(ksk, dict)
                      else ksk).device
        input_pos = {n: q for q, n in graph.input_nodes.items()}
        # the crt_tlu residues computed with their siblings
        wop = (wop_tables or {}, {})
        for node in graph.topological_order():
            name = node.name
            if node.operation == Operation.Input:
                values[node] = enc_inputs[input_pos[node]]
                if not node.output.is_encrypted:
                    runtime.add(node)
                continue
            if node.operation == Operation.Constant:
                values[node] = node()
                continue
            if name == "encrypted_constant":
                values[node] = self._trivial(
                    node.properties["kwargs"]["value"], self.width_of(node),
                    device, pid=self.part_of(node))
                continue
            preds = graph.ordered_preds_of(node)
            args = [values[pr] for pr in preds]
            enc_flags = [pr.output.is_encrypted for pr in preds]
            if not node.output.is_encrypted and not any(enc_flags):
                # a fully clear subcomputation, on the host
                if any(pr in runtime for pr in preds):
                    if name in ("tlu", "univariate", "dynamic_tlu"):
                        raise NotImplementedError(
                            f"clear {name} over a runtime clear input is "
                            "not supported; precompute it outside the "
                            "circuit")
                    runtime.add(node)
                values[node] = node(*args)
                continue
            with tm.span("node." + name) if tm.on else tm.OFF:
                values[node] = self._run_node(node, preds, args, enc_flags,
                                              keys, lut_polys, device, wop)
        outs = []
        for out_node in graph.ordered_outputs:
            v = values[out_node]
            if not out_node.output.is_encrypted:
                # a width covering the clear value's full range (equal to
                # ClientSpecs.output_widths)
                v = self._trivial(
                    v, output_encoding_width(out_node, self.p), device)
            outs.append(v)
        return tuple(outs)

    def _run_lookup(self, node, preds, args, keys: RunKeys, pid: int,
                    lut_polys, device, wop) -> torch.Tensor:
        """A lookup node's output in its input partition `pid`: a WoP-PBS
        (a crt_tlu residue, a wide tlu or multivariate), the lsb cascade of
        ``fhe.bits``, or one pbs_batch over its elements."""
        name = node.name
        wop_tables, _ = wop
        if name == "crt_tlu":
            return self._run_crt_tlu(node, preds, args, keys, pid, wop)
        if name == "extract_bits":
            return self._run_extract_bits(node, preds, args[0], keys, pid)
        if name == "dynamic_tlu":
            # the table is a runtime clear tensor: build the accumulator
            # polynomial here, then the same batched PBS as a static TLU
            table_vals, ct = args
            w_in = self.width_of(preds[1])
            signed = isinstance(preds[1].output.dtype, Integer) \
                and preds[1].output.dtype.is_signed
            lut_poly = kn.encode_expand_lut(
                torch.from_numpy(np.asarray(table_vals, dtype=np.int64))
                .to(device), self.params_for_width(pid).polynomial_size,
                w_in, self.width_of(node), signed=signed)
            return self._lookup(ct, keys, pid, lut_poly, w_in, signed)
        spec = self.wop_specs.get(node.uid)
        ct = args[0]
        if name == "multivariate":
            spec = spec or self.multivariate_specs[node.uid]
            ct, bias = None, 0
            for arg, mn, off in zip(args, spec.mins, spec.offsets):
                term = arg * (1 << off)
                ct = term if ct is None else ct + term
                bias += mn << off
            width = spec.nb_bits if node.uid in self.wop_specs \
                else spec.message_bits
            ct[..., -1] -= self._encode_clear(bias, width, device)
        if node.uid in self.wop_specs:
            return self._run_wop(ct, spec, wop_tables[node.uid], keys, pid)
        if name == "multivariate":
            return self._lookup(ct, keys, pid, lut_polys[node.uid],
                                spec.message_bits, False)
        spec = self.tlu_specs[node.uid]
        return self._lookup(ct, keys, pid, lut_polys[node.uid],
                            spec.message_bits, spec.signed_input)

    def _run_node(self, node, preds, args, enc_flags, keys: RunKeys,
                  lut_polys, device, wop) -> torch.Tensor:
        name = node.name
        kw = node.properties.get("kwargs", {})
        wop_tables, _ = wop
        if name in ("tlu", "univariate", "multivariate", "dynamic_tlu",
                    "crt_tlu", "extract_bits"):
            # every lookup kind runs in its input's partition, and its
            # output crosses into its own class's partition
            pid = self.lookup_partition(node)
            out = self._run_lookup(node, preds, args, keys, pid, lut_polys,
                                   device, wop)
            return self._cross(out, keys, pid, self.part_of(node))
        if name in ("add", "subtract"):
            a, b = args
            ea, eb = enc_flags
            sign = 1 if name == "add" else -1
            if ea and eb:
                return a + b if sign > 0 else a - b
            if ea:
                out = a.clone()
                out[..., -1] += sign * self._encode_clear(
                    b, self.width_of(node), device)
                return out
            out = b.clone() if sign > 0 else -b    # clear +/- encrypted
            out[..., -1] += self._encode_clear(a, self.width_of(node), device)
            return out
        if name == "multiply":
            a, b = args
            ea, eb = enc_flags
            if ea and eb:
                raise NotImplementedError(
                    "encrypted x encrypted multiplication lowers to two "
                    "TLUs ((x+y)^2/4 - (x-y)^2/4); planned")
            ct, clear = (a, b) if ea else (b, a)
            c = torch.from_numpy(np.asarray(clear, dtype=np.int64)).to(device)
            return ct * c[..., None]
        if name == "negative":
            return -args[0]
        if name in ("matmul", "dot"):
            return self._contract(args, enc_flags, device)
        if name == "sum":
            ct, axis = args[0], kw.get("axis")
            nd = ct.ndim - 1           # data dims (the LWE axis is last)
            if axis is None:
                axes = tuple(range(nd))
            else:
                # negative axes count from the last *data* dim, one before
                # the trailing LWE axis
                axes = tuple(a if a >= 0 else a - 1 for a in (
                    axis if isinstance(axis, tuple) else (axis,)))
            # torch reads an empty dim tuple as "every dim"
            return ct.sum(dim=axes) if axes else ct
        if name == "conv":
            out = self._conv(args[0], kw)
            if kw.get("bias") is not None:
                enc_b = self._encode_clear(
                    np.asarray(kw["bias"], dtype=np.int64),
                    self.width_of(node), device)
                out[..., -1] += enc_b[None, :, None, None]
            return out
        if name in ("round_bit_pattern", "truncate_bit_pattern"):
            # fused rounding: the consumer lookup's table is built at the
            # reduced width and its modulus switch rounds; truncation
            # (floor) also biases by -half a step, unless approximate
            ct = args[0]
            if name == "truncate_bit_pattern" \
                    and not node.properties.get("approximate"):
                half = 1 << (int(kw["lsbs_to_remove"]) - 1)
                ct = ct.clone()
                ct[..., -1] -= self._encode_clear(half, self.width_of(node),
                                                  device)
            return ct
        if name == "hint":
            return args[0]
        if name == "array":
            # stack scalar ciphertexts into one tensor; clear entries are
            # trivially encrypted first
            w = self.width_of(node)
            cts = [a if flag else self._trivial(a, w, device,
                                                pid=self.part_of(node))
                   for a, flag in zip(args, enc_flags)]
            return torch.stack(cts).reshape(
                tuple(node.output.shape) + (cts[0].shape[-1],))
        if name == "trace_message":
            # an identity; with CONCRETE_TPU_TRACE=1 it prints the
            # ciphertext body word (the server cannot decrypt)
            ct = args[0]
            if os.environ.get("CONCRETE_TPU_TRACE") == "1":
                msg = kw.get("message", "trace")
                print(f"{msg}: body={ct[..., -1].cpu().numpy()}")
            return ct
        if name == "concatenate":
            ax = kw["axis"] % len(node.output.shape)  # the LWE axis stays
            return torch.cat(args, dim=ax)
        if name == "transpose":
            ct, axes = args[0], kw["axes"]
            nd = ct.ndim - 1
            perm = tuple(axes) if axes is not None \
                else tuple(reversed(range(nd)))
            return ct.permute(perm + (nd,))
        if name == "broadcast_to":
            ct = args[0]
            return ct.expand(tuple(kw["shape"]) + (ct.shape[-1],))
        if name == "index":
            return self._index(args[0], kw["index"])
        if name == "assign":
            x, v = args
            w = self.width_of(node)
            if not enc_flags[0]:
                x = self._trivial(x, w, device, pid=self.part_of(node))
            if not enc_flags[1]:
                v = self._trivial(v, w, device, pid=self.part_of(node))
            return self._assign(x, kw["index"], v)
        if name == "reshape":
            ct = args[0]
            return ct.reshape(tuple(node.output.shape) + (ct.shape[-1],))
        raise NotImplementedError(f"operation '{name}' is not lowered yet")
