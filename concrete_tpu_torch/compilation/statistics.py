"""Primitive crypto-op statistics extracted from the lowered graph.

A copy of ``concrete_tpu/compilation/statistics.py`` for the port's
executor (the frontier keyswitches of multi-partition circuits included),
the analog of the reference's ExtractStatistics pass
(compiler/lib/Dialect/TFHE/Analysis/ExtractStatistics.cpp: counts of
PBS / KEY_SWITCH / WOP_PBS / PACKING_KEY_SWITCH / CLEAR_ADDITION /
ENCRYPTED_ADDITION / CLEAR_MULTIPLICATION / ENCRYPTED_NEGATION per
location and per key), surfaced as the ~28 `Circuit.*_count*` properties
(frontends/concrete-python/concrete/fhe/compilation/circuit.py:302-533).

Here statistics are recomputed from the post-transform graph — the same
graph the executor lowers — so the counts reflect what actually runs:
mul->2xTLU and comparison lowerings already appear as their TLU forms,
fused rounding adds nothing, and WoP TLUs report their bit-extract /
circuit-bootstrap sub-operations.  The "parameter" key of the
`*_per_parameter` variants is the partition's encoding width (an int;
mono circuits have a single partition = the global width), matching the
reference's per-key grouping at the granularity this framework keys its
keysets.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

#: primitive operation kinds (reference CompilationFeedback.h:27-36)
PBS = "programmable_bootstrap"
WOP_PBS = "wop_pbs"
KEY_SWITCH = "key_switch"
PACKING_KEY_SWITCH = "packing_key_switch"
CLEAR_ADDITION = "clear_addition"
ENCRYPTED_ADDITION = "encrypted_addition"
CLEAR_MULTIPLICATION = "clear_multiplication"
ENCRYPTED_NEGATION = "encrypted_negation"

KINDS = (PBS, WOP_PBS, KEY_SWITCH, PACKING_KEY_SWITCH, CLEAR_ADDITION,
         ENCRYPTED_ADDITION, CLEAR_MULTIPLICATION, ENCRYPTED_NEGATION)


@dataclasses.dataclass(frozen=True)
class Record:
    """One primitive-op count at one graph location."""
    kind: str
    tag: str
    parameter: int  # partition encoding width
    count: int


def _size(node) -> int:
    return max(int(np.prod(node.output.shape)), 1)


def collect(graph, executor, default_width: int) -> list[Record]:
    """Walk the lowered graph and emit per-node primitive-op records.

    `executor` is the server's GraphExecutor: its width/spec tables say how
    each TLU actually lowers (native PBS vs WoP, effective input width).
    """
    records: list[Record] = []

    def width_of(node) -> int:
        try:
            return executor.width_of(node)
        except Exception:
            return default_width

    def emit(kind: str, node, count: int, width: int = None) -> None:
        if count <= 0:
            return
        records.append(Record(
            kind, node.properties.get("tag", ""),
            width if width is not None else width_of(node), int(count)))

    def enc(node) -> bool:
        return node.output.is_encrypted

    for node in graph.topological_order():
        name = node.name
        preds = graph.ordered_preds_of(node)
        size = _size(node)
        if not enc(node):
            continue

        if name in ("add", "subtract"):
            both_enc = len(preds) == 2 and all(enc(q) for q in preds)
            if both_enc:
                emit(ENCRYPTED_ADDITION, node, size)
                if name == "subtract":
                    emit(ENCRYPTED_NEGATION, node, size)
            else:
                emit(CLEAR_ADDITION, node, size)
                if name == "subtract" and preds and not enc(preds[0]):
                    # clear - enc = neg(enc) + clear (FHEToTFHEScalar
                    # sub_int_eint lowering)
                    emit(ENCRYPTED_NEGATION, node, size)
        elif name == "multiply":
            # enc x enc was rewritten to TLUs by transforms; what remains
            # is a cleartext multiplication per element
            emit(CLEAR_MULTIPLICATION, node, size)
        elif name == "negative":
            emit(ENCRYPTED_NEGATION, node, size)
        elif name in ("matmul", "dot"):
            enc_pred = next((q for q in preds if enc(q)), None)
            clear_pred = next((q for q in preds if not enc(q)), None)
            if enc_pred is None:
                continue
            if clear_pred is not None:
                # contraction length: the shared axis of the two operands
                a_sh, b_sh = preds[0].output.shape, preds[1].output.shape
                k = a_sh[-1] if a_sh else (b_sh[0] if b_sh else 1)
                if name == "matmul" and len(a_sh) >= 1 and len(b_sh) >= 1:
                    k = a_sh[-1]
                emit(CLEAR_MULTIPLICATION, node, size * k)
                emit(ENCRYPTED_ADDITION, node, size * max(k - 1, 0))
            else:
                # enc x enc contraction (lowered via TLU squares upstream):
                # the residual adds
                k = preds[0].output.shape[-1] if preds[0].output.shape else 1
                emit(ENCRYPTED_ADDITION, node, size * max(k - 1, 0))
        elif name == "sum":
            in_size = _size(preds[0]) if preds else size
            emit(ENCRYPTED_ADDITION, node, max(in_size - size, 0))
        elif name == "conv":
            kw = node.properties["kwargs"]
            w = np.asarray(kw["weight"])
            o, c, kh, kwid = w.shape
            macs = c * kh * kwid
            emit(CLEAR_MULTIPLICATION, node, size * macs)
            emit(ENCRYPTED_ADDITION, node, size * max(macs - 1, 0))
            if kw.get("bias") is not None:
                emit(CLEAR_ADDITION, node, size)
        elif name == "dynamic_tlu":
            preds_enc = [q for q in preds if enc(q)]
            w_in = width_of(preds_enc[0]) if preds_enc else default_width
            emit(KEY_SWITCH, node, size, w_in)
            emit(PBS, node, size, w_in)
        elif name in ("tlu", "univariate", "multivariate"):
            from concrete_tpu_torch.compilation.widths import \
                tlu_effective_input_width
            preds_enc = [q for q in preds if enc(q)]
            # the width the PBS actually runs at: fused rounding shrinks
            # the LUT index domain (per_bit_width must show the reduced
            # cost; the keyset is the same within the mono partition)
            w_in = tlu_effective_input_width(graph, node, default_width) \
                if preds_enc else default_width
            spec = getattr(executor, "wop_specs", {}).get(node.uid)
            if spec is not None:
                # WoP-PBS: nb bit-extract PBS, then a circuit bootstrap
                # per bit (PBS + packing keyswitch) feeding the
                # vertical-packing lookup (counted as the WOP_PBS op)
                nb = spec.nb_bits
                emit(KEY_SWITCH, node, size * nb, w_in)
                emit(PBS, node, size * nb, w_in)
                emit(PACKING_KEY_SWITCH, node, size * nb, w_in)
                emit(WOP_PBS, node, size, w_in)
            else:
                emit(KEY_SWITCH, node, size, w_in)
                emit(PBS, node, size, w_in)
        elif name == "extract_bits":
            positions = node.properties["kwargs"]["positions"]
            preds_enc = [q for q in preds if enc(q)]
            w_in = width_of(preds_enc[0]) if preds_enc else default_width
            # lsb cascade (kernels_wop.extract_bits_to): one cleaning
            # sign-PBS per peeled position below the highest, plus one
            # output sign-PBS per requested bit.  The kernel shares a
            # clean with an output when their torus scales coincide; that
            # depends on runtime scales, so count the unshared upper bound
            # (the global_p_error union bound must not be optimistic).
            max_bit = max(int(p) for p in positions)
            n_steps = max_bit + len(positions)
            per = _size(preds_enc[0]) if preds_enc else 1
            emit(KEY_SWITCH, node, per * n_steps, w_in)
            emit(PBS, node, per * n_steps, w_in)
            emit(ENCRYPTED_ADDITION, node,
                 per * max(len(positions) - 1, 0), w_in)

        # partition-frontier conversion keyswitch (multi only)
        if getattr(executor, "partitions", None) is not None and preds:
            preds_enc = [q for q in preds if enc(q)]
            if name in ("tlu", "univariate", "multivariate",
                        "extract_bits") and preds_enc:
                part = getattr(executor, "part_of", width_of)
                pid_in = max(part(q) for q in preds_enc)
                if pid_in != part(node):
                    emit(KEY_SWITCH, node, size, width_of(node))

    return records


# ---------------------------------------------------------------------------
# Aggregations backing the Circuit properties
# ---------------------------------------------------------------------------

def total(records: Iterable[Record], kind: str) -> int:
    return sum(r.count for r in records if r.kind == kind)


def per_parameter(records: Iterable[Record], kind: str) -> dict[int, int]:
    out: dict[int, int] = {}
    for r in records:
        if r.kind == kind:
            out[r.parameter] = out.get(r.parameter, 0) + r.count
    return out


def per_tag(records: Iterable[Record], kind: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for r in records:
        if r.kind == kind:
            out[r.tag] = out.get(r.tag, 0) + r.count
    return out


def per_tag_per_parameter(records: Iterable[Record],
                          kind: str) -> dict[str, dict[int, int]]:
    out: dict[str, dict[int, int]] = {}
    for r in records:
        if r.kind == kind:
            d = out.setdefault(r.tag, {})
            d[r.parameter] = d.get(r.parameter, 0) + r.count
    return out
