"""Client specs: everything a client needs to encrypt/decrypt for a circuit.

The analog of the reference's ProgramInfo / client.specs.json sidecar
(lib/Support/ProgramInfoGeneration.cpp, compilation/specs.py in the Python
frontend): per-gate value descriptions plus the crypto parameters.
Serialized as JSON-able dicts (our stand-in for the capnp schema shapes of
tools/concrete-protocol/concrete-protocol.capnp).
"""

from __future__ import annotations

import dataclasses
import json

from concrete_tpu_torch.dtypes import Integer
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.values import ValueDescription


@dataclasses.dataclass
class ClientSpecs:
    params: CryptoParams
    message_bits: int
    inputs: list[ValueDescription]
    outputs: list[ValueDescription]
    # per-position encoding widths (multi-precision mono,
    # assign_bit_widths.py); None -> every value at message_bits
    input_widths: list[int] = None
    output_widths: list[int] = None
    # WoP-PBS gadget parameters (cbs_level, cbs_base_log, pfks_level,
    # pfks_base_log) when the circuit contains >8-bit TLUs; None otherwise
    wop_gadgets: tuple = None
    # multi-partition compilation (compilation/multi.py): pid -> params,
    # pid -> wop gadget tuple, (src_pid, dst_pid) -> (level, base_log) for
    # the conversion keyswitches, pid -> max norm2.  None -> mono.  A pid
    # is the encoding width under the PRECISION cut; the
    # PRECISION_AND_NORM2 cut adds synthetic ids (widths.partition_of).
    partitions: dict = None
    partition_wop_gadgets: dict = None
    conversions: dict = None
    partition_norm2: dict = None
    # per-position partition ids (None -> the position's width is its pid)
    input_partitions: list = None
    output_partitions: list = None

    @property
    def is_multi(self) -> bool:
        return bool(self.partitions)

    def params_for_width(self, width: int) -> CryptoParams:
        """The crypto parameters of a partition id (= the value's encoding
        width, unless the norm2 cut assigned synthetic ids)."""
        if self.partitions and width in self.partitions:
            return self.partitions[width]
        return self.params

    def input_partition(self, pos: int) -> int:
        if self.input_partitions is not None:
            return self.input_partitions[pos]
        return self.input_width(pos)

    def output_partition(self, pos: int) -> int:
        if self.output_partitions is not None:
            return self.output_partitions[pos]
        return self.output_width(pos)

    def wop_params(self, width: int = None):
        """The WopParams for wide TLUs (None if the circuit has none).

        Under multi-partition compilation, pass the partition width of the
        wide TLU's input class."""
        if not (self.wop_gadgets or self.partition_wop_gadgets):
            return None
        raise NotImplementedError(
            "WoP-PBS is not ported yet (ROADMAP queue 1 item 7)")

    def input_width(self, pos: int) -> int:
        if self.input_widths is None:
            return self.message_bits
        return self.input_widths[pos]

    def output_width(self, pos: int) -> int:
        if self.output_widths is None:
            return self.message_bits
        return self.output_widths[pos]

    def serialize(self) -> str:
        def vd(v: ValueDescription):
            return {"bit_width": v.dtype.bit_width,
                    "is_signed": v.dtype.is_signed,
                    "shape": list(v.shape),
                    "is_encrypted": v.is_encrypted}
        return json.dumps({
            "params": dataclasses.asdict(self.params),
            "message_bits": self.message_bits,
            "inputs": [vd(v) for v in self.inputs],
            "outputs": [vd(v) for v in self.outputs],
            "input_widths": self.input_widths,
            "output_widths": self.output_widths,
            "wop_gadgets": list(self.wop_gadgets)
            if self.wop_gadgets is not None else None,
            "partitions": {str(w): dataclasses.asdict(p)
                           for w, p in self.partitions.items()}
            if self.partitions else None,
            "partition_wop_gadgets": {str(w): list(g) for w, g in
                                      self.partition_wop_gadgets.items()}
            if self.partition_wop_gadgets else None,
            "conversions": [[s, d, l, b] for (s, d), (l, b)
                            in self.conversions.items()]
            if self.conversions else None,
            "partition_norm2": {str(w): n for w, n in
                                self.partition_norm2.items()}
            if self.partition_norm2 else None,
            "input_partitions": self.input_partitions,
            "output_partitions": self.output_partitions,
        })

    @classmethod
    def deserialize(cls, blob: str) -> "ClientSpecs":
        data = json.loads(blob)

        def vd(d):
            return ValueDescription(
                dtype=Integer(d["bit_width"], d["is_signed"]),
                shape=tuple(d["shape"]), is_encrypted=d["is_encrypted"])
        return cls(params=CryptoParams(**data["params"]),
                   message_bits=data["message_bits"],
                   inputs=[vd(d) for d in data["inputs"]],
                   outputs=[vd(d) for d in data["outputs"]],
                   input_widths=data.get("input_widths"),
                   output_widths=data.get("output_widths"),
                   wop_gadgets=tuple(data["wop_gadgets"])
                   if data.get("wop_gadgets") else None,
                   partitions={int(w): CryptoParams(**p) for w, p in
                               data["partitions"].items()}
                   if data.get("partitions") else None,
                   partition_wop_gadgets={int(w): tuple(g) for w, g in
                                          data["partition_wop_gadgets"]
                                          .items()}
                   if data.get("partition_wop_gadgets") else None,
                   conversions={(s, d): (l, b) for s, d, l, b in
                                data["conversions"]}
                   if data.get("conversions") else None,
                   partition_norm2={int(w): n for w, n in
                                    data["partition_norm2"].items()}
                   if data.get("partition_norm2") else None,
                   input_partitions=data.get("input_partitions"),
                   output_partitions=data.get("output_partitions"))
