"""Multi-partition execution: per-precision keysets + partition changes.

Counterpart of ``concrete_tpu/core/partitions.py``: the mechanism under the
reference's DAG_MULTI parameter strategy (TFHECircuitSolutionParametrization
+ FHE.change_partition, lib/Dialect/TFHE/Transforms/
TFHECircuitSolutionParametrization.cpp:1308).  A `PartitionedKeyset` holds
one keyset per partition plus conversion KSKs (the source partition's big
key -> the target partition's *small* key, so a crossing rides the KS->BR
of the target's bootstrap); `cross_partition_pbs` applies a TLU whose
input lives in partition A and whose output lives in partition B.

Keys come from a numpy Generator, as in the JAX package, so the same seed
gives the same keys in both; the packed keys live on a torch device, the
card unless the caller asks for the CPU.  The compiled circuits' multi
mode (``compilation/executor.py``) uses big->big conversion keys instead
(``compilation/keys.MultiKeys``); this module is the standalone mechanism.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Partition:
    name: str
    params: CryptoParams
    message_bits: int
    secret: ref.SecretKeys
    server: ref.ServerKeys
    device: torch.device
    packed_ksk: kn.LimbKSK = None
    packed_bsk: kn.LimbBSK = None

    def packed(self):
        """(LimbKSK, LimbBSK) on the partition's device, packed once."""
        if self.packed_ksk is None:
            self.packed_ksk = kn.pack_ksk(self.server.ksk, self.params,
                                          device=self.device)
            self.packed_bsk = kn.pack_bsk(self.server.bsk, self.params,
                                          device=self.device)
        return self.packed_ksk, self.packed_bsk


@dataclasses.dataclass
class PartitionedKeyset:
    partitions: dict[str, Partition]
    #: (src, dst) -> conversion KSK: src big key -> dst small key, packed
    conversion: dict[tuple[str, str], kn.LimbKSK]

    def partition(self, name: str) -> Partition:
        return self.partitions[name]


def keygen_partitioned(rng, specs: dict[str, tuple[CryptoParams, int]],
                       conversions: list[tuple[str, str]],
                       device=None) -> PartitionedKeyset:
    """Generate keysets for every partition plus the requested conversion
    keyswitch keys, in the JAX package's order from the same numpy `rng`.

    specs: name -> (params, message_bits); conversions: (src, dst) pairs.
    The conversion KSK uses the *destination* partition's keyswitch
    decomposition (the reference optimizer emits per-frontier conversion
    keys the same way, keys_spec.rs ConversionKeySwitchKey).  Packed keys
    go to `device`, CUDA by default.
    """
    device = resolve_device(device)
    parts = {}
    for name, (params, bits) in specs.items():
        secret, server = kg.keygen_device(rng, params, device)
        parts[name] = Partition(name=name, params=params, message_bits=bits,
                                secret=secret, server=server, device=device)
    conv = {}
    for src, dst in conversions:
        a, b = parts[src], parts[dst]
        ksk_u64 = kg.make_ksk(rng, a.secret.lwe_big, b.secret.lwe_small,
                              b.params.ks_base_log, b.params.ks_level,
                              b.params.lwe_std)
        conv[(src, dst)] = kn.pack_ksk(ksk_u64, b.params, device=device)
    return PartitionedKeyset(partitions=parts, conversion=conv)


def cross_partition_pbs(keyset: PartitionedKeyset, src: str, dst: str,
                        ct_batch, table: np.ndarray, in_bits: int,
                        out_bits: int, signed: bool = False) -> np.ndarray:
    """TLU with input under partition `src`, output under partition `dst`:
    u64 ciphertexts (B, src n_big + 1) -> (B, dst n_big + 1).

    Pipeline: conversion keyswitch (src.big -> dst.small) -> modswitch ->
    blind rotate with dst's BSK -> sample extract (``kernels.pbs_batch``
    with the conversion key as its keyswitch key).

    Precision belongs to *values*, not partitions: `in_bits` is the input
    value's encoded precision (requires dst.polynomial_size >=
    2^(in_bits+1)), `out_bits` the output's.  A partition only accepts
    TLUs whose input precision it can resolve, the reference optimizer's
    feasibility constraint when assigning partitions.
    """
    b = keyset.partition(dst)
    if b.params.polynomial_size < (1 << (in_bits + 1)):
        raise ValueError(
            f"partition '{dst}' (N={b.params.polynomial_size}) cannot "
            f"resolve a {in_bits}-bit TLU input")
    conv_ksk = keyset.conversion[(src, dst)]
    _, bsk = b.packed()
    lut_vals = np.asarray(table, dtype=np.int64)
    idx = np.arange(1 << in_bits)
    lut_enc = (lut_vals[idx % len(lut_vals)]
               & ((1 << (out_bits + 1)) - 1)).astype(np.uint64)
    lut_poly = ref.encode_expand_lut(
        lut_enc, b.params.polynomial_size, in_bits, signed=signed,
        out_bits=out_bits)
    ct = torch.from_numpy(np.ascontiguousarray(
        ct_batch, dtype=np.uint64).view(np.int64)).to(b.device)
    lut = torch.from_numpy(lut_poly.view(np.int64)).to(b.device)
    out = kn.pbs_batch(ct, conv_ksk, bsk, lut, b.params, in_bits,
                       signed=signed)
    return out.cpu().numpy().view(np.uint64)
