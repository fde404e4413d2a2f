"""Multi-card scale-out by ciphertext-batch sharding: counterpart of ``concrete_tpu/parallel/sharding.py``.

- the ciphertext *batch* is split over the ranks of a mesh, one rank a
  card (``shard_ciphertexts``), the embarrassingly parallel axis of PBS
  workloads;
- the evaluation keys (KSK and BSK limb planes, or fused spectra) are
  *replicated* into every card's memory, broadcast from rank 0
  (``replicate_keys``);
- each rank runs the port's ``core/kernels.pbs_batch`` on its shard
  (``sharded_pbs_fn``): no collective in the blind rotate, one of the
  shards' row counts before it; ``gather`` assembles the shards on every
  rank (the JAX package's ``process_allgather``).

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the
whole process group (``distributed.initialize``), on the cards under NCCL
or on the CPU under gloo.

Spans (``utils/telemetry``): ``sharding.shard``, ``sharding.replicate_keys``,
``sharding.pbs`` and ``sharding.gather``, whose stages are ``gather.sizes``
(the exchange of the shards' row counts: where a rank waits for the
slowest), ``gather.upload``, ``gather.all_gather`` and ``gather.to_host``;
a host array's upload and download count in ``bytes.h2d`` and
``bytes.d2h``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.ops import latency as lat
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.parallel.distributed import (all_gather_into,
                                                     local_batch_slice)
from concrete_tpu_torch.utils import telemetry as tm


def make_mesh(n_devices: int = None, axis_name: str = "batch"):
    """A 1-D mesh named `axis_name` over every rank of the process group,
    on the cards under NCCL, the CPU under gloo.  `n_devices`, if given,
    must be the group's size: each rank is one device."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"ranks; the process group has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world,), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """This rank's device in `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_ciphertexts(mesh, ct, axis_name: str = "batch"):
    """This rank's slice of a ciphertext batch (B, n+1), the remainder
    spread over the first ranks (``distributed.local_batch_slice``).  A
    single unbatched ciphertext (n+1,) has no batch axis and is replicated
    (sharding the coefficient axis would split the mask).  A tensor goes
    to the rank's device; a host array stays a host array (``Server.run``
    uploads it).  A circuit served on a shard runs each lookup at the
    shard's batch: with a truncated banded key, a shard of at most
    ``kernels.LATENCY_BATCH_MAX`` rows takes the latency blind rotate,
    whose bits differ from the whole batch's; to serve such shards of a
    larger batch, set that bound below the shard
    (``CONCRETE_TPU_LATENCY_BATCH_MAX``).  ``sharded_pbs_fn`` pads its
    shards instead."""
    with tm.span("sharding.shard") if tm.on else tm.OFF:
        if ct.ndim >= 2:
            ct = ct[local_batch_slice(ct.shape[0], mesh.size(),
                                      mesh.get_local_rank(axis_name))]
        if isinstance(ct, torch.Tensor):
            ct = ct.to(mesh_device(mesh))
        return ct


def _replicate(key, group, device: torch.device):
    """One key dataclass from rank 0 on every rank: its fields' shapes and
    values first, then each tensor (allocated here with the storage tail
    rank 0's has, which the latency kernel's bulk copies may read)."""
    src = dist.get_rank(group) == 0
    meta = [None]
    if src:
        meta[0] = (type(key), {
            f.name: (("tensor", tuple(v.shape), v.dtype, lat.tail_bytes(v))
                     if isinstance(v, torch.Tensor) else ("value", v))
            for f in dataclasses.fields(key)
            for v in (getattr(key, f.name),)})
    dist.broadcast_object_list(meta, src=0, group=group, device=device)
    cls, fields = meta[0]
    out = {}
    for name, spec in fields.items():
        if spec[0] == "value":
            out[name] = spec[1]
            continue
        _, shape, dtype, tail = spec
        if src:
            t = getattr(key, name)
        else:
            t = torch.empty(int(np.prod(shape)) * dtype.itemsize + tail,
                            dtype=torch.int8, device=device)
            t = t[:t.numel() - tail].view(dtype).view(shape)
        dist.broadcast(t, src=0, group=group)
        out[name] = t
    return key if src else cls(**out)


def replicate_keys(mesh, ksk, bsk, axis_name: str = "batch"):
    """The packed evaluation keys (a ``LimbKSK``; a ``LimbBSK``,
    ``FusedBSK`` or ``core.ntt_fourstep.NttBSK``) of rank 0, broadcast into
    every rank's device memory; the other ranks may pass None.  Returns
    (ksk, bsk) on this rank."""
    group = mesh.get_group(axis_name)
    device = mesh_device(mesh)
    with tm.span("sharding.replicate_keys") if tm.on else tm.OFF:
        return _replicate(ksk, group, device), _replicate(bsk, group, device)


def sharded_pbs_fn(mesh, params: CryptoParams, message_bits: int,
                   signed: bool = False, axis_name: str = "batch"):
    """A batch-sharded PBS: fn(ct, ksk, bsk, lut_poly) -> ct_out runs
    ``kernels.pbs_batch`` on this rank's shard `ct` (``shard_ciphertexts``)
    with the replicated keys; ``gather`` assembles the outputs.

    The blind rotate takes the form of the whole batch, as it does in the
    JAX package, whose sharded program is traced at the global shape: where
    the batch (summed over the mesh) exceeds ``kernels.LATENCY_BATCH_MAX``
    and this shard does not, the shard is padded with zero ciphertexts (a
    per-row LUT with zero rows) past that size and the output cut back, so
    the bits are the whole batch's even with a truncated banded key."""
    group = mesh.get_group(axis_name)

    def fn(ct, ksk, bsk, lut_poly):
        rows = ct.shape[0]
        with tm.span("sharding.pbs", rows=rows) if tm.on else tm.OFF:
            total = torch.tensor([rows], device=ct.device)
            dist.all_reduce(total, group=group)
            floor = kn.LATENCY_BATCH_MAX + 1
            if total.item() >= floor > rows:
                ct = torch.cat([ct, ct.new_zeros((floor - rows,
                                                  ct.shape[1]))])
                if lut_poly.ndim == 2:
                    lut_poly = torch.cat([lut_poly, lut_poly.new_zeros(
                        (floor - rows, lut_poly.shape[1]))])
            return kn.pbs_batch(ct, ksk, bsk, lut_poly, params,
                                message_bits, signed=signed)[:rows]
    return fn


def gather(mesh, local, axis_name: str = "batch"):
    """Every rank's shard along the batch axis, in rank order, on every
    rank: shards of unequal sizes are padded to the largest for one
    ``all_gather`` and cut back.  A host array (u64 ciphertexts) comes back
    as a host array, a tensor on the rank's device."""
    with tm.span("sharding.gather") if tm.on else tm.OFF:
        return _gather(mesh, local, axis_name)


def _gather(mesh, local, axis_name: str):
    group = mesh.get_group(axis_name)
    device = mesh_device(mesh)
    host = isinstance(local, np.ndarray)
    with tm.span("gather.upload") if tm.on else tm.OFF:
        if host:
            dtype = local.dtype
            arr = np.ascontiguousarray(local)
            local = torch.from_numpy(arr.view(np.int64)
                                     if dtype == np.uint64 else arr)
        t = local.to(device)
    if tm.on and host:
        tm.count("bytes.h2d", local.nbytes)
    world = mesh.size()
    with tm.span("gather.sizes") if tm.on else tm.OFF:
        sizes = torch.empty(world, dtype=torch.int64, device=device)
        all_gather_into(sizes, torch.tensor([t.shape[0]], device=device),
                        group)
        sizes = sizes.tolist()
    with tm.span("gather.all_gather") if tm.on else tm.OFF:
        padded = t.new_zeros((max(sizes),) + tuple(t.shape[1:]))
        padded[:t.shape[0]] = t
        out = t.new_empty((world,) + tuple(padded.shape))
        all_gather_into(out, padded, group)
        full = torch.cat([out[i, :s] for i, s in enumerate(sizes)])
    if not host:
        return full
    with tm.span("gather.to_host") if tm.on else tm.OFF:
        full = full.cpu().numpy()
    if tm.on:
        tm.count("bytes.d2h", full.nbytes)
    return full.view(np.uint64) if dtype == np.uint64 else full
