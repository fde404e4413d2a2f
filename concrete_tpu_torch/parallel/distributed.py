"""Multi-process execution: counterpart of ``concrete_tpu/parallel/distributed.py``.

The JAX package runs one controller per host over a global mesh of every
chip.  The port follows torch's idiom instead: one process per card, as
``torchrun`` launches them, joined in a ``torch.distributed`` process
group (NCCL between cards, gloo when the caller asks for the CPU).  The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over that group
(``sharding.make_mesh``).

Usage, in a script that ``torchrun --nproc-per-node=<cards>`` starts once
per card:

    from concrete_tpu_torch.parallel import distributed, sharding
    distributed.initialize()           # from torchrun's environment
    mesh = distributed.global_mesh()
    fn = sharding.sharded_pbs_fn(mesh, params, p)
    ...

In a single process (no ``WORLD_SIZE``) ``initialize`` does nothing.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(init_method: str = None, world_size: int = None,
               rank: int = None, device=None) -> bool:
    """Join the process group; returns whether one is up.

    The arguments default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` through the ``env://``
    method.  Without a world size there or here it does nothing (a single
    process).  `init_method` may also be ``tcp://host:port`` or
    ``file://path`` (tests).  The backend is NCCL on the rank's card
    (``device_for_rank``, made the current device), gloo with
    ``device="cpu"``.
    """
    if dist.is_initialized():
        return True
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = device_for_rank(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            init_method=init_method or "env://",
                            world_size=int(world_size), rank=int(rank))
    return True


def device_for_rank(device=None, rank: int = None) -> torch.device:
    """The rank's device: the CPU when asked (``device="cpu"``), else the
    card ``cuda:LOCAL_RANK`` (torchrun sets it; without it, the rank modulo
    the cards this host shows)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local)


def global_mesh(axis_name: str = "batch"):
    """A 1-D mesh over every rank of every host."""
    from concrete_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(axis_name=axis_name)


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_batch_slice(global_batch: int, world_size: int = None,
                      rank: int = None) -> slice:
    """The slice of a batch that this rank feeds (by default the process
    group's size and rank).  A remainder of global_batch % world_size is
    spread over the first ranks, so every element is covered."""
    if world_size is None or rank is None:
        world_size, rank = _world()
    per, rem = divmod(global_batch, world_size)
    start = rank * per + min(rank, rem)
    return slice(start, start + per + (1 if rank < rem else 0))


def scaling_report(pbs_per_sec_one_chip: float,
                   pbs_per_sec_mesh: float) -> dict:
    """Scaling efficiency record: the mesh's rate against one card's times
    the cards (one rank a card; hosts from torchrun's
    ``LOCAL_WORLD_SIZE``)."""
    n, _ = _world()
    ideal = pbs_per_sec_one_chip * n
    return {
        "devices": n,
        "hosts": n // int(os.environ.get("LOCAL_WORLD_SIZE", n)),
        "pbs_per_sec": pbs_per_sec_mesh,
        "scaling_efficiency": pbs_per_sec_mesh / ideal if ideal else 0.0,
    }


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """out (world, *inp.shape) <- every rank's `inp`, in rank order
    (``all_gather_single`` where this torch has it), gathered as ranks'
    blocks along the first axis, the form gloo and NCCL both take."""
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out.view((-1,) + tuple(inp.shape[1:])), inp, group=group)
