"""Ranks of the port's distributed tests: processes of a gloo group on the CPU.

The tests (``tests/test_torch_parallel.py``, ``tests/test_torch_limb_sharding.py``)
call ``spawn``: it writes the inputs, made in the test process (where the
JAX package computes the reference), to ``DIR/inputs.npz`` and starts one
process per rank,

    python tests/torch_ranks.py TASK RANK WORLD DIR

each of which imports only the port (never jax), joins the group through
a file store in DIR (no port, so parallel test workers never collide),
runs TASK and writes its arrays to ``DIR/out_RANK.npz``.  One spawn per
world size runs all of a file's checks.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(task: str, world: int, directory, inputs: dict,
          timeout: float = 240) -> list[dict]:
    """Run `task` on `world` ranks over `inputs`; each rank's outputs."""
    directory = str(directory)
    np.savez(os.path.join(directory, "inputs.npz"), **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    logs = [open(os.path.join(directory, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         directory], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
        for log in logs:
            log.close()
    if any(codes):
        text = "".join(open(os.path.join(directory, f"rank{r}.log")).read()
                       for r in range(world))
        raise AssertionError(f"{task} at world {world}: exit codes {codes}"
                             f"\n{text[-6000:]}")
    return [dict(np.load(os.path.join(directory, f"out_{r}.npz")))
            for r in range(world)]


def _t(a):
    import torch
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int64) if a.dtype == np.uint64
                                     else a))


def _u64(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64).view(np.uint64)


def _same_key(a, b) -> bool:
    """Two key dataclasses with equal fields, tensors bit for bit."""
    import dataclasses
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y):
            return False
    return True


def batch_task(inp: dict) -> dict:
    """Batch sharding: rank 0 packs the keys, ``replicate_keys`` broadcasts
    them, every rank runs ``sharded_pbs_fn`` on its shard and ``gather``
    assembles the batch; then a compiled circuit's run on the shards."""
    import torch.distributed as dist
    import concrete_tpu_torch as fhe
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.parallel import (make_mesh, replicate_keys,
                                             shard_ciphertexts,
                                             sharded_pbs_fn)
    from concrete_tpu_torch.parallel.sharding import gather
    from concrete_tpu_torch.params import TEST_PARAMS_TINY as P
    mesh = make_mesh()
    ksk = bsk = None
    if dist.get_rank() == 0:
        ksk = kn.pack_ksk(inp["ksk"], P, device="cpu")
        bsk = kn.pack_bsk(inp["bsk"], P, int(inp["truncate"]), device="cpu")
    ksk, bsk = replicate_keys(mesh, ksk, bsk)
    same = [_same_key(ksk, kn.pack_ksk(inp["ksk"], P, device="cpu")),
            _same_key(bsk, kn.pack_bsk(inp["bsk"], P, int(inp["truncate"]),
                                       device="cpu"))]
    ct = shard_ciphertexts(mesh, _t(inp["ct"]))
    fn = sharded_pbs_fn(mesh, P, int(inp["bits"]))
    out = gather(mesh, fn(ct, ksk, bsk, _t(inp["lut_poly"])))

    table = fhe.LookupTable([int(v) for v in inp["table"]])

    @fhe.compiler({"x": "encrypted"})
    def f(x):
        return table[x] + 1

    circuit = f.compile(list(inp["inputset"]),
                        fhe.Configuration(forced_parameters=P), device="cpu")
    circuit.keygen(seed=int(inp["seed"]))
    enc = shard_ciphertexts(mesh, inp["circuit_ct"])
    run = gather(mesh, circuit.run(enc))
    return {"pbs": _u64(out), "shard_rows": np.array(ct.shape[0]),
            "keys_equal": np.array(all(same)), "circuit": run,
            "circuit_shard_rows": np.array(enc.shape[0])}


def limb_task(inp: dict) -> dict:
    """Limb sharding over the whole group: the external product, the blind
    rotate and the full PBS, and this rank's spectrum shard."""
    import torch.distributed as dist
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import ntt_fourstep as nt
    from concrete_tpu_torch.parallel import limb_sharding as ls
    from concrete_tpu_torch.parallel import replicate_keys
    from concrete_tpu_torch.params import TEST_PARAMS_TINY as P
    mesh = ls.make_limb_mesh()
    world, rank = mesh.size(), mesh.get_local_rank()
    primes = nt.choose_primes(P)
    ext_key = nt.pack_bsk_ntt(inp["ext_bsk"], P, primes=primes,
                              device="cpu")
    ext = ls.external_product_limb_sharded(
        mesh, _t(inp["digits"]), ext_key.spectra[:, 1], P, primes)
    ksk = bsk = None
    if dist.get_rank() == 0:
        ksk = kn.pack_ksk(inp["ksk"], P, device="cpu")
        bsk = nt.pack_bsk_ntt(inp["bsk"], P, device="cpu")
    ksk, bsk = replicate_keys(mesh, ksk, bsk, axis_name=ls.LIMB_AXIS)
    lut = _t(inp["lut_poly"])
    acc = ls.blind_rotate_limb_sharded(mesh, _t(inp["ct_small"]), bsk, lut,
                                       P)
    pbs = ls.pbs_batch_limb_sharded(mesh, _t(inp["ct_big"]), ksk, bsk, lut,
                                    P, int(inp["bits"]))
    n1 = nt.build_plan(P.polynomial_size, primes[0], device="cpu").n1
    shard = ls.spectrum_shard(bsk.spectra, n1, world, rank)
    return {"ext": _u64(ext), "acc": _u64(acc), "pbs": _u64(pbs),
            "shard": shard.numpy(),
            "shardable": np.array([ls.check_limb_shardable(P, d)
                                   for d in (1, 2, 4, 8, 16)])}


TASKS = {"batch": batch_task, "limb": limb_task}


def main() -> None:
    task, rank, world, directory = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from concrete_tpu_torch.parallel import distributed
    distributed.initialize(f"file://{os.path.join(directory, 'store')}",
                           world_size=world, rank=rank, device="cpu")
    inp = dict(np.load(os.path.join(directory, "inputs.npz")))
    out = TASKS[task](inp)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                             "concrete_tpu")]
    if leaked:
        raise SystemExit(f"rank {rank} imported {leaked[:5]}")
    np.savez(os.path.join(directory, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
