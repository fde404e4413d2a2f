"""A cell on several cards: one process a card, as torch runs them.

This process is rank 0: it starts ranks 1..world-1 as processes of
``run.py`` (``--rank``), their logs under the temporary directory, and
joins them in a process group at ``tcp://localhost:<free port>`` through
the program's ``parallel.distributed.initialize`` (NCCL on the cards).

Every rank compiles the circuit; rank 0 makes the keys from the seed,
packs them for its card, and ``parallel.sharding.replicate_keys``
broadcasts them into every card.  Rank 0 encrypts the request pool; each
rank keeps its shard of every request (``shard_ciphertexts``).  A request
is ``Server.run`` on each rank's shard, host arrays in and out, then
``sharding.gather`` of the outputs; rank 0 decides, before each request,
whether the window goes on and whether the request is traced, and the
others follow.  After the window, each rank's trace summary and memory
peak come to rank 0, which judges the gathered outputs.

A watchdog ends the run when a rank fails: a rank that dies leaves the
others waiting in a collective.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from perfbench import harness

RUN_PY = os.path.join(harness.HERE, "run.py")
#: how rank 0 starts the other ranks (the tests start them with a fault)
RANK_COMMAND = [sys.executable, RUN_PY]
JOIN_SECONDS = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cell, seed: int, seconds: float, trace: bool, port: int,
          rehearse: dict, log_dir: str, control: bool = False) -> list:
    """Ranks 1..world-1 of the cell, each a process of ``run.py``."""
    procs = []
    for r in range(1, cell.chips):
        args = RANK_COMMAND + [
            "--workload", cell.name, "--seed", str(seed),
            "--seconds", str(seconds), "--trace", str(int(trace)),
            "--rank", str(r), "--port", str(port)]
        if rehearse:
            args += ["--rehearse", json.dumps(rehearse)]
        if control:
            args += ["--control", "1"]
        log = open(os.path.join(log_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            args, env={**os.environ, "LOCAL_RANK": str(r),
                       "LOCAL_WORLD_SIZE": str(cell.chips)},
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def watch(procs: list, log_dir: str, done: threading.Event) -> None:
    """End this process when a rank exits with a failure before the run is
    done, after printing the end of its log."""
    while not done.is_set():
        for r, (p, _) in enumerate(procs, start=1):
            code = p.poll()
            if code:
                with open(os.path.join(log_dir, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                print(f"rank {r} exited with {code}:\n{tail}",
                      file=sys.stderr, flush=True)
                for q, _ in procs:
                    q.kill()
                os._exit(1)
        time.sleep(0.2)


def run_rank0(cell, seed: int, seconds: float, trace: bool, t_start: float,
              rehearse: dict = None, detail: dict = None,
              control: bool = False) -> dict:
    port = free_port()
    log_dir = tempfile.mkdtemp(prefix="perfbench-ranks-")
    procs = spawn(cell, seed, seconds, trace, port, rehearse, log_dir,
                  control)
    done = threading.Event()
    threading.Thread(target=watch, args=(procs, log_dir, done),
                     daemon=True).start()
    try:
        result = run_rank(cell, 0, seed, seconds, trace, port, t_start,
                          rehearse, detail, control)
        done.set()
        codes = []
        for p, log in procs:
            codes.append(p.wait(timeout=JOIN_SECONDS))
            log.close()
        if any(codes):
            raise RuntimeError(f"ranks exited with {codes}; logs in "
                               f"{log_dir}")
        if detail is not None:
            detail["rank_logs"] = log_dir
        return result
    finally:
        done.set()
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def run_rank(cell, rank: int, seed: int, seconds: float, trace: bool,
             port: int, t_start: float, rehearse: dict = None,
             detail: dict = None, control: bool = False):
    """One rank of a run; rank 0 returns the result line's object.  In a
    control run rank 0 packs ``harness.control_key``'s key, and every rank
    serves on it."""
    import torch
    import torch.distributed as dist
    from concrete_tpu_torch.parallel import distributed as pd
    from concrete_tpu_torch.parallel import sharding as ps
    rehearse = rehearse or {}
    detail = {} if detail is None else detail
    overrides = harness.rehearsal_overrides(rehearse)
    cpu = bool(rehearse)
    world = cell.chips
    pd.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank,
                  device="cpu" if cpu else None)
    device = pd.device_for_rank("cpu" if cpu else None, rank)
    mesh = ps.make_mesh()
    spans = {"join_s": time.perf_counter() - t_start}
    shape = tuple(overrides.get("shape", cell.shape))
    harness.start_program(device, spans)
    circuit = harness.compile_circuit(cell, device, spans, shape, overrides)
    keyset = harness.keyset_of(circuit.client_specs.params)
    lookups = int(circuit.programmable_bootstrap_count)
    ksk = bsk = None
    if rank == 0:
        ksk, bsk = harness.make_keys(circuit, seed, spans, detail)[:2]
        if control:
            bsk, detail["control"] = harness.control_key(circuit, bsk)
    t0 = time.perf_counter()
    ksk, bsk = ps.replicate_keys(mesh, ksk, bsk)
    harness.synchronize(device)
    spans["replicate_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    clear = None
    pool_size = int(cell.traffic["pool"])
    n_inputs = len(circuit.client_specs.inputs)
    width = keyset["glwe_dimension"] * keyset["polynomial_size"] + 1
    if rank == 0:
        clear = harness.draw_pool(cell, seed, pool_size, shape)
        enc = harness.encrypt_pool(circuit, clear)
    shards = []
    for i in range(pool_size):
        req = []
        for j in range(n_inputs):
            t = torch.from_numpy(enc[i][j].view(np.int64)).to(device) \
                if rank == 0 else torch.empty(shape + (width,),
                                              dtype=torch.int64,
                                              device=device)
            dist.broadcast(t, src=0)
            host = t.cpu().numpy().view(np.uint64)
            req.append(np.ascontiguousarray(ps.shard_ciphertexts(mesh, host)))
        shards.append(tuple(req))
    if rank == 0:
        del enc
    spans["pool_s"] = time.perf_counter() - t0

    gather_s = []
    local_shape = shards[0][0].shape

    def serve(i):
        error = None
        try:
            out = circuit.server.run(*shards[i % pool_size],
                                     evaluation_keys=(ksk, bsk))[0]
        except Exception as exc:      # keep the ranks' collectives in step
            error = exc
            out = np.zeros(local_shape, dtype=np.uint64)
        tg = time.perf_counter()
        full = ps.gather(mesh, out)
        gather_s.append(time.perf_counter() - tg)
        if error is not None:
            raise error
        return full if rank == 0 else None

    def decide(go: bool, traced: bool):
        flags = torch.tensor([int(go), int(traced)], dtype=torch.int64,
                             device=device)
        dist.broadcast(flags, src=0)
        go, traced = flags.tolist()
        return bool(go), bool(traced)

    check = cell.output_check(keyset, shape) if rank == 0 \
        else (lambda out: True)
    t0 = time.perf_counter()
    for i in range(int(cell.traffic["warmup"])):
        serve(i)
    if trace:
        from perfbench import trace as tr
        tr.stop(tr.start(not cpu))
    harness.synchronize(device)
    dist.barrier()
    spans["warmup_s"] = time.perf_counter() - t0
    gather_s.clear()
    setup_s = time.perf_counter() - t_start
    plan = None
    if trace:
        t = cell.traffic["trace"]
        plan = (t["after"], t["seconds"], t["least_requests"])
    window = harness.Window(serve, check, seconds, plan, not cpu, decide)
    window.run()
    peak = 0 if cpu else torch.cuda.max_memory_allocated(device)
    rows = local_shape[:-1]
    mine = {"rank": rank, "peak": int(peak),
            "forbidden": harness.forbidden_modules(),
            "trace": harness.rank_trace(
                window.raw, lookups * int(np.prod(rows)) // int(
                    np.prod(shape)), cell.build.blind_rotates(rows),
                keyset) if trace else None}
    del serve, shards, circuit, ksk, bsk
    if not cpu:
        torch.cuda.empty_cache()
    everyone = [None] * world
    dist.all_gather_object(everyone, mine)
    dist.destroy_process_group()
    if rank != 0:
        return None
    forbidden = sorted({m for r in everyone for m in r["forbidden"]})
    ranks = [r["trace"] for r in everyone] if trace else []
    t0 = time.perf_counter()
    verdict = harness.judge(cell, seed, clear, window, lookups,
                            keyset if rehearse else None)
    detail.update(spans=spans, setup_s=setup_s, world=world,
                  judge_s=time.perf_counter() - t0,
                  window_s=window.window_s, errors=window.errors,
                  lookups_per_request=lookups, pool=pool_size,
                  requests=len(window.latencies), forbidden=forbidden,
                  peaks=[r["peak"] for r in everyone],
                  first_cycle_ms=harness.pool_cycle_ms(window, pool_size))
    records = {"spec_metrics": [], "setup": spans, "ranks": ranks,
               "gather_s": gather_s,
               "window": harness.window_records(window, lookups, setup_s)}
    return harness.finish(cell, trace, not cpu, records, window, verdict,
                          max(r["peak"] for r in everyone), ranks, detail)
