#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (concrete_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``concrete_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time and the card's name and power limit;
2. holds each kernel bit-exact against its plain PyTorch version on the
   card, at the shapes the 128-bit N=1024 server path gives it (and at
   limb_offset 0 / keep 8, and with two digit limbs at a small shape),
   and times kernel, plain version and, for the external product, the
   ``torch._int_mm`` of the same product against a pre-built Toeplitz
   matrix (a yardstick the port never calls);
3. serves the committed deployment archive (``table[x] - y`` over 1024
   encrypted 4-bit pairs, 128-bit parameters, N=1024): ``Server.load`` on
   CUDA, ``Client.keygen`` from a seed, three requests, decryptions checked
   against the plaintext, with every blind-rotate step counted through both
   kernels;
4. prints one JSON line per the kernels run, then the result line.

Any failed phase exits non-zero before the result line.  Without CUDA, or
next to no checkout of the port, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "concrete_tpu_torch", "fixtures",
                       "table_sub_u4_b1024.zip")
OUT_DIR = os.path.join(HERE, "chiprun_out")
SEED = 20261016
REQUESTS = 3
TABLE = [(3 * v + 1) % 16 for v in range(16)]
# H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 tensor-core ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1.979e15
# about 0.1 s of spinning at the H100's clock: longer than the host takes
# to queue any timed run of launches below
SPIN_CYCLES = 200_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` back-to-back calls, by CUDA
    events, after a warm-up.  A spin kernel ahead of the first event holds
    the card while the host queues every call, so a kernel that costs the
    host more to launch than the card to run is timed on the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rand_torus(rng, shape, device):
    import numpy as np
    import torch
    u = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    return torch.from_numpy(u.view(np.int64)).to(device)


def rand_i8(rng, shape, device, bound=128):
    import numpy as np
    import torch
    return torch.from_numpy(rng.integers(-bound, bound, shape)
                            .astype(np.int8)).to(device)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def check_rotate_decompose(rng, *, rows, n, base_log, levels, a_limbs,
                           timed):
    import numpy as np
    import torch
    from concrete_tpu_torch.ops import step
    dev = "cuda"
    acc = rand_torus(rng, (rows, n), dev)
    a_rows = torch.from_numpy(rng.integers(0, 2 * n, rows)
                              .astype(np.int32)).to(dev)
    kw = dict(base_log=base_log, levels=levels, a_limbs=a_limbs)
    got = step.rotate_decompose(acc, a_rows, **kw)
    want = step.rotate_decompose_plain(acc, a_rows, **kw)
    torch.cuda.synchronize()
    shape = f"rows={rows} N={n} base_log={base_log} l={levels} A={a_limbs}"
    if not torch.equal(got, want):
        fail(f"rotate_decompose differs from its plain version at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        rec["ms"] = cuda_ms(lambda: step.rotate_decompose(acc, a_rows, **kw),
                            50)
        rec["plain_ms"] = cuda_ms(
            lambda: step.rotate_decompose_plain(acc, a_rows, **kw), 5)
        nbytes = rows * n * 8 + rows * 4 + levels * a_limbs * rows * n
        rec.update(bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   library_ms=None, bytes=nbytes)
    print(f"rotate_decompose bit-exact at {shape}: {rec}", flush=True)
    return rec


def check_external_product(rng, *, batch, levels, kp1, n, a_limbs,
                           s_planes, keep, limb_offset, timed):
    import torch
    from concrete_tpu_torch.ops import external_product as xp
    dev = "cuda"
    cin = levels * kp1
    planes = rand_i8(rng, (levels * a_limbs, batch * kp1, n), dev)
    vv = rand_i8(rng, (cin, kp1, s_planes, 2 * n - 1), dev)
    acc = rand_torus(rng, (batch * kp1, n), dev)
    kw = dict(keep=keep, limb_offset=limb_offset)
    got = xp.external_product_accumulate(planes, vv, acc.clone(), **kw)
    want = xp.external_product_accumulate_plain(planes, vv, acc.clone(), **kw)
    torch.cuda.synchronize()
    shape = (f"B={batch} l={levels} k+1={kp1} N={n} A={a_limbs} "
             f"S={s_planes} keep={keep} limb_offset={limb_offset}")
    if not torch.equal(got, want):
        fail(f"external_product_accumulate differs from its plain version "
             f"at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        scratch = acc.clone()
        rec["ms"] = cuda_ms(lambda: xp.external_product_accumulate(
            planes, vv, scratch, **kw), 10)
        rec["plain_ms"] = cuda_ms(lambda: xp.external_product_accumulate_plain(
            planes, vv, scratch, **kw), 3)
        lhs = xp.digit_lhs(planes, kp1, levels).contiguous()
        rhs = xp.toeplitz_rhs(vv, a_limbs, keep).contiguous()
        rec["library_ms"] = cuda_ms(lambda: torch._int_mm(lhs, rhs), 10)
        pairs = sum(1 for a in range(a_limbs) for p in range(keep)
                    if 0 <= p - a < s_planes)
        macs = batch * cin * kp1 * n * n * pairs
        nbytes = planes.numel() + vv.numel() + 2 * acc.numel() * 8
        t_ops, t_bytes = 2 * macs / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        rec.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   macs=macs, bytes=nbytes)
    print(f"external_product_accumulate bit-exact at {shape}: {rec}",
          flush=True)
    return rec


def serve(rng):
    """The port's main path: three requests of 1024 table lookups, on the
    device Server.load picks by default (CUDA)."""
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    server = tfhe.Server.load(FIXTURE)
    if server.device.type != "cuda":
        fail(f"Server.load defaulted to {server.device}")
    specs = server.client_specs
    p = specs.params
    print(f"archive: {os.path.basename(FIXTURE)} params={p} "
          f"message_bits={specs.message_bits}", flush=True)
    client = tfhe.Client(specs)
    t0 = time.perf_counter()
    client.keygen(seed=SEED)
    keygen_s = time.perf_counter() - t0
    ev = client.evaluation_keys
    t0 = time.perf_counter()
    ksk, bsk = ev.packed(specs.message_bits, norm2=server.graph.max_norm2(),
                         device=server.device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    print(f"keygen {keygen_s:.2f} s, pack+upload {pack_s:.2f} s, "
          f"BSK limb truncation {bsk.truncate_limbs}", flush=True)
    size = specs.inputs[0].shape[0]
    requests = [(rng.integers(0, 16, size), rng.integers(0, 16, size))
                for _ in range(REQUESTS)]
    encrypted = [client.encrypt(x, y) for x, y in requests]
    wrong, walls, per_request = 0, [], []
    _build.reset_launches()               # the main path's run starts here
    for (x, y), (cx, cy) in zip(requests, encrypted):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        (out,) = server.run(cx, cy, evaluation_keys=ev)
        walls.append(time.perf_counter() - t0)
        per_request.append({k: v - before.get(k, 0)
                            for k, v in _build.LAUNCHES.items()})
        if out.shape != (size, p.n_big + 1) or out.dtype != np.uint64:
            fail(f"output ciphertexts {out.shape} {out.dtype}")
        got = client.decrypt(out)
        wrong += int(np.count_nonzero(got != np.array(TABLE)[x] - y))
    launches = dict(_build.LAUNCHES)       # ... and ends here
    total = REQUESTS * size
    for i, (wall, counts) in enumerate(zip(walls, per_request)):
        print(f"request {i}: {size} lookups in {wall:.3f} s = "
              f"{size / wall:.1f} PBS/s, launches {counts}", flush=True)
        for name in ("rotate_decompose", "external_product_accumulate"):
            if counts.get(name) != p.n_small:
                fail(f"request {i} launched {name} {counts.get(name)} "
                     f"times, want one per blind-rotate step ({p.n_small})")
    allowed = max(2, 1e-3 * total)
    print(f"decryptions wrong: {wrong} of {total} (allowed {allowed})",
          flush=True)
    if wrong > allowed:
        fail(f"{wrong} wrong decryptions of {total}")
    return {"walls_s": walls, "pbs_per_s": [size / w for w in walls],
            "wrong": wrong, "lookups": total, "keygen_s": keygen_s,
            "pack_s": pack_s, "n_small": p.n_small, "launches": launches,
            "truncate_limbs": bsk.truncate_limbs}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    try:
        import concrete_tpu_torch
        from concrete_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if not os.path.abspath(concrete_tpu_torch.__file__).startswith(HERE):
        fail("concrete_tpu_torch was not found next to this script")
    import numpy as np

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s, "
          f"{[os.path.basename(s) for s in _build.BUILD_INFO['sources']]}",
          flush=True)
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    card_line = card()
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    rng = np.random.default_rng(SEED)
    # slice shapes: 1024 ciphertexts x (k+1)=2 rows, N=1024, l=4, base 2^5
    rec_a = check_rotate_decompose(rng, rows=2048, n=1024, base_log=5,
                                   levels=4, a_limbs=1, timed=True)
    check_rotate_decompose(rng, rows=64, n=256, base_log=12, levels=2,
                           a_limbs=2, timed=False)
    # two digit limbs, three levels, a small batch: the CRT-like shapes at
    # which the TPU's acc32 kernels failed
    check_rotate_decompose(rng, rows=6, n=512, base_log=10, levels=3,
                           a_limbs=2, timed=False)
    rec_b = check_external_product(rng, batch=1024, levels=4, kp1=2, n=1024,
                                   a_limbs=1, s_planes=4, keep=4,
                                   limb_offset=4, timed=True)
    check_external_product(rng, batch=1024, levels=4, kp1=2, n=1024,
                           a_limbs=1, s_planes=8, keep=8, limb_offset=0,
                           timed=False)
    check_external_product(rng, batch=16, levels=2, kp1=2, n=256, a_limbs=2,
                           s_planes=8, keep=8, limb_offset=0, timed=False)
    check_external_product(rng, batch=3, levels=3, kp1=2, n=512, a_limbs=2,
                           s_planes=4, keep=4, limb_offset=4, timed=False)

    # the serve phase runs n_small steps of both kernels per request
    est_s = REQUESTS * 698 * (rec_a["ms"] + rec_b["ms"]) / 1e3
    print(f"serve estimate from the kernel times: {est_s:.1f} s", flush=True)
    if est_s > 700:
        fail(f"the kernels are too slow to serve {REQUESTS} requests within "
             f"the smoke's time limit (estimate {est_s:.0f} s)")
    run = serve(rng)

    kernels = [
        {"name": "rotate_decompose", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/rotate_decompose.cu",
         "replaces": "concrete_tpu/ops/pallas_step.py:173 "
                     "(and :275, rotate_decompose_limbs_hi)",
         "launches": run["launches"].get("rotate_decompose", 0),
         **{k: rec_a[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}},
        {"name": "external_product_accumulate", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/external_product.cu",
         "replaces": "concrete_tpu/ops/pallas_dot_recombine.py:288 "
                     "(and :203 dot_recombine_hi, pallas_step.py:385 "
                     "recombine_accumulate)",
         "launches": run["launches"].get("external_product_accumulate", 0),
         **{k: rec_b[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}},
    ]
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "concrete_tpu" or m.startswith("concrete_tpu.")]
    if leaked:
        fail(f"the port imported {leaked}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card_line, "kernels": kernels, "serve": run,
                   "detail": {"rotate_decompose": rec_a,
                              "external_product_accumulate": rec_b},
                   "build_s": _build.BUILD_INFO["seconds"]}, f, indent=1)
    print(f"card: {card()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
