"""Device-time breakdown of one request of the PyTorch port on a GPU.

    python3 tools/profile_torch_request.py

Loads the committed archive ``concrete_tpu_torch/fixtures/
table_sub_u4_b1024.zip`` (1024 table lookups at 128-bit parameters) on
CUDA, generates keys from a fixed seed, runs one untraced request, then one
request under ``torch.profiler`` (CPU and CUDA activities).  Prints the
card, both requests' wall times, the summed device time of the traced
request, the device's idle share of its wall time, and the device time by
kernel name; writes the same as JSON to ``chiprun_out/torch_request_profile
.json``.  Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import concrete_tpu_torch as tfhe  # noqa: E402

FIXTURE = os.path.join(REPO, "concrete_tpu_torch", "fixtures",
                       "table_sub_u4_b1024.zip")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_torch_request: no GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    server = tfhe.Server.load(FIXTURE)
    client = tfhe.Client(server.client_specs)
    client.keygen(seed=1)
    ev = client.evaluation_keys
    rng = np.random.default_rng(1)
    size = server.client_specs.inputs[0].shape[0]
    args = client.encrypt(rng.integers(0, 16, size), rng.integers(0, 16, size))
    t0 = time.perf_counter()
    server.run(*args, evaluation_keys=ev)         # packs keys, builds
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.run(*args, evaluation_keys=ev)
    untraced_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run(*args, evaluation_keys=ev)
        traced_s = time.perf_counter() - t0
    # device-side rows only (kernels, memcpys): the CPU-side aten rows
    # repeat the device time of the kernels they launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    out = {"card": card, "lookups": size, "first_request_s": first_s,
           "untraced_request_s": untraced_s, "traced_request_s": traced_s,
           "device_ms": device_ms,
           "idle_share": 1 - device_ms / 1e3 / traced_s,
           "by_kernel": [{"name": k, "launches": c, "device_ms": ms}
                         for k, c, ms in rows]}
    print(f"card: {card}")
    print(f"request: first {first_s:.3f} s (with key packing), untraced "
          f"{untraced_s:.3f} s, traced {traced_s:.3f} s; device busy "
          f"{device_ms:.1f} ms, idle share {out['idle_share']:.4f}")
    for k, c, ms in rows[:12]:
        print(f"  {ms:10.3f} ms  {c:6d}x  {k[:90]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out",
                           "torch_request_profile.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
