"""Device-time breakdown of one request of the PyTorch port on a GPU.

    python3 tools/profile_torch_request.py [table|mlp|table:MODE|latency ...]

For each named committed archive (default: ``table``):

- ``table``: ``concrete_tpu_torch/fixtures/table_sub_u4_b1024.zip``, 1024
  table lookups at 128-bit N=1024 parameters (banded blind rotate);
- ``mlp``: ``concrete_tpu_torch/fixtures/mlp_q2_b64.zip``, the benchmark
  QuantizedMLP over 64 samples, 256 lookups at 128-bit N=4096 parameters
  (CRT-NTT blind rotate);
- ``table:MODE``: the table archive with ``kernels.BANDED_MM_MODE`` set to
  MODE, one of the JAX package's banded modes (``auto``,
  ``fusedrecombine``, ``pallas``, ``fuseddot``, ``planes``), e.g.
  ``table:pallas`` for kernels A, 9 and the standalone recombine;
- ``latency``: one single-ciphertext ``pbs_batch`` (B=1, the latency
  blind rotate: one launch of the persistent kernel
  ``blind_rotate_latency`` for every step; before it, kernel 1, kernel
  9's latency form and the recombine per step) at
  ``BENCH_PARAMS_4BIT_TPUOPT`` with its key truncation, the JAX package's
  ``pbs_latency_b1`` configuration, keys from a seed (it only calls
  functions the port has had since its latency path came, so the tool
  times an older checkout of the port too, copied into it);

loads it on CUDA, generates keys from a fixed seed, runs one request (which
packs the keys), one untraced request, then one request under
``torch.profiler`` (CPU and CUDA activities).  Prints the card, the
requests' wall times, the summed device time of the traced request, the
device's idle share of its wall time, the kernels the device ran and the
launch calls the host made in it, and the device time by kernel name;
writes the same as JSON into the repo's git-ignored output directory, as
``torch_request_profile.json`` (``table``),
``torch_request_profile_mlp.json`` (``mlp``),
``torch_request_profile_table_MODE.json`` (``table:MODE``) or
``torch_request_profile_latency.json`` (``latency``; the lookup is run
three times untraced, and each wall is kept).
Needs a GPU; exits non-zero without one.
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

FIXTURES = os.path.join(REPO, "concrete_tpu_torch", "fixtures")
ARCHIVES = {
    # name: (archive, output file, clear inputs for one request)
    "table": ("table_sub_u4_b1024.zip", "torch_request_profile.json",
              lambda rng, specs: [rng.integers(0, 16, s.shape)
                                  for s in specs.inputs]),
    "mlp": ("mlp_q2_b64.zip", "torch_request_profile_mlp.json",
            lambda rng, specs: [rng.integers(0, 4, s.shape)
                                for s in specs.inputs]),
}


def profile(name: str, card: str) -> dict:
    """Trace one request of archive `name`, of ``table:MODE`` in the
    banded mode MODE, or one ``latency`` lookup."""
    from concrete_tpu_torch.core import kernels
    if name == "latency":
        return _profile_latency(card)
    name, _, mode = name.partition(":")
    archive, out_name, make_inputs = ARCHIVES[name]
    if mode:
        out_name = f"torch_request_profile_{name}_{mode}.json"
    kernels.BANDED_MM_MODE = mode or "auto"
    try:
        return _profile(archive, out_name, make_inputs, card, mode)
    finally:
        kernels.BANDED_MM_MODE = "auto"


def _profile(archive: str, out_name: str, make_inputs, card: str,
             mode: str) -> dict:
    server = tfhe.Server.load(os.path.join(FIXTURES, archive))
    client = tfhe.Client(server.client_specs)
    client.keygen(seed=1)
    ev = client.evaluation_keys
    rng = np.random.default_rng(1)
    args = client.encrypt(*make_inputs(rng, server.client_specs))
    args = args if isinstance(args, tuple) else (args,)
    lookups = sum(int(np.prod(node.output.shape))
                  for node in server.graph.topological_order()
                  if node.name in ("tlu", "univariate"))
    out = _measure(lambda: server.run(*args, evaluation_keys=ev), 1,
                   {"card": card, "archive": archive,
                    "banded_mode": mode or "auto", "lookups": lookups})
    print(f"{archive} ({out['banded_mode']} banded mode): {lookups} "
          f"lookups; request: first {out['first_request_s']:.3f} s "
          f"(with key packing), untraced {out['untraced_request_s']:.3f} s, "
          f"traced {out['traced_request_s']:.3f} s; device busy "
          f"{out['device_ms']:.1f} ms, idle share {out['idle_share']:.4f}")
    return _report(out, out_name)


def _profile_latency(card: str) -> dict:
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import refimpl as ref
    params = pp.BENCH_PARAMS_4BIT_TPUOPT
    rng = np.random.default_rng(1)
    sk, server_keys = kg.keygen_device(rng, params, "cuda")
    trunc = pp.choose_truncate_limbs(params, 4)
    ksk = kn.pack_ksk(server_keys.ksk, params, device="cuda")
    bsk = kn.pack_bsk(server_keys.bsk, params, trunc, device="cuda")
    table = np.array([(3 * v + 1) % 16 for v in range(16)], dtype=np.uint64)
    lut = torch.from_numpy(ref.encode_expand_lut(
        table, params.polynomial_size, 4).view(np.int64)).cuda()
    msg = rng.integers(0, 16, 1)
    ct = torch.from_numpy(kg.encrypt_lwe_batch(
        rng, sk.lwe_big, ref.encode(msg, 4), params.glwe_std)
        .view(np.int64)).cuda()
    got = []

    def lookup():
        got.append(kn.pbs_batch(ct, ksk, bsk, lut, params, 4))
        torch.cuda.synchronize()
    out = _measure(lookup, 3, {"card": card, "params":
                               "BENCH_PARAMS_4BIT_TPUOPT", "batch": 1,
                               "truncate_limbs": trunc, "lookups": 1})
    dec = ref.decode(ref.lwe_decrypt(
        sk.lwe_big, got[-1].cpu().numpy().view(np.uint64)), 4)
    out["right"] = bool(dec[0] == table[msg[0]])
    print(f"latency lookup (B=1, BENCH_PARAMS_4BIT_TPUOPT, truncation "
          f"{trunc}): first {out['first_request_s'] * 1e3:.1f} ms, untraced "
          f"{[round(w * 1e3, 1) for w in out['untraced_walls_s']]} ms, "
          f"traced {out['traced_request_s'] * 1e3:.1f} ms; device busy "
          f"{out['device_ms']:.2f} ms, idle share {out['idle_share']:.4f}, "
          f"kernels run {out['kernels_run']}, launch calls "
          f"{out['launch_calls']}, decrypted right {out['right']}")
    return _report(out, "torch_request_profile_latency.json")


def _measure(run, untraced: int, out: dict) -> dict:
    """`run` once (packs keys, builds), `untraced` times, then once under
    torch.profiler: walls, the device's busy ms and idle share, and the
    device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace
    t0 = time.perf_counter()
    run()
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(untraced):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced_s = time.perf_counter() - t0
    # device-side rows only (kernels, memcpys): the CPU-side aten rows
    # repeat the device time of the kernels they launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    kernels = sum(c for k, c, _ in rows
                  if not k.startswith(("Memcpy", "Memset")))
    launch_calls = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith("cudaLaunch"))
    out.update(first_request_s=first_s, untraced_request_s=walls[-1],
               untraced_walls_s=walls, traced_request_s=traced_s,
               device_ms=device_ms, idle_share=1 - device_ms / 1e3 / traced_s,
               kernels_run=kernels, launch_calls=launch_calls,
               by_kernel=[{"name": k, "launches": c, "device_ms": ms}
                          for k, c, ms in rows])
    return out


def _report(out: dict, out_name: str) -> dict:
    for row in out["by_kernel"][:12]:
        print(f"  {row['device_ms']:10.3f} ms  {row['launches']:6d}x  "
              f"{row['name'][:90]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", out_name), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(names: list[str]) -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_torch_request: no GPU")
    from concrete_tpu_torch.core.kernels import BANDED_MM_MODES

    def known(name: str) -> bool:
        archive, colon, mode = name.partition(":")
        return name == "latency" or archive in ARCHIVES and (
            not colon or (archive == "table" and mode in BANDED_MM_MODES))

    unknown = [n for n in names if not known(n)]
    if unknown:
        sys.exit(f"profile_torch_request: unknown argument(s) {unknown}; "
                 f"choose from {sorted(ARCHIVES)}, latency, or table:MODE "
                 f"with MODE in {BANDED_MM_MODES}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for name in names:
        profile(name, card)


if __name__ == "__main__":
    main(sys.argv[1:] or ["table"])
