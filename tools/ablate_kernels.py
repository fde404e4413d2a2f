"""Ablations of kernels B, 3 and 9 on one GPU, by variant builds.

    python3 tools/ablate_kernels.py

Each variant is a committed kernel source (``csrc/external_product.cu`` and
``csrc/banded_mm.cu`` through their shared ``csrc/banded_wgmma.cuh``;
``csrc/banded_mm_latency.cu``; ``csrc/crt_external_product.cuh`` through
its two sources) built with some of its ``ABLATE_*``
switches defined (the lists below; the port's own build defines none), by
``nvcc`` with the port's flags into its own library, and launched through
the same C entry point at the main path's shape, beside the committed
kernel, in one process on one card:

- kernel B at the table step (B=1024, l=4, k+1=2, N=1024, A=1,
  S=keep=4, limb_offset 4);
- kernel 9's table form at the same step (``pallas`` mode: kernel A's
  planes in place, Cout=2, S=4, 4 output planes);
- kernel 9's latency form at the B=1 latency step (k+1=2, l=4, N=1024, 4
  kept key limbs, 1 digit limb: kernel 1's digits and a BSK step in place);
- kernel 3 at the MLP shape (B=256, N=4096, l=2, k+1=2, 3 primes).

A variant that computes the same function is held bit-exact against the
plain version; one that leaves work out ("no ...") is only timed: its
time is what the kernel costs without that work.  The committed kernel is
timed first and last, to show the card's drift.  Prints the card and one
line per variant; writes ``chiprun_out/ablate_kernels.json``.  Needs a
GPU and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from concrete_tpu_torch.ops import _build  # noqa: E402

XP_B = ("external_product.cu",)
XP_3 = ("crt_external_product.cu", "crt_external_product_wide.cu")
BM_T = ("banded_mm.cu",)
BM_L = ("banded_mm_latency.cu",)
VARIANTS_B = {
    "committed": [],
    "no swizzle (same function)": ["ABLATE_NO_SWIZZLE"],
    "128-j chunks (same function)": ["ABLATE_JC128"],
    "no fragment build": ["ABLATE_NO_FRAGMENTS"],
    "no digit staging": ["ABLATE_NO_STAGING"],
    "no fragment build, no digit staging": ["ABLATE_NO_FRAGMENTS",
                                            "ABLATE_NO_STAGING"],
}
VARIANTS_9T = {
    "committed": [],
    "no fragment build": ["ABLATE_NO_FRAGMENTS"],
    "no lhs staging": ["ABLATE_NO_STAGING"],
}
VARIANTS_9L = {
    "committed": [],
    "no DSMEM reduction (each block stores its own partials)":
        ["ABLATE_NO_DSMEM"],
    "no band staging (digit loads, negation, limb split)":
        ["ABLATE_NO_BAND_STAGING"],
    "no fragment build": ["ABLATE_NO_FRAGMENTS"],
    "no in-register band build (neither of the two)":
        ["ABLATE_NO_BAND_STAGING", "ABLATE_NO_FRAGMENTS"],
}
VARIANTS_3 = {
    "committed": [],
    "a stage's twiddle pairs gathered into registers first (same "
    "function)": ["ABLATE_TWIDDLE_GATHER"],
    "no key-spectrum loads": ["ABLATE_NO_KEY_LOADS"],
}


def build(tmp: str, sources: tuple, name: str, switches: list):
    """Start nvcc on `sources` with `switches` defined, into
    tmp/<name>.so; `load` waits for the returned process."""
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *[f"-D{d}" for d in switches],
         "-shared", "-o", os.path.join(tmp, f"{name}.so"),
         *[os.path.join(_build.CSRC, src) for src in sources]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(tmp: str, name: str, proc, entry: str):
    out, _ = proc.communicate()
    if proc.returncode:
        sys.exit(f"ablate_kernels: nvcc failed on {name}:\n{out}")
    fn = getattr(ctypes.CDLL(os.path.join(tmp, f"{name}.so")), entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    regs = [line.split("info    :")[-1].strip() for line in out.splitlines()
            if "registers" in line or "spill" in line]
    return fn, regs


def ablate(names, loaded, tmp, kernel, variants, entry, call, exact,
           iters):
    """Time every variant of `kernel` through `call(f)` (f its C entry
    point), the committed build first and last; `exact()` after a call
    says whether the output equals the plain version's."""
    results = []
    order = [f"{kernel}_{i}" for i in range(len(variants))] + [f"{kernel}_0"]
    for name in order:
        label, proc = names[name]
        if name not in loaded:
            loaded[name] = load(tmp, name, proc, entry)
        f, regs = loaded[name]
        _build.check(label, call(f))
        torch.cuda.synchronize()
        ok = bool(exact())
        ms = cs.cuda_ms(lambda: call(f), iters)
        results.append({"kernel": entry, "variant": label, "ms": ms,
                        "exact": ok, "ptxas": regs})
        print(f"kernel {kernel}, {label}: {ms:.4f} ms, bit-exact {ok}, "
              f"{regs}", flush=True)
    return results


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("ablate_kernels: no GPU")
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import external_product as xp
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.ops import ntt as tn
    card = cs.card()
    print(f"card: {card}", flush=True)
    tmp = tempfile.mkdtemp()
    names = {}
    for kernel, src, variants in (("B", XP_B, VARIANTS_B),
                                  ("9T", BM_T, VARIANTS_9T),
                                  ("9L", BM_L, VARIANTS_9L),
                                  ("3", XP_3, VARIANTS_3)):
        for i, (label, switches) in enumerate(variants.items()):
            name = f"{kernel}_{i}"
            names[name] = (label, build(tmp, src, name, switches))
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(cs.SEED)
    results = []

    # kernel B at the table step
    batch, levels, kp1, n, s_planes, keep, lo = 1024, 4, 2, 1024, 4, 4, 4
    planes = cs.rand_i8(rng, (levels, batch * kp1, n), "cuda")
    vv = cs.rand_i8(rng, (levels * kp1, kp1, s_planes, 2 * n - 1), "cuda")
    acc = cs.rand_torus(rng, (batch * kp1, n), "cuda")
    want = xp.external_product_accumulate_plain(planes, vv, acc.clone(),
                                                keep=keep, limb_offset=lo)
    order = [f"B_{i}" for i in range(len(VARIANTS_B))] + ["B_0"]
    loaded = {}
    for name in order:
        label, proc = names[name]
        if name not in loaded:
            loaded[name] = load(tmp, name, proc,
                                "external_product_accumulate")
        f, regs = loaded[name]

        def call(a, f=f):
            return f(planes.data_ptr(), vv.data_ptr(), a.data_ptr(), batch,
                     levels, 1, kp1, n, s_planes, keep, lo, stream)
        if name == "B_0" and not results:          # warm the card up
            scratch = acc.clone()
            for _ in range(2000):
                call(scratch)
        got = acc.clone()
        _build.check(label, call(got))
        torch.cuda.synchronize()
        scratch = acc.clone()
        ms = cs.cuda_ms(lambda: call(scratch), 50)
        results.append({"kernel": "external_product_accumulate",
                        "variant": label, "ms": ms,
                        "exact": bool(torch.equal(got, want)),
                        "ptxas": regs})
        print(f"kernel B, {label}: {ms:.4f} ms, bit-exact "
              f"{results[-1]['exact']}, {regs}", flush=True)

    # kernel 9's table form at the same step: kernel A's planes in place
    from concrete_tpu_torch.ops import banded_mm as bm
    out = torch.empty((batch, kp1, s_planes, n), dtype=torch.int32,
                      device="cuda")
    want = bm.banded_matmul_plain(planes, vv, levels=levels)

    def call_table(f):
        return f(planes.data_ptr(), vv.data_ptr(), out.data_ptr(), 1, batch,
                 levels * kp1, kp1, kp1, s_planes, n, stream)
    results += ablate(names, loaded, tmp, "9T", VARIANTS_9T, "banded_matmul",
                      call_table, lambda: torch.equal(out, want), 50)

    # kernel 9's latency form at the B=1 latency step
    s_key, base_log = 4, 5
    cin = levels * kp1
    digits = torch.from_numpy(rng.integers(-16, 17, (levels, kp1, n))
                              .astype(np.int32)).cuda()
    w_vv = cs.rand_i8(rng, (2, cin, kp1, s_key, 2 * n - 1), "cuda")[1]
    out_l = torch.empty((kp1, 1, s_key, n), dtype=torch.int32,
                        device="cuda")
    want_l = bm.banded_matmul_latency_plain(digits, w_vv, kp1=kp1,
                                            levels=levels, base_log=base_log)
    vlen = 2 * n - 1
    base = w_vv.data_ptr()

    def call_latency(f):
        return f(base + n - 1, base + w_vv.numel(), vlen, s_key * vlen, 0,
                 kp1 * s_key * vlen, digits.data_ptr(), None,
                 out_l.data_ptr(), s_key, kp1, cin, cin, 1, 1, n, stream)
    results += ablate(names, loaded, tmp, "9L", VARIANTS_9L,
                      "banded_matmul_latency", call_latency,
                      lambda: torch.equal(out_l, want_l), 500)

    # kernel 3 at the MLP shape
    primes = host.special_ntt_primes(4096, 128)[:3]
    batch, n, levels = 256, 4096, 2
    bsk = rng.integers(0, 1 << 64, (1, levels, kp1, kp1, n), dtype=np.uint64)
    fbsk = fn.pack_bsk_fused(bsk, cs.fused_params(n, levels, 8, 1),
                             primes=primes, trunc_bits=0, device="cuda")
    digits = torch.from_numpy(rng.integers(-128, 128, (levels, batch * kp1, n))
                              .astype(np.int32)).cuda()
    sv, ss = fbsk.spec_val[0], fbsk.spec_sh[0]
    want = fn.crt_external_product_plain(digits, sv, ss, primes, kp1)
    tw = fn.pair_tables(n, primes, digits.device)
    cst = tn.tables(n, primes, digits.device)[1]
    out = torch.empty_like(want)
    order = [f"3_{i}" for i in range(len(VARIANTS_3))] + ["3_0"]
    for name in order:
        label, proc = names[name]
        if name not in loaded:
            loaded[name] = load(tmp, name, proc, "crt_external_product")
        f, regs = loaded[name]

        def call(f=f):
            return f(digits.data_ptr(), sv.data_ptr(), ss.data_ptr(),
                     out.data_ptr(), tw.data_ptr(), cst.data_ptr(), batch,
                     levels, kp1, len(primes), n.bit_length() - 1, stream)
        _build.check(label, call())
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, want))
        ms = cs.cuda_ms(call, 50)
        results.append({"kernel": "crt_external_product", "variant": label,
                        "ms": ms, "exact": exact, "ptxas": regs})
        print(f"kernel 3, {label}: {ms:.4f} ms, bit-exact {exact}, {regs}",
              flush=True)
    shutil.rmtree(tmp)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ablate_kernels.json"),
              "w") as f:
        json.dump({"card": card, "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
