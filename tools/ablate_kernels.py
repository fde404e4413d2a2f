"""Ablations of kernels B, 2, 3 and 9 and of the persistent latency blind
rotate on one GPU, by variant builds.

    python3 tools/ablate_kernels.py [B 9T 9L BR 3 3G 2 2P 2I ...]

(the kernels to run, default all of them)

Each variant is a committed kernel source (``csrc/external_product.cu`` and
``csrc/banded_mm.cu`` through their shared ``csrc/banded_wgmma.cuh``;
``csrc/banded_mm_latency.cu``; ``csrc/crt_external_product.cuh`` through
its two sources; ``csrc/ntt.cu`` and ``csrc/ntt_inverse.cu`` with
``csrc/ntt_regs.cuh``) built with some of its ``ABLATE_*``
switches defined (the lists below; the port's own build defines none; or
``PHASE_CLOCKS``, with which the persistent latency kernel counts the
clocks of each part of a step), by ``chip_smoke.build_variant`` with the
port's nvcc flags into its own library, and launched through
the same C entry point at the main path's shape, beside the committed
kernel, in one process on one card:

- kernel B at the table step (B=1024, l=4, k+1=2, N=1024, A=1,
  S=keep=4, limb_offset 4);
- kernel 9's table form at the same step (``pallas`` mode: kernel A's
  planes in place, Cout=2, S=4, 4 output planes);
- kernel 9's latency form at the B=1 latency step (k+1=2, l=4, N=1024, 4
  kept key limbs, 1 digit limb: kernel 1's digits and a BSK step in place);
- the persistent latency blind rotate (``csrc/blind_rotate_latency.cu``,
  BR) over a whole B=1 lookup (710 steps) at the same latency shape;
- kernel 3 at the MLP shape (B=256, N=4096, l=2, k+1=2, 3 primes), and
  in groups of output components (3G) at N=16384, k+1=4, B=2;
- kernel 2 at the MLP key pack's shape (6576 polynomials of N=4096, its 3
  primes): the standalone forward (2) and the pack entry (2P) on signed
  64-bit inputs, the inverse (2I) on 512 of their spectra.

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
BR = ("blind_rotate_latency.cu",)
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
VARIANTS_BR = {
    "committed": [],
    "no MMA (the chain floor)": ["ABLATE_NO_MMA"],
    "no key prefetch (each step waits for its key rows)":
        ["ABLATE_NO_PREFETCH"],
    "no digits recompute": ["ABLATE_NO_DIGITS"],
    "no band staging": ["ABLATE_NO_BAND_STAGING"],
    "no key rows": ["ABLATE_NO_KEY"],
    "no fragment build": ["ABLATE_NO_FRAGMENTS"],
    "no release fence at the cluster barrier": ["ABLATE_RELAXED_ARRIVE"],
    "clocks per phase (instrumented, same function)": ["PHASE_CLOCKS"],
}
NTT_F = ("ntt.cu",)
NTT_I = ("ntt_inverse.cu",)
VARIANTS_2 = {
    "committed": [],
    "no reduction (the low word taken as the residue)":
        ["ABLATE_NO_REDUCTION"],
    "no exchanges": ["ABLATE_NO_EXCHANGE"],
    "no stores": ["ABLATE_NO_STORE"],
    "none of the three": ["ABLATE_NO_REDUCTION", "ABLATE_NO_EXCHANGE",
                          "ABLATE_NO_STORE"],
    "a stage's twiddle pairs gathered into registers first (same "
    "function)": ["ABLATE_TWIDDLE_GATHER"],
    "registers capped at 64, 4 blocks a SM (same function)":
        ["ABLATE_REGS=64"],
    "registers capped at 128, 2 blocks a SM (same function)":
        ["ABLATE_REGS=128"],
    "registers not capped (same function)": ["ABLATE_REGS=256"],
    "each thread its own 16-byte stores (same function)":
        ["ABLATE_DIRECT_STORES"],
    "the last pass's twiddle pairs by 8-byte loads (same function)":
        ["ABLATE_SCALAR_TWIDDLES"],
}
VARIANTS_2P = {
    "committed": [],
    "no stores (companions still computed)": ["ABLATE_NO_STORE"],
    "each thread its own 16-byte stores (same function)":
        ["ABLATE_DIRECT_STORES"],
    "the last pass's twiddle pairs by 8-byte loads (same function)":
        ["ABLATE_SCALAR_TWIDDLES"],
}
VARIANTS_2I = {
    "committed": [],
    "no exchanges": ["ABLATE_NO_EXCHANGE"],
    "no stores": ["ABLATE_NO_STORE"],
    "registers capped at 40, 6 blocks a SM (same function)":
        ["ABLATE_REGS=40"],
    "registers not capped (same function)": ["ABLATE_REGS=256"],
}
VARIANTS_3 = {
    "committed": [],
    "a stage's twiddle pairs gathered into registers first (same "
    "function)": ["ABLATE_TWIDDLE_GATHER"],
    "no key-spectrum loads": ["ABLATE_NO_KEY_LOADS"],
}


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
            loaded[name] = cs.load_variant(tmp, name, proc, entry)
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


KERNELS = ("B", "9T", "9L", "BR", "3", "3G", "2", "2P", "2I")


def main(wanted: list[str]) -> None:
    if not torch.cuda.is_available():
        sys.exit("ablate_kernels: no GPU")
    unknown = set(wanted) - set(KERNELS)
    if unknown:
        sys.exit(f"ablate_kernels: unknown kernel(s) {sorted(unknown)}; "
                 f"choose from {KERNELS}")
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
                                  ("BR", BR, VARIANTS_BR),
                                  ("3", XP_3, VARIANTS_3),
                                  ("3G", XP_3, {"committed": []}),
                                  ("2", NTT_F, VARIANTS_2),
                                  ("2P", NTT_F, VARIANTS_2P),
                                  ("2I", NTT_I, VARIANTS_2I)):
        if kernel not in wanted:
            continue
        for i, (label, switches) in enumerate(variants.items()):
            name = f"{kernel}_{i}"
            names[name] = (label, cs.build_variant(tmp, src, name, switches))
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(cs.SEED)
    results = []

    loaded = {}
    # kernel B at the table step
    batch, levels, kp1, n, s_planes, keep, lo = 1024, 4, 2, 1024, 4, 4, 4
    planes = cs.rand_i8(rng, (levels, batch * kp1, n), "cuda")
    vv = cs.rand_i8(rng, (levels * kp1, kp1, s_planes, 2 * n - 1), "cuda")
    acc = cs.rand_torus(rng, (batch * kp1, n), "cuda")
    if "B" in wanted:
        want = xp.external_product_accumulate_plain(
            planes, vv, acc.clone(), keep=keep, limb_offset=lo)
        order = [f"B_{i}" for i in range(len(VARIANTS_B))] + ["B_0"]
        for name in order:
            label, proc = names[name]
            if name not in loaded:
                loaded[name] = cs.load_variant(
                    tmp, name, proc, "external_product_accumulate")
            f, regs = loaded[name]

            def call(a, f=f):
                return f(planes.data_ptr(), vv.data_ptr(), a.data_ptr(),
                         batch, levels, 1, kp1, n, s_planes, keep, lo,
                         stream)
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
    if "9T" in wanted:
        out = torch.empty((batch, kp1, s_planes, n), dtype=torch.int32,
                          device="cuda")
        want = bm.banded_matmul_plain(planes, vv, levels=levels)

        def call_table(f):
            return f(planes.data_ptr(), vv.data_ptr(), out.data_ptr(), 1,
                     batch, levels * kp1, kp1, kp1, s_planes, n, stream)
        results += ablate(names, loaded, tmp, "9T", VARIANTS_9T,
                          "banded_matmul", call_table,
                          lambda: torch.equal(out, want), 50)

    # kernel 9's latency form at the B=1 latency step
    s_key, base_log = 4, 5
    cin = levels * kp1
    if "9L" in wanted:
        digits = torch.from_numpy(rng.integers(-16, 17, (levels, kp1, n))
                                  .astype(np.int32)).cuda()
        w_vv = cs.rand_i8(rng, (2, cin, kp1, s_key, 2 * n - 1), "cuda")[1]
        out_l = torch.empty((kp1, 1, s_key, n), dtype=torch.int32,
                            device="cuda")
        want_l = bm.banded_matmul_latency_plain(
            digits, w_vv, kp1=kp1, levels=levels, base_log=base_log)
        vlen = 2 * n - 1
        base = w_vv.data_ptr()

        def call_latency(f):
            return f(base + n - 1, base + w_vv.numel(), vlen, s_key * vlen,
                     0, kp1 * s_key * vlen, digits.data_ptr(), None,
                     out_l.data_ptr(), s_key, kp1, cin, cin, 1, 1, n, stream)
        results += ablate(names, loaded, tmp, "9L", VARIANTS_9L,
                          "banded_matmul_latency", call_latency,
                          lambda: torch.equal(out_l, want_l), 500)

    # the persistent latency blind rotate over a B=1 lookup's 710 steps
    if "BR" in wanted:
        from concrete_tpu_torch.core import kernels as kn
        from concrete_tpu_torch.ops import latency as lat
        n_small = 710
        a_t = torch.from_numpy(rng.integers(0, 2 * n, (1, n_small))
                               .astype(np.int32)).cuda()
        acc_l = cs.rand_torus(rng, (kp1, 1, n), "cuda")
        bsk_l = kn.LimbBSK(planes=lat.with_tail(cs.rand_i8(
            rng, (n_small, cin, kp1, s_key, 2 * n - 1), "cuda")),
            base_log=base_log, levels=levels, truncate_limbs=lo)
        want_br = kn._blind_rotate_latency_steps(
            a_t, acc_l.clone(), bsk_l,
            cs.fused_params(n, levels, base_log, n_small, kp1))
        pl = lat.plan(1, n, kp1, levels, 1, s_key)
        got_br = acc_l.clone()

        def call_br(f):
            got_br.copy_(acc_l)
            return f(a_t.data_ptr(), got_br.data_ptr(),
                     bsk_l.planes.data_ptr(),
                     bsk_l.planes.data_ptr() + bsk_l.planes.numel(), 1,
                     n_small, kp1, levels, base_log, 1, s_key, n, lo,
                     pl.cluster, stream)
        results += ablate(names, loaded, tmp, "BR", VARIANTS_BR,
                          "blind_rotate_latency", call_br,
                          lambda: torch.equal(got_br, want_br), 5)
        # the instrumented builds: clocks per phase of one lookup's steps
        # in block 0 of the cluster (thread 0, from one block or cluster
        # barrier to the next)
        for idx, (label, switches) in enumerate(VARIANTS_BR.items()):
            if "PHASE_CLOCKS" not in switches:
                continue
            lib = ctypes.CDLL(os.path.join(tmp, f"BR_{idx}.so"))
            clocks = (ctypes.c_ulonglong * 8)()
            _build.check(label, lib.blind_rotate_latency_phases(clocks))
            _build.check(label, call_br(loaded[f"BR_{idx}"][0]))
            torch.cuda.synchronize()
            _build.check(label, lib.blind_rotate_latency_phases(clocks))
            per_step = {name: c / n_small
                        for name, c in zip(cs.LATENCY_PHASES, clocks)}
            results.append({"kernel": "blind_rotate_latency",
                            "variant": label, "clocks_per_step": per_step})
            print(f"kernel BR, {label}, clocks per step by phase: "
                  f"{per_step}", flush=True)

    # kernel 3 at the MLP shape, and in groups at N=16384, k+1 = 4
    for kernel, variants, batch, n, kp1 in (("3", VARIANTS_3, 256, 4096, 2),
                                            ("3G", {"committed": []}, 2,
                                             16384, 4)):
        if kernel not in wanted:
            continue
        primes = host.special_ntt_primes(n, 128)[:3]
        levels = 2
        bsk = rng.integers(0, 1 << 64, (1, levels, kp1, kp1, n),
                           dtype=np.uint64)
        fbsk = fn.pack_bsk_fused(bsk, cs.fused_params(n, levels, 8, 1, kp1),
                                 primes=primes, trunc_bits=0, device="cuda")
        digits = torch.from_numpy(rng.integers(
            -128, 128, (levels, batch * kp1, n)).astype(np.int32)).cuda()
        sv, ss = fbsk.spec_val[0], fbsk.spec_sh[0]
        want = fn.crt_external_product_plain(digits, sv, ss, primes, kp1)
        tw = tn.pair_tables(n, primes, digits.device)
        cst = tn.prime_constants(n, primes, digits.device)
        out = torch.empty_like(want)
        co_group = fn.kernel_groups(n, kp1)[1]

        def call_3(f, batch=batch, n=n, kp1=kp1, sv=sv, ss=ss, tw=tw,
                   cst=cst, out=out, digits=digits, co_group=co_group):
            return f(digits.data_ptr(), sv.data_ptr(), ss.data_ptr(),
                     out.data_ptr(), tw.data_ptr(), cst.data_ptr(), batch,
                     levels, kp1, len(primes), n.bit_length() - 1, co_group,
                     stream)
        results += ablate(names, loaded, tmp, kernel, variants,
                          "crt_external_product", call_3,
                          lambda out=out, want=want: torch.equal(out, want),
                          50)
    # kernel 2 at the MLP key pack's shape
    if {"2", "2P", "2I"} & set(wanted):
        n, rows, polys = 4096, 8, 822 * 8
        primes = host.special_ntt_primes(n, 128)[:3]
        x = cs.ntt_inputs(rng, polys, n)
        tw = tn.pair_tables(n, primes, x.device)
        cst = tn.constants(n, primes, x.device)
        spec_p = tn.ntt_forward_plain(x, primes)
        log_n, n_p = n.bit_length() - 1, len(primes)
    if "2" in wanted:
        spec = torch.empty_like(spec_p)

        def call_2(f):
            return f(x.data_ptr(), spec.data_ptr(), tw.data_ptr(),
                     cst.data_ptr(), polys, n_p, log_n, stream)
        results += ablate(names, loaded, tmp, "2", VARIANTS_2,
                          "ntt_forward", call_2,
                          lambda: torch.equal(spec, spec_p), 5)
    if "2P" in wanted:
        val_p, sh_p = tn.ntt_forward_pack_plain(x, primes, rows, 0)
        val, sh = torch.empty_like(val_p), torch.empty_like(sh_p)

        def call_2p(f):
            return f(x.data_ptr(), val.data_ptr(), sh.data_ptr(),
                     tw.data_ptr(), cst.data_ptr(), polys, rows, n_p, log_n,
                     0, stream)
        results += ablate(names, loaded, tmp, "2P", VARIANTS_2P,
                          "ntt_forward_pack", call_2p,
                          lambda: torch.equal(val, val_p)
                          and torch.equal(sh, sh_p), 5)
    if "2I" in wanted:
        spec_i = spec_p[:, :512].contiguous()
        back_p = tn.ntt_inverse_plain(spec_i, primes)
        back = torch.empty_like(back_p)

        def call_2i(f):
            return f(spec_i.data_ptr(), back.data_ptr(), tw.data_ptr(),
                     cst.data_ptr(), 512, n_p, log_n, stream)
        results += ablate(names, loaded, tmp, "2I", VARIANTS_2I,
                          "ntt_inverse", call_2i,
                          lambda: torch.equal(back, back_p), 20)
    shutil.rmtree(tmp)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ablate_kernels.json"),
              "w") as f:
        json.dump({"card": card, "results": results}, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:] or list(KERNELS))
