"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface.  The library goes into the git-ignored
``_build/`` of the package under a name derived from the sources' hash, so
the first call in a fresh checkout builds it and later calls load it.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.
``LAUNCHES`` counts, per kernel, the launches its wrapper made
(``count``).  The build and the count each take a lock: the dataflow
scheduler's threads may launch, and make their first call, at once.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from concrete_tpu_torch.utils.csprng import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> launches made by its wrapper since the last reset
LAUNCHES: collections.Counter = collections.Counter()
#: set by the first build or load: seconds taken, library path, ptxas log,
#: each source's compile seconds (empty when the library was loaded)
BUILD_INFO: dict = {}

_LIB = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # acc, a_rows, out, rows, n, base_log, levels, a_limbs, stream
    "rotate_decompose": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # planes, vv, acc, batch, levels, a_limbs, kp1, n, s_planes, keep,
    # limb_offset, stream
    "external_product_accumulate": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P],
    # acc, acc32, a_rows, out, rows, n, base_log, levels, stream
    "rotate_decompose_digits": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    # x or spec, out, twiddle pairs, prime constants, polys, n_primes,
    # log_n, stream
    "ntt_forward": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ntt_inverse": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, spec, spec_sh, twiddle pairs, prime constants, polys, rows,
    # n_primes, log_n, shift, stream
    "ntt_forward_pack": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # digits, spec, spec_sh, out, twiddles, prime constants, batch, levels,
    # kp1, n_primes, log_n, co_group, stream
    "crt_external_product": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P],
    # digits, spec stack, spec_sh stack, out, twiddles, prime constants,
    # key_index, batch, levels, kp1, n_primes, log_n, co_group, stream
    "crt_external_product_keyed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _P],
    # residues, acc, constants, n_primes, elems, shift, acc32, stream
    "garner_accumulate": [_P, _P, _P, _I, _L, _I, _I, _P],
    # lhs, vv, out, a_limbs, rows, cin, kp1, cout, s_planes, n, stream
    "banded_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # lhs, lhs_end, lhs strides (a, r, lev, r_in), digits, vv, out,
    # a_limbs, rows, cin, kp1, batch, s_planes, n, stream
    "banded_matmul_latency": [_P, _P, _L, _L, _L, _L, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _P],
    # planes, acc, rows, n_planes, n, limb_offset, stream
    "recombine_accumulate": [_P, _P, _I, _I, _I, _I, _P],
    # a_t, acc, planes, planes_end, batch, n_small, kp1, levels, base_log,
    # d_limbs, s_key, n, limb_offset, cluster, stream
    "blind_rotate_latency": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # a_t, acc, spec, spec_sh, twiddle pairs, prime constants, Garner
    # constants, batch, n_small, kp1, levels, base_log, n_primes, log_n,
    # trunc_bits, acc32, stream
    "blind_rotate_fused_latency": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _P],
    # the same arguments (ops/fused_ntt.launch_scan)
    "blind_rotate_crt_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P],
    # ct, key planes, lut, lut row stride, a_t, acc, scratch, batch, n_in,
    # levels, base_log, cols, kp1, n, log_n, body offset, stream
    "pbs_prologue": [_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _L, _P],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def count(name: str) -> None:
    """One launch of kernel `name`, made by its wrapper."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(sources: list[str], so_path: str) -> tuple[str, dict]:
    """Compile each source in parallel, link one library; return the log
    and each source's compile seconds."""
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in sources]
    logs = [os.path.join(tmp, os.path.basename(s) + ".log") for s in sources]
    t0 = time.perf_counter()
    procs = {}
    for src, obj, log_path in zip(sources, objs, logs):
        with open(log_path, "w") as out:
            procs[src] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj], stdout=out,
                stderr=subprocess.STDOUT)
    seconds = {}
    while len(seconds) < len(procs):
        for src, proc in procs.items():
            if src not in seconds and proc.poll() is not None:
                seconds[src] = time.perf_counter() - t0
        time.sleep(0.05)
    log = []
    for src, log_path in zip(sources, logs):
        with open(log_path) as f:
            out = f.read()
        log.append(out)
        if procs[src].returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    lib_tmp = os.path.join(tmp, "lib.so")
    link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    # rename into place: a concurrent process never loads a partial file
    os.replace(lib_tmp, so_path)
    shutil.rmtree(tmp)
    return "".join(log), {os.path.basename(s): t for s, t in seconds.items()}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use (once, whatever
    the threads that ask for it)."""
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _load()
    return _LIB


def _load() -> None:
    global _LIB
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log, seconds = "", {}
    if not os.path.exists(so_path):
        log, seconds = _build(sources, so_path)
    lib = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=so_path,
                      log=log, sources=sources, source_seconds=seconds)
    _LIB = lib


def check(name: str, code: int) -> None:
    if code:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
