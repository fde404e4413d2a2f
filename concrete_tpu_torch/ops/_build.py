"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface.  The library goes into the git-ignored
``_build/`` of the package under a name derived from the sources' hash, so
the first call in a fresh checkout builds it and later calls load it.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.
``LAUNCHES`` counts, per kernel, the launches its wrapper made.
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
import time

from concrete_tpu_torch.utils.csprng import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> launches made by its wrapper since the last reset
LAUNCHES: collections.Counter = collections.Counter()
#: set by the first build or load: seconds taken, library path, ptxas log
BUILD_INFO: dict = {}

_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # acc, a_rows, out, rows, n, base_log, levels, a_limbs, stream
    "rotate_decompose": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # planes, vv, acc, batch, levels, a_limbs, kp1, n, s_planes, keep,
    # limb_offset, stream
    "external_product_accumulate": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(sources: list[str], so_path: str) -> str:
    """Compile each source in parallel, link one library; return the log."""
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    lib_tmp = os.path.join(tmp, "lib.so")
    link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    # rename into place: a concurrent process never loads a partial file
    os.replace(lib_tmp, so_path)
    shutil.rmtree(tmp)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so_path):
        log = _build(sources, so_path)
    lib = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=so_path,
                      log=log, sources=sources)
    _LIB = lib
    return lib


def check(name: str, code: int) -> None:
    if code:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
