"""The CRT-NTT blind rotate of a batch in one launch
(``csrc/blind_rotate_crt_scan.cu``, ``ops/crt_scan.py``) on the card,
bit for bit against the three-kernel loop (``ops.fused_ntt.scan_steps`` on
kernels 1, 3 and 4) and against its plain version, over 12 steps of a
random key packed on the card: at the key-value query's shape (N=2048,
k+1 = 2, l = 1, base 2^23, 3 primes, acc32) at B = 5, 37 and 300 (300 is
no multiple of a wave), a u64-accumulator shape (l = 2, base 2^16: the
digits read the low word), a 2-prime shape, and two levels at base 2^8
(PrimeMatch 10's N=2048 lookups) at B = 100; its launch count, and, through
``blind_rotate_fused`` with tracing on, the rule's form, the span and the
counters ``pbs.crt_ntt_scan_rows`` and ``pbs.crt_ntt_rows``.  A CUDA
kernel has no CPU form: every test skips without a card.  This file
imports no JAX, so it runs on the card's machine:
``CONCRETE_TPU_TEST_PLATFORM=cuda python -m pytest
tests/test_torch_crt_scan_card.py -q``.
"""

import math

import numpy as np
import pytest
import torch

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.ops import _build
from concrete_tpu_torch.ops import crt_scan as cs
from concrete_tpu_torch.ops import fused_ntt as fn
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils import telemetry as tm

pytestmark = pytest.mark.card

STEPS = 12
#: (N, l, base_log, primes, acc32) of the shapes, k+1 = 2
SHAPES = {"kvdb": (2048, 1, 23, 3, True), "u64": (2048, 2, 16, 3, False),
          "p2": (2048, 1, 23, 2, True), "l2": (2048, 2, 8, 3, True)}
CASES = [("kvdb", 5), ("kvdb", 37), ("kvdb", 300), ("u64", 37), ("p2", 37),
         ("l2", 100)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the one-launch scan runs only on "
                    "CUDA")


def _case(shape: str, batch: int):
    """(params, fused key, ct, lut, acc32) on the card, random."""
    n, levels, base_log, n_p, acc32 = SHAPES[shape]
    params = CryptoParams(n_small=STEPS, glwe_dimension=1, polynomial_size=n,
                          pbs_level=levels, pbs_base_log=base_log,
                          ks_level=1, ks_base_log=2, lwe_std=0.0,
                          glwe_std=0.0, security_level=0)
    primes = host.special_ntt_primes(n, 128)[:n_p]
    t = max(0, host.required_bits(params, 0)
            - (math.prod(primes).bit_length() - 1))
    rng = np.random.default_rng([batch, n, levels, n_p])
    bsk = rng.integers(0, 1 << 64, (STEPS, levels, 2, 2, n), dtype=np.uint64)
    fbsk = fn.pack_bsk_fused(bsk, params, primes=primes, trunc_bits=t,
                             device="cuda")
    ct = torch.from_numpy(rng.integers(0, 1 << 64, (batch, STEPS + 1),
                                       dtype=np.uint64).view(np.int64))
    lut = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64)
                           .view(np.int64))
    return params, fbsk, ct.cuda(), lut.cuda(), acc32


@pytest.mark.parametrize("shape,batch", CASES,
                         ids=[f"{s}-b{b}" for s, b in CASES])
def test_one_launch_scan_is_the_loop(card, shape, batch):
    params, fbsk, ct, lut, acc32 = _case(shape, batch)
    n = params.polynomial_size
    a_t, acc = fn.first_accumulator(ct, fbsk, lut, params, acc32)
    assert (acc.dtype == torch.int32) == acc32
    assert fn.blind_rotate_form(batch, n, 2, fbsk.levels, len(fbsk.primes),
                                acc32) == "crt_ntt_scan"
    kw = dict(primes=fbsk.primes, trunc_bits=fbsk.trunc_bits,
              base_log=fbsk.base_log, levels=fbsk.levels)
    before = _build.LAUNCHES[cs.NAME]
    got = cs.blind_rotate_crt_scan(a_t, acc.clone(), fbsk.spec_val,
                                   fbsk.spec_sh, **kw)
    assert _build.LAUNCHES[cs.NAME] == before + 1
    loop = fn.scan_steps(a_t, acc.clone(), fbsk)
    plain = cs.blind_rotate_crt_scan_plain(a_t, acc, fbsk.spec_val,
                                           fbsk.spec_sh, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, loop), "the one launch differs from the loop"
    assert torch.equal(got, plain), "the one launch differs from its plain " \
        "version"
    assert not torch.equal(got, acc)

    tm.reset()
    tm.enable()
    try:
        out = fn.blind_rotate_fused(ct, fbsk, lut, params, acc32=acc32)
        torch.cuda.synchronize()
        snap = tm.snapshot()
    finally:
        tm.disable()
        tm.reset()
    assert _build.LAUNCHES[cs.NAME] == before + 2
    assert torch.equal(out, fn.last_accumulator(got))
    assert snap["counters"]["pbs.crt_ntt_scan_rows"] == batch
    assert snap["counters"]["pbs.crt_ntt_rows"] == batch
    assert [s["attrs"]["form"] for s in snap["spans"]
            if s["name"] == "pbs.blind_rotate"] == ["crt_ntt_scan"]
