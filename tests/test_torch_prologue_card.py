"""The PBS prologue kernel (``csrc/pbs_prologue.cu``) against its plain
version on the card: at tlu4's keyset (n_in 1024, ks 8 levels of base 2^2,
n_out 698, N=1024, k+1 = 2) and GameOfLife's (n_in 2048, the same ks,
n_out 758, N=2048), B = 1 to 4, bit for bit; its launch count; and
``pbs_batch`` on that route with tracing on (``pbs.prologue_rows``, the
outputs those of the torch route).  A CUDA kernel has no CPU form: every
test skips without a card.  This file imports no JAX, so it runs on the
card's machine: ``CONCRETE_TPU_TEST_PLATFORM=cuda python -m pytest
tests/test_torch_prologue_card.py -q``.
"""

import numpy as np
import pytest
import torch

from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.ops import _build
from concrete_tpu_torch.ops import prologue as pro
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils import telemetry as tm

pytestmark = pytest.mark.card

#: (n_small, N, ks_level, ks_base_log) of the keysets, k+1 = 2
SHAPES = {"tlu4": (698, 1024, 8, 2), "gol": (758, 2048, 8, 2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the prologue kernel runs only "
                    "on CUDA")


def _params(shape: str) -> CryptoParams:
    n_small, n, ks_level, ks_base_log = SHAPES[shape]
    return CryptoParams(n_small=n_small, glwe_dimension=1, polynomial_size=n,
                        pbs_level=4, pbs_base_log=5, ks_level=ks_level,
                        ks_base_log=ks_base_log, lwe_std=0.0, glwe_std=0.0,
                        security_level=0)


def _rand(rng, shape) -> torch.Tensor:
    u = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    return torch.from_numpy(u.view(np.int64)).cuda()


@pytest.fixture(scope="module")
def keys():
    """{shape: (params, packed KSK)}, random keys made once."""
    if not torch.cuda.is_available():
        return {}
    rng = np.random.default_rng(21)
    out = {}
    for shape in SHAPES:
        p = _params(shape)
        ksk = rng.integers(0, 1 << 64, (p.polynomial_size, p.ks_level,
                                        p.n_small + 1), dtype=np.uint64)
        out[shape] = (p, kn.pack_ksk(ksk, p, device="cuda"))
    return out


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("b_ct", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_prologue_kernel_is_its_plain_version(card, keys, shape, b_ct,
                                              per_row):
    p, ksk = keys[shape]
    n = p.polynomial_size
    rng = np.random.default_rng([b_ct, per_row, n])
    ct = _rand(rng, (b_ct, n + 1))
    lut = _rand(rng, (b_ct, n) if per_row else (n,))
    for signed in (False, True):
        offset = pro.body_offset(4, signed)
        before = _build.LAUNCHES[pro.NAME]
        # twice: the first launch leaves the scratch zeroed for the second
        for _ in range(2):
            a_t, acc = pro.pbs_prologue(ct, ksk, lut, p, offset)
            want_a, want_acc = pro.pbs_prologue_plain(ct, ksk, lut, p, offset)
            torch.cuda.synchronize()
            assert torch.equal(a_t, want_a)
            assert torch.equal(acc, want_acc)
        assert _build.LAUNCHES[pro.NAME] == before + 2


@pytest.mark.parametrize("b_ct", [1, 4])
def test_pbs_batch_takes_the_prologue(card, keys, b_ct):
    """pbs_batch at tlu4's keyset on a random banded key: one prologue
    launch, pbs.prologue_rows = B, the outputs those of the torch route."""
    p, ksk = keys["tlu4"]
    rng = np.random.default_rng(b_ct)
    bsk_u64 = rng.integers(0, 1 << 64, (p.n_small, p.pbs_level, 2, 2,
                                        p.polynomial_size), dtype=np.uint64)
    bsk = kn.pack_bsk(bsk_u64, p, 4, device="cuda")
    ct = _rand(rng, (b_ct, p.polynomial_size + 1))
    lut = _rand(rng, (p.polynomial_size,))
    before = _build.LAUNCHES[pro.NAME]
    tm.reset()
    tm.enable()
    try:
        got = kn.pbs_batch(ct, ksk, bsk, lut, p, 4, signed=True)
        counters = tm.snapshot()["counters"]
    finally:
        tm.disable()
        tm.reset()
    assert _build.LAUNCHES[pro.NAME] == before + 1
    assert counters["pbs.prologue_rows"] == b_ct
    route = kn.prologue_route
    kn.prologue_route = lambda *args: False
    try:
        want = kn.pbs_batch(ct, ksk, bsk, lut, p, 4, signed=True)
    finally:
        kn.prologue_route = route
    torch.cuda.synchronize()
    assert torch.equal(got, want)
