"""The GLWE key bodies on a torch device against the JAX package, on CPU.

``core/keygen.py``'s device path (the product as f64 ``torch.matmul`` on
16-bit mask limbs against the key's Toeplitz matrix, the rows streamed in
chunks whose draws seek into the ChaCha20 stream) and ``core/wop.py``'s
``pfpksk_gen_device``, run on CPU tensors at N = 256..1024: the product
equal to both packages' numpy ``_negacyclic_dot_with_key`` (masks with the
top bits set included); the chunked GLWE batch, BSK and PFPKSK bit-equal
to the JAX package's from one seed, in chunks of one row, with an uneven
last chunk and with a chunk that crosses the Box-Muller draw's cos/sin
split; ``Keys.generate(seed, device="cpu")`` equal to the JAX ``Keys``
array by array; a PFPKSK made on the device equal to the one its packed
limbs give back, and one PFPKSK for every device it is packed on; and
``device=None`` refused without CUDA.
"""

import dataclasses

import numpy as np
import pytest
import torch

from concrete_tpu.compilation.keys import Keys as JKeys
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import wop as jwop
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE
from concrete_tpu.utils.csprng import SecureGenerator as JSecureGenerator

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.compilation.keys import Keys as TKeys
from concrete_tpu_torch.core import keygen as tkg
from concrete_tpu_torch.core import kernels_wop as kw
from concrete_tpu_torch.core import wop as twop
from concrete_tpu_torch.core.refimpl import SecretKeys
from concrete_tpu_torch.params import CryptoParams as TParams
from concrete_tpu_torch.utils.csprng import SecureGenerator

EDGES = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                  0xFFFF, 0x10000, (1 << 48) - 1, 0xFFFF << 48],
                 dtype=np.uint64)
STD = 2.0 ** -40


def _tparams(p):
    return TParams(**dataclasses.asdict(p))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("k,n", [(2, 256), (1, 1024)])
def test_product_matches_both_packages(k, n):
    """The torch product against both packages' numpy product: 6 random
    rows with the top bits set, and one row of edge words."""
    rng = np.random.default_rng(n + k)
    masks = rng.integers(0, 1 << 64, (7, k, n), dtype=np.uint64)
    masks[:, :, :8] |= np.uint64(0xFFFF) << np.uint64(48)
    masks[6, :, :EDGES.size] = EDGES
    key = rng.integers(0, 2, (k, n)).astype(np.uint64)
    got = tkg.negacyclic_dot_torch(torch.from_numpy(masks.view(np.int64)),
                                   key)
    want = jkg._negacyclic_dot_with_key(masks, key)
    np.testing.assert_array_equal(want,
                                  tkg._negacyclic_dot_with_key(masks, key))
    np.testing.assert_array_equal(_u64(got), want)
    # the Toeplitz matrix: a (*) key for a = X^t, one row at a time
    mat = tkg.negacyclic_matrix(torch.from_numpy(key[0].astype(np.int64)))
    for t in (0, 1, n - 1):
        x_t = np.zeros(n, dtype=np.uint64)
        x_t[t] = 1
        row = jkg._negacyclic_dot_with_key(x_t[None, None, :],
                                           key[:1]).view(np.int64)[0]
        np.testing.assert_array_equal(mat[t].to(torch.int64).numpy(), row)


@pytest.mark.parametrize("rows,chunk", [
    (5, None),       # one chunk
    (5, 1),          # one row a chunk
    (7, 3),          # uneven last chunk; rows 3..5 cross the split m = 3.5 N
    (6, 4)])         # rows 0..3 cross m = 3 N
def test_chunked_glwe_batch_matches_reference(monkeypatch, rows, chunk):
    """glwe_encrypt_batch_device from a seeded SecureGenerator, in chunks
    of `chunk` rows: bit-equal to the JAX package's glwe_encrypt_batch
    from the same seed, and the generator left where the one numpy call
    leaves it."""
    n, k = 256, 2
    if chunk is not None:
        monkeypatch.setattr(tkg, "CHUNK_WORDS", chunk * k * n)
    rng = np.random.default_rng(rows)
    gsk = rng.integers(0, 2, (k, n)).astype(np.uint64)
    msgs = rng.integers(0, 1 << 64, (rows, n), dtype=np.uint64)
    jgen, tgen = JSecureGenerator(21), SecureGenerator(21)
    want = jkg.glwe_encrypt_batch(jgen, gsk, msgs, STD)
    timings = {}
    got = tkg.glwe_encrypt_batch_device(
        tgen, gsk, rows, lambda r0, r1: torch.from_numpy(
            msgs[r0:r1].view(np.int64)), STD, "cpu", timings=timings)
    assert got.dtype == torch.int64 and got.shape == (rows, k + 1, n)
    np.testing.assert_array_equal(_u64(got), want)
    assert tgen.stream.counter == jgen.stream.counter
    np.testing.assert_array_equal(tgen.integers(0, 1 << 64, 4,
                                                dtype=np.uint64),
                                  jgen.integers(0, 1 << 64, 4,
                                                dtype=np.uint64))
    assert set(timings) == {"draws_s", "product_s", "wall_s"}


def _sk(params, seed):
    sk, _ = jkg.keygen(np.random.default_rng(seed), params)
    return sk


@pytest.mark.parametrize("chunk_words", [None, 256, 3 * 256 + 256 // 2])
def test_chunked_pfpksk_matches_reference(monkeypatch, chunk_words):
    """pfpksk_gen_device (its messages made on the device, a chunk at a
    time) against the JAX package's core/wop.pfpksk_gen from one seed:
    in one chunk, in chunks of one row and in chunks of three rows
    (uneven last chunk, one across the Gaussian's split)."""
    if chunk_words is not None:
        monkeypatch.setattr(tkg, "CHUNK_WORDS", chunk_words)
    params = TEST_PARAMS_TINY_WIDE
    jwp = jwop.WopParams(base=params, cbs_level=3, cbs_base_log=6,
                         pfks_level=3, pfks_base_log=10)
    twp = twop.WopParams(base=_tparams(params), cbs_level=3,
                         cbs_base_log=6, pfks_level=3, pfks_base_log=10)
    sk = _sk(params, 4)
    want = jwop.pfpksk_gen(JSecureGenerator(8), sk, jwp).pfpksk
    got = twop.pfpksk_gen_device(
        SecureGenerator(8), SecretKeys(lwe_small=sk.lwe_small,
                                       glwe=sk.glwe), twp, "cpu")
    assert got.shape == want.shape == (2, params.n_big + 1, 3, 2, 256)
    np.testing.assert_array_equal(_u64(got), want)
    packed = kw.pack_pfpksk(got, twp, device="cpu")
    np.testing.assert_array_equal(
        kw.unpack_pfpksk(packed, params.n_big + 1), want)


@pytest.mark.parametrize("params", [TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE],
                         ids=["tiny", "tiny_wide"])
def test_bsk_and_keygen_match_reference(monkeypatch, params):
    """make_bsk_device and keygen_device (a seeded SecureGenerator, chunks
    of one and of two rows; a numpy Generator, drawn whole) equal to the
    JAX package's make_bsk and keygen."""
    tparams = _tparams(params)
    sk = _sk(params, 6)
    want = jkg.make_bsk(JSecureGenerator(2), sk.lwe_small, sk.glwe, params)
    for words in (params.glwe_dimension * params.polynomial_size,
                  2 * params.glwe_dimension * params.polynomial_size):
        monkeypatch.setattr(tkg, "CHUNK_WORDS", words)
        got = tkg.make_bsk_device(SecureGenerator(2), sk.lwe_small, sk.glwe,
                                  tparams, "cpu")
        np.testing.assert_array_equal(_u64(got), want)
    monkeypatch.undo()
    jsk, jsrv = jkg.keygen(np.random.default_rng(9), params)
    timings = {}
    tsk, tsrv = tkg.keygen_device(np.random.default_rng(9), tparams, "cpu",
                                  timings=timings)
    for a, b in ((tsk.lwe_small, jsk.lwe_small), (tsk.glwe, jsk.glwe),
                 (tsrv.bsk, jsrv.bsk), (tsrv.ksk, jsrv.ksk)):
        assert a.dtype == np.uint64
        np.testing.assert_array_equal(a, b)
    assert {"draws_s", "product_s", "to_host_s", "ksk_s"} <= set(timings)


def test_keys_generate_on_device_matches_reference(monkeypatch):
    """Keys.generate(seed, device="cpu") against the JAX package's
    Keys.generate(seed), array by array, in one chunk and in chunks of
    one row; the parts' seconds recorded."""
    params = TEST_PARAMS_TINY_WIDE
    jk = JKeys(params)
    jk.generate(seed=17)
    jd = jk._to_npz_dict()
    for words in (None, params.polynomial_size):
        if words is not None:
            monkeypatch.setattr(tkg, "CHUNK_WORDS", words)
        tk = TKeys(_tparams(params))
        tk.generate(seed=17, device="cpu")
        td = tk._to_npz_dict()
        assert list(td) == list(jd)
        for name in jd:
            np.testing.assert_array_equal(td[name], jd[name])
        assert {"draws_s", "product_s"} <= set(tk.setup_seconds["bsk"])
        assert tk.setup_seconds["ksk_s"] >= 0


def test_pfpksk_stays_packed_until_a_caller_saves_it(tmp_path):
    """Keys.wop_evaluation makes the PFPKSK on its device and packs it
    there, with no host copy; wop_keys, save and the evaluation keys give
    the packed key's u64 bits back, which decrypt as a PFPKSK (a body
    minus mask (*) key is the message plus small noise)."""
    from concrete_tpu_torch.compilation.evaluation_keys import \
        EvaluationKeys
    params = _tparams(TEST_PARAMS_TINY_WIDE)
    wp = twop.WopParams(base=params, cbs_level=3, cbs_base_log=6,
                        pfks_level=3, pfks_base_log=10)
    keys = TKeys(params)
    keys.generate(seed=3, device="cpu")
    packed = keys.wop_evaluation(wp, device="cpu")
    assert keys._pfpksk == {}
    assert set(keys.setup_seconds["pfpksk"]) >= {"draws_s", "product_s",
                                                 "pack_s"}
    host = keys.wop_keys(wp)
    np.testing.assert_array_equal(
        kw.pack_pfpksk(host, wp, device="cpu").planes.numpy(),
        packed.planes.numpy())
    k, n = params.glwe_dimension, params.polynomial_size
    rows = host.reshape(-1, k + 1, n)
    phase = rows[:, k] - tkg._negacyclic_dot_with_key(rows[:, :k],
                                                      keys.secret.glwe)
    in_coeffs = np.concatenate([-keys.secret.lwe_big.astype(np.int64), [1]])
    v = np.concatenate([-keys.secret.glwe.astype(np.int64),
                        np.eye(1, n, dtype=np.int64)])
    g = (np.uint64(1) << (np.uint64(64) - np.uint64(10) * np.arange(
        1, 4, dtype=np.uint64)))
    msgs = (in_coeffs[None, :, None, None].astype(np.uint64)
            * v[:, None, None, :].astype(np.uint64) * g[None, None, :, None])
    noise = (phase - msgs.reshape(-1, n)).view(np.int64)
    assert np.abs(noise).max() < 2.0 ** 64 * 2.0 ** -40 * 8
    path = str(tmp_path / "keys.npz")
    keys.save(path)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["pfpksk_3_10"], host)
    assert set(EvaluationKeys.from_keys(keys).pfpksk) == {(3, 10)}


def test_one_pfpksk_for_every_device(monkeypatch):
    """A keyset holds one PFPKSK per pfks gadget: a second device's pack
    is the first one's planes copied there, and wop_keys gives that key's
    bits, made once (on "cpu" and "cpu:0", two cache entries); a keyset
    with no PFPKSK yet gets one from wop_keys, made and packed on its
    device."""
    params = _tparams(TEST_PARAMS_TINY_WIDE)
    wp = twop.WopParams(base=params, cbs_level=3, cbs_base_log=6,
                        pfks_level=3, pfks_base_log=10)
    keys = TKeys(params)
    keys.generate(seed=5, device="cpu")
    made = []
    make = keys._make_pfpksk
    monkeypatch.setattr(keys, "_make_pfpksk",
                        lambda *a: made.append(a) or make(*a))
    first = keys.wop_evaluation(wp, device="cpu")
    second = keys.wop_evaluation(wp, device="cpu:0")
    host = keys.wop_keys(wp)
    assert len(made) == 1 and second is not first
    assert set(keys._packed_pfpksk) == {(3, 10, "cpu"), (3, 10, "cpu:0")}
    np.testing.assert_array_equal(second.planes.numpy(),
                                  first.planes.numpy())
    np.testing.assert_array_equal(
        kw.pack_pfpksk(host, wp, device="cpu").planes.numpy(),
        second.planes.numpy())
    np.testing.assert_array_equal(keys.host_pfpksks()[(3, 10)], host)
    fresh = TKeys(params)
    fresh.generate(seed=5, device="cpu")
    host = fresh.wop_keys(wp, device="cpu")
    assert set(fresh._packed_pfpksk) == {(3, 10, "cpu")}
    np.testing.assert_array_equal(
        kw.pack_pfpksk(host, wp, device="cpu").planes.numpy(),
        fresh.wop_evaluation(wp, device="cpu").planes.numpy())


def test_no_device_means_cuda():
    """device=None is the card, as everywhere in the port: without CUDA a
    key generation is refused (a secret-only keyset makes no body and is
    not)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: None resolves to it")
    keys = TKeys(_tparams(TEST_PARAMS_TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        keys.generate(seed=1)
    keys.generate(seed=1, secret_only=True)
    assert keys.are_generated


def test_cached_keyset_keeps_a_pfpksk_made_on_the_device(tmp_path):
    """With the insecure key cache, a PFPKSK made and packed on the device
    (wop_evaluation) is written into the keyset's file from its packed
    limbs; a reload packs that key again instead of making another."""
    params = _tparams(TEST_PARAMS_TINY_WIDE)
    wp = twop.WopParams(base=params, cbs_level=3, cbs_base_log=6,
                        pfks_level=3, pfks_base_log=10)
    d = str(tmp_path)
    keys = TKeys(params, cache_directory=d)
    keys.generate(seed=7, device="cpu")
    packed = keys.wop_evaluation(wp, device="cpu")
    again = TKeys(params, cache_directory=d)
    again.generate(seed=7, device="cpu")
    assert set(again._pfpksk) == {(3, 10)}
    np.testing.assert_array_equal(
        again.wop_evaluation(wp, device="cpu").planes.numpy(),
        packed.planes.numpy())
    assert "pfpksk" not in again.setup_seconds
