"""The port's WoP-PBS primitives (``concrete_tpu_torch/core/kernels_wop.py``)
against the JAX package's numpy oracle and batched kernels, on CPU.

At ``TEST_PARAMS_TINY_WIDE`` (a banded key, N = 256) with the gadgets
(cbs 3 x 2^6, pfks 8 x 2^4), keys from one numpy seed per module, the
same numpy keys given to both packages: the PFPKSK pack (and its
device-style limb split) against the JAX package's, and the PFPKSK
keyswitch, the sign PBS, both bit extractions, the circuit bootstrap, the
vertical packing (tree and rotation phases, on the CRT-NTT kernels' plain
versions) and the queue-3 shapes (cbs 3 x 2^9) bit for bit against the
JAX package's oracle ``concrete_tpu.core.wop``; one ``wop_pbs_batch`` and
one ``wop_pbs_crt_batch`` against the JAX package's ``kernels_wop``; the
port's copy of the oracle (``concrete_tpu_torch.core.wop``) against the
JAX package's; the keyed product against a direct negacyclic product; the
runtime primes; the acc32 message-scale gate on a small fused key; the
chunking and the memory refusal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from concrete_tpu.core import kernels as jkn
from concrete_tpu.core import kernels_wop as jkw
from concrete_tpu.core import limbs as jlb
from concrete_tpu.core import refimpl as jref
from concrete_tpu.core import wop as jwop
from concrete_tpu.params import CryptoParams as JParams
from concrete_tpu.params import TEST_PARAMS_TINY_WIDE as JP

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core import kernels_wop as kw
from concrete_tpu_torch.core import ntt as host
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.core import wop
from concrete_tpu_torch.ops import fused_ntt as fnt
from concrete_tpu_torch.ops import ntt as tn
from concrete_tpu_torch.params import CryptoParams

P = CryptoParams(**dataclasses.asdict(JP))
WP = wop.WopParams(base=P)
JWP = jwop.WopParams(base=JP)
U64 = np.uint64


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=U64).view(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(U64)


@pytest.fixture(scope="module")
def keyset():
    rng = np.random.default_rng(23)
    sk, server = ref.keygen(rng, P)
    wop_keys = wop.pfpksk_gen(rng, sk, WP)
    ksk = kn.pack_ksk(server.ksk, P, device="cpu")
    bsk = kn.pack_bsk(server.bsk, P, device="cpu")
    pfp = kw.pack_pfpksk(wop_keys.pfpksk, WP, device="cpu")
    return rng, sk, server, wop_keys, ksk, bsk, pfp


def _encrypt(rng, sk, msgs, delta):
    return np.stack([ref.lwe_encrypt(rng, sk.lwe_big,
                                     U64(m) << U64(delta), P.lwe_std / 64)
                     for m in msgs])


def test_pack_pfpksk_matches_reference(keyset):
    """The planes equal the JAX package's (the K padding rows zero), and
    the device-style split equals the host's u64_to_balanced_i8, also at
    the carry edges."""
    _, _, _, wop_keys, _, _, pfp = keyset
    want = np.asarray(jkw.pack_pfpksk(wop_keys.pfpksk, JWP).planes)
    got = pfp.planes.numpy()
    assert got.shape[0] % 8 == 0 and got.shape[1] == want.shape[1]
    np.testing.assert_array_equal(got[:want.shape[0]], want)
    assert not got[want.shape[0]:].any()
    edges = np.array([0, 1, 127, 128, 255, 256, 2 ** 63 - 1, 2 ** 63,
                      2 ** 64 - 1, 0x7F7F7F7F7F7F7F7F, 0x8080808080808080,
                      0xFF80FF80FF80FF80], dtype=U64)
    vals = np.concatenate([edges, wop_keys.pfpksk.reshape(-1)[:4096]])
    np.testing.assert_array_equal(kw.split_u64_limbs(_t(vals)).numpy(),
                                  jlb.u64_to_balanced_i8(vals))


def test_private_packing_keyswitch_batch(keyset):
    rng, sk, _, wop_keys, _, _, pfp = keyset
    cts = _encrypt(rng, sk, range(3), 60)
    got = _u(kw.private_packing_keyswitch_batch(_t(cts), pfp))
    for b in range(3):
        for r in range(P.glwe_dimension + 1):
            np.testing.assert_array_equal(
                got[b, r], jwop.private_packing_keyswitch(
                    cts[b], wop_keys.pfpksk[r], JWP.pfks_base_log,
                    JWP.pfks_level))


def test_runtime_primes_cover_the_product():
    """The rule at PIR 32's vertical packing (N=4096, k+1=2, cbs 3 x 2^5)
    is 85 bits and 3 primes; at every shape the product covers the bits
    and one prime fewer would not."""
    assert host.runtime_required_bits(4096, 2, 5, 3) == 85
    assert len(host.runtime_primes(4096, 2, 5, 3)) == 3
    for n, kp1, base, lev in ((256, 2, 6, 3), (256, 2, 9, 3),
                              (8192, 2, 3, 5), (16384, 2, 4, 8)):
        need = host.runtime_required_bits(n, kp1, base, lev)
        primes = host.runtime_primes(n, kp1, base, lev)
        assert int(np.prod([float(p) for p in primes])) >= 2 ** need
        assert np.prod([float(p) for p in primes[:-1]]) < 2.0 ** need
        assert all((p - 1) % (2 * n) == 0 for p in primes)


def test_crt_external_product_keyed_plain_is_the_product():
    """Kernel 3's keyed entry (plain version) gives the residues of each
    ciphertext's exact negacyclic product with the key its index names,
    repeated indices included (the tree phase's shape)."""
    rng = np.random.default_rng(3)
    n, kp1, levels, base = 256, 2, 3, 6
    cin = levels * kp1
    n_keys, b_ct = 3, 5
    primes = host.runtime_primes(n, kp1, base, levels)
    keys = rng.integers(-2 ** 40, 2 ** 40, (n_keys, levels, kp1, kp1, n))
    digits = rng.integers(-2 ** (base - 1), 2 ** (base - 1),
                          (levels, b_ct * kp1, n)).astype(np.int32)
    index = np.array([2, 0, 2, 1, 1], dtype=np.int32)
    spec, sh = tn.ntt_forward_pack(torch.from_numpy(keys.reshape(-1, n)),
                                   primes, cin * kp1, 0)
    got = fnt.crt_external_product_keyed(
        torch.from_numpy(digits), spec, sh, torch.from_numpy(index), primes,
        kp1).numpy()
    for b in range(b_ct):
        for co in range(kp1):
            z = np.zeros(n, dtype=object)
            for lev in range(levels):
                for r in range(kp1):
                    d = digits[lev, b * kp1 + r].astype(object)
                    w = keys[index[b], lev, r, co].astype(object)
                    full = np.convolve(d, w)
                    z += full[:n]
                    z[:n - 1] -= full[n:]
            for pi, p in enumerate(primes):
                np.testing.assert_array_equal(
                    got[pi, b * kp1 + co].astype(np.int64),
                    np.array([int(v) % p for v in z], dtype=np.int64))


def test_external_product_batch_matches_oracle(keyset):
    rng, sk, *_ = keyset
    levels, base = WP.cbs_level, WP.cbs_base_log
    ggsws = np.stack([ref.ggsw_encrypt(rng, sk.glwe, bit, base, levels,
                                       P.glwe_std) for bit in (0, 1)])
    glwes = ref.sample_uniform_u64(rng, (2, P.glwe_dimension + 1,
                                         P.polynomial_size))
    got = _u(kw.external_product_batch(_t(ggsws), _t(glwes), base, levels))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], ref.external_product(ggsws[b], glwes[b], base, levels))


@pytest.mark.parametrize("case", ["packing_keyswitch", "sign_pbs",
                                  "vertical_packing"])
def test_oracle_copy_is_the_reference(keyset, case):
    """The port's copy of the oracle (core/wop.py) gives the JAX package's
    bits on the same inputs."""
    rng, sk, server, wop_keys, *_ = keyset
    ct = _encrypt(rng, sk, [1], 63)[0]
    if case == "packing_keyswitch":
        got = wop.private_packing_keyswitch(ct, wop_keys.pfpksk[1],
                                            WP.pfks_base_log, WP.pfks_level)
        want = jwop.private_packing_keyswitch(
            ct, wop_keys.pfpksk[1], JWP.pfks_base_log, JWP.pfks_level)
    elif case == "sign_pbs":
        got = wop._sign_pbs(ct, server, P, 52)
        want = jwop._sign_pbs(ct, server, JP, 52)
    else:           # nb = 10 at N = 256: the tree phase and the rotations
        ggsws = np.stack([
            ref.ggsw_encrypt(rng, sk.glwe, int(v), WP.cbs_base_log,
                             WP.cbs_level, P.glwe_std)
            for v in rng.integers(0, 2, 10)])
        lut = rng.integers(0, 2 ** 64, 1 << 10, dtype=U64)
        got = wop.vertical_packing(lut, ggsws, WP)
        want = jwop.vertical_packing(lut, ggsws, JWP)
    np.testing.assert_array_equal(got, want)


def test_sign_pbs_batch_matches_oracle(keyset):
    """Per-row scales: the extraction's 63 and a cleaning position, and the
    circuit bootstrap's three levels."""
    rng, sk, server, _, ksk, bsk, _ = keyset
    cts = _encrypt(rng, sk, [0, 1, 1, 0, 1], 63)
    scales = [63, 58, 52, 46, 40]
    got = _u(kw.sign_pbs_batch(_t(cts), ksk, bsk, P, scales))
    for b, s in enumerate(scales):
        np.testing.assert_array_equal(got[b],
                                      jwop._sign_pbs(cts[b], server, JP, s))


def test_extract_bits_batch_matches_oracle(keyset):
    rng, sk, server, _, ksk, bsk, _ = keyset
    p, delta = 6, 57
    msgs = [0b101101, 0b000111, 0b111111]
    cts = _encrypt(rng, sk, msgs, delta)
    got = _u(kw.extract_bits_batch(_t(cts), p, delta, ksk, bsk, P))
    for b in range(len(msgs)):
        np.testing.assert_array_equal(
            got[b], jwop.extract_bits(cts[b], p, delta, server, JP))


def test_extract_bits_to_matches_oracle_cascade(keyset):
    """The lsb cascade against the same cascade of the oracle's sign PBS,
    and its reassembled sum against the requested bits."""
    rng, sk, server, _, ksk, bsk, _ = keyset
    p, delta = 5, 58
    positions, scales = (0, 2, 3), (58, 59, 60)     # output width 5
    msgs = [0b10110, 0b01101]
    cts = _encrypt(rng, sk, msgs, delta)
    got = _u(kw.extract_bits_to(_t(cts), positions, scales, delta, ksk, bsk,
                                P))
    for b, m in enumerate(msgs):
        acc = cts[b].copy()
        want = []
        for i in range(max(positions) + 1):
            pos = delta + i
            shifted = acc * (U64(1) << U64(63 - pos))
            if i in positions:
                want.append(jwop._sign_pbs(shifted, server, JP,
                                           scales[positions.index(i)]))
            if i < max(positions):
                acc = acc - jwop._sign_pbs(shifted, server, JP, pos)
        np.testing.assert_array_equal(got[b], np.stack(want))
        total = got[b].sum(axis=0, dtype=U64)
        assert ref.decode(ref.lwe_decrypt(sk.lwe_big, total), 5) == sum(
            ((m >> q) & 1) << j for j, q in enumerate(positions))


def test_circuit_bootstrap_batch_matches_oracle(keyset):
    rng, sk, server, wop_keys, ksk, bsk, pfp = keyset
    bits = _encrypt(rng, sk, [1, 0, 1, 1], 63).reshape(2, 2, -1)
    got = _u(kw.circuit_bootstrap_batch(_t(bits), ksk, bsk, pfp, WP))
    for b in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                got[b, j], jwop.circuit_bootstrap(bits[b, j], server,
                                                  wop_keys, JWP))


@pytest.mark.parametrize("nb", [6, 10])
def test_vertical_packing_batch_matches_oracle(keyset, nb):
    """nb = 6: the rotation phase alone; nb = 10 at N = 256: two tree bits
    then eight rotations; per-element tables, on the GGSWs' spectra."""
    rng, sk, *_ = keyset
    levels, base = WP.cbs_level, WP.cbs_base_log
    bits = rng.integers(0, 2, (2, nb))
    ggsws = np.stack([np.stack([
        ref.ggsw_encrypt(rng, sk.glwe, int(v), base, levels, P.glwe_std)
        for v in row]) for row in bits])
    lut = rng.integers(0, 2 ** 64, (2, 1 << nb), dtype=U64)
    keys = kw.ggsw_spectra(_t(ggsws), base, levels)
    assert keys.shape == (2, nb)
    got = _u(kw.vertical_packing_batch(_t(lut), keys, WP))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], jwop.vertical_packing(lut[b], ggsws[b], JWP))


def _jax_keys(server, wop_keys):
    return (jkn.pack_ksk(server.ksk, JP), jkn.pack_bsk(server.bsk, JP),
            jkw.pack_pfpksk(wop_keys.pfpksk, JWP))


def test_wop_pbs_batch_matches_reference(keyset):
    """A 7-bit lookup at B=2 through the whole pipeline, bit for bit the
    JAX package's wop_pbs_batch; the decryptions are the table's."""
    rng, sk, server, wop_keys, ksk, bsk, pfp = keyset
    nb, out_bits = 7, 4
    table = np.array([(5 * v + 3) % 16 for v in range(1 << nb)],
                     dtype=np.int64)
    msgs = [93, 6]
    cts = _encrypt(rng, sk, msgs, 63 - nb)
    got = _u(kw.wop_pbs_batch(_t(cts), table, nb, 63 - nb, out_bits, ksk,
                              bsk, pfp, WP))
    jksk, jbsk, jpfp = _jax_keys(server, wop_keys)
    want = np.asarray(jkw.wop_pbs_batch(cts, table, nb, 63 - nb, out_bits,
                                        jksk, jbsk, jpfp, JWP))
    np.testing.assert_array_equal(got, want)
    dec = [ref.decode(ref.lwe_decrypt(sk.lwe_big, c), out_bits) for c in got]
    assert dec == [int(table[m]) for m in msgs]


def test_wop_pbs_crt_batch_matches_reference(keyset):
    """The CRT lookup at moduli (3, 4, 5), B=2, bit for bit the JAX
    package's wop_pbs_crt_batch, and the residues of the table's value."""
    rng, sk, server, wop_keys, ksk, bsk, pfp = keyset
    moduli = (3, 4, 5)
    bits = wop.crt_block_bits(moduli)
    table = np.array([(v * v) % 60 for v in range(60)], dtype=np.int64)
    xs = [29, 58]
    res = np.stack([np.stack([
        ref.lwe_encrypt(rng, sk.lwe_big, U64(x % m) << U64(63 - nb),
                        P.lwe_std / 64) for m, nb in zip(moduli, bits)])
        for x in xs], axis=1)                     # (blocks, B, n+1)
    luts = wop.crt_lut_tables(table, moduli)
    got = _u(kw.wop_pbs_crt_batch(_t(res), luts, moduli, ksk, bsk, pfp, WP))
    jksk, jbsk, jpfp = _jax_keys(server, wop_keys)
    want = np.asarray(jkw.wop_pbs_crt_batch(res, luts, moduli, jksk, jbsk,
                                            jpfp, JWP))
    np.testing.assert_array_equal(got, want)
    for b, x in enumerate(xs):
        dec = [ref.decode(ref.lwe_decrypt(sk.lwe_big, got[j, b]), bits[j])
               for j in range(len(moduli))]
        assert dec == [int(table[x]) % m for m in moduli]


@pytest.mark.parametrize("batch", [1, 2])
def test_wop_pbs_batch_queue3_shapes_match_oracle(keyset, batch):
    """The shapes that crashed the JAX package's acc32 kernels (cbs_base_log
    9, cbs_level 3: two digit limbs, three levels; small batches) against
    the oracle and the table."""
    rng, sk, server, wop_keys, ksk, bsk, pfp = keyset
    gadgets = dict(cbs_level=3, cbs_base_log=9, pfks_level=8,
                   pfks_base_log=4)
    wp = wop.WopParams(base=P, **gadgets)
    nb, out_bits = 4, 4
    table = np.array([(7 * v + 2) % 16 for v in range(1 << nb)],
                     dtype=np.int64)
    msgs = [13, 2][:batch]
    cts = _encrypt(rng, sk, msgs, 63 - nb)
    got = _u(kw.wop_pbs_batch(_t(cts), table, nb, 63 - nb, out_bits, ksk,
                              bsk, pfp, wp))
    for b, m in enumerate(msgs):
        np.testing.assert_array_equal(
            got[b], jwop.wop_pbs(cts[b], table, nb, 63 - nb, out_bits,
                                 server, wop_keys,
                                 jwop.WopParams(base=JP, **gadgets)))
        assert ref.decode(ref.lwe_decrypt(sk.lwe_big, got[b]),
                          out_bits) == table[m]


def test_chunks_give_the_same_bits(keyset, monkeypatch):
    """A chunk budget of one element runs the circuit bootstrap and the
    vertical packings chunk by chunk, with the bits of one batch; each
    chunk's GGSWs are transformed once for both tables."""
    rng, sk, server, wop_keys, ksk, bsk, pfp = keyset
    nb = 5
    luts = [kw.lut_torus(np.arange(1 << nb, dtype=np.int64) % 8, 3, "cpu"),
            kw.lut_torus(np.arange(1 << nb, dtype=np.int64)[::-1] % 8, 3,
                         "cpu")]
    bits = _t(_encrypt(rng, sk, [1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1],
                       63)).view(3, nb, -1)
    packs = []
    spectra = kw.ggsw_spectra

    def counted(ggsws, *args):
        packs.append(ggsws.shape[0])
        return spectra(ggsws, *args)
    monkeypatch.setattr(kw, "ggsw_spectra", counted)
    whole = kw._cbs_vp_chunked(bits, luts, ksk, bsk, pfp, WP)
    assert whole.shape == (2, 3, P.n_big + 1) and packs == [3]
    monkeypatch.setenv("CONCRETE_TPU_WOP_CHUNK_MB", "0")
    assert kw.chunk_size(WP, nb) == 1
    np.testing.assert_array_equal(
        kw._cbs_vp_chunked(bits, luts, ksk, bsk, pfp, WP).numpy(),
        whole.numpy())
    assert packs == [3, 1, 1, 1]


def test_memory_refusal_before_any_allocation(monkeypatch):
    """The 12-bit lookup at N=16384, cbs_level 8 (the JAX package's 100 GB
    host-RSS fault) is refused with its estimate; nothing is allocated.
    The estimate counts the PFPKSK generated on the device: its u64 key
    beside the packed one, and the generation's Toeplitz matrix (2 GiB
    of f64 at N=16384) and chunk."""
    params = dataclasses.replace(P, n_small=900, glwe_dimension=1,
                                 polynomial_size=16384)
    wp = wop.WopParams(base=params, cbs_level=8, cbs_base_log=4,
                       pfks_level=4, pfks_base_log=8)
    est = kw.wop_memory_estimate(wp, 12, 64)
    assert est["chunk"] > 1 << 30 and est["pfpksk"] > 8 << 30
    rows = 2 * (params.n_big + 1) * 4
    assert est["pfpksk_u64"] == rows * 2 * 16384 * 8
    assert est["keygen"] > 16384 * 16384 * 8
    assert est["total"] == est["chunk"] + est["pfpksk"] \
        + est["pfpksk_u64"] + est["keygen"]

    def no_alloc(*args, **kwargs):
        raise AssertionError("allocated")
    monkeypatch.setattr(torch, "zeros", no_alloc)
    monkeypatch.setattr(torch, "empty", no_alloc)
    with pytest.raises(MemoryError, match=str(est["total"])):
        kw.check_wop_memory(wp, 12, 64, "cpu", free_bytes=64 << 30)
    assert kw.check_wop_memory(wp, 12, 64, "cpu",
                               free_bytes=est["total"]) == est


# -- the acc32 message-scale gate (ROADMAP queue 3) --------------------------

GATE_P = CryptoParams(n_small=8, glwe_dimension=1, polynomial_size=2048,
                      pbs_level=1, pbs_base_log=20, ks_level=2,
                      ks_base_log=10, lwe_std=2.0 ** -40,
                      glwe_std=2.0 ** -50, security_level=0)


def test_acc32_gate_rule():
    assert fnt.acc32_min_scale_log(822) == 55        # PIR 32's n_small
    assert fnt.acc32_min_scale_log(8) == 49
    bsk = fnt.FusedBSK(spec_val=torch.zeros(822, 1, 1),
                       spec_sh=torch.zeros(822, 1, 1), primes=(3,),
                       trunc_bits=0, base_log=14, levels=2)
    assert fnt.acc32_eligible(bsk) and fnt.acc32_eligible(bsk, 55)
    assert not fnt.acc32_eligible(bsk, 54)
    deep = dataclasses.replace(bsk, levels=3)        # 42 bits: never
    assert not fnt.acc32_eligible(deep) and not fnt.acc32_eligible(deep, 63)


def test_acc32_gate_on_a_fused_key():
    """A deep scale on an N=2048 fused key runs the exact mode and equals
    the oracle's sign PBS; a native scale keeps acc32 and equals
    blind_rotate_acc32_oracle, as a lookup with no scale does."""
    from concrete_tpu.ops.pallas_fused_ntt import blind_rotate_acc32_oracle
    rng = np.random.default_rng(7)
    sk, server = ref.keygen(rng, GATE_P)
    primes = host.special_ntt_primes(2048, 128)[:4]
    fb = fnt.pack_bsk_fused(server.bsk, GATE_P, primes=primes, trunc_bits=0,
                            device="cpu")
    ksk = kn.pack_ksk(server.ksk, GATE_P, device="cpu")
    cts = _encrypt_p(rng, sk, [1, 0])
    deep = _u(kw.sign_pbs_batch(_t(cts), ksk, fb, GATE_P, [40, 44]))
    jp = JParams(**dataclasses.asdict(GATE_P))
    for b, s in enumerate((40, 44)):
        np.testing.assert_array_equal(
            deep[b], jwop._sign_pbs(cts[b], server, jp, s))
    native = _u(kw.sign_pbs_batch(_t(cts), ksk, fb, GATE_P, [63, 63]))
    half = U64(1) << U64(62)
    for b in range(2):
        ct = cts[b].copy()
        ct[-1] += half
        small = ref.keyswitch(ct, server.ksk, GATE_P.ks_base_log,
                              GATE_P.ks_level)
        test_poly = np.full(GATE_P.polynomial_size, U64(0) - half, dtype=U64)
        acc = blind_rotate_acc32_oracle(small, server.bsk, test_poly, jp,
                                        primes, 0)
        want = ref.sample_extract(np.asarray(acc, dtype=U64), 0)
        want[-1] += half
        np.testing.assert_array_equal(native[b], want)
        lookup = kn.blind_rotate(_t(small[None]), fb,
                                 _t(test_poly), GATE_P)
        np.testing.assert_array_equal(_u(lookup)[0], acc)


def _encrypt_p(rng, sk, bits):
    return np.stack([jref.lwe_encrypt(rng, sk.lwe_big, U64(b) << U64(63),
                                      GATE_P.lwe_std) for b in bits])
