"""Key generation for real-size parameters.

A copy of ``concrete_tpu/core/keygen.py``'s functions: the same seed gives
the same keys in both packages, the seeded keyset of ``keygen_seeded``
included.  The whole keyset is ``keygen_device``; the host-only numpy
functions (``glwe_encrypt_batch``, ``make_bsk``, ``_negacyclic_dot_with_key``)
stay as its plain versions, which the tests and the smoke hold it to.

Functionally identical to refimpl.keygen (which stays the oracle for tiny
parameters) but vectorized: the GLWE body polynomials  sum_r A_r (*) S_r  are
exact f64 matmuls over 16-bit mask limbs against the binary key's
negacyclic Toeplitz matrix (see _negacyclic_dot_with_key).

Reference analog: lib/Common/Keys.cpp:59,115,239 (concrete-cpu keygen calls,
with rayon parallelism); here the batch axis is the vector axis.

Randomness: the functions take any numpy-Generator-compatible source; the
production path (compilation/keys.py Keys.generate) passes the ChaCha20
SecureGenerator (concrete_tpu/utils/csprng.py; reference: concrete-cpu
c_api/csprng.rs).  numpy Generators appear only in tests/oracles.

The device path (``glwe_encrypt_batch_device``, ``make_bsk_device``,
``keygen_device``; ``core/wop.pfpksk_gen_device``) computes the same keys
bit for bit with the product on a torch device: the uniform and Gaussian
draws stay on the host's generator, in its order, and the rows stream to
the device in chunks.  The draws are seeks into the regions the whole
batch's two draws would have read (``ChaCha20Stream.reserve``), so worker
threads make the noise, then the next chunks' masks while the device
multiplies this one.  The product is the host's own scheme as a ``torch.matmul`` in f64
on 16-bit mask limbs against the key's {-1, 0, 1} Toeplitz matrix, built
on the device: exact in any summation order (|partial sums| <= N 2^16 <
2^53), and on the CPU the same BLAS dgemm as the numpy version.  The
messages are made on the device, a chunk at a time, and the result stays
there as an int64 tensor.
"""

from __future__ import annotations

import collections
import contextvars
import os

import numpy as np
import torch

from concrete_tpu_torch.core.refimpl import (SecretKeys, ServerKeys,
                                       sample_binary_key,
                                       sample_torus_gaussian,
                                       sample_uniform_u64)
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils import telemetry as tm


def _negacyclic_dot_with_key(a_polys: np.ndarray, key: np.ndarray) -> np.ndarray:
    """sum_r a_polys[..., r, :] (*) key[r, :]  mod 2^64, exactly — jit-free.

    a_polys: (rows, k, N) u64; key: (k, N) binary u64.

    Host-side exact path: the binary key's negacyclic Toeplitz matrix has
    entries in {-1, 0, 1}, so splitting the u64 masks into four 16-bit limbs
    makes every BLAS f64 matmul exact (|partial sums| <= N * 2^16 << 2^53),
    and the limb recombination wraps mod 2^64 in u64.  This keeps keygen
    off the device entirely — no jit, no compile latency (the device keygen
    graph used to dominate keyset generation time).
    """
    rows, k, n = a_polys.shape
    j = np.arange(n)
    # M[t, j] = key[(j - t) mod n] with a sign flip where j < t (negacyclic)
    idx = (j[None, :] - j[:, None]) % n
    sign = np.where(j[None, :] >= j[:, None], 1.0, -1.0)
    out = np.zeros((rows, n), dtype=np.uint64)
    for r in range(k):
        m = key[r].astype(np.float64)[idx] * sign          # (N, N) in {-1,0,1}
        a_r = a_polys[:, r, :]
        for i in range(4):
            limb = ((a_r >> np.uint64(16 * i))
                    & np.uint64(0xFFFF)).astype(np.float64)
            c = limb @ m                                   # exact in f64
            out += c.astype(np.int64).astype(np.uint64) << np.uint64(16 * i)
    return out


def glwe_encrypt_batch(rng: np.random.Generator, gsk: np.ndarray,
                       m_polys: np.ndarray, std: float) -> np.ndarray:
    """Batched GLWE encryption: m_polys (rows, N) -> (rows, k+1, N)."""
    k, n = gsk.shape
    rows = m_polys.shape[0]
    a = sample_uniform_u64(rng, (rows, k, n))
    e = sample_torus_gaussian(rng, std, (rows, n))
    body = _negacyclic_dot_with_key(a, gsk) + m_polys + e
    return np.concatenate([a, body[:, None, :]], axis=1)


# ---------------------------------------------------------------------------
# The device path: the same keys, the product on a torch device
# ---------------------------------------------------------------------------

#: masks a chunk of the device path, in u64 words (64 MB): the unit of the
#: host's draw threads and of the device's product
CHUNK_WORDS = 1 << 23


def negacyclic_matrix(key_row: torch.Tensor) -> torch.Tensor:
    """The (N, N) f64 matrix M of a binary key polynomial on its device,
    M[t, j] = key[j - t] for j >= t and -key[j - t + N] below, so that
    a @ M is a (*) key mod X^N + 1: ``_negacyclic_dot_with_key``'s matrix,
    built as windows of [-key, key] rather than by a gather."""
    n = key_row.shape[0]
    k = key_row.to(torch.float64)
    ext = torch.cat([-k, k])            # ext[N + d]: key[d], or -key[N + d]
    return ext.unfold(0, n, 1).flip(0)[:n].contiguous()


def negacyclic_dot_torch(masks: torch.Tensor, key) -> torch.Tensor:
    """sum_r masks[:, r, :] (*) key[r, :]  mod 2^64, exactly, on masks'
    device: (rows, k, N) int64 (u64 bits) -> (rows, N) int64.  `key` is the
    (k, N) binary key, or the list of its ``negacyclic_matrix`` rows.
    The torch counterpart of ``_negacyclic_dot_with_key`` (its plain
    version): four f64 matmuls a key row on the masks' 16-bit limbs."""
    rows, k, n = masks.shape
    mats = key if isinstance(key, (list, tuple)) else [
        negacyclic_matrix(torch.as_tensor(
            np.asarray(key[r], dtype=np.int64)).to(masks.device))
        for r in range(k)]
    out = torch.zeros((rows, n), dtype=torch.int64, device=masks.device)
    for r in range(k):
        a = masks[:, r, :]
        limbs = torch.stack([(a >> (16 * i)) & 0xFFFF for i in range(4)])
        c = (limbs.to(torch.float64).view(4 * rows, n) @ mats[r]).view(
            4, rows, n).to(torch.int64)         # exact: |c| <= N 2^16
        for i in range(4):
            out += c[i] << (16 * i)
    return out


class GlweDraws:
    """The uniform masks and Gaussian noise of ``glwe_encrypt_batch``
    over `rows` GLWE rows, bit for bit as its one call draws them: masks
    (rows, k, N) first, then ``normal((rows, N))``, whose Box-Muller reads
    (2, m) words u, m = ceil(rows N / 2), and gives sample i < m from
    u[0][i], u[1][i] by cos and sample m + i from the same two words by
    sin.  On a SecureGenerator both regions are reserved here, so the
    generator stands where the one call would leave it; ``fill_noise``
    then makes the noise over ranges of i on worker threads (each word
    read once, its two samples from one log), and ``draw`` seeks a chunk
    of rows' masks.  Any other generator draws the whole batch now."""

    def __init__(self, rng, rows: int, k: int, n: int, std: float):
        self.rows, self.k, self.n, self.std = rows, k, n, std
        self.m = (rows * n + 1) // 2
        stream = getattr(rng, "stream", None)
        if stream is not None and hasattr(stream, "reserve"):
            self.stream = stream
            self.masks_at = stream.reserve(8 * rows * k * n)
            self.normal_at = stream.reserve(16 * self.m)
            self.noise = np.empty(rows * n, dtype=np.int64)
        else:
            self.stream = None
            self.masks = sample_uniform_u64(rng, (rows, k, n))
            self.noise = sample_torus_gaussian(
                rng, std, (rows * n,)).view(np.int64)

    def _noise(self, lo: int, hi: int) -> None:
        """Samples lo..hi and m+lo..m+hi (those below rows N): the
        arithmetic of SecureGenerator.normal and sample_torus_gaussian on
        words lo..hi of each half of u."""
        m, total = self.m, self.rows * self.n
        words = self.stream.words_at
        u1 = words(self.normal_at, lo, hi - lo).astype(np.float64) / 2.0 ** 64
        u2 = words(self.normal_at, m + lo, hi - lo).astype(
            np.float64) / 2.0 ** 64
        r = np.sqrt(-2.0 * np.log(np.clip(u1, 1e-300, 1.0)))
        t = 2 * np.pi * u2
        self.noise[lo:hi] = np.round(
            (0.0 + self.std * (r * np.cos(t))) * 2.0 ** 64).astype(np.int64)
        top = min(hi, total - m)
        if lo < top:
            z = r[:top - lo] * np.sin(t[:top - lo])
            self.noise[m + lo:m + top] = np.round(
                (0.0 + self.std * z) * 2.0 ** 64).astype(np.int64)

    def fill_noise(self, pool) -> float:
        """Every sample, over ranges of half a chunk of words on `pool`'s
        threads; returns the threads' seconds."""
        if self.stream is None:
            return 0.0

        def timed(lo, hi):
            with tm.timed("keygen.draws", words=hi - lo) as t:
                self._noise(lo, hi)
            return t.seconds
        step = max(1, CHUNK_WORDS // 2)
        return sum(f.result() for f in [
            pool.submit(contextvars.copy_context().run, timed, lo,
                        min(lo + step, self.m))
            for lo in range(0, self.m, step)])

    def draw(self, r0: int, r1: int):
        """(masks (r1-r0, k, N) u64, noise (r1-r0, N) int64) of rows
        r0..r1 (the noise made by ``fill_noise``)."""
        k, n = self.k, self.n
        e = self.noise[r0 * n:r1 * n].reshape(r1 - r0, n)
        if self.stream is None:
            return self.masks[r0:r1], e
        a = self.stream.words_at(self.masks_at, r0 * k * n,
                                 (r1 - r0) * k * n).reshape(r1 - r0, k, n)
        return a, e


def glwe_encrypt_batch_device(rng, gsk: np.ndarray, rows: int, messages,
                              std: float, device,
                              timings: dict = None) -> torch.Tensor:
    """``glwe_encrypt_batch`` with the product on `device`: (rows, k+1, N)
    int64 there, bit for bit the host's from the same generator.
    `messages(r0, r1)` gives rows r0..r1's message polynomials as an int64
    (r1-r0, N) tensor on `device`.  Worker threads make the noise
    (``GlweDraws.fill_noise``), then draw chunks of ``CHUNK_WORDS`` of
    masks (whole rows) a few chunks ahead of the device.  `timings` gains
    the draws' seconds (summed over the threads: the ``keygen.draws``
    spans), the product's (uploads, product, messages and noise added, on
    the main thread: the ``keygen.product`` spans) and the wall (the
    ``keygen.encrypt`` span)."""
    from concurrent.futures import ThreadPoolExecutor
    device = torch.device(device)
    k, n = gsk.shape
    with tm.timed("keygen.encrypt", rows=rows) as wall:
        draws = GlweDraws(rng, rows, k, n, std)
        chunk_rows = max(1, CHUNK_WORDS // (k * n))
        spans = [(lo, min(lo + chunk_rows, rows))
                 for lo in range(0, rows, chunk_rows)]
        draw_s = [0.0]

        def timed_draw(r0, r1):
            with tm.timed("keygen.draws", rows=r1 - r0) as t:
                out = draws.draw(r0, r1)
            draw_s.append(t.seconds)               # list.append: atomic
            return out

        def submit(r0, r1):
            # the draw threads' spans are children of this one
            return pool.submit(contextvars.copy_context().run, timed_draw,
                               r0, r1)

        with tm.timed("keygen.product") as t:
            mats = [negacyclic_matrix(torch.from_numpy(
                np.asarray(gsk[r], dtype=np.int64)).to(device))
                for r in range(k)]
            out = torch.empty((rows, k + 1, n), dtype=torch.int64,
                              device=device)
        product_s = t.seconds
        workers = min(os.cpu_count() or 1, 8)
        with ThreadPoolExecutor(workers) as pool:
            draw_s.append(draws.fill_noise(pool))
            pending = collections.deque()
            todo = iter(spans)
            for span in todo:
                pending.append((span, submit(*span)))
                if len(pending) > workers:
                    break
            while pending:
                (r0, r1), fut = pending.popleft()
                a, e = fut.result()
                span = next(todo, None)
                if span is not None:
                    pending.append((span, submit(*span)))
                with tm.timed("keygen.product", rows=r1 - r0) as t:
                    a_t = torch.from_numpy(a.view(np.int64)).to(device)
                    body = negacyclic_dot_torch(a_t, mats)
                    body += messages(r0, r1)
                    body += torch.from_numpy(e).to(device)
                    out[r0:r1, :k] = a_t
                    out[r0:r1, k] = body
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                product_s += t.seconds
    if timings is not None:
        timings["draws_s"] = timings.get("draws_s", 0.0) + sum(draw_s)
        timings["product_s"] = timings.get("product_s", 0.0) + product_s
        timings["wall_s"] = timings.get("wall_s", 0.0) + wall.seconds
    return out


def gadget_i64(base_log: int, levels: int) -> torch.Tensor:
    """The gadget g_j = 2^(64 - (j+1) base_log), j < levels, as int64
    (u64 bits)."""
    return torch.from_numpy(np.array(
        [1 << (64 - (j + 1) * base_log) for j in range(levels)],
        dtype=np.uint64).view(np.int64))


def make_bsk_device(rng, sk_small: np.ndarray, gsk: np.ndarray,
                    params: CryptoParams, device,
                    timings: dict = None) -> torch.Tensor:
    """``make_bsk`` with the bodies' product on `device`: (n, l, k+1, k+1,
    N) int64 there, bit for bit the host's.  Row ((i l + j)(k+1) + r)
    encrypts -s_i S_r g_j (r < k) or s_i g_j at X^0 (r = k); the rows'
    messages are made on the device, a chunk at a time."""
    device = torch.device(device)
    n_small = params.n_small
    k, n = gsk.shape
    l = params.pbs_level
    s = torch.from_numpy(np.asarray(sk_small, dtype=np.int64)).to(device)
    keys = torch.cat([torch.from_numpy(np.asarray(gsk, dtype=np.int64)),
                      torch.zeros((1, n), dtype=torch.int64)]).to(device)
    g = gadget_i64(params.pbs_base_log, l).to(device)

    def messages(r0, r1):
        q = torch.arange(r0, r1, device=device)
        i, j, r = q // (l * (k + 1)), (q // (k + 1)) % l, q % (k + 1)
        coef = s[i] * g[j]
        msgs = -coef[:, None] * keys[r]                  # zero at r = k
        msgs[:, 0] += torch.where(r == k, coef, 0)
        return msgs

    rows = n_small * l * (k + 1)
    cts = glwe_encrypt_batch_device(rng, gsk, rows, messages,
                                    params.glwe_std, device, timings=timings)
    return cts.view(n_small, l, k + 1, k + 1, n)


def keygen_device(rng, params: CryptoParams, device, glwe_key=None,
                  timings: dict = None) -> tuple[SecretKeys, ServerKeys]:
    """The (client, server) keyset with the BSK's bodies on `device`: the
    JAX package's ``keygen`` draws in the same order, so the same keys from
    the same generator (`glwe_key` injects a shared big/GLWE key, as
    there: TFHE-rs interop, the BSK and KSK made from it); the BSK comes
    back to the host (u64), as ``ServerKeys`` holds it.  `timings` gains
    the BSK's parts (``glwe_encrypt_batch_device``), its copy to the host
    and the KSK's seconds (host numpy)."""
    sk_small = sample_binary_key(rng, (params.n_small,))
    if glwe_key is None:
        gsk = sample_binary_key(
            rng, (params.glwe_dimension, params.polynomial_size))
    else:
        gsk = np.asarray(glwe_key, dtype=np.uint64).reshape(
            params.glwe_dimension, params.polynomial_size)
    sk = SecretKeys(lwe_small=sk_small, glwe=gsk)
    timings = {} if timings is None else timings
    bsk_dev = make_bsk_device(rng, sk_small, gsk, params, device,
                              timings=timings)
    with tm.timed("keygen.to_host") as t:
        bsk = bsk_dev.cpu().numpy().view(np.uint64)
        del bsk_dev
    timings["to_host_s"] = t.seconds
    with tm.timed("keygen.ksk") as t:
        ksk = make_ksk(rng, sk.lwe_big, sk_small, params.ks_base_log,
                       params.ks_level, params.lwe_std)
    timings["ksk_s"] = t.seconds
    return sk, ServerKeys(bsk=bsk, ksk=ksk)


def make_bsk(rng: np.random.Generator, sk_small: np.ndarray, gsk: np.ndarray,
             params: CryptoParams) -> np.ndarray:
    """Bootstrap key: GGSW(s_i) for each small-key bit, (n, l, k+1, k+1, N)."""
    n_small = params.n_small
    k, n = gsk.shape
    l = params.pbs_level
    # message polys for every (i, level j, row r): r<k: -s_i*S_r*g_j; r=k: s_i*g_j
    msgs = np.zeros((n_small, l, k + 1, n), dtype=np.uint64)
    for j in range(l):
        g = np.uint64(1) << np.uint64(64 - (j + 1) * params.pbs_base_log)
        for r in range(k):
            msgs[:, j, r, :] = ((-(sk_small[:, None].astype(np.int64))
                                 * gsk[r].astype(np.int64)).astype(np.uint64)
                                * g)
        msgs[:, j, k, 0] = sk_small * g
    flat = msgs.reshape(n_small * l * (k + 1), n)
    cts = glwe_encrypt_batch(rng, gsk, flat, params.glwe_std)
    return cts.reshape(n_small, l, k + 1, k + 1, n)


def make_ksk(rng: np.random.Generator, sk_in: np.ndarray, sk_out: np.ndarray,
             base_log: int, levels: int, std: float) -> np.ndarray:
    """Keyswitch key (n_in, l, n_out+1), batched LWE encryptions."""
    n_in = sk_in.shape[0]
    n_out = sk_out.shape[0]
    g = (np.uint64(1) << (np.uint64(64) - np.uint64(base_log)
                          * np.arange(1, levels + 1, dtype=np.uint64)))
    msgs = sk_in[:, None] * g[None, :]                        # (n_in, l)
    a = sample_uniform_u64(rng, (n_in, levels, n_out))
    e = sample_torus_gaussian(rng, std, (n_in, levels))
    body = (a * sk_out).sum(axis=-1, dtype=np.uint64) + msgs + e
    return np.concatenate([a, body[..., None]], axis=-1)


def keygen_seeded(rng_noise, params: CryptoParams, seed: bytes = None):
    """Seeded keygen: evaluation-key masks come from a ChaCha20 stream so the
    server keyset ships as seed + bodies (reference seeded keygen,
    concrete-cpu c_api `concrete_cpu_init_seeded_*`).

    Returns (SecretKeys, SeededServerKeys); rng_noise supplies secret keys
    and gaussian noise only.
    """
    import os

    from concrete_tpu_torch.core.compression import SeededServerKeys
    from concrete_tpu_torch.utils.csprng import ChaCha20Stream

    if seed is None:
        seed = os.urandom(32)
    sk_small = sample_binary_key(rng_noise, (params.n_small,))
    gsk = sample_binary_key(rng_noise,
                            (params.glwe_dimension, params.polynomial_size))
    sk = SecretKeys(lwe_small=sk_small, glwe=gsk)

    k, n = gsk.shape
    l = params.pbs_level
    n_small = params.n_small
    stream = ChaCha20Stream(seed=seed)

    # BSK bodies: same message layout as make_bsk, masks from the stream
    msgs = np.zeros((n_small, l, k + 1, n), dtype=np.uint64)
    for j in range(l):
        g = np.uint64(1) << np.uint64(64 - (j + 1) * params.pbs_base_log)
        for r in range(k):
            msgs[:, j, r, :] = ((-(sk_small[:, None].astype(np.int64))
                                 * gsk[r].astype(np.int64)).astype(np.uint64)
                                * g)
        msgs[:, j, k, 0] = sk_small * g
    rows = n_small * l * (k + 1)
    a = stream.random_u64((n_small, l, k + 1, k, n)).reshape(rows, k, n)
    e = sample_torus_gaussian(rng_noise, params.glwe_std, (rows, n))
    bodies = (_negacyclic_dot_with_key(a, gsk) + msgs.reshape(rows, n) + e)
    bsk_bodies = bodies.reshape(n_small, l, k + 1, n)

    # KSK bodies
    n_big = params.n_big
    ks_l = params.ks_level
    g = (np.uint64(1) << (np.uint64(64) - np.uint64(params.ks_base_log)
                          * np.arange(1, ks_l + 1, dtype=np.uint64)))
    ks_msgs = sk.lwe_big[:, None] * g[None, :]
    ks_a = stream.random_u64((n_big, ks_l, n_small))
    ks_e = sample_torus_gaussian(rng_noise, params.lwe_std, (n_big, ks_l))
    ksk_bodies = ((ks_a * sk_small).sum(axis=-1, dtype=np.uint64)
                  + ks_msgs + ks_e)

    return sk, SeededServerKeys(
        seed=seed, bsk_bodies=bsk_bodies, ksk_bodies=ksk_bodies,
        n_small=n_small, glwe_dimension=k, polynomial_size=n,
        pbs_level=l, ks_level=ks_l)


def encrypt_lwe_batch(rng: np.random.Generator, sk_flat: np.ndarray,
                      m_torus: np.ndarray, std: float) -> np.ndarray:
    """Batched LWE encryption under a flat key: (B,) torus -> (B, n+1)."""
    n = sk_flat.shape[0]
    m_torus = np.asarray(m_torus, dtype=np.uint64)
    a = sample_uniform_u64(rng, m_torus.shape + (n,))
    e = sample_torus_gaussian(rng, std, m_torus.shape)
    with np.errstate(over="ignore"):     # u64 wraps; a 0-d sum warns
        body = (a * sk_flat).sum(axis=-1, dtype=np.uint64) + m_torus + e
    return np.concatenate([a, body[..., None]], axis=-1)
