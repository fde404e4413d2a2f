"""``kvdb32``: Concrete's key-value database (examples/key_value_database,
the static-size database): a query by an encrypted 32-bit key over an
encrypted state of E rows, compiled by the port's ``fhe.compiler`` at the
default ``Configuration()`` through ``models.KeyValueDatabase``."""

import numpy as np

KEY_BITS = VALUE_BITS = 32
CHUNK_BITS = 4
#: the share of queries whose key a row holds
HIT_SHARE = 0.75


def build(shape, configuration=None, device=None):
    from concrete_tpu_torch.models import KeyValueDatabase
    return KeyValueDatabase(int(shape[0])).compile(configuration,
                                                   device=device)


def chunks(numbers, bits: int) -> np.ndarray:
    """Each number's CHUNK_BITS-bit chunks, most significant first."""
    numbers = np.asarray(numbers, dtype=np.uint64)[..., None]
    shifts = np.arange(bits - CHUNK_BITS, -1, -CHUNK_BITS, dtype=np.uint64)
    return ((numbers >> shifts) & np.uint64((1 << CHUNK_BITS) - 1)).astype(
        np.int64)


def draw(rng, shape):
    """One database of E distinct keys and uniform values, every row
    occupied, and a query key: a row's key with probability HIT_SHARE,
    else one no row holds."""
    entries = int(shape[0])
    keys = rng.choice(1 << KEY_BITS, entries + 1, replace=False)
    values = rng.integers(0, 1 << VALUE_BITS, entries, dtype=np.uint64)
    state = np.concatenate([np.ones((entries, 1), dtype=np.int64),
                            chunks(keys[:-1], KEY_BITS),
                            chunks(values, VALUE_BITS)], axis=1)
    hit = rng.random() < HIT_SHARE
    key = keys[rng.integers(0, entries)] if hit else keys[-1]
    return state, chunks(key, KEY_BITS)


def blind_rotates(shape):
    """(count, batch) of the blind rotates one request runs: the chunks'
    equalities, the rows' matches, the selected values."""
    entries = int(shape[0])
    chunks_a_key = KEY_BITS // CHUNK_BITS
    return [(1, chunks_a_key * entries), (1, entries),
            (1, (VALUE_BITS // CHUNK_BITS) * entries)]


def output_check(keyset, shape):
    """A well-formed output: one u64 array of 1 + 8 ciphertexts, the
    matches' count and the value's chunks, whatever the state's shape."""
    want = (1 + VALUE_BITS // CHUNK_BITS,
            keyset["glwe_dimension"] * keyset["polynomial_size"] + 1)

    def check(out) -> bool:
        return (isinstance(out, np.ndarray) and out.dtype == np.uint64
                and out.shape == want)
    return check
