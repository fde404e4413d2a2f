"""The clear function of ``kvdb32``: the key-value database's query over a
state of rows [flag | 8 key chunks | 8 value chunks] and a key of 8
chunks: the number of rows whose key chunks all equal the key's, then the
sums of those rows' value chunks."""

import numpy as np

KEY_CHUNKS = 8


def clear(state, key) -> np.ndarray:
    state = np.asarray(state, dtype=np.int64)
    keys = state[:, 1:1 + KEY_CHUNKS]
    values = state[:, 1 + KEY_CHUNKS:]
    hit = np.all(keys == np.asarray(key, dtype=np.int64), axis=1)
    return np.concatenate([[hit.sum()], values[hit].sum(axis=0)]).astype(
        np.int64)
