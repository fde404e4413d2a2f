"""The clear function of ``tlu4``: table[x] - y over 4-bit x and y, with
the table (3v + 1) % 16."""

import numpy as np

TABLE = np.array([(3 * v + 1) % 16 for v in range(16)], dtype=np.int64)


def clear(x, y) -> np.ndarray:
    return TABLE[np.asarray(x, dtype=np.int64)] - np.asarray(y, np.int64)
