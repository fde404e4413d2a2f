"""``tlu4``: table[x] - y over encrypted 4-bit x and y, compiled by the
port's ``fhe.compiler`` at the default ``Configuration()``."""

import numpy as np

TABLE = [(3 * v + 1) % 16 for v in range(16)]


def inputset(shape):
    """tools/make_torch_fixture.py's inputset (four pairs of 1,024 values
    drawn from default_rng(0), then a ramp), flattened and cut into samples
    of `shape`, the last one filled from the start."""
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 16, 1024), rng.integers(0, 16, 1024))
             for _ in range(4)]
    ramp = np.arange(1024) % 16
    pairs.append((ramp, ramp))
    xs = np.concatenate([x for x, _ in pairs])
    ys = np.concatenate([y for _, y in pairs])
    size = int(np.prod(shape))
    rows = -(-xs.size // size)
    xs = np.resize(xs, (rows,) + tuple(shape))
    ys = np.resize(ys, (rows,) + tuple(shape))
    return list(zip(xs, ys))


def build(shape, configuration=None, device=None):
    import concrete_tpu_torch as fhe
    table = fhe.LookupTable(TABLE)

    @fhe.compiler({"x": "encrypted", "y": "encrypted"})
    def table_sub(x, y):
        return table[x] - y

    return table_sub.compile(inputset(shape), configuration, device=device)


def draw(rng, shape):
    return rng.integers(0, 16, shape), rng.integers(0, 16, shape)


def blind_rotates(shape):
    """(count, batch) of the blind rotates one request runs."""
    return [(1, int(np.prod(shape)))]
