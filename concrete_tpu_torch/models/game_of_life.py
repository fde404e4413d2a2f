"""Encrypted Conway's Game of Life.

Reference workload: frontends/concrete-python/benchmarks/game_of_life.py.
One step: neighbor count is a leveled sum; the life rule is one TLU over the
packed (count, alive) value via fhe.multivariate.

Counterpart of ``concrete_tpu/models/game_of_life.py``: the same traced function, so
both packages compile it to the same circuit; ``compile`` also takes the
port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


def _life_rule(count: int, alive: int) -> int:
    return int(count == 3 or (alive and count == 2))


class GameOfLife:
    def __init__(self, height: int = 4, width: int = 4):
        self.height = height
        self.width = width

    def step_clear(self, grid: np.ndarray) -> np.ndarray:
        h, w = grid.shape
        padded = np.pad(grid, 1)
        out = np.zeros_like(grid)
        for y in range(h):
            for x in range(w):
                count = padded[y:y + 3, x:x + 3].sum() - grid[y, x]
                out[y, x] = _life_rule(int(count), int(grid[y, x]))
        return out

    def compile(self, configuration=None, inputset_size: int = 10,
                seed: int = 0, device=None):
        h, w = self.height, self.width

        @fhe.compiler({"grid": "encrypted"})
        def step(grid):
            rows = []
            for y in range(h):
                cols = []
                for x in range(w):
                    neigh = None
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            if dy == 0 and dx == 0:
                                continue
                            yy, xx = y + dy, x + dx
                            if 0 <= yy < h and 0 <= xx < w:
                                cell = grid[yy, xx]
                                neigh = cell if neigh is None else neigh + cell
                    cols.append(fhe.multivariate(_life_rule)(
                        neigh, grid[y, x]))
                rows.append(cols)
            # assemble the next grid (list of encrypted scalars)
            return tuple(c for row in rows for c in row)

        rng = np.random.default_rng(seed)
        # the all-ones/all-zeros grids pin the measured neighbor-count
        # bounds to the full [0, 8] range — random Bernoulli grids almost
        # never exhibit count 8, which would undersize the packed TLU and
        # wrap at run time
        inputset = [np.ones((h, w), dtype=np.int64),
                    np.zeros((h, w), dtype=np.int64)]
        inputset += [rng.integers(0, 2, (h, w))
                     for _ in range(inputset_size)]
        return step.compile(inputset, configuration, device=device)
