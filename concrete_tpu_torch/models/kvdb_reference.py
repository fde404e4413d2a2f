"""The key-value database's three operations on clear chunk tensors, in
plain ``torch`` int64: the reference that ``models/kvdb.py``'s
``KeyValueDatabase`` is held to.  It imports nothing of the package.

A state is an (E, 1 + K + V) tensor of rows ``[flag | key chunks | value
chunks]``, a key (K,) and a value (V,) of chunks, most significant first.
The equations are those of Concrete's example
(``examples/key_value_database``, static size)::

    matches  = sum((keys - key) == 0, axis=1) == K
    selected = keep_selected[matches[:, None] * 2^c + values]
    query    = [sum(matches), *sum(selected, axis=0)]

with ``keep_selected = [0] * 2^c + list(range(2^c))``.  Where this code
departs from them in form, it is the same function:

- ``keep_selected[s * 2^c + v]`` is written ``s * v`` (s is 0 or 1 and v a
  chunk below 2^c);
- ``insert``'s chain ``found * 2 + flag[i] == 0`` over the rows is the
  first row whose flag is 0 (a cumulative sum of the free rows equal to
  1 at a free row);
- ``replace``'s ``keep_selected[(1 - s) * 2^c + values] +
  keep_selected[s * 2^c + value]`` is ``where(s, value, values)``.
"""

from __future__ import annotations

import torch


def _split(state: torch.Tensor, key_chunks: int):
    return (state[:, 0], state[:, 1:1 + key_chunks],
            state[:, 1 + key_chunks:])


def matches(state: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(E,) 0/1: the rows whose key chunks all equal `key`'s."""
    _, keys, _ = _split(state, key.shape[-1])
    return (keys == key).all(dim=1).to(torch.int64)


def query(state: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(1 + V,): the number of matching rows, then the sums of their value
    chunks."""
    state, key = state.to(torch.int64), key.to(torch.int64)
    hit = matches(state, key)
    _, _, values = _split(state, key.shape[-1])
    return torch.cat([hit.sum().reshape(1),
                      (hit[:, None] * values).sum(dim=0)])


def insert(state: torch.Tensor, key: torch.Tensor,
           value: torch.Tensor) -> torch.Tensor:
    """The state with its first row of flag 0 set to (1, key, value); the
    same state when every row is occupied."""
    state = state.to(torch.int64).clone()
    free = (state[:, 0] == 0).to(torch.int64)
    first = free * (torch.cumsum(free, dim=0) == 1).to(torch.int64)
    update = torch.cat([first[:, None], first[:, None] * key[None, :],
                        first[:, None] * value[None, :]], dim=1)
    return state + update


def replace(state: torch.Tensor, key: torch.Tensor,
            value: torch.Tensor) -> torch.Tensor:
    """The state with the value chunks of every occupied matching row set
    to `value`."""
    state = state.to(torch.int64).clone()
    sel = (state[:, 0] * matches(state, key)).bool()
    k = key.shape[-1]
    state[:, 1 + k:] = torch.where(sel[:, None], value[None, :].to(
        torch.int64), state[:, 1 + k:])
    return state
