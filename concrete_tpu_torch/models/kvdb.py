"""Encrypted key-value databases.

Reference workload: frontends/concrete-python/benchmarks/static_kvdb.py and
examples/key_value_database.

``StaticKeyValueDatabase`` queries a table of clear keys with an encrypted
key: the match flags are TLU equality checks and the value is a masked sum.
It is the counterpart of ``concrete_tpu/models/kvdb.py``: the same traced
function, so both packages compile it to the same circuit; ``compile`` also
takes the port's ``device``.

``KeyValueDatabase`` is the example's database itself: keys, values and
their rows encrypted in chunks, with no counterpart in the JAX package; its
plain reference is ``models/kvdb_reference.py``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe
from concrete_tpu_torch.tracing import Tracer


class StaticKeyValueDatabase:
    def __init__(self, keys, values):
        self.db_keys = np.asarray(keys, dtype=np.int64)
        self.db_values = np.asarray(values, dtype=np.int64)
        assert len(self.db_keys) == len(self.db_values)

    def query_clear(self, key: int) -> int:
        hits = self.db_keys == key
        return int((self.db_values * hits).sum())

    def compile(self, configuration=None, device=None):
        db_keys = self.db_keys
        db_values = self.db_values

        @fhe.compiler({"key": "encrypted"})
        def query(key):
            out = None
            for k, v in zip(db_keys, db_values):
                flag = fhe.univariate(
                    lambda q, k=int(k): int(q == k))(key)
                term = flag * int(v)
                out = term if out is None else out + term
            return out

        inputset = list(range(int(self.db_keys.max()) + 2))
        return query.compile(inputset, configuration, device=device)


class KeyValueDatabase:
    """Concrete's key-value database (examples/key_value_database, the
    static-size database of benchmarks/static_kvdb.py): E rows of
    ``[flag | key chunks | value chunks]``, every chunk encrypted.

    Keys and values are cut into `chunk_bits`-bit chunks, most significant
    first.  ``query``, ``insert`` and ``replace`` are the example's
    functions; each runs on clear NumPy arrays as it is and is traced by
    ``fhe.compiler`` over the encrypted ``state`` (E, 1 + key chunks +
    value chunks), ``key`` and ``value``.  Every query, insert or replace
    touches every row: a query is ``17 E`` lookups at the default sizes.
    """

    OPS = ("query", "insert", "replace")

    def __init__(self, entries: int, key_bits: int = 32,
                 value_bits: int = 32, chunk_bits: int = 4):
        if key_bits % chunk_bits or value_bits % chunk_bits:
            raise ValueError("key and value bits must be whole chunks")
        self.entries = int(entries)
        self.key_bits, self.value_bits = key_bits, value_bits
        self.chunk_bits = chunk_bits
        self.key_chunks = key_bits // chunk_bits
        self.value_chunks = value_bits // chunk_bits
        self.row = 1 + self.key_chunks + self.value_chunks
        self.shape = (self.entries, self.row)
        self.keys = slice(1, 1 + self.key_chunks)
        self.values = slice(1 + self.key_chunks, self.row)
        chunk = 1 << chunk_bits
        #: a value kept where the selection bit above it is set, else 0
        self.keep_selected = fhe.LookupTable([0] * chunk + list(range(chunk)))

    # -- encoding ----------------------------------------------------------

    def _encode(self, number: int, bits: int) -> np.ndarray:
        if not 0 <= int(number) < 1 << bits:
            raise ValueError(f"{number} does not fit in {bits} bits")
        chunks = bits // self.chunk_bits
        mask = (1 << self.chunk_bits) - 1
        return np.array([(int(number) >> (self.chunk_bits * (chunks - 1 - i)))
                         & mask for i in range(chunks)], dtype=np.int64)

    def encode_key(self, number: int) -> np.ndarray:
        return self._encode(number, self.key_bits)

    def encode_value(self, number: int) -> np.ndarray:
        return self._encode(number, self.value_bits)

    def decode(self, chunks) -> int:
        out = 0
        for c in np.asarray(chunks, dtype=np.int64).reshape(-1):
            out = (out << self.chunk_bits) | int(c)
        return out

    def state_of(self, rows) -> np.ndarray:
        """The clear state of (key, value) pairs, the rest of the rows
        empty (flag 0)."""
        state = np.zeros(self.shape, dtype=np.int64)
        for i, (key, value) in enumerate(rows):
            state[i, 0] = 1
            state[i, self.keys] = self.encode_key(key)
            state[i, self.values] = self.encode_value(value)
        return state

    # -- the example's functions -------------------------------------------

    def _selected(self, selection, chunks):
        """keep_selected[selection * 2^c + chunks]: the chunks of the rows
        whose selection is 1, zeros elsewhere."""
        return self.keep_selected[selection * (1 << self.chunk_bits)
                                  + chunks]

    def _equal_rows(self, state, key):
        keys = state[:, self.keys]
        return np.sum((keys - key) == 0, axis=1) == self.key_chunks

    def query(self, state, key):
        """[number of rows whose key matches, *sum of their value chunks]."""
        selection = self._equal_rows(state, key).reshape((-1, 1))
        selected = self._selected(selection, state[:, self.values])
        found = np.sum(selection)
        value = np.sum(selected, axis=0)
        return fhe.array([found, *value])

    def insert(self, state, key, value):
        """The state with (key, value) written into its first empty row
        (unchanged when no row is empty)."""
        traced = isinstance(state, Tracer)
        zeros = fhe.zeros if traced else (
            lambda shape: np.zeros(shape, dtype=np.int64))
        flags = state[:, 0]
        selection = zeros(self.entries)
        found = zeros(())
        for i in range(self.entries):
            is_selected = (found * 2) + flags[i] == 0
            selection[i] = is_selected
            found = found + is_selected
        update = zeros(self.shape)
        update[:, 0] = selection
        selection = selection.reshape((-1, 1))
        update[:, self.keys] = self._selected(selection, key)
        update[:, self.values] = self._selected(selection, value)
        return state + update

    def replace(self, state, key, value):
        """The state with the value of every occupied row whose key
        matches set to `value`."""
        flags = state[:, 0]
        values = state[:, self.values]
        selection = (flags * self._equal_rows(state, key)).reshape((-1, 1))
        set_value = self._selected(selection, value)
        kept = self._selected(1 - selection, values)
        if not isinstance(state, Tracer):
            state = np.array(state)
        state[:, self.values] = kept + set_value
        return state

    # -- compilation ---------------------------------------------------------

    def inputset(self, op: str = "query", size: int = 8,
                 seed: int = 0) -> list:
        """Full states of distinct random keys and random values, with the
        extremes of every chunk; the key a row's key (a hit) in every other
        sample, else a fresh one.  With distinct keys a query counts at
        most one hit, so its sums stay within one chunk."""
        rng = np.random.default_rng(seed)
        out = []
        for s in range(size):
            # one more key than rows: the last one no row holds
            keys = rng.choice(1 << self.key_bits, self.entries + 1,
                              replace=False)
            values = rng.integers(0, 1 << self.value_bits, self.entries,
                                  dtype=np.uint64)
            if s == 0:                          # every chunk's extremes
                values[0] = (1 << self.value_bits) - 1
                keys[0], keys[-2] = (1 << self.key_bits) - 1, 0
            state = self.state_of(zip(keys[:-1].tolist(), values.tolist()))
            if op != "query" and s % 2:
                state[-1] = 0                   # a free row
            key = keys[s % self.entries] if s % 2 == 0 else keys[-1]
            args = (state, self.encode_key(key))
            if op != "query":
                args += (self.encode_value(int(rng.integers(
                    0, 1 << self.value_bits, dtype=np.uint64))),)
            out.append(args)
        return out

    def compile(self, configuration=None, device=None, op: str = "query"):
        """The circuit of `op`, one of ``OPS``, over the encrypted state,
        key and, for ``insert`` and ``replace``, value."""
        if op not in self.OPS:
            raise ValueError(f"op must be one of {self.OPS}, not {op!r}")
        names = ("state", "key") if op == "query" else ("state", "key",
                                                        "value")
        traced = fhe.compiler(dict.fromkeys(names, "encrypted"))(
            getattr(self, op))
        return traced.compile(self.inputset(op), configuration,
                              device=device)
