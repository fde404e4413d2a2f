"""The port's executor against the JAX package's, node kind by node kind.

Each traced function compiles in both packages at an insecure TINY
parameter set: the graph, the ``ClientSpecs`` and the saved archive must
be equal, and under one secret key (the same keygen seed) and the same
JAX-encrypted inputs (and clear arguments) the port's output ciphertexts
must equal the JAX package's bit for bit, and decrypt to the graph's clear
evaluation.  The port runs with ``device="cpu"`` (every kernel's plain
version), the JAX package on its CPU backend.  Several node kinds share a
function, so that every kind of the executor is covered.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import concrete_tpu as fhe
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.core import kernels as tk
from concrete_tpu_torch.core import refimpl as tref
from concrete_tpu_torch.params import CryptoParams as TParams
from test_torch_server import _assert_same_archive


def _tparams(p) -> TParams:
    return TParams(**dataclasses.asdict(p))


def _both(make, statuses, inputset, params, **config):
    """(JAX circuit, port circuit) of make(pkg) at `params`; a callable
    configuration value is called with the package."""
    def cfg(pkg):
        return {k: v(pkg) if callable(v) else v for k, v in config.items()}
    jc = fhe.compiler(statuses)(make(fhe)).compile(
        inputset, fhe.Configuration(forced_parameters=params, **cfg(fhe)))
    tc = tfhe.compiler(statuses)(make(tfhe)).compile(
        inputset, tfhe.Configuration(forced_parameters=_tparams(params),
                                     **cfg(tfhe)), device="cpu")
    return jc, tc


def _parity(tmp_path, make, statuses, inputset, args, params, seed=3,
            **config):
    """Compile in both packages, save both archives, run both circuits on
    the same ciphertexts under the same key; return the port's decrypted
    outputs (a tuple), the graph's clear evaluation and the port's
    circuit."""
    jc, tc = _both(make, statuses, inputset, params, **config)
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jc.server.save(jpath)
    tc.server.save(tpath)
    _assert_same_archive(jpath, tpath)
    jc.keygen(seed=seed)
    tc.keygen(seed=seed)
    specs = jc.client_specs
    rng = np.random.default_rng(seed + 1)
    run_args = [
        jkg.encrypt_lwe_batch(rng, jc.keys.secret.lwe_big,
                              jref.encode(np.asarray(v),
                                          specs.input_width(pos)),
                              specs.params.glwe_std)
        if spec.is_encrypted else np.asarray(v)
        for pos, (v, spec) in enumerate(zip(args, specs.inputs))]
    want = jc.server.run(*run_args,
                         evaluation_keys=jc.keys.evaluation_keys)
    got = tc.server.run(*run_args, evaluation_keys=tc.keys.evaluation_keys)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint64 and g.shape == np.asarray(w).shape
        assert np.array_equal(g, np.asarray(w))
    dec = tc.decrypt(*got)
    dec = dec if isinstance(dec, tuple) else (dec,)
    clear = tc.graph(*args)
    clear = clear if isinstance(clear, tuple) else (clear,)
    return dec, clear, tc


def _assert_decrypts(dec, clear):
    for d, c in zip(dec, clear):
        assert np.array_equal(np.asarray(d), np.asarray(c)), (d, c)


# -- levelled kinds, clear subgraphs, runtime clear inputs, clear outputs ----

def _shapes(pkg):
    def f(x, y):
        z = pkg.zeros((2, 3)) + x                 # encrypted_constant, add
        s = np.sum(z, axis=-1) + np.sum(x, axis=(0,))[:2]    # sum, index
        c = np.concatenate([x, x[::-1]], axis=0)  # negative-step index
        b = np.broadcast_to(x[1], (2, 3))
        r = (b + c[1:3]).reshape(3, 2)            # reshape
        t = np.transpose(r) + y * 2               # transpose, runtime clear
        a = pkg.array([s[0], x[0, 2], 3])         # array of scalars
        u = pkg.hint(a, bit_width=4) - pkg.ones(3) + pkg.ones_like(y) \
            + pkg.zeros_like(y)
        v = -x[0] + pkg.constant(9) + pkg.one() + pkg.zero()    # negative
        return t, u, v, y + 1                     # a clear output
    return f


SHAPES_SET = [(np.array([[0, 1, 2], [3, 2, 1]]), np.array([1, 0, 2])),
              (np.array([[3, 3, 3], [3, 3, 3]]), np.array([2, 2, 2])),
              (np.zeros((2, 3), dtype=np.int64), np.zeros(3, np.int64))]


def test_levelled_kinds_match_reference(tmp_path):
    """encrypted_constant (zeros, ones, their _like forms, constant, one,
    zero), add, negative, sum (a negative axis), index (a negative step),
    concatenate, broadcast_to, reshape, transpose, array, hint, a runtime
    clear input through a clear subgraph, and a clear output."""
    dec, clear, _ = _parity(
        tmp_path, _shapes, {"x": "encrypted", "y": "clear"}, SHAPES_SET,
        (np.array([[1, 2, 0], [2, 0, 3]]), np.array([2, 1, 0])),
        TEST_PARAMS_TINY)
    _assert_decrypts(dec, clear)


# -- lookups: per-element, multivariate, dynamic, rounding, control ----------

PER_ELEMENT = [[0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2]]


def _lookups(pkg):
    table = pkg.LookupTable(PER_ELEMENT)

    def f(x, y):
        a = table[x]                                    # per-element table
        m = pkg.multivariate(lambda u, v: (u + 2 * v) % 4)(x, y)
        c = pkg.if_then_else(x > 1, x, y)               # enc x enc multiply
        r = pkg.relu(x - y) + pkg.refresh(y) + pkg.identity(x)
        q = pkg.round_bit_pattern(x + y, lsbs_to_remove=1)
        t = pkg.truncate_bit_pattern(x + 2 * y, lsbs_to_remove=2)
        return a + m, c, r, pkg.univariate(lambda v: v // 2)(q), \
            pkg.univariate(lambda v: v)(t)
    return f


LOOKUPS_SET = [(np.array([0, 1, 2]), np.array([3, 0, 1])),
               (np.array([3, 3, 3]), np.array([3, 3, 3])),
               (np.array([0, 0, 0]), np.array([0, 0, 0]))]


@pytest.mark.parametrize("exactness", ["exact", "approximate"])
def test_lookup_kinds_match_reference(tmp_path, exactness):
    """A per-element table, a multivariate lookup, if_then_else (mux; its
    encrypted multiply as two lookups), relu, refresh, identity,
    round_bit_pattern
    and truncate_bit_pattern (exact, and approximate: no half-step bias)
    into their consumer lookups."""
    dec, clear, tc = _parity(
        tmp_path, _lookups, {"x": "encrypted", "y": "encrypted"},
        LOOKUPS_SET, (np.array([2, 3, 1]), np.array([1, 2, 3])),
        TEST_PARAMS_TINY_WIDE,
        rounding_exactness=lambda pkg: getattr(pkg.Exactness,
                                               exactness.upper()))
    truncate = [n for n in tc.graph.graph.nodes
                if n.name == "truncate_bit_pattern"]
    assert len(truncate) == 1 and bool(truncate[0].properties.get(
        "approximate")) == (exactness == "approximate")
    # the graph evaluates the exact rounding; an approximate truncation may
    # land a step up, so only the untouched outputs are held to it.  A tie
    # (an odd x + y under round_bit_pattern, a multiple of 4 of x + 2y
    # under truncate_bit_pattern's half-step bias) sits on a lookup box's
    # edge in both packages, where the noise decides (ROADMAP queue 3)
    _assert_decrypts(dec[:3], clear[:3])
    if exactness == "exact":
        x, y = np.array([2, 3, 1]), np.array([1, 2, 3])
        for k, tie in ((3, (x + y) % 2 == 1), (4, (x + 2 * y) % 4 == 0)):
            assert np.array_equal(np.asarray(dec[k])[~tie],
                                  np.asarray(clear[k])[~tie])


def _dynamic(pkg):
    def f(t, x):
        return t[x] + 1
    return f


def test_dynamic_lookup_matches_reference(tmp_path):
    """A table that arrives as a runtime clear argument: its accumulator
    polynomial is built at run time (core.kernels.encode_expand_lut).  The
    inputset comes from fhe.inputset, equal in both packages."""
    inputsets = [pkg.inputset(pkg.tensor[pkg.uint2, 4],
                              pkg.tensor[pkg.uint2, 3], n=8, seed=1)
                 for pkg in (fhe, tfhe)]
    assert all(np.array_equal(a, b) for pa, pb in zip(*inputsets)
               for a, b in zip(pa, pb))
    inputset = inputsets[1] + [(np.full(4, 3), np.full(3, 3))]
    assert tfhe.mux is tfhe.if_then_else
    dec, clear, _ = _parity(
        tmp_path, _dynamic, {"t": "clear", "x": "encrypted"}, inputset,
        (np.array([2, 0, 3, 1]), np.array([1, 3, 0])), TEST_PARAMS_TINY)
    _assert_decrypts(dec, clear)


# -- conv, maxpool, fancy indices, assignment, trace -------------------------

WEIGHT = np.array([[[[1, -1], [0, 2]], [[2, 0], [1, 1]]],
                   [[[0, 1], [1, 0]], [[-1, 1], [1, 2]]]])    # (2, 2, 2, 2)


def _windows(pkg):
    def f(x):
        y = pkg.conv(x, WEIGHT, bias=[1, 2], strides=(2, 1), padding=(1, 1))
        m = pkg.maxpool(x, (2, 2), strides=(1, 1))
        return y, m
    return f


def test_conv_and_maxpool_match_reference(tmp_path):
    """conv with padding, a stride and a bias (int64 multiply-sums over
    the kernel positions), and maxpool (its maximum as lookups)."""
    rng = np.random.default_rng(7)
    inputset = [rng.integers(0, 4, (1, 2, 3, 3)) for _ in range(6)] + [
        np.full((1, 2, 3, 3), 3), np.zeros((1, 2, 3, 3), dtype=np.int64)]
    dec, clear, _ = _parity(
        tmp_path, _windows, {"x": "encrypted"}, inputset,
        (rng.integers(0, 4, (1, 2, 3, 3)),), TEST_PARAMS_TINY_WIDE)
    _assert_decrypts(dec, clear)


def _fancy(pkg):
    def f(x, v):
        a = x[[2, 0], :, [1, 1]]           # advanced indices split by a slice
        b = x[..., ::-2, None]              # Ellipsis, a negative step, None
        c = x[np.int64(1), [0, 1]]
        x2 = x.reshape(3, 2, 2)
        x2[[0, 2, 0], 1] = v                # a repeated index: the last wins
        x2[1, :, 0] = 3                     # a clear value into a ciphertext
        return a, b, c, pkg.trace(x2, "after assign")
    return f


@pytest.mark.parametrize("tracing", ["0", "1"])
def test_fancy_index_and_assign_match_reference(tmp_path, monkeypatch,
                                               capsys, tracing):
    """Indices torch reads differently from numpy (advanced indices split by
    a slice move their axis first; a negative step; Ellipsis and None; a
    numpy integer), a functional assign with a repeated index (numpy's last
    writer), a clear value assigned into a ciphertext, and trace_message
    with and without CONCRETE_TPU_TRACE."""
    monkeypatch.setenv("CONCRETE_TPU_TRACE", tracing)
    rng = np.random.default_rng(2)
    inputset = [(rng.integers(0, 4, (3, 2, 2)), rng.integers(0, 4, (3, 2)))
                for _ in range(5)]
    x = rng.integers(0, 4, (3, 2, 2))
    v = np.array([[1, 2], [3, 0], [2, 2]])
    dec, clear, _ = _parity(
        tmp_path, _fancy, {"x": "encrypted", "v": "encrypted"}, inputset,
        (x, v), TEST_PARAMS_TINY)
    _assert_decrypts(dec, clear)
    want = x.reshape(3, 2, 2).copy()
    want[[0, 2, 0], 1] = v
    want[1, :, 0] = 3
    assert np.array_equal(dec[3], want)
    assert np.array_equal(dec[0], x[[2, 0], :, [1, 1]])
    printed = "after assign: body=" in capsys.readouterr().out
    assert printed == (tracing == "1")


@pytest.mark.parametrize("index", [
    (slice(None, None, -1),), (Ellipsis, slice(3, 0, -2)), ([2, 0], 1),
    ([1, 1], slice(None), [0, 2]), (None, 1, Ellipsis), (np.int64(-1),),
    (np.array([True, False, True]),), (slice(1, None), None, [2, 2, 0]),
    ((1, 2),)], ids=lambda i: repr(i)[:24])
def test_index_and_assign_follow_numpy(index):
    """The executor's index and assign on a (3, 4, 3) tensor of rows
    against numpy's on the row numbers: a view where torch's basic
    indexing is numpy's, a gather of numpy's selection elsewhere, and
    numpy's last writer for repeated indices."""
    from concrete_tpu_torch.compilation.executor import GraphExecutor
    data = np.arange(36, dtype=np.int64).reshape(3, 4, 3)
    ct = torch.from_numpy(data)[..., None] * torch.tensor([1, -1])
    got = GraphExecutor._index(ct, index)
    want = data[index]
    assert got.shape == want.shape + (2,)
    assert torch.equal(got[..., 0], torch.from_numpy(np.array(want)))
    assert torch.equal(got[..., 1], -got[..., 0])
    rng = np.random.default_rng(0)
    v = rng.integers(100, 200, np.shape(want))
    upd = torch.from_numpy(v)[..., None] * torch.tensor([1, -1])
    out = GraphExecutor._assign(ct, index, upd)
    ref = data.copy()
    ref[index] = v
    assert torch.equal(out[..., 0], torch.from_numpy(ref))
    assert torch.equal(out[..., 1], -out[..., 0])
    assert torch.equal(ct[..., 0], torch.from_numpy(data))   # functional


@pytest.mark.parametrize("bits,out_bits,signed,rows", [
    (1, 1, False, None), (3, 5, True, None), (4, 2, False, 5),
    (5, 7, True, 3), (7, 7, False, None)])
def test_encode_expand_lut_matches_refimpl(bits, out_bits, signed, rows):
    """core.kernels.encode_expand_lut on torch tensors (what a dynamic
    lookup runs on the device) against refimpl.encode_expand_lut, entries
    beyond the output width and negative ones included, 1-D and per-row
    tables."""
    rng = np.random.default_rng(bits * 10 + out_bits)
    shape = (1 << bits,) if rows is None else (rows, 1 << bits)
    table = rng.integers(-(1 << 9), 1 << 9, shape)
    got = tk.encode_expand_lut(torch.from_numpy(table), 512, bits, out_bits,
                               signed=signed)
    want = tref.encode_expand_lut(
        (table & ((1 << (out_bits + 1)) - 1)).astype(np.uint64), 512, bits,
        signed=signed, out_bits=out_bits)
    assert np.array_equal(got.numpy().view(np.uint64), want)


def test_dynamic_table_checks_match_reference():
    """A dynamic table of the wrong length refuses in both packages when
    the circuit is built, with the JAX package's message."""
    def f(t, x):
        return t[x]
    inputset = [(np.array([1, 2, 0]), 2), (np.array([0, 0, 1]), 0)]
    errors = []
    for pkg, kw in ((fhe, {}), (tfhe, {"device": "cpu"})):
        with pytest.raises(ValueError, match="dynamic table needs") as e:
            pkg.compiler({"t": "clear", "x": "encrypted"})(f).compile(
                inputset, pkg.Configuration(
                    forced_parameters=TEST_PARAMS_TINY if pkg is fhe
                    else _tparams(TEST_PARAMS_TINY)), **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
