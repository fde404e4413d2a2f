"""The PyTorch port's compile path against the JAX package, on CPU.

Four circuits compile in both packages at the default 128-bit
``Configuration()``: the fixture's ``table_sub`` (two encrypted (1024,)
4-bit tensors, N=1024), ``QuantizedMLP`` over 64 samples (N=4096, fused
CRT-NTT), ``examples/table_lookup.py``'s ``f`` (N=256, k=4) and
``examples/quickstart.py``'s ``add`` (levelled only).  The port must trace
the same graph, choose the same ``CryptoParams``, ``ClientSpecs`` and BSK
form, and write the committed archives byte for byte; at the insecure TINY
parameter sets its compiled circuits must produce the JAX package's output
ciphertexts bit for bit.  The parameter search and the multi-partition
planner are held against the JAX package's on a grid of patterns.
"""

import dataclasses
import importlib.util
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import concrete_tpu as fhe
from concrete_tpu.compilation import graph_io as jgio
from concrete_tpu.compilation import multi as jmulti
from concrete_tpu.compilation import transforms as jtr
from concrete_tpu.compilation import widths as jwidths
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.models import QuantizedMLP as JMLP
from concrete_tpu.optimizer import v0 as jv0
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation import graph_io as tgio
from concrete_tpu_torch.compilation import multi as tmulti
from concrete_tpu_torch.compilation import transforms as ttr
from concrete_tpu_torch.compilation import widths as twidths
from concrete_tpu_torch.models import QuantizedMLP as TMLP
from concrete_tpu_torch.optimizer import v0 as tv0
from concrete_tpu_torch.params import CryptoParams as TParams
from test_torch_server import _assert_same_archive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICKSTART = os.path.join(REPO, "examples", "quickstart.py")
TOOL_PATH = os.path.join(REPO, "tools", "make_torch_fixture.py")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load("make_torch_fixture", TOOL_PATH)


def _tparams(p) -> TParams:
    return TParams(**dataclasses.asdict(p))


# -- the four circuits, written once for either package ----------------------

def _table_sub(pkg, table=TOOL.TABLE):
    lut = pkg.LookupTable(table)

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def table_sub(x, y):
        return lut[x] - y

    return table_sub


def _table_lookup(pkg):
    """examples/table_lookup.py's ``f``, written again with ``pkg``'s own
    LookupTable and univariate (the example's body names the JAX
    package's)."""
    table = pkg.LookupTable([2, 1, 3, 0])

    @pkg.compiler({"x": "encrypted"})
    def f(x):
        return table[x] + pkg.univariate(lambda v: v // 2)(x)

    return f


def _quickstart(pkg):
    """examples/quickstart.py's own ``add`` function, under ``pkg``'s
    compiler."""
    add = _load("quickstart", QUICKSTART).add
    return pkg.compiler({"x": "encrypted", "y": "encrypted"})(add.function)


QUICKSTART_INPUTSET = [(2, 3), (0, 0), (7, 7)]
CIRCUITS = {
    "table_sub": (_table_sub, TOOL.inputset),
    "table_lookup": (_table_lookup, lambda: list(range(4))),
    "quickstart": (_quickstart, lambda: QUICKSTART_INPUTSET),
}
NAMES = ["table_sub", "mlp", "table_lookup", "quickstart"]


def _compile(pkg, name, config=None, **kwargs):
    config = config or pkg.Configuration()
    if pkg is tfhe:
        kwargs.setdefault("device", "cpu")
    if name == "mlp":
        mlp = (JMLP if pkg is fhe else TMLP)()
        return mlp.compile(config, batch_size=TOOL.MLP_BATCH, **kwargs)
    make, inputset = CIRCUITS[name]
    return make(pkg).compile(inputset(), config, **kwargs)


_COMPILED: dict = {}


def _compiled(name):
    """(JAX circuit, port circuit) at the default Configuration()."""
    if name not in _COMPILED:
        _COMPILED[name] = (_compile(fhe, name), _compile(tfhe, name))
    return _COMPILED[name]


def _graph_record(gio, graph):
    """graph.json with the uids nulled, and the npz payloads."""
    text, blob = gio.serialize_graph(graph)
    rec = json.loads(text)
    for node in rec["nodes"]:
        node["uid"] = None
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return rec, {n: z.read(n) for n in z.namelist()}


# -- (a) graph, widths, parameters, specs and BSK form ------------------------

@pytest.mark.parametrize("name", ["table_sub", "table_lookup", "quickstart"])
def test_trace_matches_reference(name):
    make, inputset = CIRCUITS[name]
    jg = make(fhe).trace(inputset())
    tg = make(tfhe).trace(inputset())
    assert _graph_record(tgio, tg) == _graph_record(jgio, jg)


@pytest.mark.parametrize("name", NAMES)
def test_compile_matches_reference(name):
    """The compiled graph (transforms, bounds, encoding widths), the
    CryptoParams, the ClientSpecs and the BSK form the keys pack."""
    jc, tc = _compiled(name)
    assert _graph_record(tgio, tc.graph) == _graph_record(jgio, jc.graph)
    assert dataclasses.asdict(tc.client_specs.params) == \
        dataclasses.asdict(jc.client_specs.params)
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    assert not tc.client_specs.is_multi
    mb = jc.client_specs.message_bits
    assert tv0.fused_ntt_preferred(tc.client_specs.params, mb) == \
        jv0.fused_ntt_preferred(jc.client_specs.params, mb)
    assert tc.programmable_bootstrap_count == jc.programmable_bootstrap_count
    assert tc.complexity == jc.complexity
    assert tc.p_error == jc.p_error
    assert tc.server.lowering_text() == jc.server.lowering_text()


def test_compiled_shapes_of_the_slice():
    """The shapes chip_smoke.py's compile phase relies on: table_sub on
    the banded path at N=1024, the MLP fused at N=4096, table_lookup at
    k+1 = 5, N = 256 (the persistent kernel's cluster of 4), quickstart
    levelled only."""
    p = {name: _compiled(name)[1].client_specs for name in NAMES}
    assert (p["table_sub"].params.n_small, p["table_sub"].params.
            polynomial_size, p["table_sub"].params.pbs_level) == (698, 1024, 4)
    assert (p["mlp"].params.polynomial_size, p["mlp"].message_bits) == \
        (4096, 6)
    tl = p["table_lookup"].params
    assert (tl.n_small, tl.glwe_dimension, tl.polynomial_size,
            tl.pbs_level, tl.pbs_base_log) == (610, 4, 256, 3, 5)
    assert p["quickstart"].params.n_small == 556
    assert _compiled("quickstart")[1].programmable_bootstrap_count == 0
    assert tv0.fused_ntt_preferred(p["mlp"].params, 6)
    assert not tv0.fused_ntt_preferred(p["table_sub"].params, 5)


# -- (b, c) Server.save reproduces the committed archives --------------------

@pytest.mark.parametrize("name,fixture", [("table_sub", TOOL.FIXTURE),
                                          ("mlp", TOOL.MLP_FIXTURE)])
def test_save_reproduces_committed_archive(tmp_path, name, fixture):
    path = str(tmp_path / f"{name}.zip")
    _compiled(name)[1].server.save(path)
    _assert_same_archive(fixture, path)


@pytest.mark.parametrize("name", ["table_lookup", "quickstart"])
def test_saved_archive_loads_in_both_packages(tmp_path, name):
    """A port-saved archive is the JAX package's archive: both Server.load
    read it, with the same specs and the same graph."""
    jc, tc = _compiled(name)
    tpath, jpath = str(tmp_path / "t.zip"), str(tmp_path / "j.zip")
    tc.server.save(tpath)
    jc.server.save(jpath)
    _assert_same_archive(jpath, tpath)
    jserver = fhe.Server.load(tpath)
    tserver = tfhe.Server.load(tpath, device="cpu")
    assert jserver.client_specs.serialize() == \
        tserver.client_specs.serialize() == tc.client_specs.serialize()
    assert _graph_record(jgio, jserver.graph) == \
        _graph_record(tgio, tserver.graph)


# -- (d) the parameter search and the planner --------------------------------

#: precision 1-8 against norm2 1-2^6: each (p_error, security) case takes
#: another rotation of the norm2 column, so the four cases cover 32 cells
_NORM2 = [1, 2, 4, 8, 16, 32, 64]


@pytest.mark.parametrize("p_error", [6.3e-5, 1e-3])
@pytest.mark.parametrize("security", [128, 132])
def test_optimize_v0_multi_matches_reference(p_error, security):
    shift = (p_error == 1e-3) + 2 * (security == 132)
    for p in range(1, 9):
        n2 = _NORM2[(p + 2 * shift) % len(_NORM2)]
        kw = dict(p_error=p_error, security_level=security)
        assert dataclasses.asdict(tv0.optimize_v0(p, n2, **kw)) == \
            dataclasses.asdict(jv0.optimize_v0(p, n2, **kw)), (p, n2)
    # (p, in_sq, lut_sq) triples, several at once, with noise-only ones
    patterns = ((2, 1.0, 0.0), (3, 0.0, 4.0), (5, 2.0, 9.0))
    noise_only = ((6, 1.0, 16.0), (4, 0.0, 1.0))
    kw = dict(p_error=p_error, security_level=security,
              noise_only=noise_only)
    assert dataclasses.asdict(tv0.optimize_v0_multi(patterns, **kw)) == \
        dataclasses.asdict(jv0.optimize_v0_multi(patterns, **kw))
    assert tv0.achieved_p_error(
        tv0.optimize_v0_multi(patterns, **kw), patterns, noise_only) == \
        jv0.achieved_p_error(jv0.optimize_v0_multi(patterns, **kw),
                             patterns, noise_only)


def test_optimize_v0_multi_under_range_restriction():
    pattern = ((4, 1.0, 4.0),)
    for fields in (dict(glwe_log_polynomial_sizes=(11,)),
                   dict(pbs_level_count=(2,), ks_base_log=(3, 4)),
                   dict(internal_lwe_dimensions=(700, 800, 900))):
        jr = fhe.RangeRestriction(**fields)
        tr = tfhe.RangeRestriction(**fields)
        hash(tr)                         # the search is lru-cached
        assert dataclasses.asdict(tv0.optimize_v0_multi(
            pattern, restriction=tr)) == dataclasses.asdict(
            jv0.optimize_v0_multi(pattern, restriction=jr)), fields


@pytest.mark.parametrize("strategy", ["multi", "mono"])
def test_global_p_error_calibration_matches_reference(strategy):
    """The calibration loops: the planner's achieved global error under
    MULTI (table_lookup has two partitions), the mono search's under
    MONO."""
    params = []
    for pkg in (fhe, tfhe):
        c = _compile(pkg, "table_lookup", pkg.Configuration(
            global_p_error=1e-3, parameter_selection_strategy=strategy))
        params.append(dataclasses.asdict(c.client_specs.params))
    assert params[0] == params[1]


def _width_graph(pkg, name):
    """The compile pipeline up to the planner (trace, transforms, bounds,
    encoding widths) in one package."""
    tr, wd = (jtr, jwidths) if pkg is fhe else (ttr, twidths)
    if name == "mlp":
        return _compile(pkg, name).graph
    make, inputset = CIRCUITS[name]
    compiler = make(pkg)
    graph = pkg.Tracer.trace(compiler.function,
                             compiler.parameter_encryption_statuses,
                             sample=inputset()[0], name="f")
    tr.run_default_transforms(graph)
    graph.measure_bounds(inputset())
    graph.update_dtypes_from_bounds()
    tr.chunk_wide_comparisons(graph, native_bits=8)
    tr.chunk_wide_minmax(graph, native_bits=8)
    tr.chunk_wide_encrypted_shifts(graph, native_bits=8)
    wd.assign_encoding_widths(graph)
    return graph


def _plan_record(plan):
    return (
        {w: dataclasses.asdict(p) for w, p in plan.params.items()},
        plan.fks, plan.wop_gadgets, plan.norm2, plan.patterns,
        plan.noise_patterns, plan.crossing_p_error)


@pytest.mark.parametrize("name,widths", [("table_sub", [4, 5]),
                                         ("mlp", [1, 6]),
                                         ("table_lookup", [2, 3])])
def test_planner_matches_reference_on_two_partition_graphs(name, widths):
    """The finest cut (patterns, crossings), its fixed-point solve, and the
    merge search's answer (mono, None) in both packages."""
    jg, tg = _width_graph(fhe, name), _width_graph(tfhe, name)
    jpat, jcross = jmulti.partition_pattern_split(jg)
    tpat, tcross = tmulti.partition_pattern_split(tg)
    assert sorted(tpat) == sorted(jpat) == widths
    assert {w: dataclasses.asdict(p) for w, p in tpat.items()} == \
        {w: dataclasses.asdict(p) for w, p in jpat.items()}
    assert [dataclasses.asdict(c) for c in tcross] == \
        [dataclasses.asdict(c) for c in jcross]
    assert tcross
    args = (6.3e-5, 128, 4, None)
    jplan = jmulti._solve_plan(jpat, jcross, *args)
    tplan = tmulti._solve_plan(tpat, tcross, *args)
    assert _plan_record(tplan) == _plan_record(jplan)
    group = {pid: pid for pid in tpat}
    assert tmulti._modeled_cost(tmulti._tlu_instructions(tg), group,
                                tplan) == \
        jmulti._modeled_cost(jmulti._tlu_instructions(jg), group, jplan)
    assert tmulti.achieved_global_p_error(tplan, tg) == \
        jmulti.achieved_global_p_error(jplan, jg)
    assert tmulti.plan_partitions(tg) is None
    assert jmulti.plan_partitions(jg) is None


def _mixed(pkg):
    """A circuit the planner keeps multi: a 2-bit and a 4-bit lookup whose
    outputs join (tests/test_multi.py's)."""
    small = pkg.LookupTable([3, 1, 2, 0])
    big = pkg.LookupTable([(i * 7) % 4 for i in range(16)])

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return small[x] + big[y]

    return f, [(int(i % 4), int((i * 13) % 16)) for i in range(30)]


def test_multi_partition_result_matches_reference_and_is_not_served():
    """The planner keeps this circuit multi in both packages, with the same
    partition parameters and conversion keyswitches.  (The name is from
    before the port served such circuits: its circuit now holds a
    MultiKeys client and a multi-mode server on those partitions, which
    tests/test_torch_multi.py runs against the JAX package.)"""
    from concrete_tpu_torch.compilation.keys import MultiKeys
    specs = []
    for pkg in (fhe, tfhe):
        f, inputset = _mixed(pkg)
        kw = {"device": "cpu"} if pkg is tfhe else {}
        c = f.compile(inputset, **kw)
        specs.append(c.client_specs)
    jspecs, tspecs = specs
    assert tspecs.is_multi and tspecs.serialize() == jspecs.serialize()
    assert isinstance(c.keys, MultiKeys) and not c.keys.are_generated
    assert set(c.keys.partitions) == set(tspecs.partitions)
    assert c.server._executor.partitions == tspecs.partitions
    assert c.server._executor.conversions == tspecs.conversions


# -- (e) bit parity of the compiled circuits at TINY parameters ---------------

def _tiny_case(name):
    if name == "table_sub":
        rng = np.random.default_rng(0)
        inputset = [(rng.integers(0, 8, 6), rng.integers(0, 8, 6))
                    for _ in range(4)] + [(np.arange(6) % 8,
                                           np.arange(6) % 8)]
        table = [(3 * v + 1) % 8 for v in range(8)]
        args = (np.array([0, 7, 3, 5, 1, 6]), np.array([7, 0, 2, 5, 4, 1]))
        return (lambda pkg: _table_sub(pkg, table)), inputset, args, \
            np.array(table)[args[0]] - args[1]
    if name == "table_lookup":
        return _table_lookup, list(range(4)), (3,), 0 + 3 // 2
    return _quickstart, QUICKSTART_INPUTSET, (2, 6), 8


@pytest.mark.parametrize("params", [TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE],
                         ids=["tiny", "tiny_wide"])
@pytest.mark.parametrize("name", ["table_sub", "table_lookup", "quickstart"])
def test_compiled_circuit_run_matches_reference(name, params):
    """Same keygen seed, same JAX-encrypted inputs: the port circuit's
    output ciphertexts equal the JAX circuit's bit for bit."""
    make, inputset, args, want = _tiny_case(name)
    jc = make(fhe).compile(inputset,
                           fhe.Configuration(forced_parameters=params))
    tc = make(tfhe).compile(inputset, tfhe.Configuration(
        forced_parameters=_tparams(params)), device="cpu")
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    jc.keygen(seed=3)
    tc.keygen(seed=3)
    specs = jc.client_specs
    rng = np.random.default_rng(1)
    cts = [jkg.encrypt_lwe_batch(
        rng, jc.keys.secret.lwe_big,
        jref.encode(np.asarray(v), specs.input_width(pos)),
        specs.params.glwe_std) for pos, v in enumerate(args)]
    want_ct = np.asarray(jc.run(*cts))
    got_ct = tc.run(*cts)
    assert got_ct.dtype == np.uint64 and got_ct.shape == want_ct.shape
    assert np.array_equal(got_ct, want_ct)
    assert np.array_equal(tc.decrypt(got_ct), want)
    if name == "quickstart":             # no PBS: no decision can fail
        assert tc.encrypt_run_decrypt(*args) == want


# -- (f, g) the configuration fields and features of later slices, the device

@pytest.mark.parametrize("field,item", [
    ("fhe_simulation", "item 5"), ("simulate_encrypt_run_decrypt", "item 5"),
    ("auto_schedule_run", "item 5"), ("use_insecure_key_cache", "item 6"),
    ("compress_input_ciphertexts", "item 6"),
    ("forced_wop_parameters", "item 7")])
def test_unported_configuration_raises(field, item):
    """Every field of the later slices is ported now (simulation and the
    scheduler, item 5; the key cache and seeded compression, item 6;
    WoP-PBS, item 7): each is taken as it is, as in the JAX package."""
    value = (1, 2, 3, 4) if field == "forced_wop_parameters" else True
    assert getattr(tfhe.Configuration(**{field: value}), field) == value
    assert getattr(fhe.Configuration(**{field: value}), field) == value
    # fields the JAX package accepts and ignores stay accepted
    tfhe.Configuration(loop_parallelize=False, dataflow_parallelize=True,
                       auto_parallelize=True, mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="use_gpu"):
        tfhe.Configuration(use_gpu=True)


def test_unported_features_raise():
    """The features of later slices work: simulation and run_async (item
    5) on the levelled quickstart circuit, as in the JAX package; debug
    artifacts (item 6); a 9-bit lookup (item 7)."""
    jc, tc = _compiled("quickstart")
    assert tc.simulate(2, 6) == jc.simulate(2, 6) == 8
    enc = tc.encrypt(2, 6)
    fut = tc.run_async(*enc)
    assert np.array_equal(fut.result(timeout=120), tc.run(*enc))
    assert tc.decrypt(fut.result()) == 8
    # debug artifacts (item 6) are ported: compile hands them its stages
    seen = []

    class Recorder:
        def __getattr__(self, name):
            return lambda *args: seen.append(name)
    _compile(tfhe, "quickstart", artifacts=Recorder())
    assert seen == ["add_graph", "add_bounds", "add_parameters",
                    "add_statistics", "export"]
    # a 9-bit lookup (ROADMAP item 7, WoP-PBS) now compiles, to the JAX
    # package's parameters and WoP gadgets
    def nine_bits(pkg):
        wide = pkg.LookupTable(list(range(512)))

        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return wide[x]
        return f

    compiled = nine_bits(tfhe).compile(range(512), device="cpu")
    assert compiled.client_specs.serialize() \
        == nine_bits(fhe).compile(range(512)).client_specs.serialize()
    assert compiled.client_specs.wop_gadgets is not None


def test_circuit_defaults_to_cuda():
    """compile() builds its Circuit on the card unless asked for the CPU,
    and raises without one."""
    make, inputset = CIRCUITS["quickstart"]
    if torch.cuda.is_available():
        assert make(tfhe).compile(inputset()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make(tfhe).compile(inputset())
    assert make(tfhe).compile(inputset(), device="cpu").device.type == "cpu"
