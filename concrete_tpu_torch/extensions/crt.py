"""CRT (residue number system) encrypted integers.

Reference: the compiler's CRT mode for >=9-bit integers
(lib/Conversion/FHEToTFHECrt/FHEToTFHECrt.cpp, lib/Common/CRT.cpp): a value
is held as residues mod pairwise-coprime moduli; add/mul act per residue
(with TLU reduction mod m_j), decode via CRT reconstruction.  Arbitrary
table lookups go through WoP-PBS (`crt_tlu`: per-residue bit extraction +
circuit bootstrap + one vertical packing per output residue —
wrappers.cpp:855-998 semantics over native-encoded residues).
"""

from __future__ import annotations

from functools import reduce

import numpy as np

from concrete_tpu_torch.extensions.univariate import univariate

#: the reference's default CRT basis for 16-bit integers (CRT.cpp usage)
DEFAULT_MODULI = (7, 8, 9, 11, 13)


def crt_encode_clear(value: int, moduli=DEFAULT_MODULI):
    return [int(value) % m for m in moduli]


def crt_decode_clear(residues, moduli=DEFAULT_MODULI) -> int:
    product = reduce(lambda a, b: a * b, moduli)
    out = 0
    for r, m in zip(residues, moduli):
        q = product // m
        out += int(r) * q * pow(q, -1, m)
    return out % product


def crt_add(a_res, b_res, moduli=DEFAULT_MODULI):
    """Per-residue addition with TLU reduction mod m_j."""
    out = []
    for a, b, m in zip(a_res, b_res, moduli):
        out.append(univariate(lambda v, m=m: int(v) % m)(a + b))
    return tuple(out)


def crt_add_clear(a_res, constant: int, moduli=DEFAULT_MODULI):
    out = []
    for a, m in zip(a_res, moduli):
        c = int(constant) % m
        out.append(univariate(lambda v, m=m: int(v) % m)(a + c))
    return tuple(out)


def crt_mul(a_res, b_res, moduli=DEFAULT_MODULI):
    """Per-residue multiplication via one packed TLU per residue."""
    from concrete_tpu_torch.extensions.multivariate import multivariate
    out = []
    for a, b, m in zip(a_res, b_res, moduli):
        out.append(multivariate(lambda x, y, m=m: (int(x) * int(y)) % m)(
            a, b))
    return tuple(out)


def crt_mul_clear(a_res, constant: int, moduli=DEFAULT_MODULI):
    out = []
    for a, m in zip(a_res, moduli):
        c = int(constant) % m
        out.append(univariate(lambda v, m=m, c=c: (int(v) * c) % m)(a))
    return tuple(out)


def crt_tlu(residues, table, moduli=DEFAULT_MODULI):
    """Arbitrary univariate TLU over a CRT value: y = table[x] as residues.

    Lowers to ONE shared per-residue bit extraction + circuit bootstrap and
    one vertical-packing lookup per output residue (WoP-PBS), matching the
    reference's CRT TLU (memref_wop_pbs_crt_buffer, wrappers.cpp:855-998;
    lowering FHEToTFHECrt.cpp).  `table` must cover [0, prod(moduli)) or
    the circuit's measured input range.

    Returns a tuple of len(moduli) encrypted residues of table[x].
    """
    from concrete_tpu_torch.tracing.tracer import Tracer

    moduli = tuple(int(m) for m in moduli)
    table = np.asarray(table, dtype=np.int64)
    if not any(isinstance(r, Tracer) for r in residues):
        x = crt_decode_clear(residues, moduli)
        v = int(table[x % len(table)])
        return tuple(v % m for m in moduli)
    operands = [Tracer.sanitize(r) for r in residues]
    for i, (op, m) in enumerate(zip(operands, moduli)):
        if not op.node.output.is_encrypted:
            raise ValueError(
                f"crt_tlu residue {i} is not encrypted — all residues of "
                "a CRT value are ciphertexts")
        # a residue mod m structurally spans [0, m): pin the encoding to
        # ceil(log2 m) bits regardless of what the inputset happens to
        # cover (the reference fixes CRT encodings from the moduli —
        # Transformers.cpp:514-575 — not from measured bounds)
        prev = op.node.bounds
        seed = (0, m - 1)
        op.node.bounds = seed if prev is None else \
            (min(prev[0], 0), max(prev[1], m - 1))
    outs = []
    for j, m_out in enumerate(moduli):
        def evaluator(*vals, _j=j, _m=m_out):
            vals = [np.asarray(v) for v in vals]
            product = reduce(lambda a, b: a * b, moduli)
            x = np.zeros_like(vals[0], dtype=np.int64)
            for r, m in zip(vals, moduli):
                q = product // m
                x = x + r.astype(np.int64) * (q * pow(int(q), -1, int(m)))
            x = x % product
            return table[x % len(table)] % _m

        output = Tracer._infer_output("crt_tlu", evaluator, operands)
        out = Tracer._generic(
            "crt_tlu", operands, evaluator, output,
            moduli=moduli, table=table, out_index=j)
        # output residues likewise hold any value in [0, m_out)
        out.node.bounds = (0, m_out - 1)
        outs.append(out)
    return tuple(outs)
