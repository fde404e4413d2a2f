"""Radix-decomposed big-integer arithmetic with per-limb PBS.

Counterpart of ``concrete_tpu/extensions/bigint.py``, on the port's
tracer: the same lookups, so one function traces to the JAX package's
graph.  The analog of the reference's big-integer support
(transformFHEBigInt, lib/Support/Pipeline.cpp:284-299: ints wider than the
TLU budget are chunked into radix limbs, with carry propagation via table
lookups).  A big integer is a tuple/array of encrypted limbs, LSB first,
each holding `limb_bits` bits.

Operations:
- radix_add: per-limb leveled adds + ripple carry TLUs
- radix_mul: schoolbook limb products (packed two-operand TLUs for lo/hi
  halves) + radix adds
- radix_lt / radix_eq: lexicographic comparison via TLU chain

BASELINE config #4 ("16-bit radix-decomposed arithmetic with per-limb PBS")
is radix_add/mul/lt with bit_width=16.
"""

from __future__ import annotations


from concrete_tpu_torch.extensions.multivariate import multivariate
from concrete_tpu_torch.extensions.univariate import univariate


def radix_decompose_clear(value: int, limb_bits: int, n_limbs: int):
    mask = (1 << limb_bits) - 1
    return [(int(value) >> (i * limb_bits)) & mask for i in range(n_limbs)]


def radix_recompose_clear(limbs, limb_bits: int) -> int:
    out = 0
    for i, limb in enumerate(limbs):
        out |= int(limb) << (i * limb_bits)
    return out


def radix_add(a_limbs, b_limbs, limb_bits: int):
    """(a + b) mod 2^(limb_bits * n): ripple carry, one TLU pair per limb."""
    n = len(a_limbs)
    mod = 1 << limb_bits
    out = []
    carry = None
    for i in range(n):
        s = a_limbs[i] + b_limbs[i]
        if carry is not None:
            s = s + carry
        out.append(univariate(lambda v, m=mod: int(v) % m)(s))
        if i != n - 1:
            carry = univariate(lambda v, m=mod: int(v) // m)(s)
    return tuple(out)


def radix_add_clear(a_limbs, constant: int, limb_bits: int):
    n = len(a_limbs)
    c_limbs = radix_decompose_clear(constant, limb_bits, n)
    mod = 1 << limb_bits
    out = []
    carry = None
    for i in range(n):
        s = a_limbs[i] + c_limbs[i]
        if carry is not None:
            s = s + carry
        out.append(univariate(lambda v, m=mod: int(v) % m)(s))
        if i != n - 1:
            carry = univariate(lambda v, m=mod: int(v) // m)(s)
    return tuple(out)


def radix_mul(a_limbs, b_limbs, limb_bits: int):
    """(a * b) mod 2^(limb_bits * n): schoolbook partial products.

    Each limb product is one packed TLU for the low half and one for the
    high half (carry limb); partials are summed with radix_add.
    """
    n = len(a_limbs)
    mod = 1 << limb_bits
    zero_cols = [[] for _ in range(n)]
    for i in range(n):
        for j in range(n - i):
            lo = multivariate(
                lambda x, y, m=mod: (int(x) * int(y)) % m)(
                a_limbs[i], b_limbs[j])
            zero_cols[i + j].append(lo)
            if i + j + 1 < n:
                hi = multivariate(
                    lambda x, y, m=mod: (int(x) * int(y)) // m)(
                    a_limbs[i], b_limbs[j])
                zero_cols[i + j + 1].append(hi)
    # column-wise accumulation with carry TLUs
    out = []
    carry = None
    for c in range(n):
        s = None
        for term in zero_cols[c]:
            s = term if s is None else s + term
        if carry is not None:
            s = carry if s is None else s + carry
        out.append(univariate(lambda v, m=mod: int(v) % m)(s))
        if c != n - 1:
            carry = univariate(lambda v, m=mod: int(v) // m)(s)
    return tuple(out)


def radix_eq(a_limbs, b_limbs, limb_bits: int):
    """a == b as one encrypted bit: product of per-limb equality flags
    (accumulated as a sum reaching n, then a threshold TLU)."""
    n = len(a_limbs)
    acc = None
    for i in range(n):
        f = multivariate(lambda x, y: int(int(x) == int(y)))(
            a_limbs[i], b_limbs[i])
        acc = f if acc is None else acc + f
    return univariate(lambda v, n=n: int(int(v) == n))(acc)


def radix_lt(a_limbs, b_limbs, limb_bits: int):
    """a < b: lexicographic scan from the most significant limb.

    state in {0: undecided/equal, 1: a<b, 2: a>b}; one packed TLU per limb
    plus a final projection.
    """
    state = None
    for i in reversed(range(len(a_limbs))):
        cmp_i = multivariate(
            lambda x, y: 0 if x == y else (1 if x < y else 2))(
            a_limbs[i], b_limbs[i])
        if state is None:
            state = cmp_i
        else:
            # keep previous decision unless undecided
            state = multivariate(
                lambda s, c: s if s != 0 else c)(state, cmp_i)
    return univariate(lambda s: int(s == 1))(state)
