"""The least time a blind rotate could take on the card, from the
cryptographic parameters and the batch alone.

The count reads the same work whatever implements it: nothing here looks
at the build, the kernels' code, the dispatch form or the width at which
the program stores its key.  For a blind rotate of B ciphertexts at
(n, k, N, l):

- bytes: the bootstrapping key's n (k+1)^2 l N coefficients at one byte
  each, the narrowest width any form of the program stores them in, read
  once, plus the B (k+1) N accumulator words (8 bytes) read and written
  once;
- operations: the transform-domain products, B n (k+1)^2 l N
  multiply-adds at two operations each, as the peak counts them, at the
  card's fastest integer rate.

The floor is the larger of bytes over the memory bandwidth and operations
over that rate.  Published peaks of one NVIDIA H100 SXM (the data sheet,
dense rates, at a power limit of 700 W): 3.35 TB/s of HBM3 and 1,979 TOP/s
of int8 tensor-core throughput.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
PEAK_POWER_W = 700.0


def blind_rotate_bytes(n: int, k: int, big_n: int, levels: int,
                       batch: int) -> int:
    key = n * (k + 1) ** 2 * levels * big_n
    accumulators = 2 * batch * (k + 1) * big_n * 8
    return key + accumulators


def blind_rotate_ops(n: int, k: int, big_n: int, levels: int,
                     batch: int) -> int:
    return 2 * batch * n * (k + 1) ** 2 * levels * big_n


def blind_rotate_floor_s(n: int, k: int, big_n: int, levels: int,
                         batch: int) -> float:
    return max(blind_rotate_bytes(n, k, big_n, levels, batch)
               / HBM_BYTES_PER_S,
               blind_rotate_ops(n, k, big_n, levels, batch)
               / INT8_OPS_PER_S)
