#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (concrete_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``concrete_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time and the card's name and power limit;
2. holds each banded kernel (A, B, kernel 9 ``banded_matmul`` in its
   table and latency forms, and the standalone ``recombine_accumulate``)
   bit-exact against its plain PyTorch version on the card, at the shapes
   the 128-bit N=1024 server path gives it (kernel 9's table form on
   kernel A's digit planes in place, and on the JAX package's stacked
   lhs, also at batches of 200 and 1000, which leave its last 128-row
   tile part empty; limb_offset 0 / keep 8; two digit limbs at a small
   shape; kernel 9 with the latency path's k+1 = 2 rows and Cout = B in
   {1, 4}, and its latency form as the latency step calls it, on kernel
   1's digits and a BSK step in place, at B = 1 .. 4, k+1 = 3, two digit
   limbs and N = 2048; the recombine and kernel 1 also at the latency
   shape; kernel B, whose main loop kernel 9's table form shares
   (``csrc/banded_wgmma.cuh``), also at N=2048, l=2, at batches of 200
   and 1000, and at N=16384, where three planes' key windows fill a
   block), and times kernel, plain version and, for the products, the
   ``torch._int_mm`` of the same product against a pre-built Toeplitz
   matrix, its lhs zero-padded to 17 rows where it has fewer (a yardstick
   the port never calls); and the persistent latency blind rotate
   (``blind_rotate_latency``, every step of a B <= 4 lookup in one launch)
   over a whole lookup's 710 steps at B = 1 and 4, against its plain
   version and the three-kernel step loop on the card, timed beside both
   and beside variants built without its MMA (the chain floor) and
   without its key rows, with the clocks of each part of a step from an
   instrumented build, the same at the shape of the compiled
   ``examples/table_lookup.py`` (B = 1, k+1 = 5, N = 256, l = 3, 610
   steps), at GameOfLife's (N = 2048, l = 2, base 2^7, 5 key limbs: two
   64-t groups a block and a key ring of one slot, 758 steps) and at the
   latency shape's untruncated key (8 limbs, one slot), at B = 1 and 4
   against the plain version over a few steps and the step loop over a
   whole lookup, then at B = 1 .. 4, k+1 = 3 with two digit limbs and a
   full key over a few steps; kernel 1, kernel 9's latency form and the
   recombine are also timed at GameOfLife's step; and the PBS prologue
   (``pbs_prologue``: a B <= 4 lookup's keyswitch, modulus switch and
   first accumulator in one launch) at tlu4's keyset (n_in 1024, ks 8
   levels of base 2^2, n_out 698, N=1024) and GameOfLife's (n_in 2048,
   n_out 758, N=2048) for B = 1 .. 4, and at k+1 = 3 with a 64-bit
   decomposition, signed and unsigned, shared and per-row LUTs, against
   its plain version (the torch composition it replaced), timed at tlu4's
   B = 1 and 4 cold and with the key in L2, beside its bytes bound, the
   plain version and ``torch._int_mm`` on the padded product alone;
3. serves the committed deployment archive (``table[x] - y`` over 1024
   encrypted 4-bit pairs, 128-bit parameters, N=1024): ``Server.load`` on
   CUDA, ``Client.keygen`` from a seed, three requests, decryptions checked
   against the plaintext, with every blind-rotate step counted through
   kernels A and B; then the same requests in the JAX package's "pallas"
   banded mode (``kernels.BANDED_MM_MODE``), every step through kernels A,
   9 and the recombine, whose output ciphertexts must equal the first
   three's bit for bit; then one blind rotate of 64 ciphertexts in each of
   the five banded modes, whose accumulators must be equal; then the
   latency blind rotate (B <= 4) at the ``pbs_latency_b1`` configuration
   (BENCH_PARAMS_4BIT_TPUOPT, truncated key): lookups at B = 1 and 4
   decrypted right, each lookup one launch of the prologue and one of the
   persistent kernel and no other port kernel, three single lookups timed
   and one traced
   (``torch.profiler``: device-busy ms, kernels run, launch calls); the
   B = 1 and 4 outputs equal, bit for bit, to the three-kernel step loop
   on the card (kernel 1, kernel 9's latency form and the recombine once a
   step, counted as a path of its own), the B = 1 one also to
   ``pbs_batch`` on CPU copies of the keys and ciphertexts (every kernel's
   plain version);
4. holds each kernel of the CRT-NTT blind rotate bit-exact against its
   plain PyTorch version on the card, over a few blind-rotate steps at the
   shapes the N=4096 QuantizedMLP archive gives them (256 ciphertexts,
   l=2, 3 primes, acc32 and full accumulator), at N=16384 with a small
   batch, with a truncated key (t > 0), at B=5 for N in 1024 .. 8192
   (kernel 3 is compiled once per N), and with k+1 = 3 (N=2048 and
   16384, both accumulator modes), 4 and 7 (kernel 3's accumulators
   beyond two in shared memory), k+1 = 4 at N=16384 and 8 at N=8192
   (kernel 3 in groups of output components), and times them; then
   kernel 2: its pack entry and its standalone forward and inverse at the
   MLP key pack's shape (6576 polynomials, 3 primes, N=4096, signed 64-bit
   inputs with the edge values), at every N from 4 to 16384, with primes
   far below 2^31, and the pack of a truncated key at N = 1024 .. 16384;
   the NTT kernels' operations bounds count the instructions nvcc
   emitted, per pipe, from the SASS of the probes in
   ``csrc/op_probes.cu``; then the CRT-NTT blind rotate at B <= 4 in one
   launch (``blind_rotate_fused_latency``, one cluster per ciphertext) at
   the three model lookups' shapes (Levenshtein's N=1024, k+1 = 3, l = 2, 3
   primes; the 16-key database's N=2048, l = 1, 3 primes, 7 bits truncated;
   the 2-key database's l = 2, 2 primes, 27 bits), at B = 1 and 4 in both
   accumulator modes over a few steps against its plain version and the
   three-kernel loop on the card, then over a whole lookup's steps against
   the loop (Levenshtein's B = 1 also against the plain version), timed
   beside the loop and beside variant builds without the key rows, without
   the spectra's exchange, without the transforms and without the Garner;
   the MLP's shape, which its rule refuses; and kernels 1, 3 and 4 timed at
   Levenshtein's B = 1 shape;
5. serves the committed ``mlp_q2_b64.zip`` archive (the repo's benchmark
   QuantizedMLP over 64 samples, 128-bit parameters, N=4096, 256 lookups
   per request): ``Server.load`` on CUDA, ``Client.keygen`` from a seed,
   the key pack on the device (one launch of kernel 2's pack entry, its
   FusedBSK then held equal to the one the plain version builds, and the
   pack timed again part by part: the KSK's upload and limb split on the
   card, the BSK's upload, the pack kernel), three requests
   whose decryptions must equal the graph's clear evaluation, every
   blind-rotate step counted through the digit, external-product and
   Garner kernels;
6. runs 1024 direct lookups of 6-bit inputs through ``pbs_batch`` with
   the same keys, twice: (3v + 1) % 64 decoded at 6 bits, whose wrong
   count must lie within 4 sigma of the noise model's (these parameters
   leave a blind rotate's output too noisy for 6 output bits;
   ``tools/witness_br_noise.py`` measures the same rate through the JAX
   package on the CPU), and ((3v + 1) % 64) >> 3 decoded
   at 3 bits, nearly all right (the MLP's outputs are all zero, so this is
   the phase whose outputs vary);
7. compiles with the port (host code, each compile timed) the fixture
   tool's ``table_sub`` and ``QuantizedMLP`` over 64 samples,
   ``examples/table_lookup.py``'s ``f`` and ``examples/quickstart.py``'s
   ``add`` (written again with the port: the examples import the JAX
   package), at the default ``Configuration()``; saves ``table_sub`` and
   the MLP, which must equal the committed archives; serves both compiled
   circuits on the card with keys from the seed, two requests each, on
   the same ciphertexts as the archive-loaded ``Server`` (output
   ciphertexts bit-identical, decryptions right, every blind-rotate step
   counted); runs every input of table_lookup through
   ``encrypt_run_decrypt`` (one ``blind_rotate_latency`` launch per
   lookup, a cluster of 4 blocks at k+1 = 5), holds its outputs against
   the same runs on CPU copies of the keys, traces one run, and runs one
   with the untruncated key (8 key limbs: one launch a lookup on a key
   ring of one slot), equal to the same run through the three-kernel step
   loop and on the CPU; and quickstart's
   ``add`` on the card, no port kernel launched;
8. the models phase: five of the JAX package's model circuits compiled by
   the port at the default ``Configuration()`` — GameOfLife(8, 8),
   LevenshteinDistance(8, 8, 2), StaticKeyValueDatabase over 16 keys,
   HammingDistance(32 words of 4 bits, "packed") and
   PrivateInformationRetrieval over 16 x 16 4-bit values — each
   compiled, keyed and packed (seconds printed), two requests whose
   decryptions must equal the model's clear function, whose output
   ciphertexts must equal those of ``Server.load`` on the model's own
   saved archive, and whose launches must be those of the blind-rotate
   form each lookup node takes (printed: persistent kernel (GameOfLife's
   64 lookups, one launch each), step loop, banded scan, fused
   persistent kernel (one launch of ``blind_rotate_fused_latency`` a
   lookup node run: Levenshtein's and both databases') or fused loop);
   one request traced (device busy, idle share, launches); every kernel
   call of the same requests on the
   archive-loaded ``Server``, at each shape, held bit-exact to its plain
   version on the card on the same inputs (the key packs' too);
   StaticKeyValueDatabase over 2 keys (0 and 30: the 16-key database's
   N=2048 fused key, truncated) also against the same run on CPU copies
   of the keys.  Requests are random
   inputs within the bounds the compile's inputset measured, through
   ``Circuit.run`` on the keys its packing rule gives.  Where the rule
   truncates a fused key (its noise is a reference fault, ROADMAP queue
   3), the same ciphertexts run again on the exact key, whose
   decryptions are held to the clear function, and the path's wrong
   count is printed;
9. the multi phase: three multi-partition circuits compiled by the port
   at the default ``Configuration()``, ``PrimeMatch(10, 10, 10, 50)``,
   ``PrimeMatch(5, 5, 4, 7)`` and ``HammingDistance(32, 4)`` with
   ``via="xor"``, and one with a WoP partition, ``(ts[x], tb[y])`` (a
   2-bit table beside a 9-bit one: x in a partition at the v0 search's
   2-bit parameters, y in one at the mono compile's WoP parameters and
   gadgets, N=4096, a conversion keyswitch after the WoP lookup; its
   memory estimate checked first), served as the models are (two requests through
   ``Circuit.run`` within the compiled bounds, output ciphertexts equal
   to the archive-loaded ``Server``'s, each lookup node's launches those
   of its blind-rotate form on its partition's key, every kernel call held
   to its plain version): each partition's BSK form and N, compile,
   keygen and pack seconds per partition and conversion key, the
   conversion keyswitches a request (``torch._int_mm`` limb GEMMs, each
   frontier's held to the same keyswitch on CPU copies and timed at its
   shape), one traced request, and the wrong
   decryptions against ``PrimeMatch.match_clear`` and
   ``HammingDistance.distance_clear`` beside the noise model's expected
   failing decisions (``compilation.multi.decision_failures``);
10. the module phase: fhe.module compiled by the port at the default
   ``Configuration()`` and served on the card, its composition cases (a
   chain of two functions over ciphertexts, one function run five times on
   its own output, a ``NotComposable`` and a ``Wired`` module; the chain
   once more from a module compiled with ``compress_input_ciphertexts``,
   its keyset loaded from the insecure key cache), decryptions held to the
   clear function, each function's launches those of its lookup nodes'
   forms; then ``Sha1`` at ``Configuration(p_error=1e-8)``: compile, keygen
   and one pack per norm2 timed, ``hexdigest(b"abc", mode="run")`` (80
   rounds, 5,355 B=1 lookups in one launch each of the fused persistent
   kernel, 80 B=32 lookups on the CRT-NTT loop) held to hashlib, served
   on the exact keys where the rule truncates a fused key (the rule's
   28-bit keys gave a wrong digest on every run so far, ROADMAP
   queue 3; their digest is no longer served, for the smoke's time), each
   function's calls and ms a call, one ``round_add`` call traced with its
   argument uploads' share, the kernel calls of one ``choose`` call and of
   the first two lookup nodes of one ``round_add`` call held to their
   plain versions; and ``hexdigest(b"abc")`` in the default
   simulate mode (the host simulation, no keys) held to hashlib;
11. the node-kinds phase: five small circuits holding every node kind the
   models do not (the levelled and shape kinds, runtime clear inputs and
   clear outputs, per-element, multivariate, dynamic and control lookups,
   rounding, conv, maxpool, fancy indices, assign, trace), run through
   ``Circuit.run`` (and on the exact key, as above) and decrypted
   against the graph's clear evaluation (rounding ties, which the noise
   decides in both packages, counted apart), every kernel call held to
   its plain version on the same inputs; then fhe.bits, fhe.crt_tlu and a
   10-bit lookup (WoP-PBS at N=256), also held to the CPU's plain path;
12. the wop phase: kernel 3's keyed entry (a key per ciphertext) and
   kernel 2's pack entry at the vertical packing's shapes against their
   plain versions, timed (PIR over 64 rows' N=8192, cbs_level 5 among
   them); PrivateInformationRetrieval over 32 rows of 16 (a 9-bit WoP row
   fetch at N=4096) and over 64 rows (11 bits at N=8192, a PFPKSK of
   65,544 GLWE rows, 8.6 GB) served as the models are, each PFPKSK made
   and split on the card (its draws, product and pack timed) and its
   launches by kernel;
13. the bigint phase: ``bench.py``'s BASELINE config 4 (``radix_add`` of
   16-bit integers as 4 x 4-bit limbs, B = 512 a request) and one circuit
   of ``radix_mul`` (mod 2^16), ``radix_lt`` and ``radix_eq`` of 16-bit
   integers as 8 x 2-bit limbs at B = 4 (multi-partition), compiled at the
   default ``Configuration()`` and served as the models and the multi
   circuits are, decryptions held to the clear integers;
14. the tfhers phase: a TFHE-rs ``FheUint8`` (4 blocks of 2 + 2 bits) over
   32 values, encrypted on the host under a shared key of TFHE-rs's big
   dimension (4096) at its noise, serialized as tfhe-rs bincode, imported
   (the conversion keyswitch on the card), run through
   ``from_native(table[to_native(blocks)])`` with an 8-bit table, exported
   as bincode (the keyswitch back), parsed and decrypted under the shared
   key, held to the table;
15. the scheduler phase: the composition counter chained through
   ``run_async`` futures, and two ``Circuit.run_async`` calls at once on a
   fresh circuit (their first calls: one key pack), each output held bit
   for bit to sequential ``run`` calls;
16. the cli phase: ``python -m concrete_tpu_torch compile``, ``inspect``,
   ``keygen`` and ``run`` as subprocesses on a 4-bit lookup, on the
   default device (the card), ``run``'s printed result held to the table;
17. the parallel phase (``parallel/``): one process per visible card,
   this script started again (``--parallel-rank``), the ranks joined in a
   torch.distributed group with the NCCL backend; each makes its keys from
   the smoke's seed, rank 0 packs them and ``replicate_keys`` broadcasts
   them.  A batch-sharded PBS of 1024 ciphertexts at
   BENCH_PARAMS_4BIT_TPUOPT (``sharded_pbs_fn`` on each rank's shard,
   kernels A and B, then ``gather``), bit-equal to ``pbs_batch`` on the
   whole batch on one card, 0 wrong, PBS/s per rank and
   ``scaling_report``; the table archive's ``Server.run`` on each rank's
   shard, gathered, bit-equal to the unsharded run; and the limb-sharded
   PBS (``pbs_batch_limb_sharded``, kernels 1 and 4 a step, all-to-all
   exchanges between the four-step NTT's stages) at BENCH_PARAMS_6BIT
   (N=4096), B = 2, bit-equal to ``blind_rotate_ntt`` and to ``pbs_batch``
   on an exact banded key on one card, 0 wrong, with the rank's spectrum
   shard (N/D wide) and its time a request.  The ranks run on several
   cards only where the machine has several GPUs: on one card the group
   has one rank, and every collective runs over that rank alone;
Between steps 5 and 6 (after the first kernel checks), the key bodies:
``core/keygen.py``'s product on the card held bit for bit to the host's
at N=8192, a BSK and a PFPKSK made on the card to the host numpy
keygen's from one seed, and the product timed on a chunk of rows at
N=4096, 8192 and 16384 beside its bound; from there to the end of the
parallel phase, every key's bodies are computed on the card and a call
of the host's product fails the smoke.

18. prints one JSON line per the kernels run (each one's launches
   include those of the models, multi, module, wop, bigint, tfhers,
   scheduler and parallel phases' requests), then the result line.

Any failed phase exits non-zero before the result line.  Without CUDA, or
next to no checkout of the port, it exits non-zero at once.
``tools/smoke_phases.py`` runs the models, multi, module, node-kinds,
wop, bigint, tfhers, scheduler, cli and parallel phases alone.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "concrete_tpu_torch", "fixtures",
                       "table_sub_u4_b1024.zip")
OUT_DIR = os.path.join(HERE, "chiprun_out")
SEED = 20261016
REQUESTS = 3
TABLE = [(3 * v + 1) % 16 for v in range(16)]
# H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 tensor-core ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1.979e15
# about 0.1 s of spinning at the H100's clock: longer than the host takes
# to queue any timed run of launches below
SPIN_CYCLES = 200_000_000
MLP_FIXTURE = os.path.join(HERE, "concrete_tpu_torch", "fixtures",
                           "mlp_q2_b64.zip")
DIRECT_LOOKUPS = 1024
DIRECT_TABLE = [(3 * v + 1) % 64 for v in range(64)]
FIXTURE_TOOL = os.path.join(HERE, "tools", "make_torch_fixture.py")
COMPILED_REQUESTS = 2
#: examples/table_lookup.py's table and examples/quickstart.py's inputset
LOOKUP_TABLE = [2, 1, 3, 0]
QUICKSTART_INPUTSET = [(2, 3), (0, 0), (7, 7)]
FUSED_KERNELS = ("rotate_decompose_digits", "crt_external_product",
                 "garner_accumulate")
LATENCY_KERNELS = ("rotate_decompose_digits", "banded_matmul_latency",
                   "recombine_accumulate")
FUSED_LATENCY = "blind_rotate_fused_latency"
CRT_SCAN = "blind_rotate_crt_scan"
#: GameOfLife's B=1 lookups (any size) as the port compiles them at the
#: default Configuration(): N=2048, k+1 = 2, l = 2, base 2^7, 5 kept key
#: limbs (3 truncated), 758 steps; the persistent kernel's plan takes it
#: with a key ring of one slot
GOL_LATENCY = dict(kp1=2, levels=2, n=2048, s_key=5, base_log=7,
                   limb_offset=3)
GOL_STEPS = 758
#: variant builds of the persistent latency kernel, each without one part
LATENCY_VARIANTS = {"no MMA": "ABLATE_NO_MMA",
                    "no key rows": "ABLATE_NO_KEY"}
#: the parts of a step its PHASE_CLOCKS build counts (thread 0 of block 0)
LATENCY_PHASES = ("bands", "acc copy in", "digits", "key wait", "MMA",
                  "warp reduction", "slot release",
                  "recombine and cluster barrier")
#: the models' CRT-NTT lookups, as the port compiles them at the default
#: Configuration(): (N, k+1, l, base_log, primes, truncated bits, n_small)
#: of LevenshteinDistance(8, 8, 2), StaticKeyValueDatabase over 16 keys
#: and over keys 0 and 30; and the MLP archive's, which the rule of
#: ops/fused_latency.py refuses (its key ring of two steps is 256 KB)
FUSED_LATENCY_SHAPES = {"levenshtein": (1024, 3, 2, 11, 3, 0, 718),
                        "kvdb_16": (2048, 2, 1, 21, 3, 7, 758),
                        "kvdb_2": (2048, 2, 2, 9, 2, 27, 758)}
MLP_FUSED_SHAPE = (4096, 2, 2, 8, 3, 0, 822)
#: the batches of CRT-NTT lookups that ops/crt_scan.py's rule takes:
#: (B, N, l, base_log, primes, truncated bits, steps) of the key-value
#: query's two levels (kvdb32) and radix_add's (its steps cut to 200); the
#: rule refuses the MLP's N = 4096 and PrimeMatch 10's N = 8192 (more
#: threads a block than keep 168 registers each)
CRT_SCAN_SHAPES = {"kvdb32_b2048": (2048, 2048, 1, 23, 3, 9, 760),
                   "kvdb32_b256": (256, 2048, 1, 23, 3, 9, 760),
                   "radix_add": (512, 2048, 2, 10, 2, 28, 200)}
#: variant builds of the B <= 4 CRT-NTT kernel, each without one part
FUSED_LATENCY_VARIANTS = {"no key rows": "ABLATE_NO_KEY",
                          "own spectra only": "ABLATE_LOCAL_SPECTRA",
                          "no transforms": "ABLATE_NO_TRANSFORMS",
                          "no Garner": "ABLATE_NO_GARNER"}
#: the models phase: two requests of each model, at the sizes below
MODEL_REQUESTS = 2
GOL_SIZE = (8, 8)       # N=2048's one-slot key ring, 64 B=1 lookups
#                         (16 x 16 before: cut for the smoke's time)
LATENCY_CPU_BATCHES = (1,)   # B=4 on the CPU's plain kernels took 34 s; its
#                              output stays held to the step loop's
LEVENSHTEIN = (8, 8, 2)                 # lengths and alphabet bits
# the model's default inputset of 12 string pairs leaves most 8 x 8 pairs'
# values out of its bounds (ROADMAP queue 3); 256 pairs give the same
# parameters and message width, and bounds that random pairs fall within
LEVENSHTEIN_INPUTSET = 256
KVDB_KEYS = list(range(0, 32, 2))
KVDB_VALUES = [(3 * i + 1) % 16 for i in range(16)]
# two keys at the ends of the 16-key range: the 16-key database's N=2048
# and 5-bit messages, a fused key that the packing rule truncates (2
# primes, 27 bits), and 2 lookups, few enough for the CPU's plain path
KVDB_CPU_KEYS = [0, 30]
HAMMING = (32, 4)                       # words, bits a word
PRIME_MATCH_10 = (10, 10, 10, 50)       # bank and client orders, symbols,
PRIME_MATCH_5 = (5, 5, 4, 7)            # largest quantity (both multi)
# 16 rows: the row fetch is a native lookup; at 32 rows it is 9 bits wide
# and lowers to WoP-PBS, at 64 rows 11 bits (N=8192; its PFPKSK has 65,544
# GLWE rows, 8.6 GB as u64, made on the card): the wop phase serves both
PIR_SHAPE = (16, 16)
PIR_WOP_SHAPE = (32, 16)
PIR_64_SHAPE = (64, 16)
PIR_64_GADGETS = (5, 3, 4, 6)   # its compile's (cbs_level, cbs_base_log,
#                                 pfks_level, pfks_base_log), 11 bits
# the multi phase's circuit with a WoP partition, (ts[x], tb[y]): a 2-bit
# table beside a 9-bit one of 6-bit values, whose mono compile is PIR over
# 32 rows' class (N=4096, 9 bits); partitions set explicitly (multi_wop)
MULTI_WOP_TS = [3, 1, 2, 0]
MULTI_WOP_TB = [(5 * i + 2) % 64 for i in range(1 << 9)]
# the key bodies' product on the card (core/keygen.py): f64 matmuls, bound
# by the FP64 tensor cores' peak (NVIDIA's H100 SXM data sheet, dense)
PEAK_F64_OPS = 6.7e13
MODULE_LOOP = 5                         # inc run on its own output
SHA1_MESSAGE = b"abc"
SHA1_P_ERROR = 1e-8                     # tests/test_models.py's digest
SHA1_PROBES = 4                         # carry-chain calls a key form
# bench.py's BASELINE config 4: radix_add of 16-bit integers as 4 x 4-bit
# limbs, B = 512 a request (limb bits, limbs, batch)
RADIX_ADD = (4, 4, 512)
# radix_mul (mod 2^16), radix_lt and radix_eq of 16-bit integers as 8 x
# 2-bit limbs in one circuit, B = 4; its inputset: 20 random batches
RADIX_MUL = (2, 8, 4)
RADIX_MUL_INPUTSET = 20
# TFHE-rs's FheUint8 at PARAM_MESSAGE_2_CARRY_2: 32 values, their shared
# secret key of TFHE-rs's big LWE dimension, an 8-bit table
TFHERS_VALUES = 32
TFHERS_KEY_DIM = 4096
TFHERS_TABLE = [(37 * v + 11) % 256 for v in range(256)]
SCHEDULER_CHAINS = 8                    # the counter's chains, one an input
SCHEDULER_BATCH = 64                    # two concurrent run_async requests
CLI_TABLE = [(5 * v + 3) % 16 for v in range(16)]
CLI_ARG = 11
PARALLEL_BATCH = 1024                   # the batch-sharded PBS's ciphertexts
PARALLEL_LIMB_BATCH = 2                 # the limb-sharded PBS's
PARALLEL_TIMEOUT = 400                  # s for every rank of the phase
KEYED = "crt_external_product_keyed"
LOOKUP_KINDS = ("tlu", "univariate", "multivariate", "dynamic_tlu")
# Operations bounds of the CRT-NTT kernels.  The NTT kernels (2, 3) are
# charged the instructions of their butterflies, pointwise multiply-adds
# and 1/N scaling as nvcc compiles them: sass_mix() reads them per pipe
# from the probes of csrc/op_probes.cu.  Per SM and clock, sm_90 issues one
# 32-thread instruction per scheduler (4) and each pipe takes 64 (16 for
# the conversion/special-function unit): CUDA C programming guide,
# arithmetic instruction throughput, compute capability 9.0.  Index
# arithmetic, loads and stores are left out, so the bound is a floor.
PIPE_RATES = {"alu": 64, "fma": 64, "fp64": 64, "xu": 16}
ISSUE_PER_CLOCK_PER_SM = 128
PIPES = {op: pipe for pipe, ops in {
    "fma": ("IMAD", "IMUL", "IDP"),
    "alu": ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
            "ICMP", "SEL", "FSEL", "LEA", "IMNMX", "VIMNMX", "IABS", "PRMT",
            "PLOP3", "P2R", "R2P", "MOV", "FSETP", "BMSK", "SGXT"),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP"),
    "xu": ("MUFU", "I2F", "F2I", "F2F", "I2I", "FRND", "POPC", "FLO",
           "BREV"),
}.items() for op in ops}
SASS_OP = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                     r"([A-Z][A-Z0-9_.]*)")
PROBED = ("ct_butterfly", "gs_butterfly", "mul_add", "shoup_mul")
# The digit and Garner kernels (1, 4) move bytes per coefficient and are
# charged a hand tally of their instructions, kernel 1 10 + 6 per level,
# kernel 4 14 per prime + 8, all on one 64-per-clock pipe.  Their bytes
# time is 2x-3x that, twice as much at the issue rate, so a tally short
# of the compiled count by less than that leaves them bytes-bound.
OPS_GARNER_PRIME, OPS_GARNER = 14, 8
ONE_PIPE_PER_CLOCK_PER_SM = 64


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over `iters` back-to-back calls, by CUDA
    events, after a warm-up.  A spin kernel ahead of the first event holds
    the card while the host queues every call, so a kernel that costs the
    host more to launch than the card to run is timed on the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rand_torus(rng, shape, device):
    import numpy as np
    import torch
    u = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    return torch.from_numpy(u.view(np.int64)).to(device)


def rand_i8(rng, shape, device, bound=128):
    import numpy as np
    import torch
    return torch.from_numpy(rng.integers(-bound, bound, shape)
                            .astype(np.int8)).to(device)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def check_rotate_decompose(rng, *, rows, n, base_log, levels, a_limbs,
                           timed):
    import numpy as np
    import torch
    from concrete_tpu_torch.ops import step
    dev = "cuda"
    acc = rand_torus(rng, (rows, n), dev)
    a_rows = torch.from_numpy(rng.integers(0, 2 * n, rows)
                              .astype(np.int32)).to(dev)
    kw = dict(base_log=base_log, levels=levels, a_limbs=a_limbs)
    got = step.rotate_decompose(acc, a_rows, **kw)
    want = step.rotate_decompose_plain(acc, a_rows, **kw)
    torch.cuda.synchronize()
    shape = f"rows={rows} N={n} base_log={base_log} l={levels} A={a_limbs}"
    if not torch.equal(got, want):
        fail(f"rotate_decompose differs from its plain version at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        rec["ms"] = cuda_ms(lambda: step.rotate_decompose(acc, a_rows, **kw),
                            50)
        rec["plain_ms"] = cuda_ms(
            lambda: step.rotate_decompose_plain(acc, a_rows, **kw), 5)
        nbytes = rows * n * 8 + rows * 4 + levels * a_limbs * rows * n
        rec.update(bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                   library_ms=None, bytes=nbytes)
    print(f"rotate_decompose bit-exact at {shape}: {rec}", flush=True)
    return rec


def check_external_product(rng, *, batch, levels, kp1, n, a_limbs,
                           s_planes, keep, limb_offset, timed):
    import torch
    from concrete_tpu_torch.ops import external_product as xp
    dev = "cuda"
    cin = levels * kp1
    planes = rand_i8(rng, (levels * a_limbs, batch * kp1, n), dev)
    vv = rand_i8(rng, (cin, kp1, s_planes, 2 * n - 1), dev)
    acc = rand_torus(rng, (batch * kp1, n), dev)
    kw = dict(keep=keep, limb_offset=limb_offset)
    got = xp.external_product_accumulate(planes, vv, acc.clone(), **kw)
    want = xp.external_product_accumulate_plain(planes, vv, acc.clone(), **kw)
    torch.cuda.synchronize()
    shape = (f"B={batch} l={levels} k+1={kp1} N={n} A={a_limbs} "
             f"S={s_planes} keep={keep} limb_offset={limb_offset}")
    if not torch.equal(got, want):
        fail(f"external_product_accumulate differs from its plain version "
             f"at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        scratch = acc.clone()
        rec["ms"] = cuda_ms(lambda: xp.external_product_accumulate(
            planes, vv, scratch, **kw), 10)
        rec["plain_ms"] = cuda_ms(lambda: xp.external_product_accumulate_plain(
            planes, vv, scratch, **kw), 3)
        lhs = xp.digit_lhs(planes, kp1, levels).contiguous()
        rhs = xp.toeplitz_rhs(vv, a_limbs, keep).contiguous()
        rec["library_ms"] = cuda_ms(lambda: torch._int_mm(lhs, rhs), 10)
        pairs = sum(1 for a in range(a_limbs) for p in range(keep)
                    if 0 <= p - a < s_planes)
        macs = batch * cin * kp1 * n * n * pairs
        nbytes = planes.numel() + vv.numel() + 2 * acc.numel() * 8
        t_ops, t_bytes = 2 * macs / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        rec.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   macs=macs, bytes=nbytes)
    print(f"external_product_accumulate bit-exact at {shape}: {rec}",
          flush=True)
    return rec


def check_banded_matmul(rng, *, a_limbs, rows, cin, cout, s_planes, n,
                        timed, levels=None):
    """Kernel 9 against its plain version (per-J-block torch._int_mm); with
    `levels`, on kernel A's digit planes (l*A, B*(k+1), N) read in place,
    as the "pallas" step passes them."""
    import torch
    from concrete_tpu_torch.ops import banded_mm as bm
    from concrete_tpu_torch.ops import external_product as xp
    if levels is None:
        lhs = rand_i8(rng, (a_limbs, rows, cin * n), "cuda")
    else:
        lhs = rand_i8(rng, (levels * a_limbs, rows * cin // levels, n),
                      "cuda")
    vv = rand_i8(rng, (cin, cout, s_planes, 2 * n - 1), "cuda")
    got = bm.banded_matmul(lhs, vv, levels=levels)
    want = bm.banded_matmul_plain(lhs, vv, levels=levels)
    torch.cuda.synchronize()
    shape = (f"A={a_limbs} B={rows} Cin={cin} Cout={cout} S={s_planes} "
             f"N={n} levels={levels}")
    if not torch.equal(got, want):
        fail(f"banded_matmul differs from its plain version at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        rec["ms"] = cuda_ms(lambda: bm.banded_matmul(lhs, vv, levels=levels),
                            20)
        rec["plain_ms"] = cuda_ms(lambda: bm.banded_matmul_plain(
            lhs, vv, levels=levels), 3)
        if levels is None:
            lhs_cat = lhs.permute(1, 0, 2).reshape(rows, -1)
        else:
            lhs_cat = xp.digit_lhs(lhs, cin // levels, levels)
            # the same product on the JAX package's stacked copy, and the
            # copy itself: what reading kernel A's planes in place saves
            stacked = bm.stacked_lhs(lhs, cin // levels, levels)
            rec["stacked_ms"] = cuda_ms(lambda: bm.banded_matmul(stacked, vv),
                                        20)
            rec["stack_copy_ms"] = cuda_ms(lambda: bm.stacked_lhs(
                lhs, cin // levels, levels), 20)
        # torch._int_mm takes more than 16 rows: zero rows pad the lhs
        lhs_cat = torch.nn.functional.pad(
            lhs_cat, (0, 0, 0, max(0, 17 - rows))).contiguous()
        rhs = xp.toeplitz_rhs(vv, a_limbs, got.shape[2]).contiguous()
        rec["library_ms"] = cuda_ms(lambda: torch._int_mm(lhs_cat, rhs), 10)
        macs = rows * cout * a_limbs * s_planes * cin * n * n
        rec.update(bound(2 * macs / PEAK_INT8_OPS * 1e3,
                         lhs.numel() + vv.numel() + got.numel() * 4,
                         macs=macs, library_rows=lhs_cat.shape[0]))
    print(f"banded_matmul bit-exact at {shape}: {rec}", flush=True)
    return rec


def check_banded_matmul_latency(rng, *, batch, kp1, levels, n, s_key,
                                base_log, timed):
    """Kernel 9's latency form against its plain version (the latency
    step's glue, then banded_matmul_plain) on kernel 1's int32 digits (l,
    (k+1)*B, N) and a BSK step (Cin, k+1, S, 2N-1) read in place, as
    _blind_rotate_latency passes them: the second step of two, so its rows
    lie at odd offsets as in a packed key."""
    import numpy as np
    import torch
    from concrete_tpu_torch.core import limbs as lb
    from concrete_tpu_torch.ops import banded_mm as bm
    from concrete_tpu_torch.ops import external_product as xp
    cin = levels * kp1
    half = 1 << (base_log - 1)
    digits = torch.from_numpy(rng.integers(-half, half + 1,
                                           (levels, kp1 * batch, n))
                              .astype(np.int32)).cuda()
    w_vv = rand_i8(rng, (2, cin, kp1, s_key, 2 * n - 1), "cuda")[1]
    kw = dict(kp1=kp1, levels=levels, base_log=base_log)
    got = bm.banded_matmul_latency(digits, w_vv, **kw)
    want = bm.banded_matmul_latency_plain(digits, w_vv, **kw)
    torch.cuda.synchronize()
    shape = (f"B={batch} k+1={kp1} l={levels} N={n} S={s_key} "
             f"base_log={base_log}")
    if not torch.equal(got, want):
        fail(f"banded_matmul_latency differs from its plain version at "
             f"{shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        rec["ms"] = cuda_ms(lambda: bm.banded_matmul_latency(
            digits, w_vv, **kw), 200)
        rec["plain_ms"] = cuda_ms(lambda: bm.banded_matmul_latency_plain(
            digits, w_vv, **kw), 3)
        # torch._int_mm on the same product: the glue's lhs (its k+1 rows
        # zero-padded to 17) against the Toeplitz matrix of its band
        d_limbs = lb.num_digit_limbs(base_log)
        d = (digits.view(levels, kp1, batch, n).permute(2, 0, 1, 3)
             .reshape(batch, cin, n))
        vv_d = lb.i32_digits_to_balanced_i8(
            torch.cat([-d[..., 1:], d], dim=-1), d_limbs) \
            .permute(1, 0, 3, 2).contiguous()
        lhs_cat = w_vv[..., n - 1:].permute(1, 2, 0, 3).reshape(kp1, -1)
        lhs_cat = torch.nn.functional.pad(
            lhs_cat, (0, 0, 0, max(0, 17 - kp1))).contiguous()
        rhs = xp.toeplitz_rhs(vv_d, s_key, got.shape[2]).contiguous()
        rec["library_ms"] = cuda_ms(lambda: torch._int_mm(lhs_cat, rhs), 10)
        macs = kp1 * batch * s_key * d_limbs * cin * n * n
        nbytes = digits.numel() * 4 + cin * kp1 * s_key * n + got.numel() * 4
        rec.update(bound(2 * macs / PEAK_INT8_OPS * 1e3, nbytes, macs=macs,
                         library_rows=lhs_cat.shape[0]))
    print(f"banded_matmul_latency bit-exact at {shape}: {rec}", flush=True)
    return rec


def check_digits(rng, *, rows, n, base_log, levels, timed, clock):
    """Kernel 1 on a full int64 accumulator against its plain version: the
    latency path's front, at its shapes (k+1 rows per ciphertext)."""
    import numpy as np
    import torch
    from concrete_tpu_torch.ops import step
    acc = rand_torus(rng, (rows, n), "cuda")
    a_rows = torch.from_numpy(rng.integers(0, 2 * n, rows)
                              .astype(np.int32)).cuda()
    kw = dict(base_log=base_log, levels=levels)
    got = step.rotate_decompose_digits(acc, a_rows, **kw)
    want = step.rotate_decompose_digits_plain(acc, a_rows, **kw)
    torch.cuda.synchronize()
    shape = f"rows={rows} N={n} base_log={base_log} l={levels} full"
    if not torch.equal(got, want):
        fail(f"rotate_decompose_digits differs from its plain version at "
             f"{shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        rec["ms"] = cuda_ms(lambda: step.rotate_decompose_digits(
            acc, a_rows, **kw), 50)
        rec["plain_ms"] = cuda_ms(lambda: step.rotate_decompose_digits_plain(
            acc, a_rows, **kw), 5)
        rec.update(bound(tally_ms(rows * n * (10 + 6 * levels), clock),
                         acc.numel() * 8 + rows * 4 + got.numel() * 4),
                   library_ms=None)
    print(f"rotate_decompose_digits bit-exact at {shape}: {rec}", flush=True)
    return rec


def check_recombine(rng, *, rows, n_planes, n, limb_offset, timed):
    """The standalone recombine-accumulate against its plain version."""
    import numpy as np
    import torch
    from concrete_tpu_torch.ops import recombine as rc
    planes = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                           (rows, n_planes, n))
                              .astype(np.int32)).cuda()
    acc = rand_torus(rng, (rows, n), "cuda")
    kw = dict(limb_offset=limb_offset)
    got = rc.recombine_accumulate(planes, acc.clone(), **kw)
    want = rc.recombine_accumulate_plain(planes, acc.clone(), **kw)
    torch.cuda.synchronize()
    shape = f"rows={rows} P={n_planes} N={n} limb_offset={limb_offset}"
    if not torch.equal(got, want):
        fail(f"recombine_accumulate differs from its plain version at "
             f"{shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        scratch = acc.clone()
        rec["ms"] = cuda_ms(lambda: rc.recombine_accumulate(
            planes, scratch, **kw), 50)
        rec["plain_ms"] = cuda_ms(lambda: rc.recombine_accumulate_plain(
            planes, scratch, **kw), 5)
        used = min(n_planes, 8 - limb_offset)
        rec.update(bound(tally_ms(rows * n * 5 * used, sm_clock()),
                         rows * n * (4 * used + 16)), library_ms=None)
    print(f"recombine_accumulate bit-exact at {shape}: {rec}", flush=True)
    return rec


def check_prologue(rng, *, batch, n_small, n, kp1, ks_level, ks_base_log,
                   per_row, timed):
    """The PBS prologue kernel against its plain version (unsigned and
    signed, each launched twice: the first leaves its scratch zeroed for
    the second), at n_in = (k+1 - 1) N; timed, the kernel's ms a launch
    with the key in L2 (back to back) and cold (a 256 MB write between
    launches, timed apart), beside its bytes bound, the plain version's
    and torch._int_mm's on the padded product alone."""
    import numpy as np
    import torch
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.ops import prologue as pro
    from concrete_tpu_torch.params import CryptoParams
    p = CryptoParams(n_small=n_small, glwe_dimension=kp1 - 1,
                     polynomial_size=n, pbs_level=4, pbs_base_log=5,
                     ks_level=ks_level, ks_base_log=ks_base_log, lwe_std=0.0,
                     glwe_std=0.0, security_level=0)
    n_in, cols = (kp1 - 1) * n, n_small + 1
    ksk = kn.pack_ksk(rng.integers(0, 1 << 64, (n_in, ks_level, cols),
                                   dtype=np.uint64), p, device="cuda")
    ct = rand_torus(rng, (batch, n_in + 1), "cuda")
    lut = rand_torus(rng, (batch, n) if per_row else (n,), "cuda")
    shape = (f"B={batch} n_in={n_in} ks ({ks_level}, 2^{ks_base_log}) "
             f"n_out={n_small} N={n} k+1={kp1} "
             f"{'per-row' if per_row else 'shared'} LUT")
    for signed in (False, True):
        offset = pro.body_offset(4, signed)
        want = pro.pbs_prologue_plain(ct, ksk, lut, p, offset)
        for _ in range(2):
            got = pro.pbs_prologue(ct, ksk, lut, p, offset)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"pbs_prologue differs from its plain version at "
                     f"{shape}, signed={signed}")
    rec = {"max_abs_err": 0.0}
    if timed:
        def launch():
            pro.pbs_prologue(ct, ksk, lut, p, 0)
        rec["ms_l2"] = cuda_ms(launch, 50)
        flush = torch.empty(1 << 28, dtype=torch.int8, device="cuda")
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(50)]
        launch()
        for start, end in marks:
            flush.fill_(1)
            start.record()
            launch()
            end.record()
        torch.cuda.synchronize()
        rec["ms"] = sum(s.elapsed_time(e) for s, e in marks) / len(marks)
        rec["plain_ms"] = cuda_ms(lambda: pro.pbs_prologue_plain(
            ct, ksk, lut, p, 0), 10)
        k_rows = n_in * ks_level
        lhs = torch.zeros((17, k_rows), dtype=torch.int8, device="cuda")
        rhs = ksk.planes.reshape(k_rows, cols * 8)
        rec["library_ms"] = cuda_ms(lambda: torch._int_mm(lhs, rhs), 50)
        key_bytes = ksk.planes.numel()
        io_bytes = 8 * batch * (n_in + 1) + 4 * batch * n_small \
            + 8 * kp1 * batch * n + 8 * lut.numel()
        # a 64-bit multiply-add: about 4 integer-pipe instructions
        rec.update(bound(tally_ms(4 * batch * k_rows * cols, sm_clock()),
                         key_bytes + io_bytes), key_bytes=key_bytes)
    print(f"pbs_prologue bit-exact at {shape}: {rec}", flush=True)
    return rec


def build_variant(out_dir: str, sources: tuple, name: str,
                  switches: list):
    """Start nvcc on `sources` (in the port's csrc/) with the ABLATE_*
    `switches` defined, into out_dir/<name>.so; `load_variant` waits for
    the returned process."""
    from concrete_tpu_torch.ops import _build
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *[f"-D{d}" for d in switches],
         "-shared", "-o", os.path.join(out_dir, f"{name}.so"),
         *[os.path.join(_build.CSRC, src) for src in sources]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_variant(out_dir: str, name: str, proc, entry: str):
    """The C entry point `entry` of a variant build, bound as the port
    binds it, and its ptxas lines (registers, spills)."""
    import ctypes
    from concrete_tpu_torch.ops import _build
    out, _ = proc.communicate()
    if proc.returncode:
        fail(f"nvcc failed on the variant {name}:\n{out}")
    fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    regs = [line.split("info    :")[-1].strip() for line in out.splitlines()
            if "registers" in line or "spill" in line]
    return fn, regs


def check_blind_rotate_latency(rng, *, batch, kp1, levels, n, s_key,
                               base_log, n_small, limb_offset, timed,
                               plain=True, variants=None, clocks=None):
    """The persistent latency blind rotate against its plain version (the
    step loop on the plain versions of kernel 1, kernel 9's latency form
    and the recombine) and against the three-kernel step loop on the card,
    on random switched masks, accumulators and keys.  Timed: ms per
    lookup (n_small steps), beside the plain version, the step loop, and
    each variant build in `variants` (label -> its C entry point, the
    same arguments: "no MMA" is the chain floor, "no key rows" leaves the
    key ring's copies out); with `clocks` (the PHASE_CLOCKS build's entry
    point and its reader), the clocks of each part of a step.  With
    `plain` False the plain version (about 7.5 ms a step at B=1, N=1024 on
    the card) is left out."""
    import numpy as np
    import torch
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import limbs as lb
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import latency as lat
    cin = levels * kp1
    a_t = torch.from_numpy(rng.integers(0, 2 * n, (batch, n_small))
                           .astype(np.int32)).cuda()
    acc = rand_torus(rng, (kp1, batch, n), "cuda")
    planes = lat.with_tail(rand_i8(rng, (n_small, cin, kp1, s_key,
                                         2 * n - 1), "cuda"))
    kw = dict(kp1=kp1, levels=levels, base_log=base_log,
              limb_offset=limb_offset)
    bsk = kn.LimbBSK(planes=planes, base_log=base_log, levels=levels,
                     truncate_limbs=limb_offset)
    params = fused_params(n, levels, base_log, n_small, kp1)
    got = lat.blind_rotate_latency(a_t, acc.clone(), planes, **kw)
    want = lat.blind_rotate_latency_plain(a_t, acc, planes, **kw) \
        if plain else got
    steps = kn._blind_rotate_latency_steps(a_t, acc.clone(), bsk, params)
    torch.cuda.synchronize()
    d_limbs = lb.num_digit_limbs(base_log)
    shape = (f"B={batch} k+1={kp1} l={levels} N={n} S={s_key} "
             f"base_log={base_log} steps={n_small} "
             f"limb_offset={limb_offset}")
    if not torch.equal(got, want):
        fail(f"blind_rotate_latency differs from its plain version at "
             f"{shape}")
    if not torch.equal(got, steps):
        fail(f"blind_rotate_latency differs from the three-kernel step loop "
             f"at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want)}
    if timed:
        scratch = acc.clone()     # updated in place by every timed call
        rec["ms"] = cuda_ms(lambda: lat.blind_rotate_latency(
            a_t, scratch, planes, **kw), 5)
        if plain:
            rec["plain_ms"] = cuda_ms(lambda: lat.blind_rotate_latency_plain(
                a_t, acc, planes, **kw), 1)
        rec["step_loop_ms"] = cuda_ms(lambda: kn._blind_rotate_latency_steps(
            a_t, scratch, bsk, params), 1)
        pl = lat.plan(batch, n, kp1, levels, d_limbs, s_key)
        stream = _build.stream_of(acc)

        def call(fn, label):
            _build.check(label, fn(
                a_t.data_ptr(), scratch.data_ptr(),
                planes.data_ptr(), planes.data_ptr() + planes.numel(),
                batch, n_small, kp1, levels, base_log, d_limbs, s_key, n,
                limb_offset, pl.cluster, stream))
        rec["variants_ms"] = {
            label: cuda_ms(lambda fn=fn, label=label: call(fn, label), 5)
            for label, fn in (variants or {}).items()}
        rec["chain_floor_ms"] = rec["variants_ms"].get("no MMA")
        if clocks:
            fn_c, read = clocks
            read()                           # zeroes the clocks
            call(fn_c, "phase clocks")
            torch.cuda.synchronize()
            rec["clocks_per_step"] = {
                name: c / n_small for name, c in zip(LATENCY_PHASES,
                                                     read())}
        macs = n_small * kp1 * batch * s_key * d_limbs * cin * n * n
        nbytes = a_t.numel() * 4 + 2 * acc.numel() * 8 \
            + n_small * cin * kp1 * s_key * n
        rec.update(bound(2 * macs / PEAK_INT8_OPS * 1e3, nbytes, macs=macs),
                   library_ms=None, cluster=pl.cluster, ltb=pl.ltb,
                   slots=pl.slots, smem=pl.smem)
    print(f"blind_rotate_latency bit-exact (against its plain version and "
          f"the step loop on the card) at {shape}: {rec}", flush=True)
    return rec


def serve(rng):
    """The port's main path: three requests of 1024 table lookups, on the
    device Server.load picks by default (CUDA), in the default banded mode
    (kernels A and B)."""
    import torch
    import concrete_tpu_torch as tfhe
    server = tfhe.Server.load(FIXTURE)
    if server.device.type != "cuda":
        fail(f"Server.load defaulted to {server.device}")
    specs = server.client_specs
    p = specs.params
    print(f"archive: {os.path.basename(FIXTURE)} params={p} "
          f"message_bits={specs.message_bits}", flush=True)
    client = tfhe.Client(specs)
    t0 = time.perf_counter()
    client.keygen(seed=SEED)
    keygen_s = time.perf_counter() - t0
    ev = client.evaluation_keys
    t0 = time.perf_counter()
    _, bsk = ev.packed(specs.message_bits, norm2=server.graph.max_norm2(),
                       device=server.device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    print(f"keygen {keygen_s:.2f} s, pack+upload {pack_s:.2f} s, "
          f"BSK limb truncation {bsk.truncate_limbs}", flush=True)
    size = specs.inputs[0].shape[0]
    requests = [(rng.integers(0, 16, size), rng.integers(0, 16, size))
                for _ in range(REQUESTS)]
    encrypted = [client.encrypt(x, y) for x, y in requests]
    state = (server, client, ev, requests, encrypted)
    run = serve_requests(*state, "auto",
                         {"rotate_decompose": p.n_small,
                          "external_product_accumulate": p.n_small})
    run.update(keygen_s=keygen_s, pack_s=pack_s, n_small=p.n_small,
               truncate_limbs=bsk.truncate_limbs, state=state, bsk=bsk)
    return run


def serve_requests(server, client, ev, requests, encrypted, mode,
                   want_counts):
    """Three table requests with kernels.BANDED_MM_MODE = `mode` and the
    evaluation keys `ev` (packed on their first use, then cached); each
    must launch exactly `want_counts` (kernel name -> launches, 0 for
    none)."""
    import numpy as np
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.ops import _build
    p = server.client_specs.params
    size = requests[0][0].shape[0]
    wrong, walls, per_request, outs = 0, [], [], []
    kn.BANDED_MM_MODE = mode
    try:
        _build.reset_launches()           # this path's run starts here
        for (x, y), (cx, cy) in zip(requests, encrypted):
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            (out,) = server.run(cx, cy, evaluation_keys=ev)
            walls.append(time.perf_counter() - t0)
            per_request.append({k: v - before.get(k, 0)
                                for k, v in _build.LAUNCHES.items()
                                if v - before.get(k, 0)})
            if out.shape != (size, p.n_big + 1) or out.dtype != np.uint64:
                fail(f"output ciphertexts {out.shape} {out.dtype}")
            outs.append(out)
            got = client.decrypt(out)
            wrong += int(np.count_nonzero(got != np.array(TABLE)[x] - y))
        launches = dict(_build.LAUNCHES)   # ... and ends here
    finally:
        kn.BANDED_MM_MODE = "auto"
    total = REQUESTS * size
    for i, (wall, counts) in enumerate(zip(walls, per_request)):
        print(f"{mode} request {i}: {size} lookups in {wall:.3f} s = "
              f"{size / wall:.1f} PBS/s, launches {counts}", flush=True)
        for name, want in want_counts.items():
            if counts.get(name, 0) != want:
                fail(f"{mode} request {i} launched {name} "
                     f"{counts.get(name, 0)} times, want {want}")
    allowed = max(2, 1e-3 * total)
    print(f"{mode} decryptions wrong: {wrong} of {total} (allowed "
          f"{allowed})", flush=True)
    if wrong > allowed:
        fail(f"{mode}: {wrong} wrong decryptions of {total}")
    return {"walls_s": walls, "pbs_per_s": [size / w for w in walls],
            "wrong": wrong, "lookups": total, "launches": launches,
            "per_request": per_request, "outputs": outs}


def serve_pallas(run):
    """The table archive again, in the JAX package's "pallas" banded mode:
    the same keys and ciphertexts, kernel A then kernel 9 then the
    standalone recombine at every step, and the "auto" outputs' bits."""
    import numpy as np
    n_small = run["n_small"]
    pal = serve_requests(*run["state"], "pallas",
                         {"rotate_decompose": n_small,
                          "banded_matmul": n_small,
                          "recombine_accumulate": n_small,
                          "external_product_accumulate": 0})
    for i, (a, b) in enumerate(zip(run["outputs"], pal["outputs"])):
        if not np.array_equal(a, b):
            fail(f"pallas request {i}: output ciphertexts differ from the "
                 f"auto mode's")
    print("pallas-mode output ciphertexts equal the auto mode's, bit for "
          "bit", flush=True)
    return pal


def check_modes(rng, bsk, params, batch=64):
    """One blind rotate of `batch` ciphertexts in each banded mode, with the
    served archive's key: the accumulators must be equal."""
    import torch
    from concrete_tpu_torch.core import kernels as kn
    ct = rand_torus(rng, (batch, params.n_small + 1), "cuda")
    lut = rand_torus(rng, (params.polynomial_size,), "cuda")
    ref_acc, walls = None, {}
    try:
        for mode in kn.BANDED_MM_MODES:
            kn.BANDED_MM_MODE = mode
            t0 = time.perf_counter()
            acc = kn.blind_rotate(ct, bsk, lut, params)
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            if ref_acc is None:
                ref_acc = acc
            elif not torch.equal(acc, ref_acc):
                fail(f"banded mode {mode} gives another accumulator than "
                     f"{kn.BANDED_MM_MODES[0]}")
    finally:
        kn.BANDED_MM_MODE = "auto"
    print(f"blind rotate of {batch} ciphertexts equal in every banded mode; "
          f"walls s {walls}", flush=True)
    return walls


def latency_lookups(rng):
    """The latency blind rotate (B <= LATENCY_BATCH_MAX) at the
    pbs_latency_b1 configuration, BENCH_PARAMS_4BIT_TPUOPT with its key
    truncation: keys from a seed, pbs_batch at B = 1 and 4 with the
    decryptions checked, each lookup one launch of the prologue
    (pbs_prologue) and one of the persistent kernel (blind_rotate_latency)
    and no other port kernel, then three timed
    single lookups and one traced; then the B = 1 and B = 4 outputs against
    the three-kernel step loop on the card (the route of the shapes the
    persistent kernel's rule refuses, driven here through the same
    pbs_batch with the rule refusing every shape, its launches counted as
    their own path) and, at B in LATENCY_CPU_BATCHES, against the same
    pbs_batch on CPU copies of the keys and ciphertexts (the plain versions
    of every kernel), bit for bit."""
    import numpy as np
    import torch
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import latency as lat
    from concrete_tpu_torch.ops import prologue as pro
    params = pp.BENCH_PARAMS_4BIT_TPUOPT
    t0 = time.perf_counter()
    sk, server_keys = kg.keygen_device(np.random.default_rng(SEED), params,
                                       "cuda")
    trunc = pp.choose_truncate_limbs(params, 4)
    ksk = kn.pack_ksk(server_keys.ksk, params, device="cuda")
    bsk = kn.pack_bsk(server_keys.bsk, params, trunc, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lut = torch.from_numpy(ref.encode_expand_lut(
        np.array(TABLE, dtype=np.uint64), params.polynomial_size, 4)
        .view(np.int64)).cuda()
    n_small = params.n_small
    print(f"latency path: {params}, truncate_limbs {trunc}, keygen and "
          f"pack {setup_s:.2f} s", flush=True)

    def run(ct, want_counts):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = kn.pbs_batch(ct, ksk, bsk, lut, params, 4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        if counts != want_counts:
            fail(f"a B={ct.shape[0]} latency lookup launched {counts}, want "
                 f"{want_counts}")
        return wall, counts, out

    def lookup(batch):
        msgs = rng.integers(0, 16, batch)
        ct = torch.from_numpy(kg.encrypt_lwe_batch(
            rng, sk.lwe_big, ref.encode(msgs, 4), params.glwe_std)
            .view(np.int64)).cuda()
        # one launch of the prologue, one of the persistent kernel for
        # every step
        wall, counts, out = run(ct, {pro.NAME: 1, lat.NAME: 1})
        dec = ref.decode(ref.lwe_decrypt(
            sk.lwe_big, out.cpu().numpy().view(np.uint64)), 4)
        wrong = int(np.count_nonzero(dec != np.array(TABLE)[msgs]))
        if wrong:
            fail(f"latency lookups at B={batch}: {wrong} wrong of {batch}")
        return wall, counts, ct, out

    _build.reset_launches()               # the latency path starts here
    checked = {batch: lookup(batch) for batch in (1, 4)}
    timed = [lookup(1) for _ in range(3)]
    launches = dict(_build.LAUNCHES)       # ... and ends here
    walls = [w for w, *_ in timed]
    print(f"latency lookups right at B=1 and B=4 "
          f"({ {b: r[0] for b, r in checked.items()} } s); three B=1 "
          f"lookups {[f'{w * 1e3:.1f}' for w in walls]} ms, launches per "
          f"lookup {timed[0][1]}", flush=True)
    traced = trace_lookup(lambda: lookup(1), n_small)

    # the step loop's path: the same keys and ciphertexts, three port
    # kernels per step
    plan = lat.plan
    lat.plan = lambda *args: None
    _build.reset_launches()               # the step loop's path starts here
    try:
        steps_want = {**dict.fromkeys(LATENCY_KERNELS, n_small),
                      pro.NAME: 1}
        for batch, (_, _, ct, out) in checked.items():
            if not torch.equal(run(ct, steps_want)[2], out):
                fail(f"the B={batch} latency lookup's output differs from "
                     f"the three-kernel step loop's on the card")
        step_walls = [run(checked[1][2], steps_want)[0] for _ in range(3)]
    finally:
        lat.plan = plan
    step_launches = dict(_build.LAUNCHES)  # ... and ends here
    print(f"latency outputs at B=1 and B=4 equal the three-kernel step "
          f"loop's on the card, bit for bit; its B=1 lookups "
          f"{[f'{w * 1e3:.1f}' for w in step_walls]} ms", flush=True)
    ksk_cpu, bsk_cpu = cpu_keys(ksk, bsk)
    cpu_s = {}
    for batch, (_, _, ct, out) in checked.items():
        if batch not in LATENCY_CPU_BATCHES:
            continue
        t0 = time.perf_counter()
        want = kn.pbs_batch(ct.cpu(), ksk_cpu, bsk_cpu, lut.cpu(), params, 4)
        cpu_s[batch] = time.perf_counter() - t0
        if not torch.equal(out.cpu(), want):
            fail(f"the B={batch} latency lookup's output differs from the "
                 f"plain path's on the CPU")
    print(f"latency outputs at B={list(cpu_s)} equal the plain path's on "
          f"the CPU, bit for bit ({cpu_s} s)", flush=True)
    return {"setup_s": setup_s, "truncate_limbs": trunc, "checked_s":
            {b: r[0] for b, r in checked.items()}, "b1_walls_s": walls,
            "per_lookup": timed[0][1], "launches": launches,
            "step_loop_b1_walls_s": step_walls,
            "step_loop_launches": step_launches,
            "cpu_plain_s": cpu_s, "traced_b1": traced}


def profile_run(fn, host_ops: bool = True):
    """fn() under torch.profiler: its result, then the device's kernels as
    (name, count, device ms) rows, busiest first, the kernels the device
    ran and the launch calls the host made, as the trace counts them.
    Without `host_ops` the host's operators go unrecorded (fewer events
    for a request of half a million launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        result = fn()
    # the trace's raw events, summed here: torch parses them into its own
    # event objects only when asked, which takes minutes at a million
    by_name, launch_calls = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            count, ms = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (count + 1, ms + e.duration_ns() / 1e6)
        elif e.device_type() == DeviceType.CPU \
                and e.name().startswith("cudaLaunchKernel"):
            launch_calls += 1
    rows = sorted(((k, c, ms) for k, (c, ms) in by_name.items()),
                  key=lambda r: -r[2])
    kernels = sum(c for k, c, _ in rows
                  if not k.startswith(("Memcpy", "Memset")))
    return result, rows, kernels, launch_calls


def trace_lookup(lookup, n_small, label="one traced B=1 latency lookup"):
    """One B=1 latency lookup under torch.profiler: its wall, the port's
    launches per blind-rotate step by kernel name, the device-busy ms, and
    the kernels the device ran and the launch calls the host made, as the
    trace counts them."""
    (wall, counts, *_), rows, kernels, launch_calls = profile_run(lookup)
    rec = {"wall_s": wall, "device_busy_ms": sum(ms for *_, ms in rows),
           "per_step": {k: v / n_small for k, v in counts.items()},
           "device_kernels": kernels, "launch_calls": launch_calls,
           "by_kernel": [{"name": k, "count": c, "device_ms": ms}
                         for k, c, ms in rows[:12]]}
    print(f"{label}: wall {wall * 1e3:.1f} ms, device "
          f"busy {rec['device_busy_ms']:.2f} ms, port launches per step "
          f"{rec['per_step']}, kernels run {kernels}, launch calls "
          f"{launch_calls}", flush=True)
    for k, c, ms in rows[:8]:
        print(f"  {ms:9.3f} ms {c:6d}x  {k[:90]}", flush=True)
    return rec


def compile_circuits():
    """The port's compile path (host code): the slice's four circuits at
    the default Configuration(), each compile timed.  table_sub and the
    MLP take the fixture tool's definitions, table_lookup and quickstart
    the examples' functions written with the port."""
    import importlib.util
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.models import QuantizedMLP
    spec = importlib.util.spec_from_file_location("make_torch_fixture",
                                                  FIXTURE_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    table = tfhe.LookupTable(tool.TABLE)

    @tfhe.compiler({"x": "encrypted", "y": "encrypted"})
    def table_sub(x, y):
        return table[x] - y

    lut = tfhe.LookupTable(LOOKUP_TABLE)

    @tfhe.compiler({"x": "encrypted"})
    def f(x):
        return lut[x] + tfhe.univariate(lambda v: v // 2)(x)

    @tfhe.compiler({"x": "encrypted", "y": "encrypted"})
    def add(x, y):
        return x + y

    jobs = {"table_sub": lambda: table_sub.compile(tool.inputset()),
            "mlp": lambda: QuantizedMLP().compile(
                tfhe.Configuration(), batch_size=tool.MLP_BATCH),
            "table_lookup": lambda: f.compile(range(len(LOOKUP_TABLE))),
            "quickstart": lambda: add.compile(QUICKSTART_INPUTSET)}
    circuits, seconds = {}, {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        circuits[name] = job()
        seconds[name] = time.perf_counter() - t0
        c = circuits[name]
        if c.device.type != "cuda":
            fail(f"the compiled {name} circuit defaulted to {c.device}")
        print(f"compiled {name} in {seconds[name]:.3f} s: "
              f"{c.client_specs.params}, message_bits "
              f"{c.client_specs.message_bits}, "
              f"{c.programmable_bootstrap_count} PBS per run", flush=True)
    return circuits, seconds


def same_archive(committed: str, path: str) -> None:
    """Specs and array payloads byte for byte, the graph up to node uids
    (tests/test_torch_server.py's _assert_same_archive)."""
    import io
    import zipfile
    with zipfile.ZipFile(committed) as a, zipfile.ZipFile(path) as b:
        if a.read("client.specs.json") != b.read("client.specs.json"):
            fail(f"{path}: client specs differ from {committed}")

        def graph(z):
            rec = json.loads(z.read("graph.json"))
            for node in rec["nodes"]:
                node["uid"] = None
            return rec
        if graph(a) != graph(b):
            fail(f"{path}: graph.json differs from {committed}")
        with zipfile.ZipFile(io.BytesIO(a.read("graph_arrays.npz"))) as na, \
                zipfile.ZipFile(io.BytesIO(b.read("graph_arrays.npz"))) as nb:
            if na.namelist() != nb.namelist() or any(
                    na.read(n) != nb.read(n) for n in na.namelist()):
                fail(f"{path}: graph arrays differ from {committed}")


def serve_compiled(rng, circuit, archive, inputs, want_counts, decoded):
    """A compiled circuit against the archive it saves: keys from the
    seed, the circuit's keyset packed once on the card, then on the same
    ciphertexts the circuit's run and the archive-loaded Server's, whose
    output ciphertexts must be equal bit for bit; every request launches
    `want_counts` (or want_counts(circuit) once its keys are packed, where
    it is callable), and decoded(x, got) counts its wrong decryptions."""
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    server = tfhe.Server.load(archive)
    specs = circuit.client_specs
    t0 = time.perf_counter()
    circuit.keygen(seed=SEED)
    keygen_s = time.perf_counter() - t0
    encrypted = [circuit.encrypt(*x) for x in inputs]
    encrypted = [ct if isinstance(ct, tuple) else (ct,) for ct in encrypted]
    t0 = time.perf_counter()
    ev = circuit.keys.evaluation_for(specs.message_bits,
                                     norm2=circuit.graph.max_norm2(),
                                     device=circuit.device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if callable(want_counts):
        want_counts = want_counts(circuit)
    name = os.path.basename(archive)
    walls, archive_walls, wrong, values = [], [], 0, 0
    _build.reset_launches()               # this path's run starts here
    for i, (x, ct) in enumerate(zip(inputs, encrypted)):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = circuit.run(*ct)
        walls.append(time.perf_counter() - t0)
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        for kernel, want in want_counts.items():
            if counts.get(kernel, 0) != want:
                fail(f"compiled {name} request {i} launched {kernel} "
                     f"{counts.get(kernel, 0)} times, want {want}")
        t0 = time.perf_counter()
        (ref,) = server.run(*ct, evaluation_keys=ev)
        archive_walls.append(time.perf_counter() - t0)
        if out.dtype != np.uint64 or not np.array_equal(out, ref):
            fail(f"compiled {name} request {i}: output ciphertexts differ "
                 f"from the archive-loaded Server's")
        w, n = decoded(x, circuit.decrypt(out), server)
        wrong, values = wrong + w, values + n
    launches = dict(_build.LAUNCHES)       # ... and ends here
    allowed = max(2, 1e-3 * values)
    print(f"compiled {name}: keygen {keygen_s:.2f} s, pack {pack_s:.3f} s; "
          f"requests {[f'{w:.4f}' for w in walls]} s, the archive-loaded "
          f"Server's on the same ciphertexts "
          f"{[f'{w:.4f}' for w in archive_walls]} s, output ciphertexts equal bit for bit; wrong decryptions "
          f"{wrong} of {values} (allowed {allowed}); launches {launches}",
          flush=True)
    if wrong > allowed:
        fail(f"compiled {name}: {wrong} wrong decryptions of {values}")
    return {"keygen_s": keygen_s, "pack_s": pack_s, "walls_s": walls,
            "archive_walls_s": archive_walls, "wrong": wrong,
            "values": values, "launches": launches}


def compiled_lookups(circuit):
    """examples/table_lookup.py's circuit, compiled by the port (k=4,
    N=256, l=3): every input through encrypt_run_decrypt on the card,
    each B=1 lookup one launch of the prologue and one of the persistent
    kernel (a cluster of 4 blocks, k+1 = 5) and no other port kernel; the
    outputs of a run on
    the card against the same run on CPU copies of the packed keys (every
    kernel's plain version), bit for bit; one run traced; then one run
    with the untruncated key (8 key limbs: a key ring of one slot), one
    launch of the persistent kernel a lookup, against the same run
    through the three-kernel step loop and on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import latency as lat
    from concrete_tpu_torch.ops import prologue as pro
    specs, p = circuit.client_specs, circuit.client_specs.params
    circuit.keygen(seed=SEED)
    ksk, bsk = circuit.keys.evaluation_for(specs.message_bits,
                                           norm2=circuit.graph.max_norm2(),
                                           device=circuit.device)
    kp1, s_key = p.glwe_dimension + 1, 8 - bsk.truncate_limbs
    plan = lat.plan(1, p.polynomial_size, kp1, p.pbs_level, 1, s_key)
    if plan is None or plan.cluster != 4:
        fail(f"the persistent kernel's rule gives {plan} at N="
             f"{p.polynomial_size}, k+1={kp1}, l={p.pbs_level}, "
             f"{s_key} key limbs; want a cluster of 4")
    lookups = circuit.programmable_bootstrap_count
    want = {pro.NAME: lookups, lat.NAME: lookups}

    def run(ct, keys, want_counts):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        (out,) = circuit.server.run(ct, evaluation_keys=keys)
        wall = time.perf_counter() - t0
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        if counts != want_counts:
            fail(f"a compiled table_lookup run launched {counts}, want "
                 f"{want_counts}")
        return wall, counts, out

    _build.reset_launches()               # this path's run starts here
    walls, results = [], []
    for v in range(len(LOOKUP_TABLE)):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        got = circuit.encrypt_run_decrypt(v)
        walls.append(time.perf_counter() - t0)
        counts = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()
                  if n - before.get(k, 0)}
        if counts != want or got != LOOKUP_TABLE[v] + v // 2:
            fail(f"table_lookup({v}) = {got} with launches {counts}; want "
                 f"{LOOKUP_TABLE[v] + v // 2} with {want}")
        ct = circuit.encrypt(v)
        results.append((ct, run(ct, (ksk, bsk), want)))
    launches = dict(_build.LAUNCHES)       # ... and ends here
    traced = trace_lookup(lambda: run(results[0][0], (ksk, bsk), want),
                          p.n_small * lookups,
                          label=f"one traced compiled table_lookup run "
                                f"({lookups} B=1 lookups)")
    cpu = tfhe.Server(circuit.graph, specs, device="cpu")
    ksk_cpu, bsk_cpu = cpu_keys(ksk, bsk)
    t0 = time.perf_counter()
    for v, (ct, (_, _, out)) in enumerate(results):
        (want_out,) = cpu.run(ct, evaluation_keys=(ksk_cpu, bsk_cpu))
        if not np.array_equal(out, want_out):
            fail(f"compiled table_lookup({v}): the card's output differs "
                 f"from the plain path's on the CPU")
    cpu_s = time.perf_counter() - t0
    # the untruncated key: the persistent kernel with a key ring of one
    # slot at 8 key limbs, then the step loop on the same ciphertexts
    full = kn.pack_bsk(circuit.keys.server.bsk, p, 0, device=circuit.device)
    full_plan = lat.plan(1, p.polynomial_size, kp1, p.pbs_level, 1, 8)
    if full_plan is None or full_plan.slots != 1:
        fail(f"the persistent kernel's rule gives {full_plan} for the "
             f"untruncated key; want a key ring of one slot")
    ct = results[-1][0]
    _build.reset_launches()               # the untruncated key's path ...
    full_wall, _, out = run(ct, (ksk, full), want)
    full_launches = dict(_build.LAUNCHES)  # ... ends here
    steps = {**dict.fromkeys(LATENCY_KERNELS, p.n_small * lookups),
             pro.NAME: lookups}
    rule = lat.plan
    lat.plan = lambda *args: None
    _build.reset_launches()               # the step loop's path starts here
    try:
        step_wall, _, step_out = run(ct, (ksk, full), steps)
    finally:
        lat.plan = rule
    step_launches = dict(_build.LAUNCHES)  # ... and ends here
    (want_out,) = cpu.run(ct, evaluation_keys=(ksk_cpu,
                                               cpu_keys(ksk, full)[1]))
    if not np.array_equal(out, step_out):
        fail("compiled table_lookup with the untruncated key: the "
             "persistent kernel's output differs from the step loop's")
    if not np.array_equal(out, want_out) \
            or circuit.decrypt(out) != LOOKUP_TABLE[-1] + 1:
        fail("compiled table_lookup with the untruncated key: the "
             "output differs from the CPU's or decrypts wrong")
    print(f"compiled table_lookup: {plan}; encrypt_run_decrypt of every "
          f"input right, {[f'{w * 1e3:.1f}' for w in walls]} ms; server "
          f"runs ({lookups} lookups) "
          f"{[f'{r[0] * 1e3:.1f}' for _, r in results]} ms, launches {results[0][1][1]}; equal to the CPU's plain path "
          f"({cpu_s:.1f} s); untruncated key {full_wall * 1e3:.1f} ms, "
          f"launches {full_launches}, equal to the step loop's "
          f"({step_wall * 1e3:.1f} ms, launches {step_launches}) and to "
          f"the CPU's", flush=True)
    return {"plan": dataclasses.asdict(plan), "lookups_per_run": lookups,
            "encrypt_run_decrypt_s": walls,
            "run_walls_s": [r[0] for _, r in results],
            "launches": launches, "traced": traced, "cpu_plain_s": cpu_s,
            "untruncated_plan": dataclasses.asdict(full_plan),
            "untruncated_wall_s": full_wall,
            "untruncated_launches": full_launches,
            "step_loop_wall_s": step_wall, "step_loop_launches":
            step_launches}


def compile_phase(rng):
    """The port compiles the slice's circuits, saves the archives the JAX
    package wrote, and serves what it compiled on the card."""
    import tempfile
    import numpy as np
    from concrete_tpu_torch.ops import _build
    circuits, compile_s = compile_circuits()
    with tempfile.TemporaryDirectory() as d:
        for name, archive in (("table_sub", FIXTURE), ("mlp", MLP_FIXTURE)):
            path = os.path.join(d, os.path.basename(archive))
            circuits[name].server.save(path)
            same_archive(archive, path)
    print("Server.save of the compiled table_sub and MLP equals the "
          "committed archives", flush=True)
    ts = circuits["table_sub"]
    n_ts = ts.client_specs.params.n_small
    size = ts.client_specs.inputs[0].shape[0]
    table = serve_compiled(
        rng, ts, FIXTURE,
        [(rng.integers(0, 16, size), rng.integers(0, 16, size))
         for _ in range(COMPILED_REQUESTS)],
        {"rotate_decompose": n_ts, "external_product_accumulate": n_ts},
        lambda x, got, _: (int(np.count_nonzero(
            got != np.array(TABLE)[x[0]] - x[1])), size))
    mlp_c = circuits["mlp"]
    shape = tuple(mlp_c.client_specs.inputs[0].shape)
    mlp = serve_compiled(
        rng, mlp_c, MLP_FIXTURE,
        [(rng.integers(0, 4, shape),) for _ in range(COMPILED_REQUESTS)],
        lambda c: br_form(c._evaluation_keys()[1], c.client_specs.params,
                          c.programmable_bootstrap_count)[1],
        lambda x, got, server: (int(np.count_nonzero(
            got != np.asarray(server.graph(x[0])))), got.size))
    lookup = compiled_lookups(circuits["table_lookup"])
    qs = circuits["quickstart"]
    qs.keygen(seed=SEED)
    _build.reset_launches()               # the levelled path starts here
    for x, y in [(2, 6)] + QUICKSTART_INPUTSET:
        got = qs.encrypt_run_decrypt(x, y)
        if got != x + y:
            fail(f"compiled quickstart add({x}, {y}) = {got}")
    if _build.LAUNCHES:
        fail(f"the levelled quickstart circuit launched {_build.LAUNCHES}")
    print(f"compiled quickstart: add(2, 6) = 8 and the inputset's pairs "
          f"right on {qs.device}, no port kernel launched", flush=True)
    return {"compile_s": compile_s, "table_sub": table, "mlp": mlp,
            "table_lookup": lookup}


def br_form(bsk, p, batch: int, min_scale: int = None,
            prologue: bool = True) -> tuple:
    """(form, launches) of one blind rotate of `batch` ciphertexts on the
    packed key `bsk` at parameters `p`: the form core.kernels.blind_rotate
    takes (the persistent kernel where ops/latency.plan takes the shape,
    else the step loop, at B <= LATENCY_BATCH_MAX; the banded scan above;
    for a fused key, ops/fused_ntt.blind_rotate_form's: the CRT-NTT kernel
    of ops/fused_latency.py where its plan takes the shape and the
    accumulator's mode at B <= LATENCY_BATCH_MAX, else ops/crt_scan.py's
    one launch where its plan takes them, else the CRT-NTT loop;
    `min_scale`, a WoP sign
    PBS's smallest output scale, gates the acc32 mode) and the port
    launches it makes there, with, where `prologue` (a lookup through
    core.kernels.pbs_batch, not a WoP sign PBS), the one launch of
    ops/prologue.py before a banded blind rotate at B <=
    LATENCY_BATCH_MAX."""
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import limbs as lb
    from concrete_tpu_torch.ops import fused_latency as fl
    from concrete_tpu_torch.ops import latency as lat
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.ops import prologue as pro
    from concrete_tpu_torch.ops.fused_ntt import FusedBSK, acc32_eligible
    steps = p.n_small
    if isinstance(bsk, FusedBSK):
        shape = (batch, p.polynomial_size, p.glwe_dimension + 1,
                 bsk.levels, len(bsk.primes), acc32_eligible(bsk, min_scale))
        form = fn.blind_rotate_form(*shape)
        if form == "crt_ntt_loop":
            return "fused loop", dict.fromkeys(FUSED_KERNELS, steps)
        if form == "crt_ntt_scan":
            return "fused one-launch scan", {CRT_SCAN: 1}
        return f"fused persistent kernel (cluster of " \
            f"{fl.plan(*shape).cluster})", {fl.NAME: 1}
    if batch > kn.LATENCY_BATCH_MAX:
        return f"banded scan ({kn.BANDED_MM_MODE})", {
            "rotate_decompose": steps, "external_product_accumulate": steps}
    s_key = bsk.planes.shape[3]
    plan = lat.plan(batch, p.polynomial_size, p.glwe_dimension + 1,
                    p.pbs_level, lb.num_digit_limbs(p.pbs_base_log), s_key)
    first = {pro.NAME: 1} if prologue else {}
    if plan is None:
        return f"step loop ({s_key} key limbs)", \
            {**first, **dict.fromkeys(LATENCY_KERNELS, steps)}
    return f"persistent kernel (cluster of {plan.cluster}, {s_key} key " \
        f"limbs)", {**first, lat.NAME: 1}


def wop_counts(circuit) -> dict:
    """The launches the WoP-PBS design fixes for one request: one pack of
    each chunk's GGSWs (kernel 2's pack entry; a crt_tlu's sibling residues
    share it) and nb keyed products for each vertical packing of a
    chunk."""
    import numpy as np
    from concrete_tpu_torch.core import kernels_wop as kw
    ex = circuit.server._executor
    out, sets = {"ntt_forward_pack": 0, KEYED: 0}, set()
    for node in circuit.graph.topological_order():
        spec = ex.wop_specs.get(node.uid)
        if spec is None:
            continue
        size = max(int(np.prod(node.output.shape)), 1)
        chunks = -(-size // kw.chunk_size(
            ex.wop_params_for(ex.lookup_partition(node)), spec.nb_bits))
        key = tuple(q.uid for q in circuit.graph.ordered_preds_of(node)) \
            if node.name == "crt_tlu" else node.uid
        if key not in sets:
            sets.add(key)
            out["ntt_forward_pack"] += chunks
        out[KEYED] += spec.nb_bits * chunks
    return {k: v for k, v in out.items() if v}


class wop_schedule:
    """Within the block, the calls core/kernels_wop.py makes: each sign-PBS
    batch (its rows and smallest output scale), each transform of a
    chunk's GGSWs and each vertical packing (its bits).  launches(bsk, p)
    gives the port launches those calls make on the packed key `bsk`: a
    sign PBS its blind rotate's (br_form), a transform one of kernel 2's
    pack entry, a vertical packing a keyed product and a Garner a bit and
    kernel 1's digits a rotation bit; and the sign PBS's forms."""

    NOTES = {
        "sign_pbs_batch": lambda lwe, ksk, bsk, params, scales: (
            lwe.shape[0], min(int(s) for s in scales)),
        "ggsw_spectra": lambda *args: (),
        "vertical_packing_batch": lambda lut, keys, wp: (keys.shape[1],)}

    def __init__(self):
        self.calls, self.saved = [], []

    def __enter__(self):
        from concrete_tpu_torch.core import kernels_wop as kw
        for attr, note in self.NOTES.items():
            fn = getattr(kw, attr)
            self.saved.append((kw, attr, fn))

            def recorded(*args, _fn=fn, _attr=attr, _note=note):
                self.calls.append((_attr,) + _note(*args))
                return _fn(*args)
            setattr(kw, attr, recorded)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)

    def launches(self, bsk, p) -> tuple:
        out, forms = {}, set()

        def add(name, n):
            out[name] = out.get(name, 0) + n
        for attr, *note in self.calls:
            if attr == "sign_pbs_batch":
                form, more = br_form(bsk, p, *note, prologue=False)
                forms.add(form)
                for k, v in more.items():
                    add(k, v)
            elif attr == "ggsw_spectra":
                add("ntt_forward_pack", 1)
            else:
                nb = note[0]
                add(KEYED, nb)
                add("garner_accumulate", nb)
                add("rotate_decompose_digits",
                    min(nb, p.polynomial_size.bit_length() - 1))
        return out, sorted(forms)


def lookup_forms(circuit, bsk) -> dict:
    """{uid: (kind, pbs, form, launches)} of every encrypted lookup node:
    a native lookup is one blind rotate of its elements (pbs: the
    elements), in the form br_form gives, with its launches; a WoP-PBS
    node's pbs is the statistics' count (elements x extracted bits, and
    for fhe.bits the lsb cascade's unshared count), its launches those
    of the calls it makes (wop_schedule, read on the run)."""
    import numpy as np
    p = circuit.client_specs.params
    ex = circuit.server._executor
    forms = {}
    for node in circuit.graph.topological_order():
        if not node.output.is_encrypted or not (
                node.name in LOOKUP_KINDS + ("crt_tlu", "extract_bits")):
            continue
        batch = max(int(np.prod(node.output.shape)), 1)
        spec = ex.wop_specs.get(node.uid)
        if spec is None and node.name != "extract_bits":
            forms[node.uid] = (node.name, batch) + br_form(bsk, p, batch)
        elif spec is not None:
            forms[node.uid] = (node.name, batch * spec.nb_bits, "WoP-PBS",
                               {})
        else:       # the statistics' unshared count of the lsb cascade
            positions = node.properties["kwargs"]["positions"]
            forms[node.uid] = (node.name,
                               batch * (max(positions) + len(positions)),
                               "WoP-PBS", {})
    return forms


def key_form(bsk) -> str:
    """A packed bootstrap key's form and truncation, in words."""
    if hasattr(bsk, "primes"):
        return f"fused, {len(bsk.primes)} primes, {bsk.trunc_bits} bits " \
            f"truncated"
    return f"banded, {bsk.truncate_limbs} limbs truncated"


def cpu_keys(*keys):
    """CPU copies of packed keys (LimbKSK, LimbBSK or FusedBSK[,
    LimbPFPKSK])."""
    import dataclasses
    import torch
    return tuple(dataclasses.replace(k, **{
        f.name: getattr(k, f.name).cpu() for f in dataclasses.fields(k)
        if isinstance(getattr(k, f.name), torch.Tensor)}) for k in keys)


def covered_draws(circuit, draw, count: int, limit: int = 5000):
    """`count` inputs from draw(), each one whose every node value, in the
    graph's clear evaluation, lies within the bounds the compile's
    inputset measured: the inputs the compiled circuit is exact on (a value
    beyond them can overflow its encoding width).  Returns the inputs and
    the number of draws they took."""
    import numpy as np
    graph, out = circuit.graph, []
    for tries in range(1, limit + 1):
        x = draw()
        values = graph.evaluate(*x)
        if all(n.bounds is None or (np.min(v) >= n.bounds[0]
                                    and np.max(v) <= n.bounds[1])
               for n, v in values.items()):
            out.append(x)
            if len(out) == count:
                return out, tries
    fail(f"{count} of {limit} draws stay within the compiled bounds")


def exact_keys(circuit, ev):
    """None where the packing rule's key pair `ev` (what Circuit.run serves
    on) holds no truncated fused key; else the pair that decryptions are
    held on: the rule's KSK and the exact fused key (no bits dropped, the
    fewest primes whose range holds the external product), and a WoP
    circuit's PFPKSK.  The JAX
    package's fused truncation rule admits keys too noisy for their output
    width (ROADMAP queue 3); the port keeps its bits, so the rule's key
    serves the path and this one the decryption check."""
    if getattr(ev[1], "trunc_bits", 0) == 0:
        return None
    exact = exact_fused_key(circuit.keys.server.bsk,
                            circuit.client_specs.params, circuit.device)
    return (ev[0], exact) + tuple(ev[2:])


def exact_fused_key(bsk_u64, p, device):
    """The fused key of a u64 BSK with no bits dropped, on the fewest
    primes whose range holds the external product."""
    import math
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops.fused_ntt import pack_bsk_fused
    pool = host.special_ntt_primes(p.polynomial_size, 128)
    count = next(c for c in range(2, len(pool) + 1)
                 if math.prod(pool[:c]).bit_length() - 1
                 >= host.required_bits(p, 0))
    return pack_bsk_fused(bsk_u64, p, primes=pool[:count], trunc_bits=0,
                          device=device)


class timed_calls:
    """Within the block, each (module, function) of `targets` is timed on
    the host clock, the card synchronised after each call, its seconds
    summed by label in `.seconds`."""

    def __init__(self, targets: dict):
        self.targets, self.seconds, self.saved = targets, {}, []

    def __enter__(self):
        import torch
        for label, (module, attr) in self.targets.items():
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def timed(*args, _fn=fn, _label=label, **kwargs):
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[_label] = self.seconds.get(_label, 0.0) \
                    + time.perf_counter() - t0
                return out
            setattr(module, attr, timed)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)


class host_products:
    """From __enter__ on, every call of the host's key-body product
    (``core.keygen._negacyclic_dot_with_key``, the numpy keygen's) is
    counted: the card's key generation must make none."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        from concrete_tpu_torch.core import keygen as kg
        self.saved = kg._negacyclic_dot_with_key

        def counted(*args, _fn=self.saved):
            self.calls += 1
            return _fn(*args)
        kg._negacyclic_dot_with_key = counted
        return self

    def __exit__(self, *exc):
        from concrete_tpu_torch.core import keygen as kg
        kg._negacyclic_dot_with_key = self.saved


def setup_parts(seconds: dict) -> dict:
    """A keyset's set-up parts (``Keys.setup_seconds``) by key, rounded:
    the host's draws (thread seconds), the product on the card (with the
    uploads), the BSK's copy to the host, the KSK (host), and the
    PFPKSK's pack (its limb split on the card)."""
    out = {}
    for key, parts in seconds.items():
        if isinstance(parts, dict):
            for part, v in parts.items():
                out[f"{key} {part[:-2] if part.endswith('_s') else part}"] \
                    = round(v, 3)
        else:
            out[key[:-2] if key.endswith("_s") else key] = round(parts, 3)
    return out


def keygen_checks(rng):
    """The GLWE key bodies on the card (core/keygen.py's device path,
    core/wop.pfpksk_gen_device) against the host's numpy keygen: the
    product at N=8192 (PIR over 64 rows' ring) on masks with their top
    bits set and on edge words, a BSK from one seed at
    TEST_PARAMS_TINY_WIDE and at N=2048 (the Sha1 keyset's ring), in
    chunks of one and of several rows, and a PFPKSK at N=1024, each bit
    for bit; then the
    product timed on one chunk of rows (CHUNK_WORDS of masks) at N=4096,
    8192 and 16384 beside its bound: four f64 matmuls of (rows, N) by
    (N, N) over the FP64 tensor cores' peak, or its bytes (masks in, the
    matrix read, the body out) over the memory's."""
    import dataclasses
    import numpy as np
    import torch
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import wop
    from concrete_tpu_torch.core.refimpl import SecretKeys
    from concrete_tpu_torch.params import TEST_PARAMS_TINY_WIDE
    from concrete_tpu_torch.utils.csprng import SecureGenerator
    start = time.perf_counter()
    n = 8192
    masks = rng.integers(0, 1 << 64, (5, 1, n), dtype=np.uint64)
    masks[:, :, :64] |= np.uint64(0xFFFF) << np.uint64(48)
    masks[4, 0, :4] = [0, (1 << 64) - 1, 1 << 63, 0xFFFF]
    key = rng.integers(0, 2, (1, n)).astype(np.uint64)
    got = kg.negacyclic_dot_torch(torch.from_numpy(
        masks.view(np.int64)).cuda(), key).cpu().numpy().view(np.uint64)
    if not np.array_equal(got, kg._negacyclic_dot_with_key(masks, key)):
        fail("the key-body product on the card differs from the host's at "
             "N=8192")
    recs = {"product_equal_at": n}
    p2048 = dataclasses.replace(TEST_PARAMS_TINY_WIDE, n_small=16,
                                polynomial_size=2048)
    for params in (TEST_PARAMS_TINY_WIDE, p2048):
        k, n = params.glwe_dimension, params.polynomial_size
        sk_small = SecureGenerator(SEED).integers(0, 2, params.n_small,
                                                  dtype=np.uint64)
        gsk = SecureGenerator(SEED + 1).integers(0, 2, (k, n),
                                                 dtype=np.uint64)
        want = kg.make_bsk(SecureGenerator(SEED), sk_small, gsk, params)
        for words in (k * n, kg.CHUNK_WORDS):
            saved, kg.CHUNK_WORDS = kg.CHUNK_WORDS, words
            try:
                bsk = kg.make_bsk_device(SecureGenerator(SEED), sk_small,
                                         gsk, params, "cuda")
            finally:
                kg.CHUNK_WORDS = saved
            if not np.array_equal(bsk.cpu().numpy().view(np.uint64), want):
                fail(f"the BSK made on the card differs from the host's at "
                     f"N={n} (chunks of {words // (k * n)} rows)")
    p1024 = dataclasses.replace(p2048, polynomial_size=1024)
    sk = SecretKeys(lwe_small=sk_small, glwe=gsk[:, :1024].copy())
    wp = wop.WopParams(base=p1024, cbs_level=3, cbs_base_log=6,
                       pfks_level=2, pfks_base_log=10)
    want = wop.pfpksk_gen(SecureGenerator(SEED), sk, wp).pfpksk
    got = wop.pfpksk_gen_device(SecureGenerator(SEED), sk, wp, "cuda")
    if not np.array_equal(got.cpu().numpy().view(np.uint64), want):
        fail("the PFPKSK made on the card differs from the host's")
    recs["bit_equal"] = ["product N=8192", "BSK N=256", "BSK N=2048",
                         f"PFPKSK N=1024 ({want.shape[0] * want.shape[1] * want.shape[2]} rows)"]
    del got, want
    timed = {}
    for n in (4096, 8192, 16384):
        rows = kg.CHUNK_WORDS // n
        a = torch.randint(-(1 << 62), 1 << 62, (rows, 1, n),
                          dtype=torch.int64, device="cuda")
        mats = [kg.negacyclic_matrix(torch.randint(
            0, 2, (n,), dtype=torch.int64, device="cuda"))]
        ms = cuda_ms(lambda: kg.negacyclic_dot_torch(a, mats), 5)
        ops = 4 * 2 * rows * n * n
        nbytes = rows * n * 8 * 2 + n * n * 8
        ops_ms, bytes_ms = ops / PEAK_F64_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        timed[n] = {"rows": rows, "ms": ms, "bound_ms": max(ops_ms, bytes_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes", "us_a_row": ms * 1e3 / rows,
                    "matrix_bytes": n * n * 8}
        del a, mats
    torch.cuda.empty_cache()
    recs["product"] = timed
    recs["phase_s"] = time.perf_counter() - start
    print(f"key bodies on the card: bit-equal to the host's numpy keygen "
          f"({', '.join(recs['bit_equal'])}); the product on a chunk of "
          f"rows (ms, bound ms, bound by, us a row): "
          f"{ {n: (r['rows'], round(r['ms'], 4), round(r['bound_ms'], 4), r['bound_by'], round(r['us_a_row'], 3)) for n, r in timed.items()} }"
          f"; phase {recs['phase_s']:.1f} s", flush=True)
    return recs


def kernel_wrappers() -> dict:
    """{launch name: (module, wrapper, plain version)} of every kernel
    wrapper a served request or a key pack may launch; each plain version
    takes its wrapper's arguments."""
    from concrete_tpu_torch.ops import banded_mm as bm
    from concrete_tpu_torch.ops import crt_scan as cs
    from concrete_tpu_torch.ops import external_product as xp
    from concrete_tpu_torch.ops import fused_latency as fl
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.ops import latency as lat
    from concrete_tpu_torch.ops import ntt as tn
    from concrete_tpu_torch.ops import prologue as pro
    from concrete_tpu_torch.ops import recombine as rc
    from concrete_tpu_torch.ops import step
    return {name: (module, name, getattr(module, f"{name}_plain"))
            for module, name in (
                (step, "rotate_decompose"), (step, "rotate_decompose_digits"),
                (xp, "external_product_accumulate"), (bm, "banded_matmul"),
                (bm, "banded_matmul_latency"), (rc, "recombine_accumulate"),
                (lat, "blind_rotate_latency"), (fn, "crt_external_product"),
                (fn, KEYED), (fn, "garner_accumulate"),
                (tn, "ntt_forward_pack"), (fl, FUSED_LATENCY),
                (cs, CRT_SCAN), (pro, pro.NAME))}


class same_inputs:
    """Within the block, the first call of each kernel wrapper at each
    signature (its tensors' shapes and dtypes, its other arguments), and
    the CAPTURE_NTH-th (or the calls numbered in `nth`), keep copies of
    their arguments.  check() runs each
    kept call through the wrapper and through its plain version, each on
    fresh copies (some kernels write in place), and fails unless every
    output is equal bit for bit: the kernels held to their plain versions
    on the inputs a served request gave them."""

    CAPTURE_NTH = 100

    def __init__(self, label: str, nth: tuple = (1, CAPTURE_NTH)):
        self.label, self.kept, self.calls = label, {}, {}
        self.nth = nth

    @staticmethod
    def _copy(args):
        """Copies of the tensors of `args`; a contiguous one with storage
        past its end keeps KEY_TAIL bytes of it (the latency kernel's bulk
        copies of a key row read there, ops/latency.with_tail)."""
        import torch
        from concrete_tpu_torch.ops import latency as lat
        return [a if not isinstance(a, torch.Tensor)
                else lat.with_tail(a) if a.is_contiguous()
                and lat.tail_bytes(a) >= lat.KEY_TAIL else a.clone()
                for a in args]

    def __enter__(self):
        import torch
        self.saved = []
        for name, (module, attr, _) in kernel_wrappers().items():
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def kept(*args, _fn=fn, _name=name, **kwargs):
                sig = (_name,) + tuple(
                    (tuple(a.shape), str(a.dtype))
                    if isinstance(a, torch.Tensor) else repr(a)
                    for a in args) + tuple(sorted(kwargs.items()))
                n = self.calls[sig] = self.calls.get(sig, 0) + 1
                if n in self.nth:
                    self.kept.setdefault(sig, []).append(
                        (self._copy(args), kwargs))
                return _fn(*args, **kwargs)
            setattr(module, attr, kept)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)

    def check(self) -> dict:
        """{launch name: {"calls": calls checked, "signatures": [...],
        "max_abs_err": 0.0}}; fails on the first disagreement."""
        import torch
        wrappers = kernel_wrappers()
        out = {}
        for sig, calls in self.kept.items():
            name = sig[0]
            _, _, plain = wrappers[name]
            kernel = getattr(*wrappers[name][:2])
            for args, kwargs in calls:
                got = kernel(*self._copy(args), **kwargs)
                want = plain(*self._copy(args), **kwargs)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                if len(got) != len(want) or not all(
                        torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"{self.label}: {name} differs from its plain "
                         f"version on a served call's inputs {sig[1:]}")
            rec = out.setdefault(name, {"calls": 0, "signatures": [],
                                        "max_abs_err": 0.0})
            rec["calls"] += len(calls)
            rec["signatures"].append(" ".join(str(s) for s in sig[1:]))
        self.kept.clear()
        return out


def decrypt_wrong(circuit, wrong_of, inputs, outs):
    """(wrong, values) of the decryptions of `outs`, request by request,
    against the clear function: wrong_of(x, outputs) -> (wrong, values)."""
    wrong = values = 0
    for x, o in zip(inputs, outs):
        dec = circuit.decrypt(*o)
        w, n = wrong_of(x, dec if isinstance(dec, tuple) else (dec,))
        wrong, values = wrong + w, values + n
    return wrong, values


def serve_model(name, compile_fn, draw, wrong_of, cpu_check=False):
    """One model on the card: compile, keygen and pack timed; two requests
    of random inputs within the compiled bounds (covered_draws) through
    Circuit.run, on the keys its packing rule gives: the first timed, the
    second traced, each one's launches those of the blind-rotate forms its
    lookup nodes take (the path's launches are these two requests' alone).
    Their output ciphertexts must equal bit for bit those of Server.load
    of the model's own saved archive on the same ciphertexts and keys
    (and with `cpu_check`, those of the same run on CPU copies of the
    keys, every kernel's plain version); every kernel call of the archive
    run, at each signature, is held to its plain version on the card on
    the same inputs (same_inputs).  Decryptions are held to the model's
    clear function (wrong_of(x, outputs) -> (wrong, values)), unless the
    rule's key is a truncated fused key (exact_keys): then the same
    ciphertexts run again on the exact key, whose decryptions are held,
    and the path's wrong count is printed."""
    start = time.perf_counter()
    import tempfile
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    t0 = time.perf_counter()
    circuit = compile_fn()
    compile_s = time.perf_counter() - t0
    specs = circuit.client_specs
    if specs.is_multi or circuit.device.type != "cuda":
        fail(f"{name} compiled multi-partition or off the card")
    inputs, draws = covered_draws(circuit, draw, MODEL_REQUESTS)
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.ops import fused_ntt as fn
    wp = specs.wop_params()
    wop = None
    if wp is not None:
        # the memory check Circuit.run makes before any key exists
        est = circuit.server.check_wop_memory()
        p = specs.params
        wop = {"gadgets": specs.wop_gadgets,
               "nb_bits": [s.nb_bits for s in
                           circuit.server._executor.wop_specs.values()],
               "pfpksk_glwe_rows": (p.glwe_dimension + 1) * (p.n_big + 1)
               * wp.pfks_level, "memory_estimates": est}
    t0 = time.perf_counter()
    circuit.keygen(seed=SEED)           # the BSK's bodies on the card
    if wp is not None:      # the PFPKSK, made and split on the card
        circuit.keys.wop_evaluation(wp, device=circuit.device)
    keygen_s = time.perf_counter() - t0
    keygen_parts = setup_parts(circuit.keys.setup_seconds)
    checks = same_inputs(name)
    t0 = time.perf_counter()
    with timed_calls({"ksk_split_and_upload_s": (kn, "pack_ksk"),
                      "banded_bsk_s": (kn, "pack_bsk"),
                      "fused_bsk_s": (fn, "pack_bsk_fused")}) \
            as pack_parts, checks:
        ev = circuit._evaluation_keys()    # what Circuit.run serves on
        torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if wop is not None:
        pf = circuit.keys.setup_seconds["pfpksk"]
        wop["pfpksk_setup_s"] = dict(pf)
        print(f"model {name}: WoP gadgets (cbs_level, cbs_base_log, "
              f"pfks_level, pfks_base_log) {wop['gadgets']}, extracted bits "
              f"{wop['nb_bits']}, PFPKSK {wop['pfpksk_glwe_rows']} GLWE "
              f"rows made on the card in {pf['wall_s'] + pf['pack_s']:.2f} "
              f"s: draws {pf['draws_s']:.2f} s of host threads' time, "
              f"product {pf['product_s']:.2f} s on the card (uploads "
              f"included), pack (the limb split on the card) "
              f"{pf['pack_s']:.3f} s; modeled bytes "
              f"{wop['memory_estimates']}", flush=True)
    t0 = time.perf_counter()
    with checks:
        exact = exact_keys(circuit, ev)
    exact_pack_s = time.perf_counter() - t0 if exact else None
    forms = lookup_forms(circuit, ev[1])
    lookups = circuit.programmable_bootstrap_count
    if lookups != sum(b for _, b, _, _ in forms.values()):
        fail(f"{name}: {lookups} PBS a run, the lookup nodes hold "
             f"{sum(b for _, b, _, _ in forms.values())}")
    want, wop_want = {}, wop_counts(circuit)
    for *_, launches in forms.values():
        for k, v in launches.items():
            want[k] = want.get(k, 0) + v
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{name}.zip")
        circuit.server.save(path)
        server = tfhe.Server.load(path)
    encrypted = [circuit.encrypt(*x) for x in inputs]
    encrypted = [ct if isinstance(ct, tuple) else (ct,) for ct in encrypted]

    sign_pbs_forms = set()

    def request(ct):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        with wop_schedule() as sched:
            out = circuit.run(*ct)
        wall = time.perf_counter() - t0
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        made, wop_forms = sched.launches(ev[1], specs.params)
        if any(made.get(k, 0) != v for k, v in wop_want.items()):
            fail(f"{name}: the WoP-PBS calls make {made}, the design "
                 f"{wop_want} (a pack a chunk, nb keyed products a vertical "
                 f"packing)")
        expect = dict(want)
        for k, v in made.items():
            expect[k] = expect.get(k, 0) + v
        if counts != expect:
            fail(f"{name}: a request launched {counts}, its lookup nodes' "
                 f"forms and WoP-PBS calls give {expect}")
        sign_pbs_forms.update(wop_forms)
        return wall, out if isinstance(out, tuple) else (out,), counts

    wall, out, counts = request(encrypted[0])        # the path's run ...
    (traced_wall, traced_out, traced_counts), rows, kernels, launch_calls = \
        profile_run(lambda: request(encrypted[1]), host_ops=False)
    launches = {k: counts.get(k, 0) + traced_counts.get(k, 0)
                for k in {**counts, **traced_counts}}   # ... and its launches
    with checks:
        refs = [server.run(*ct, evaluation_keys=ev) for ct in encrypted]
        exact_outs = [circuit.server.run(*ct, evaluation_keys=exact)
                      for ct in encrypted] if exact else None
    for o, r in zip((out, traced_out), refs):
        if len(r) != len(o) or any(
                a.dtype != np.uint64 or not np.array_equal(a, b)
                for a, b in zip(o, r)):
            fail(f"{name}: output ciphertexts differ from the archive-loaded "
                 f"Server's")
    checked = checks.check()
    if set(launches) - set(checked):
        fail(f"{name}: {sorted(set(launches) - set(checked))} launched on "
             f"the path and never held to the plain version")
    path_wrong, values = decrypt_wrong(circuit, wrong_of, inputs,
                                       (out, traced_out))
    wrong = path_wrong if exact is None else decrypt_wrong(
        circuit, wrong_of, inputs, exact_outs)[0]
    allowed = max(2, 1e-3 * values)
    if wrong > allowed:
        fail(f"{name}: {wrong} wrong decryptions of {values}")
    cpu_s = None
    if cpu_check:
        cpu = tfhe.Server(circuit.graph, specs, device="cpu")
        t0 = time.perf_counter()
        if any(not np.array_equal(o, r) for o, r in zip(
                out, cpu.run(*encrypted[0], evaluation_keys=cpu_keys(*ev)))):
            fail(f"{name}: the card's outputs differ from the plain path's "
                 f"on the CPU")
        cpu_s = time.perf_counter() - t0
    busy = sum(ms for *_, ms in rows)
    by_form = {}
    for kind, batch, form, _ in forms.values():
        key = f"{kind} B={batch}: {form}"
        by_form[key] = by_form.get(key, 0) + 1
    p = specs.params
    held = "" if exact is None else (
        f" on the packing rule's key, which ROADMAP queue 3 finds too noisy;"
        f" the same ciphertexts on the exact key ({key_form(exact[1])}, "
        f"packed in {exact_pack_s:.3f} s): {wrong} of {values}")
    print(f"model {name}: n_small={p.n_small} k={p.glwe_dimension} "
          f"N={p.polynomial_size} l={p.pbs_level} base 2^{p.pbs_base_log}, "
          f"{specs.message_bits}-bit messages, {key_form(ev[1])}; "
          f"compile {compile_s:.3f} s, keygen {keygen_s:.2f} s "
          f"({keygen_parts}), "
          f"pack {pack_s:.3f} s "
          f"({ {k: round(v, 3) for k, v in pack_parts.seconds.items()} }); "
          f"{lookups} lookups a request; lookup nodes by "
          f"form {by_form}"
          + (f", their sign PBS as {sorted(sign_pbs_forms)}"
             if sign_pbs_forms else "")
          + f"; {MODEL_REQUESTS} requests within the compiled "
          f"bounds in {draws} draws; Circuit.run request {wall:.4f} s, "
          f"output ciphertexts equal bit for bit to the archive-loaded "
          f"Server's"
          + (f" and to the CPU's plain path ({cpu_s:.1f} s)"
             if cpu_check else "")
          + f"; kernel calls held to their plain versions on the archive "
          f"run's inputs: { {k: v['signatures'] for k, v in checked.items()} }"
          f"; wrong decryptions {path_wrong} of {values}{held} (allowed "
          f"{allowed}); launches {launches}; the traced request: wall "
          f"{traced_wall * 1e3:.1f} ms, device busy {busy:.2f} ms, idle "
          f"share {1 - busy / (traced_wall * 1e3):.3f}, kernels run "
          f"{kernels}, launch calls {launch_calls}; the model's phase "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for k, c, ms in rows[:5]:
        print(f"  {ms:9.3f} ms {c:6d}x  {k[:90]}", flush=True)
    return {"params": str(p), "message_bits": specs.message_bits,
            "phase_s": time.perf_counter() - start,
            "bsk": key_form(ev[1]), "compile_s": compile_s,
            "keygen_s": keygen_s, "keygen_parts_s": keygen_parts,
            "pack_s": pack_s, "pack_parts_s": pack_parts.seconds,
            "lookups_per_request": lookups, "forms": by_form,
            "sign_pbs_forms": sorted(sign_pbs_forms),
            "draws": draws, "wall_s": wall, "path_wrong": path_wrong,
            "wrong": wrong, "values": values, "launches": launches,
            "exact_key": None if exact is None else {
                "bsk": key_form(exact[1]), "pack_s": exact_pack_s},
            "wop": wop,
            "checked_on_served_inputs": checked, "cpu_plain_s": cpu_s,
            "traced": {"wall_s": traced_wall, "device_busy_ms": busy,
                       "idle_share": 1 - busy / (traced_wall * 1e3),
                       "device_kernels": kernels,
                       "launch_calls": launch_calls,
                       "by_kernel": [{"name": k, "count": c, "device_ms": ms}
                                     for k, c, ms in rows[:12]]}}


def models_phase(rng):
    """Five of the JAX package's model circuits, compiled by the port at the
    default Configuration() and served on the card (serve_model), then
    StaticKeyValueDatabase with 2 keys (KVDB_CPU_KEYS) also against CPU
    copies of its keys."""
    import numpy as np
    from concrete_tpu_torch import models as tm
    from concrete_tpu_torch.ops import latency as lat
    from concrete_tpu_torch.ops import prologue as pro
    gol = tm.GameOfLife(*GOL_SIZE)
    lev = tm.LevenshteinDistance(*LEVENSHTEIN)
    kvdb = tm.StaticKeyValueDatabase(KVDB_KEYS, KVDB_VALUES)
    ham = tm.HammingDistance(*HAMMING)
    pir = tm.PrivateInformationRetrieval(rng.integers(0, 16, PIR_SHAPE))

    def wrong_of(clear):
        def count(x, dec):
            want = np.asarray(clear(*x)).reshape(-1)
            got = np.concatenate([np.asarray(d).reshape(-1) for d in dec])
            if got.shape != want.shape:
                fail(f"outputs of shape {got.shape}, want {want.shape}")
            return int(np.count_nonzero(got != want)), want.size
        return count

    out = {
        "game_of_life": serve_model(
            "game_of_life", gol.compile,
            lambda: (rng.integers(0, 2, GOL_SIZE),),
            wrong_of(gol.step_clear)),
        "levenshtein": serve_model(
            "levenshtein",
            lambda: lev.compile(inputset_size=LEVENSHTEIN_INPUTSET),
            lambda: tuple(rng.integers(0, 1 << LEVENSHTEIN[2], length)
                          for length in LEVENSHTEIN[:2]),
            wrong_of(lambda a, b: lev.distance_clear(list(a), list(b)))),
        "kvdb": serve_model(
            "kvdb", kvdb.compile,
            lambda: (int(rng.integers(0, KVDB_KEYS[-1] + 2)),),
            wrong_of(kvdb.query_clear)),
        "hamming": serve_model(
            "hamming", lambda: ham.compile(via="packed"),
            lambda: tuple(rng.integers(0, 1 << HAMMING[1], HAMMING[0])
                          for _ in range(2)),
            wrong_of(ham.distance_clear)),
        "pir": serve_model(
            "pir", pir.compile,
            lambda: (int(rng.integers(0, PIR_SHAPE[0])),),
            wrong_of(pir.query_clear)),
    }
    # GameOfLife's B=1 lookups: one launch of the persistent kernel each
    # (a key ring of one slot), none of the step loop's kernels
    rec = out["game_of_life"]
    want = dict.fromkeys((pro.NAME, lat.NAME),
                         MODEL_REQUESTS * rec["lookups_per_request"])
    if rec["launches"] != want:
        fail(f"GameOfLife's requests launched {rec['launches']}, want "
             f"{want}")
    small = tm.StaticKeyValueDatabase(KVDB_CPU_KEYS, KVDB_VALUES[:2])
    out["kvdb_2_keys"] = serve_model(
        "kvdb_2_keys", small.compile,
        lambda: (int(rng.integers(0, KVDB_CPU_KEYS[1] + 2)),),
        wrong_of(small.query_clear), cpu_check=True)
    return out


def multi_lookup_forms(circuit, ev) -> dict:
    """lookup_forms for a multi-partition circuit: each lookup node's
    blind rotate on its input partition's packed key and parameters, with
    the partition; a WoP-PBS node's count as lookup_forms gives it, its
    launches read on the run (wop_schedule)."""
    import numpy as np
    ex = circuit.server._executor
    forms = {}
    for node in circuit.graph.topological_order():
        if not node.output.is_encrypted or node.name not in LOOKUP_KINDS:
            continue
        pid = ex.lookup_partition(node)
        batch = max(int(np.prod(node.output.shape)), 1)
        spec = ex.wop_specs.get(node.uid)
        if spec is not None:
            forms[node.uid] = (f"{node.name} in {pid}",
                               batch * spec.nb_bits, "WoP-PBS", {})
            continue
        forms[node.uid] = (f"{node.name} in {pid}", batch) + br_form(
            ev[1][pid], ex.params_for_width(pid), batch)
    return forms


def multi_exact_keys(circuit, ev):
    """The keys of a multi circuit's exact path: ev with each truncated
    fused key replaced by the exact one (the fewest primes whose range
    holds the product, no bits dropped; exact_keys per partition), to be
    run under int64_accumulators; None where the rule's path is already
    exact (no fused key truncated or in the acc32 mode)."""
    from concrete_tpu_torch.ops.fused_ntt import FusedBSK, acc32_eligible
    ksk, bsk, pfpksk, fks = ev
    exact = dict(bsk)
    truncated = [pid for pid, key in bsk.items()
                 if getattr(key, "trunc_bits", 0)]
    if not truncated and not any(isinstance(key, FusedBSK)
                                 and acc32_eligible(key)
                                 for key in bsk.values()):
        return None
    for pid in truncated:
        exact[pid] = exact_fused_key(circuit.keys.keys_for(pid).server.bsk,
                                     circuit.client_specs.partitions[pid],
                                     circuit.device)
    return ksk, exact, pfpksk, fks


class int64_accumulators:
    """Within the block, every fused blind rotate keeps its accumulator in
    int64 (``ops.fused_ntt.acc32_eligible`` refuses the acc32 mode, which
    the JAX package's rule takes wherever the digits read only the top
    word, and whose truncations add noise the noise model leaves out:
    ROADMAP queue 3)."""

    def __enter__(self):
        from concrete_tpu_torch.ops import fused_ntt as fn
        self.saved = fn.acc32_eligible
        fn.acc32_eligible = lambda bsk, min_scale_log=None: False
        return self

    def __exit__(self, *exc):
        from concrete_tpu_torch.ops import fused_ntt as fn
        fn.acc32_eligible = self.saved


class conversion_calls:
    """Within the block, each conversion keyswitch (``core.kernels.keyswitch``
    on one of `fks`' keys): its frontier, rows and the int8 GEMMs it
    launches (one a digit limb); the first call's input kept per
    frontier."""

    def __init__(self, fks: dict):
        self.by_key = {id(k): f for f, k in fks.items()}
        self.calls, self.first = [], {}

    def __enter__(self):
        from concrete_tpu_torch.core import kernels as kn
        from concrete_tpu_torch.core import limbs as lb
        self.saved = kn.keyswitch

        def keyswitch(ct, ksk, _fn=self.saved):
            frontier = self.by_key.get(id(ksk))
            if frontier is not None:
                self.calls.append((frontier, ct.shape[0],
                                   lb.num_digit_limbs(ksk.base_log)))
                self.first.setdefault(frontier, (ct.clone(), ksk))
            return _fn(ct, ksk)
        kn.keyswitch = keyswitch
        return self

    def __exit__(self, *exc):
        from concrete_tpu_torch.core import kernels as kn
        kn.keyswitch = self.saved


def serve_multi(name, compile_fn, draw, wrong_of):
    """One multi-partition circuit on the card, as serve_model serves a
    model: compile, keygen (each partition's keyset, the secret-only ones
    and the conversion keys) and pack (each partition's keys, each
    conversion key split on the card) timed; two requests of inputs
    within the compiled bounds through Circuit.run, each one's launches
    those of its lookup nodes' blind-rotate forms on their partitions'
    keys, the second traced; the conversion keyswitches counted (their
    int8 GEMMs: torch._int_mm, a library call), each frontier's equal to
    the same keyswitch on CPU copies and timed at its shape; output
    ciphertexts equal bit for bit to those of Server.load
    of the circuit's own archive, whose kernel calls are held to their
    plain versions (same_inputs); decryptions held to the clear function
    on the exact path, where the rule's path is not exact (a truncated
    fused key, or a fused key in the acc32 mode: multi_exact_keys, run
    under int64_accumulators), beside the noise model's expected failing
    decisions (compilation.multi.decision_failures, which models no
    WoP-PBS lookup); the rule path's wrong count is printed.  A WoP
    partition (one at most) is served as serve_model serves a WoP circuit:
    check_wop_memory before any key, its PFPKSK made and split on the
    card, its sign PBS's and vertical packing's launches read on the run
    (wop_schedule) and held to the design's (wop_counts)."""
    start = time.perf_counter()
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.compilation import keys as ck
    from concrete_tpu_torch.compilation.multi import (decision_failures,
                                                      expected_failures)
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import limbs as lb
    from concrete_tpu_torch.ops import _build
    t0 = time.perf_counter()
    circuit = compile_fn()
    compile_s = time.perf_counter() - t0
    specs = circuit.client_specs
    if not specs.is_multi or circuit.device.type != "cuda":
        fail(f"{name} compiled mono or off the card")
    ex = circuit.server._executor
    wop_pids = sorted({ex.lookup_partition(node)
                       for node in circuit.graph.topological_order()
                       if node.uid in ex.wop_specs})
    if len(wop_pids) > 1:
        fail(f"{name}: WoP lookups in partitions {wop_pids}; this phase "
             f"reads the sign PBS's launches on one partition's key")
    wop = None
    if wop_pids:
        est = circuit.server.check_wop_memory()    # before any key exists
        wpid = wop_pids[0]
        wpp = specs.partitions[wpid]
        wop = {"partition": wpid, "params": str(wpp),
               "gadgets": list(specs.partition_wop_gadgets[wpid]),
               "nb_bits": [s.nb_bits for s in ex.wop_specs.values()],
               "pfpksk_glwe_rows": (wpp.glwe_dimension + 1)
               * (wpp.n_big + 1) * specs.wop_params(wpid).pfks_level,
               "memory_estimates": est}
    inputs, draws = covered_draws(circuit, draw, MODEL_REQUESTS)
    model = [r for r in decision_failures(circuit.graph, specs)
             if r["uid"] not in ex.wop_specs]
    expected = expected_failures(model)

    def timed_by(cls, attr, label_of, seconds):
        fn = getattr(cls, attr)

        def timed(self, *args, **kwargs):
            t1 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            label = label_of(self, *args, **kwargs)
            seconds[label] = seconds.get(label, 0.0) \
                + time.perf_counter() - t1
            return out
        return fn, timed
    pid_of = {id(k): w for w, k in circuit.keys._keys.items()}
    keygen_parts, pack_parts = {}, {}
    saved = []
    for cls, attr, label_of, seconds in (
            (ck.Keys, "generate",
             lambda k, *a, secret_only=False, **kw:
             f"partition {pid_of[id(k)]}"
             + (" (secret only)" if secret_only else ""), keygen_parts),
            (ck.Keys, "evaluation_for",
             lambda k, *a, **kw: f"partition {pid_of[id(k)]}", pack_parts),
            (ck.MultiKeys, "conversion_key",
             lambda k, s, d, *a, **kw: f"conversion {s}->{d}",
             pack_parts)):
        fn, timed = timed_by(cls, attr, label_of, seconds)
        saved.append((cls, attr, fn))
        setattr(cls, attr, timed)
    checks = same_inputs(name)
    try:
        t0 = time.perf_counter()
        circuit.keygen(seed=SEED)
        keygen_s = time.perf_counter() - t0
        keygen_parts["conversion keys"] = keygen_s - sum(
            keygen_parts.values())
        if wop is not None:     # the PFPKSK, made and split on the card
            t0 = time.perf_counter()
            circuit.keys.wop_evaluation_for(
                wpid, specs.wop_params(wpid), device=circuit.device)
            keygen_parts[f"partition {wpid} PFPKSK"] = \
                time.perf_counter() - t0
            keygen_s += keygen_parts[f"partition {wpid} PFPKSK"]
        setup = {pid: setup_parts(circuit.keys.keys_for(pid).setup_seconds)
                 for pid in specs.partitions}
        t0 = time.perf_counter()
        with checks:
            ev = circuit._evaluation_keys()    # what Circuit.run serves on
            torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
    with checks:
        exact = multi_exact_keys(circuit, ev)
    forms = multi_lookup_forms(circuit, ev)
    lookups = circuit.programmable_bootstrap_count
    if lookups != sum(b for _, b, _, _ in forms.values()):
        fail(f"{name}: {lookups} PBS a run, the lookup nodes hold "
             f"{sum(b for _, b, _, _ in forms.values())}")
    want = {}
    for *_, launches in forms.values():
        for k, v in launches.items():
            want[k] = want.get(k, 0) + v
    frontiers = {}
    for node in circuit.graph.topological_order():
        if node.name in LOOKUP_KINDS and node.output.is_encrypted:
            key = (ex.lookup_partition(node), ex.part_of(node))
            if key in specs.conversions:
                frontiers[key] = frontiers.get(key, 0) + 1
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{name}.zip")
        circuit.server.save(path)
        server = tfhe.Server.load(path, device=circuit.device)
    encrypted = [circuit.encrypt(*x) for x in inputs]
    encrypted = [ct if isinstance(ct, tuple) else (ct,) for ct in encrypted]
    conv = conversion_calls(ev[3])
    wop_want = wop_counts(circuit)
    sign_pbs_forms = set()

    def request(ct):
        before = dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        with conv, wop_schedule() as sched:
            out = circuit.run(*ct)
        wall = time.perf_counter() - t1
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        expect = dict(want)
        if wop is not None:
            made, wop_forms = sched.launches(ev[1][wpid], wpp)
            if any(made.get(k, 0) != v for k, v in wop_want.items()):
                fail(f"{name}: the WoP-PBS calls make {made}, the design "
                     f"{wop_want}")
            for k, v in made.items():
                expect[k] = expect.get(k, 0) + v
            sign_pbs_forms.update(wop_forms)
        if counts != expect:
            fail(f"{name}: a request launched {counts}, its lookup nodes' "
                 f"forms and WoP-PBS calls give {expect}")
        return wall, out if isinstance(out, tuple) else (out,), counts

    wall, out, counts = request(encrypted[0])        # the path's run ...
    (traced_wall, traced_out, traced_counts), rows, kernels, launch_calls = \
        profile_run(lambda: request(encrypted[1]), host_ops=False)
    launches = {k: counts.get(k, 0) + traced_counts.get(k, 0)
                for k in {**counts, **traced_counts}}   # ... and its launches
    made = {}
    for frontier, _, _ in conv.calls:
        made[frontier] = made.get(frontier, 0) + 1
    if made != {f: n * MODEL_REQUESTS for f, n in frontiers.items()}:
        fail(f"{name}: conversion keyswitches {made}, the graph's "
             f"frontiers {frontiers} a request")
    gemms = sum(a for _, _, a in conv.calls) // MODEL_REQUESTS
    with checks:
        refs = [server.run(*ct, evaluation_keys=ev) for ct in encrypted]
    with checks, int64_accumulators():
        exact_outs = [circuit.server.run(*ct, evaluation_keys=exact)
                      for ct in encrypted] if exact else None
    for o, r in zip((out, traced_out), refs):
        if len(r) != len(o) or any(
                a.dtype != np.uint64 or not np.array_equal(a, b)
                for a, b in zip(o, r)):
            fail(f"{name}: output ciphertexts differ from the archive-loaded "
                 f"Server's")
    checked = checks.check()
    if set(launches) - set(checked):
        fail(f"{name}: {sorted(set(launches) - set(checked))} launched on "
             f"the path and never held to the plain version")
    # each frontier's conversion keyswitch on the first request's rows:
    # equal bit for bit to the same keyswitch on CPU copies (the GEMM's
    # shapes are new: torch._int_mm pads M to 17 and K, N to 8 on the
    # card), then it and one of its int8 GEMMs timed
    conversions = {}
    for (s, d), (x, key) in conv.first.items():
        t0 = time.perf_counter()
        cpu = kn.keyswitch(x.cpu(), dataclasses.replace(
            key, planes=key.planes.cpu()))
        cpu_s = time.perf_counter() - t0
        if not torch.equal(kn.keyswitch(x, key).cpu(), cpu):
            fail(f"{name}: the conversion keyswitch {s}->{d} on the card "
                 f"differs from the CPU's")
        a_limbs = lb.num_digit_limbs(key.base_log)
        n_in, levels, n_out_p1, _ = key.planes.shape
        lhs = torch.zeros((x.shape[0], n_in * levels), dtype=torch.int8,
                          device=x.device)
        rhs = key.planes.reshape(n_in * levels, n_out_p1 * 8)
        conversions[f"{s}->{d}"] = {
            "equal_to_cpu": True, "cpu_s": cpu_s,
            "rows": x.shape[0], "gadget": list(specs.conversions[(s, d)]),
            "n_in": n_in, "n_out": n_out_p1 - 1, "gemms": a_limbs,
            "keyswitch_ms": cuda_ms(lambda: kn.keyswitch(x, key), 20),
            "gemm_ms": cuda_ms(lambda: lb.int8_matmul(lhs, rhs), 20),
            "gemm_shape": [max(x.shape[0], 17), n_in * levels,
                           n_out_p1 * 8],
            "key_bytes": key.planes.numel()}
    path_wrong, values = decrypt_wrong(circuit, wrong_of, inputs,
                                       (out, traced_out))
    wrong = path_wrong if exact is None else decrypt_wrong(
        circuit, wrong_of, inputs, exact_outs)[0]
    allowed = max(2, 1e-3 * values)
    if wrong > allowed:
        for label, outs in (("rule keys", (out, traced_out)),
                            ("exact keys", exact_outs or ())):
            for x, o in zip(inputs, outs):
                print(f"{name} on the {label}: decrypted {circuit.decrypt(*o)}"
                      f" for inputs {x}", flush=True)
        fail(f"{name}: {wrong} wrong decryptions of {values} ({path_wrong} "
             f"on the packing rule's keys; the noise model expects "
             f"{expected * MODEL_REQUESTS:.3g} failing decisions in "
             f"{MODEL_REQUESTS} requests)")
    busy = sum(ms for *_, ms in rows)
    gemm_rows = [(k, c, ms) for k, c, ms in rows
                 if "gemm" in k.lower() or "s8" in k.lower()
                 or "imma" in k.lower()]
    by_form = {}
    for kind, batch, form, _ in forms.values():
        key = f"{kind} B={batch}: {form}"
        by_form[key] = by_form.get(key, 0) + 1
    partitions = {
        pid: {"N": p.polynomial_size, "k": p.glwe_dimension,
              "n_small": p.n_small, "l": p.pbs_level,
              "base_log": p.pbs_base_log,
              "bsk": key_form(ev[1][pid]) if pid in ev[1] else
              "none (secret-only: no PBS runs here)"}
        for pid, p in specs.partitions.items()}
    held = "" if exact is None else (
        f" on the packing rule's keys (truncated fused keys, acc32 "
        f"accumulators: ROADMAP queue 3); the same ciphertexts on the "
        f"exact path (untruncated keys, int64 accumulators): {wrong} of "
        f"{values}")
    if wop is not None:
        pf = circuit.keys.keys_for(wpid).setup_seconds["pfpksk"]
        wop["pfpksk_setup_s"] = dict(pf)
        print(f"multi {name}: WoP partition {wpid} at {wpp}, gadgets "
              f"{wop['gadgets']}, extracted bits {wop['nb_bits']}, "
              f"check_wop_memory's estimate {wop['memory_estimates']}; "
              f"PFPKSK {wop['pfpksk_glwe_rows']} GLWE rows made on the card: "
              f"draws {pf['draws_s']:.2f} s of host threads' time, product "
              f"{pf['product_s']:.2f} s, pack {pf['pack_s']:.3f} s; its sign "
              f"PBS as {sorted(sign_pbs_forms)}", flush=True)
    print(f"multi {name}: partitions "
          f"{ {w: (r['N'], r['bsk']) for w, r in partitions.items()} }, "
          f"conversions {specs.conversions}; compile {compile_s:.3f} s, "
          f"keygen {keygen_s:.2f} s "
          f"({ {k: round(v, 2) for k, v in keygen_parts.items()} }; by key "
          f"and part {setup}), pack "
          f"{pack_s:.3f} s ({ {k: round(v, 3) for k, v in pack_parts.items()} }"
          f"); {lookups} lookups a request; lookup nodes by form {by_form}; "
          f"{MODEL_REQUESTS} requests within the compiled bounds in {draws} "
          f"draws; Circuit.run request {wall:.4f} s, output ciphertexts "
          f"equal bit for bit to the archive-loaded Server's; kernel calls "
          f"held to their plain versions: "
          f"{ {k: v['signatures'] for k, v in checked.items()} }; wrong "
          f"decryptions {path_wrong} of {values}{held} (allowed {allowed}; "
          f"the noise model's expected failing decisions a request "
          f"{expected:.3g}); launches {launches}; conversion keyswitches a "
          f"request {frontiers} ({gemms} int8 GEMMs): "
          f"{ {f: (c['rows'], round(c['keyswitch_ms'], 4), round(c['gemm_ms'], 4)) for f, c in conversions.items()} }"
          f" (rows, keyswitch ms, one GEMM ms), each equal to the CPU's; the "
          f"traced request: wall "
          f"{traced_wall * 1e3:.1f} ms, device busy {busy:.2f} ms, idle "
          f"share {1 - busy / (traced_wall * 1e3):.3f}, int8 GEMM rows "
          f"{sum(ms for *_, ms in gemm_rows):.3f} ms, kernels run {kernels}, "
          f"launch calls {launch_calls}; phase "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for k, c, ms in rows[:6]:
        print(f"  {ms:9.3f} ms {c:6d}x  {k[:90]}", flush=True)
    return {"partitions": partitions,
            "conversions": {f"{s}->{d}": list(g)
                            for (s, d), g in specs.conversions.items()},
            "phase_s": time.perf_counter() - start, "compile_s": compile_s,
            "keygen_s": keygen_s, "keygen_parts_s": keygen_parts,
            "setup_by_partition": setup, "wop": wop,
            "pack_s": pack_s, "pack_parts_s": pack_parts,
            "lookups_per_request": lookups, "forms": by_form,
            "draws": draws, "wall_s": wall, "path_wrong": path_wrong,
            "wrong": wrong, "values": values, "launches": launches,
            "exact_keys": exact is not None,
            "model_expected_failures_per_request": expected,
            "model_decisions": model,
            "conversion_keyswitches_per_request": {
                f"{s}->{d}": n for (s, d), n in frontiers.items()},
            "conversion_gemms_per_request": gemms,
            "conversion_timings": conversions,
            "checked_on_served_inputs": checked,
            "traced": {"wall_s": traced_wall, "device_busy_ms": busy,
                       "idle_share": 1 - busy / (traced_wall * 1e3),
                       "device_kernels": kernels,
                       "launch_calls": launch_calls,
                       "gemm_ms": sum(ms for *_, ms in gemm_rows),
                       "by_kernel": [{"name": k, "count": c, "device_ms": ms}
                                     for k, c, ms in rows[:12]]}}


def multi_phase(rng):
    """Three multi-partition circuits compiled by the port at the default
    Configuration() and served on the card (serve_multi):
    PrimeMatch(10, 10, 10, 50), PrimeMatch(5, 5, 4, 7) and
    HammingDistance(32, 4) with via="xor"."""
    import numpy as np
    from concrete_tpu_torch import models as tm

    def prime_match(sizes):
        b, c, s, q = sizes
        pm = tm.PrimeMatch(*sizes)

        def draw():
            return (rng.integers(0, 2, b), rng.integers(0, s, b),
                    rng.integers(1, q + 1, b), rng.integers(0, 2, c),
                    rng.integers(0, s, c), rng.integers(1, q + 1, c))

        def wrong_of(x, dec):
            want = np.concatenate([np.asarray(v).reshape(-1)
                                   for v in pm.match_clear(*x)])
            got = np.concatenate([np.asarray(d).reshape(-1) for d in dec])
            if got.shape != want.shape:
                fail(f"outputs of shape {got.shape}, want {want.shape}")
            return int(np.count_nonzero(got != want)), want.size
        return pm.compile, draw, wrong_of

    ham = tm.HammingDistance(*HAMMING)

    def ham_wrong(x, dec):
        want = int(ham.distance_clear(*x))
        return int(int(np.asarray(dec[0])) != want), 1

    out = {}
    for name, sizes in (("prime_match_10", PRIME_MATCH_10),
                        ("prime_match_5", PRIME_MATCH_5)):
        out[name] = serve_multi(name, *prime_match(sizes))
    out["hamming_xor"] = serve_multi(
        "hamming_xor", lambda: ham.compile(via="xor"),
        lambda: tuple(rng.integers(0, 1 << HAMMING[1], HAMMING[0])
                      for _ in range(2)), ham_wrong)
    out["multi_wop"] = multi_wop_phase(rng)
    return out


def multi_wop_phase(rng):
    """multi_wop_circuit served on the card (serve_multi), decryptions held
    to (ts[x], tb[y])."""
    import numpy as np

    def wop_wrong(x, dec):
        want = (MULTI_WOP_TS[x[0]], MULTI_WOP_TB[x[1]])
        return sum(int(int(np.asarray(d)) != w)
                   for d, w in zip(dec, want)), 2

    return serve_multi(
        "multi_wop", multi_wop_circuit,
        lambda: (int(rng.integers(0, 4)), int(rng.integers(0, 512))),
        wop_wrong)


def multi_wop_circuit():
    """(ts[x], tb[y]) on the card with a WoP partition, its partitions set
    explicitly (the default planner puts the 9-bit lookup at N=32768, 160
    GB of PFPKSK: ROADMAP queue 3).  The graph is the mono compile's; each
    encrypted node's encoding width is its partition, as the planner's
    finest cut gives them: x in 2, y in 9, tb's 6-bit output in 6 (ts's
    stays in 2).  Partition 2 takes what the port's v0 search gives a
    2-bit lookup, partition 9 the parameters and WoP gadgets of the mono
    compile of tb alone, partition 6 (secret-only: no lookup reads it)
    the v0 search's for a 6-bit lookup.  The frontier 9 -> 6 takes the
    conversion gadget choose_fks gives a quarter of the 6-bit decode's
    variance budget; the WoP gadgets are derived again (choose_wop_gadgets)
    where the WoP output and that keyswitch together miss the budget."""
    import dataclasses
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.compilation.circuit import Circuit
    from concrete_tpu_torch.compilation.widths import (
        TLU_OPS, partition_of, tlu_input_partition)
    from concrete_tpu_torch.optimizer.v0 import (choose_fks,
                                                 choose_wop_gadgets,
                                                 p_error_of_variance)
    ts = tfhe.LookupTable(MULTI_WOP_TS)
    tb = tfhe.LookupTable(MULTI_WOP_TB)
    ident6 = tfhe.LookupTable(list(range(64)))
    inputset = [(i % 4, (37 * i) % 512) for i in range(40)] + [(3, 511)]

    def compiled(fn, names, inputs, **kw):
        return tfhe.compiler({n: "encrypted" for n in names})(fn).compile(
            inputs, **kw)
    mono = compiled(lambda x, y: (ts[x], tb[y]), ("x", "y"), inputset,
                    parameter_selection_strategy="mono")
    wide = compiled(lambda y: tb[y], ("y",), [y for _, y in inputset])
    if wide.client_specs.wop_params() is None:
        fail("tb compiled without WoP gadgets")
    by_width = {2: compiled(lambda x: ts[x], ("x",), range(4)),
                9: wide, 6: compiled(lambda x: ident6[x], ("x",), range(64))}
    g, p = mono.graph, mono.client_specs.message_bits
    widths = {partition_of(n, p) for n in g.topological_order()
              if n.output.is_encrypted}
    if widths != set(by_width):
        fail(f"multi_wop: encoding widths {widths}, expected "
             f"{set(by_width)}")
    params = {w: c.client_specs.params for w, c in by_width.items()}
    p_error = mono.configuration.p_error
    conv = {}
    for n in g.topological_order():
        if n.name in TLU_OPS and n.output.is_encrypted:
            src, dst = tlu_input_partition(g, n, p), partition_of(n, p)
            if src != dst:
                lvl, base, _ = choose_fks(
                    params[src], params[dst],
                    pp.safe_variance_bound(dst, p_error) / 4)
                conv[(src, dst)] = (lvl, base)
    if set(conv) != {(9, 6)}:
        fail(f"multi_wop: frontiers {sorted(conv)}, expected (9, 6)")
    gadgets = tuple(wide.client_specs.wop_gadgets)
    lvl, base = conv[(9, 6)]
    v_fks = pp.variance_keyswitch(params[9].n_big, base, lvl,
                                  params[6].glwe_std ** 2)

    def decode_p(g4):
        return p_error_of_variance(6, pp.wop_output_variance(
            params[9], 9, g4[1], g4[0], g4[3], g4[2]) + v_fks)
    if decode_p(gadgets) > p_error:
        wp = choose_wop_gadgets(params[9], 9, ((6, 1.0),), p_error=p_error)
        gadgets = (wp.cbs_level, wp.cbs_base_log, wp.pfks_level,
                   wp.pfks_base_log)
    specs = dataclasses.replace(
        mono.client_specs, partitions=params, conversions=conv,
        partition_wop_gadgets={9: gadgets},
        input_partitions=[partition_of(n, p) for n in g.ordered_inputs],
        output_partitions=[partition_of(n, p) for n in g.ordered_outputs])
    print(f"multi_wop: partitions (n_small, k, N, l, base_log) "
          f"{ {w: (q.n_small, q.glwe_dimension, q.polynomial_size, q.pbs_level, q.pbs_base_log) for w, q in sorted(params.items())} }"
          f", WoP gadgets {gadgets} on 9 (tb's mono compile: "
          f"{tuple(wide.client_specs.wop_gadgets)}), conversions {conv}; "
          f"the 6-bit decode after the frontier at p_error "
          f"{decode_p(gadgets):.3g} (target {p_error})", flush=True)
    return Circuit(mono.graph, specs, configuration=mono.configuration)


def composition_modules(tfhe):
    """The composition cases of tests/test_composition.py:26-75 and
    tests/test_api_surface.py:185, and a Wired module, written again with
    the port: {name: (module compiler, inputsets, request, arguments)}; a
    request maps the compiled module and one argument to (decryptions,
    clear values)."""
    def table(f):
        return tfhe.LookupTable([f(v) for v in range(8)])

    @tfhe.module()
    class Counter:
        @tfhe.function({"x": "encrypted"})
        def double(x):
            return table(lambda v: (2 * v) % 8)[x]

        @tfhe.function({"x": "encrypted"})
        def increment(x):
            return table(lambda v: (v + 1) % 8)[x]

    @tfhe.module()
    class Inc:
        @tfhe.function({"x": "encrypted"})
        def inc(x):
            return table(lambda v: (v + 1) % 8)[x]

    @tfhe.module()
    class Isolated:
        composition = tfhe.NotComposable()

        @tfhe.function({"x": "encrypted"})
        def small(x):
            return x + 1

        @tfhe.function({"x": "encrypted"})
        def big(x):
            return (x + 1) % 32

    @tfhe.module()
    class WiredPair:
        composition = tfhe.Wired([tfhe.Wire(tfhe.Output("double", 0),
                                            tfhe.Input("inc", 0))])

        @tfhe.function({"x": "encrypted"})
        def double(x):
            return table(lambda v: (2 * v) % 8)[x]

        @tfhe.function({"x": "encrypted"})
        def inc(x):
            return table(lambda v: (v + 1) % 8)[x]

        @tfhe.function({"x": "encrypted"})
        def small(x):
            return x + 1

    def chain(first, second, clear):
        def request(m, x):
            f, g = getattr(m, first), getattr(m, second)
            out = g.run(f.run(f.encrypt(x)))     # ciphertext to ciphertext
            return [int(g.decrypt(out))], [clear(x)]
        return request

    def loop(m, x):
        ct = m.inc.encrypt(x)
        for _ in range(MODULE_LOOP):
            ct = m.inc.run(ct)
        return [int(m.inc.decrypt(ct))], [(x + MODULE_LOOP) % 8]

    def isolated(m, x):
        return [int(m.small.encrypt_run_decrypt(x % 2)),
                int(m.big.encrypt_run_decrypt(x))], [x % 2 + 1, (x + 1) % 32]

    def wired(m, x):
        got, want = chain("double", "inc", lambda v: (2 * v + 1) % 8)(m, x)
        return got + [int(m.small.encrypt_run_decrypt(x % 2))], \
            want + [x % 2 + 1]

    eight = list(range(8))
    return {
        "counter": (Counter, {"double": eight, "increment": eight},
                    chain("double", "increment",
                          lambda v: (2 * v + 1) % 8), eight),
        "inc_loop": (Inc, {"inc": eight}, loop, [0, 3, 6]),
        "not_composable": (Isolated, {"small": range(2), "big": range(31)},
                           isolated, [0, 17, 30]),
        "wired": (WiredPair, {"double": eight, "inc": eight,
                              "small": range(2)}, wired, [1, 2, 5]),
    }


def per_call_launches(forms: dict) -> dict:
    """The launches of one call of a function whose lookup nodes take
    `forms` (lookup_forms)."""
    out = {}
    for *_, launches in forms.values():
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


def served_calls(m, requests):
    """Run `requests` (callables of the module) on module `m`: (their
    results, the calls of each function, the seconds, the launches)."""
    from concrete_tpu_torch.ops import _build
    calls = {f: 0 for f in m.function_names}
    for f in m.function_names:
        fn = getattr(m, f)

        def counted(*args, _run=fn.run, _f=f):
            calls[_f] += 1
            return _run(*args)
        fn.run = counted
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    results = [request(m) for request in requests]
    wall = time.perf_counter() - t0
    for f in m.function_names:
        del getattr(m, f).run
    counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
              if v - before.get(k, 0)}
    return results, calls, wall, counts


def serve_composition(rng):
    """Part (a) of the module phase: each composition module compiled by
    the port at the default Configuration() and served on the card, every
    function's launches those of its lookup nodes' forms, decryptions held
    to the clear function; the counter's chain once more from a module
    compiled with compress_input_ciphertexts=True (its keyset loaded from
    the insecure key cache the first one wrote)."""
    import tempfile
    import numpy as np
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.core.compression import SeededLweCiphertext
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as cache:
        cached = tfhe.Configuration(use_insecure_key_cache=True,
                                    insecure_key_cache_location=cache)
        modules = composition_modules(tfhe)
        for name, (compiler, inputsets, request, xs) in modules.items():
            t0 = time.perf_counter()
            m = compiler.compile(inputsets, cached)
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            m.keygen(seed=SEED)
            keygen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            evs = {f: getattr(m, f)._evaluation_keys()
                   for f in m.function_names}
            pack_s = time.perf_counter() - t0
            forms = {f: lookup_forms(getattr(m, f), evs[f][1])
                     for f in m.function_names}
            results, calls, wall, counts = served_calls(
                m, [lambda m, x=x: request(m, x) for x in xs])
            got = [v for g, _ in results for v in g]
            want = [v for _, w in results for v in w]
            expect = {}
            for f, c in calls.items():
                for k, v in per_call_launches(forms[f]).items():
                    expect[k] = expect.get(k, 0) + c * v
            if counts != expect:
                fail(f"module {name}: its calls launched {counts}, their "
                     f"lookup nodes' forms give {expect}")
            wrong = int(np.count_nonzero(np.asarray(got) != np.asarray(want)))
            if wrong > max(2, 1e-3 * len(want)):
                fail(f"module {name}: {wrong} wrong decryptions of "
                     f"{len(want)}")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            p = getattr(m, m.function_names[0]).client_specs.params
            by_form = sorted({f"{f}: {kind} B={b}: {form}"
                              for f in forms for kind, b, form, _ in
                              forms[f].values()})
            out[name] = {"params": str(p), "compile_s": compile_s,
                         "keygen_s": keygen_s, "pack_s": pack_s,
                         "calls": calls, "wall_s": wall, "wrong": wrong,
                         "values": len(want), "launches": counts,
                         "forms": by_form,
                         "bsk": sorted({key_form(ev[1])
                                        for ev in evs.values()})}
            print(f"module {name}: n_small={p.n_small} "
                  f"N={p.polynomial_size} l={p.pbs_level} base "
                  f"2^{p.pbs_base_log}, {out[name]['bsk']}; compile "
                  f"{compile_s:.3f} s, keygen {keygen_s:.2f} s, pack "
                  f"{pack_s:.3f} s; calls {calls} in {wall:.3f} s; lookup "
                  f"nodes {by_form}; launches {counts}; wrong {wrong} of "
                  f"{len(want)}", flush=True)
            if name == "counter":
                plain_m = m
        # the chain from a module compiled with compress_input_ciphertexts
        compiler, inputsets, request, _ = modules["counter"]
        m = compiler.compile(inputsets, cached.fork(
            compress_input_ciphertexts=True))
        t0 = time.perf_counter()
        m.keygen(seed=SEED)
        keygen_s = time.perf_counter() - t0
        files = len(os.listdir(cache))
    if not all(np.array_equal(a, b) for a, b in zip(
            (m.keys.secret.lwe_big, m.keys.server.bsk),
            (plain_m.keys.secret.lwe_big, plain_m.keys.server.bsk))):
        fail("the compressed counter's keyset is not the cached one")
    ct = m.double.encrypt(3)
    if not isinstance(ct, SeededLweCiphertext):
        fail("compress_input_ciphertexts=True encrypted no seeded input")
    full = plain_m.double.encrypt(3)
    (res,), _, wall, counts = served_calls(
        m, [lambda m: m.increment.run(m.double.run(ct))])
    got, want = int(m.increment.decrypt(res)), (2 * 3 + 1) % 8
    if got != want:
        fail(f"the compressed chain decrypted {got}, want {want}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    out["counter_compressed"] = {
        "keygen_from_cache_s": keygen_s, "wall_s": wall,
        "input_bytes": ct.size_bytes, "uncompressed_bytes": full.nbytes,
        "launches": counts, "wrong": int(got != want), "values": 1}
    print(f"module counter, compress_input_ciphertexts=True: keyset loaded "
          f"from the insecure key cache ({files} files for the five "
          f"modules) in {keygen_s:.3f} s; input {ct.size_bytes} bytes "
          f"against {full.nbytes} uncompressed; chain {wall:.3f} s, "
          f"decrypted {got} (want {want}); launches {counts}", flush=True)
    out["launches"] = launches
    return out


def mono_decision_failures(fn) -> float:
    """The noise model's expected failing decisions of one call of a mono
    module function (compilation.multi.decision_failures, every partition
    the function's parameters)."""
    import collections
    from types import SimpleNamespace
    from concrete_tpu_torch.compilation.multi import (decision_failures,
                                                      expected_failures)
    p = fn.client_specs.params
    specs = SimpleNamespace(
        partitions=collections.defaultdict(lambda: p), conversions={})
    return expected_failures(decision_failures(fn.graph, specs))


def run_digest(sha):
    """``sha.hexdigest(SHA1_MESSAGE, mode="run")``, or None where a word of
    the digest decrypts past 32 bits: a limb past its width, which the
    rule's too-noisy truncated keys (ROADMAP queue 3) can give."""
    import struct
    try:
        return sha.hexdigest(SHA1_MESSAGE, mode="run")
    except struct.error:
        return None


def serve_sha1(rng):
    """Part (b) of the module phase: Sha1 at Configuration(p_error=1e-8)
    compiled by the port, keyed and packed (one pack per norm2), then
    hexdigest(SHA1_MESSAGE, mode="run") on the card held to hashlib; where
    it differs on a truncated fused key, the same ciphertexts served again
    on the exact keys, whose digest is held.  Each function's calls, ms a
    call and launches (those of its lookup nodes' forms); one round_add
    call traced; the kernel calls of one choose call and of the first two
    lookup nodes of one round_add call held to their plain versions; the
    carry chains call by call on both key forms (sha1_probes)."""
    import hashlib
    from types import SimpleNamespace
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.compilation import server as srv
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.models import Sha1
    from concrete_tpu_torch.models.sha1 import split32
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import fused_ntt as fnt
    start = time.perf_counter()
    sha = Sha1()
    t0 = time.perf_counter()
    m = sha.compile(tfhe.Configuration(p_error=SHA1_P_ERROR))
    compile_s = time.perf_counter() - t0
    # the default mode: the host simulation, no keys
    want = hashlib.sha1(SHA1_MESSAGE).hexdigest()
    t0 = time.perf_counter()
    simulated = sha.hexdigest(SHA1_MESSAGE)
    simulate_s = time.perf_counter() - t0
    print(f"module sha1: hexdigest({SHA1_MESSAGE!r}) in the default "
          f"simulate mode {simulated} in {simulate_s:.3f} s on the host "
          f"(hashlib {want})", flush=True)
    if simulated != want:
        fail(f"sha1: the simulated digest {simulated} differs from "
             f"hashlib's {want}")
    names = m.function_names
    fns = {f: getattr(m, f) for f in names}
    p = fns["round_add"].client_specs.params
    t0 = time.perf_counter()
    m.keygen(seed=SEED)
    keygen_s = time.perf_counter() - t0
    packs, evs = {}, {}
    with timed_calls({"ksk_split_and_upload_s": (kn, "pack_ksk"),
                      "fused_bsk_s": (fnt, "pack_bsk_fused"),
                      "banded_bsk_s": (kn, "pack_bsk")}) as pack_parts:
        t_all = time.perf_counter()
        for f in sorted(names, key=lambda f: fns[f].graph.max_norm2()):
            norm2 = round(fns[f].graph.max_norm2(), 4)
            t0 = time.perf_counter()
            evs[f] = fns[f]._evaluation_keys()
            packs.setdefault(norm2, 0.0)
            packs[norm2] += time.perf_counter() - t0
        pack_s = time.perf_counter() - t_all
    forms = {f: lookup_forms(fns[f], evs[f][1]) for f in names}
    per_call = {f: per_call_launches(forms[f]) for f in names}
    keys_by_norm2 = {round(fns[f].graph.max_norm2(), 4): key_form(evs[f][1])
                     for f in names}
    print(f"module sha1: n_small={p.n_small} k={p.glwe_dimension} "
          f"N={p.polynomial_size} l={p.pbs_level} base 2^{p.pbs_base_log} "
          f"ks ({p.ks_level}, 2^{p.ks_base_log}); compile {compile_s:.3f} s, "
          f"keygen {keygen_s:.2f} s "
          f"({setup_parts(m.keys.setup_seconds)}), pack {pack_s:.3f} s (per "
          f"norm2 { {k: round(v, 3) for k, v in packs.items()} }, parts "
          f"{ {k: round(v, 3) for k, v in pack_parts.seconds.items()} }); "
          f"keys per norm2 {keys_by_norm2}", flush=True)

    # the digest on the packing rule's keys; every encryption recorded,
    # so that the exact keys can serve the same ciphertexts
    calls = {f: 0 for f in names}
    seconds = {f: 0.0 for f in names}
    saved = {f: fns[f].run for f in names}
    for f in names:
        def timed(*args, _run=saved[f], _f=f):
            t0 = time.perf_counter()
            res = _run(*args)
            seconds[_f] += time.perf_counter() - t0
            calls[_f] += 1
            return res
        fns[f].run = timed
    encrypt = fns["rotate30"].encrypt
    recorded = []

    def recording(*args):
        ct = encrypt(*args)
        recorded.append(ct)
        return ct
    fns["rotate30"].encrypt = recording
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    got = run_digest(sha)
    digest_s = time.perf_counter() - t0
    counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
              if v - before.get(k, 0)}
    for f in names:
        del fns[f].run
    expect = {}
    for f, c in calls.items():
        for k, v in per_call[f].items():
            expect[k] = expect.get(k, 0) + c * v
    if counts != expect:
        fail(f"sha1: the digest launched {counts}, its functions' lookup "
             f"nodes' forms give {expect}")
    lookups = sum(calls[f] * fns[f].programmable_bootstrap_count
                  for f in names)
    model = {f: calls[f] * mono_decision_failures(fns[f]) for f in names}
    wrong_bits = None if got is None else [
        bin(int(got[8 * i:8 * i + 8], 16)
            ^ int(want[8 * i:8 * i + 8], 16)).count("1") for i in range(5)]
    rec_fns = {f: {"calls": calls[f],
                   "lookups_per_call": fns[f].programmable_bootstrap_count,
                   "norm2": fns[f].graph.max_norm2(),
                   "bsk": key_form(evs[f][1]),
                   "forms": sorted({f"{kind} B={b}: {form}" for kind, b,
                                    form, _ in forms[f].values()}),
                   "ms_per_call": 1e3 * seconds[f] / max(calls[f], 1),
                   "launches_per_call": per_call[f]} for f in names}
    for f in names:
        r = rec_fns[f]
        print(f"  sha1 {f}: {r['calls']} calls, {r['lookups_per_call']} "
              f"lookups a call, norm2 {r['norm2']:.3f}, {r['bsk']}, "
              f"{r['forms']}, {r['ms_per_call']:.3f} ms a call, launches a "
              f"call {r['launches_per_call']}", flush=True)
    print(f"module sha1: hexdigest({SHA1_MESSAGE!r}) on the rule's keys "
          f"{got} in {digest_s:.3f} s ({lookups} lookups; hashlib {want}); "
          f"wrong bits per word {wrong_bits}; the noise model's expected "
          f"failing decisions a digest {sum(model.values()):.3e}; launches "
          f"{counts}", flush=True)
    exact = None
    exact_evs = {f: exact_keys(SimpleNamespace(
        keys=fns[f].client.keys, client_specs=fns[f].client_specs,
        device=fns[f].device), evs[f]) for f in names}
    if got != want:
        if not any(e is not None for e in exact_evs.values()):
            fail(f"sha1: the digest {got} differs from hashlib's {want} on "
                 f"exact keys")
        replay = iter(recorded)
        fns["rotate30"].encrypt = lambda *args: next(replay)
        swapped = [f for f in names if exact_evs[f] is not None]
        for f in swapped:
            fns[f]._evaluation_keys = lambda _e=exact_evs[f]: _e
        t0 = time.perf_counter()
        exact_got = run_digest(sha)
        exact_s = time.perf_counter() - t0
        for f in swapped:
            del fns[f]._evaluation_keys
        exact = {"digest": exact_got, "wall_s": exact_s,
                 "bsk": {f: key_form(e[1]) for f, e in exact_evs.items()
                         if e is not None}}
        print(f"module sha1: the same ciphertexts on the exact keys "
              f"({exact['bsk']}): {exact_got} in {exact_s:.3f} s", flush=True)
        if exact_got != want:
            fail(f"sha1: the exact keys' digest {exact_got} differs from "
                 f"hashlib's {want}")
    del fns["rotate30"].encrypt

    # the carry chains call by call on random words, on the rule's keys and
    # on the exact keys: wrong output bits against the clear sum
    probes = sha1_probes(rng, fns, exact_evs)

    # one round_add call traced, its argument uploads timed
    words = [fns["rotate30"].encrypt(split32(int(v)))
             for v in rng.integers(0, 1 << 32, 5)]
    with timed_calls({"upload_s": (srv, "to_torus")}) as uploads:
        (traced_out, rows, kernels, launch_calls) = profile_run(
            lambda: timed_wall(lambda: fns["round_add"].run(*words)),
            host_ops=False)
    traced_wall, _ = traced_out
    busy = sum(ms for *_, ms in rows)
    h2d = sum(ms for k, _, ms in rows if "HtoD" in k)
    traced = {"wall_s": traced_wall, "device_busy_ms": busy,
              "idle_share": 1 - busy / (traced_wall * 1e3),
              "device_kernels": kernels, "launch_calls": launch_calls,
              "upload_host_s": uploads.seconds.get("upload_s", 0.0),
              "upload_share": uploads.seconds.get("upload_s", 0.0)
              / traced_wall, "htod_device_ms": h2d,
              "by_kernel": [{"name": k, "count": c, "device_ms": ms}
                            for k, c, ms in rows[:12]]}
    print(f"module sha1: one traced round_add call: wall "
          f"{traced_wall * 1e3:.1f} ms, device busy {busy:.2f} ms, idle "
          f"share {traced['idle_share']:.3f}, kernels run {kernels}, launch "
          f"calls {launch_calls}; its argument uploads "
          f"{traced['upload_host_s'] * 1e3:.3f} ms on the host clock (share "
          f"{traced['upload_share']:.5f}), HtoD copies {h2d:.3f} ms on the "
          f"device", flush=True)
    for k, c, ms in rows[:6]:
        print(f"  {ms:9.3f} ms {c:6d}x  {k[:90]}", flush=True)

    # the kernel calls of one choose call and of the first two lookup
    # nodes of one round_add call, held to their plain versions
    checks = same_inputs("sha1 choose")
    with checks:
        fns["choose"].run(*words[:3])
    held = checks.check()
    checks = same_inputs("sha1 round_add", nth=(1, 2))
    with checks:
        fns["round_add"].run(*words)
    for name, rec in checks.check().items():
        held[f"round_add {name}"] = rec
    print(f"module sha1: kernel calls held to their plain versions: "
          f"{ {k: (v['calls'], v['signatures']) for k, v in held.items()} }",
          flush=True)
    return {"params": str(p), "compile_s": compile_s,
            "simulated_digest": simulated, "simulate_s": simulate_s,
            "keygen_s": keygen_s,
            "keygen_parts_s": setup_parts(m.keys.setup_seconds),
            "pack_s": pack_s, "pack_per_norm2_s": packs,
            "pack_parts_s": pack_parts.seconds,
            "keys_per_norm2": keys_by_norm2, "digest": got, "hashlib": want,
            "digest_s": digest_s, "lookups": lookups,
            "wrong_bits_per_word": wrong_bits,
            "model_expected_failures": model, "exact": exact,
            "probes": probes,
            "functions": rec_fns, "launches": counts, "traced": traced,
            "checked_on_served_inputs": held,
            "phase_s": time.perf_counter() - start}


def sha1_probes(rng, fns, exact_evs) -> dict:
    """SHA1_PROBES calls of round_add (a carry chain of 63 lookups, add2's
    too) on random words, on the packing rule's keys and, where the rule
    truncates, on the exact keys (the same ciphertexts): {"round_add":
    {"rule"|"exact": wrong output bits of each call against the clear sum
    mod 2^32}}."""
    from concrete_tpu_torch.models.sha1 import split32, unsplit32

    def rotl5(v):
        return ((v << 5) | (v >> 27)) & 0xFFFFFFFF

    clear = {"round_add": lambda a, f, e, w, k:
             (rotl5(a) + f + e + w + k) % (1 << 32)}
    out = {}
    for name, fn in clear.items():
        f = fns[name]
        arity = len(f.client_specs.inputs)
        words = [[int(v) for v in rng.integers(0, 1 << 32, arity)]
                 for _ in range(SHA1_PROBES)]
        cts = [[fns["rotate30"].encrypt(split32(v)) for v in ws]
               for ws in words]
        rec = {}
        for label, ev in (("rule", None), ("exact", exact_evs[name])):
            if label == "exact" and ev is None:
                continue
            if ev is not None:
                f._evaluation_keys = lambda _e=ev: _e
            rec[label] = [bin(unsplit32(f.decrypt(f.run(*ct)))
                              ^ fn(*ws)).count("1")
                          for ws, ct in zip(words, cts)]
            if ev is not None:
                del f._evaluation_keys
        out[name] = rec
    print(f"module sha1: wrong output bits a call against the clear sum, "
          f"{SHA1_PROBES} calls on random words each, rule keys then exact: "
          f"{out}", flush=True)
    return out


def timed_wall(fn):
    """(seconds, result) of fn() on the host clock; fn returns host
    arrays, so the card is synchronised."""
    t0 = time.perf_counter()
    res = fn()
    return time.perf_counter() - t0, res


def module_phase(rng):
    """fhe.module on the card: the composition cases (serve_composition),
    then Sha1 over encrypted words (serve_sha1)."""
    start = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    comp = serve_composition(rng)
    sha = serve_sha1(rng)
    launches = dict(comp.pop("launches"))
    for k, v in sha["launches"].items():
        launches[k] = launches.get(k, 0) + v
    print(f"module phase: {time.perf_counter() - start:.1f} s; launches "
          f"{launches}", flush=True)
    return {"composition": comp, "sha1": sha, "launches": launches,
            "phase_s": time.perf_counter() - start}


def radix_limbs(values, limb_bits: int, n_limbs: int):
    """Clear integers -> (len, n_limbs) radix limbs, LSB first."""
    import numpy as np
    from concrete_tpu_torch.extensions import bigint as bi
    return np.array([bi.radix_decompose_clear(int(v), limb_bits, n_limbs)
                     for v in values])


def radix_values(limbs, limb_bits: int):
    """Radix limbs, one array of a batch per limb (a circuit's outputs) or
    a (batch, n_limbs) array, -> the integers."""
    import numpy as np
    from concrete_tpu_torch.extensions import bigint as bi
    rows = np.stack([np.asarray(v).reshape(-1) for v in limbs], axis=-1) \
        if isinstance(limbs, (tuple, list)) else np.asarray(limbs)
    return np.array([bi.radix_recompose_clear(r, limb_bits) for r in rows])


def bigint_phase(rng):
    """Radix big integers on the card: bench.py's BASELINE config 4
    (radix_add of 16-bit integers as 4 x 4-bit limbs, B = 512 a request),
    served as the models are (serve_model), and one circuit of radix_mul
    (mod 2^16), radix_lt and radix_eq of 16-bit integers as 8 x 2-bit
    limbs at B = 4, served as its compile makes it (serve_multi for a
    multi-partition circuit); decryptions held to the clear integers."""
    import numpy as np
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.extensions import bigint as bi
    start = time.perf_counter()
    out = {}
    # the inputsets from a fixed seed: each compile is the same circuit
    irng = np.random.default_rng(0)

    w, nl, batch = RADIX_ADD
    mod = 1 << (w * nl)

    @tfhe.compiler({"a": "encrypted", "b": "encrypted"})
    def radix16_add(a, b):
        return bi.radix_add([a[..., i] for i in range(nl)],
                            [b[..., i] for i in range(nl)], w)

    # bench.py's inputset, and all limbs at their smallest and at their
    # largest (the last limb's sum then takes a carry): requests of random
    # integers stay within its bounds
    top = np.full((batch, nl), (1 << w) - 1)
    low = np.zeros((batch, nl), dtype=np.int64)
    add_inputset = [(irng.integers(0, 1 << w, (batch, nl)),
                     irng.integers(0, 1 << w, (batch, nl))), (top, top),
                    (low, low)]

    def add_draw():
        return tuple(radix_limbs(rng.integers(0, mod, batch), w, nl)
                     for _ in range(2))

    def add_wrong(x, dec):
        want = (radix_values(x[0], w) + radix_values(x[1], w)) % mod
        return int(np.count_nonzero(radix_values(dec, w) != want)), batch

    out["radix16_add"] = serve_model(
        "radix16_add", lambda: radix16_add.compile(add_inputset),
        add_draw, add_wrong)

    w, nl, batch = RADIX_MUL
    mod = 1 << (w * nl)

    @tfhe.compiler({"a": "encrypted", "b": "encrypted"})
    def radix16_mul_lt_eq(a, b):
        a_l = [a[..., i] for i in range(nl)]
        b_l = [b[..., i] for i in range(nl)]
        return bi.radix_mul(a_l, b_l, w) + (bi.radix_lt(a_l, b_l, w),
                                             bi.radix_eq(a_l, b_l, w))

    top = np.full((batch, nl), (1 << w) - 1)
    low = np.zeros((batch, nl), dtype=np.int64)
    mul_inputset = [(irng.integers(0, 1 << w, (batch, nl)),
                     irng.integers(0, 1 << w, (batch, nl)))
                    for _ in range(RADIX_MUL_INPUTSET)] + [(top, top),
                                                           (low, low)]

    def mul_draw():
        return tuple(radix_limbs(rng.integers(0, mod, batch), w, nl)
                     for _ in range(2))

    def mul_wrong(x, dec):
        a, b = radix_values(x[0], w), radix_values(x[1], w)
        got = (radix_values(dec[:nl], w), np.asarray(dec[nl]).reshape(-1),
               np.asarray(dec[nl + 1]).reshape(-1))
        want = (a * b % mod, (a < b).astype(np.int64),
                (a == b).astype(np.int64))
        return sum(int(np.count_nonzero(g != v))
                   for g, v in zip(got, want)), 3 * batch

    t0 = time.perf_counter()
    circuit = radix16_mul_lt_eq.compile(mul_inputset)
    compile_s = time.perf_counter() - t0
    serve = serve_multi if circuit.client_specs.is_multi else serve_model
    rec = serve("radix16_mul_lt_eq", lambda: circuit, mul_draw, mul_wrong)
    rec["compile_s"] = compile_s
    out["radix16_mul_lt_eq"] = rec
    print(f"bigint radix16_mul_lt_eq: compile {compile_s:.3f} s "
          f"({'multi' if circuit.client_specs.is_multi else 'mono'}, "
          f"{circuit.programmable_bootstrap_count} lookups a request, "
          f"{sum(1 for n in circuit.graph.topological_order() if n.name in LOOKUP_KINDS)} "
          f"lookup nodes)", flush=True)
    launches = {}
    for r in out.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - start
    print(f"bigint phase: {out['phase_s']:.1f} s; launches {launches}",
          flush=True)
    return out


def tfhers_phase(rng):
    """A TFHE-rs FheUint8 (tfhers.uint8_2_2(): 4 blocks of 2 + 2 bits)
    round trip through the bridge on the card: TFHERS_VALUES values
    encrypted on the host under a shared secret key of TFHE-rs's big
    dimension at TFHE-rs's noise, serialized as tfhe-rs bincode, imported
    (the conversion keyswitch on the card where the circuit's n_big is
    another), from_native(table[to_native(blocks)]) through Circuit.run,
    exported as tfhe-rs bincode (the keyswitch back), parsed and decrypted
    under the shared key with the TFHE-rs encoding; the request's launches
    held to its lookup nodes' forms, one request traced.  Decryptions are
    held to the table on the packing rule's keys or, where the rule's key
    is a truncated fused key or takes the acc32 mode (both too noisy,
    ROADMAP queue 3), on the exact path (the untruncated key, int64
    accumulators) over the same ciphertexts, the rule's count printed;
    so are the wrong values at the inner stages (the imported blocks under
    the circuit's key, the circuit's outputs through the client)."""
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch import tfhers
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import kernels_wop as kw
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops.fused_ntt import FusedBSK, acc32_eligible
    from concrete_tpu_torch.tfhers import bincode
    from concrete_tpu_torch.tfhers.serialization import radix_from_blocks
    start = time.perf_counter()
    t = tfhers.uint8_2_2()
    table = tfhe.LookupTable(TFHERS_TABLE)

    @tfhe.compiler({"blocks": "encrypted"})
    def fheuint8_lookup(blocks):
        return tfhers.from_native(table[tfhers.to_native(blocks, t)], t)

    inputset = [np.array([t.encode_blocks(v % 256)
                          for v in range(i, i + TFHERS_VALUES)])
                for i in range(0, 256, TFHERS_VALUES)]
    t0 = time.perf_counter()
    circuit = fheuint8_lookup.compile(inputset)
    compile_s = time.perf_counter() - t0
    specs = circuit.client_specs
    if specs.is_multi or circuit.device.type != "cuda":
        fail("the FheUint8 circuit compiled multi-partition or off the card")
    p = specs.params
    t0 = time.perf_counter()
    circuit.keygen(seed=SEED)
    keygen_s = time.perf_counter() - t0
    key = ref.sample_binary_key(rng, (TFHERS_KEY_DIM,))
    bridge = tfhers.new_bridge(circuit, {0: t})
    t0 = time.perf_counter()
    with timed_calls({"generation_s": (kg, "make_ksk"),
                      "card_split_s": (kw, "split_u64_limbs")}) as conv:
        bridge.keygen_with_initial_keys({0: key})
    conversion_s = time.perf_counter() - t0
    cross = bridge._import_ksk is not None
    if cross != (p.n_big != TFHERS_KEY_DIM):
        fail(f"the bridge built conversion keys: {cross}, with the "
             f"circuit's n_big {p.n_big} and the shared key's "
             f"{TFHERS_KEY_DIM}")
    t0 = time.perf_counter()
    ev = circuit._evaluation_keys()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    forms = lookup_forms(circuit, ev[1])
    want_launches = per_call_launches(forms)

    # the TFHE-rs side: block messages at the TFHE-rs delta under the
    # shared key, each value serialized as a tfhe-rs FheUint8
    values = rng.integers(0, 256, TFHERS_VALUES)
    delta = np.uint64(1) << np.uint64(t.delta_log2)
    blobs = []
    for v in values:
        blocks = np.array(t.encode_blocks(int(v)), dtype=np.uint64)
        cts = kg.encrypt_lwe_batch(rng, key, blocks * delta,
                                   t.params.glwe_noise_distribution_stdev)
        blobs.append(bincode.serialize_fheuint(radix_from_blocks(cts, t),
                                               t.bit_width))

    def request(keys=None):
        """Import, run (Circuit.run, or on `keys` through the server),
        export: (walls, exported bytes, launches, imported, outputs)."""
        with timed_calls({"keyswitch_s": (kn, "keyswitch")}) as ks_in:
            t1 = time.perf_counter()
            imported = np.stack([bridge.import_ciphertext(b, 0)
                                 for b in blobs])
            import_s = time.perf_counter() - t1
        before = dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        outs = circuit.run(imported) if keys is None else \
            circuit.server.run(imported, evaluation_keys=keys)
        run_s = time.perf_counter() - t1
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        if keys is None and counts != want_launches:
            fail(f"the FheUint8 request launched {counts}, its lookup "
                 f"nodes' forms give {want_launches}")
        with timed_calls({"keyswitch_s": (kn, "keyswitch")}) as ks_out:
            t1 = time.perf_counter()
            exported = [bridge.export_ciphertext([o[i] for o in outs], 0, t,
                                                 format="tfhers")
                        for i in range(len(blobs))]
            export_s = time.perf_counter() - t1
        return {"import_s": import_s, "run_s": run_s, "export_s": export_s,
                "import_keyswitch_s": ks_in.seconds.get("keyswitch_s", 0.0),
                "export_keyswitch_s": ks_out.seconds.get("keyswitch_s", 0.0),
                "imported_shape": list(imported.shape)}, exported, counts, \
            imported, outs

    def decrypt(exported):
        got = []
        for blob in exported:
            radix = bincode.deserialize_fheuint(blob,
                                                expected_width=t.bit_width)
            span = t.msg_modulus * t.params.carry_modulus
            msgs = [int((int(ref.lwe_decrypt(key, b)) + (1 << (t.delta_log2
                                                              - 1)))
                        >> t.delta_log2) % span for b in radix.blocks]
            got.append(t.decode_blocks(msgs))
        return np.array(got)

    want = np.array(TFHERS_TABLE)[values]

    def stage_wrong(imported, outs):
        """Wrong values of the imported blocks decrypted under the
        circuit's big key, and of the circuit's outputs through the
        client."""
        blocks = ref.decode(ref.lwe_decrypt(circuit.keys.secret.lwe_big,
                                            imported), specs.input_width(0))
        sent = np.array([t.encode_blocks(int(v)) for v in values])
        dec = np.stack([np.asarray(d).reshape(-1)
                        for d in circuit.decrypt(*outs)], axis=-1)
        got = np.array([t.decode_blocks(list(r)) for r in dec])
        return {"imported": int(np.count_nonzero((blocks != sent).any(-1))),
                "circuit": int(np.count_nonzero(got != want))}

    walls, exported, counts, imported, outs = request()
    (traced_walls, traced_exported, traced_counts, _, _), rows, kernels, \
        launch_calls = profile_run(request, host_ops=False)
    launches = {k: counts.get(k, 0) + traced_counts.get(k, 0)
                for k in {**counts, **traced_counts}}
    wrong = [int(np.count_nonzero(decrypt(e) != want))
             for e in (exported, traced_exported)]
    stages = {"rule": stage_wrong(imported, outs)}
    exact = None
    if isinstance(ev[1], FusedBSK) and (ev[1].trunc_bits
                                        or acc32_eligible(ev[1])):
        exact_ev = (ev[0], exact_fused_key(circuit.keys.server.bsk, p,
                                           circuit.device))
        with int64_accumulators():
            exact_walls, exact_exported, _, _, exact_outs = request(exact_ev)
        exact = {"bsk": key_form(exact_ev[1]), "walls_s": exact_walls,
                 "wrong": int(np.count_nonzero(decrypt(exact_exported)
                                               != want))}
        stages["exact"] = stage_wrong(imported, exact_outs)
    held = sum(wrong) if exact is None else exact["wrong"]
    allowed = max(2, 1e-3 * (len(values) if exact else 2 * len(values)))
    print(f"tfhers FheUint8: {key_form(ev[1])}"
          + (", acc32" if isinstance(ev[1], FusedBSK)
             and acc32_eligible(ev[1]) else "")
          + f"; wrong on the rule's path {wrong} of {len(values)} a request"
          + ("" if exact is None else
             f"; the same ciphertexts on the exact path ({exact['bsk']}, "
             f"int64 accumulators): {exact['wrong']} of {len(values)}")
          + f"; wrong at the inner stages {stages} (allowed {allowed})",
          flush=True)
    if held > allowed:
        fail(f"FheUint8 round trip: {held} wrong of {len(values)}")
    busy = sum(ms for *_, ms in rows)
    traced_wall = sum(traced_walls[k] for k in ("import_s", "run_s",
                                                "export_s"))
    by_form = {}
    for kind, b, form, _ in forms.values():
        label = f"{kind} B={b}: {form}"
        by_form[label] = by_form.get(label, 0) + 1
    rec = {"params": str(p), "message_bits": specs.message_bits,
           "input_widths": [specs.input_width(0)],
           "output_widths": [specs.output_width(i)
                             for i in range(len(specs.outputs))],
           "bsk": key_form(ev[1]), "compile_s": compile_s,
           "keygen_s": keygen_s, "pack_s": pack_s,
           "keygen_parts_s": setup_parts(circuit.keys.setup_seconds),
           "conversion_keys": {
               "s": conversion_s, "parts_s": conv.seconds,
               "import": [bridge._import_ksk.levels,
                          bridge._import_ksk.base_log],
               "export": [bridge._export_ksk.levels,
                          bridge._export_ksk.base_log]} if cross else None,
           "lookups_per_request": circuit.programmable_bootstrap_count,
           "forms": by_form, "request": walls, "path_wrong": wrong,
           "wrong": held, "exact_path": exact, "stage_wrong": stages,
           "values": len(values), "bytes_per_value": len(blobs[0]),
           "launches": launches,
           "traced": {"walls_s": traced_walls, "device_busy_ms": busy,
                      "idle_share": 1 - busy / (traced_wall * 1e3),
                      "device_kernels": kernels,
                      "launch_calls": launch_calls,
                      "by_kernel": [{"name": k, "count": c, "device_ms": ms}
                                    for k, c, ms in rows[:12]]},
           "phase_s": time.perf_counter() - start}
    print(f"tfhers FheUint8: n_small={p.n_small} k={p.glwe_dimension} "
          f"N={p.polynomial_size} l={p.pbs_level} base 2^{p.pbs_base_log} "
          f"ks ({p.ks_level}, 2^{p.ks_base_log}), {specs.message_bits}-bit "
          f"messages, input width {specs.input_width(0)}, block outputs at "
          f"{rec['output_widths']} bits, {key_form(ev[1])}; compile "
          f"{compile_s:.3f} s, keygen {keygen_s:.2f} s "
          f"({rec['keygen_parts_s']}), pack {pack_s:.3f} s; "
          f"shared key of {TFHERS_KEY_DIM}: conversion keys "
          + (f"(levels, base_log) in {rec['conversion_keys']['import']}, "
             f"out {rec['conversion_keys']['export']}, "
             f"{conversion_s:.2f} s (host generation "
             f"{conv.seconds.get('generation_s', 0):.2f} s, card split "
             f"{conv.seconds.get('card_split_s', 0):.3f} s)"
             if cross else "none (same dimension)")
          + f"; {len(values)} values, {len(blobs[0])} bytes each in bincode;"
          f" a request: import {walls['import_s'] * 1e3:.1f} ms (keyswitch "
          f"{walls['import_keyswitch_s'] * 1e3:.2f} ms), Circuit.run "
          f"{walls['run_s']:.4f} s, export {walls['export_s'] * 1e3:.1f} ms "
          f"(keyswitch {walls['export_keyswitch_s'] * 1e3:.2f} ms); "
          f"{rec['lookups_per_request']} lookups a request, nodes by form "
          f"{by_form}; launches {launches}; wrong decryptions under the "
          f"shared key {held} of {len(values)}"
          + ("" if exact is None else " on the exact path")
          + f" (allowed {allowed}); the traced request: device busy {busy:.2f} ms of "
          f"{traced_wall * 1e3:.1f}, idle share "
          f"{rec['traced']['idle_share']:.3f}, kernels run {kernels}, launch "
          f"calls {launch_calls}; phase {rec['phase_s']:.1f} s", flush=True)
    for k, c, ms in rows[:5]:
        print(f"  {ms:9.3f} ms {c:6d}x  {k[:90]}", flush=True)
    return rec


def scheduler_phase(rng):
    """The dataflow scheduler on the card: the composition counter module
    (double, then increment) chained through run_async futures, one chain
    an input, all submitted before any is read; then two run_async calls
    at once on one fresh circuit, both first calls (one key pack, built
    once); each output ciphertext equal bit for bit to sequential run
    calls on the same ciphertexts; the walls of both."""
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    start = time.perf_counter()
    compiler, inputsets, _, _ = composition_modules(tfhe)["counter"]
    m = compiler.compile(inputsets)
    m.keygen(seed=SEED)
    xs = [int(v) for v in rng.integers(0, 8, SCHEDULER_CHAINS)]
    cts = [m.double.encrypt(x) for x in xs]
    m.increment.run(m.double.run(cts[0]))      # the packs, outside the walls
    t0 = time.perf_counter()
    sequential = [m.increment.run(m.double.run(ct)) for ct in cts]
    sequential_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    futures = [m.increment.run_async(m.double.run_async(ct)) for ct in cts]
    chained = [f.result(timeout=600) for f in futures]
    chained_s = time.perf_counter() - t0
    if any(not np.array_equal(a, b) for a, b in zip(chained, sequential)):
        fail("scheduler: the run_async chains' outputs differ from the "
             "sequential runs'")
    wrong = sum(int(m.increment.decrypt(o)) != (2 * x + 1) % 8
                for x, o in zip(xs, chained))
    if wrong > 2:
        fail(f"scheduler: {wrong} wrong of {len(xs)} chains")

    table = tfhe.LookupTable(TABLE)

    @tfhe.compiler({"x": "encrypted"})
    def lookup(x):
        return table[x]

    circuit = lookup.compile([(np.arange(SCHEDULER_BATCH) + s) % 16
                              for s in (0, 8)])
    circuit.keygen(seed=SEED)
    inputs = [rng.integers(0, 16, SCHEDULER_BATCH) for _ in range(2)]
    encrypted = [circuit.encrypt(x) for x in inputs]
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    futures = [circuit.run_async(ct) for ct in encrypted]
    together = [f.result(timeout=600) for f in futures]
    together_s = time.perf_counter() - t0
    counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
              if v - before.get(k, 0)}
    packs = len(circuit.keys._packed)
    if packs != 1:
        fail(f"scheduler: two first calls at once left {packs} packs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apart = [circuit.run(ct) for ct in encrypted]
    apart_s = time.perf_counter() - t0
    if any(not np.array_equal(a, b) for a, b in zip(together, apart)):
        fail("scheduler: concurrent run_async outputs differ from "
             "sequential runs'")
    want = {k: 2 * v for k, v in per_call_launches(
        lookup_forms(circuit, circuit._evaluation_keys()[1])).items()}
    if counts != want:
        fail(f"scheduler: the concurrent requests launched {counts}, their "
             f"lookup nodes' forms give {want}")
    wrong_lookups = sum(int(np.count_nonzero(
        circuit.decrypt(o) != np.array(TABLE)[x]))
        for x, o in zip(inputs, together))
    if wrong_lookups > max(2, 1e-3 * 2 * SCHEDULER_BATCH):
        fail(f"scheduler: {wrong_lookups} wrong lookups")
    rec = {"chains": len(xs), "chains_sequential_s": sequential_s,
           "chains_run_async_s": chained_s, "chains_wrong": wrong,
           "concurrent_batch": SCHEDULER_BATCH,
           "concurrent_first_calls_s": together_s,
           "sequential_s": apart_s, "packs": packs, "launches": counts,
           "wrong_lookups": wrong_lookups,
           "phase_s": time.perf_counter() - start}
    print(f"scheduler: {len(xs)} counter chains (double then increment, "
          f"B=1 lookups): sequential {sequential_s:.3f} s, through "
          f"run_async futures {chained_s:.3f} s, outputs equal bit for bit, "
          f"wrong {wrong}; two run_async requests of {SCHEDULER_BATCH} "
          f"lookups at once on a fresh circuit (their first calls, "
          f"{packs} pack): {together_s:.3f} s, then the same two "
          f"sequentially {apart_s:.3f} s, outputs equal bit for bit, "
          f"wrong {wrong_lookups}; launches {counts}; phase "
          f"{rec['phase_s']:.1f} s", flush=True)
    return rec


def cli_phase(rng):
    """python -m concrete_tpu_torch compile | inspect | keygen | run as
    subprocesses on a 4-bit lookup circuit, each on the default device
    (the card); run's printed result held to the table."""
    import subprocess
    import tempfile
    start = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [v for v in [env.get("PYTHONPATH")] if v])
    rec = {"seconds": {}}
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "circuit.py"), "w") as f:
            f.write("import concrete_tpu_torch as fhe\n"
                    f"table = fhe.LookupTable({CLI_TABLE})\n\n\n"
                    "@fhe.compiler({'x': 'encrypted'})\n"
                    "def f(x):\n"
                    "    return table[x]\n")
        verbs = {
            "compile": ["compile", "circuit.py", "--function", "f",
                        "--inputset", "0:16", "--output", "server.zip"],
            "inspect": ["inspect", "server.zip"],
            "keygen": ["keygen", "server.zip", "--output", "keys.bin",
                       "--seed", str(SEED)],
            "run": ["run", "server.zip", "--keys", "keys.bin", "--args",
                    str(CLI_ARG)]}
        for verb, argv in verbs.items():
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "concrete_tpu_torch", *argv], cwd=d,
                env=env, capture_output=True, text=True, timeout=600)
            rec["seconds"][verb] = time.perf_counter() - t0
            if proc.returncode:
                fail(f"cli {verb} exited {proc.returncode}:\n"
                     f"{proc.stdout}{proc.stderr}")
            rec[verb] = proc.stdout.strip()
    shown = json.loads(rec["inspect"])
    if rec["run"] != str(CLI_TABLE[CLI_ARG]):
        fail(f"cli run printed {rec['run']!r}, want {CLI_TABLE[CLI_ARG]}")
    rec["params"] = shown["params"]
    rec["phase_s"] = time.perf_counter() - start
    print(f"cli: compile -> {rec['compile']!r}; inspect params "
          f"{shown['params']}, {shown['pbs_count']} PBS; run --args "
          f"{CLI_ARG} printed {rec['run']} (table: {CLI_TABLE[CLI_ARG]}); "
          f"seconds a verb { {k: round(v, 2) for k, v in rec['seconds'].items()} }"
          f"; phase {rec['phase_s']:.1f} s", flush=True)
    return rec


def parallel_phase(rng):
    """The parallel phase: one process per visible card (``parallel_rank``,
    this script started again), joined in an NCCL process group by
    ``parallel.distributed.initialize``; their records read back here.  A
    rank that fails to join, to launch or to match the bits fails the
    phase; every rank is stopped before it returns.  With one card the
    group has one rank: its collectives run, each over that rank alone."""
    import socket
    import tempfile
    import torch
    start = time.perf_counter()
    world = torch.cuda.device_count()
    torch.cuda.empty_cache()           # the cards' memory for the ranks
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "LOCAL_WORLD_SIZE": str(world)}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--parallel-rank", str(r), str(world), str(port), tmp],
            env={**env, "LOCAL_RANK": str(r)}, stdout=log,
            stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
        deadline = time.monotonic() + PARALLEL_TIMEOUT
        try:
            while time.monotonic() < deadline and any(
                    p.poll() is None for p in procs) and not any(
                    p.poll() for p in procs):
                time.sleep(0.5)
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                for line in f.read().splitlines():
                    print(f"  [rank {r}] {line}", flush=True)
        if any(codes):
            fail(f"parallel phase: rank exit codes {codes} (negative: "
                 f"stopped here, after a rank failed or at the "
                 f"{PARALLEL_TIMEOUT} s limit)")
        recs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    launches = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    r0 = recs[0]
    bt, lm = r0["batch"], r0["limb"]
    print(f"parallel: world {world} over {r0['devices']}; batch-sharded PBS "
          f"per rank { [round(r['batch']['pbs_per_s_rank'], 1) for r in recs] }"
          f" PBS/s, scaling {bt['scaling']}; the table archive on the shards "
          f"{r0['circuit']['wall_s']:.4f} s, bits equal to the unsharded "
          f"run; limb-sharded PBS (B={PARALLEL_LIMB_BATCH}, N="
          f"{lm['n']}) {lm['request_s'][-1]:.4f} s a request (traced idle "
          f"{lm['traced']['idle_share']:.3f}; an exchange "
          f"{lm['exchange_ms']:.4f} ms), launches a request "
          f"{lm['launches']}, spectrum shard {lm['shard_shape']} "
          f"({lm['shard_width']} = N/{world} wide); phase "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return {"world": world, "ranks": recs, "launches": launches,
            "host_products": sum(r["host_products"] for r in recs),
            "phase_s": time.perf_counter() - start}


def _rank_launches(want: dict, path: str) -> dict:
    """The launches since the last reset, held to `want` (kernel name ->
    launches; the rest none)."""
    from concrete_tpu_torch.ops import _build
    got = dict(_build.LAUNCHES)
    if got != want:
        fail(f"{path} launched {got}, want {want}")
    return got


def parallel_batch(rank: int) -> dict:
    """Batch-sharded PBS: PARALLEL_BATCH ciphertexts at
    BENCH_PARAMS_4BIT_TPUOPT (the table request's parameters, its truncated
    key), keys made on every rank from the smoke's seed, packed on rank 0
    and broadcast (``replicate_keys``); each rank runs ``sharded_pbs_fn``
    (``pbs_batch``: kernels A and B a step) on its shard, ``gather``
    assembles the batch; its bits against ``pbs_batch`` on the whole batch
    on this card, every decryption against the table."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.parallel import distributed as pd
    from concrete_tpu_torch.parallel import sharding as ps
    params = pp.BENCH_PARAMS_4BIT_TPUOPT
    rng = np.random.default_rng(SEED)       # the same keys on every rank
    t0 = time.perf_counter()
    sk, server_keys = kg.keygen_device(rng, params,
                                       torch.cuda.current_device())
    keygen_s = time.perf_counter() - t0
    mesh = ps.make_mesh()
    trunc = pp.choose_truncate_limbs(params, 4)
    t0 = time.perf_counter()
    ksk = bsk = None
    if rank == 0:
        ksk = kn.pack_ksk(server_keys.ksk, params)
        bsk = kn.pack_bsk(server_keys.bsk, params, trunc)
    ksk, bsk = ps.replicate_keys(mesh, ksk, bsk)
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0
    lut = torch.from_numpy(ref.encode_expand_lut(
        np.array(TABLE, dtype=np.uint64), params.polynomial_size, 4)
        .view(np.int64)).cuda()
    msgs = rng.integers(0, 16, PARALLEL_BATCH)
    ct_full = torch.from_numpy(kg.encrypt_lwe_batch(
        rng, sk.lwe_big, ref.encode(msgs, 4), params.glwe_std)
        .view(np.int64)).cuda()
    ct = ps.shard_ciphertexts(mesh, ct_full)
    fn = ps.sharded_pbs_fn(mesh, params, 4)
    fn(ct, ksk, bsk, lut)                   # first use: handles, library
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launches()                 # this path's run starts here
    t0 = time.perf_counter()
    out = fn(ct, ksk, bsk, lut)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    full = ps.gather(mesh, out)
    mesh_s = time.perf_counter() - t0
    launches = _rank_launches(                # ... and ends here: the
        {"rotate_decompose": params.n_small,  # banded scan, as the batch's
         "external_product_accumulate": params.n_small},
        "the batch-sharded PBS")
    slowest = torch.tensor([mesh_s], dtype=torch.float64, device="cuda")
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    t0 = time.perf_counter()
    want = kn.pbs_batch(ct_full, ksk, bsk, lut, params, 4)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if not torch.equal(full, want):
        fail("the batch-sharded PBS's gathered outputs differ from pbs_batch "
             "on the whole batch on one card")
    dec = ref.decode(ref.lwe_decrypt(
        sk.lwe_big, full.cpu().numpy().view(np.uint64)), 4)
    wrong = int(np.count_nonzero(dec != np.array(TABLE)[msgs]))
    if wrong:
        fail(f"batch-sharded PBS: {wrong} wrong of {PARALLEL_BATCH}")
    report = pd.scaling_report(PARALLEL_BATCH / one_s,
                               PARALLEL_BATCH / slowest.item())
    rec = {"keygen_s": keygen_s, "keys_s": keys_s, "shard": ct.shape[0],
           "local_s": local_s, "mesh_s": mesh_s, "one_card_s": one_s,
           "pbs_per_s_rank": ct.shape[0] / local_s, "scaling": report,
           "wrong": wrong, "launches": launches}
    print(f"batch-sharded PBS: {ct.shape[0]} of {PARALLEL_BATCH} "
          f"ciphertexts on this rank in {local_s:.4f} s "
          f"({rec['pbs_per_s_rank']:.1f} PBS/s), gathered {mesh_s:.4f} s; "
          f"the whole batch on one card {one_s:.4f} s, equal bits; 0 wrong; "
          f"keygen {keygen_s:.2f} s, pack and broadcast {keys_s:.2f} s; "
          f"launches {launches}; {report}", flush=True)
    return rec


def parallel_circuit(rank: int) -> dict:
    """The compiled table circuit on shards: ``Server.run`` of the
    committed table_sub archive on this rank's shard of an encrypted batch
    (keys from the smoke's seed on every rank; the batch encrypted on rank
    0, whose encryption draws from the system's generator, and broadcast),
    the shards gathered; bits against the unsharded run, decryptions
    against the table."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.parallel import sharding as ps
    server = tfhe.Server.load(FIXTURE)
    specs = server.client_specs
    client = tfhe.Client(specs)
    client.keygen(seed=SEED)
    ev = client.evaluation_keys
    rng = np.random.default_rng(SEED + 1)    # the same batch on every rank
    size = specs.inputs[0].shape[0]
    x, y = rng.integers(0, 16, size), rng.integers(0, 16, size)
    batch = [*client.encrypt(x, y)] if rank == 0 else [None, None]
    dist.broadcast_object_list(batch, src=0)
    cx, cy = batch
    (want,) = server.run(cx, cy, evaluation_keys=ev)   # packs the keys
    mesh = ps.make_mesh()
    sx, sy = ps.shard_ciphertexts(mesh, cx), ps.shard_ciphertexts(mesh, cy)
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launches()                  # this path's run starts here
    t0 = time.perf_counter()
    (out,) = server.run(sx, sy, evaluation_keys=ev)
    full = ps.gather(mesh, out)
    wall = time.perf_counter() - t0
    n_small = specs.params.n_small
    launches = _rank_launches(               # ... and ends here: the
        {"rotate_decompose": n_small,        # banded scan at 1024 / D rows
         "external_product_accumulate": n_small},
        "the sharded table circuit")
    if not np.array_equal(full, want):
        fail("the table circuit's gathered outputs differ from the unsharded "
             "run's")
    wrong = int(np.count_nonzero(client.decrypt(full)
                                 != np.array(TABLE)[x] - y))
    if wrong:
        fail(f"the sharded table circuit: {wrong} wrong of {size}")
    print(f"table circuit on a shard of {sx.shape[0]} of {size}: "
          f"{wall:.4f} s with the gather, bits equal to the unsharded run, "
          f"0 wrong; launches {launches}", flush=True)
    return {"shard": int(sx.shape[0]), "wall_s": wall, "wrong": wrong,
            "launches": launches}


def parallel_limb(rank: int) -> dict:
    """Limb-sharded PBS: ``pbs_batch_limb_sharded`` at BENCH_PARAMS_6BIT
    (N=4096) and B = PARALLEL_LIMB_BATCH, 6-bit lookups; keys from the
    smoke's seed, the four-step spectra packed on rank 0 and broadcast,
    this rank keeping its k1 block.  Kernels 1 and 4 held to their plain
    versions at the path's shapes first; then the request twice (the
    second timed), its launches (kernels 1 and 4 once a step), its bits
    against ``ntt_fourstep.blind_rotate_ntt`` and ``pbs_batch`` on an exact
    banded key on this card, its decryptions against the table."""
    import math
    import numpy as np
    import torch
    import torch.distributed as dist
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import ntt_fourstep as nt
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.parallel import limb_sharding as ls
    from concrete_tpu_torch.parallel import sharding as ps
    params = pp.BENCH_PARAMS_6BIT
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    sk, keys = kg.keygen_device(rng, params, torch.cuda.current_device())
    keygen_s = time.perf_counter() - t0
    mesh = ls.make_limb_mesh()
    world, me = mesh.size(), mesh.get_local_rank()
    if not ls.check_limb_shardable(params, world):
        fail(f"N={n} does not split over {world} ranks")
    primes = nt.choose_primes(params)
    t0 = time.perf_counter()
    ksk = nbsk = None
    if rank == 0:
        ksk = kn.pack_ksk(keys.ksk, params)
        nbsk = nt.pack_bsk_ntt(keys.bsk, params, primes)
    ksk, nbsk = ps.replicate_keys(mesh, ksk, nbsk, axis_name=ls.LIMB_AXIS)
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0
    n1 = nt.build_plan(n, primes[0]).n1
    shard = tuple(ls.spectrum_shard(nbsk.spectra, n1, world, me).shape)
    rows, blk = PARALLEL_LIMB_BATCH * kp1, n // world
    # kernels 1 and 4 at this path's shapes, against their plain versions
    # (kernel 4 on residues of products within the primes' range)
    check_digits(rng, rows=rows, n=n, base_log=params.pbs_base_log,
                 levels=params.pbs_level, timed=False, clock=None)
    half = math.prod(primes) // 8
    z = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, rows * blk)]
    z = [v * (half >> 62) for v in z]
    res = torch.tensor([[v % p for v in z] for p in primes],
                       dtype=torch.int64).view(len(primes), rows, blk)
    res = res.to(torch.int32).cuda()
    acc = rand_torus(rng, (rows, blk), "cuda")
    got = fn.garner_accumulate(res, acc.clone(), primes, 0)
    if not torch.equal(got, fn.garner_accumulate_plain(res, acc.clone(),
                                                       primes, 0)):
        fail(f"garner_accumulate differs from its plain version at the "
             f"limb-sharded path's shape ({len(primes)} primes {primes}, "
             f"{rows} x {blk})")
    lut = torch.from_numpy(ref.encode_expand_lut(
        np.array(DIRECT_TABLE, dtype=np.uint64), n, 6).view(np.int64)).cuda()
    msgs = rng.integers(0, 64, PARALLEL_LIMB_BATCH)
    ct = torch.from_numpy(kg.encrypt_lwe_batch(
        rng, sk.lwe_big, ref.encode(msgs, 6), params.glwe_std)
        .view(np.int64)).cuda()
    walls = []
    for _ in range(2):                       # the first builds the tables
        torch.cuda.synchronize()
        dist.barrier()
        _build.reset_launches()              # this path's run starts here
        t0 = time.perf_counter()
        out = ls.pbs_batch_limb_sharded(mesh, ct, ksk, nbsk, lut, params, 6)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = _rank_launches(           # ... and ends here
            {"rotate_decompose_digits": params.n_small,
             "garner_accumulate": params.n_small}, "the limb-sharded PBS")
    # where a request's time goes: one traced, and the step's exchange
    # (one all_to_all_single with its two layout copies) timed alone
    def request():
        t0 = time.perf_counter()
        ls.pbs_batch_limb_sharded(mesh, ct, ksk, nbsk, lut, params, 6)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    wall, by_kernel, kernels_run, _ = profile_run(request, host_ops=False)
    busy = sum(ms for *_, ms in by_kernel)
    traced = {"wall_s": wall, "device_busy_ms": busy,
              "idle_share": 1 - busy / (wall * 1e3),
              "nccl_ms": sum(ms for k, _, ms in by_kernel
                             if "nccl" in k.lower()),
              "device_kernels": kernels_run,
              "by_kernel": [{"name": k[:90], "count": c, "device_ms": ms}
                            for k, c, ms in by_kernel[:8]]}
    group = mesh.get_group(ls.LIMB_AXIS)
    y = torch.zeros((len(primes), PARALLEL_LIMB_BATCH * kp1, n1 // world,
                     n // n1), dtype=torch.int32, device="cuda")
    ls._exchange(y, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ls._exchange(y, group)
    torch.cuda.synchronize()
    exchange_ms = (time.perf_counter() - t0) / 200 * 1e3
    small = kn.keyswitch(ct, ksk)
    t0 = time.perf_counter()
    want = kn.sample_extract(nt.blind_rotate_ntt(small, nbsk, lut, params))
    torch.cuda.synchronize()
    ntt_s = time.perf_counter() - t0
    if not torch.equal(out, want):
        fail("the limb-sharded PBS differs from blind_rotate_ntt on one card")
    t0 = time.perf_counter()
    exact = kn.pbs_batch(ct, ksk, kn.pack_bsk(keys.bsk, params), lut,
                         params, 6)
    torch.cuda.synchronize()
    banded_s = time.perf_counter() - t0
    if not torch.equal(out, exact):
        fail("the limb-sharded PBS differs from pbs_batch on an exact banded "
             "key on one card")
    dec = ref.decode(ref.lwe_decrypt(
        sk.lwe_big, out.cpu().numpy().view(np.uint64)), 6)
    wrong = int(np.count_nonzero(dec != np.array(DIRECT_TABLE)[msgs]))
    if wrong:
        fail(f"limb-sharded PBS: {wrong} wrong of {PARALLEL_LIMB_BATCH}")
    rec = {"n": n, "primes": list(primes), "keygen_s": keygen_s,
           "keys_s": keys_s, "request_s": walls, "launches": launches,
           "per_step": {k: v / params.n_small for k, v in launches.items()},
           "blind_rotate_ntt_s": ntt_s, "pbs_batch_banded_s": banded_s,
           "shard_shape": shard, "shard_width": shard[-2] * shard[-1],
           "traced": traced, "exchange_ms": exchange_ms, "wrong": wrong}
    print(f"limb-sharded PBS at {params}, B={PARALLEL_LIMB_BATCH}, {world} "
          f"rank(s), {len(primes)} primes: requests "
          f"{[round(w, 4) for w in walls]} s, launches {launches}; equal to "
          f"blind_rotate_ntt ({ntt_s:.4f} s) and to pbs_batch on the exact "
          f"banded key ({banded_s:.4f} s) on one card; 0 wrong; spectrum "
          f"shard {shard}; keygen {keygen_s:.2f} s, pack and broadcast "
          f"{keys_s:.2f} s; one request traced: wall {wall:.4f} s, device "
          f"busy {busy:.2f} ms (idle {traced['idle_share']:.3f}, NCCL "
          f"{traced['nccl_ms']:.2f} ms), {kernels_run} kernels; an "
          f"exchange alone {exchange_ms:.4f} ms", flush=True)
    for k in traced["by_kernel"]:
        print(f"  {k['device_ms']:9.3f} ms {k['count']:6d}x  {k['name']}",
              flush=True)
    return rec


def parallel_rank(rank: str, world: str, port: str, out_dir: str) -> None:
    """One rank of the parallel phase: joins the NCCL group at
    tcp://localhost:`port` on its card (``LOCAL_RANK``), loads the smoke's
    kernel library, runs the three paths and writes its record to
    `out_dir`/rank<rank>.json."""
    import torch
    import torch.distributed as dist
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.parallel import distributed as pd
    rank, world = int(rank), int(world)
    t0 = time.perf_counter()
    pd.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank)
    if dist.get_backend() != "nccl":
        fail(f"rank {rank} joined a {dist.get_backend()} group, not NCCL")
    _build.library()
    names = [None] * world
    dist.all_gather_object(names, f"{torch.cuda.get_device_name()} "
                                  f"(cuda:{torch.cuda.current_device()})")
    init_s = time.perf_counter() - t0
    print(f"rank {rank} of {world}: devices {names}, joined and loaded in "
          f"{init_s:.1f} s", flush=True)
    with host_products() as products:
        rec = {"world": world, "devices": names, "init_s": init_s,
               "batch": parallel_batch(rank),
               "circuit": parallel_circuit(rank),
               "limb": parallel_limb(rank)}
    rec["host_products"] = products.calls
    rec["launches"] = {}
    for path in ("batch", "circuit", "limb"):
        for k, v in rec[path]["launches"].items():
            rec["launches"][k] = rec["launches"].get(k, 0) + v
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def kind_circuits(tfhe, rng):
    """The node kinds that the models phase's circuits hold none of, in five
    small circuits (the functions of tests/test_torch_executor.py, written
    again with the port): {name: (statuses, function, inputset, a draw of
    one run's arguments, node kinds the graph must hold, ties)}.  ties(args)
    maps an output's position to the elements whose rounding is a tie: the
    JAX package's fused rounding puts a tie of round_bit_pattern (and an
    exact multiple under truncate_bit_pattern's half-step bias) on a
    lookup box's edge, where the noise decides (ROADMAP queue 3)."""
    import numpy as np
    per_element = tfhe.LookupTable([[0, 1, 2, 3], [3, 2, 1, 0],
                                    [1, 3, 0, 2]])
    weight = np.array([[[[1, -1], [0, 2]], [[2, 0], [1, 1]]],
                       [[[0, 1], [1, 0]], [[-1, 1], [1, 2]]]])

    def levelled(x, y):
        z = tfhe.zeros((2, 3)) + x
        s = np.sum(z, axis=-1) + np.sum(x, axis=(0,))[:2]
        c = np.concatenate([x, x[::-1]], axis=0)
        b = np.broadcast_to(x[1], (2, 3))
        r = (b + c[1:3]).reshape(3, 2)
        t = np.transpose(r) + y * 2
        a = tfhe.array([s[0], x[0, 2], 3])
        u = tfhe.hint(a, bit_width=4) - tfhe.ones(3) + tfhe.ones_like(y) \
            + tfhe.zeros_like(y)
        v = -x[0] + tfhe.constant(9) + tfhe.one() + tfhe.zero()
        return t, u, v, y + 1

    def lookups(x, y):
        a = per_element[x]
        m = tfhe.multivariate(lambda u, v: (u + 2 * v) % 4)(x, y)
        c = tfhe.mux(x > 1, x, y)
        r = tfhe.relu(x - y) + tfhe.refresh(y) + tfhe.identity(x)
        q = tfhe.round_bit_pattern(x + y, lsbs_to_remove=1)
        t = tfhe.truncate_bit_pattern(x + 2 * y, lsbs_to_remove=2)
        return a + m, c, r, tfhe.univariate(lambda v: v // 2)(q), \
            tfhe.univariate(lambda v: v)(t)

    def windows(x):
        return (tfhe.conv(x, weight, bias=[1, 2], strides=(2, 1),
                          padding=(1, 1)),
                tfhe.maxpool(x, (2, 2), strides=(1, 1)))

    def fancy(x, v):
        a = x[[2, 0], :, [1, 1]]
        b = x[..., ::-2, None]
        c = x[np.int64(1), [0, 1]]
        x2 = x.reshape(3, 2, 2)
        x2[[0, 2, 0], 1] = v
        x2[1, :, 0] = 3
        return a, b, c, tfhe.trace(x2, "after assign")

    def dynamic(t, x):
        return t[x] + 1

    def u2(*shape):
        return rng.integers(0, 4, shape)

    def rounding_ties(x, y):
        return {3: (x + y) % 2 == 1, 4: (x + 2 * y) % 4 == 0}

    return {
        "levelled": ({"x": "encrypted", "y": "clear"}, levelled,
                     [(np.array([[0, 1, 2], [3, 2, 1]]), np.array([1, 0, 2])),
                      (np.full((2, 3), 3), np.full(3, 2)),
                      (np.zeros((2, 3), np.int64), np.zeros(3, np.int64))],
                     lambda: (u2(2, 3), rng.integers(0, 3, 3)),
                     {"encrypted_constant", "add", "subtract", "negative",
                      "sum", "index", "concatenate", "broadcast_to",
                      "reshape", "transpose", "array", "hint", "multiply"},
                     None),
        "lookups": ({"x": "encrypted", "y": "encrypted"}, lookups,
                    [(np.array([0, 1, 2]), np.array([3, 0, 1])),
                     (np.full(3, 3), np.full(3, 3)),
                     (np.zeros(3, np.int64), np.zeros(3, np.int64))],
                    lambda: (u2(3), u2(3)),
                    {"tlu", "multivariate", "univariate",
                     "round_bit_pattern", "truncate_bit_pattern"},
                    rounding_ties),
        "windows": ({"x": "encrypted"}, windows,
                    [u2(1, 2, 3, 3) for _ in range(6)]
                    + [np.full((1, 2, 3, 3), 3),
                       np.zeros((1, 2, 3, 3), np.int64)],
                    lambda: (u2(1, 2, 3, 3),),
                    {"conv", "index", "univariate"}, None),
        "fancy": ({"x": "encrypted", "v": "encrypted"}, fancy,
                  [(u2(3, 2, 2), u2(3, 2)) for _ in range(5)]
                  + [(np.full((3, 2, 2), 3), np.full((3, 2), 3))],
                  lambda: (u2(3, 2, 2), u2(3, 2)),
                  {"index", "assign", "reshape", "trace_message"}, None),
        "dynamic": ({"t": "clear", "x": "encrypted"}, dynamic,
                    tfhe.inputset(tfhe.tensor[tfhe.uint2, 4],
                                  tfhe.tensor[tfhe.uint2, 3], n=8, seed=1)
                    + [(np.full(4, 3), np.full(3, 3))],
                    lambda: (u2(4), u2(3)), {"dynamic_tlu"}, None),
    }


def kinds_phase(rng):
    """Each of kind_circuits() compiled by the port at the default
    Configuration() (the lookups one also with approximate rounding),
    keys from the seed, two runs through Circuit.run of arguments within
    the compiled bounds (covered_draws), decrypted against numpy's
    evaluation of the same function (the graph's clear evaluation); every
    kernel call of the runs, at each signature, held to its plain version
    on the same inputs (same_inputs).  Where the packing rule's key is a
    truncated fused key (exact_keys), the same ciphertexts run again on
    the exact key, whose decryptions are held, and the rule's wrong count
    is printed.  Then the WoP-PBS kinds (wop_kind_circuits, each at its
    own configuration), whose output ciphertexts are also held to the
    CPU's plain path on the same keys and ciphertexts."""
    import numpy as np
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    out = {}
    circuits = kind_circuits(tfhe, rng)
    cases = [(name, case, {}, False) for name, case in circuits.items()]
    cases.append(("lookups_approximate", circuits["lookups"],
                  {"rounding_exactness": tfhe.Exactness.APPROXIMATE}, False))
    cases += [(name, case, cfg, True) for name, (case, cfg)
              in wop_kind_circuits(tfhe, rng).items()]
    for name, (statuses, fn, inputset, draw, kinds, ties), cfg, wop in cases:
        approx = "rounding_exactness" in cfg
        t0 = time.perf_counter()
        circuit = tfhe.compiler(statuses)(fn).compile(
            inputset, tfhe.Configuration(**cfg))
        compile_s = time.perf_counter() - t0
        held = {n.name for n in circuit.graph.graph.nodes}
        if not kinds <= held:
            fail(f"kinds circuit {name} holds no {sorted(kinds - held)}")
        runs, draws = covered_draws(circuit, draw, 2)
        circuit.keygen(seed=SEED)
        ev = circuit._evaluation_keys()
        exact = exact_keys(circuit, ev)

        def wrong_of(args, run):
            enc = circuit.encrypt(*args)
            enc = enc if isinstance(enc, tuple) else (enc,)
            t0 = time.perf_counter()
            res = run(enc)
            wall = time.perf_counter() - t0
            dec = circuit.decrypt(*res)
            dec = dec if isinstance(dec, tuple) else (dec,)
            want = circuit.graph(*args)
            want = want if isinstance(want, tuple) else (want,)
            # approximate rounding may land a truncation a step up: its
            # rounded outputs are not held to the exact evaluation; a tie
            # of the exact one is counted apart
            held_out = 3 if approx else len(want)
            tie = ties(*args) if ties and not approx else {}
            wrong = values = flips = n_ties = 0
            for k, (d, w) in enumerate(zip(dec[:held_out], want[:held_out])):
                off = np.asarray(d).reshape(-1) != np.asarray(w).reshape(-1)
                mask = np.asarray(tie.get(k, False)).reshape(-1) \
                    & np.ones_like(off)
                wrong += int(np.count_nonzero(off & ~mask))
                values += int(np.count_nonzero(~mask))
                flips += int(np.count_nonzero(off & mask))
                n_ties += int(np.count_nonzero(mask))
            return wrong, values, flips, n_ties, wall

        served_runs = []

        def served(enc):
            res = circuit.run(*enc)
            res = res if isinstance(res, tuple) else (res,)
            served_runs.append((enc, res))
            return res

        def on_exact(enc):
            return circuit.server.run(*enc, evaluation_keys=exact)

        tally = {"path": [0] * 4, "exact": [0] * 4}
        walls = []
        _build.reset_launches()
        checks = same_inputs(f"kinds {name}")
        with checks:
            for label, run in (("path", served), ("exact", on_exact)):
                if label == "exact":
                    launches = dict(_build.LAUNCHES)   # the path's alone
                    if exact is None:
                        break
                for args in runs:
                    *counts, wall = wrong_of(args, run)
                    tally[label] = [t + c for t, c in zip(tally[label],
                                                          counts)]
                    walls += [wall] if label == "path" else []
        checked = checks.check()
        cpu_s = None
        if wop:
            # the WoP circuits' bits against the CPU's plain path on the
            # same keys and ciphertexts
            cpu = tfhe.Server(circuit.graph, circuit.client_specs,
                              device="cpu")
            t0 = time.perf_counter()
            for enc, res in served_runs:
                if any(not np.array_equal(a, b) for a, b in zip(
                        res, cpu.run(*enc, evaluation_keys=cpu_keys(*ev)))):
                    fail(f"kinds circuit {name}: the card's outputs differ "
                         f"from the plain path's on the CPU")
            cpu_s = time.perf_counter() - t0
        wrong, values, flips, n_ties = tally["path" if exact is None
                                             else "exact"]
        allowed = max(2, 1e-3 * values)
        p = circuit.client_specs.params
        print(f"kinds {name} ({sorted(kinds)}): n_small={p.n_small} "
              f"k={p.glwe_dimension} N={p.polynomial_size} security "
              f"{p.security_level}"
              + (f", WoP gadgets {circuit.client_specs.wop_gadgets}"
                 if circuit.client_specs.wop_gadgets else "")
              + f", compile "
              f"{compile_s:.3f} s, {circuit.programmable_bootstrap_count} "
              f"PBS a run, runs within the compiled bounds in {draws} "
              f"draws, {key_form(ev[1])}, Circuit.run "
              f"{[f'{w * 1e3:.1f}' for w in walls]} ms"
              + (f", wrong {wrong} of {values} (allowed {allowed})"
                 if exact is None else
                 f", wrong {tally['path'][0]} of {tally['path'][1]} on the "
                 f"packing rule's key, {wrong} of {values} on the exact key "
                 f"({key_form(exact[1])}; allowed {allowed})")
              + (f", rounding ties decided the other way {flips} of "
                 f"{n_ties}" if n_ties else "")
              + (f", output ciphertexts equal to the CPU's plain path's "
                 f"({cpu_s:.1f} s)" if wop else "")
              + f", launches {launches}, kernel calls held to their plain "
              f"versions: { {k: v['signatures'] for k, v in checked.items()} }",
              flush=True)
        if wrong > allowed:
            fail(f"kinds circuit {name}: {wrong} wrong of {values}")
        out[name] = {"compile_s": compile_s, "walls_s": walls,
                     "draws": draws, "key": key_form(ev[1]), "wrong": wrong,
                     "values": values, "tie_flips": flips, "ties": n_ties,
                     "launches": launches, "checked": checked,
                     "path_wrong": tally["path"][0], "cpu_plain_s": cpu_s,
                     "exact_key": None if exact is None
                     else key_form(exact[1])}
    return out


def check_keyed(rng, *, batch, n, kp1, levels, base_log, keys, index,
                clock=None, mix=None, timed=False, label=""):
    """Kernel 3's keyed entry on random digits and a stack of `keys`
    random GGSW-shaped keys (their spectra from kernel 2's pack entry, as
    the vertical packing makes them), ciphertext b reading key index[b],
    held bit-exact to its plain version; timed at this shape.  Its bytes
    bound reads each distinct key's spectra and companions once."""
    import numpy as np
    import torch
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.ops import ntt as tn
    dev = "cuda"
    primes = host.runtime_primes(n, kp1, base_log, levels)
    cin, n_p = levels * kp1, len(primes)
    ggsw = rand_torus(rng, (keys * cin * kp1, n), dev)
    spec, sh = tn.ntt_forward_pack(ggsw, primes, cin * kp1, 0)
    digits = torch.from_numpy(rng.integers(
        -(1 << (base_log - 1)), 1 << (base_log - 1),
        (levels, batch * kp1, n)).astype(np.int32)).to(dev)
    idx = torch.from_numpy(np.asarray(index, dtype=np.int32)).to(dev)
    got = fn.crt_external_product_keyed(digits, spec, sh, idx, primes, kp1)
    want = fn.crt_external_product_keyed_plain(digits, spec, sh, idx,
                                               primes, kp1)
    torch.cuda.synchronize()
    shape = (f"B={batch} N={n} k+1={kp1} l={levels} base 2^{base_log} "
             f"P={n_p}, {keys} keys, {len(set(np.asarray(index).tolist()))} "
             f"read{label}")
    if not torch.equal(got, want):
        fail(f"{KEYED} differs from its plain version at {shape}")
    rec = {"max_abs_err": max_abs_err(got, want), "shape": shape}
    if timed:
        rec["ms"] = cuda_ms(lambda: fn.crt_external_product_keyed(
            digits, spec, sh, idx, primes, kp1), 10)
        rec["plain_ms"] = cuda_ms(
            lambda: fn.crt_external_product_keyed_plain(
                digits, spec, sh, idx, primes, kp1), 3)
        work = {**ntt_work(batch * n_p * cin, n),
                **ntt_work(batch * n_p * kp1, n, inverse=True),
                "mul_add": batch * n_p * cin * kp1 * n}
        ops_ms, detail = pipe_ms(work, mix, clock)
        distinct = len(set(np.asarray(index).tolist()))
        nbytes = (digits.numel() + idx.numel() + got.numel()) * 4 \
            + distinct * 2 * spec[0].numel() * 4
        rec.update(bound(ops_ms, nbytes, work=work, **detail),
                   library_ms=None)
    print(f"{KEYED} bit-exact at {shape}: {rec}", flush=True)
    return rec


def wop_keyed_checks(rng, clock, mix):
    """Kernel 3's keyed entry and kernel 2's pack entry at the vertical
    packing's shapes: PIR 32's (16 ciphertexts of 9 bits, N=4096, k+1=2,
    cbs 3 x 2^5: its rotation phase, one key per ciphertext, and the pack
    of its 144 GGSWs), a tree phase's (pairs of ciphertexts on one key:
    repeated indices), the node-kinds circuits' N=256 and 512, and k+1=3
    (accumulators in shared memory); then PIR over 64 rows' (16
    ciphertexts of 11 bits, N=8192, cbs 5 x 2^3: its rotation step and
    the pack of its 176 GGSWs), timed."""
    from concrete_tpu_torch.core import ntt as host
    b, nb = PIR_WOP_SHAPE[1], 9
    rec = check_keyed(rng, batch=b, n=4096, kp1=2, levels=3, base_log=5,
                      keys=b * nb, index=[i * nb + nb - 1 for i in range(b)],
                      clock=clock, mix=mix, timed=True,
                      label=": PIR 32's rotation step")
    tree = check_keyed(rng, batch=4 * b, n=4096, kp1=2, levels=3,
                       base_log=5, keys=b * nb,
                       index=[(i // 4) * nb + 1 for i in range(4 * b)],
                       clock=clock, mix=mix, timed=True,
                       label=": a tree step, 4 pairs a key")
    for n, kp1 in ((256, 2), (512, 2), (1024, 3), (16384, 2)):
        check_keyed(rng, batch=3, n=n, kp1=kp1, levels=3, base_log=6,
                    keys=5, index=[4, 0, 4])
    pack = check_ntt_pack(rng, n_small=b * nb, rows=3 * 2 * 2, n=4096,
                          primes=host.runtime_primes(4096, 2, 5, 3),
                          trunc_bits=0, clock=clock, mix=mix, timed=True)
    for n in (256, 512):
        check_ntt_pack(rng, n_small=4, rows=12, n=n,
                       primes=host.runtime_primes(n, 2, 6, 3), trunc_bits=0)
    b64, nb64 = PIR_64_SHAPE[1], 11
    cbs_l, cbs_b = PIR_64_GADGETS[:2]
    rec64 = check_keyed(rng, batch=b64, n=8192, kp1=2, levels=cbs_l,
                        base_log=cbs_b, keys=b64 * nb64,
                        index=[i * nb64 + nb64 - 1 for i in range(b64)],
                        clock=clock, mix=mix, timed=True,
                        label=": PIR 64's rotation step")
    pack64 = check_ntt_pack(rng, n_small=b64 * nb64, rows=cbs_l * 2 * 2,
                            n=8192, primes=host.runtime_primes(
                                8192, 2, cbs_b, cbs_l),
                            trunc_bits=0, clock=clock, mix=mix, timed=True)
    return {"rotation": rec, "tree": tree, "pack": pack,
            "rotation_pir_64": rec64, "pack_pir_64": pack64}


def wop_phase(rng):
    """PrivateInformationRetrieval over 32 rows of 16 (a 9-bit WoP row
    fetch at N=4096) and over 64 rows of 16 (11 bits at N=8192, its PFPKSK
    of 65,544 GLWE rows made on the card), each compiled by the port at
    the default Configuration() and served on the card as the models are
    (serve_model: the memory check before any key, keygen with its
    PFPKSK's draws, product and pack, the BSK's pack by part, two requests
    through Circuit.run within the models' rule of wrong decryptions, held
    on the exact key where the rule truncates, bits equal to the
    archive-loaded Server's, every kernel call held to its plain version
    on the same inputs, the launches of its blind-rotate forms and
    vertical packing, one request traced)."""
    import numpy as np
    import torch
    from concrete_tpu_torch import models as tm
    out = {}
    for name, shape in (("pir_32", PIR_WOP_SHAPE), ("pir_64", PIR_64_SHAPE)):
        pir = tm.PrivateInformationRetrieval(rng.integers(0, 16, shape))

        def wrong_of(x, dec, pir=pir):
            want = np.asarray(pir.query_clear(*x)).reshape(-1)
            got = np.concatenate([np.asarray(d).reshape(-1) for d in dec])
            return int(np.count_nonzero(got != want)), want.size

        def compiled(pir=pir, name=name):
            circuit = pir.compile()
            if name == "pir_64" and tuple(
                    circuit.client_specs.wop_gadgets) != PIR_64_GADGETS:
                fail(f"PIR 64 compiled to the gadgets "
                     f"{circuit.client_specs.wop_gadgets}, the keyed checks "
                     f"ran at {PIR_64_GADGETS}")
            return circuit

        torch.cuda.reset_peak_memory_stats()
        rec = out[name] = serve_model(
            name, compiled, lambda shape=shape: (int(rng.integers(
                0, shape[0])),), wrong_of)
        per_request = {k: v / MODEL_REQUESTS
                       for k, v in rec["launches"].items()}
        print(f"PIR {shape}: launches a request {per_request} "
              f"({rec['launches'].get('ntt_forward_pack', 0)} packs of the "
              f"circuit bootstrap's GGSWs and "
              f"{rec['launches'].get(KEYED, 0)} keyed products in "
              f"{MODEL_REQUESTS} requests); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        torch.cuda.empty_cache()
    return out


def wop_kind_circuits(tfhe, rng):
    """The WoP-PBS node kinds at N=256 (a banded key): fhe.bits at the
    default Configuration() (the function of tests/test_extensions.py: no
    WoP gadgets, the lsb cascade of sign PBS), fhe.crt_tlu at
    tests/test_crt_tlu.py's forced parameters and a 10-bit lookup at
    tests/test_wop_frontend.py's (TEST_PARAMS_TINY_WIDE, security 0,
    gadgets (3, 6, 8, 4)); entries as kind_circuits', with each one's
    configuration."""
    import numpy as np
    from concrete_tpu_torch.extensions import crt
    from concrete_tpu_torch.params import TEST_PARAMS_TINY_WIDE
    forced = {"forced_parameters": TEST_PARAMS_TINY_WIDE,
              "forced_wop_parameters": (3, 6, 8, 4)}
    moduli = (3, 4, 5)
    crt_table = np.array([(7 * v + 1) % 60 for v in range(60)],
                         dtype=np.int64)
    wide = tfhe.LookupTable([(3 * i + 1) % 32 for i in range(1 << 10)])

    def bits(x):
        return tfhe.bits(x)[0] + 2 * tfhe.bits(x)[2]

    def crt_lookup(r0, r1, r2):
        return crt.crt_tlu((r0, r1, r2), crt_table, moduli)

    def wide_lookup(x):
        return wide[x]

    return {
        "bits": (({"x": "encrypted"}, bits, range(8),
                  lambda: (int(rng.integers(0, 8)),), {"extract_bits"},
                  None), {}),
        "crt_tlu": (({"r0": "encrypted", "r1": "encrypted",
                      "r2": "encrypted"}, crt_lookup,
                     [tuple(crt.crt_encode_clear(v, moduli))
                      for v in range(0, 60, 7)] + [(2, 3, 4)],
                     lambda: tuple(crt.crt_encode_clear(
                         int(rng.integers(0, 60)), moduli)),
                     {"crt_tlu"}, None), forced),
        "wide_tlu": (({"x": "encrypted"}, wide_lookup, [0, 517, 1023],
                      lambda: (int(rng.integers(0, 1024)),), {"tlu"},
                      None), forced),
    }


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v log: its
    (mangled) name, registers, and spill stores and loads."""
    lines, name = [], None
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            name = head.group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            spills = f"spills {spill.group(1)}/{spill.group(2)} B"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            lines.append(f"{name}: {regs.group(1)} registers, {spills}")
            name = None
    return lines


def sm_clock() -> tuple[int, float, str]:
    """The card's SM count and maximum SM clock (Hz), and the clocks as
    nvidia-smi reads them."""
    import torch
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms, float(out.split(",")[0]) * 1e6, \
        f"{sms} SMs, SM clock max,now MHz {out}"


def sass_mix() -> dict:
    """Instructions of one operation of csrc/ntt.cuh per pipe, from the
    SASS of csrc/op_probes.cu in the built library; "other" (loads,
    stores, control, uniform datapath) is shown and not charged."""
    import collections
    from torch.utils.cpp_extension import CUDA_HOME
    from concrete_tpu_torch.ops import _build
    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", _build.BUILD_INFO["path"]],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = counts.setdefault(head.group(1), collections.Counter())
            continue
        op = SASS_OP.match(line)
        if fn is not None and op and not op.group(1).startswith("NOP"):
            fn[PIPES.get(op.group(1).split(".")[0], "other")] += 1
    mix = {}
    for name in PROBED:
        long_, short = (counts.get(f"probe_{name}_{r}") for r in (64, 32))
        if not long_ or not short:
            fail(f"no SASS for the {name} probes in "
                 f"{_build.BUILD_INFO['path']}")
        mix[name] = {pipe: (long_[pipe] - short[pipe]) / 32
                     for pipe in sorted(set(long_) | set(short))}
    return mix


def pipe_ms(work: dict, mix: dict, clock) -> tuple[float, dict]:
    """Least device ms for `work` (operation -> count) at the pipes' and
    the issue's peak rates: the busiest of them."""
    sms, hz = clock[:2]
    per_pipe = {pipe: sum(n * mix[op].get(pipe, 0.0) for op, n in work.items())
                for pipe in PIPE_RATES}
    clocks = {pipe: per_pipe[pipe] / rate for pipe, rate in PIPE_RATES.items()}
    clocks["issue"] = sum(per_pipe.values()) / ISSUE_PER_CLOCK_PER_SM
    busiest = max(clocks, key=clocks.get)
    return clocks[busiest] / (sms * hz) * 1e3, {
        "instructions": per_pipe, "busiest": busiest}


def tally_ms(ops: float, clock) -> float:
    sms, hz = clock[:2]
    return ops / (ONE_PIPE_PER_CLOCK_PER_SM * sms * hz) * 1e3


def bound(ops_ms: float, nbytes: float, **detail) -> dict:
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bytes": nbytes,
            **detail}


def ntt_work(transforms: int, n: int, inverse: bool = False) -> dict:
    """Operations of `transforms` size-N transforms."""
    bfly = transforms * (n // 2) * (n.bit_length() - 1)
    if inverse:
        return {"gs_butterfly": bfly, "shoup_mul": transforms * n}
    return {"ct_butterfly": bfly}


def fused_params(n: int, levels: int, base_log: int, n_small: int,
                 kp1: int = 2):
    from concrete_tpu_torch.params import CryptoParams
    return CryptoParams(n_small=n_small, glwe_dimension=kp1 - 1,
                        polynomial_size=n, pbs_level=levels,
                        pbs_base_log=base_log, ks_level=1, ks_base_log=2,
                        lwe_std=0.0, glwe_std=0.0, security_level=0)


def check_fused_steps(rng, *, batch, n, levels, base_log, primes,
                      trunc_bits, acc32, steps, clock, mix, timed, kp1=2):
    """A few CRT-NTT blind-rotate steps on random keys and accumulators:
    every launch of the three step kernels, on the evolving accumulator,
    is held bit-exact against its plain version on the same inputs."""
    import numpy as np
    import torch
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.ops import step
    dev = "cuda"
    rows, n_p = batch * kp1, len(primes)
    shape = (f"B={batch} N={n} k+1={kp1} l={levels} base_log={base_log} "
             f"P={n_p} t={trunc_bits} {'acc32' if acc32 else 'full'}")
    bsk = rng.integers(0, 1 << 64, (steps, levels, kp1, kp1, n),
                       dtype=np.uint64)
    fbsk = fn.pack_bsk_fused(bsk, fused_params(n, levels, base_log, steps,
                                               kp1),
                             primes=primes, trunc_bits=trunc_bits,
                             device=dev)
    if acc32:
        acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (rows, n))
                               .astype(np.int32)).to(dev)
    else:
        acc = rand_torus(rng, (rows, n), dev)
    a_rows = torch.from_numpy(rng.integers(0, 2 * n, (steps, rows))
                              .astype(np.int32)).to(dev)
    kw = dict(base_log=base_log, levels=levels)
    errs = dict.fromkeys(FUSED_KERNELS, 0.0)
    first = None
    for i in range(steps):
        d = step.rotate_decompose_digits(acc, a_rows[i], **kw)
        d_p = step.rotate_decompose_digits_plain(acc, a_rows[i], **kw)
        sv, ss = fbsk.spec_val[i], fbsk.spec_sh[i]
        res = fn.crt_external_product(d, sv, ss, primes, kp1)
        res_p = fn.crt_external_product_plain(d, sv, ss, primes, kp1)
        new = fn.garner_accumulate(res, acc.clone(), primes, trunc_bits)
        new_p = fn.garner_accumulate_plain(res, acc.clone(), primes,
                                           trunc_bits)
        torch.cuda.synchronize()
        for name, got, want in zip(FUSED_KERNELS, (d, res, new),
                                   (d_p, res_p, new_p)):
            if not torch.equal(got, want):
                fail(f"{name} differs from its plain version at step {i}, "
                     f"{shape}")
            errs[name] = max(errs[name], max_abs_err(got, want))
        if first is None:
            first = (acc, d, res)
        acc = new
    recs = {name: {"max_abs_err": errs[name]} for name in FUSED_KERNELS}
    if timed:
        acc0, d0, res0 = first
        sv, ss = fbsk.spec_val[0], fbsk.spec_sh[0]
        r = recs["rotate_decompose_digits"]
        r["ms"] = cuda_ms(lambda: step.rotate_decompose_digits(
            acc0, a_rows[0], **kw), 50)
        r["plain_ms"] = cuda_ms(lambda: step.rotate_decompose_digits_plain(
            acc0, a_rows[0], **kw), 5)
        r.update(bound(tally_ms(rows * n * (10 + 6 * levels), clock),
                       acc0.numel() * acc0.element_size() + rows * 4
                       + d0.numel() * 4), library_ms=None)
        r = recs["crt_external_product"]
        r["ms"] = cuda_ms(lambda: fn.crt_external_product(
            d0, sv, ss, primes, kp1), 10)
        r["plain_ms"] = cuda_ms(lambda: fn.crt_external_product_plain(
            d0, sv, ss, primes, kp1), 3)
        cin = levels * kp1
        work = {**ntt_work(batch * n_p * cin, n),
                **ntt_work(batch * n_p * kp1, n, inverse=True),
                "mul_add": batch * n_p * cin * kp1 * n}
        ops_ms, detail = pipe_ms(work, mix, clock)
        r.update(bound(ops_ms, (d0.numel() + 2 * sv.numel() + res0.numel())
                       * 4, work=work, **detail), library_ms=None)
        r = recs["garner_accumulate"]
        scratch = acc0.clone()
        r["ms"] = cuda_ms(lambda: fn.garner_accumulate(
            res0, scratch, primes, trunc_bits), 50)
        r["plain_ms"] = cuda_ms(lambda: fn.garner_accumulate_plain(
            res0, scratch, primes, trunc_bits), 5)
        r.update(bound(tally_ms(rows * n * (n_p * OPS_GARNER_PRIME
                                            + OPS_GARNER), clock),
                       res0.numel() * 4 + 2 * acc0.numel()
                       * acc0.element_size()), library_ms=None)
    print(f"CRT-NTT step kernels bit-exact over {steps} steps at {shape}: "
          f"{recs}", flush=True)
    return recs


def fused_latency_args(a_t, acc, fbsk, *, primes, trunc_bits, base_log,
                       levels):
    """The C arguments of blind_rotate_fused_latency (and of its variant
    builds) for these operands, as ops/fused_latency.py passes them."""
    import torch
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import fused_ntt as fn
    from concrete_tpu_torch.ops import ntt as tn
    batch, kp1, n = acc.shape
    keep = (tn.pair_tables(n, primes, acc.device),
            tn.prime_constants(n, primes, acc.device),
            fn.garner_constants(primes, trunc_bits, acc.device))
    return keep, (a_t.data_ptr(), acc.data_ptr(), fbsk.spec_val.data_ptr(),
                  fbsk.spec_sh.data_ptr(), *(t.data_ptr() for t in keep),
                  batch, a_t.shape[1], kp1, levels, base_log, len(primes),
                  n.bit_length() - 1, trunc_bits,
                  int(acc.dtype == torch.int32), _build.stream_of(acc))


FUSED_LATENCY_PHASES = ("digits, forward transforms, spectra stored",
                        "spectra barrier", "key wait", "multiply-add",
                        "inverse, residues stored", "residues barrier",
                        "Garner")


def variant_builds(out_dir: str, source: str, entry: str, switches: dict):
    """Start nvcc on a persistent kernel's `source` without each of its
    parts (`switches`: label -> ABLATE_* switch) and on its PHASE_CLOCKS
    build, into out_dir; the returned function waits for them and gives
    (variants, clocks): label -> C entry point `entry`, and (the clocks
    build's entry point, a function that returns and zeroes its clocks per
    phase, `entry`_phases)."""
    import ctypes
    from concrete_tpu_torch.ops import _build
    tag = entry.replace("blind_rotate", "br")
    procs = {label: build_variant(out_dir, (source,), f"{tag}_{i}", [switch])
             for i, (label, switch) in enumerate(switches.items())}
    clocks_proc = build_variant(out_dir, (source,), f"{tag}_clocks",
                                ["PHASE_CLOCKS"])

    def load():
        variants = {label: load_variant(out_dir, f"{tag}_{i}", proc, entry)[0]
                    for i, (label, proc) in enumerate(procs.items())}
        fn_c, _ = load_variant(out_dir, f"{tag}_clocks", clocks_proc, entry)
        lib = ctypes.CDLL(os.path.join(out_dir, f"{tag}_clocks.so"))

        def read():
            out = (ctypes.c_ulonglong * 8)()
            _build.check("phase clocks", getattr(lib, f"{entry}_phases")(out))
            return list(out)
        return variants, (fn_c, read)
    return load


def fused_latency_builds(out_dir: str):
    """variant_builds of the B <= 4 CRT-NTT kernel
    (FUSED_LATENCY_VARIANTS)."""
    return variant_builds(out_dir, "blind_rotate_fused_latency.cu",
                          FUSED_LATENCY, FUSED_LATENCY_VARIANTS)


def check_fused_latency(rng, *, batch, n, kp1, levels, base_log, n_primes,
                        trunc_bits, acc32, n_small, plain=True, loop=True,
                        timed=False, clock=None, mix=None, variants=None,
                        clocks=None):
    """The CRT-NTT blind rotate at B <= 4 in one launch
    (ops/fused_latency.py) against its plain version (`plain`: the
    three-kernel scan on the plain versions of kernels 1, 3 and 4) and
    against the three-kernel loop on the card (`loop`), on random switched
    masks and accumulators and a random key packed on the card, truncated
    by `trunc_bits` (at least what the primes' range needs).  Timed: ms per
    lookup (n_small steps) beside the loop's and the plain version's (the
    check's own call), and each variant build's in `variants` (label ->
    its C entry point, the same arguments); with `clocks`
    (variant_builds), the clocks of each part of a step in block 0
    of the first cluster; the bound: the key's spectra
    and companions read once (the B clusters read one key) and the
    accumulator in and out, against the transforms', multiply-adds' (per
    pipe, from the probes' SASS), digits' and Garner's instructions."""
    import math
    import numpy as np
    import torch
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import fused_latency as fl
    from concrete_tpu_torch.ops import fused_ntt as fn
    primes = host.special_ntt_primes(n, 128)[:n_primes]
    params = fused_params(n, levels, base_log, n_small, kp1)
    t_min = max(0, host.required_bits(params, 0)
                - (math.prod(primes).bit_length() - 1))
    shape = (f"B={batch} N={n} k+1={kp1} l={levels} base_log={base_log} "
             f"P={n_primes} t={trunc_bits} steps={n_small} "
             f"{'acc32' if acc32 else 'full'}")
    if trunc_bits < t_min:
        fail(f"{shape}: {n_primes} primes need t >= {t_min}")
    bsk = rng.integers(0, 1 << 64, (n_small, levels, kp1, kp1, n),
                       dtype=np.uint64)
    fbsk = fn.pack_bsk_fused(bsk, params, primes=primes,
                             trunc_bits=trunc_bits, device="cuda")
    del bsk
    a_t = torch.from_numpy(rng.integers(0, 2 * n, (batch, n_small))
                           .astype(np.int32)).cuda()
    if acc32:
        acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                            (batch, kp1, n))
                               .astype(np.int32)).cuda()
    else:
        acc = rand_torus(rng, (batch, kp1, n), "cuda")
    kw = dict(primes=primes, trunc_bits=trunc_bits, base_log=base_log,
              levels=levels)
    got = fl.blind_rotate_fused_latency(a_t, acc.clone(), fbsk.spec_val,
                                        fbsk.spec_sh, **kw)
    rec = {}
    if plain:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fl.blind_rotate_fused_latency_plain(
            a_t, acc, fbsk.spec_val, fbsk.spec_sh, **kw)
        end.record()
        end.synchronize()
        if not torch.equal(got, want):
            fail(f"{FUSED_LATENCY} differs from its plain version at "
                 f"{shape}")
        rec.update(max_abs_err=max_abs_err(got, want),
                   plain_ms=start.elapsed_time(end))
    if loop:
        steps = fn.scan_steps(a_t, acc.clone(), fbsk)
        torch.cuda.synchronize()
        if not torch.equal(got, steps):
            fail(f"{FUSED_LATENCY} differs from the three-kernel loop on "
                 f"the card at {shape}")
        rec.setdefault("max_abs_err", max_abs_err(got, steps))
    if timed:
        pl = fl.plan(batch, n, kp1, levels, n_primes, acc32)
        scratch = acc.clone()     # updated in place by every timed call
        rec["ms"] = cuda_ms(lambda: fl.blind_rotate_fused_latency(
            a_t, scratch, fbsk.spec_val, fbsk.spec_sh, **kw), 5)
        if loop:
            rec["loop_ms"] = cuda_ms(lambda: fn.scan_steps(a_t, scratch,
                                                           fbsk), 2)
        keep, args = fused_latency_args(a_t, scratch, fbsk, **kw)
        rec["variants_ms"] = {}
        for label, fn_v in (variants or {}).items():
            def call(fn_v=fn_v, label=label):
                _build.check(label, fn_v(*args))
            rec["variants_ms"][label] = cuda_ms(call, 5)
        if clocks:
            fn_c, read = clocks
            read()
            _build.check("phase clocks", fn_c(*args))
            torch.cuda.synchronize()
            rec["clocks_per_step"] = dict(zip(
                FUSED_LATENCY_PHASES,
                (c / n_small for c in read()[1:8])))
        cin = levels * kp1
        per = batch * n_small * n_primes
        work = {**ntt_work(per * cin, n), **ntt_work(per * kp1, n, True),
                "mul_add": per * cin * kp1 * n,
                # kernel 1's digits and kernel 4's Garner, as their tallies
                "tally": batch * n_small * kp1 * n * (
                    10 + 6 * levels + n_primes * OPS_GARNER_PRIME
                    + OPS_GARNER)}
        ops_ms, detail = pipe_ms(work, {**mix, "tally": {"alu": 1.0}}, clock)
        nbytes = 8 * fbsk.spec_val.numel() + a_t.numel() * 4 \
            + 2 * acc.numel() * acc.element_size()
        rec.update(bound(ops_ms, nbytes, work=work, **detail),
                   library_ms=None, cluster=pl.cluster, threads=pl.threads,
                   smem=pl.smem)
    against = [what for what, on in (
        ("its plain version", plain),
        ("the three-kernel loop on the card", loop)) if on]
    print(f"{FUSED_LATENCY} bit-exact (against {' and '.join(against)}) at "
          f"{shape}: {rec}", flush=True)
    return rec


def fused_latency_phase(rng, clock, mix, variants, clocks):
    """The CRT-NTT blind rotate at B <= 4 in one launch: at each model
    shape of FUSED_LATENCY_SHAPES, B = 1 and 4 in both accumulator modes
    over a few steps (an odd and an even count) against its plain version
    and the three-kernel loop; then over the whole lookup's n_small steps
    at B = 1 (Levenshtein's also against its plain version, and at B = 4)
    against the loop, timed with the variant builds and counted by the
    instrumented one (`clocks`, variant_builds); the MLP's shape
    refused by the rule.  Kernels 1, 3 and 4 are timed at Levenshtein's
    B = 1 shape for the loop's share."""
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import fused_latency as fl
    recs = {}
    for name, (n, kp1, levels, base_log, n_p, t, n_small) in \
            FUSED_LATENCY_SHAPES.items():
        kw = dict(n=n, kp1=kp1, levels=levels, base_log=base_log,
                  n_primes=n_p, trunc_bits=t)
        for batch, steps in ((1, 5), (4, 4)):
            for acc32 in (True, False):
                check_fused_latency(rng, batch=batch, acc32=acc32,
                                    n_small=steps, **kw)
        recs[name] = check_fused_latency(
            rng, batch=1, acc32=True, n_small=n_small,
            plain=name == "levenshtein", timed=True, clock=clock, mix=mix,
            variants=variants, clocks=clocks, **kw)
    n, kp1, levels, base_log, n_p, t, n_small = \
        FUSED_LATENCY_SHAPES["levenshtein"]
    recs["levenshtein_b4"] = check_fused_latency(
        rng, batch=4, n=n, kp1=kp1, levels=levels, base_log=base_log,
        n_primes=n_p, trunc_bits=t, acc32=True, n_small=n_small,
        plain=False, timed=True, clock=clock, mix=mix, variants=variants,
        clocks=clocks)
    recs["loop_kernels_b1"] = check_fused_steps(
        rng, batch=1, n=n, levels=levels, base_log=base_log,
        primes=host.special_ntt_primes(n, 128)[:n_p], trunc_bits=t,
        acc32=True, steps=3, kp1=kp1, clock=clock, mix=mix, timed=True)
    n, kp1, levels, base_log, n_p, t, n_small = MLP_FUSED_SHAPE
    if fl.plan(1, n, kp1, levels, n_p, True) is not None:
        fail("the rule of ops/fused_latency.py takes the MLP's shape; "
             "check it on the card")
    print(f"{FUSED_LATENCY}: the rule refuses the MLP's shape (N={n}, "
          f"k+1={kp1}, l={levels}, {n_p} primes): its key ring of two steps "
          f"is {2 * 2 * levels * kp1 * n * 4} bytes", flush=True)
    recs["ptxas"] = [line for line in ptxas_summary(_build.BUILD_INFO["log"])
                     if FUSED_LATENCY in line]
    for name in ("levenshtein", "levenshtein_b4", "kvdb_16", "kvdb_2"):
        r = recs[name]
        print(f"{FUSED_LATENCY} per lookup at {name}: {r['ms']:.4f} ms "
              f"(cluster of {r['cluster']}, {r['threads']} + 32 threads, "
              f"{r['smem']} bytes of shared memory), the three-kernel loop "
              f"{r['loop_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), without each part "
              f"{ {k: round(v, 4) for k, v in r['variants_ms'].items()} }; "
              f"clocks a step by part "
              f"{ {k: round(v) for k, v in r['clocks_per_step'].items()} }",
              flush=True)
    print(f"{FUSED_LATENCY} ptxas: {recs['ptxas']}", flush=True)
    return recs


def check_crt_scan(rng, *, batch, n, levels, base_log, n_primes, trunc_bits,
                   acc32, n_small, plain_steps=4, timed=False, clock=None,
                   mix=None):
    """The CRT-NTT blind rotate of a batch in one launch (ops/crt_scan.py)
    over `n_small` steps of a random key packed on the card, against the
    three-kernel loop on the card, and over its first `plain_steps` steps
    against its plain version (the three-kernel scan on the plain versions
    of kernels 1, 3 and 4); k+1 = 2.  Timed: ms per lookup (n_small steps)
    beside the loop's, the plain version's ms a step, and the bound: the
    key's spectra and companions read once and the accumulator in and out,
    against the transforms', multiply-adds' (per pipe, from the probes'
    SASS), digits' and Garner's instructions."""
    import math
    import numpy as np
    import torch
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import crt_scan as cs
    from concrete_tpu_torch.ops import fused_ntt as fn
    kp1 = 2
    primes = host.special_ntt_primes(n, 128)[:n_primes]
    params = fused_params(n, levels, base_log, n_small, kp1)
    t_min = max(0, host.required_bits(params, 0)
                - (math.prod(primes).bit_length() - 1))
    shape = (f"B={batch} N={n} l={levels} base_log={base_log} P={n_primes} "
             f"t={trunc_bits} steps={n_small} {'acc32' if acc32 else 'full'}")
    if trunc_bits < t_min:
        fail(f"{shape}: {n_primes} primes need t >= {t_min}")
    form = fn.blind_rotate_form(batch, n, kp1, levels, n_primes, acc32)
    if form != "crt_ntt_scan":
        fail(f"{CRT_SCAN}: the rule gives {form} at {shape}")
    bsk = rng.integers(0, 1 << 64, (n_small, levels, kp1, kp1, n),
                       dtype=np.uint64)
    fbsk = fn.pack_bsk_fused(bsk, params, primes=primes,
                             trunc_bits=trunc_bits, device="cuda")
    del bsk
    a_t = torch.from_numpy(rng.integers(0, 2 * n, (batch, n_small))
                           .astype(np.int32)).cuda()
    if acc32:
        acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                            (batch, kp1, n))
                               .astype(np.int32)).cuda()
    else:
        acc = rand_torus(rng, (batch, kp1, n), "cuda")
    kw = dict(primes=primes, trunc_bits=trunc_bits, base_log=base_log,
              levels=levels)
    before = _build.LAUNCHES[CRT_SCAN]
    got = cs.blind_rotate_crt_scan(a_t, acc.clone(), fbsk.spec_val,
                                   fbsk.spec_sh, **kw)
    if _build.LAUNCHES[CRT_SCAN] != before + 1:
        fail(f"{CRT_SCAN} counted {_build.LAUNCHES[CRT_SCAN] - before} "
             f"launches for one call")
    steps = fn.scan_steps(a_t, acc.clone(), fbsk)
    torch.cuda.synchronize()
    if not torch.equal(got, steps):
        fail(f"{CRT_SCAN} differs from the three-kernel loop on the card at "
             f"{shape}")
    k = min(plain_steps, n_small)
    part = (a_t[:, :k].contiguous(), acc, fbsk.spec_val[:k],
            fbsk.spec_sh[:k])
    short = cs.blind_rotate_crt_scan(part[0], acc.clone(), *part[2:], **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cs.blind_rotate_crt_scan_plain(*part, **kw)
    end.record()
    end.synchronize()
    if not torch.equal(short, want):
        fail(f"{CRT_SCAN} differs from its plain version over {k} steps at "
             f"{shape}")
    # the plain version's ms a lookup, from its first k steps
    plain_ms_a_step = start.elapsed_time(end) / k
    rec = {"max_abs_err": max_abs_err(got, steps),
           "plain_ms_a_step": plain_ms_a_step,
           "plain_ms": plain_ms_a_step * n_small}
    if timed:
        pl = cs.plan(batch, n, kp1, levels, n_primes, acc32)
        scratch = acc.clone()     # updated in place by every timed call
        rec["ms"] = cuda_ms(lambda: cs.blind_rotate_crt_scan(
            a_t, scratch, fbsk.spec_val, fbsk.spec_sh, **kw), 3)
        rec["loop_ms"] = cuda_ms(lambda: fn.scan_steps(a_t, scratch, fbsk),
                                 2)
        cin = levels * kp1
        per = batch * n_small * n_primes
        work = {**ntt_work(per * cin, n), **ntt_work(per * kp1, n, True),
                "mul_add": per * cin * kp1 * n,
                # the digits (every prime's block) and the Garner (once)
                "tally": batch * n_small * kp1 * n * (
                    n_primes * (10 + 6 * levels)
                    + n_primes * OPS_GARNER_PRIME + OPS_GARNER)}
        ops_ms, detail = pipe_ms(work, {**mix, "tally": {"alu": 1.0}}, clock)
        nbytes = 8 * fbsk.spec_val.numel() + a_t.numel() * 4 \
            + 2 * acc.numel() * acc.element_size()
        rec.update(bound(ops_ms, nbytes, work=work, **detail),
                   library_ms=None, threads=pl.threads, smem=pl.smem,
                   ms_a_step=rec["ms"] / n_small,
                   loop_ms_a_step=rec["loop_ms"] / n_small)
    print(f"{CRT_SCAN} bit-exact (against the three-kernel loop on the "
          f"card, and over {k} steps its plain version) at {shape}: {rec}",
          flush=True)
    return rec


def crt_scan_phase(rng, clock, mix):
    """The CRT-NTT blind rotate of a batch in one launch at every shape of
    CRT_SCAN_SHAPES, timed against the three-kernel loop; then a few steps
    at the key-value query's shape in the u64 mode and on 2 primes, and at
    a batch of 300 (no multiple of a wave); the rule's refusals (k+1 = 3,
    N = 1024, 4096, 8192 and 16384, 4 primes)."""
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops import crt_scan as cs
    recs = {}
    for name, (batch, n, levels, base_log, n_p, t, n_small) in \
            CRT_SCAN_SHAPES.items():
        recs[name] = check_crt_scan(
            rng, batch=batch, n=n, levels=levels, base_log=base_log,
            n_primes=n_p, trunc_bits=t, acc32=True, n_small=n_small,
            timed=True, clock=clock, mix=mix)
    for batch, levels, base_log, n_p, t, acc32 in (
            (300, 1, 23, 3, 9, True), (37, 2, 16, 3, 9, False),
            (37, 1, 23, 2, 40, True)):
        check_crt_scan(rng, batch=batch, n=2048, levels=levels,
                       base_log=base_log, n_primes=n_p, trunc_bits=t,
                       acc32=acc32, n_small=9)
    for shape in ((256, 2048, 3, 1, 3, True), (256, 1024, 2, 2, 3, True),
                  (128, 16384, 2, 2, 3, True), (256, 4096, 2, 2, 3, True),
                  (100, 8192, 2, 2, 3, True), (256, 2048, 2, 1, 4, True)):
        if cs.plan(*shape) is not None:
            fail(f"the rule of ops/crt_scan.py takes {shape}")
    recs["ptxas"] = [line for line in ptxas_summary(_build.BUILD_INFO["log"])
                     if "crt_external_product_kernel_scan" in line]
    for name in CRT_SCAN_SHAPES:
        r = recs[name]
        print(f"{CRT_SCAN} at {name}: {r['ms']:.4f} ms a blind rotate "
              f"({r['ms_a_step']:.5f} a step; {r['threads']} threads, "
              f"{r['smem']} bytes of shared memory a block), the "
              f"three-kernel loop {r['loop_ms']:.4f} ms "
              f"({r['loop_ms_a_step']:.5f} a step), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms_a_step']:.3f} ms a step", flush=True)
    print(f"{CRT_SCAN} ptxas: {recs['ptxas']}", flush=True)
    return recs


NTT_EDGES = [-(1 << 63), (1 << 63) - 1, -1, 0, 1, -(1 << 32), (1 << 32) - 1,
             1 << 32]


def ntt_inputs(rng, polys, n):
    """Signed 64-bit coefficients over their whole range on the card, the
    edge values first."""
    import torch
    x = rand_torus(rng, (polys, n), "cuda")
    k = min(len(NTT_EDGES), x.numel())
    x.view(-1)[:k] = torch.tensor(NTT_EDGES[:k], dtype=torch.int64)
    return x


def check_ntt(rng, *, polys, n, primes, clock=None, mix=None, timed=False,
              inverse_polys=512):
    """Kernel 2's standalone forward transform (int64 inputs, edge values
    included, every prime per block) and its inverse on those spectra,
    each bit-exact against its plain version; timed, the forward at this
    shape and the inverse on the first `inverse_polys` polynomials."""
    import torch
    from concrete_tpu_torch.ops import ntt as tn
    x = ntt_inputs(rng, polys, n)
    got = tn.ntt_forward(x, primes)
    want = tn.ntt_forward_plain(x, primes)
    back = tn.ntt_inverse(got, primes)
    back_p = tn.ntt_inverse_plain(got, primes)
    torch.cuda.synchronize()
    shape = f"M={polys} N={n} primes={tuple(primes)}"
    if not torch.equal(got, want):
        fail(f"ntt_forward differs from its plain version at {shape}")
    if not torch.equal(back, back_p):
        fail(f"ntt_inverse differs from its plain version at {shape}")
    fwd = {"max_abs_err": max_abs_err(got, want)}
    inv = {"max_abs_err": max_abs_err(back, back_p)}
    if timed:
        fwd["ms"] = cuda_ms(lambda: tn.ntt_forward(x, primes), 5)
        fwd["plain_ms"] = cuda_ms(lambda: tn.ntt_forward_plain(x, primes), 1)
        work = ntt_work(polys * len(primes), n)
        ops_ms, detail = pipe_ms(work, mix, clock)
        fwd.update(bound(ops_ms, x.numel() * 8 + got.numel() * 4,
                         work=work, **detail), library_ms=None)
        spec = got[:, :inverse_polys].contiguous()
        inv["ms"] = cuda_ms(lambda: tn.ntt_inverse(spec, primes), 20)
        inv["plain_ms"] = cuda_ms(lambda: tn.ntt_inverse_plain(spec,
                                                               primes), 3)
        work = ntt_work(spec.shape[0] * spec.shape[1], n, inverse=True)
        ops_ms, detail = pipe_ms(work, mix, clock)
        inv.update(bound(ops_ms, spec.numel() * 8, work=work, **detail),
                   library_ms=None, shape=list(spec.shape))
    print(f"ntt_forward / ntt_inverse bit-exact at {shape}: {fwd} {inv}",
          flush=True)
    return fwd, inv


def check_ntt_pack(rng, *, n_small, rows, n, primes, trunc_bits, clock=None,
                   mix=None, timed=False):
    """Kernel 2's pack entry (the key's polynomials >> t in the kernel,
    spectra and Shoup companions stored in the FusedBSK layout) against
    its plain version (the plain transform, the rows moved, companions by
    integer division), both arrays bit-exact; timed at this shape."""
    import torch
    from concrete_tpu_torch.ops import ntt as tn
    x = ntt_inputs(rng, n_small * rows, n)
    val, sh = tn.ntt_forward_pack(x, primes, rows, trunc_bits)
    val_p, sh_p = tn.ntt_forward_pack_plain(x, primes, rows, trunc_bits)
    torch.cuda.synchronize()
    shape = (f"n_small={n_small} rows={rows} N={n} P={len(primes)} "
             f"t={trunc_bits}")
    if not (torch.equal(val, val_p) and torch.equal(sh, sh_p)):
        fail(f"ntt_forward_pack differs from its plain version at {shape}")
    rec = {"max_abs_err": max(max_abs_err(val, val_p),
                              max_abs_err(sh, sh_p))}
    if timed:
        rec["ms"] = cuda_ms(lambda: tn.ntt_forward_pack(
            x, primes, rows, trunc_bits), 5)
        rec["plain_ms"] = cuda_ms(lambda: tn.ntt_forward_pack_plain(
            x, primes, rows, trunc_bits), 1)
        # the companions' few instructions per output are not charged
        work = ntt_work(n_small * rows * len(primes), n)
        ops_ms, detail = pipe_ms(work, mix, clock)
        rec.update(bound(ops_ms, x.numel() * 8 + 2 * val.numel() * 4,
                         work=work, **detail), library_ms=None)
    print(f"ntt_forward_pack bit-exact at {shape}: {rec}", flush=True)
    return rec


def pack_parts(ev, params, bsk):
    """The MLP key pack again, part by part on the host clock, each part
    synchronised: pack_ksk (the KSK's upload and limb split on the card), the
    BSK's upload, kernel 2's pack entry; and its FusedBSK held equal, in
    both arrays, to the one built by the plain version (the plain
    transform, host-side companions by integer division)."""
    import numpy as np
    import torch
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.ops import ntt as tn
    dev = bsk.device
    parts = {}
    t0 = time.perf_counter()
    kn.pack_ksk(ev.ksk, params, device=dev)
    torch.cuda.synchronize()
    parts["pack_ksk_s"] = time.perf_counter() - t0
    n_small, levels, kp1, _, n = ev.bsk.shape
    t0 = time.perf_counter()
    raw = torch.from_numpy(np.ascontiguousarray(ev.bsk, dtype=np.uint64)
                           .view(np.int64)).to(dev).view(-1, n)
    torch.cuda.synchronize()
    parts["bsk_upload_s"] = time.perf_counter() - t0
    rows = levels * kp1 * kp1
    t0 = time.perf_counter()
    tn.ntt_forward_pack(raw, bsk.primes, rows, bsk.trunc_bits)
    torch.cuda.synchronize()
    parts["pack_kernel_s"] = time.perf_counter() - t0
    parts["parts_total_s"] = sum(parts.values())
    val_p, sh_p = tn.ntt_forward_pack_plain(raw, bsk.primes, rows,
                                            bsk.trunc_bits)
    if not (torch.equal(bsk.spec_val, val_p)
            and torch.equal(bsk.spec_sh, sh_p)):
        fail("the MLP's FusedBSK differs from the one built by the plain "
             "transform with host companions")
    return parts


def serve_mlp(rng):
    """The slice's main path: the QuantizedMLP archive's key pack on the
    device and three requests of 64 samples (256 lookups each)."""
    import numpy as np
    import torch
    import concrete_tpu_torch as tfhe
    from concrete_tpu_torch.ops import _build
    from concrete_tpu_torch.ops.fused_ntt import FusedBSK, acc32_eligible
    t0 = time.perf_counter()
    server = tfhe.Server.load(MLP_FIXTURE)
    load_s = time.perf_counter() - t0
    if server.device.type != "cuda":
        fail(f"Server.load defaulted to {server.device}")
    specs = server.client_specs
    p = specs.params
    print(f"archive: {os.path.basename(MLP_FIXTURE)} params={p} "
          f"message_bits={specs.message_bits}", flush=True)
    client = tfhe.Client(specs)
    t0 = time.perf_counter()
    client.keygen(seed=SEED)
    keygen_s = time.perf_counter() - t0
    ev = client.evaluation_keys
    shape = tuple(specs.inputs[0].shape)
    lookups = sum(int(np.prod(node.output.shape))
                  for node in server.graph.topological_order()
                  if node.name in ("tlu", "univariate"))
    samples = [rng.integers(0, 4, shape) for _ in range(REQUESTS)]
    encrypted = [client.encrypt(x) for x in samples]
    _build.reset_launches()               # the MLP path's run starts here
    t0 = time.perf_counter()
    ksk, bsk = ev.packed(specs.message_bits, norm2=server.graph.max_norm2(),
                         device=server.device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    pack_launches = dict(_build.LAUNCHES)
    if not isinstance(bsk, FusedBSK) \
            or pack_launches != {"ntt_forward_pack": 1}:
        fail(f"the key pack gave {type(bsk).__name__} with launches "
             f"{pack_launches}, want a FusedBSK from one ntt_forward_pack")
    print(f"load {load_s:.3f} s, keygen {keygen_s:.2f} s, device pack "
          f"{pack_s:.3f} s (primes {bsk.primes}, trunc_bits "
          f"{bsk.trunc_bits}, acc32 {acc32_eligible(bsk)}), launches "
          f"{pack_launches}", flush=True)
    walls, per_request, wrong, values = [], [], 0, 0
    for i, (x, cx) in enumerate(zip(samples, encrypted)):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        (out,) = server.run(cx, evaluation_keys=ev)
        walls.append(time.perf_counter() - t0)
        counts = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                  if v - before.get(k, 0)}
        per_request.append(counts)
        want = np.asarray(server.graph(x))
        if out.shape != want.shape + (p.n_big + 1,) or out.dtype != np.uint64:
            fail(f"output ciphertexts {out.shape} {out.dtype}")
        got = client.decrypt(out)
        wrong += int(np.count_nonzero(got != want))
        values += want.size
        print(f"MLP request {i}: {shape[0]} samples ({lookups} lookups) in "
              f"{walls[-1]:.3f} s = {lookups / walls[-1]:.1f} PBS/s, "
              f"launches {counts}", flush=True)
        form, want = br_form(bsk, p, lookups)
        for name, n in want.items():
            if counts.get(name) != n:
                fail(f"MLP request {i} launched {name} {counts.get(name)} "
                     f"times, want {n} (the {form})")
    launches = dict(_build.LAUNCHES)       # ... and ends here
    parts = pack_parts(ev, p, bsk)
    print(f"MLP key pack by part (again, each part synchronised): "
          f"{parts}; FusedBSK equal to the plain-built one; the pack on "
          f"the main path took {pack_s:.3f} s", flush=True)
    allowed = max(2, 1e-3 * values)
    print(f"MLP decryptions differing from the graph's clear evaluation: "
          f"{wrong} of {values} (allowed {allowed})", flush=True)
    if wrong > allowed:
        fail(f"{wrong} MLP outputs differ from the clear evaluation")
    return {"walls_s": walls, "wrong": wrong, "values": values,
            "lookups_per_request": lookups, "load_s": load_s,
            "keygen_s": keygen_s, "pack_s": pack_s, "pack_parts": parts,
            "n_small": p.n_small,
            "launches": launches, "pack_launches": pack_launches,
            "per_request": per_request, "primes": list(bsk.primes),
            "trunc_bits": bsk.trunc_bits, "acc32": acc32_eligible(bsk),
            "keys": (client, ksk, bsk, p)}


def direct_lookups(rng, client, ksk, bsk, params):
    """1024 lookups through pbs_batch with the archive's parameters and the
    client's keys, on 6-bit inputs: outputs that vary.  These parameters
    were chosen for the MLP, whose lookup outputs are decoded at 1 bit, so
    a blind rotate's output noise (std sqrt(v_br)) is far too large for a
    6-bit output.  Two tables, on the same ciphertexts:

    - (3v + 1) % 64, decoded at 6 bits: the wrong count must lie within
      4 sigma of the noise model's binomial expectation for a 6-bit decode
      of a blind-rotate output (a broken blind rotate would miss nearly
      every lookup);
    - ((3v + 1) % 64) >> 3, decoded at 3 bits (the MLP's use: a 6-bit index,
      a narrow output): at most max(2, 1e-3 x lookups) wrong."""
    import math
    import numpy as np
    import torch
    from concrete_tpu_torch import params as pp
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.core import keygen as kg
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import _build
    bits = 6
    sk = client.keys.secret.lwe_big
    msgs = rng.integers(0, 1 << bits, DIRECT_LOOKUPS)
    ct = kg.encrypt_lwe_batch(rng, sk, ref.encode(msgs, bits),
                              params.glwe_std)
    ct_t = torch.from_numpy(ct.view(np.int64)).cuda()
    v_br = pp.variance_blind_rotate(
        params.n_small, params.glwe_dimension, params.polynomial_size,
        params.pbs_base_log, params.pbs_level, params.glwe_std ** 2,
        params.q_log)
    out_rec = {}
    for name, table, out_bits in (
            ("6bit", DIRECT_TABLE, bits),
            ("3bit", [v >> 3 for v in DIRECT_TABLE], 3)):
        lut = ref.encode_expand_lut(np.array(table, dtype=np.uint64),
                                    params.polynomial_size, bits,
                                    out_bits=out_bits)
        lut_t = torch.from_numpy(lut.view(np.int64)).cuda()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = kn.pbs_batch(ct_t, ksk, bsk, lut_t, params, bits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v - before.get(k, 0)
                  for k, v in _build.LAUNCHES.items() if v - before.get(k, 0)}
        dec = ref.decode(ref.lwe_decrypt(
            sk, out.cpu().numpy().view(np.uint64)), out_bits)
        wrong = int(np.count_nonzero(dec != np.array(table)[msgs]))
        distinct = len(set(dec.tolist()))
        p_out = pp.p_error_from_variance(v_br, out_bits)
        expected = DIRECT_LOOKUPS * p_out
        spread = 4 * math.sqrt(DIRECT_LOOKUPS * p_out * (1 - p_out))
        if out_bits == bits:
            lo, hi = max(0.0, expected - spread), expected + spread
        else:
            lo, hi = 0.0, max(2, 1e-3 * DIRECT_LOOKUPS)
        print(f"direct lookups, {name} output: {DIRECT_LOOKUPS} in "
              f"{wall:.3f} s = {DIRECT_LOOKUPS / wall:.1f} PBS/s, {distinct} "
              f"distinct outputs, wrong {wrong} (noise model expects "
              f"{expected:.1f}; allowed {lo:.1f}..{hi:.1f}), launches "
              f"{counts}", flush=True)
        if not lo <= wrong <= hi or distinct < (1 << out_bits):
            fail(f"direct lookups, {name} output: {wrong} wrong of "
                 f"{DIRECT_LOOKUPS}, {distinct} distinct outputs")
        for kernel, n in br_form(bsk, params, DIRECT_LOOKUPS)[1].items():
            if counts.get(kernel) != n:
                fail(f"the direct lookups launched {kernel} "
                     f"{counts.get(kernel)} times, want {n}")
        out_rec[name] = {"wall_s": wall, "wrong": wrong,
                         "expected_wrong": expected, "distinct": distinct,
                         "launches": counts}
    return {"lookups": DIRECT_LOOKUPS, "v_br_std": math.sqrt(v_br),
            **out_rec}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    try:
        import concrete_tpu_torch
        from concrete_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if not os.path.abspath(concrete_tpu_torch.__file__).startswith(HERE):
        fail("concrete_tpu_torch was not found next to this script")
    import numpy as np

    import shutil
    import tempfile
    from concrete_tpu_torch.utils.csprng import BUILD_DIR
    os.makedirs(BUILD_DIR, exist_ok=True)
    var_dir = tempfile.mkdtemp(dir=BUILD_DIR)
    t_main = t0 = time.perf_counter()
    marks = {}              # seconds since the start at each phase's end

    def mark(label):
        marks[label] = round(time.perf_counter() - t_main, 1)
    _build.library()
    per_source = {k: round(v, 1)
                  for k, v in _build.BUILD_INFO["source_seconds"].items()}
    print(f"build: {time.perf_counter() - t0:.1f} s; nvcc seconds per "
          f"source, all started together: {per_source}", flush=True)
    # then, while the first checks run, the persistent latency kernel
    # without its MMA (its chain floor) and without its key rows, and its
    # PHASE_CLOCKS build, and the B <= 4 CRT-NTT kernel's variants: after
    # the library, so that at most one set of nvcc processes shares the
    # host's memory at a time
    br_builds = variant_builds(var_dir, "blind_rotate_latency.cu",
                               "blind_rotate_latency", LATENCY_VARIANTS)
    fl_builds = fused_latency_builds(var_dir)
    for line in ptxas_summary(_build.BUILD_INFO["log"]):
        print("  ptxas:", line, flush=True)
    card_line = card()
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    rng = np.random.default_rng(SEED)
    # slice shapes: 1024 ciphertexts x (k+1)=2 rows, N=1024, l=4, base 2^5
    rec_a = check_rotate_decompose(rng, rows=2048, n=1024, base_log=5,
                                   levels=4, a_limbs=1, timed=True)
    check_rotate_decompose(rng, rows=64, n=256, base_log=12, levels=2,
                           a_limbs=2, timed=False)
    # two digit limbs, three levels, a small batch: the CRT-like shapes at
    # which the TPU's acc32 kernels failed
    check_rotate_decompose(rng, rows=6, n=512, base_log=10, levels=3,
                           a_limbs=2, timed=False)
    rec_b = check_external_product(rng, batch=1024, levels=4, kp1=2, n=1024,
                                   a_limbs=1, s_planes=4, keep=4,
                                   limb_offset=4, timed=True)
    check_external_product(rng, batch=1024, levels=4, kp1=2, n=1024,
                           a_limbs=1, s_planes=8, keep=8, limb_offset=0,
                           timed=False)
    check_external_product(rng, batch=16, levels=2, kp1=2, n=256, a_limbs=2,
                           s_planes=8, keep=8, limb_offset=0, timed=False)
    check_external_product(rng, batch=3, levels=3, kp1=2, n=512, a_limbs=2,
                           s_planes=4, keep=4, limb_offset=4, timed=False)
    # the banded form of GameOfLife(8, 8)'s 5-bit parameters (N=2048, l=2),
    # and batches that leave the last 128-ciphertext tile part empty
    check_external_product(rng, batch=200, levels=2, kp1=2, n=2048,
                           a_limbs=1, s_planes=4, keep=4, limb_offset=4,
                           timed=False)
    check_external_product(rng, batch=1000, levels=4, kp1=2, n=1024,
                           a_limbs=1, s_planes=4, keep=4, limb_offset=4,
                           timed=False)
    # N=16384 (banded, as CONCRETE_TPU_FUSED_NTT=0 forces it): the key
    # windows of 3 planes fit a block, so keep=4 takes two blocks per tile
    check_external_product(rng, batch=4, levels=1, kp1=2, n=16384,
                           a_limbs=1, s_planes=2, keep=4, limb_offset=4,
                           timed=False)
    # kernel 9 at the table step (the "pallas" mode's shape), with two
    # digit limbs, and at the latency path's (k+1 rows, Cout = B, the 4
    # kept BSK limb planes as lhs limbs, 1 digit limb)
    rec_bm = check_banded_matmul(rng, a_limbs=1, rows=1024, cin=8, cout=2,
                                 s_planes=4, n=1024, levels=4, timed=True)
    check_banded_matmul(rng, a_limbs=1, rows=1024, cin=8, cout=2,
                        s_planes=4, n=1024, timed=False)
    for levels in (None, 2):
        check_banded_matmul(rng, a_limbs=2, rows=16, cin=4, cout=2,
                            s_planes=8, n=256, levels=levels, timed=False)
    # ... and at batches that leave the last 128-row tile part empty
    check_banded_matmul(rng, a_limbs=1, rows=200, cin=8, cout=2, s_planes=4,
                        n=1024, levels=4, timed=False)
    check_banded_matmul(rng, a_limbs=1, rows=1000, cin=8, cout=2,
                        s_planes=4, n=1024, timed=False)
    # the few-row route (the latency form with vv as the band)
    rec_bm_few = check_banded_matmul(rng, a_limbs=4, rows=2, cin=8, cout=1,
                                     s_planes=1, n=1024, timed=True)
    check_banded_matmul(rng, a_limbs=4, rows=2, cin=8, cout=4, s_planes=1,
                        n=1024, timed=False)
    # kernel 9's latency form as the latency step calls it (kernel 1's
    # digits, the BSK step in place): B = 1 .. 4 at the pbs_latency_b1
    # shape (k+1 = 2, l = 4, N = 1024, 4 kept key limbs, base 2^5), k+1 = 3,
    # two digit limbs, N = 2048 (two 1024-j slices per ci) and N = 32768
    rec_bm_lat = check_banded_matmul_latency(
        rng, batch=1, kp1=2, levels=4, n=1024, s_key=4, base_log=5,
        timed=True)
    for batch in (2, 3, 4):
        check_banded_matmul_latency(rng, batch=batch, kp1=2, levels=4,
                                    n=1024, s_key=4, base_log=5, timed=False)
    check_banded_matmul_latency(rng, batch=2, kp1=3, levels=4, n=1024,
                                s_key=4, base_log=5, timed=False)
    check_banded_matmul_latency(rng, batch=3, kp1=2, levels=2, n=1024,
                                s_key=4, base_log=10, timed=False)
    check_banded_matmul_latency(rng, batch=2, kp1=2, levels=2, n=2048,
                                s_key=4, base_log=5, timed=False)
    # N = 32768, l = 4: 32 slices per block, staged in two rounds
    check_banded_matmul_latency(rng, batch=1, kp1=2, levels=4, n=32768,
                                s_key=4, base_log=5, timed=False)
    # the persistent latency blind rotate: a whole lookup's 710 steps at
    # the pbs_latency_b1 shape, B = 1 (also against its plain version) and
    # B = 4 (against the step loop on the card), timed with the chain
    # floor; then B = 1 .. 4 over a few steps against the plain version,
    # k+1 = 3 with two digit limbs, an odd step count, a full key
    variants, br_clocks = br_builds()
    lat_kw = dict(kp1=2, levels=4, n=1024, s_key=4, base_log=5,
                  limb_offset=4)
    rec_br = check_blind_rotate_latency(rng, batch=1, n_small=710,
                                        timed=True, variants=variants,
                                        clocks=br_clocks, **lat_kw)
    rec_br4 = check_blind_rotate_latency(rng, batch=4, n_small=710,
                                         timed=True, plain=False,
                                         variants=variants, **lat_kw)
    # ... and at the compiled examples/table_lookup.py's shape (610 steps
    # of k+1 = 5, N = 256, l = 3, 4 kept key limbs: a cluster of 4)
    rec_br_tl = check_blind_rotate_latency(
        rng, batch=1, kp1=5, levels=3, n=256, s_key=4, base_log=5,
        n_small=610, limb_offset=4, timed=True, variants=variants)
    # ... at GameOfLife's shape (N=2048: two 64-t groups a block; 5 key
    # limbs: a key ring of one slot) and at the latency shape's untruncated
    # key (8 limbs, one slot): B = 1 and 4 against the plain version over a
    # few steps (at N=2048 it takes seconds a step), then over a whole
    # lookup against the step loop on the card, timed
    s8_kw = {**lat_kw, "s_key": 8, "limb_offset": 0}
    for kw in (GOL_LATENCY, s8_kw):
        for batch in (1, 4):
            check_blind_rotate_latency(rng, batch=batch, n_small=3,
                                       timed=False, **kw)
    rec_gol = {batch: check_blind_rotate_latency(
        rng, batch=batch, n_small=GOL_STEPS, timed=True, plain=False,
        variants=variants, clocks=br_clocks, **GOL_LATENCY)
        for batch in (1, 4)}
    rec_s8 = {batch: check_blind_rotate_latency(
        rng, batch=batch, n_small=710, timed=True, plain=False,
        variants=variants, **s8_kw) for batch in (1, 4)}
    for batch in (1, 2, 3, 4):
        check_blind_rotate_latency(rng, batch=batch, n_small=8, timed=False,
                                   **lat_kw)
    check_blind_rotate_latency(rng, batch=2, kp1=3, levels=2, n=1024,
                               s_key=4, base_log=10, n_small=5,
                               limb_offset=4, timed=False)
    check_blind_rotate_latency(rng, batch=3, kp1=2, levels=2, n=1024,
                               s_key=8, base_log=5, n_small=3,
                               limb_offset=0, timed=False)
    rec_rc = check_recombine(rng, rows=2048, n_planes=4, n=1024,
                             limb_offset=4, timed=True)
    check_recombine(rng, rows=2048, n_planes=8, n=1024, limb_offset=0,
                    timed=False)
    # ... and at the latency step's shape (B = 1: k+1 = 2 rows)
    rec_rc_lat = check_recombine(rng, rows=2, n_planes=4, n=1024,
                                 limb_offset=4, timed=True)
    check_recombine(rng, rows=8, n_planes=4, n=1024, limb_offset=4,
                    timed=False)

    # kernel 1 on the full accumulator at the latency path's k+1 = 2 rows
    # per ciphertext, B = 1 and 4, N=1024, l=4, base 2^5
    clock = sm_clock()
    rec_d_lat = check_digits(rng, rows=2, n=1024, base_log=5, levels=4,
                             timed=True, clock=clock)
    check_digits(rng, rows=8, n=1024, base_log=5, levels=4, timed=False,
                 clock=clock)
    # the three kernels of the step loop at GameOfLife's B=1 step (k+1 = 2
    # rows, N=2048, l = 2, base 2^7, 5 key limbs: 5 planes)
    rec_gol_steps = {
        "rotate_decompose_digits": check_digits(
            rng, rows=2, n=2048, base_log=7, levels=2, timed=True,
            clock=clock),
        "banded_matmul_latency": check_banded_matmul_latency(
            rng, batch=1, kp1=2, levels=2, n=2048, s_key=5, base_log=7,
            timed=True),
        "recombine_accumulate": check_recombine(
            rng, rows=2, n_planes=5, n=2048, limb_offset=3, timed=True)}

    # the PBS prologue at tlu4's keyset (n_in 1024, ks 8 levels of base
    # 2^2, n_out 698, N=1024, k+1 = 2), timed at B = 1 and 4; GameOfLife's
    # (n_in 2048, n_out 758, N=2048), k+1 = 3 and a 64-bit decompose
    rec_pro = {batch: check_prologue(
        rng, batch=batch, n_small=698, n=1024, kp1=2, ks_level=8,
        ks_base_log=2, per_row=False, timed=batch in (1, 4))
        for batch in (1, 2, 3, 4)}
    for batch in (1, 2, 3, 4):
        check_prologue(rng, batch=batch, n_small=758, n=2048, kp1=2,
                       ks_level=8, ks_base_log=2, per_row=batch % 2 == 0,
                       timed=False)
    check_prologue(rng, batch=3, n_small=500, n=512, kp1=3, ks_level=3,
                   ks_base_log=12, per_row=True, timed=False)

    # the serve phase runs n_small steps of both kernels per request
    est_s = REQUESTS * 698 * (rec_a["ms"] + rec_b["ms"]) / 1e3
    print(f"serve estimate from the kernel times: {est_s:.1f} s", flush=True)
    if est_s > 700:
        fail(f"the kernels are too slow to serve {REQUESTS} requests within "
             f"the smoke's time limit (estimate {est_s:.0f} s)")
    mark("kernel checks")
    # the key bodies on the card against the host's keygen; from here on,
    # no key is made by the host's product
    keygen = keygen_checks(rng)
    products = host_products().__enter__()
    mark("key bodies")
    run = serve(rng)
    # ... and in "pallas" mode, n_small steps of kernels A, 9 and the
    # recombine; then one blind rotate in each of the five modes (the
    # "fuseddot" and "planes" steps are torch._int_mm, about 1 ms each)
    est_s = REQUESTS * 698 * (rec_a["ms"] + rec_bm["ms"] + rec_rc["ms"]) \
        / 1e3
    print(f"pallas-mode serve estimate from the kernel times: {est_s:.1f} s",
          flush=True)
    if est_s > 300:
        fail(f"the pallas-mode kernels are too slow to serve {REQUESTS} "
             f"requests within the smoke's time limit (estimate "
             f"{est_s:.0f} s)")
    pal = serve_pallas(run)
    server = run.pop("state")[0]
    modes = check_modes(rng, run.pop("bsk"), server.client_specs.params)
    latency = latency_lookups(rng)
    mark("serve and latency")

    # the CRT-NTT path: its kernels at the MLP archive's shapes (256
    # ciphertexts x (k+1)=2 rows, N=4096, l=2, base 2^8, its 3 primes,
    # t=0, acc32), the full accumulator, N=16384, and a truncated key
    from concrete_tpu_torch.core import ntt as host
    mix = sass_mix()
    print(f"{clock[2]}; instructions per operation by pipe, from the "
          f"probes' SASS: {mix}", flush=True)
    primes = host.special_ntt_primes(4096, 128)[:3]
    rec_f = check_fused_steps(rng, batch=256, n=4096, levels=2, base_log=8,
                              primes=primes, trunc_bits=0, acc32=True,
                              steps=3, clock=clock, mix=mix, timed=True)
    check_fused_steps(rng, batch=256, n=4096, levels=2, base_log=8,
                      primes=primes, trunc_bits=0, acc32=False, steps=2,
                      clock=clock, mix=mix, timed=False)
    for acc32 in (True, False):
        check_fused_steps(rng, batch=4, n=16384, levels=2, base_log=8,
                          primes=host.special_ntt_primes(16384, 128)[:3],
                          trunc_bits=0, acc32=acc32, steps=2, clock=clock,
                          mix=mix, timed=False)
    # one ciphertext per block, so any batch fills its blocks; an odd one,
    # and the transform sizes the smoke's paths do not reach (the kernel is
    # compiled once per N)
    for n in (1024, 2048, 4096, 8192):
        check_fused_steps(rng, batch=5, n=n, levels=2, base_log=8,
                          primes=host.special_ntt_primes(n, 128)[:3],
                          trunc_bits=0, acc32=False, steps=1, clock=clock,
                          mix=mix, timed=False)
    # k >= 2: the accumulators beyond the two in registers live in shared
    # memory; k+1 = 3 at N=2048 and at N=16384 (the most it fits there),
    # 4, and 7 (the optimizer's largest k) at N=2048 and N=8192
    for n, batch, kp1 in ((2048, 5, 3), (16384, 4, 3)):
        for acc32 in (True, False):
            check_fused_steps(rng, batch=batch, n=n, levels=2, base_log=8,
                              primes=host.special_ntt_primes(n, 128)[:3],
                              trunc_bits=0, acc32=acc32, steps=2, kp1=kp1,
                              clock=clock, mix=mix, timed=False)
    for n, batch, kp1 in ((4096, 5, 4), (2048, 3, 7), (8192, 2, 7)):
        check_fused_steps(rng, batch=batch, n=n, levels=2, base_log=8,
                          primes=host.special_ntt_primes(n, 128)[:3],
                          trunc_bits=0, acc32=False, steps=1, kp1=kp1,
                          clock=clock, mix=mix, timed=False)
    # beyond one block's shared memory, kernel 3 in groups of output
    # components: k+1 = 4 at N=16384 (two groups of two) and k+1 = 8 at
    # N=8192 (two of four), the key packed for the card
    for n, kp1 in ((16384, 4), (8192, 8)):
        check_fused_steps(rng, batch=2, n=n, levels=2, base_log=8,
                          primes=host.special_ntt_primes(n, 128)[:3],
                          trunc_bits=0, acc32=False, steps=2, kp1=kp1,
                          clock=clock, mix=mix, timed=False)
    # the 6-bit N=4096 benchmark parameters truncate their key (t > 0)
    p6 = fused_params(4096, 1, 22, 880)
    primes6, t6 = host.choose_fused_primes(p6, 6)
    if t6 <= 0:
        fail(f"expected a truncated key at {p6}, got t={t6}")
    for acc32 in (True, False):
        check_fused_steps(rng, batch=16, n=4096, levels=1, base_log=22,
                          primes=primes6, trunc_bits=t6, acc32=acc32,
                          steps=2, clock=clock, mix=mix, timed=False)
    # kernel 2: the key pack transforms every polynomial of the MLP's BSK
    # at once (822 steps x l(k+1)(k+1) = 8 polynomials), the standalone
    # transforms at that shape (the inverse timed on 512 of them); every
    # N the wrapper takes at a few polynomials (N = 4 and 8 run one thread
    # per transform, N >= 16 the register schedule), primes far below
    # 2^31, and the pack of a truncated key at every N the path packs
    rec_pack = check_ntt_pack(rng, n_small=822, rows=8, n=4096,
                              primes=primes, trunc_bits=0, clock=clock,
                              mix=mix, timed=True)
    rec_ntt, rec_inv = check_ntt(rng, polys=822 * 8, n=4096, primes=primes,
                                 clock=clock, mix=mix, timed=True)
    for log_n in range(2, 15):
        check_ntt(rng, polys=5, n=1 << log_n,
                  primes=host.special_ntt_primes(1 << log_n, 128)[:3])
    check_ntt(rng, polys=3, n=1024, primes=(12289, 40961))
    check_ntt(rng, polys=3, n=8, primes=(17, 97))
    for n in (1024, 2048, 8192, 16384):
        check_ntt_pack(rng, n_small=2, rows=8, n=n,
                       primes=host.special_ntt_primes(n, 128)[:3],
                       trunc_bits=9)

    # the CRT-NTT blind rotate at B <= 4 in one launch, at the models'
    # shapes
    rec_fl = fused_latency_phase(rng, clock, mix, *fl_builds())
    # ... and of a batch in one launch, at the batch shapes its rule takes
    rec_cs = crt_scan_phase(rng, clock, mix)
    mark("CRT-NTT checks")

    step_ms = sum(rec_f[name]["ms"] for name in FUSED_KERNELS)
    est_s = (REQUESTS + 2 * DIRECT_LOOKUPS / 256) * 822 * step_ms / 1e3
    print(f"MLP serve and direct lookups estimate from the kernel times: "
          f"{est_s:.1f} s", flush=True)
    if est_s > 500:
        fail(f"the CRT-NTT kernels are too slow to serve within the smoke's "
             f"time limit (estimate {est_s:.0f} s)")
    mlp = serve_mlp(rng)
    client, ksk, bsk, params = mlp.pop("keys")
    if tuple(bsk.primes) != tuple(primes):
        fail(f"the archive's primes {bsk.primes} are not the checked ones")
    direct = direct_lookups(rng, client, ksk, bsk, params)
    mark("MLP and direct lookups")
    compiled = compile_phase(rng)
    mark("compile")
    models = models_phase(rng)
    mark("models")
    multi = multi_phase(rng)
    mark("multi")
    module = module_phase(rng)
    mark("module")
    kinds = kinds_phase(rng)
    mark("kinds")
    keyed = wop_keyed_checks(rng, clock, mix)
    wop = wop_phase(rng)
    mark("wop")
    bigint = bigint_phase(rng)
    mark("bigint")
    bridge = tfhers_phase(rng)
    mark("tfhers")
    scheduler = scheduler_phase(rng)
    mark("scheduler")
    cli = cli_phase(rng)
    mark("cli")
    par = parallel_phase(rng)
    mark("parallel")
    products.__exit__(None, None, None)
    if products.calls or par["host_products"]:
        fail(f"the host's key-body product ran {products.calls} times in "
             f"this process and {par['host_products']} in the parallel "
             f"ranks: a key fell back from the card")
    print("the host's key-body product on the main path: 0 calls in this "
          "process and in the parallel ranks (every BSK and PFPKSK body "
          "they made computed on the card; the CLI's subprocesses are not "
          "counted)", flush=True)
    # the models, multi, module, wop, bigint, tfhers, scheduler and parallel
    # phases' own launches of the kernels that their lookups ran
    model_launches = {}
    for rec in list(models.values()) + list(multi.values()) \
            + [module, wop["pir_32"], wop["pir_64"], bigint, bridge,
               scheduler, par]:
        for k, v in rec["launches"].items():
            model_launches[k] = model_launches.get(k, 0) + v

    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    kernels = [
        {"name": "rotate_decompose", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/rotate_decompose.cu",
         "replaces": "concrete_tpu/ops/pallas_step.py:173 "
                     "(and :275, rotate_decompose_limbs_hi)",
         "launches": run["launches"].get("rotate_decompose", 0),
         **{k: rec_a[k] for k in fields}},
        {"name": "external_product_accumulate", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/external_product.cu",
         "replaces": "concrete_tpu/ops/pallas_dot_recombine.py:288 "
                     "(and :203 dot_recombine_hi; its epilogue does the "
                     "shift-add that recombine_accumulate does alone)",
         "launches": run["launches"].get("external_product_accumulate", 0),
         **{k: rec_b[k] for k in fields}},
        {"name": "banded_matmul", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/banded_mm.cu",
         "replaces": "concrete_tpu/ops/pallas_banded_mm.py:88 "
                     "banded_matmul_fused (pallas_call :117)",
         "launches": pal["launches"].get("banded_matmul", 0),
         **{k: rec_bm[k] for k in fields}},
        {"name": "banded_matmul_latency", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/banded_mm_latency.cu",
         "replaces": "concrete_tpu/ops/pallas_banded_mm.py:88 "
                     "banded_matmul_fused at the latency step's shape, with "
                     "the step's glue (concrete_tpu/core/kernels.py:752-762)",
         "launches": latency["step_loop_launches"].get(
             "banded_matmul_latency", 0),
         **{k: rec_bm_lat[k] for k in fields}},
        {"name": "blind_rotate_latency", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/blind_rotate_latency.cu",
         "replaces": "concrete_tpu/ops/pallas_step.py:322 and :385 "
                     "(rotate_decompose_digits, recombine_accumulate) at the "
                     "latency shape, with pallas_banded_mm.py:88 in its "
                     "body: the scan of concrete_tpu/core/kernels.py:710",
         "launches": latency["launches"].get("blind_rotate_latency", 0),
         **{k: rec_br[k] for k in fields}},
        {"name": "recombine_accumulate", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/recombine_accumulate.cu",
         "replaces": "concrete_tpu/ops/pallas_step.py:385 "
                     "recombine_accumulate (pallas_call :403)",
         "launches": pal["launches"].get("recombine_accumulate", 0),
         **{k: rec_rc[k] for k in fields}},
        {"name": "rotate_decompose_digits", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/rotate_decompose.cu",
         "replaces": "concrete_tpu/ops/pallas_step.py:322 (and the "
                     ":210/:234 rotate_diff_digits front of "
                     "pallas_fused_ntt.py:1223)",
         "launches": mlp["launches"].get("rotate_decompose_digits", 0),
         **{k: rec_f["rotate_decompose_digits"][k] for k in fields}},
        {"name": "ntt_forward_pack", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/ntt.cu",
         "replaces": "concrete_tpu/ops/pallas_ntt.py:374 ntt_fwd_pallas "
                     "(pallas_calls :383, :403), with the spectra's move "
                     "into the FusedBSK rows and their Shoup companions of "
                     "pallas_fused_ntt.py:504 pack_bsk_fused (the "
                     "standalone ntt_forward is the same template; "
                     "ntt_inv_pallas :417 is ntt_inverse, "
                     "csrc/ntt_inverse.cu)",
         "launches": mlp["launches"].get("ntt_forward_pack", 0),
         **{k: rec_pack[k] for k in fields}},
        {"name": "crt_external_product", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/crt_external_product.cu",
         "replaces": "concrete_tpu/ops/pallas_fused_ntt.py:1223 (the "
                     "forward NTT, spectral MAC and inverse NTT of "
                     "_step_kernel :1018)",
         "launches": mlp["launches"].get("crt_external_product", 0),
         **{k: rec_f["crt_external_product"][k] for k in fields}},
        {"name": "garner_accumulate", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/garner_accumulate.cu",
         "replaces": "concrete_tpu/ops/pallas_fused_ntt.py:1223 (the "
                     "explicit-CRT Garner and accumulate, :622)",
         "launches": mlp["launches"].get("garner_accumulate", 0),
         **{k: rec_f["garner_accumulate"][k] for k in fields}},
        {"name": KEYED, "route": "cuda",
         "source": "concrete_tpu_torch/csrc/crt_external_product_keyed.cu",
         "replaces": "concrete_tpu/ops/pallas_fused_ntt.py:1223 (kernel 3's "
                     "step, _step_kernel :1018) with a key per ciphertext: "
                     "the runtime external product that "
                     "concrete_tpu/core/kernels_wop.py:115 computes by a "
                     "grouped limb convolution",
         "launches": 0,       # its path is the wop phase's requests
         **{k: keyed["rotation"][k] for k in fields}},
        {"name": FUSED_LATENCY, "route": "cuda",
         "source": "concrete_tpu_torch/csrc/blind_rotate_fused_latency.cu",
         "replaces": "concrete_tpu/ops/pallas_fused_ntt.py:1223 "
                     "blind_rotate_fused at B <= 4 (pallas_call :1299), "
                     "with pallas_step.py:322 rotate_decompose_digits in "
                     "its body",
         "launches": 0,       # its path is the models phase's requests
         **{k: rec_fl["levenshtein"][k] for k in fields}},
        {"name": CRT_SCAN, "route": "cuda",
         "source": "concrete_tpu_torch/csrc/blind_rotate_crt_scan.cu",
         "replaces": "none alone: the batch form of "
                     "concrete_tpu/ops/pallas_fused_ntt.py:1223 "
                     "blind_rotate_fused's one-call scan (pallas_call "
                     ":1299), with pallas_step.py:322 "
                     "rotate_decompose_digits in its body; kernels 1, 3 "
                     "and 4 stay for the shapes its rule refuses",
         "launches": mlp["launches"].get(CRT_SCAN, 0),
         **{k: rec_cs["kvdb32_b2048"][k] for k in fields}},
        {"name": "pbs_prologue", "route": "cuda",
         "source": "concrete_tpu_torch/csrc/pbs_prologue.cu",
         "replaces": "none: the JAX package's keyswitch is XLA's int8 "
                     "matmul (concrete_tpu/core/kernels.py:435), its "
                     "modulus switch and LUT rotation plain XLA; added to "
                     "take the B <= 4 prologue's ~140 torch launches off "
                     "the host path",
         "launches": latency["launches"].get("pbs_prologue", 0),
         **{k: rec_pro[1][k] for k in fields}},
    ]
    for k in kernels:
        # the models phase drives the port's entry points too
        k["launches"] += model_launches.get(k["name"], 0)
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "concrete_tpu" or m.startswith("concrete_tpu.")]
    if leaked:
        fail(f"the port imported {leaked}")
    os.makedirs(OUT_DIR, exist_ok=True)
    for rec in (run, pal):
        rec.pop("outputs")
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card_line, "clocks": clock[2], "sass_mix": mix,
                   "kernels": kernels, "serve": run, "serve_pallas": pal,
                   "banded_modes_walls_s": modes, "latency": latency,
                   "serve_mlp": mlp, "direct_lookups": direct,
                   "compiled": compiled, "models": models,
                   "multi": multi, "module": module, "kinds": kinds,
                   "key_bodies": keygen,
                   "wop": wop, "wop_kernels": keyed, "bigint": bigint,
                   "tfhers": bridge, "scheduler": scheduler, "cli": cli,
                   "parallel": par,
                   "detail": {"rotate_decompose": rec_a,
                              "external_product_accumulate": rec_b,
                              "banded_matmul": rec_bm,
                              "banded_matmul_latency_b1": rec_bm_lat,
                              "blind_rotate_latency_b1": rec_br,
                              "blind_rotate_latency_b4": rec_br4,
                              "blind_rotate_latency_table_lookup":
                                  rec_br_tl,
                              "blind_rotate_latency_gol": rec_gol,
                              "blind_rotate_latency_s8": rec_s8,
                              "gol_step_loop_kernels": rec_gol_steps,
                              "banded_matmul_few_rows_b1": rec_bm_few,
                              "recombine_accumulate_latency_b1": rec_rc_lat,
                              "rotate_decompose_digits_latency_b1":
                                  rec_d_lat,
                              "recombine_accumulate": rec_rc,
                              "ntt_forward_pack": rec_pack,
                              "ntt_forward": rec_ntt, "ntt_inverse": rec_inv,
                              **rec_f, FUSED_LATENCY: rec_fl,
                              "pbs_prologue": rec_pro},
                   "phase_end_s": marks,
                   "ptxas": ptxas_summary(_build.BUILD_INFO["log"]),
                   "build_s": _build.BUILD_INFO["seconds"],
                   "build_source_s": _build.BUILD_INFO["source_seconds"]},
                  f, indent=1)
    shutil.rmtree(var_dir)
    print(f"persistent latency blind rotate per lookup (710 steps): B=1 "
          f"{rec_br['ms']:.4f} ms, B=4 {rec_br4['ms']:.4f} ms; bound "
          f"{rec_br['bound_ms']:.4f} / {rec_br4['bound_ms']:.4f} ms; chain "
          f"floor (no MMA) {rec_br['chain_floor_ms']:.4f} / "
          f"{rec_br4['chain_floor_ms']:.4f} ms; the three-kernel step loop "
          f"{rec_br['step_loop_ms']:.4f} / {rec_br4['step_loop_ms']:.4f} ms",
          flush=True)
    print(f"... at the compiled table_lookup's shape (k+1=5, N=256, l=3, "
          f"610 steps, a cluster of {rec_br_tl['cluster']}): "
          f"{rec_br_tl['ms']:.4f} ms, bound {rec_br_tl['bound_ms']:.4f} ms, "
          f"chain floor {rec_br_tl['chain_floor_ms']:.4f} ms, step loop "
          f"{rec_br_tl['step_loop_ms']:.4f} ms, plain "
          f"{rec_br_tl['plain_ms']:.1f} ms", flush=True)
    gol, g1, g4 = models["game_of_life"], rec_gol[1], rec_gol[4]
    print(f"GameOfLife{GOL_SIZE}: request {gol['wall_s']:.4f} s, traced "
          f"idle share {gol['traced']['idle_share']:.3f}, wrong "
          f"{gol['wrong']} of {gol['values']}, launches {gol['launches']}; "
          f"the persistent kernel at its shape ({GOL_STEPS} steps, "
          f"{g1['slots']} ring slot, {g1['smem']} bytes a block): B=1 "
          f"{g1['ms']:.4f} ms a lookup, B=4 {g4['ms']:.4f} ms; bound "
          f"{g1['bound_ms']:.4f} / {g4['bound_ms']:.4f} ms "
          f"({g1['bound_by']}); the step loop on the same inputs "
          f"{g1['step_loop_ms']:.4f} / {g4['step_loop_ms']:.4f} ms; without "
          f"the MMA {g1['chain_floor_ms']:.4f}, without the key rows "
          f"{g1['variants_ms']['no key rows']:.4f} ms; clocks a step "
          f"{ {k: round(v) for k, v in g1['clocks_per_step'].items()} }; "
          f"at the untruncated latency-shape key (8 limbs, "
          f"{rec_s8[1]['slots']} slot): {rec_s8[1]['ms']:.4f} / "
          f"{rec_s8[4]['ms']:.4f} ms, step loop "
          f"{rec_s8[1]['step_loop_ms']:.4f} / "
          f"{rec_s8[4]['step_loop_ms']:.4f} ms; card {card_line}",
          flush=True)
    print(f"seconds since the start at each phase's end: {marks}",
          flush=True)
    print(f"card: {card()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(*sys.argv[2:6])
    else:
        main()
