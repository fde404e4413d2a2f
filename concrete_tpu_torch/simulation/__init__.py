"""Noise-accurate plaintext simulation.

Counterpart of ``concrete_tpu/simulation/__init__.py``: the same numpy
model, on the port's graphs and ``ClientSpecs``; given the same
``np.random.default_rng`` it draws the same samples and returns the JAX
package's values.  Reference: lib/Runtime/simulation.cpp (sim_* kernels:
plaintext op + Gaussian noise drawn from the noise model) and the
SimulateTFHE pass.

Like the reference runtime, simulation carries a concrete NOISE SAMPLE
(torus units, float64) alongside every encrypted plaintext and pushes it
through the leveled ops exactly: ``x + x`` doubles the same sample (4x the
variance), broadcasts share samples, clear dots contract them with the
real weights.  Decision points (TLU indices, sign-PBS) add fresh
keyswitch/modulus-switch samples and may flip exactly as hardware does;
each bootstrap output gets a fresh blind-rotate (or WoP vertical-packing)
sample.  No keys, no crypto and no device — host numpy, fast enough for
test sweeps.

Leveled ops are affine in their encrypted operands, so their noise maps
through the op's own evaluator: ``L(n) = f(n, clears) - f(0, clears)``.
This needs no per-op noise rules and is exact for every linear lowering
(add/sub/mul-by-clear/sum/dot/matmul/conv/index/reshape/broadcast/concat/
assign).
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch import params as pp
from concrete_tpu_torch.representation import Operation

__all__ = ["simulate_graph"]

#: ops whose value passes through physically unchanged (the consumer PBS
#: implements them), so the noise sample passes through too
_PASSTHROUGH = ("round_bit_pattern", "truncate_bit_pattern", "hint")


def _sim_cache(graph) -> dict:
    """Per-graph memo for materialized simulation tables (the executor
    builds its specs once; simulation must not re-vectorize user functions
    on every simulate() call)."""
    return graph.__dict__.setdefault("_sim_table_cache", {})


def simulate_graph(graph, specs, *inputs, rng=None,
                   detect_overflow: bool = False):
    """Evaluate with simulated noise; returns outputs like the real circuit.

    detect_overflow: warn when an encrypted value exceeds its encoding
    width (the reference's detect_overflow_in_simulation: overflow wraps
    silently in FHE, so simulation is where it is catchable)."""
    import functools
    import warnings

    from concrete_tpu_torch.compilation.widths import (encoding_width,
                                                       partition_of)
    rng = rng or np.random.default_rng()
    p_default = specs.message_bits

    def check_overflow(node, value):
        if not detect_overflow or not node.output.is_encrypted:
            return
        w = encoding_width(node, p_default)
        v = np.asarray(value)
        signed = getattr(node.output.dtype, "is_signed", False)
        lo = -(1 << (w - 1)) if signed else 0
        hi = (1 << (w - 1)) - 1 if signed else (1 << w) - 1
        if v.size and (v.min() < lo or v.max() > hi):
            warnings.warn(
                f"simulation overflow at %{node.uid} [{node.name}]: "
                f"value range [{v.min()}, {v.max()}] exceeds the "
                f"{w}-bit {'signed' if signed else 'unsigned'} encoding "
                f"[{lo}, {hi}] (would wrap silently in FHE)",
                RuntimeWarning, stacklevel=3)

    @functools.lru_cache(maxsize=None)
    def stages(width):
        """(fresh, br, ks, ms, max_native_bits) of `width`'s partition —
        mono circuits resolve every width to the single keyset."""
        params = specs.params_for_width(width) \
            if hasattr(specs, "params_for_width") else specs.params
        # fresh inputs are encrypted under the BIG key at glwe_std
        # (client.py _secret_for)
        fresh = params.glwe_std ** 2
        br = pp.variance_blind_rotate(
            params.n_small, params.glwe_dimension, params.polynomial_size,
            params.pbs_base_log, params.pbs_level, params.glwe_std ** 2)
        ks = pp.variance_keyswitch(
            params.n_big, params.ks_base_log, params.ks_level,
            params.lwe_std ** 2)
        ms = pp.variance_modulus_switch(
            params.n_small, params.log2_polynomial_size)
        return fresh, br, ks, ms, min(
            8, params.polynomial_size.bit_length() - 2)

    def wop_gadgets_for(width):
        multi = getattr(specs, "partition_wop_gadgets", None)
        if multi:
            return multi.get(width)
        return getattr(specs, "wop_gadgets", None)

    def crossing_var(w_in, w_out):
        """Conversion-keyswitch variance a fresh PBS output picks up when
        it crosses the (w_in -> w_out) partition frontier."""
        conv = getattr(specs, "conversions", None)
        if not conv or w_in == w_out or (w_in, w_out) not in conv:
            return 0.0
        lvl, base = conv[(w_in, w_out)]
        src = specs.params_for_width(w_in)
        dst = specs.params_for_width(w_out)
        return pp.variance_keyswitch(src.n_big, base, lvl, dst.glwe_std ** 2)

    def sample(var, shape):
        return rng.normal(0.0, np.sqrt(var), shape) if var > 0 \
            else np.zeros(shape)

    def pbs_out_noise(node, p_in, pid_in, pid_out, lsbs, br_var,
                      max_native_bits, shape, signed):
        """Fresh output-noise sample of one bootstrap: blind-rotate for
        native TLUs, vertical-packing for WoP (with the fused-rounding
        reduced extraction count), plus the partition-crossing keyswitch."""
        p_eff = max(p_in - lsbs, 1)
        wop_gadgets = wop_gadgets_for(pid_in)
        if p_eff > max_native_bits and wop_gadgets is not None:
            cbs_l, cbs_b, pfks_l, pfks_b = wop_gadgets
            nb = p_eff + (1 if signed else 0)
            var = pp.wop_output_variance(
                specs.params_for_width(pid_in)
                if hasattr(specs, "params_for_width") else specs.params,
                nb, cbs_b, cbs_l, pfks_b, pfks_l)
        else:
            var = br_var
        return sample(var + crossing_var(pid_in, pid_out), shape)

    values: dict = {}
    noises: dict = {}   # torus-unit float64 noise samples (0.0 for clear)

    def noise_of(node):
        n = noises.get(node, 0.0)
        return n if isinstance(n, np.ndarray) else np.asarray(n, np.float64)

    def affine_noise(node, preds, args):
        """Noise through a leveled op via its own evaluator:
        f(noise, clears) - f(0, clears) = the op's linear map applied to
        the noise samples (exact for every affine lowering)."""
        nargs, zargs = [], []
        for q, a in zip(preds, args):
            if q.output.is_encrypted:
                n = noise_of(q)
                n = np.broadcast_to(n, np.shape(a)) if np.shape(a) else n
                nargs.append(np.asarray(n, dtype=np.float64))
                zargs.append(np.zeros(np.shape(a)))
            else:
                nargs.append(a)
                zargs.append(a)
        try:
            return np.asarray(node(*nargs), dtype=np.float64) \
                - np.asarray(node(*zargs), dtype=np.float64)
        except Exception:
            # non-affine or evaluator incompatible with floats: keep the
            # loudest operand's sample (conservative magnitude, correlation
            # lost only for this exotic op)
            cands = [noise_of(q) for q in preds if q.output.is_encrypted]
            if not cands:
                return np.zeros(np.shape(values[node]))
            return max(cands, key=lambda n: float(np.abs(n).max()
                                                  if np.size(n) else 0.0))

    for node in graph.topological_order():
        name = node.name
        preds = graph.ordered_preds_of(node)
        if node.operation == Operation.Input:
            pos = next(q for q, n in graph.input_nodes.items() if n is node)
            values[node] = np.asarray(inputs[pos])
            if node.output.is_encrypted:
                fresh = stages(partition_of(node, p_default))[0]
                noises[node] = sample(fresh, values[node].shape)
            else:
                noises[node] = 0.0
            continue
        if node.operation == Operation.Constant:
            values[node] = node()
            noises[node] = 0.0
            continue
        args = [values[q] for q in preds]
        if name in ("tlu", "univariate"):
            from concrete_tpu_torch.compilation.widths import \
                tlu_fused_lsbs
            x = np.asarray(args[0])
            # decide at the TLU boundary: the carried input sample plus
            # fresh keyswitch + modulus-switch noise, at the input
            # partition's encoding width (multi-precision mono); fused
            # rounding enlarges the decision step by 2^lsbs
            p_in = encoding_width(preds[0], p_default)
            w_out = encoding_width(node, p_default)
            pid_in = partition_of(preds[0], p_default)
            pid_out = partition_of(node, p_default)
            _, br_var, ks_var, ms_var, max_native_bits = stages(pid_in)
            lsbs = tlu_fused_lsbs(graph, node)
            step = 2.0 ** -(p_in + 1)   # torus width of one encoded step
            noise = (np.broadcast_to(noise_of(preds[0]), x.shape)
                     + sample(ks_var + ms_var, x.shape))
            quantum = 1 << lsbs
            shifted = x + quantum * np.round(
                noise / (step * quantum)).astype(np.int64)
            domain = 1 << p_in
            shifted = ((shifted % domain) + domain) % domain
            signed = node.inputs[0].dtype.is_signed
            if signed:
                half = domain // 2
                shifted = np.where(shifted >= half, shifted - domain,
                                   shifted)
            values[node] = np.asarray(node(shifted))
            noises[node] = pbs_out_noise(node, p_in, pid_in, pid_out,
                                         lsbs, br_var, max_native_bits,
                                         values[node].shape, signed)
        elif name == "multivariate":
            # packed TLU: the packed index carries each operand's own
            # sample scaled by its packing offset (correlations exact)
            from concrete_tpu_torch.compilation.executor import (
                multivariate_raw_table, packed_layout)
            preds_enc = [q for q in preds if q.output.is_encrypted]
            p_in = max(encoding_width(q, p_default) for q in preds_enc)
            w_out = encoding_width(node, p_default)
            pid_in = partition_of(preds_enc[0], p_default)
            pid_out = partition_of(node, p_default)
            _, br_var, ks_var, ms_var, max_native_bits = stages(pid_in)
            cache = _sim_cache(graph)
            key = ("multivariate", node.uid, p_in)
            if key not in cache:
                cache[key] = (packed_layout(graph, node),
                              multivariate_raw_table(graph, node, p_in))
            (mins, widths_, offsets), table = cache[key]
            packed = 0
            noise_in = 0.0
            for q, val, mn, off in zip(preds, args, mins, offsets):
                packed = packed + ((np.asarray(val, dtype=np.int64) - mn)
                                   << off)
                if q.output.is_encrypted:
                    noise_in = noise_in + noise_of(q) * float(1 << off)
            step = 2.0 ** -(p_in + 1)
            noise = (np.broadcast_to(noise_in, np.shape(packed))
                     + sample(ks_var + ms_var, np.shape(packed)))
            shifted = packed + np.round(noise / step).astype(np.int64)
            domain = 1 << p_in
            shifted = ((shifted % domain) + domain) % domain
            values[node] = table[shifted]
            noises[node] = pbs_out_noise(node, p_in, pid_in, pid_out,
                                         0, br_var, max_native_bits,
                                         np.shape(values[node]), False)
        elif name == "dynamic_tlu":
            # runtime-table lookup: the same decision-noise model as a
            # static TLU, with the table read from the clear operand
            table = np.asarray(args[0])
            x = np.asarray(args[1])
            p_in = encoding_width(preds[1], p_default)
            pid_in = partition_of(preds[1], p_default)
            pid_out = partition_of(node, p_default)
            _, br_var, ks_var, ms_var, max_native_bits = stages(pid_in)
            step = 2.0 ** -(p_in + 1)
            noise = (np.broadcast_to(noise_of(preds[1]), x.shape)
                     + sample(ks_var + ms_var, x.shape))
            shifted = x + np.round(noise / step).astype(np.int64)
            domain = 1 << p_in
            shifted = ((shifted % domain) + domain) % domain
            if node.inputs[1].dtype.is_signed:
                half = domain // 2
                shifted = np.where(shifted >= half, shifted - domain,
                                   shifted)
            values[node] = table[shifted]
            noises[node] = sample(br_var + crossing_var(pid_in, pid_out),
                                  np.shape(values[node]))
        elif name == "extract_bits":
            # lsb-cascade (executor extract_bits lowering): peel bits LSB
            # first with one sign-PBS decision per bit; a flipped decision
            # corrupts the residual and thus all higher peels, exactly as
            # the real cascade fails
            positions = tuple(node.properties["kwargs"]["positions"])
            x = np.asarray(args[0]).astype(np.int64)
            p_in = encoding_width(preds[0], p_default)
            pid_in = partition_of(preds[0], p_default)
            _, br_var, ks_var, ms_var, _ = stages(pid_in)
            domain = np.int64(1) << np.int64(p_in)
            resid = ((x % domain) + domain) % domain
            resid_noise = np.broadcast_to(
                noise_of(preds[0]), resid.shape).astype(np.float64).copy()
            out = np.zeros_like(resid)
            out_noise = np.zeros(resid.shape)
            for j_bit in range(max(positions) + 1):
                # the sign decision sees the residual's accumulated sample
                # plus fresh KS+MS, scaled to the torus MSB
                dec = resid_noise + sample(ks_var + ms_var, resid.shape)
                scale = 2.0 ** (p_in - 1 - j_bit)
                bit = (((resid >> np.int64(j_bit)) & 1)
                       ^ (np.abs(dec * scale) > 0.25)).astype(np.int64)
                if j_bit in positions:
                    out |= bit << np.int64(positions.index(j_bit))
                    out_noise = out_noise + sample(br_var, resid.shape)
                resid = resid - (bit << np.int64(j_bit))
                # the subtracted bit ciphertext carries one fresh BR noise
                resid_noise = resid_noise + sample(br_var, resid.shape)
            values[node] = out
            noises[node] = out_noise + sample(
                crossing_var(pid_in, partition_of(node, p_default)),
                resid.shape)
        elif name == "crt_tlu":
            # WoP-PBS over CRT residues (executor crt_tlu lowering):
            # per-residue bit extraction decides at each residue's own
            # encoding width; the output carries fresh vertical-packing
            # noise (one WoP chain shared by all sibling output residues)
            kwargs = node.properties["kwargs"]
            moduli = tuple(int(m) for m in kwargs["moduli"])
            table = np.asarray(kwargs["table"], dtype=np.int64)
            j_out = int(kwargs["out_index"])
            product = 1
            for m in moduli:
                product *= m
            shape = np.shape(args[0])
            x = np.zeros(shape, dtype=np.int64)
            nb_total = 0
            for q, a, m in zip(preds, args, moduli):
                w_j = encoding_width(q, p_default)
                _, _, ks_var, ms_var, _ = stages(
                    partition_of(q, p_default))
                step = 2.0 ** -(w_j + 1)
                noise = (np.broadcast_to(noise_of(q), shape)
                         + sample(ks_var + ms_var, shape))
                dom = 1 << w_j
                r = (np.asarray(a, dtype=np.int64)
                     + np.round(noise / step).astype(np.int64))
                r = ((r % dom) + dom) % dom
                q_m = product // m
                x = x + r * (q_m * pow(int(q_m), -1, int(m)))
                nb_total += min(int(np.ceil(np.log2(m))), w_j)
            x = x % product
            values[node] = table[x % len(table)] % moduli[j_out]
            p_in = partition_of(preds[0], p_default)
            w_out = partition_of(node, p_default)
            gadgets = wop_gadgets_for(p_in)
            if gadgets is not None:
                cbs_l, cbs_b, pfks_l, pfks_b = gadgets
                var = pp.wop_output_variance(
                    specs.params_for_width(p_in)
                    if hasattr(specs, "params_for_width") else specs.params,
                    nb_total, cbs_b, cbs_l, pfks_b, pfks_l)
            else:
                var = stages(p_in)[1]
            values[node] = np.asarray(values[node])
            noises[node] = sample(var + crossing_var(p_in, w_out),
                                  np.shape(values[node]))
        elif name == "trace_message":
            # Tracing dialect analog (lib/Dialect/Tracing): simulation
            # prints the current plaintext, like sim trace_plaintext
            values[node] = args[0]
            noises[node] = noise_of(preds[0])
            msg = node.properties["kwargs"].get("message", "trace")
            print(f"[trace] {msg}: {np.asarray(args[0])}")
        elif name in _PASSTHROUGH:
            # physically the ciphertext is untouched (rounding happens in
            # the consumer PBS's modulus switch): value rounds, noise rides
            values[node] = np.asarray(node(*args))
            noises[node] = noise_of(preds[0])
        else:
            values[node] = np.asarray(node(*args))
            if node.output.is_encrypted:
                noises[node] = affine_noise(node, preds, args)
            else:
                noises[node] = 0.0

        check_overflow(node, values[node])

    outs = tuple(values[n] for n in graph.ordered_outputs)
    return outs[0] if len(outs) == 1 else outs
