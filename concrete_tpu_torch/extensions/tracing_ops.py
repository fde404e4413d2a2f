"""In-circuit trace points — the analog of the reference's Tracing dialect.

Reference: compilers/concrete-compiler/compiler/lib/Dialect/Tracing
(TraceCiphertextOp / TracePlaintextOp / TraceMessageOp survive lowering and
print at runtime; the simulation backend prints decrypted plaintexts).

Here `fhe.trace(x, message)` inserts a `trace_message` node that
- **simulation**: prints `message` and the current plaintext value at that
  point (simulation/__init__.py);
- **execution**: is a free identity by default; with
  ``CONCRETE_TPU_TRACE=1`` the executor prints the ciphertext body word
  (the encrypted analog — the server cannot decrypt, so only metadata is
  printable, exactly like the reference's trace_ciphertext);
- is otherwise transparent to bounds, widths, fusing and the optimizer.
"""

from __future__ import annotations

from concrete_tpu_torch.tracing.tracer import Tracer


def trace(x, message: str = "trace"):
    """Mark a value for tracing; returns the value unchanged."""
    if not isinstance(x, Tracer):
        print(f"[trace] {message}: {x}")
        return x
    out = Tracer._generic("trace_message", [x], lambda v: v, x.node.output,
                          message=message)
    return out
