"""Composition policies for modules (reference compilation/composition.py:
CompositionPolicy / AllComposable / NotComposable / Wired + Wire endpoints).

A copy of ``concrete_tpu/compilation/composition.py``: the same policies,
the same unified functions and the same messages.

A module's functions share one keyset; a policy declares which function
outputs may feed which function inputs, which controls encoding-width
unification:

- AllComposable (default): any output may feed any input -> every encrypted
  value in the module is pinned to the module-wide width (one shared
  encoding, exactly like the reference's full-unification behavior).
- NotComposable: no chaining -> each function keeps its own per-value
  multi-precision widths (cheapest TLUs; outputs are NOT valid inputs).
- Wired(wires): only the declared Wire(Output(f, i), Input(g, j)) pairs
  chain -> the involved functions are unified, the rest stay
  multi-precision.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


def _func_name(func) -> str:
    fdef = getattr(func, "_fhe_function", None)
    if fdef is not None:
        return fdef.function.__name__
    if isinstance(func, str):
        return func
    return getattr(func, "__name__", str(func))


@dataclasses.dataclass(frozen=True)
class Output:
    """One function output (or use AllOutputs)."""
    func: object
    pos: int = 0

    @property
    def func_name(self) -> str:
        return _func_name(self.func)


@dataclasses.dataclass(frozen=True)
class Input:
    """One function input (or use AllInputs)."""
    func: object
    pos: int = 0

    @property
    def func_name(self) -> str:
        return _func_name(self.func)


class AllOutputs(Output):
    def __init__(self, func):
        super().__init__(func, -1)


class AllInputs(Input):
    def __init__(self, func):
        super().__init__(func, -1)


@dataclasses.dataclass(frozen=True)
class Wire:
    output: Output
    input: Input


class CompositionPolicy:
    """Base: which module functions need a unified (shared) encoding."""

    def unified_functions(self, names: Iterable[str]) -> set:
        raise NotImplementedError


class AllComposable(CompositionPolicy):
    def unified_functions(self, names):
        return set(names)


class NotComposable(CompositionPolicy):
    def unified_functions(self, names):
        return set()


class Wired(CompositionPolicy):
    def __init__(self, wires: Iterable[Wire] = ()):
        self.wires = list(wires)

    def unified_functions(self, names):
        names = set(names)
        out = set()
        for w in self.wires:
            out.add(w.output.func_name)
            out.add(w.input.func_name)
        unknown = out - names
        if unknown:
            raise ValueError(
                f"Wired composition references unknown module function(s) "
                f"{sorted(unknown)}; known: {sorted(names)}")
        return out
