"""Dataflow task scheduler — the RT-dialect / DFR analog.

Counterpart of ``concrete_tpu/compilation/scheduler.py``.  Reference: the
compiler's RT dialect turns the circuit into dataflow tasks executed by an
HPX runtime (compilers/concrete-compiler/compiler/lib/Dialect/RT,
lib/Runtime/DFRuntime.cpp): tasks fire when their operands become ready,
independent tasks run concurrently.

Within one circuit call the executor issues its kernels in graph order on
the device's stream, so the meaningful dataflow level is BETWEEN circuit
calls: composition chains (f2(f1(x))), independent module functions, and
host-side encrypt/decrypt work.  `DataflowScheduler.submit` accepts futures
as arguments — a task waits only on the futures it actually consumes,
everything else overlaps on the pool.  The pool's threads share the
device's default stream, so their kernels run in the order they were
issued; what overlaps is one call's host work (keyswitch glue, the
executor's Python, uploads and downloads) with another call's kernels.
A task's exception comes out of its future's ``result()``.  A task runs
in a copy of the submitter's ``contextvars`` context, so the spans it
records (``utils/telemetry``) join the submitter's request.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import os
import threading
from typing import Any, Callable


class DataflowScheduler:
    """Dependency-aware async executor: args may be Futures of prior tasks."""

    def __init__(self, max_workers: int = None):
        if max_workers is None:
            max_workers = min(4, os.cpu_count() or 1)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="ctpu-dataflow")

    def submit(self, fn: Callable, *args, **kwargs
               ) -> concurrent.futures.Future:
        """Schedule fn(*args, **kwargs); any Future argument is resolved
        (awaited) inside the task before the call, so chains submitted
        back-to-back form a dataflow graph without blocking the caller."""

        def task():
            resolved = [a.result() if isinstance(a, concurrent.futures.Future)
                        else a for a in args]
            kw = {k: (v.result()
                      if isinstance(v, concurrent.futures.Future) else v)
                  for k, v in kwargs.items()}
            return fn(*resolved, **kw)

        return self._pool.submit(contextvars.copy_context().run, task)

    def map_unordered(self, fn: Callable, items) -> list:
        """Run fn over items concurrently, return results in input order."""
        futures = [self.submit(fn, it) for it in items]
        return [f.result() for f in futures]

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


_default_lock = threading.Lock()
_default: DataflowScheduler = None


def default_scheduler() -> DataflowScheduler:
    """Process-wide scheduler shared by Circuit.run_async /
    auto_schedule_run (reference: the process-wide DFR runtime)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = DataflowScheduler()
        return _default


def run_async(fn: Callable, *args: Any, **kwargs: Any):
    return default_scheduler().submit(fn, *args, **kwargs)
