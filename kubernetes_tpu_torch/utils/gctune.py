"""Generational-GC tuning for steady-state control-plane processes.

The API dataclasses form no reference cycles (plain trees: object ->
metadata/spec/status -> lists of leaf dataclasses), so CPython's
refcounting reclaims essentially all garbage and the cyclic collector
only costs: each gen-0 pass scans every tracked young object, and with
a 5k-node fleet churning ~10 clones per pod the collector fired often
enough to show at ~25% of profile ticks (PROFILE_e2e.md,
_xla_gc_callback — jax registers a hook that runs on every
collection, so collections are extra-expensive in-process).

The tuning a long-lived server applies at startup (the same move Go's
runtime makes structurally — its GC is concurrent, ours stops the
world): freeze the boot-time object graph out of the young
generations, then raise gen-0's threshold so steady-state churn is
reclaimed by refcounting with rare cycle sweeps. The collector stays
ON — genuine cycles (error tracebacks etc.) still get collected.

Used by the hyperkube server entries and the kubemark benchmark
(a warm live scheduler measures with the same process tuning it
serves with).
"""

from __future__ import annotations

import contextlib
import gc

TUNED_THRESHOLD = (50_000, 20, 20)


def tune_for_server() -> None:
    """One-way startup tuning for a real server process."""
    gc.collect()
    gc.freeze()
    gc.set_threshold(*TUNED_THRESHOLD)


@contextlib.contextmanager
def tuned_gc():
    """Scoped variant for benchmarks/tests: tune, then restore (and
    unfreeze) so the host process's GC behavior is unchanged after."""
    prev = gc.get_threshold()
    gc.collect()
    gc.freeze()
    gc.set_threshold(*TUNED_THRESHOLD)
    try:
        yield
    finally:
        gc.set_threshold(*prev)
        gc.unfreeze()
        gc.collect()
