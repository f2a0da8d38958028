"""Device profiling — the torch.profiler integration.

Reference: net/http/pprof mounted on the apiserver/scheduler/kubelet
(pkg/master/master.go:689-691, plugin/cmd/kube-scheduler/app/
server.go:131-135) + hack/grab-profiles.sh. The device analogue:
`device_trace` wraps a region in a torch.profiler trace (CPU activity,
and CUDA activity when a card is present) and writes it to `logdir` as
a Chrome trace (chrome://tracing, Perfetto), and `profiled_schedule`
captures one engine run — the equivalent of grabbing a scheduler CPU
profile mid-benchmark. Pairs with utils/trace.py (the over-threshold
span logger playing pkg/util/trace.go's role on the host side).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

TRACE_NAME = "trace-{pid}-{stamp}.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace every torch operation and kernel launch in the region into
    `logdir` (one Chrome trace file, TRACE_NAME).

    Usage:
        with device_trace("/tmp/sched-trace"):
            engine.run_chunked(enc, 1024)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield logdir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME.format(
            pid=os.getpid(), stamp=time.time_ns())))


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-span inside a device trace (torch.profiler.
    record_function — shows up as a labeled region in the timeline)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def profiled_schedule(engine, enc, logdir: str,
                      chunk: Optional[int] = None):
    """One traced engine run -> (assigned, logdir). The grab-profiles.sh
    move: point it at a live encoder's output, read the dump in a trace
    viewer."""
    with device_trace(logdir):
        with annotate("batch-schedule"):
            if chunk:
                assigned, _ = engine.run_chunked(enc, chunk)
            else:
                assigned, _ = engine.run(enc)
    return assigned, logdir
