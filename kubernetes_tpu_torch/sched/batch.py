"""Batch scheduling control loop: the device fast path.

Where the reference's scheduleOne is strictly serial (scheduler.go:120 —
one pod, one Schedule() call, one binding POST), this loop drains the
pending FIFO into a tile, schedules the whole tile on the device in one
sequential scan (sched.device), and commits the resulting bindings in one
batched CAS pass (registry.bind_batch — single lock acquisition, per-pod
conflict semantics; SURVEY.md section 7 hard part 2).

The port's copy of the JAX package's live tile loop. A dispatched tile's
assignment is a device tensor with a CUDA event recorded after its last
chunk (engine.PendingAssignment): the scheduler thread never waits on
the device; whichever thread lands the tile waits on that tile's event
alone. `mesh=` splits the engine's node axis (sched/device/mesh.py) and
`shard_monitor=` watches the shards' leases between tiles
(sched/device/shardfail.py), as in the JAX loop.
Priority preemption is (`preemption=`, `_try_preempt`), with one
difference: a failed victim search is not taken for "no victims" (see
`_try_preempt`).

Semantics parity: the engine carries assume-pod state inside the scan, so
within a tile pod k+1 sees pod k's binding exactly as the serial
scheduler's modeler would. Across tiles the modeler plays its usual role
(bind -> assume -> watch confirms). Unschedulable pods take the same
error path (backoff + requeue) as the serial loop.

Fast-path eligibility is decided by the factory (create_batch): the
default algorithm provider with no extenders maps onto the engine; any
custom policy (service affinity, label presence, anti-affinity priority,
HTTP extenders) falls back to the serial Scheduler — the provable
fallback the BASELINE requires.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

logger = logging.getLogger(__name__)

from .. import obs
from ..core import types as api
from ..core.errors import Conflict, NotFound
from ..utils.metrics import MetricsRegistry, global_metrics
from .device import BatchEngine, ClusterSnapshot
from .device.engine import CARRY_DTYPES
from .device.incremental import IncrementalEncoder, NeedsFullEncode
from .generic import FitError
from .predicates import node_schedulable

#: calls a failed tile's halving commit makes side by side
#: (BatchScheduler._bind_halves)
BIND_SPLIT_THREADS = 16


@dataclass
class _Inflight:
    """A tile dispatched to the device but not yet finalized: its
    assignment lands on the host via PendingAssignment.result() and its
    final carry State lives on device for the next tile to chain from."""
    pods: List[api.Pod]
    enc: Any                 # EncodeResult
    assigned: Any            # engine.PendingAssignment of i32[p_pad]
    state: Any               # device State (the scan's final carry)
    epoch: int               # encoder state_epoch at encode time
    flags: Tuple[bool, bool]  # (has_aff, has_spread)
    t_start: float
    t_dev: float
    # encoder shard-epoch vector at encode time (TableDelta.shard_epochs;
    # None on the full-encode path): _finalize fences on it — a tile
    # whose vector no longer matches the encoder's was dispatched
    # against a mesh that lost a shard, and is dropped whole
    shard_epochs: Optional[Tuple[int, ...]] = None
    # set once _finalize has handed the tile's bindings over (commit
    # queued or committed) — the drain_commits barrier rides behind it
    landed: threading.Event = field(default_factory=threading.Event)


def _carry_compatible(enc, prev_state) -> bool:
    """Would the device carry from the previous tile slot into this
    tile's State position bit-for-bit? Shapes and dtypes must agree
    (interner growth widens bitsets; gcd changes flip narrowing). The
    encoding is numpy and the carry torch, so dtypes compare through the
    engine's one map of encoder dtype -> carry dtype (CARRY_DTYPES)."""
    st = enc.init_state
    pairs = ((st.cpu_used, prev_state.cpu_used),
             (st.mem_used, prev_state.mem_used),
             (st.nz_cpu, prev_state.nz_cpu),
             (st.nz_mem, prev_state.nz_mem),
             (st.pod_count, prev_state.pod_count),
             (st.port_bits, prev_state.port_bits),
             (st.disk_any, prev_state.disk_any),
             (st.disk_rw, prev_state.disk_rw),
             (st.spread, prev_state.spread),
             (st.aff_count, prev_state.aff_count),
             (st.aff_total, prev_state.aff_total),
             (st.svc_count, prev_state.svc_count),
             (st.svc_total, prev_state.svc_total))
    return all(a.shape == tuple(b.shape)
               and CARRY_DTYPES.get(a.dtype) == b.dtype
               for a, b in pairs)


class BatchSchedulerConfig:
    def __init__(self, factory, engine: Optional[BatchEngine] = None,
                 tile_size: int = 8192, min_pad: int = 64,
                 bulk_chunk: int = 1024, incremental: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 mesh=None, shard_monitor=None, preemption=None,
                 device=None):
        self.factory = factory
        # priority preemption (sched/preemption.py PreemptionPass):
        # None (the default) keeps the pre-priority behavior — an
        # infeasible pod takes the plain error path no matter its
        # priority. Only meaningful on the incremental path (the victim
        # table is a cut of the encoder's ledger).
        self.preemption = preemption
        # shard-failure tolerance (sched/device/shardfail.py): a
        # ShardLeaseMonitor polled between tiles. An expired shard
        # lease triggers fence -> survivor re-shard -> in-flight drop;
        # None (the default) keeps the mesh un-monitored.
        self.shard_monitor = shard_monitor
        # mesh= (a NodeMesh) shards the node axis of the live pipeline
        # (ignored when an explicit engine is passed — the engine's own
        # mesh wins); the encoder below keeps slot capacity a multiple
        # of the mesh size so shards stay block-aligned. device: where a
        # default engine without a mesh runs (None = the CUDA device)
        self.engine = engine or BatchEngine(mesh=mesh, device=device)
        self.tile_size = tile_size
        # scan-chunk sizes: small drains run [min_pad] chunks, bulk drains
        # [bulk_chunk] ones (the JAX engine compiles one program per
        # rung; the port keeps the same ladder, so its tiles pad alike)
        self.min_pad = min_pad
        self.bulk_chunk = bulk_chunk
        # incremental device state (watch deltas -> persistent arrays,
        # SURVEY.md section 7 hard part 4). Node-static policy tiers
        # (label presence/priorities) ride along; the anti-affinity tier
        # needs per-tile service groups and keeps the full encode
        self.incremental = incremental and (
            self.engine.policy is None
            or not self.engine.policy.needs_anti_affinity)
        self.metrics = metrics or global_metrics


class BatchScheduler:
    """Tile-at-a-time scheduler over the device engine.

    HA: pass `elector` (utils/leaderelection.LeaderElector) and the
    scheduler becomes a CANDIDATE — the scan loop idles until the
    elector wins the lease, and every leadership session starts from a
    fresh device state (see _on_started_leading). N replicas can run
    against one apiserver; the bind CAS guarantees a pod binds once no
    matter how leadership moved mid-tile.
    """

    def __init__(self, config: BatchSchedulerConfig, elector=None):
        self.config = config
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inc: Optional[IncrementalEncoder] = None
        # leadership gate: the scan loop only drains the FIFO while
        # set. Electorless schedulers lead unconditionally.
        self._leading = threading.Event()
        self._killed = False
        self.elector = elector
        if elector is None:
            self._leading.set()
        else:
            elector.on_started_leading = self._on_started_leading
            elector.on_stopped_leading = self._on_stopped_leading
        # the dispatched-but-unfinalized tile (device pipeline depth 1):
        # scheduler-thread only
        self._prev: Optional[_Inflight] = None
        # the most recently handed-off unfinalized tile (scheduler-
        # thread writes; FIFO means its landed event implies every
        # earlier handoff landed too — see _ledger_current)
        self._last_handed: Optional[_Inflight] = None
        # the commit pipeline (SURVEY.md section 7 hard part 2 + the
        # reference's scheduler->binder two-stage analogue,
        # scheduler.go:120-165): tile k's binding commit runs on this
        # thread while tile k+1 encodes and executes on device. Sound
        # because the incremental state is advanced OPTIMISTICALLY at
        # schedule time (assume-before-bind); a failed bind is corrected
        # by the watch echo (deleted pod -> remove, bound-elsewhere ->
        # node change), and until then the error is conservative (the
        # node looks fuller than it is). Bounded queue = backpressure.
        self._commit_q: "queue.Queue[Optional[list]]" = queue.Queue(
            maxsize=4)
        self._commit_thread: Optional[threading.Thread] = None
        # longest FIFO wait among the pods of the last drained tile
        # (scheduler-thread only) — the "queue" stage span reads it
        self._last_drain_wait = 0.0

    def _incremental(self) -> Optional[IncrementalEncoder]:
        """Lazily attach the incremental encoder (the factory's informers
        must be running; attach+bootstrap is idempotent via the ledger)."""
        if not self.config.incremental:
            return None
        if self._inc is None:
            inc = IncrementalEncoder(
                policy=self.config.engine.policy,
                mesh_devices=self.config.engine.n_shards)
            # narrowing must budget for a dispatched-but-unassumed tile
            inc.inflight_pad = self.config.tile_size
            self._inc = inc.attach(self.config.factory)
        return self._inc

    def run(self) -> "BatchScheduler":
        self._thread = threading.Thread(target=self._loop,
                                        name="batch-scheduler", daemon=True)
        self._thread.start()
        self._commit_thread = threading.Thread(
            target=self._commit_loop, name="batch-binder", daemon=True)
        self._commit_thread.start()
        if self.elector is not None:
            self.elector.run()
        return self

    # ------------------------------------------------------- leadership

    def _on_started_leading(self, term: int) -> None:
        """Failover rebuild: drop every pre-leadership carry — the
        in-flight tile and the incremental device ledger — and
        bootstrap a fresh encoder from the informer caches (a fresh
        re-list of bound pods and nodes) on the next tile. The pending
        FIFO needs no rebuild: the unassigned reflector has been
        feeding it all along, and a pod the old leader managed to bind
        mid-failover leaves via its filtered-watch DELETE (or, at
        worst, the bind CAS rejects the duplicate and _bind_failed
        re-reads it)."""
        self._prev = None
        self._last_handed = None
        old = self._inc
        self._inc = None
        if old is not None:
            old.detach()
        self._leading.set()

    def _on_stopped_leading(self) -> None:
        self._leading.clear()

    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    def kill(self) -> None:
        """Simulated process death (chaos/crash.py): scheduling halts
        NOW, queued-but-uncommitted tiles are dropped (a dead binder
        binds nothing), and the lease is NOT released — the standby
        waits out the expiry and takes over under a new fencing term,
        re-scheduling whatever this process left unbound."""
        self._killed = True
        self._leading.clear()
        if self.elector is not None:
            self.elector.kill()
        self._stop.set()

    def reap(self, timeout: float = 30.0) -> bool:
        """After kill(): wait for the dead process's scheduler and binder
        threads to end (the binder drops what was queued, as kill()
        says) and release its engine's device tables, so that a standby
        in the same process (kubemark/crash_soak.py) does not inherit
        them. -> whether both threads ended within `timeout`."""
        if not self._killed:
            raise RuntimeError("reap: the scheduler was not killed")
        deadline = time.monotonic() + timeout
        if self._thread:
            self._thread.join(timeout=timeout)
        try:
            self._commit_q.put(None, timeout=max(
                0.001, deadline - time.monotonic()))
        except queue.Full:
            return False
        if self._commit_thread:
            self._commit_thread.join(timeout=max(
                0.0, deadline - time.monotonic()))
        ended = not any(t is not None and t.is_alive()
                        for t in (self._thread, self._commit_thread))
        if ended:
            self._prev = None
            self._last_handed = None
            if self._inc is not None:
                self._inc.detach()
            self.config.engine.release()
        return ended

    def stop(self) -> None:
        if self.elector is not None:
            self.elector.stop()  # demotes + releases the lease
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)
        if self._thread and self._thread.is_alive():
            # the scheduler thread is wedged mid-tile (e.g. a long
            # scan): leave the committer alive so a tile published
            # after this point still binds — both threads are daemons
            return
        # flush: every scheduled-but-uncommitted tile still binds
        try:
            self._commit_q.put(None, timeout=30)
        except queue.Full:
            # committer wedged mid-tile (e.g. per-pod CAS fallback over
            # a big tile): it's a daemon, let it drain in the background
            # rather than hanging shutdown
            return
        if self._commit_thread:
            self._commit_thread.join(timeout=30)

    def drain_commits(self, timeout: float = 30.0) -> None:
        """Block until every dispatched tile has been committed AND
        assumed (a barrier Event rides the queue behind the pending
        tiles). The full-encode path snapshots the modeler's merged
        lister — tiles still queued here are bound-but-unassumed, and
        scheduling against that snapshot would see their capacity as
        free.

        Under the deep pipeline the dispatched-but-unfinalized tile in
        self._prev is NOT in the queue yet: its bindings only enqueue
        when _finalize hands them over, so a barrier queued before that
        handoff would fire with the tile still in flight. The barrier
        therefore rides BEHIND it — on the scheduler thread by
        finalizing it first, elsewhere by waiting for its landed event
        (set after the handoff, so FIFO puts the barrier behind the
        bindings)."""
        deadline = time.monotonic() + timeout
        fl = self._prev
        if fl is not None:
            if threading.current_thread() is self._thread:
                self._finalize_prev()
            else:
                fl.landed.wait(timeout=max(0.0,
                                           deadline - time.monotonic()))
        barrier = threading.Event()
        try:
            self._commit_q.put(barrier, timeout=max(
                0.001, deadline - time.monotonic()))
        except queue.Full:
            return  # committer wedged; the caller's snapshot is stale
                    # either way and the epoch guard catches it
        barrier.wait(timeout=max(0.0, deadline - time.monotonic()))

    def _commit_loop(self) -> None:
        while True:
            item = self._commit_q.get()
            if item is None:
                return
            if isinstance(item, threading.Event):
                # drain barrier: every commit before it has RETURNED —
                # but under NativeStore's publish ring "committed" only
                # means enqueued, so flush the native publisher before
                # firing: drained must keep meaning visible to watchers
                # (in-proc client only; over HTTP there is no handle,
                # and no in-proc snapshot to go stale either)
                store = getattr(getattr(getattr(
                    self.config.factory, "client", None),
                    "registry", None), "store", None)
                flush = getattr(store, "publish_flush", None)
                if flush is not None:
                    try:
                        flush(timeout=5.0)
                    except Exception:
                        pass  # barrier still fires; epoch guard covers
                item.set()  # drain barrier: everything before it landed
                continue
            if self._killed:
                continue  # a dead binder binds nothing (kill())
            if isinstance(item, _Inflight):
                # deep pipeline (scan/commit overlap): the scheduler
                # thread handed over a dispatched-but-unfinalized tile —
                # the wait on its CUDA event happens HERE, double-buffered
                # against the next tile's encode/execute on device.
                # _finalize routes its own failures (asarray -> whole
                # tile to error path, commit -> per-pod fallback).
                try:
                    self._finalize(item, on_committer=True)
                except Exception as e:
                    logger.exception("tile finalize failed")
                    for pod in item.pods:
                        try:
                            self._error(pod, e)
                        except Exception:
                            pass
                continue
            try:
                # No tile-wide modeler lock here: the merged lister
                # dedupes scheduled-vs-assumed by key, so bind→assume
                # need not be atomic against the confirm reflector's
                # forgets (a forget racing ahead of the assume leaves a
                # stale assumed entry that list() prunes on sight).
                # Holding the lock across a whole tile starved the
                # reflector's per-event forgets on small-core hosts.
                self._commit(item, inc_assumed=True)
            except Exception as e:
                # _commit routes per-pod failures itself; anything
                # escaping aborted the tile mid-way — route the whole
                # tile to backoff+requeue (error_func re-reads the pod,
                # so already-bound ones are dropped) instead of
                # stranding it Pending
                logger.exception("tile commit failed")
                for pod, _host in item:
                    try:
                        self._error(pod, e)
                    except Exception:
                        pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._leading.is_set():
                # standby / demoted: land any in-flight tile (its binds
                # are CAS-protected — the new leader's duplicates lose
                # cleanly on one side) and stop draining the FIFO
                self._finalize_prev()
                self._stop.wait(0.02)
                continue
            try:
                busy = self.schedule_tile()
            except Exception:
                # schedule_tile itself routes pod-level failures; anything
                # escaping here would otherwise kill the daemon thread and
                # stall scheduling cluster-wide
                busy = True
            if not busy:
                # idle: land the in-flight tile before parking
                self._finalize_prev()
                self._stop.wait(0.01)
        if not self._killed:
            self._finalize_prev()

    def _drain_tile(self, timeout: float = 0.5) -> List[api.Pod]:
        f = self.config.factory
        pods: List[api.Pod] = []
        # tile queue-wait = the longest per-pod FIFO wait in the drain
        # (fifo.pop stamps last_pop_wait; getattr tolerates the fake
        # queues tests substitute)
        max_wait = 0.0
        q_wait = lambda: getattr(f.pod_queue, "last_pop_wait", 0.0)
        pod = f.pod_queue.pop(timeout=timeout)
        if pod is None:
            self._last_drain_wait = 0.0
            return pods
        max_wait = q_wait()
        pods.append(pod)
        # the drain's host cost, split in two: the pops of a queue that
        # still holds pods ("drain") and the top-up below, which also
        # waits for the in-flight tile ("topup"); the wait for a tile's
        # first pod is idle time and stays out of both
        t_drain = time.monotonic()
        while len(pods) < self.config.tile_size:
            pod = f.pod_queue.pop(timeout=0)
            if pod is None:
                break
            w = q_wait()
            if w > max_wait:
                max_wait = w
            pods.append(pod)
        t_topup = time.monotonic()
        self.config.metrics.observe("batch_drain_latency_microseconds",
                                    (t_topup - t_drain) * 1e6)
        # Top-up while a tile is in flight: until the device reports the
        # previous assignments ready, dispatching this tile would only
        # queue behind it — so keep accumulating instead. Under a create
        # storm this turns 12 ragged ~2.5k-pod tiles (each padded to a
        # full scan) into 4 full ones (~3x less device work); when the
        # device is idle or the result is already ready, nothing waits.
        prev = self._prev
        if prev is not None and len(pods) < self.config.tile_size:
            ready = prev.assigned.is_ready
            while (len(pods) < self.config.tile_size and not ready()
                   and not self._stop.is_set()):
                # 20ms poll: long enough not to busy-spin the
                # scheduling thread at ~500 wakeups/s against an empty
                # queue for a whole device scan, short enough that the
                # post-ready finalize lags the device by at most one
                # poll (a full-tile scan runs far longer than 20ms)
                pod = f.pod_queue.pop(timeout=0.02)
                if pod is not None:
                    w = q_wait()
                    if w > max_wait:
                        max_wait = w
                    pods.append(pod)
            self.config.metrics.observe(
                "batch_topup_latency_microseconds",
                (time.monotonic() - t_topup) * 1e6)
        self._last_drain_wait = max_wait
        return pods

    @staticmethod
    def _chunk_for(c: BatchSchedulerConfig, n: int) -> int:
        # fixed scan-chunk ladder -> stable shapes (the JAX engine
        # compiles one program per rung). Big drains run as ONE
        # tile-sized dispatch:
        # on an idle chip, small chunks win (tail padding burns scan
        # steps), but in situ — 30 writer threads contending — each
        # extra dispatch re-enters Python behind the GIL, and the
        # measured e2e is ~20% better at chunk=tile than chunk=1024
        if n <= c.min_pad:
            return c.min_pad
        if n <= 2 * c.bulk_chunk:
            return c.bulk_chunk
        return c.tile_size

    def schedule_tile(self) -> bool:
        """Returns True if any pods were processed."""
        c = self.config
        f = c.factory
        if c.shard_monitor is not None:
            # between-tile shard failure detection: the scan itself is
            # never interrupted — an expired shard lease is observed
            # HERE, before the next dispatch
            self._check_shards()
        # with a tile in flight, don't park on the FIFO — an empty drain
        # must fall through so the idle path can finalize promptly
        pods = self._drain_tile(0 if self._prev is not None else 0.5)
        if not pods:
            return False
        if f.rate_limiter is not None:
            for _ in pods:
                f.rate_limiter.accept()
        start = time.monotonic()
        tr = obs.tracer()
        if tr.enabled:
            # "queue" stage, tile-granular: informer delivery -> this
            # drain, per the FIFO's first-enqueue stamps; the first
            # pod's annotation context is the exemplar parent
            tr.record("sched.queue_wait", start - self._last_drain_wait,
                      start, parent=obs.ctx_of(pods[0]), stage="queue",
                      attrs={"pods": len(pods)})

        inc = self._incremental()
        if inc is not None:
            try:
                return self._schedule_incremental(pods, start)
            except NeedsFullEncode:
                pass  # this tile needs the full encoder
            except Exception as e:
                self._fail_tile(pods, e)
                return True

        # full-encode path: strictly ordered after any in-flight tile
        # AND every queued commit (the encoder below reads the modeler's
        # merged lister; assume_pods runs on the committer thread, so
        # tiles still in _commit_q are bound-but-unassumed phantom
        # capacity until the queue drains)
        self._finalize_prev()
        self.drain_commits()
        try:
            chunk = self._chunk_for(c, len(pods))
            # the full node cache (not just ready nodes) resolves
            # existing pods' topology domains for affinity terms,
            # mirroring the serial predicate's node_by_name
            # (ReadyNodeLister.get)
            node_cache = getattr(f.node_lister, "cache", None)
            snap = ClusterSnapshot(
                nodes=f.node_lister.list(),
                existing_pods=f.pod_lister.list(),
                services=f.service_lister.list(),
                controllers=f.controller_lister.list(),
                pending_pods=pods,
                all_nodes=(node_cache.list()
                           if node_cache is not None else None))
            c.metrics.observe("batch_snapshot_latency_microseconds",
                              (time.monotonic() - start) * 1e6)
            t_dev = time.monotonic()
            hosts, _enc = c.engine.schedule(snap, chunk=chunk)
            t_done = time.monotonic()
            c.metrics.observe("batch_device_latency_microseconds",
                              (t_done - t_dev) * 1e6)
            if tr.enabled:
                ctx0 = obs.ctx_of(pods[0])
                tr.record("sched.encode", start, t_dev, parent=ctx0,
                          stage="schedule", attrs={"pods": len(pods)})
                tr.record("sched.device", t_dev, t_done, parent=ctx0,
                          stage="device", attrs={"pods": len(pods)})
        except Exception as e:
            self._fail_tile(pods, e)
            return True
        c.metrics.observe("scheduling_algorithm_latency_microseconds",
                          (time.monotonic() - start) * 1e6)

        scheduled = [(pod, host) for pod, host in zip(pods, hosts)
                     if host is not None]
        unscheduled = [pod for pod, host in zip(pods, hosts) if host is None]

        if self._inc is not None:
            # the incremental ledger exists but this tile went through
            # the full encoder: feed the assumes back one by one
            for pod, host in scheduled:
                self._inc.assume(api.fast_replace(
                    pod, spec=api.fast_replace(pod.spec, node_name=host)))
            self._commit_q.put(scheduled)
        else:
            # policy engines: the encoder reads the modeler's merged
            # lister, so commit stays on this thread to keep the next
            # tile's snapshot ordered after the binds
            f.modeler.locked_action(
                lambda: self._commit(scheduled, inc_assumed=False))

        self._route_unscheduled(unscheduled)
        c.metrics.observe("scheduler_e2e_scheduling_latency_microseconds",
                          (time.monotonic() - start) * 1e6)
        return True

    def _schedule_incremental(self, pods: List[api.Pod],
                              start: float) -> bool:
        """Dispatch one tile through the incremental encoder, chaining
        off the in-flight tile's device carry when provably equivalent;
        the previous tile finalizes (host assume + commit enqueue) while
        this one runs on device — the reference's scheduler->binder
        two-stage pipeline (scheduler.go:120-165), depth 2."""
        c = self.config
        f = c.factory
        inc = self._inc
        chunk = self._chunk_for(c, len(pods))
        # pre-pad the pod axis to a chunk multiple at encode time:
        # run_chunked then slices exact [chunk] pieces and never
        # concatenates under the GIL
        pad = ((len(pods) + chunk - 1) // chunk) * chunk
        services = f.service_lister.list()
        controllers = f.controller_lister.list()
        # spread groups make the device State tile-local (its [G, N]
        # rows are this tile's groups): chain only group-free tiles
        if self._prev is not None and (services or controllers
                                       or inc.groups):
            self._finalize_prev()
        if self._prev is None and not self._ledger_current():
            # about to dispatch from the encoder's init state (nothing
            # to chain off): tiles handed to the committer but not yet
            # assumed would read as free capacity — land them first
            self.drain_commits()
        enc = inc.encode_tile(pods, services, controllers, pad_to=pad)
        c.metrics.observe("batch_snapshot_latency_microseconds",
                          (time.monotonic() - start) * 1e6)
        flags = c.engine._enc_flags(enc)
        prev = self._prev
        chained = False
        t_dev = time.monotonic()
        if prev is not None:
            if (flags == (False, False) and prev.flags == (False, False)
                    and enc.state_epoch == prev.epoch
                    and enc.mem_scale == prev.enc.mem_scale
                    and _carry_compatible(enc, prev.state)):
                # self._prev stays set until the dispatch succeeds — an
                # exception here must not strand the in-flight tile
                assigned, state = c.engine.run_chunked(
                    enc, chunk, state_override=prev.state, block=False)
                chained = True
                self._prev = None
            else:
                # can't chain: land the previous tile (and any older
                # handoffs still with the committer), then re-encode so
                # this tile's init state includes every assume
                self._finalize_prev()
                if not self._ledger_current():
                    self.drain_commits()
                prev = None
                enc = inc.encode_tile(pods, services, controllers,
                                      pad_to=pad)
                flags = c.engine._enc_flags(enc)
        if not chained:
            t_dev = time.monotonic()
            assigned, state = c.engine.run_chunked(enc, chunk, block=False)
        c.metrics.inc("batch_tiles_total",
                      {"chained": str(chained).lower()})
        self._prev = _Inflight(pods=pods, enc=enc, assigned=assigned,
                               state=state, epoch=enc.state_epoch,
                               flags=flags, t_start=start, t_dev=t_dev,
                               shard_epochs=(enc.delta.shard_epochs
                                             if enc.delta is not None
                                             else None))
        tr = obs.tracer()
        if tr.enabled:
            # "schedule" stage ends at device dispatch; the matching
            # "device" span closes in _finalize when the assignments
            # materialize (possibly on the committer thread)
            tr.record("sched.encode", start, t_dev,
                      parent=obs.ctx_of(pods[0]), stage="schedule",
                      attrs={"pods": len(pods),
                             "chained": str(chained).lower()})
        if chained and prev is not None:
            # scan/commit overlap, committer-side double-buffer: hand
            # tile k over UNFINALIZED — the wait on its event (and the
            # bind commit behind it) runs on the committer thread while
            # tile k+1 executes on device and this thread encodes tile
            # k+2. Sound for the same assume-before-bind reason as the
            # commit queue itself; chaining means tile k+1's carry
            # already contains tile k's placements, so the encoder
            # ledger lagging behind the committer's assume_assigned is
            # invisible to chained dispatches (non-chained ones drain
            # via _ledger_current above). Bounded queue = backpressure.
            self._commit_q.put(prev)
            self._last_handed = prev
        return True

    def _ledger_current(self) -> bool:
        """Has every tile handed to the committer been assumed into the
        incremental encoder's ledger? FIFO order: if the most recent
        handoff landed (assume_assigned + commit handed over), every
        earlier one did too."""
        lh = self._last_handed
        return lh is None or lh.landed.is_set()

    def _finalize_prev(self) -> None:
        fl = self._prev
        self._prev = None
        if fl is not None:
            self._finalize(fl)

    def _finalize(self, fl: _Inflight, on_committer: bool = False) -> None:
        """Land a dispatched tile: block on its assignments, assume them
        into the persistent encoder state, hand bindings to the
        committer (or, on the committer thread itself, commit them
        directly — enqueueing into its own bounded queue would
        deadlock), route no-fit pods to backoff. The landed event fires
        once the bindings are queued/committed, whatever path ran —
        it's what drain_commits and _ledger_current key off."""
        c = self.config
        f = c.factory
        inc = self._inc
        delta = getattr(fl.enc, "delta", None)
        if (inc is not None and delta is not None
                and fl.shard_epochs is not None
                and delta.encoder_id == inc.encoder_id
                and inc.shard_epochs() != fl.shard_epochs):
            # shard-epoch fence: a shard owner died (and the mesh
            # re-sharded) after this tile's dispatch. Its assignments
            # were computed against the dead shard's slot mapping —
            # none may bind. Drop the tile whole; its pods requeue
            # FIFO and re-schedule against the survivor mesh. Epochs
            # are compared only within ONE encoder instance
            # (encoder_id): a failover successor's vector is
            # incomparable, and those tiles keep the existing
            # bind-then-reconcile semantics.
            try:
                for pod in fl.pods:
                    try:
                        self._requeue(pod, "mesh",
                                      "re-sharded since dispatch")
                    except Exception:
                        logger.exception("requeue of %s failed",
                                         pod.metadata.name)
            finally:
                fl.landed.set()
            return
        try:
            try:
                # waits on this tile's CUDA event only (the committer
                # thread, in the deep pipeline): later tiles queued on
                # the device are not waited for
                assigned = fl.assigned.result()
            except Exception as e:
                self._fail_tile(fl.pods, e)
                return
            t_done = time.monotonic()
            c.metrics.observe("batch_device_latency_microseconds",
                              (t_done - fl.t_dev) * 1e6)
            tr = obs.tracer()
            if tr.enabled:
                tr.record("sched.device", fl.t_dev, t_done,
                          parent=obs.ctx_of(fl.pods[0]), stage="device",
                          attrs={"pods": len(fl.pods)})
            enc = fl.enc
            idx = assigned[: enc.n_pods]
            names = enc.node_names
            scheduled: List[Tuple[api.Pod, str]] = []
            unscheduled: List[api.Pod] = []
            for j, pod in enumerate(fl.pods):
                i = idx[j]
                if i >= 0:
                    scheduled.append((pod, names[i]))
                else:
                    unscheduled.append(pod)
            c.metrics.observe("scheduling_algorithm_latency_microseconds",
                              (time.monotonic() - fl.t_start) * 1e6)
            try:
                # self._inc can be None mid-failover (_on_started_leading
                # discards it); the tile still binds — the fresh encoder's
                # bootstrap re-list covers its capacity
                if self._inc is not None:
                    self._inc.assume_assigned(enc, fl.pods, idx)
            except Exception:
                # the slow path inside assume_assigned is the robust one;
                # anything escaping means the ledger may be torn for this
                # tile — scheduling continues (the watch echo reconciles),
                # binds still commit
                logger.exception("assume_assigned failed")
            if on_committer:
                try:
                    self._commit(scheduled, inc_assumed=True)
                except Exception as e:
                    # same whole-tile error routing as _commit_loop's
                    # list path: error_func re-reads, bound pods drop out
                    logger.exception("tile commit failed")
                    for pod, _host in scheduled:
                        try:
                            self._error(pod, e)
                        except Exception:
                            pass
            else:
                self._commit_q.put(scheduled)
        finally:
            fl.landed.set()
        self._route_unscheduled(unscheduled)
        c.metrics.observe("scheduler_e2e_scheduling_latency_microseconds",
                          (time.monotonic() - fl.t_start) * 1e6)

    def _route_unscheduled(self, unscheduled: List[api.Pod]) -> None:
        """Per-pod robust: _finalize may run while a LATER tile is
        already dispatched and registered in _prev — an exception
        escaping here would be caught by schedule_tile's handler and
        error-requeue that tile's pods even though it still lands,
        double-processing them."""
        f = self.config.factory
        for pod in unscheduled:
            try:
                try:
                    if self._try_preempt(pod):
                        continue
                except Exception as e:
                    # the victim search failed (not "found nothing"):
                    # logged with its trace, and the pod takes the error
                    # path with that failure instead of a FitError
                    logger.exception("victim search failed")
                    self._fail_tile([pod], e)
                    continue
                err = FitError(pod, {})
                if f.recorder is not None:
                    f.recorder.eventf(pod, "Warning", "FailedScheduling",
                                      str(err))
                self._error(pod, err)
            except Exception:
                logger.exception("routing unscheduled pod failed")

    def _check_shards(self) -> None:
        """Shard-failure recovery, scheduler-thread only: poll the
        shard lease monitor; on expiry, fence the dead owner (CAS
        takeover advancing lease_transitions — a resurrecting owner
        loses every subsequent CAS), re-shard the slot mapping onto the
        survivors (encoder re-journals + re-epochs, engine rebuilds
        over the survivor mesh), and drop the in-flight tile — it was
        dispatched against the dead shard's epoch, so its assignments
        must never bind. Its pods requeue FIFO, the same immediate
        no-backoff path as the commit-time health gate, now at
        shard granularity."""
        from .device.shardfail import reshard_survivors
        c = self.config
        dead = c.shard_monitor.poll()
        if not dead:
            return
        res = reshard_survivors(dead, c.shard_monitor, encoder=self._inc,
                                engine=c.engine, metrics=c.metrics)
        if res is None:
            return  # every fence lost: the owners renewed after all
        logger.warning("shard(s) %s expired: fenced (terms %s), "
                       "re-sharded onto %d survivors, %d rows replayed",
                       res.dead, res.fence_terms, res.survivors,
                       res.replay_rows)
        fl = self._prev
        self._prev = None
        if fl is not None:
            try:
                for pod in fl.pods:
                    try:
                        self._requeue(pod, f"shard-{res.dead[0]}",
                                      "lease expired mid-tile")
                    except Exception:
                        logger.exception("requeue of %s failed",
                                         pod.metadata.name)
            finally:
                fl.landed.set()

    def _try_preempt(self, pod: api.Pod) -> bool:
        """Priority preemption for one unschedulable pod (selection
        rule + wrongful-eviction invariants in
        sched/preemption.py). Returns True when the pod was handled —
        requeued FIFO after evicting its victim set, after finding
        freed capacity, or while a prior round's victims drain — and
        False to fall through to the plain error path.

        Ordering invariant: the preemptor is NEVER bound here. It
        requeues FIFO and binds on a later tile, which only sees the
        victims' capacity once their DELETE echoes journal the release
        into the encoder — no optimistic double-booking. Evictions are
        uid-preconditioned graceful deletes (the eviction contract:
        Conflict means a same-name replacement won the name,
        NotFound means someone else finished the job), and the whole
        round is fenced on the shard-epoch vector captured with the
        victim table — a mid-preemption reshard drops the victim set
        instead of evicting against stale capacity.

        Only the encoder's cut is caught here: a victim search that
        fails (a refused kernel launch) raises to the caller."""
        c = self.config
        pre = c.preemption
        inc = self._inc
        if pre is None or inc is None:
            return False
        from .preemption import PreemptionDecision, preemptor_eligible
        if not preemptor_eligible(pod):
            # ports/volumes/affinity: predicates the victim search does
            # not model — preempting for this pod could be wrongful
            return False
        f = c.factory
        c.metrics.inc("preemption_attempts_total")
        try:
            table = inc.victim_table(pod)
        except (KeyError, ValueError):
            # the encoder's cut met a record it cannot read (a request
            # that does not parse, a ledger entry torn by a racing
            # event): no victim set for this pod, plain error path
            logger.exception("victim table cut failed")
            return False
        # nominated nodes have draining victims another preemptor
        # already claimed: masking them spreads a burst of preemptors
        # across distinct nodes instead of serializing one grace period
        # per pod on the argmax node. The pod's OWN nomination stays
        # visible (exclude_uid): its draining node re-selects the
        # identical victim set and the cooldown hold — not a second
        # eviction elsewhere — handles it
        nominated = pre.nominated_nodes(exclude_uid=pod.metadata.uid)
        masked = False
        if nominated:
            for j, nm in enumerate(table.node_names):
                if nm in nominated and table.cand[j]:
                    table.cand[j] = False
                    masked = True
        # the search itself is not caught: the JAX loop's catch-all here
        # would read a refused kernel launch as "no victim set". It
        # raises to _route_unscheduled, which routes the pod to the
        # error path with the failure
        res = c.engine.find_victims(table)
        if not res.feasible:
            if masked:
                # only the nomination mask stood between this pod and a
                # victim set: stay hot in the FIFO (priority pop keeps
                # the preemptor ahead of the batch backlog) instead of
                # paying the error path's escalating backoff while the
                # other preemptors' capacity frees
                self._requeue(pod, "mesh", "all victim nodes nominated")
                return True
            return False  # no victim set helps: plain error path
        node = table.node_names[res.pick]
        victims = res.victim_keys(table)
        if res.kstar <= 0 or not victims:
            # a feasible NON-preempting node exists right now (capacity
            # freed since the scan failed): wrongful-eviction rule 2
            # says never evict here — plain immediate requeue
            self._requeue(pod, node, "has free capacity; no preemption")
            return True
        vkey = pre.vset_key(node, victims)
        if pre.blocked(pod, vkey):
            # same victim set inside its cooldown window (a prior round
            # evicted it and the terminations haven't journaled, or a
            # delete lost a race): requeue FIFO, do NOT re-evict
            self._requeue(pod, node, "awaiting preempted capacity")
            return True
        if (table.encoder_id != inc.encoder_id
                or inc.shard_epochs() != table.shard_epochs):
            # reshard (or encoder swap) since the table was cut: the
            # victim set was computed against a dead shard's mapping
            self._requeue(pod, "mesh", "re-sharded during victim search")
            return True
        evicted = 0
        struck = False
        for ns, name, uid in victims:
            try:
                f.client.delete("pods", name, ns,
                                grace_period_seconds=(
                                    pre.grace_period_seconds),
                                uid=uid or None)
            except (NotFound, Conflict):
                # the victim moved under us — the remaining prefix was
                # chosen assuming this one's release, so stop the round
                struck = True
                break
            except Exception:
                struck = True
                break
            evicted += 1
            c.metrics.inc("preemption_victims_total")
        if f.recorder is not None:
            f.recorder.eventf(
                pod, "Normal", "Preempting",
                f"evicting {evicted}/{len(victims)} lower-priority "
                f"pods on {node}")
        pre.record(PreemptionDecision(
            pod_key=(pod.metadata.namespace, pod.metadata.name),
            pod_uid=pod.metadata.uid, prio=table.prio, node=node,
            pick=res.pick, kstar=res.kstar,
            score=int(res.node_score[res.pick]), victims=victims,
            table=table, state_epoch=table.state_epoch,
            shard_epochs=table.shard_epochs, evicted=evicted,
            t=pre.now()))
        if evicted:
            pre.nominate(node, uid=pod.metadata.uid)
        pre.hold(pod, vkey, escalate=struck)
        self._requeue(pod, node,
                      "victim moved; preemption cooling down" if struck
                      else f"preempted {evicted} pods; will bind after "
                           f"release is journaled")
        return True

    def _fail_tile(self, pods: List[api.Pod], e: Exception) -> None:
        """Encode/device failure: the tile is already drained from the
        FIFO, so every pod must take the error path (backoff+requeue)
        like the serial loop's algorithm failures (scheduler.go:129)."""
        f = self.config.factory
        for pod in pods:
            try:
                if f.recorder is not None:
                    f.recorder.eventf(pod, "Warning", "FailedScheduling",
                                      str(e))
                self._error(pod, e)
            except Exception:
                logger.exception("error-routing pod failed")

    def _target_alive(self, host: str) -> bool:
        """Is the bind target still a live node RIGHT NOW, per the node
        informer cache? The scan decided with encode-time knowledge; a
        node can go NotReady/Unknown, get cordoned, or vanish between
        scan and commit — binding to it anyway starts the bind -> evict
        -> recreate -> rebind-to-the-corpse loop the NodeController
        then has to fight."""
        cache = getattr(self.config.factory.node_lister, "cache", None)
        if cache is None:
            return True
        node = cache.get_by_key(host)
        return node is not None and node_schedulable(node)

    def _requeue(self, pod: api.Pod, host: str, reason: str) -> None:
        """Immediate requeue, no error backoff: the pod did nothing
        wrong — its target died (or a racing write collided) between
        scan and commit. The FIFO re-add re-schedules it against the
        post-death mask on the very next tile."""
        f = self.config.factory
        if f.recorder is not None:
            f.recorder.eventf(pod, "Normal", "SchedulingRequeued",
                              f"node {host} {reason}; pod requeued")
        self.config.metrics.inc("batch_commit_requeues_total")
        f.pod_queue.add(pod)

    def _bind_failed(self, pod: api.Pod, host: str, err: Exception) -> None:
        """A per-pod CAS bind was rejected. Re-read the pod: still
        unbound -> requeue it NOW for a fresh placement instead of
        paying the error path's 1s->60s backoff; already bound (a
        racing scheduler won) or deleted -> done is done; the re-read
        itself failing -> the classic error path (backoff + requeue)."""
        f = self.config.factory
        try:
            fresh = f.client.get("pods", pod.metadata.name,
                                 pod.metadata.namespace)
        except NotFound:
            return
        except Exception:
            self._error(pod, err)
            return
        if fresh.spec.node_name:
            return
        self._requeue(fresh, host, f"rejected the bind ({err})")

    def _commit(self, scheduled: List[Tuple[api.Pod, str]],
                inc_assumed: bool) -> None:
        """Bind a tile (batched CAS, per-pod fallback), record events,
        and assume into the modeler. The committer thread runs this
        lock-free (assume_pods takes the modeler lock once at the end;
        a confirm-reflector forget racing ahead of it wins via the
        modeler's tombstones); only the policy-engine path still wraps
        it in locked_action for snapshot ordering."""
        c = self.config
        f = c.factory
        # commit-time health gate: a target that went NotReady/Unknown,
        # cordoned, or deleted since the scan gets its pods requeued
        # rather than bound to a corpse (the incremental assume is
        # corrected by the watch echo once the pod binds elsewhere)
        live: List[Tuple[api.Pod, str]] = []
        for pod, host in scheduled:
            if self._target_alive(host):
                live.append((pod, host))
            else:
                try:
                    self._requeue(pod, host, "went unschedulable")
                except Exception:
                    logger.exception("requeue of %s failed",
                                     pod.metadata.name)
        scheduled = live
        # columnar commit: (ns, name, host) rows, no Binding carrier
        # objects on the hot path (client.bind_batch_hosts expands them
        # only for wire transports)
        rows = [(p.metadata.namespace, p.metadata.name, h)
                for p, h in scheduled]
        bind_start = time.monotonic()
        committed: List[bool] = [False] * len(rows)
        tr = obs.tracer()
        bind_span = obs.NOOP
        if tr.enabled and rows:
            # "bind" stage, tile-granular; installed as current context
            # so the client's http spans and the store's txn spans nest
            # under it
            bind_span = tr.start_span(
                "sched.bind", parent=obs.ctx_of(scheduled[0][0]),
                stage="bind", attrs={"pods": len(rows)}, start=bind_start)
        # whole-tile commit: the registry routes one multi-key
        # transaction per tile — one ledger-lock acquisition, one
        # publish fan-out — with all-or-nothing CAS semantics
        try:
            with obs.use(bind_span):
                try:
                    if rows:
                        f.client.bind_batch_hosts(rows)
                    committed = [True] * len(rows)
                except Exception:
                    # the tile's txn failed (e.g. a pod got bound by
                    # another scheduler mid-flight, a transient fault)
                    # and, all-or-nothing, committed nothing: commit it
                    # in halves, each one txn, down to per-pod CAS for
                    # the pods that conflict, so one conflict doesn't
                    # waste the rest (over HTTP a call a pod took
                    # minutes for a tile of thousands)
                    self._bind_halves(rows, scheduled, committed, 0,
                                      len(rows))
        finally:
            tr.end(bind_span)
        c.metrics.observe("binding_latency_microseconds",
                          (time.monotonic() - bind_start) * 1e6)
        to_assume = []
        for ok, (pod, host) in zip(committed, scheduled):
            if not ok:
                continue
            if f.recorder is not None:
                f.recorder.eventf(
                    pod, "Normal", "Scheduled",
                    f"Successfully assigned {pod.metadata.name} to {host}")
            assumed = api.fast_replace(
                pod, spec=api.fast_replace(pod.spec, node_name=host))
            to_assume.append(assumed)
            if self._inc is not None and not inc_assumed:
                # count the binding into the persistent device state
                # now; the watch echo dedupes via the ledger
                self._inc.assume(assumed)
        f.modeler.assume_pods(to_assume)

    def _bind_halves(self, rows: List[Tuple[str, str, str]],
                     scheduled: List[Tuple[api.Pod, str]],
                     committed: List[bool], lo: int, hi: int) -> None:
        """Commit rows[lo:hi], whose txn failed: commit each half as one
        txn and split again whichever fails, a level of halves at a time
        with the level's calls side by side (BIND_SPLIT_THREADS); a
        single row is one per-pod CAS whose failure routes the pod as the
        per-pod path always did. One conflict costs about 2 log2(rows)
        calls in about log2(rows) rounds; a failover's run of pods the
        dead leader bound costs a round a level, not a call a pod."""
        f = self.config.factory

        def one(i: int) -> None:
            ns, name, host = rows[i]
            try:
                f.client.bind(api.Binding(
                    metadata=api.ObjectMeta(namespace=ns, name=name),
                    target=api.ObjectReference(kind="Node", name=host)))
                committed[i] = True
            except Exception as e:
                pod = scheduled[i][0]
                if f.recorder is not None:
                    f.recorder.eventf(pod, "Normal", "FailedScheduling",
                                      f"Binding rejected: {e}")
                self._bind_failed(pod, host, e)

        def txn(r: Tuple[int, int]) -> bool:
            a, b = r
            try:
                f.client.bind_batch_hosts(rows[a:b])
            except Exception:
                return False
            committed[a:b] = [True] * (b - a)
            return True

        failed = [(lo, hi)]
        with ThreadPoolExecutor(BIND_SPLIT_THREADS,
                                thread_name_prefix="bind-split") as pool:
            while failed:
                halves = []
                for a, b in failed:
                    if b - a == 1:
                        halves.append((a, b))
                    else:
                        mid = (a + b) // 2
                        halves += [(a, mid), (mid, b)]
                singles = [a for a, b in halves if b - a == 1]
                batches = [r for r in halves if r[1] - r[0] > 1]
                ok = list(pool.map(txn, batches))
                list(pool.map(one, singles))
                failed = [r for r, good in zip(batches, ok) if not good]

    def _error(self, pod: api.Pod, err: Exception) -> None:
        self.config.factory.error_func(pod, err)
