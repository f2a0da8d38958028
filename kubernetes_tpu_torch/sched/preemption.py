"""Priority preemption: the serial oracle and the eviction-pass state.

When a pending high-priority pod is infeasible on every node, the
scheduler may evict strictly-lower-priority pods to make room (the
reference models this as PriorityClass + nominatedNodeName,
scheduler/algorithm/preemption — DIVERGENCES #35). The selection rule,
shared verbatim by this serial oracle and the device kernel
(device/victim_kernel.py, run by engine.BatchEngine.find_victims), is:

  * candidate nodes: live, schedulable, selector/host-matching, and NOT
    carrying resource-exceeding pods (on a non-exceed node every counted
    pod contributes its full request, so releasing a victim releases
    exactly its recorded request — no misfit bookkeeping on the search
    path);
  * victims on a node: counted pods with priority strictly below the
    preemptor's, ordered (priority asc, insertion asc) — the eviction
    set is always a PREFIX of that order, so per-node search reduces to
    prefix sums of released cpu/mem;
  * per node, k* = the minimal prefix length whose release makes the
    preemptor feasible under the engine's exact predicate forms
    (fits_count = pod_count - k < pod_cap, zero-cap cpu/mem = unlimited,
    zero-request pods check only the count);
  * across nodes: fewest evictions first, then lowest senior victim
    priority (the largest priority in the evicted prefix), final tie by
    the engine's tie_rank — encoded as one injective int64 composite so
    host argmax (oracle) and device argmax agree bit-for-bit.

k* == 0 at the pick means a feasible non-preempting node exists: the
caller must NOT evict (wrongful-eviction rule 2) and simply requeues.

Preemptors are restricted to the flag-free subset (no host ports, no
volumes, no affinity): those are the predicates the victim search does
not model, so restricting the preemptor keeps the oracle exact instead
of approximately-right.

Everything here is deterministic: the eviction-pass backoff draws from
one seeded stream (f"{seed}:preemption") and reads time from an
injectable Clock.

The port's copy of the JAX package's sched/preemption.py.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import types as api
from ..utils.clock import Clock, REAL

# priority bound (|p| <= PMAX, enforced by registry validation): keeps
# the composite victim score exact in int64 at every supported shape
PMAX = 1_000_000_000
# senior-victim sentinel for k*=0 (no evictions): beats every real
# priority, so "evict nobody" always outranks "evict somebody" at equal
# eviction counts
SENIOR_NONE = -PMAX - 1
# per-eviction-count stride of the composite score: wider than the
# (PMAX - senior) term's full range [0, 2*PMAX+1]
SCORE_STRIDE = 2 * PMAX + 2


def composite_score(n: int, v: int, kstar: int, senior: int,
                    tie_rank: int) -> int:
    """The injective node-choice score (python ints — exact): fewest
    evictions, then lowest senior victim priority, then tie_rank."""
    return ((v - kstar) * SCORE_STRIDE + (PMAX - senior)) * n + tie_rank


def preemptor_eligible(pod: api.Pod) -> bool:
    """Flag-free preemptors only: the victim search models counts and
    cpu/mem plus the static node masks — a preemptor relying on host
    ports, volumes (disk conflicts) or affinity would need predicates
    the search doesn't evaluate, so it skips preemption entirely."""
    sp = pod.spec
    if sp.affinity is not None:
        return False
    if sp.volumes:
        return False
    for c in sp.containers:
        for p in c.ports:
            if p.host_port:
                return False
    return True


@dataclass
class VictimTable:
    """Host snapshot of the preemption search inputs for ONE preemptor:
    per-node State columns plus the per-node victim prefix arrays
    ((priority asc, insertion asc) order, padded to v_pad). Built under
    the encoder lock (IncrementalEncoder.victim_table) so the columns,
    the victim identities and the fencing epochs are one consistent
    cut; both the oracle and the device kernel read only this."""
    pod_key: Tuple[str, str]              # (namespace, name)
    pod_uid: str
    prio: int
    req_cpu: int
    req_mem: int
    zero_req: bool
    cand: np.ndarray                      # bool [N] candidate-node mask
    cpu_cap: np.ndarray                   # i64 [N] (0 = unlimited)
    mem_cap: np.ndarray                   # i64 [N] (0 = unlimited)
    pod_cap: np.ndarray                   # i64 [N]
    cpu_used: np.ndarray                  # i64 [N]
    mem_used: np.ndarray                  # i64 [N]
    pod_count: np.ndarray                 # i64 [N]
    tie_rank: np.ndarray                  # i64 [N] (injective)
    v_prio: np.ndarray                    # i64 [N, V] (pad: PMAX+1)
    v_cpu: np.ndarray                     # i64 [N, V] (pad: 0)
    v_mem: np.ndarray                     # i64 [N, V] (pad: 0)
    v_valid: np.ndarray                   # bool [N, V]
    victims: List[List[Tuple[str, str, str]]]  # per node [(ns, name, uid)]
    node_names: List[str]
    # fencing metadata: a reshard or encoder swap after this snapshot
    # invalidates the victim set (batch.py re-checks before evicting)
    state_epoch: int = 0
    shard_epochs: Optional[Tuple[int, ...]] = None
    encoder_id: int = 0

    @property
    def n(self) -> int:
        return int(self.cand.shape[0])

    @property
    def v(self) -> int:
        return int(self.v_prio.shape[1])


@dataclass
class OracleResult:
    pick: int                 # chosen node slot (np.argmax convention)
    kstar: int                # evictions at the pick (0 = none needed)
    feasible: bool            # False: no victim set makes the pod fit
    node_kstar: np.ndarray    # i64 [N] per-node minimal eviction count
    node_score: np.ndarray    # i64 [N] composite (-1 = infeasible)

    def victim_keys(self, t: VictimTable) -> List[Tuple[str, str, str]]:
        if not self.feasible or self.kstar <= 0:
            return []
        return list(t.victims[self.pick][: self.kstar])


def oracle_find_victims(t: VictimTable) -> OracleResult:
    """The correctness truth: plain-python exact-int replay of the
    selection rule. The device kernel must be bit-equal to this at
    every shape (tests/test_torch_preemption.py)."""
    n, v = t.n, t.v
    node_kstar = np.zeros(n, dtype=np.int64)
    node_score = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        if not bool(t.cand[j]):
            continue
        vm = t.v_valid[j] & (t.v_prio[j] < t.prio)
        nv = int(vm.sum())
        pc = int(t.pod_count[j])
        pcap = int(t.pod_cap[j])
        cc, mc = int(t.cpu_cap[j]), int(t.mem_cap[j])
        cu, mu = int(t.cpu_used[j]), int(t.mem_used[j])
        released_c = released_m = 0
        found = -1
        for k in range(nv + 1):
            if k > 0:
                released_c += int(t.v_cpu[j][k - 1])
                released_m += int(t.v_mem[j][k - 1])
            fits_count = (pc - k) < pcap
            if t.zero_req:
                ok = fits_count
            else:
                free_cpu = cc == 0 or cc - (cu - released_c) >= t.req_cpu
                free_mem = mc == 0 or mc - (mu - released_m) >= t.req_mem
                ok = fits_count and free_cpu and free_mem
            if ok:
                found = k
                break
        if found < 0:
            continue
        node_kstar[j] = found
        senior = int(t.v_prio[j][found - 1]) if found > 0 else SENIOR_NONE
        node_score[j] = composite_score(n, v, found, senior,
                                        int(t.tie_rank[j]))
    pick = int(np.argmax(node_score))  # first-max, like jnp.argmax
    return OracleResult(pick=pick, kstar=int(node_kstar[pick]),
                        feasible=bool(node_score[pick] >= 0),
                        node_kstar=node_kstar, node_score=node_score)


@dataclass
class PreemptionDecision:
    """One live eviction decision, recorded with the exact table it was
    computed from — the post-hoc audit replays the oracle over it."""
    pod_key: Tuple[str, str]
    pod_uid: str
    prio: int
    node: str
    pick: int
    kstar: int
    score: int
    victims: List[Tuple[str, str, str]]   # (ns, name, uid) chosen prefix
    table: VictimTable
    state_epoch: int
    shard_epochs: Optional[Tuple[int, ...]]
    # how many of `victims` were actually deleted (a Conflict/NotFound
    # strike stops the round early; the deleted ones are by construction
    # a prefix of the chosen — and audited — set)
    evicted: int = 0
    t: float = 0.0                        # pass clock, monotonic


def audit_decision(d: PreemptionDecision) -> List[str]:
    """Post-hoc wrongful-eviction audit: replay the serial oracle over
    the decision's recorded table. Returns violation strings (empty =
    clean). Checks, in order: device/oracle agreement, the never-evict-
    >=-priority invariant, and the never-evict-when-a-non-preempting-
    node-existed invariant."""
    out: List[str] = []
    o = oracle_find_victims(d.table)
    if not o.feasible:
        out.append(f"{d.pod_key}: oracle found NO feasible victim set "
                   f"but node {d.node} was preempted")
        return out
    if (o.pick, o.kstar) != (d.pick, d.kstar):
        out.append(f"{d.pod_key}: device picked node {d.pick} k={d.kstar}"
                   f", oracle node {o.pick} k={o.kstar}")
    if o.kstar == 0 and d.victims:
        out.append(f"{d.pod_key}: feasible non-preempting node "
                   f"{d.table.node_names[o.pick]} existed, yet "
                   f"{len(d.victims)} pods were evicted")
    want = o.victim_keys(d.table)
    if list(d.victims) != want:
        out.append(f"{d.pod_key}: victim set {d.victims} != oracle "
                   f"prefix {want}")
    vp = d.table.v_prio[d.pick]
    for i in range(min(d.kstar, d.table.v)):
        if int(vp[i]) >= d.prio:
            out.append(f"{d.pod_key}: victim {d.victims[i] if i < len(d.victims) else i} "
                       f"priority {int(vp[i])} >= preemptor {d.prio}")
    return out


class PreemptionPass:
    """Per-scheduler eviction-pass state: the seeded cooldown/backoff
    that prevents eviction storms, and the decision log the soak audits.

    A preemptor whose victim delete hits Conflict/NotFound (the eviction
    contract: a same-name replacement won the name, or someone else
    already deleted the victim) is requeued FIFO and must NOT re-select
    the SAME victim set until a cooldown expires — capped jittered
    exponential backoff off one seeded stream, time from the injected
    Clock. A successful eviction round registers the same hold (flat,
    no escalation) so retries while the victims drain don't re-delete
    them; once the victims actually terminate the recomputed set
    differs and the hold no longer applies.

    A successful round also NOMINATES its node for a short TTL: while
    the victims drain (their resources still counted in the encoder),
    a second preemptor's victim search would see the identical table,
    pick the identical node, and the flash crowd would serialize one
    grace period per pod. Masking nominated nodes out of later
    searches spreads concurrent preemptors across distinct nodes — the
    reference's nominatedNodeName, reduced to one nomination per node
    (see DIVERGENCES #35). Normal (non-preempting) scheduling is
    unaffected; the mask only narrows victim searches.
    """

    def __init__(self, seed: int = 0, clock: Optional[Clock] = None,
                 cooldown_base: float = 0.25, cooldown_cap: float = 8.0,
                 grace_period_seconds: int = 1,
                 nominate_ttl: Optional[float] = None):
        self._rng = random.Random(f"{seed}:preemption")
        self._clock = clock or REAL
        self.cooldown_base = cooldown_base
        self.cooldown_cap = cooldown_cap
        self.grace_period_seconds = grace_period_seconds
        # long enough for the victims' graceful deletes to journal
        # their release, short enough that a stuck drain frees the
        # node for a fresh search
        self.nominate_ttl = (grace_period_seconds + 2.0
                             if nominate_ttl is None else nominate_ttl)
        # preemptor uid -> (hold-until monotonic, strikes, victim-set key)
        self._cool: Dict[str, Tuple[float, int, Any]] = {}
        # node name -> (nomination expiry monotonic, nominator uid)
        self._nominated: Dict[str, Tuple[float, str]] = {}
        self.decisions: List[PreemptionDecision] = []

    @staticmethod
    def vset_key(node: str, victims: Sequence[Tuple[str, str, str]]) -> Any:
        return (node, tuple(uid for _, _, uid in victims))

    def now(self) -> float:
        return self._clock.monotonic()

    def blocked(self, pod: api.Pod, vset_key: Any) -> bool:
        """Is this (preemptor, victim set) inside its cooldown window?
        A DIFFERENT victim set is never blocked — the cluster moved."""
        ent = self._cool.get(pod.metadata.uid)
        if ent is None or ent[2] != vset_key:
            return False
        return self.now() < ent[0]

    def hold(self, pod: api.Pod, vset_key: Any, escalate: bool) -> float:
        """Register a cooldown for this victim set; escalate=True (a
        Conflict/NotFound strike) doubles the window up to the cap,
        escalate=False (successful eviction round) keeps it flat."""
        prev = self._cool.get(pod.metadata.uid)
        strikes = 0
        if escalate:
            strikes = (prev[1] + 1) if prev is not None else 1
        window = min(self.cooldown_cap,
                     self.cooldown_base * (2.0 ** strikes))
        window *= 0.5 + 0.5 * self._rng.random()  # jitter, seeded
        self._cool[pod.metadata.uid] = (self.now() + window, strikes,
                                        vset_key)
        return window

    def nominate(self, node: str, uid: str = "",
                 ttl: Optional[float] = None) -> None:
        """Claim a node's draining capacity for one preemptor (uid)."""
        self._nominated[node] = (self.now() + (
            self.nominate_ttl if ttl is None else ttl), uid)

    def nominated_nodes(self, exclude_uid: Optional[str] = None
                        ) -> Set[str]:
        """Live nominations by OTHER preemptors (expired ones pruned) —
        the victim search masks these out of its candidate set. A pod's
        OWN nominated node stays visible to it: while its victims drain
        the recomputed set is identical, so the cooldown hold (not a
        fresh eviction) is what fires — masking it instead would push
        the pod onto a second node and cascade wasted evictions."""
        now = self.now()
        self._nominated = {n: e for n, e in self._nominated.items()
                           if e[0] > now}
        return {n for n, (_, uid) in self._nominated.items()
                if exclude_uid is None or uid != exclude_uid}

    def record(self, d: PreemptionDecision) -> None:
        self.decisions.append(d)

    def audit(self) -> List[str]:
        """Replay every recorded decision through the serial oracle."""
        out: List[str] = []
        for d in self.decisions:
            out.extend(audit_decision(d))
        return out
