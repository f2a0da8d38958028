"""The port's lease-based leader election
(kubernetes_tpu_torch/utils/leaderelection.py, a copy of the JAX
package's over the port's core, clock and metrics): the JAX package's
test_leaderelection.py gates, run against the port's modules, and one
lock-step check that both packages write the same lease records."""

import threading
import time

import pytest

from kubernetes_tpu_torch.api.client import Client, InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.core.errors import Conflict
from kubernetes_tpu_torch.utils.clock import FakeClock
from kubernetes_tpu_torch.utils.leaderelection import (LeaderElectionConfig,
                                                 LeaderElector)
from kubernetes_tpu_torch.utils.metrics import MetricsRegistry

from kubernetes_tpu.api.client import InProcClient as JaxInProcClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.utils.clock import FakeClock as JaxFakeClock
from kubernetes_tpu.utils.leaderelection import (
    LeaderElectionConfig as JaxLeaderElectionConfig,
    LeaderElector as JaxLeaderElector)


def make_pair(client, clock, **kw):
    def cfg(ident):
        return LeaderElectionConfig(
            lease_name=kw.get("lease_name", "test-lease"),
            identity=ident, lease_duration=kw.get("lease_duration", 10.0),
            renew_deadline=kw.get("renew_deadline", 6.0),
            retry_period=kw.get("retry_period", 1.0), clock=clock)
    return (LeaderElector(client, cfg("a")),
            LeaderElector(client, cfg("b")))


def holder(client, name="test-lease"):
    lease = client.get("leases", name, "kube-system")
    return lease.spec.holder_identity, lease.spec.lease_transitions


@pytest.mark.durability
class TestLeaseCas:
    def test_cas_race_table_one_winner_per_term(self):
        """The acceptance table: at every phase of an acquire/renew/
        expire/takeover script, exactly one elector holds the lease
        and the fencing term moves only on holder CHANGES."""
        client = InProcClient(Registry())
        clk = FakeClock()
        a, b = make_pair(client, clk)
        script = [
            # (step time, expected (winner, holder-on-record, term))
            ("both try: first creator wins, second loses the race",
             0, True, False, ("a", 1)),
            ("holder renews, challenger still fenced out",
             5, True, False, ("a", 1)),
            ("nothing expired yet: challenger keeps losing",
             4, True, False, ("a", 1)),  # 9s since b's last observation
        ]
        for desc, step, want_a, want_b, want_rec in script:
            clk.step(step)
            got_a = a.try_acquire_or_renew()
            got_b = b.try_acquire_or_renew()
            assert (got_a, got_b) == (want_a, want_b), desc
            assert holder(client) == want_rec, desc
        # a's record stops moving; past lease_duration on b's monotonic
        # clock, b takes over under a NEW term
        clk.step(11)
        assert b.try_acquire_or_renew()
        assert holder(client) == ("b", 2)
        assert b.term == 2
        # the deposed leader immediately loses the CAS (stale rv)
        assert not a.try_acquire_or_renew()
        assert holder(client) == ("b", 2)

    def test_two_electors_racing_same_expired_lease_one_cas_winner(self):
        """Both candidates observe the same dead holder and race the
        SAME resourceVersion: the store's CAS admits exactly one."""
        registry = Registry()
        client = InProcClient(registry)
        clk = FakeClock()
        a, b = make_pair(client, clk)
        assert a.try_acquire_or_renew()
        clk.step(11)  # a's lease expires on everyone's clock
        # drive both CAS attempts against the same observed record
        results = {}
        barrier = threading.Barrier(2)

        def race(name, el):
            el.try_acquire_or_renew()  # observe the stale record
            barrier.wait()
            results[name] = el.try_acquire_or_renew()

        # reset a's self-view so it must CAS like a challenger: kill its
        # identity advantage by making it contend for b's expired lease
        clk.step(11)
        ts = [threading.Thread(target=race, args=(n, e))
              for n, e in (("a", a), ("b", b))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        rec_holder, term = holder(client)
        # exactly one elector may believe it leads this term
        winners = [n for n, ok in results.items() if ok]
        assert len(winners) <= 1
        assert rec_holder in ("a", "b")

    def test_update_with_stale_rv_conflicts(self):
        """The primitive the elector stands on: a PUT carrying an old
        resourceVersion loses."""
        from dataclasses import replace

        from kubernetes_tpu_torch.core import types as api
        client = InProcClient(Registry())
        lease = client.create("leases", api.Lease(
            metadata=api.ObjectMeta(name="l", namespace="kube-system"),
            spec=api.LeaseSpec(holder_identity="x")), "kube-system")
        client.update("leases", replace(
            lease, spec=replace(lease.spec, holder_identity="y")),
            "kube-system")
        with pytest.raises(Conflict):
            client.update("leases", replace(
                lease, spec=replace(lease.spec, holder_identity="z")),
                "kube-system")


@pytest.mark.durability
class TestMonotonicDeadlines:
    def test_backwards_wall_jump_does_not_extend_leadership(self):
        """Regression (satellite 2): a backwards time.time() step must
        not let a dead leader fence out its successor — expiry runs on
        the monotonic axis."""
        client = InProcClient(Registry())
        clk = FakeClock()
        a, b = make_pair(client, clk)
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
        # the wall clock leaps a day backwards; a is dead (no renewals)
        clk.jump_wall(-86400.0)
        clk.step(11)  # monotonic time passes the lease duration
        assert b.try_acquire_or_renew(), \
            "wall jump must not extend the dead leader's lease"
        assert b.term == 2

    def test_backwards_wall_jump_does_not_drop_leadership(self):
        """...and the inverse: the holder keeps renewing across the
        jump, so the challenger never gets in."""
        client = InProcClient(Registry())
        clk = FakeClock()
        a, b = make_pair(client, clk)
        assert a.try_acquire_or_renew()
        for _ in range(4):
            clk.step(5)              # well inside the lease each time
            clk.jump_wall(-3600.0)   # wall reads nonsense throughout
            assert a.try_acquire_or_renew()   # renewal still lands
            assert not b.try_acquire_or_renew(), \
                "live renewals must fence the challenger regardless " \
                "of wall time"
        assert holder(client)[1] == 1  # never a transition

    def test_forward_wall_jump_does_not_expire_live_leader(self):
        client = InProcClient(Registry())
        clk = FakeClock()
        a, b = make_pair(client, clk)
        assert a.try_acquire_or_renew()
        clk.jump_wall(+86400.0)  # renewTime strings look ancient now
        clk.step(2)
        assert not b.try_acquire_or_renew(), \
            "forward wall jump must not expire a live lease"


class _FlakyClient(Client):
    """Delegating client whose lease writes can be switched to fail —
    the renewal-outage simulator."""

    def __init__(self, inner):
        self.inner = inner
        self.fail = False

    def update(self, *a, **kw):
        if self.fail:
            raise ConnectionError("injected renewal outage")
        return self.inner.update(*a, **kw)

    def get(self, *a, **kw):
        return self.inner.get(*a, **kw)

    def create(self, *a, **kw):
        if self.fail:
            raise ConnectionError("injected renewal outage")
        return self.inner.create(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.durability
class TestElectorLoop:
    def test_renew_deadline_demotes_and_standby_takes_over(self):
        """The live loop: the leader's renewals start failing; it steps
        down within renew_deadline (before the lease can expire for
        the standby) and the standby acquires under a new term."""
        registry = Registry()
        flaky = _FlakyClient(InProcClient(registry))
        metrics = MetricsRegistry()
        events = []

        def cfg(ident, client):
            return LeaderElectionConfig(
                lease_name="loop", identity=ident,
                lease_duration=0.6, renew_deadline=0.35,
                retry_period=0.05)

        a = LeaderElector(flaky, cfg("a", flaky),
                          on_started_leading=lambda t: events.append(
                              ("a-up", t)),
                          on_stopped_leading=lambda: events.append(
                              ("a-down",)),
                          metrics=metrics)
        b = LeaderElector(InProcClient(registry), cfg("b", None),
                          on_started_leading=lambda t: events.append(
                              ("b-up", t)),
                          metrics=metrics)
        a.run()
        deadline = time.time() + 5
        while not a.is_leader and time.time() < deadline:
            time.sleep(0.01)
        assert a.is_leader
        b.run()
        time.sleep(0.2)
        assert not b.is_leader
        flaky.fail = True  # the outage
        deadline = time.time() + 10
        while (not b.is_leader or a.is_leader) and time.time() < deadline:
            time.sleep(0.02)
        try:
            assert not a.is_leader, "leader must demote on renew deadline"
            assert b.is_leader, "standby must take over after expiry"
            assert b.term == 2
            assert ("a-down",) in events
            assert ("b-up", 2) in events
            assert metrics.counter_sum("lease_renew_failures_total") >= 1
            assert metrics.counter_sum("leader_transitions_total") >= 2
        finally:
            a.stop()
            b.stop()

    def test_stop_releases_for_immediate_handoff(self):
        registry = Registry()
        client = InProcClient(registry)
        a, b = make_pair(client, FakeClock(),
                         lease_name="handoff")
        assert a.try_acquire_or_renew()
        a.stop(release=True)  # voluntary shutdown: holder cleared
        lease = client.get("leases", "handoff", "kube-system")
        assert lease.spec.holder_identity == ""
        # the standby acquires with NO lease-duration wait
        assert b.try_acquire_or_renew()
        assert b.term == 2

    def test_kill_keeps_the_lease_until_expiry(self):
        """Simulated crash: no release — the successor must wait out
        the lease exactly as after a real process death."""
        client = InProcClient(Registry())
        clk = FakeClock()
        a, b = make_pair(client, clk, lease_name="crash")
        assert a.try_acquire_or_renew()
        a.kill()
        assert not a.is_leader
        lease = client.get("leases", "crash", "kube-system")
        assert lease.spec.holder_identity == "a"  # still on record
        assert not b.try_acquire_or_renew()       # fenced until expiry
        clk.step(11)
        assert b.try_acquire_or_renew()
        assert b.term == 2


@pytest.mark.durability
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lease_records_match_jax(seed):
    """Both packages' electors, driven by one seeded script of clock
    steps, tries, kills and releases over their own in-proc apiservers,
    win and lose alike and leave the same (holder, term) on record."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sides = []
    for client, clock, cfg, elector in (
            (JaxInProcClient(JaxRegistry()), JaxFakeClock(),
             JaxLeaderElectionConfig, JaxLeaderElector),
            (InProcClient(Registry()), FakeClock(), LeaderElectionConfig,
             LeaderElector)):
        els = [elector(client, cfg(lease_name="lock-step", identity=i,
                                   lease_duration=4.0, renew_deadline=3.0,
                                   retry_period=1.0, clock=clock))
               for i in ("a", "b", "c")]
        sides.append((client, clock, els))
    for _ in range(60):
        op, who = int(rng.integers(4)), int(rng.integers(3))
        step = float(rng.integers(0, 3))
        release = bool(rng.integers(2))
        got = []
        for client, clock, els in sides:
            clock.step(step)
            if op == 3:
                els[who].stop(release=release)
                won = None
            else:
                won = els[who].try_acquire_or_renew()
            try:
                rec = holder(client, "lock-step")
            except Exception as e:      # no lease yet: both must agree
                rec = type(e).__name__
            got.append((won, rec))
        assert got[0] == got[1]
