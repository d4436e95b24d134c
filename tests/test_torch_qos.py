"""The port's QoS and retry copies (``dstack_tpu_torch.qos``,
``dstack_tpu_torch.qos.metrics``, ``dstack_tpu_torch.utils.retry``) against
the JAX package's on the same seeded inputs under one injected clock.

- ``TokenBucket`` and ``TenantBuckets`` (bounded tenants, idle eviction,
  the overflow bucket) behind ``edge_admit``: one seeded sequence of
  arrivals, costs, refunds and clock steps gives the same admit/shed
  decisions and ``Retry-After`` hints, the same per-run edge stats, the
  same decisions on a span's ``edge_admit`` events, and byte-identical
  QoS registries (``dtpu_qos_*``); a ``serve.admit`` fault plan sheds
  alike in both.
- ``PriorityPending``: the same pushes, admission walks with a charging
  predicate, drains and cancellations pop the same items in the same
  order.
- ``QoSPolicy.from_env``/``from_spec``, the priority classes, the headers
  and ``tenant_from_headers`` agree.
- ``Deadline.remaining()``, ``expired()`` and ``clamp()`` agree under the
  same monotonic clock; ``RetryPolicy`` gives the same schedule from the
  same seeded ``random.Random``; ``retry_sync`` under a fake sleep retries
  the same way and the retry registries render alike.
"""

import random
import time

import numpy as np
import pytest

from dstack_tpu import faults as jfaults
from dstack_tpu import qos as jqos
from dstack_tpu.qos import metrics as jqm
from dstack_tpu.utils import retry as jretry
from dstack_tpu_torch import faults as tfaults
from dstack_tpu_torch import qos as tqos
from dstack_tpu_torch.qos import metrics as tqm
from dstack_tpu_torch.utils import retry as tretry

PAIRS = ((jqos, jqm, jfaults), (tqos, tqm, tfaults))


@pytest.fixture(autouse=True)
def _fresh_globals():
    """Each package's QoS registry and edge stats start empty; no plan."""
    for qos, qm, faults in PAIRS:
        qm._registry = None
        qos.reset_edge_stats()
        faults.clear()
    yield
    for qos, qm, faults in PAIRS:
        qm._registry = None
        qos.reset_edge_stats()
        faults.clear()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class _Span:
    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))


def _admissions(qos, seed: int, plan=None, faults=None) -> tuple:
    rng = np.random.default_rng(seed)
    clock = _Clock()
    policy = qos.QoSPolicy(rps=float(rng.uniform(0.5, 4)), burst=float(rng.integers(0, 6)),
                           max_tenants=4)
    buckets = qos.TenantBuckets(policy.rps, policy.effective_burst(), max_tenants=policy.max_tenants,
                                clock=clock)
    if plan is not None:
        faults.install_plan(plan)
    span = _Span()
    out = []
    tenants = [f"t{i}" for i in range(7)]
    for i in range(300):
        clock.t += float(rng.exponential(0.2))
        tenant = tenants[int(rng.integers(0, len(tenants)))]
        cost = float(rng.choice([1.0, 1.0, 1.0, 2.0, 3.0]))
        hint = qos.edge_admit(policy, buckets, tenant, run_name="tiny", fault_point="serve.admit",
                              cost=cost, span=span if i % 3 == 0 else None)
        if hint is None and rng.random() < 0.15:
            buckets.bucket(tenant).refund(1.0)
        out.append((tenant, cost, hint, round(buckets.bucket(tenant).tokens, 12)))
    faults.clear() if faults is not None else None
    return out, span.events, qos.run_edge_snapshot("", "tiny"), sorted(buckets._buckets)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_admit_decisions_and_registry_match_jax(seed):
    (jout, jev, jstats, jkeys), (tout, tev, tstats, tkeys) = (_admissions(q, seed) for q, _, _ in PAIRS)
    assert tout == jout and tev == jev and tkeys == jkeys
    assert {k: v for k, v in tstats.items() if k != "last_shed_at"} == {
        k: v for k, v in jstats.items() if k != "last_shed_at"}
    assert any(h is not None for _, _, h, _ in tout) and any(h is None for _, _, h, _ in tout)
    assert tqm.get_qos_registry().render() == jqm.get_qos_registry().render()


def test_a_serve_admit_plan_sheds_alike():
    plan = {"seed": 3, "rules": [{"point": "serve.admit", "action": "raise", "error": "http:429",
                                  "retry_after": 2.5, "prob": 0.3}]}
    got = [_admissions(q, 5, plan=plan, faults=f)[:2] for q, _, f in PAIRS]
    assert got[1] == got[0]
    assert any(ev[1].get("injected") for ev in got[1][1])
    assert tqm.get_qos_registry().render() == jqm.get_qos_registry().render()


class _Item:
    def __init__(self, i, tenant, prio):
        self.i, self.tenant, self.prio, self.cancelled = i, tenant, prio, False


@pytest.mark.parametrize("seed", [0, 1])
def test_priority_pending_order_matches_jax(seed):
    logs = []
    for qos, _, _ in PAIRS:
        rng = np.random.default_rng(seed)
        q = qos.PriorityPending()
        items = {}
        log = []
        for step in range(60):
            for _ in range(int(rng.integers(0, 4))):
                it = _Item(len(items), f"t{int(rng.integers(0, 3))}",
                           qos.parse_priority_class(["interactive", "standard", "batch", "bogus", None][
                               int(rng.integers(0, 5))]))
                items[it.i] = it
                q.push(it, it.prio)
            for it in items.values():
                if rng.random() < 0.03:
                    it.cancelled = True
            cap = int(rng.integers(1, 3))
            held: dict = {}

            def charge(r, held=held, cap=cap):
                if held.get(r.tenant, 0) >= cap:
                    return False
                held[r.tenant] = held.get(r.tenant, 0) + 1
                return True

            got = q.pop_admissible_many(int(rng.integers(0, 4)), charge, discard=lambda r: r.cancelled)
            drained = q.drain_matching(lambda r: r.i % 11 == step % 11) if step % 7 == 0 else []
            log.append(([r.i for r in got], [r.i for r in drained], q.qsize(),
                        q.any_admissible(lambda r: r.tenant == "t0", discard=lambda r: r.cancelled)))
        logs.append(log)
    assert logs[1] == logs[0]


def test_policy_headers_and_tenants_match_jax(monkeypatch):
    assert (tqos.TENANT_HEADER, tqos.PRIORITY_HEADER, tqos.RESUME_HEADER, tqos.DEADLINE_HEADER,
            tqos.ANONYMOUS_TENANT) == (jqos.TENANT_HEADER, jqos.PRIORITY_HEADER, jqos.RESUME_HEADER,
                                       jqos.DEADLINE_HEADER, jqos.ANONYMOUS_TENANT)
    assert [tqos.PRIORITY_INTERACTIVE, tqos.PRIORITY_STANDARD, tqos.PRIORITY_BATCH] == [
        jqos.PRIORITY_INTERACTIVE, jqos.PRIORITY_STANDARD, jqos.PRIORITY_BATCH]
    for v in ["interactive", "BATCH", " standard ", "x", None, 3]:
        assert tqos.parse_priority_class(v) == jqos.parse_priority_class(v)
    for r in range(-1, 4):
        assert tqos.priority_class_name(r) == jqos.priority_class_name(r)
    for env in [{}, {"DTPU_QOS_RPS": "2.5", "DTPU_QOS_BURST": "4", "DTPU_QOS_TENANT_INFLIGHT": "2"},
                {"DTPU_QOS_RPS": "bad", "DTPU_QOS_MAX_TENANTS": "0"}]:
        for k in ("DTPU_QOS_RPS", "DTPU_QOS_BURST", "DTPU_QOS_TENANT_INFLIGHT", "DTPU_QOS_MAX_TENANTS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        t, j = tqos.QoSPolicy.from_env(), jqos.QoSPolicy.from_env()
        assert (t.rps, t.burst, t.tenant_inflight, t.max_tenants, t.enabled, t.effective_burst(), t.env()) == (
            j.rps, j.burst, j.tenant_inflight, j.max_tenants, j.enabled, j.effective_burst(), j.env())
    for spec in [None, {"rps": 3}, {"rps": "x"}, {"rps": 1, "burst": 2, "tenant_inflight": 1}]:
        assert tqos.QoSPolicy.from_spec(spec).env() == jqos.QoSPolicy.from_spec(spec).env()
    for h in [{}, {"X-DTPU-Tenant": "acme"}, {"X-DTPU-Tenant": "x" * 99}, {"Authorization": "Bearer k"}]:
        for trust in (True, False):
            assert tqos.tenant_from_headers(h, trust) == jqos.tenant_from_headers(h, trust)


def test_deadline_agrees_under_one_clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    for seconds in (None, 0.0, 0.5, 3.0):
        j, t = jretry.Deadline(seconds), tretry.Deadline(seconds)
        for dt in (0.0, 0.25, 0.3, 2.0, 1.0):
            clock.t += dt
            assert (t.remaining(), t.expired(), t.clamp(0.7)) == (j.remaining(), j.expired(), j.clamp(0.7))
        if seconds is not None:
            with pytest.raises(tretry.DeadlineExceeded, match="x: deadline exceeded"):
                t.check("x")
    assert issubclass(tretry.DeadlineExceeded, TimeoutError)


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_schedule_and_registry_match_jax(seed):
    pol = dict(max_attempts=6, base_delay=0.25, max_delay=3.0, multiplier=2.5, jitter=0.3)
    assert list(tretry.RetryPolicy(**pol).schedule(random.Random(seed))) == list(
        jretry.RetryPolicy(**pol).schedule(random.Random(seed)))
    for mod in (jretry, tretry):
        mod._registry = None
    runs = []
    for mod, faults in ((jretry, jfaults), (tretry, tfaults)):
        sleeps, calls = [], []

        def flaky(mod=mod, calls=calls, faults=faults):
            calls.append(1)
            if len(calls) < 4:
                raise faults.InjectedHTTPError(503 if len(calls) % 2 else 429,
                                               retry_after=0.5 if len(calls) == 2 else None)
            return "done"

        out = mod.retry_sync(flaky, site="test", policy=mod.RetryPolicy(**pol), rng=random.Random(seed),
                             sleep=sleeps.append)
        runs.append((out, sleeps))
        for exc in (faults.InjectedHTTPError(429, retry_after=2), ConnectionError(), ValueError(),
                    mod.DeadlineExceeded("x"), TimeoutError()):
            runs[-1] += (mod.default_should_retry(exc), mod.retry_after_hint(exc))
    assert runs[1] == runs[0]
    assert tretry.get_retry_registry().render() == jretry.get_retry_registry().render()
