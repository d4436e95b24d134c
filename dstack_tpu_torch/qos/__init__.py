"""Multi-tenant QoS: admission control, priority, and overload isolation
(own copy of ``dstack_tpu.qos``, no JAX import; the port's server is its
only admission edge so far: the proxy and the gateway, ``qos/web.py``, come
with ROADMAP A7).

In the JAX package the shared layer behind every admission edge (the
OpenAI serve server, the in-server service proxy, the gateway agent) and
the scheduling plane's fair share. One tenant flooding requests must cost
*that tenant* 429s, never another tenant's latency. The proxy's and the
gateway's per-service limiters and the job scheduler's fair share stay
with those planes.

Pieces:

- :class:`TokenBucket` / :class:`TenantBuckets` — deterministic
  leaky-bucket rate limiting with an injectable clock (tests drive a
  fake clock and assert the exact admit/shed schedule; production uses
  ``time.monotonic``). Tenant maps are bounded: past ``max_tenants``
  distinct keys, new tenants share one overflow bucket instead of
  growing memory without bound (the same cardinality defense the obs
  registry applies to label sets).
- :class:`QoSPolicy` — per-service admission config, parsed from the
  run/service spec's ``qos`` block or from ``DTPU_QOS_*`` env (the form
  the job configurator injects into a service replica's environment).
- :func:`edge_admit` — the one admission decision both HTTP edges call:
  fires the ``routing.admit`` fault point (chaos plans force the shed
  path deterministically), charges the tenant's bucket, counts
  admitted/shed into the ``dtpu_qos_*`` metrics and the per-run edge
  stats, and returns the 429 ``Retry-After`` hint on shed. Hints are
  monotone within a flood: they are derived from the bucket's refill
  schedule, so back-to-back sheds never tell a client to wait *longer*
  than the previous response did.
- Priority classes + :class:`PriorityPending` — the serve scheduler's
  admission queue: interactive requests are admitted to slots ahead of
  batch, with per-tenant in-flight caps so no tenant holds every slot.

Import-light on purpose (stdlib + obs only — no aiohttp, no jax): the
scheduler plane, the serve process, and unit tests all import this
without pulling a web or accelerator runtime.
"""

import asyncio
import hashlib
import heapq
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from dstack_tpu_torch import faults
from dstack_tpu_torch.qos.metrics import get_qos_registry
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("qos")

# ---------------------------------------------------------------------------
# token buckets
# ---------------------------------------------------------------------------


class TokenBucket:
    """Deterministic leaky bucket: ``rate`` tokens/second refill toward
    ``burst`` capacity; each admitted request spends one token.

    The clock is injectable so the refill schedule is a pure function
    of (rate, burst, clock readings) — the unit tests drive a fake
    clock and assert exactly which calls admit and which shed.
    """

    __slots__ = ("rate", "burst", "tokens", "updated", "clock")

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.clock = clock
        self.updated = clock()

    def _refill(self) -> None:
        now = self.clock()
        if now > self.updated:
            self.tokens = min(self.burst, self.tokens + (now - self.updated) * self.rate)
        self.updated = now

    def try_acquire(self, cost: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def retry_after(self, cost: float = 1.0) -> float:
        """Seconds until ``cost`` tokens will have accrued. A shed does
        NOT spend tokens, so while a flood lasts the hint shrinks
        monotonically as the refill progresses — it never grows."""
        self._refill()
        deficit = cost - self.tokens
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return 3600.0  # rate 0 = hard-closed bucket
        return deficit / self.rate

    def refund(self, cost: float = 1.0) -> None:
        """Return tokens spent on work that was ultimately rejected —
        the serve edge's two-phase charge (1 pre-parse + n-1 once the
        fan-out width is known) refunds the first token when the
        second phase sheds, so a shed stays free of charge and the
        Retry-After contract (hints shrink, a compliant client lands
        on its tokens) holds across the split. Capped at burst."""
        self._refill()
        self.tokens = min(self.burst, self.tokens + cost)

    def is_idle_full(self) -> bool:
        """Fully refilled — indistinguishable from a freshly-created
        bucket, so evicting it loses no state."""
        self._refill()
        return self.tokens >= self.burst


class TenantBuckets:
    """Per-tenant buckets with bounded tenant cardinality: past
    ``max_tenants`` distinct keys, new tenants share one overflow
    bucket (they still get rate-limited — collectively — instead of
    minting unbounded state).

    A full map first evicts idle (fully-refilled) buckets before
    overflowing: a burst of throwaway identities — e.g. rotated Bearer
    tokens at an edge that cannot verify them — poisons the map only
    while those buckets are still draining, not forever. Eviction is
    lossless: a full bucket behaves identically to a fresh one."""

    _OVERFLOW = "<overflow>"

    def __init__(
        self,
        rate: float,
        burst: float,
        max_tenants: int = 256,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        # < 1 would route EVERY tenant to the overflow bucket, silently
        # collapsing per-tenant isolation into one shared budget
        self.max_tenants = max(1, int(max_tenants))
        self.clock = clock
        self._buckets: Dict[str, TokenBucket] = {}

    def _evict_idle(self) -> None:
        for k in [
            k for k, b in self._buckets.items()
            if k != self._OVERFLOW and b.is_idle_full()
        ]:
            del self._buckets[k]

    def bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= self.max_tenants and tenant != self._OVERFLOW:
                self._evict_idle()
            if len(self._buckets) >= self.max_tenants and tenant != self._OVERFLOW:
                return self.bucket(self._OVERFLOW)
            b = self._buckets[tenant] = TokenBucket(
                self.rate, self.burst, clock=self.clock
            )
        return b


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

#: priority classes for the serve admission queue, lower = admitted first
PRIORITY_INTERACTIVE = 0
PRIORITY_STANDARD = 1
PRIORITY_BATCH = 2

_PRIORITY_CLASSES = {
    "interactive": PRIORITY_INTERACTIVE,
    "standard": PRIORITY_STANDARD,
    "batch": PRIORITY_BATCH,
}
_PRIORITY_NAMES = {v: k for k, v in _PRIORITY_CLASSES.items()}


def parse_priority_class(value: Any) -> int:
    """``interactive`` / ``standard`` / ``batch`` (header or payload
    value) → queue rank; anything unrecognized is standard — a bad
    header must not 400 a request or grant it priority."""
    if isinstance(value, str):
        return _PRIORITY_CLASSES.get(value.strip().lower(), PRIORITY_STANDARD)
    return PRIORITY_STANDARD


def priority_class_name(rank: int) -> str:
    return _PRIORITY_NAMES.get(rank, "standard")


@dataclass(frozen=True)
class QoSPolicy:
    """Admission config for one service edge. ``rps <= 0`` disables
    rate limiting; ``tenant_inflight <= 0`` disables the in-flight cap."""

    rps: float = 0.0
    burst: float = 0.0  # 0 → derived as max(1, 2×rps)
    tenant_inflight: int = 0
    max_tenants: int = 256

    @property
    def enabled(self) -> bool:
        return self.rps > 0

    def effective_burst(self) -> float:
        return self.burst if self.burst > 0 else max(1.0, 2.0 * self.rps)

    @classmethod
    def from_spec(cls, spec: Optional[dict]) -> "QoSPolicy":
        """Parse a run/service configuration ``qos`` block (already a
        plain dict on the server side). Bad values degrade to disabled
        rather than 500 the data path."""
        if not isinstance(spec, dict):
            return cls()
        try:
            return cls(
                rps=float(spec.get("rps") or 0.0),
                burst=float(spec.get("burst") or 0.0),
                tenant_inflight=int(spec.get("tenant_inflight") or 0),
                max_tenants=int(spec.get("max_tenants") or 256),
            )
        except (TypeError, ValueError):
            logger.warning("ignoring malformed qos spec: %r", spec)
            return cls()

    @classmethod
    def from_env(cls) -> "QoSPolicy":
        """The serve-process form: the job configurator renders a
        service spec's ``qos`` block into ``DTPU_QOS_*`` env vars for
        the replica (documented in docs/reference/server.md)."""

        def _f(name: str, default: float = 0.0) -> float:
            try:
                return float(os.getenv(name, "") or default)
            except ValueError:
                return default

        return cls(
            rps=_f("DTPU_QOS_RPS"),
            burst=_f("DTPU_QOS_BURST"),
            tenant_inflight=int(_f("DTPU_QOS_TENANT_INFLIGHT")),
            # 0 falls back to the default like from_spec — collapsing
            # every tenant into the overflow bucket is never intended
            max_tenants=int(_f("DTPU_QOS_MAX_TENANTS") or 256),
        )

    def env(self) -> Dict[str, str]:
        """The inverse of :meth:`from_env` — what the configurator
        injects into a service replica's environment."""
        return {
            "DTPU_QOS_RPS": str(self.rps),
            "DTPU_QOS_BURST": str(self.burst),
            "DTPU_QOS_TENANT_INFLIGHT": str(self.tenant_inflight),
            "DTPU_QOS_MAX_TENANTS": str(self.max_tenants),
        }


# ---------------------------------------------------------------------------
# tenant identity
# ---------------------------------------------------------------------------

TENANT_HEADER = "X-DTPU-Tenant"
PRIORITY_HEADER = "X-DTPU-Priority"
#: router-asserted marker on a mid-stream-failover continuation: the
#: proxy/gateway strip client-supplied values (routing.forward
#: _DROP_REQUEST) and inject it only on a resume re-dispatch, so the
#: serve edge may trust it the same way it trusts TENANT_HEADER —
#: a resumed continuation was already admitted (and charged) on its
#: original leg and must not be charged or shed again
RESUME_HEADER = "X-DTPU-Resume"
#: per-request wall-clock budget in seconds (float), set by the client
#: or defaulted by DTPU_REQUEST_DEADLINE_DEFAULT at the serve edge; the
#: forwarder rewrites it to the REMAINING budget on every failover /
#: resume re-dispatch so the budget spans the whole request, not each leg
DEADLINE_HEADER = "X-DTPU-Deadline"
ANONYMOUS_TENANT = "anonymous"


def tenant_from_headers(headers, trust_header: bool = False) -> str:
    """Stable tenant key for a request: a digest of the Bearer token
    (the key never appears in logs or metric labels in the clear), else
    the shared anonymous tenant.

    ``trust_header`` honors an explicit ``X-DTPU-Tenant`` INSTEAD of
    the token digest and is ONLY for the serve process sitting behind
    the proxy/gateway — those edges strip client-supplied values and
    re-inject the authenticated identity, so the header is the one
    trustworthy signal and the Authorization header is NOT: on the
    nginx custom-domain path the raw client token reaches the replica
    unvalidated, and digesting it would let a flooder rotating made-up
    Bearer tokens mint a fresh full-burst bucket per token (budget
    bypass, bounded-map churn). Absent header → shared anonymous
    budget, never the token. A client-facing edge must never set
    ``trust_header``: a spoofable tenant header lets a flooder mint a
    fresh bucket per request or impersonate a victim tenant to exhaust
    theirs. With ``trust_header=False`` the digest fallback is safe
    because its one caller — the gateway's ``_request_tenant`` — only
    reaches it with a token ``_service_auth`` already validated (the
    in-server proxy keys by authenticated username instead)."""
    if trust_header:
        explicit = headers.get(TENANT_HEADER)
        if explicit:
            return str(explicit)[:64]
        return ANONYMOUS_TENANT
    auth = headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        token = auth[len("Bearer "):].strip()
        if token:
            return "tok-" + hashlib.sha256(token.encode()).hexdigest()[:12]
    return ANONYMOUS_TENANT


# ---------------------------------------------------------------------------
# per-run edge stats (the `dtpu stats` / timeline surface)
# ---------------------------------------------------------------------------


@dataclass
class RunEdgeStats:
    admitted: int = 0
    shed: int = 0
    last_shed_at: float = 0.0  # unix seconds
    last_retry_after: int = 0
    shed_tenants: set = field(default_factory=set)  # bounded below


_MAX_RUN_STATS = 512
_MAX_SHED_TENANTS = 64
_run_stats: Dict[Tuple[str, str], RunEdgeStats] = {}


def record_edge(
    project: str, run_name: str, admitted: bool, retry_after: int = 0,
    tenant: str = "", count: int = 1,
) -> None:
    key = (project, run_name)
    st = _run_stats.get(key)
    if st is None:
        if len(_run_stats) >= _MAX_RUN_STATS:
            return  # bounded: drop stats, never memory
        st = _run_stats[key] = RunEdgeStats()
    if admitted:
        st.admitted += count
    else:
        st.shed += 1
        st.last_shed_at = time.time()
        st.last_retry_after = retry_after
        if tenant and len(st.shed_tenants) < _MAX_SHED_TENANTS:
            st.shed_tenants.add(tenant)


def run_edge_snapshot(project: str, run_name: str) -> Optional[dict]:
    st = _run_stats.get((project, run_name))
    if st is None:
        return None
    return {
        "admitted": st.admitted,
        "shed": st.shed,
        "last_shed_at": st.last_shed_at or None,
        "last_retry_after": st.last_retry_after or None,
        "shed_tenants": len(st.shed_tenants),
    }


def reset_edge_stats() -> None:
    """Test hook: edge stats are per-process module state."""
    _run_stats.clear()


# ---------------------------------------------------------------------------
# edge admission
# ---------------------------------------------------------------------------


def edge_admit(
    policy: QoSPolicy,
    buckets: Optional[TenantBuckets],
    tenant: str,
    project: str = "",
    run_name: str = "",
    fault_point: Optional[str] = "routing.admit",
    cost: float = 1.0,
    span=None,
) -> Optional[int]:
    """One admission decision at an HTTP edge → ``None`` when admitted,
    else the integer ``Retry-After`` seconds for the 429.

    The fault point (``routing.admit`` at the proxy/gateway edges,
    ``serve.admit`` at the OpenAI server's) fires first so a chaos plan
    can force the shed path (``action: raise, error: http:429``)
    deterministically, independent of bucket state. ``fault_point=None``
    skips the fire — the serve fan-out's extra-choice charge is a
    second decision on a request whose ``serve.admit`` already fired,
    and chaos plans count fires per HTTP request.

    ``cost`` weights the bucket charge: an ``n``-choice fan-out is n
    engine generations and must spend n tokens, not 1 — otherwise
    ``n=8`` buys 8× a compliant tenant's decode budget. On admit the
    counters advance by ``round(cost)`` (one per covered generation,
    matching ``dtpu_serve_requests_total``'s per-choice accounting); a
    shed is one rejected HTTP request and counts 1 regardless of
    cost.

    ``span`` (an :mod:`obs.tracing` span, optional) receives one
    ``edge_admit`` event recording the decision — a trace of a shed
    request then shows the 429 as an admission decision, not a
    mystery, and a trace of a slow one proves admission was not the
    wait."""
    if fault_point is not None:
        try:
            faults.fire(fault_point, tenant=tenant, run=run_name)
        except faults.FaultError as e:
            hint = max(1, int(math.ceil(getattr(e, "retry_after", None) or 1)))
            _count_edge(tenant, project, run_name, admitted=False, retry_after=hint)
            if span is not None:
                span.event(
                    "edge_admit", shed=True, injected=True, retry_after=hint,
                )
            return hint
    if not policy.enabled or buckets is None:
        # no QoS configured: pass through WITHOUT counting — minting
        # metrics series / RunEdgeStats for every un-policied run would
        # exhaust the bounded _run_stats map and make `dtpu stats`
        # print an admission line for services that have no QoS at all
        return None
    bucket = buckets.bucket(tenant)
    if bucket.try_acquire(cost):
        _count_edge(
            tenant, project, run_name, admitted=True,
            count=max(1, int(round(cost))),
        )
        if span is not None:
            span.event("edge_admit", shed=False)
        return None
    hint = max(1, int(math.ceil(bucket.retry_after(cost))))
    _count_edge(tenant, project, run_name, admitted=False, retry_after=hint)
    if span is not None:
        span.event("edge_admit", shed=True, retry_after=hint)
    return hint


def _count_edge(
    tenant: str, project: str, run_name: str, admitted: bool,
    retry_after: int = 0, count: int = 1,
) -> None:
    m = get_qos_registry()
    if admitted:
        m.family("dtpu_qos_admitted_total").inc(count, tenant)
    else:
        m.family("dtpu_qos_shed_total").inc(1, tenant)
        if retry_after < 1:
            # structurally unreachable under the DTPU007 contract
            # (every shed computes a hint >= 1) — counted anyway so the
            # SLO engine's shed_honesty objective watches the invariant
            # instead of assuming it
            m.family("dtpu_qos_shed_unhinted_total").inc(1)
    if project or run_name:
        record_edge(
            project, run_name, admitted, retry_after=retry_after, tenant=tenant,
            count=count,
        )


# ---------------------------------------------------------------------------
# serve admission queue
# ---------------------------------------------------------------------------


class PriorityPending:
    """Priority-ordered admission queue for the serve scheduler.

    Items are popped best-first by ``(priority_class, arrival_seq)`` —
    interactive ahead of standard ahead of batch, FIFO within a class.
    ``pop_admissible`` skips (but keeps) items an admission predicate
    rejects — the per-tenant in-flight cap — and silently drops items a
    ``discard`` predicate matches (cancelled requests)."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0
        self._event = asyncio.Event()

    def push(self, item, priority: int) -> None:
        heapq.heappush(self._heap, (int(priority), self._seq, item))
        self._seq += 1
        self._event.set()

    def qsize(self) -> int:
        return len(self._heap)

    def empty(self) -> bool:
        return not self._heap

    def pop_admissible(
        self,
        admissible: Callable[[Any], bool],
        discard: Optional[Callable[[Any], bool]] = None,
    ):
        """Best admissible item, or None. Skipped items keep their heap
        position (and their arrival seq, so fairness within a class
        survives the skip)."""
        out = self.pop_admissible_many(1, admissible, discard)
        return out[0] if out else None

    def pop_admissible_many(
        self,
        limit: int,
        admissible: Callable[[Any], bool],
        discard: Optional[Callable[[Any], bool]] = None,
    ) -> list:
        """Up to ``limit`` best admissible items in ONE heap walk.

        The serve tick admits a whole slot-batch through this: popping
        per slot would re-walk (heappop + re-push) every cap-blocked
        entry parked ahead of admissible work ONCE PER SLOT — an
        abusive tenant's backlog would cost O(slots × backlog) heap
        operations on the event loop each tick, during exactly the
        flood QoS exists to absorb. One walk is O(backlog) per tick.

        ``admissible`` runs once per surviving entry in priority order
        and a True return ACCEPTS the item — a predicate tracking a
        budget (the per-tenant in-flight caps) must charge it on
        acceptance, since later entries are judged in the same walk.
        Skipped items keep their heap position and arrival seq."""
        kept: list = []
        out: list = []
        while self._heap and len(out) < limit:
            entry = heapq.heappop(self._heap)
            item = entry[2]
            if discard is not None and discard(item):
                continue
            if admissible(item):
                out.append(item)
            else:
                kept.append(entry)
        for entry in kept:
            heapq.heappush(self._heap, entry)
        if not self._heap:
            self._event.clear()
        return out

    def drain_matching(self, pred: Callable[[Any], bool]) -> list:
        """Remove and return every queued item matching ``pred`` (one
        pred call per item — predicates may have side effects, e.g. the
        deadline check fires a fault point). Survivors keep their
        (priority, arrival seq) ordering. The serve scheduler uses this
        to fail deadline-expired requests still parked in the queue —
        a silent ``discard`` would leave their clients hanging."""
        kept: list = []
        out: list = []
        for entry in self._heap:
            (out if pred(entry[2]) else kept).append(entry)
        if out:
            self._heap = kept
            heapq.heapify(self._heap)
            if not self._heap:
                self._event.clear()
        return [entry[2] for entry in out]

    def any_admissible(
        self,
        admissible: Callable[[Any], bool],
        discard: Optional[Callable[[Any], bool]] = None,
    ) -> bool:
        """Early-exit scan (no heap mutation, no acceptance): does any
        queued item pass ``admissible``? Feeds the engine's adaptive-
        turbo hint — a cap-blocked tenant's parked backlog must not
        read as arrival pressure and shrink every OTHER tenant's
        macro-step."""
        for entry in self._heap:
            item = entry[2]
            if discard is not None and discard(item):
                continue
            if admissible(item):
                return True
        return False

    async def wait(self) -> None:
        """Block until an item may be present (edge-triggered on push)."""
        if self._heap:
            return
        self._event.clear()
        await self._event.wait()
