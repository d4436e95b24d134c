"""Replica pool: per-replica health state machine, picker, breaker (the
port's copy of ``dstack_tpu.routing.pool``; its probe reads the
``/health`` fields the port's server serves).

The shared registry behind both data planes (in-server proxy and the
standalone gateway agent). Each service gets a :class:`ReplicaPool`
whose members move through

    STARTING -> READY -> DEGRADED -> DRAINING -> DEAD

driven by three inputs: an async probing loop polling each replica's
``/health`` (queue depth / inflight / KV utilization from the serve
gauges), per-request success/failure reports from the forwarding path,
and explicit drain marks from scale-down/teardown.

Design points:

- **Optimistic STARTING.** A replica the prober has not confirmed yet
  is still routable — the control planes that embed this pool (the
  in-server proxy resolving replicas per request, tests without a probe
  loop) must keep working with zero probes. Real failures still open
  the breaker, so blind optimism degrades to correctness, not outages.
- **Startup grace.** Failures never transition STARTING -> DEAD inside
  ``startup_grace`` seconds of first sight: an engine compiling its
  kernels refuses connections for a while, and hammering it into a
  breaker window would only delay its first served request. Failover
  keeps clients unaffected meanwhile.
- **Half-open trials.** A DEAD replica whose breaker window passed is
  offered exactly one trial request (or probe); success closes the
  breaker, failure doubles the backoff (capped).
- **Least-outstanding picks.** Among routable replicas the picker
  prefers healthier states, then fewest in-flight proxied requests,
  then the smallest probed queue depth — live load data when the
  prober has it, plain outstanding counts when it does not.
- **Prefix affinity.** When the forwarder hands ``pick()`` a request's
  :class:`~dstack_tpu_torch.routing.affinity.AffinityKey`, the replica that
  most recently served the deepest shared prompt prefix wins — its KV
  rows make the re-prefill nearly free — unless it is less healthy or
  carries more than ``DTPU_ROUTER_AFFINITY_MAX_IMBALANCE`` extra
  outstanding requests vs the least-loaded peer (then the pick falls
  back to load and ``dtpu_router_affinity_overrides_total`` counts
  the shed). Mappings die with the replica: DEAD/DRAINING/unsynced
  replicas are purged from the affinity map immediately.

Everything here runs on one event loop per process (aiohttp handlers,
probe task, reconcilers); no locking — the metrics registry underneath
is thread-safe on its own.
"""

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, Optional, Tuple

from dstack_tpu_torch import faults
from dstack_tpu_torch.obs import boot as obs_boot
from dstack_tpu_torch.routing.affinity import AffinityKey, AffinityMap
from dstack_tpu_torch.routing.metrics import get_router_registry
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("routing.pool")


class ReplicaState(str, Enum):
    STARTING = "starting"  # known, not yet probed healthy
    READY = "ready"  # probed healthy (or recovered via a trial)
    DEGRADED = "degraded"  # alive but overloaded: last-resort target
    DRAINING = "draining"  # finishing inflight work; no new requests
    DEAD = "dead"  # breaker open; half-open trials after backoff


# picker preference: lower is better
_STATE_RANK = {
    ReplicaState.READY: 0,
    ReplicaState.STARTING: 1,
    ReplicaState.DEGRADED: 2,
}


@dataclass
class PoolConfig:
    fail_threshold: int = 3  # consecutive failures -> breaker opens
    breaker_base_backoff: float = 1.0
    breaker_max_backoff: float = 15.0
    startup_grace: float = 180.0  # STARTING can't die before this age
    degraded_queue_depth: float = 8.0
    degraded_kv_util: float = 0.95
    probe_timeout: float = 2.0
    probe_stale_after: float = 15.0  # probe data older than this is noise
    drain_deadline: float = 30.0


@dataclass
class ReplicaEntry:
    replica_id: str
    host: str
    port: int
    state: ReplicaState = ReplicaState.STARTING
    created_at: float = field(default_factory=time.monotonic)
    outstanding: int = 0  # proxied requests currently in flight
    consecutive_failures: int = 0
    breaker_backoff: float = 0.0
    breaker_open_until: float = 0.0
    half_open: bool = False  # one trial in flight against a DEAD replica
    last_probe_at: float = 0.0  # monotonic; 0 = never probed
    probe: dict = field(default_factory=dict)  # last /health payload
    drain_deadline_at: float = 0.0
    drained_counted: bool = False  # dtpu_router_drained_total fired once
    # a firing per-replica SLO fast-burn alert pins the replica
    # DEGRADED (last-resort target) until the alert resolves — the
    # soft-failure analogue of the breaker (obs/slo.py, process_slo)
    slo_degraded: bool = False
    # boot-block ingestion memo (obs/boot.py ingest): tracks which
    # stages of the replica's CURRENT boot_id were already folded into
    # the fleet histograms, so repeated probes observe each once; a
    # boot_id change here is the authoritative restart signal
    boot_memo: dict = field(default_factory=dict)

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def queue_depth(self) -> float:
        try:
            return float(self.probe.get("queue_depth") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def kv_utilization(self) -> float:
        try:
            return float(self.probe.get("kv_utilization") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def probed_prefix_slots(self) -> Optional[int]:
        """Occupied prefix-registry slots from the last /health probe,
        or None when the replica never reported them (non-dtpu
        service, pre-upgrade replica)."""
        v = self.probe.get("prefix_slots") if self.probe else None
        try:
            return int(v) if v is not None else None
        except (TypeError, ValueError):
            return None


class ReplicaPool:
    """Health-aware replica set for one service (project, run_name)."""

    def __init__(self, project: str, run_name: str, config: Optional[PoolConfig] = None):
        self.project = project
        self.run_name = run_name
        self.config = config or PoolConfig()
        self.entries: Dict[str, ReplicaEntry] = {}
        self._rr = 0  # rotates equal-score picks (round-robin tie-break)
        # digest/session → replica learned from dispatch history
        # (bounded LRU + TTL; see routing/affinity.py)
        self.affinity = AffinityMap()

    # ---- membership ----

    def sync(self, replicas: Iterable[Tuple[str, str, int]]) -> None:
        """Reconcile membership against the authoritative replica list
        (DB resolution or gateway registry). New ids start STARTING;
        existing ids keep their health state (probes are the only thing
        that should promote/demote); gone ids drop out."""
        seen = set()
        for rid, host, port in replicas:
            rid = str(rid)
            seen.add(rid)
            e = self.entries.get(rid)
            if e is None:
                self.entries[rid] = ReplicaEntry(rid, host, int(port))
            elif e.address != (host, int(port)):
                # same id at a new address: it's a different process —
                # restart the state machine from scratch (and drop the
                # affinity hints: the new process has an empty KV cache)
                self.entries[rid] = ReplicaEntry(rid, host, int(port))
                self.affinity.invalidate_replica(rid)
        for rid in [r for r in self.entries if r not in seen]:
            del self.entries[rid]
            self.affinity.invalidate_replica(rid)

    def size(self) -> int:
        return len(self.entries)

    def has(self, replica_id: str) -> bool:
        return str(replica_id) in self.entries

    def get(self, replica_id: str) -> Optional[ReplicaEntry]:
        return self.entries.get(str(replica_id))

    def replica_ids(self) -> list:
        """Known replica ids (for per-replica state snapshots — count
        aggregates hide offsetting same-tick transitions)."""
        return list(self.entries)

    def states(self) -> Dict[str, int]:
        out = {s.value: 0 for s in ReplicaState}
        for e in self.entries.values():
            out[e.state.value] += 1
        return out

    # ---- picking ----

    def pick(
        self,
        exclude: Iterable[str] = (),
        affinity: Optional[AffinityKey] = None,
        span=None,
    ) -> Optional[ReplicaEntry]:
        """Least-outstanding-requests selection over routable replicas,
        or one half-open trial against a breaker-expired DEAD replica
        when nothing else is left. None = pool exhausted.

        With ``affinity``, the replica recorded against the request's
        deepest known prompt-prefix digest wins instead — provided it
        is as healthy as the best candidate and within the imbalance
        cap of the least-loaded one (docs/guides/serving.md §10).

        ``span`` (an :mod:`obs.tracing` span, optional) receives one
        ``replica_pick`` event per call — the chosen replica, its
        state, and the affinity outcome (hit/miss/override/off) — so a
        trace explains WHY a request landed where it did."""
        excluded = set(exclude)
        now = time.monotonic()
        candidates = []
        trials = []
        for e in self.entries.values():
            if e.replica_id in excluded:
                continue
            if e.state == ReplicaState.DRAINING:
                continue
            if e.state == ReplicaState.DEAD:
                if now >= e.breaker_open_until and not e.half_open:
                    trials.append(e)
                continue
            candidates.append(e)
        affinity_outcome = "off"
        if candidates:
            best = None
            if affinity is not None and self.affinity.config.enabled:
                best, affinity_outcome = self._affinity_choice(
                    affinity, candidates
                )
            if best is None:
                score = lambda e: (  # noqa: E731 - used twice below
                    _STATE_RANK[e.state], e.outstanding, e.queue_depth(),
                )
                best_score = min(score(e) for e in candidates)
                # sequential (non-overlapping) requests tie on
                # everything — rotate among the tied so the spread
                # survives without live load data (the old
                # round-robin's one virtue)
                tied = sorted(
                    (e for e in candidates if score(e) == best_score),
                    key=lambda e: e.replica_id,
                )
                best = tied[self._rr % len(tied)]
                self._rr += 1
        elif trials:
            best = min(trials, key=lambda e: (e.outstanding, e.replica_id))
            best.half_open = True  # exactly one trial per window
        else:
            if span is not None:
                span.event("replica_pick", exhausted=True)
            return None
        get_router_registry().family("dtpu_router_picks_total").inc(
            1, best.state.value
        )
        if span is not None:
            span.event(
                "replica_pick",
                replica=best.replica_id, state=best.state.value,
                outstanding=best.outstanding, affinity=affinity_outcome,
            )
        return best

    def _affinity_choice(
        self, key: AffinityKey, candidates: list
    ) -> Tuple[Optional[ReplicaEntry], str]:
        """The two-term affinity score → (choice or None, outcome
        label): the mapped replica wins the pick (``hit``) unless the
        mapping is absent/unroutable/provably cold (``miss`` → load
        pick) or honoring it would pile more than ``max_imbalance``
        extra outstanding requests onto it — or route past a healthier
        peer — while others idle (``override`` → load pick, counted so
        an imbalance flood is observable)."""
        m = get_router_registry()
        hit = self.affinity.lookup_entry(key)
        target_rid, recorded_at = hit if hit is not None else (None, 0.0)
        target = (
            next(
                (e for e in candidates if e.replica_id == target_rid), None
            )
            if target_rid is not None
            else None
        )
        if target is None:
            # no mapping, or the mapped replica is excluded (already
            # tried this request), DRAINING, DEAD, or gone: cache miss
            m.family("dtpu_router_affinity_misses_total").inc(1)
            return None, "miss"
        now = time.monotonic()
        fresh = (
            target.last_probe_at > 0
            and now - target.last_probe_at <= self.config.probe_stale_after
            # a probe OLDER than the mapping predates the dispatch that
            # warmed the registry — it proves nothing about THIS prefix
            # (post-restart: the t=0 slots=0 probe must not invalidate
            # a mapping learned at t=1 until the next probe lands)
            and target.last_probe_at >= recorded_at
        )
        if fresh and target.probed_prefix_slots() == 0:
            # a fresh probe proves the prefix registry empty (engine
            # restarted/reset): the KV this mapping promised is gone
            m.family("dtpu_router_affinity_misses_total").inc(1)
            return None, "miss"
        cfg = self.affinity.config
        rank_min = min(_STATE_RANK[e.state] for e in candidates)
        out_min = min(e.outstanding for e in candidates)
        if (
            _STATE_RANK[target.state] > rank_min
            or target.outstanding - out_min > cfg.max_imbalance
        ):
            m.family("dtpu_router_affinity_overrides_total").inc(1)
            return None, "override"
        m.family("dtpu_router_affinity_hits_total").inc(1)
        return target, "hit"

    def acquire(self, entry: ReplicaEntry) -> None:
        entry.outstanding += 1

    def release(self, entry: ReplicaEntry) -> None:
        entry.outstanding = max(0, entry.outstanding - 1)
        if (
            entry.state == ReplicaState.DRAINING
            and entry.outstanding == 0
            and not entry.drained_counted
        ):
            entry.drained_counted = True
            get_router_registry().family("dtpu_router_drained_total").inc(1)

    def retry_after_hint(self) -> int:
        """Seconds until the earliest breaker half-opens — what a 503's
        Retry-After should tell clients to wait."""
        now = time.monotonic()
        waits = [
            e.breaker_open_until - now
            for e in self.entries.values()
            if e.state == ReplicaState.DEAD
        ]
        if not waits:
            return 1
        return max(1, min(30, int(min(waits)) + 1))

    # ---- breaker / health reports ----

    def report_success(self, entry: ReplicaEntry) -> None:
        entry.consecutive_failures = 0
        entry.half_open = False
        entry.breaker_backoff = 0.0
        if entry.state in (ReplicaState.STARTING, ReplicaState.DEAD):
            # request successes promote; DEGRADED only clears via a
            # probe (one cheap request succeeding says nothing about
            # the queue that made it degraded) — and never past a
            # pinned SLO alert
            entry.state = (
                ReplicaState.DEGRADED
                if entry.slo_degraded
                else ReplicaState.READY
            )

    def report_failure(self, entry: ReplicaEntry) -> None:
        entry.consecutive_failures += 1
        if entry.state == ReplicaState.DRAINING:
            return  # picker already skips it; let inflight finish
        if entry.state == ReplicaState.DEAD:
            # failed half-open trial: double the window (capped)
            entry.half_open = False
            entry.breaker_backoff = min(
                self.config.breaker_max_backoff,
                max(
                    self.config.breaker_base_backoff,
                    entry.breaker_backoff * 2,
                ),
            )
            entry.breaker_open_until = time.monotonic() + entry.breaker_backoff
            return
        if entry.consecutive_failures < self.config.fail_threshold:
            return
        if (
            entry.state == ReplicaState.STARTING
            and time.monotonic() - entry.created_at < self.config.startup_grace
        ):
            return  # still booting (engine warmup): keep trying
        entry.state = ReplicaState.DEAD
        entry.breaker_backoff = self.config.breaker_base_backoff
        entry.breaker_open_until = time.monotonic() + entry.breaker_backoff
        # the replica's KV cache dies with it: affinity hints pointing
        # there would only steer sessions into the breaker
        self.affinity.invalidate_replica(entry.replica_id)
        get_router_registry().family("dtpu_router_breaker_opens_total").inc(1)
        logger.warning(
            "replica %s of %s/%s marked DEAD after %d consecutive failures",
            entry.replica_id, self.project, self.run_name,
            entry.consecutive_failures,
        )

    # ---- draining ----

    def mark_draining(
        self, replica_id: str, deadline_seconds: Optional[float] = None
    ) -> bool:
        e = self.entries.get(str(replica_id))
        if e is None:
            return False
        if e.state != ReplicaState.DRAINING:
            e.state = ReplicaState.DRAINING
            e.drain_deadline_at = time.monotonic() + (
                deadline_seconds
                if deadline_seconds is not None
                else self.config.drain_deadline
            )
            # draining ends in teardown: sessions must re-warm
            # elsewhere, not chase a replica that stopped taking work
            self.affinity.invalidate_replica(str(replica_id))
            logger.info(
                "replica %s of %s/%s draining (%d inflight)",
                replica_id, self.project, self.run_name, e.outstanding,
            )
        return True

    def cancel_draining(self, replica_id: str) -> bool:
        """Put a DRAINING replica back into rotation (scale-down was
        reversed before it finished draining). It re-enters as READY —
        it was serving a moment ago — and the next probe reclassifies."""
        e = self.entries.get(str(replica_id))
        if e is None or e.state != ReplicaState.DRAINING:
            return False
        e.state = ReplicaState.READY
        e.drain_deadline_at = 0.0
        e.drained_counted = False
        logger.info(
            "replica %s of %s/%s drain cancelled; back in rotation",
            replica_id, self.project, self.run_name,
        )
        return True

    def set_slo_degraded(self, replica_id: str, degraded: bool) -> bool:
        """Pin (or release) a replica's DEGRADED state from a firing
        per-replica SLO fast-burn alert (process_slo / the soak's live
        engine). While pinned, probes keep the replica DEGRADED even
        when its queue/KV look healthy — it violated its service-level
        targets, so it serves only as a last-resort target. Releasing
        restores READY immediately unless the probe data itself says
        overloaded; the next probe reclassifies either way. True when
        the flag actually changed."""
        e = self.entries.get(str(replica_id))
        if e is None or e.slo_degraded == degraded:
            return False
        e.slo_degraded = degraded
        m = get_router_registry()
        if degraded:
            if e.state == ReplicaState.READY:
                e.state = ReplicaState.DEGRADED
            m.family("dtpu_router_slo_degraded_total").inc(1)
            logger.warning(
                "replica %s of %s/%s marked DEGRADED by a firing SLO "
                "fast-burn alert",
                replica_id, self.project, self.run_name,
            )
        else:
            if e.state == ReplicaState.DEGRADED and not self._overloaded(e):
                e.state = ReplicaState.READY
            m.family("dtpu_router_slo_restored_total").inc(1)
            logger.info(
                "replica %s of %s/%s SLO alert resolved; restored",
                replica_id, self.project, self.run_name,
            )
        return True

    def _overloaded(self, entry: ReplicaEntry) -> bool:
        """The probe-data overload predicate behind READY↔DEGRADED,
        OR-ed with the SLO pin (one definition for both the probe path
        and the pin-release path)."""
        return (
            entry.slo_degraded
            or entry.queue_depth() >= self.config.degraded_queue_depth
            or entry.kv_utilization() >= self.config.degraded_kv_util
        )

    def is_draining(self, replica_id: str) -> bool:
        e = self.entries.get(str(replica_id))
        return e is not None and e.state == ReplicaState.DRAINING

    def drained(self, replica_id: str) -> bool:
        """True once a DRAINING replica may be torn down: inflight hit
        zero or the deadline passed. Unknown replicas are trivially
        drained (nothing is routing to them through this pool)."""
        e = self.entries.get(str(replica_id))
        if e is None:
            return True
        if e.state != ReplicaState.DRAINING:
            return False
        if e.outstanding == 0 or time.monotonic() >= e.drain_deadline_at:
            if not e.drained_counted:
                e.drained_counted = True
                get_router_registry().family("dtpu_router_drained_total").inc(1)
            return True
        return False

    # ---- probing ----

    def probe_summary(self) -> Optional[Tuple[float, int]]:
        """(total probed queue depth, replicas with fresh probes), or
        None when every probe is stale — the queue-depth autoscaler's
        signal, with staleness as its fall-back-to-RPS trigger."""
        now = time.monotonic()
        total = 0.0
        fresh = 0
        for e in self.entries.values():
            if (
                e.last_probe_at > 0
                and now - e.last_probe_at <= self.config.probe_stale_after
            ):
                total += e.queue_depth()
                fresh += 1
        if fresh == 0:
            return None
        return total, fresh

    def probe_targets(self) -> list:
        """Entries worth probing this tick: everything except DEAD
        replicas still inside their breaker window (probing those would
        inflate the backoff without new information) or with a live
        half-open trial (a concurrent probe failure would reset the
        trial flag and break the one-trial-per-window invariant)."""
        now = time.monotonic()
        return [
            e
            for e in self.entries.values()
            if e.state != ReplicaState.DEAD
            or (now >= e.breaker_open_until and not e.half_open)
        ]

    def ingest_boot(self, entry: ReplicaEntry) -> None:
        """Fold a probed ``/health`` ``boot`` block into the fleet boot
        histograms (via the entry's memo, so each boot observes each
        stage once) and — the restart detector — invalidate the
        replica's affinity mappings when its ``boot_id`` changed: same
        id, same address, NEW process, so every KV row the affinity map
        remembers is gone. The ``prefix_slots=0`` heuristic in the
        affinity score cannot catch a replica that restarted AND
        re-warmed between probes; boot identity can, and the heuristic
        stays for same-process registry resets. Separate from
        probe_replica so restart-flap tests drive it with synthetic
        probe payloads."""
        block = entry.probe.get("boot") if entry.probe else None
        if not isinstance(block, dict) or not block.get("boot_id"):
            return
        prior = entry.boot_memo.get("boot_id")
        if prior is not None and prior != str(block["boot_id"]):
            self.affinity.invalidate_replica(entry.replica_id)
            get_router_registry().family(
                "dtpu_router_boot_restarts_total"
            ).inc(1)
            logger.info(
                "replica %s rebooted (boot_id %s -> %s): affinity "
                "mappings invalidated",
                entry.replica_id, prior, block["boot_id"],
            )
        obs_boot.ingest(block, entry.boot_memo)

    async def probe_replica(self, session, entry: ReplicaEntry) -> bool:
        """One ``GET /health`` against a replica; updates its state.
        Any HTTP answer below 500 counts as alive (plain services need
        not implement /health); a JSON body contributes load data."""
        import asyncio

        import aiohttp

        m = get_router_registry()
        url = f"http://{entry.host}:{entry.port}/health"
        t0 = time.perf_counter()
        try:
            await faults.afire("routing.probe", replica=entry.replica_id)
            async with session.get(
                url, timeout=aiohttp.ClientTimeout(total=self.config.probe_timeout)
            ) as resp:
                if resp.status >= 500:
                    raise aiohttp.ClientResponseError(
                        resp.request_info, (), status=resp.status,
                        message="unhealthy",
                    )
                data = {}
                try:
                    body = await resp.json(content_type=None)
                    if isinstance(body, dict):
                        data = body
                except (ValueError, aiohttp.ClientError):
                    pass  # non-JSON /health: liveness only
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            m.family("dtpu_router_probe_failures_total").inc(1)
            self.report_failure(entry)
            return False
        m.family("dtpu_router_probe_seconds").observe(time.perf_counter() - t0)
        entry.probe = {
            k: data.get(k)
            for k in ("queue_depth", "inflight", "kv_utilization",
                      "active_slots", "max_slots",
                      # prefix-cache occupancy (serving.md §10): the
                      # affinity score treats a fresh prefix_slots=0
                      # as proof the mapped KV is gone
                      "prefix_hits", "prefix_slots", "prefix_occupancy",
                      "prefix_tokens",
                      # the replica's rolling SLO window summaries
                      # (obs/slo.py ReplicaSLO): TTFT/queue-wait/TPOT
                      # bucket deltas + request/error/shed counts per
                      # window, consumed by process_slo — the probe IS
                      # the transport, no new scrape protocol
                      "slo_windows",
                      # engine observability (obs/flight.py +
                      # obs/profiling.py): a replica stuck in a
                      # profiler capture or a compile storm shows here
                      # — probes carry the flight compile/recompile/
                      # post-mortem counts and the is_tracing flag
                      "profiler_tracing", "flight",
                      # boot decomposition (obs/boot.py): boot_id +
                      # per-stage seconds + TTFST — the probe is the
                      # transport for the fleet boot histograms, and
                      # a boot_id change invalidates affinity
                      "boot")
        }
        entry.last_probe_at = time.monotonic()
        self.ingest_boot(entry)
        self.report_success(entry)
        if (
            entry.state == ReplicaState.DRAINING
            and time.monotonic()
            >= entry.drain_deadline_at + self.config.drain_deadline
        ):
            # abandoned drain: a drained replica gets torn down and
            # unregistered promptly — one still registered and healthy
            # long past its deadline (e.g. the control plane restarted
            # and forgot) must rejoin rotation, not stay blackholed
            self.cancel_draining(entry.replica_id)
        if entry.state in (ReplicaState.READY, ReplicaState.DEGRADED):
            # probe-data overload OR a pinned SLO fast-burn alert
            # (the pin outlives healthy-looking probes until the alert
            # resolves — soft failures don't show in queue depth)
            entry.state = (
                ReplicaState.DEGRADED
                if self._overloaded(entry)
                else ReplicaState.READY
            )
        return True


class PoolRegistry:
    """Pools keyed by (project, run_name). The server process uses the
    module-global instance (proxy handlers, reconcilers, and the probe
    task share it); the gateway agent holds its own."""

    def __init__(self, config: Optional[PoolConfig] = None):
        self.config = config or PoolConfig()
        self.pools: Dict[Tuple[str, str], ReplicaPool] = {}

    def pool(self, project: str, run_name: str) -> ReplicaPool:
        key = (project, run_name)
        p = self.pools.get(key)
        if p is None:
            p = self.pools[key] = ReplicaPool(project, run_name, self.config)
        return p

    def prune(self, active_keys: Iterable[Tuple[str, str]]) -> None:
        keep = set(active_keys)
        for key in [k for k in self.pools if k not in keep]:
            del self.pools[key]

    async def probe_all(self, session) -> None:
        import asyncio

        jobs = [
            pool.probe_replica(session, e)
            for pool in list(self.pools.values())
            for e in pool.probe_targets()
        ]
        if jobs:
            await asyncio.gather(*jobs, return_exceptions=True)
        self.update_state_gauge()

    def update_state_gauge(self) -> None:
        counts = {s.value: 0 for s in ReplicaState}
        for pool in self.pools.values():
            for state, n in pool.states().items():
                counts[state] += n
        g = get_router_registry().family("dtpu_router_replicas")
        for state, n in counts.items():
            g.set(n, state)


_pool_registry: Optional[PoolRegistry] = None


def get_pool_registry() -> PoolRegistry:
    global _pool_registry
    if _pool_registry is None:
        _pool_registry = PoolRegistry()
    return _pool_registry
