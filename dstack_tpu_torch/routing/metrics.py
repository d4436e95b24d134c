"""Router metric families (``dtpu_router_*``, obs registry factory; the
port's copy, rendering byte-identical to ``dstack_tpu.routing.metrics``).

One construction point for every series the replica-routing subsystem
exports, used by:

- :mod:`dstack_tpu_torch.routing.pool` — pick/breaker/probe accounting at the
  source, so the in-server proxy and the standalone gateway report the
  same series from the same code.
- ``server/services/prometheus.py`` — renders the process-global
  registry into the server's ``/metrics`` page.
- ``gateway/app.py`` — serves the same render from the gateway agent's
  own ``/metrics``.
- ``tools/check_metrics_docs.py`` — enumerates the family names to hold
  docs/reference/server.md to account.

Import-light on purpose (no torch, no aiohttp): the docs checker and unit
tests instantiate the registry without a serving runtime.
"""

from typing import Optional

from dstack_tpu_torch.obs import Registry, SHORT_LATENCY_BUCKETS_S


def new_router_registry() -> Registry:
    """Registry pre-populated with every router metric family."""
    r = Registry()
    r.counter(
        "dtpu_router_picks_total",
        "Replica picks by replica state at pick time",
        labelnames=("state",),
    )
    r.counter(
        "dtpu_router_failovers_total",
        "Requests retried on another replica after a connect error or "
        "5xx (before the response started streaming)",
    )
    r.counter(
        "dtpu_router_exhausted_total",
        "Requests answered 503 because every replica was tried or "
        "unroutable (dead/draining)",
    )
    r.counter(
        "dtpu_router_stream_resumes_total",
        "In-flight SSE completion streams re-dispatched onto another "
        "replica after the upstream died mid-body (resumable "
        "generation: the continuation re-prefills prompt + delivered "
        "tokens and the client stream continues without a 5xx)",
    )
    r.counter(
        "dtpu_router_affinity_hits_total",
        "Picks routed to the replica holding the request's deepest "
        "known prompt-prefix KV (prefix-affinity routing honored)",
    )
    r.counter(
        "dtpu_router_affinity_misses_total",
        "Affinity lookups that fell back to load-based picking: no "
        "recorded mapping, or the mapped replica was unroutable "
        "(dead/draining/excluded) or provably cold (fresh probe with "
        "an empty prefix registry)",
    )
    r.counter(
        "dtpu_router_affinity_overrides_total",
        "Affinity targets shed back to load balancing because honoring "
        "them would exceed the imbalance cap "
        "(DTPU_ROUTER_AFFINITY_MAX_IMBALANCE) or route past a "
        "healthier peer — the overload-isolation escape hatch",
    )
    r.counter(
        "dtpu_router_breaker_opens_total",
        "Circuit-breaker opens (replica marked DEAD after consecutive "
        "failures)",
    )
    r.counter(
        "dtpu_router_slo_degraded_total",
        "Replicas pinned DEGRADED by a firing per-replica SLO "
        "fast-burn alert (the soft-failure analogue of a breaker "
        "open: the replica stays routable as a last resort while it "
        "violates its service-level targets)",
    )
    r.counter(
        "dtpu_router_slo_restored_total",
        "SLO-degraded pins released after the per-replica fast-burn "
        "alert resolved (the replica re-enters normal rotation)",
    )
    r.counter(
        "dtpu_router_probe_failures_total",
        "Health probes that failed (connect error, timeout, or 5xx)",
    )
    r.counter(
        "dtpu_router_boot_restarts_total",
        "Replica restarts detected by a changed boot_id in the probed "
        "/health boot block (same id, same address, new process): each "
        "one invalidates the replica's prefix-affinity mappings — the "
        "authoritative restart signal the prefix_slots=0 heuristic "
        "cannot provide for a replica that re-warmed between probes",
    )
    r.counter(
        "dtpu_router_drained_total",
        "Replicas that finished draining (inflight hit zero or the "
        "drain deadline passed)",
    )
    r.histogram(
        "dtpu_router_probe_seconds",
        "Round-trip latency of successful /health probes",
        buckets=SHORT_LATENCY_BUCKETS_S,
    )
    r.gauge(
        "dtpu_router_replicas",
        "Known replicas by state across all pools in this process",
        labelnames=("state",),
    )
    return r


_registry: Optional[Registry] = None


def get_router_registry() -> Registry:
    """The process-global router registry (proxy and gateway run in
    different processes in production; in tests both feed this one)."""
    global _registry
    if _registry is None:
        _registry = new_router_registry()
    return _registry
