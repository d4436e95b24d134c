"""QoS metric families (own copy of ``dstack_tpu.qos.metrics``; the port's
server renders them on its ``/metrics``, byte for byte as JAX's).

One construction point for every ``dtpu_qos_*`` series. The registry is
rendered by three surfaces: the control-plane server's ``/metrics``
(edge admission through the in-server proxy + scheduler preemptions),
the gateway agent's ``/metrics`` (its own admission edge), and the
OpenAI serve server's ``/metrics`` (engine-side admission). Each
process holds its own module-global instance — counts are per-process,
exactly like the router registry.

The ``tenant`` label is bounded twice: tenant keys are short digests
(never raw tokens), and the families carry a low ``max_series`` cap so
an attacker minting Authorization headers collapses into the
``<truncated>`` sentinel series instead of growing the exporter
(DTPU004's cardinality contract).

Import-light (no jax, no aiohttp): the docs-coverage lint enumerates
these families without an accelerator runtime.
"""

from typing import Optional

from dstack_tpu_torch.obs import LATENCY_BUCKETS_S, Registry

# distinct tenants one process tracks per family before collapsing
TENANT_SERIES_CAP = 128


def new_qos_registry() -> Registry:
    r = Registry()
    r.counter(
        "dtpu_qos_admitted_total",
        "Requests admitted by the QoS edge, by tenant digest",
        labelnames=("tenant",),
        max_series=TENANT_SERIES_CAP,
    )
    r.counter(
        "dtpu_qos_shed_total",
        "Requests shed (429 + Retry-After) by the QoS edge, by tenant digest",
        labelnames=("tenant",),
        max_series=TENANT_SERIES_CAP,
    )
    r.counter(
        "dtpu_qos_shed_unhinted_total",
        "Sheds recorded without a Retry-After hint — structurally "
        "zero under the DTPU007 contract; any count means the shed "
        "contract itself broke (the SLO engine's shed_honesty "
        "objective burns on this)",
    )
    r.counter(
        "dtpu_qos_inflight_deferred_total",
        "Requests that waited at least once at their tenant's in-flight "
        "slot cap (counted once per request; the request stays queued, "
        "it is not shed)",
        labelnames=("tenant",),
        max_series=TENANT_SERIES_CAP,
    )
    r.histogram(
        "dtpu_qos_queue_wait_seconds",
        "Submit-to-slot-admission wait by priority class "
        "(interactive/standard/batch) under the priority-aware queue",
        labelnames=("priority",),
        buckets=LATENCY_BUCKETS_S,
        max_series=8,
    )
    r.counter(
        "dtpu_qos_preempted_jobs_total",
        "Batch jobs preempted (INTERRUPTED_BY_NO_CAPACITY) so a "
        "higher-priority run could take their capacity",
    )
    return r


_registry: Optional[Registry] = None


def get_qos_registry() -> Registry:
    global _registry
    if _registry is None:
        _registry = new_qos_registry()
    return _registry
