"""Loadgen metric families (``dtpu_loadgen_*``, obs registry factory;
the port's copy of ``dstack_tpu.loadgen.metrics``).

One construction point for every series the traffic-replay driver
exports, used by:

- :mod:`dstack_tpu_torch.loadgen.driver` — per-request outcome/latency
  accounting at the source.
- ``python -m dstack_tpu_torch.loadgen`` — renders the registry into the
  soak artifact's ``loadgen_metrics`` field (Prometheus text).
- the DTPU004 docs-coverage collector — enumerates the family names to
  hold docs/reference/server.md to account.

Import-light on purpose (no torch, no aiohttp): the docs checker and
unit tests instantiate the registry without a serving runtime.
"""

from typing import Optional

from dstack_tpu_torch.obs import (
    LATENCY_BUCKETS_S,
    Registry,
    SHORT_LATENCY_BUCKETS_S,
)

#: bounded outcome enum for dtpu_loadgen_requests_total — the driver
#: classifies every fired event into exactly one of these
OUTCOMES = (
    "ok",  # completed (stream saw [DONE] / JSON body landed)
    "shed",  # honest 429 (QoS working, not a failure)
    "client_error",  # other 4xx (a workload bug, not the stack's)
    "failed_5xx",  # 5xx answer — ALWAYS a defect under this harness
    "failed_connect",  # connect/send error before any response
    "failed_truncated",  # response died mid-body without [DONE]
    "failed_stream_error",  # in-band terminal SSE error event
    "abandoned",  # still in flight when the drain timeout expired
)


def new_loadgen_registry() -> Registry:
    """Registry pre-populated with every loadgen metric family."""
    r = Registry()
    r.counter(
        "dtpu_loadgen_events_fired_total",
        "Schedule events fired by the open-loop driver (incremented at "
        "send time, before any response — a mid-soak scrape shows "
        "arrival progress)",
    )
    r.counter(
        "dtpu_loadgen_requests_total",
        "Fired requests by terminal outcome (ok / shed / client_error "
        "/ failed_5xx / failed_connect / failed_truncated / "
        "failed_stream_error / abandoned)",
        labelnames=("outcome",),
    )
    r.histogram(
        "dtpu_loadgen_ttft_seconds",
        "Client-observed time-to-first-token: request send to first "
        "non-empty content delta (streaming) or to the full response "
        "(non-streaming) — includes router, QoS, queueing, and prefill",
        buckets=LATENCY_BUCKETS_S,
    )
    r.histogram(
        "dtpu_loadgen_tpot_seconds",
        "Client-observed time-per-output-token: mean inter-delta gap "
        "over a completed stream with at least two content deltas",
        buckets=SHORT_LATENCY_BUCKETS_S,
    )
    r.histogram(
        "dtpu_loadgen_sched_lag_seconds",
        "Open-loop fidelity: how late each event fired relative to its "
        "compiled schedule time (a growing lag means the DRIVER is "
        "saturated and the workload is no longer open-loop)",
        buckets=SHORT_LATENCY_BUCKETS_S,
    )
    r.gauge(
        "dtpu_loadgen_inflight",
        "Requests the driver has fired and not yet resolved",
    )
    return r


_registry: Optional[Registry] = None


def get_loadgen_registry() -> Registry:
    """The process-global loadgen registry (driver and soak CLI share
    it; tests may construct their own via new_loadgen_registry)."""
    global _registry
    if _registry is None:
        _registry = new_loadgen_registry()
    return _registry
