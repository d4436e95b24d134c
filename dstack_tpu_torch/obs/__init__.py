"""Telemetry core of the port: metric primitives and Prometheus rendering
(own copy of ``dstack_tpu.obs``'s metrics, no JAX import), shared by the
serve engine's registry (``serve/metrics.py``), the server's
``/metrics``, the serving bench and the train-step hook
(``train/step.py``)."""

from dstack_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    SHORT_LATENCY_BUCKETS_S,
    THROUGHPUT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    escape_label,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "escape_label",
    "LATENCY_BUCKETS_S",
    "SHORT_LATENCY_BUCKETS_S",
    "THROUGHPUT_BUCKETS",
]
