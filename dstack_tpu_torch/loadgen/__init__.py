"""Deterministic open-loop traffic replay + goodput-under-SLO soak (the
port's copy of ``dstack_tpu.loadgen``: the same specs compile to the
same schedules and digests, and the soak drives the port's server).

The regression spine for the serving stack: a seeded,
declarative workload — Poisson or diurnal arrivals across tenant
classes with QoS priorities, multi-turn chat sessions with shared
prefixes alongside one-shot batch completions — compiled into a
replayable event schedule (a workload is a **pure function of its
seed**, the ``DTPU_FAULT_PLAN`` design contract), fired **open-loop**
by an asyncio driver (requests go out at schedule time regardless of
completions — the arrival pattern closed-loop benches can't produce,
and the one that exposes queueing collapse), and scored as **goodput
under SLO**: per-tenant-class completions meeting their TTFT/TPOT
targets, with honest-shed accounting (a 429 with a monotone
Retry-After is QoS working; a 5xx or truncated stream is always a
failure) and tail amplification across injected chaos windows.

``python -m dstack_tpu_torch.loadgen --seed N`` stands up ≥2 real in-process
replicas behind the real :mod:`dstack_tpu_torch.routing` forwarder with QoS
enabled, optionally kills a replica mid-soak (fault-plan driven, the
mid-stream resume path) and flips another DRAINING, and writes a
``SOAK_rNN.json`` artifact (under ``build/`` by default).

Layout (the generator path — spec/schedule/report/metrics — is
import-light: no torch, no aiohttp, no numpy; the driver and soak
runner import their runtimes lazily):

- :mod:`~dstack_tpu_torch.loadgen.spec` — declarative workload spec.
- :mod:`~dstack_tpu_torch.loadgen.textgen` — the ONE seeded text/prompt
  generator set (``serve/bench.py`` draws from the same functions).
- :mod:`~dstack_tpu_torch.loadgen.schedule` — (spec, seed) → event schedule.
- :mod:`~dstack_tpu_torch.loadgen.report` — SLO evaluator / soak artifact.
- :mod:`~dstack_tpu_torch.loadgen.metrics` — ``dtpu_loadgen_*`` families.
- :mod:`~dstack_tpu_torch.loadgen.driver` — asyncio open-loop driver (aiohttp).
- :mod:`~dstack_tpu_torch.loadgen.soak` — full-stack soak runner (torch).
"""

from dstack_tpu_torch.loadgen.metrics import (
    OUTCOMES,
    get_loadgen_registry,
    new_loadgen_registry,
)
from dstack_tpu_torch.loadgen.report import (
    EventWindow,
    RequestRecord,
    evaluate,
    percentile,
)
from dstack_tpu_torch.loadgen.schedule import (
    Event,
    EventSchedule,
    compile_schedule,
)
from dstack_tpu_torch.loadgen.spec import (
    ArrivalSpec,
    TenantClass,
    WorkloadSpec,
    default_spec,
    load_spec,
    spec_from_dict,
    validate_spec,
)

__all__ = [
    "ArrivalSpec",
    "Event",
    "EventSchedule",
    "EventWindow",
    "OUTCOMES",
    "RequestRecord",
    "TenantClass",
    "WorkloadSpec",
    "compile_schedule",
    "default_spec",
    "evaluate",
    "get_loadgen_registry",
    "load_spec",
    "new_loadgen_registry",
    "percentile",
    "spec_from_dict",
    "validate_spec",
]
