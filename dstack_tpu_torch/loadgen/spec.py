"""Declarative workload spec for the traffic-replay soak harness (the
port's copy of ``dstack_tpu.loadgen.spec``, on the port's ``obs.slo``
target schema).

A :class:`WorkloadSpec` describes production-shaped traffic as data —
an arrival process, a tenant-class mix, and per-class request shapes —
and the schedule compiler (:mod:`dstack_tpu_torch.loadgen.schedule`) turns
(spec, seed) into a replayable event schedule. The spec deliberately
contains **no randomness**: every draw happens in the compiler from
named ``random.Random`` streams, so a workload is a pure function of
its seed (the ``DTPU_FAULT_PLAN`` design contract).

Two request kinds:

- ``chat`` — multi-turn conversations with shared prefixes: each class
  arrival *starts a session*; the session's later turns follow at
  seeded think-time gaps, and turn *k+1*'s message list extends turn
  *k*'s (user turns and scripted assistant turns are both seeded text,
  so the prefix chain — and therefore prefix-affinity routing and the
  engine's KV prefix cache — behaves like a real conversation replay
  without coupling the schedule to live completions).
- ``completion`` — one-shot batch completions (a single prompt string).

Per-class SLO targets (``ttft_slo_ms``/``tpot_slo_ms``) are what the
report evaluator scores **goodput** against: a request counts toward
goodput only when it completed successfully AND met both targets
(DistServe's goodput-under-SLO, not raw throughput).

Validation follows :func:`dstack_tpu_torch.faults.validate_plan`'s style:
offline, returns a list of error strings, raises nothing until a
caller actually compiles.

Import-light on purpose (stdlib only): the schedule compiler, the docs
tooling, and unit tests load this without aiohttp or torch.
"""

import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from dstack_tpu_torch.loadgen.textgen import bounds_pair
# the one SLO-target schema: per-class ttft_slo_ms/tpot_slo_ms
# defaults and validation live in obs/slo.py (stdlib-only, so this
# module stays import-light) — the live burn engine's SLOPolicy
# classes and these tenant classes cannot drift
from dstack_tpu_torch.obs.slo import (
    DEFAULT_TPOT_SLO_MS,
    DEFAULT_TTFT_SLO_MS,
    validate_slo_target_fields,
)

_KINDS = ("chat", "completion")
_PROCESSES = ("poisson", "diurnal")
_PRIORITIES = ("interactive", "standard", "batch")


@dataclass(frozen=True)
class ArrivalSpec:
    """Open-loop arrival process for the whole workload.

    ``rate_rps`` is the mean REQUEST rate across all classes (chat
    turns count as requests: a chat class admits sessions at
    ``share * rate / turns`` so its turn stream lands near its share).
    ``diurnal`` modulates the rate sinusoidally: rate(t) =
    rate × (1 + amplitude × sin(2πt / period_s)), realized by seeded
    thinning of a peak-rate Poisson stream — still a pure function of
    the seed."""

    process: str = "poisson"
    rate_rps: float = 3.0
    amplitude: float = 0.5  # diurnal only; peak = rate × (1 + amplitude)
    period_s: float = 60.0


@dataclass(frozen=True)
class TenantClass:
    """One tenant class: its share of traffic, QoS priority, SLO
    targets, and request shape."""

    name: str
    kind: str = "chat"  # "chat" | "completion"
    share: float = 1.0  # relative weight of the arrival mix
    tenants: int = 2  # distinct tenant identities in this class
    priority: str = "standard"  # serve-edge priority class
    ttft_slo_ms: float = DEFAULT_TTFT_SLO_MS
    tpot_slo_ms: float = DEFAULT_TPOT_SLO_MS
    stream: bool = True
    temperature: float = 0.0  # 0 = greedy (resumable mid-stream)
    seeded: bool = False  # temperature > 0 with a per-request seed
    max_tokens: Tuple[int, int] = (4, 12)  # inclusive range
    # chat shape
    turns: int = 3
    think_time_s: float = 3.0  # mean exponential gap between turns
    turn_chars: Tuple[int, int] = (80, 200)
    # completion shape
    prompt_chars: Tuple[int, int] = (200, 600)


@dataclass(frozen=True)
class WorkloadSpec:
    duration_s: float = 60.0
    arrival: ArrivalSpec = field(default_factory=ArrivalSpec)
    classes: Tuple[TenantClass, ...] = ()

    def to_dict(self) -> dict:
        return {
            "duration_s": self.duration_s,
            "arrival": {
                "process": self.arrival.process,
                "rate_rps": self.arrival.rate_rps,
                "amplitude": self.arrival.amplitude,
                "period_s": self.arrival.period_s,
            },
            "classes": [
                {
                    "name": c.name,
                    "kind": c.kind,
                    "share": c.share,
                    "tenants": c.tenants,
                    "priority": c.priority,
                    "ttft_slo_ms": c.ttft_slo_ms,
                    "tpot_slo_ms": c.tpot_slo_ms,
                    "stream": c.stream,
                    "temperature": c.temperature,
                    "seeded": c.seeded,
                    "max_tokens": list(c.max_tokens),
                    "turns": c.turns,
                    "think_time_s": c.think_time_s,
                    "turn_chars": list(c.turn_chars),
                    "prompt_chars": list(c.prompt_chars),
                }
                for c in self.classes
            ],
        }


def validate_spec(data) -> List[str]:
    """Offline spec validation → list of error strings (empty = valid).
    Mirrors ``faults.validate_plan``: shape and enum checks only, no
    compilation, nothing imported."""
    errors: List[str] = []
    if not isinstance(data, dict):
        return [f"spec must be a JSON object, got {type(data).__name__}"]
    unknown = set(data) - {"duration_s", "arrival", "classes"}
    if unknown:
        errors.append(f"unknown top-level keys: {sorted(unknown)}")
    dur = data.get("duration_s", 60.0)
    if not isinstance(dur, (int, float)) or dur <= 0:
        errors.append(f"duration_s must be a positive number, got {dur!r}")
    arrival = data.get("arrival", {})
    if not isinstance(arrival, dict):
        errors.append("arrival must be an object")
        arrival = {}
    unknown_arrival = set(arrival) - {
        "process", "rate_rps", "amplitude", "period_s",
    }
    if unknown_arrival:
        errors.append(f"unknown arrival keys: {sorted(unknown_arrival)}")
    proc = arrival.get("process", "poisson")
    if proc not in _PROCESSES:
        errors.append(f"arrival.process {proc!r} not one of {_PROCESSES}")
    rate = arrival.get("rate_rps", 3.0)
    if not isinstance(rate, (int, float)) or rate <= 0:
        errors.append(f"arrival.rate_rps must be positive, got {rate!r}")
    period = arrival.get("period_s", 60.0)
    if not isinstance(period, (int, float)) or period <= 0:
        errors.append(f"arrival.period_s must be positive, got {period!r}")
    amp = arrival.get("amplitude", 0.5)
    if not isinstance(amp, (int, float)) or not 0.0 <= amp <= 1.0:
        errors.append(
            f"arrival.amplitude must be in [0, 1], got {amp!r}"
        )
    classes = data.get("classes")
    if classes is None:
        return errors + ["classes is required (at least one tenant class)"]
    if not isinstance(classes, list) or not classes:
        return errors + ["classes must be a non-empty list"]
    known_class_keys = {
        "name", "kind", "share", "tenants", "priority", "ttft_slo_ms",
        "tpot_slo_ms", "stream", "temperature", "seeded", "max_tokens",
        "turns", "think_time_s", "turn_chars", "prompt_chars",
    }
    for i, c in enumerate(classes):
        where = f"classes[{i}]"
        if not isinstance(c, dict):
            errors.append(f"{where}: must be an object")
            continue
        unknown_cls = set(c) - known_class_keys
        if unknown_cls:
            # a typo'd SLO field silently scoring against the default
            # target would be the worst kind of green: reject it, like
            # faults.validate_plan rejects unknown rule keys
            errors.append(f"{where}: unknown keys {sorted(unknown_cls)}")
        if not isinstance(c.get("name"), str) or not c.get("name"):
            errors.append(f"{where}: 'name' is required")
        kind = c.get("kind", "chat")
        if kind not in _KINDS:
            errors.append(f"{where}: kind {kind!r} not one of {_KINDS}")
        prio = c.get("priority", "standard")
        if prio not in _PRIORITIES:
            errors.append(
                f"{where}: priority {prio!r} not one of {_PRIORITIES}"
            )
        share = c.get("share", 1.0)
        if not isinstance(share, (int, float)) or share <= 0:
            errors.append(f"{where}: share must be positive, got {share!r}")
        tenants = c.get("tenants", 2)
        if not isinstance(tenants, int) or tenants < 1:
            errors.append(f"{where}: tenants must be an int >= 1")
        turns = c.get("turns", 3)
        if kind == "chat" and (not isinstance(turns, int) or turns < 1):
            errors.append(f"{where}: turns must be an int >= 1")
        # shared SLO-target validation (obs/slo.py: the same checker
        # SLOPolicy classes run through)
        errors.extend(validate_slo_target_fields(c, where))
        v = c.get("think_time_s")
        if v is not None and (not isinstance(v, (int, float)) or v <= 0):
            errors.append(
                f"{where}: think_time_s must be positive, got {v!r}"
            )
        for key in ("max_tokens", "turn_chars", "prompt_chars"):
            v = c.get(key)
            if v is None or isinstance(v, int):
                continue
            if not (
                isinstance(v, list)
                and len(v) == 2
                and all(isinstance(x, int) and x > 0 for x in v)
            ):
                errors.append(
                    f"{where}: {key} must be an int or [lo, hi] of "
                    f"positive ints, got {v!r}"
                )
        if c.get("seeded") and float(c.get("temperature") or 0.0) <= 0.0:
            errors.append(
                f"{where}: seeded=true needs temperature > 0 "
                "(greedy requests carry no sampling seed)"
            )
    names = [c.get("name") for c in classes if isinstance(c, dict)]
    if len(names) != len(set(names)):
        errors.append("class names must be unique")
    return errors


def spec_from_dict(data: dict) -> WorkloadSpec:
    """Parse + validate → :class:`WorkloadSpec`; raises ``ValueError``
    listing every problem (same failure mode as a bad fault plan: loud
    and before any replica is stood up)."""
    errors = validate_spec(data)
    if errors:
        raise ValueError("invalid workload spec: " + "; ".join(errors))
    arrival = data.get("arrival", {})
    classes = []
    for c in data["classes"]:
        classes.append(
            TenantClass(
                name=c["name"],
                kind=c.get("kind", "chat"),
                share=float(c.get("share", 1.0)),
                tenants=int(c.get("tenants", 2)),
                priority=c.get("priority", "standard"),
                ttft_slo_ms=float(c.get("ttft_slo_ms", DEFAULT_TTFT_SLO_MS)),
                tpot_slo_ms=float(c.get("tpot_slo_ms", DEFAULT_TPOT_SLO_MS)),
                stream=bool(c.get("stream", True)),
                temperature=float(c.get("temperature", 0.0)),
                seeded=bool(c.get("seeded", False)),
                max_tokens=bounds_pair(c.get("max_tokens"), (4, 12)),
                turns=int(c.get("turns", 3)),
                think_time_s=float(c.get("think_time_s", 3.0)),
                turn_chars=bounds_pair(c.get("turn_chars"), (80, 200)),
                prompt_chars=bounds_pair(c.get("prompt_chars"), (200, 600)),
            )
        )
    return WorkloadSpec(
        duration_s=float(data.get("duration_s", 60.0)),
        arrival=ArrivalSpec(
            process=arrival.get("process", "poisson"),
            rate_rps=float(arrival.get("rate_rps", 3.0)),
            amplitude=float(arrival.get("amplitude", 0.5)),
            period_s=float(arrival.get("period_s", 60.0)),
        ),
        classes=tuple(classes),
    )


def load_spec(text: str) -> WorkloadSpec:
    """Spec from inline JSON or ``@/path.json`` (the fault-plan
    convention)."""
    text = text.strip()
    if text.startswith("@"):
        with open(text[1:]) as f:
            return spec_from_dict(json.load(f))
    return spec_from_dict(json.loads(text))


def default_spec(
    duration_s: float = 75.0, rate_rps: float = 3.0
) -> WorkloadSpec:
    """The stock soak mix: interactive multi-turn chat (tight SLOs),
    standard chat, and one-shot batch completions (loose SLOs) — the
    "long multi-turn chats alongside batch completions" shape the
    roadmap's million-user envelope names. All classes are greedy so
    every stream is resumable across a mid-soak replica death."""
    return spec_from_dict({
        "duration_s": duration_s,
        "arrival": {"process": "poisson", "rate_rps": rate_rps},
        "classes": [
            {
                "name": "interactive",
                "kind": "chat",
                "share": 0.5,
                "tenants": 2,
                "priority": "interactive",
                "ttft_slo_ms": 2500.0,
                "tpot_slo_ms": 400.0,
                "turns": 4,
                "think_time_s": max(2.0, duration_s / 30.0),
                "turn_chars": [80, 200],
                "max_tokens": [4, 10],
            },
            {
                "name": "standard",
                "kind": "chat",
                "share": 0.3,
                "tenants": 2,
                "priority": "standard",
                "ttft_slo_ms": 5000.0,
                "tpot_slo_ms": 800.0,
                "turns": 3,
                "think_time_s": max(2.0, duration_s / 25.0),
                "turn_chars": [60, 160],
                "max_tokens": [4, 10],
            },
            {
                "name": "batch",
                "kind": "completion",
                "share": 0.2,
                "tenants": 1,
                "priority": "batch",
                "ttft_slo_ms": 15000.0,
                "tpot_slo_ms": 2000.0,
                "prompt_chars": [200, 500],
                "max_tokens": [6, 16],
            },
        ],
    })
