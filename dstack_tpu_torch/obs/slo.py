"""Live SLO engine: sliding windows, burn rates, multi-window alerts (own
copy of ``dstack_tpu.obs.slo``, no JAX import; ``server_signals``, which
reads the control plane's HTTP registry, comes with ROADMAP A7).

The serve histograms are *cumulative* — they can say "p95 since boot"
but not "TTFT p95 over the last 5 minutes" — and the loadgen report
scores SLOs only *offline*, after a soak ends. This module is
the live half: a sliding-window aggregator that snapshots existing
Counter/Histogram registries on a tick and derives windowed rates and
quantile/violation estimates from bucket deltas, a declarative
:class:`SLOPolicy` sharing the loadgen tenant-class target schema
(``ttft_slo_ms``/``tpot_slo_ms``), and a deterministic multi-window
**burn-rate** alert state machine (Google SRE Workbook ch. 5:
fast-burn 14.4× over 5m AND 1h pages; slow-burn 1× over 6h tickets).

Burn rate is dimensionless: over a window,

    burn = (bad events / total events) / error_budget

where the budget is the allowed bad fraction (``1 − latency_compliance``
for latency objectives, ``error_rate_slo`` for the error objective).
``burn == 1`` consumes the budget exactly as fast as allowed; 14.4×
over 5m+1h is the classic "2% of a 30-day budget in one hour" page.

Objectives compiled from a policy:

- ``ttft`` / ``tpot`` — latency compliance against the fleet-floor
  threshold (the LOOSEST class target: the serve histograms carry no
  class label, and judging a strict class against aggregate traffic
  would false-page on lenient traffic — see
  :func:`compile_objectives`; the loadgen report stays the per-class
  ground truth). Violation fractions are estimated from histogram
  **bucket deltas** (error bounded by bucket width; pinned by
  property test). The live TTFT estimate is the max of the
  engine-TTFT and queue-wait component violation fractions — a
  *lower bound* on client-observed violations (client TTFT = queue
  wait + engine TTFT), so the live engine never over-alerts relative
  to the offline report.
- ``error_rate`` — failed requests (replica-side request failures,
  server-side 5xx) over all requests.
- ``shed_honesty`` — sheds emitted without a Retry-After hint over all
  sheds (an invariant watch: DTPU007 makes this structurally zero;
  a nonzero burn here means the shed contract itself broke).

Design constraints, in order (the ``faults``/``tracing`` contract):

- **Zero cost when disabled.** ``DTPU_SLO=0`` restores the no-op
  binding: :func:`replica_slo` IS :func:`_noop_replica_slo` (pinned by
  test), the replica /health pays one attribute load, and the server
  never registers the ``process_slo`` loop.
- **Bounded.** Per-window snapshot rings hold at most
  :data:`RING_SLOTS` anchors each; the transition log and per-scope
  state are bounded; gauge label sets ride the obs cardinality cap.
- **Deterministic.** The alert state machine is a pure function of the
  (clock, signal) sequence — same inputs on a fake clock → the same
  transition sequence, byte for byte (pinned by test).
- **Import-light.** Stdlib + ``obs.metrics`` only — no aiohttp, no
  jax (pinned by test, like ``faults/`` and ``obs/tracing.py``), so
  the loadgen generator path and the offline ``--validate`` CLI load
  it anywhere.

Env (documented in docs/reference/server.md):

- ``DTPU_SLO`` (default 1): 0/false disables the engine everywhere.
- ``DTPU_SLO_WINDOWS`` (default ``5m,30m,1h,6h``): the window set.
- ``DTPU_SLO_TICK`` (default 5.0): evaluation tick seconds (the server
  loop interval and the replica aggregator's minimum tick spacing).
- ``DTPU_SLO_POLICY``: policy JSON (inline or ``@/path.json``); unset
  uses :func:`default_policy`.
- ``DTPU_BG_TICK_SCALE`` multiplies every window and hold-down, so the
  chaos suite runs the real engine on a fast clock (testing.md).

Offline validation: ``python -m dstack_tpu_torch.obs.slo --validate POLICY``
(the ``faults``/``loadgen`` convention; tier-1 smoke via subprocess).
"""

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dstack_tpu_torch.obs.metrics import Registry

__all__ = [
    "DEFAULT_TTFT_SLO_MS",
    "DEFAULT_TPOT_SLO_MS",
    "validate_slo_target_fields",
    "parse_window",
    "window_scale",
    "default_windows",
    "SlidingWindows",
    "quantile_from_counts",
    "fraction_over",
    "merge_windows",
    "ClassTarget",
    "BurnRule",
    "SLOPolicy",
    "validate_policy",
    "policy_from_dict",
    "load_policy",
    "default_policy",
    "policy_from_env",
    "Objective",
    "compile_objectives",
    "objective_burn",
    "AlertTransition",
    "SLOEngine",
    "ReplicaSLO",
    "replica_slo",
    "serve_signals",
    "new_slo_registry",
    "get_slo_registry",
    "enabled",
    "enable",
    "disable",
]


# ---------------------------------------------------------------------------
# the one SLO-target schema (shared with the loadgen spec, ROADMAP A4.2)
# ---------------------------------------------------------------------------

#: Default per-class latency targets. ``loadgen.spec.TenantClass`` and
#: :class:`ClassTarget` both default from HERE — one definition, so the
#: offline goodput scorer and the live burn engine cannot drift.
DEFAULT_TTFT_SLO_MS = 2000.0
DEFAULT_TPOT_SLO_MS = 500.0

#: the shared field names (loadgen spec keys == policy class keys)
SLO_TARGET_KEYS = ("ttft_slo_ms", "tpot_slo_ms")


def validate_slo_target_fields(c: dict, where: str) -> List[str]:
    """Validate the shared ``ttft_slo_ms``/``tpot_slo_ms`` fields of
    one class dict → error strings (the loadgen spec validator and
    :func:`validate_policy` both call this — satellite: de-dup)."""
    errors: List[str] = []
    for key in SLO_TARGET_KEYS:
        v = c.get(key)
        if v is not None and (not isinstance(v, (int, float)) or v <= 0):
            errors.append(f"{where}: {key} must be positive, got {v!r}")
    return errors


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

DEFAULT_WINDOW_SPEC = "5m,30m,1h,6h"

#: snapshot anchors kept per window ring: resolution ≈ window/RING_SLOTS
RING_SLOTS = 64

_UNIT_S = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_window(name: str) -> Optional[float]:
    """``"5m"`` → 300.0 seconds; None when unparseable."""
    if not isinstance(name, str) or len(name) < 2:
        return None
    unit = _UNIT_S.get(name[-1])
    if unit is None:
        return None
    try:
        n = float(name[:-1])
    except ValueError:
        return None
    return n * unit if n > 0 else None


def window_scale() -> float:
    """``DTPU_BG_TICK_SCALE`` (the background-scheduler contract):
    multiplies every window and hold-down so chaos tests run the real
    burn math on a fast clock."""
    try:
        scale = float(os.getenv("DTPU_BG_TICK_SCALE", "") or 1.0)
    except ValueError:
        return 1.0
    return scale if scale > 0 else 1.0


def default_windows(scale: Optional[float] = None) -> Dict[str, float]:
    """The configured window set: ``DTPU_SLO_WINDOWS`` names → scaled
    seconds (unparseable entries dropped; empty set falls back to the
    default spec)."""
    spec = os.getenv("DTPU_SLO_WINDOWS", "") or DEFAULT_WINDOW_SPEC
    scale = window_scale() if scale is None else scale
    out: Dict[str, float] = {}
    for raw in spec.split(","):
        name = raw.strip()
        w = parse_window(name)
        if w is not None:
            out[name] = w * scale
    if not out:
        for name in DEFAULT_WINDOW_SPEC.split(","):
            out[name] = parse_window(name) * scale  # type: ignore[operator]
    return out


# ---------------------------------------------------------------------------
# bucket-delta estimators
# ---------------------------------------------------------------------------


def quantile_from_counts(
    bounds: Sequence[float], counts: Sequence[float], q: float
) -> Optional[float]:
    """Quantile estimate from per-bucket (non-cumulative) counts over
    log-spaced bounds, linear interpolation inside the covering bucket.
    The +Inf bucket (``counts[-1]``) reports the last finite bound —
    there is nothing to interpolate against. Error is bounded by the
    covering bucket's width (pinned by property test)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    lo = 0.0
    for i, b in enumerate(bounds):
        nxt = acc + counts[i]
        if nxt >= target and counts[i] > 0:
            frac = (target - acc) / counts[i]
            return lo + (b - lo) * frac
        acc, lo = nxt, b
    return bounds[-1] if bounds else None


def fraction_over(
    bounds: Sequence[float], counts: Sequence[float], threshold: float
) -> Optional[float]:
    """Estimated fraction of observations above ``threshold`` from
    per-bucket counts (linear interpolation inside the bucket the
    threshold falls in). Observations in the +Inf bucket count as over
    only when the threshold is at or below the last finite bound —
    past it the estimate is conservatively 0 for that bucket (the
    error stays bounded by bucket width, never guessed)."""
    total = sum(counts)
    if total <= 0:
        return None
    over = 0.0
    lo = 0.0
    for i, b in enumerate(bounds):
        if b <= threshold:
            pass  # wholly at/below the threshold
        elif lo >= threshold:
            over += counts[i]  # wholly above
        else:
            over += counts[i] * (b - threshold) / (b - lo)
        lo = b
    if bounds and threshold <= bounds[-1]:
        over += counts[-1]  # +Inf bucket: everything ≥ last bound
    return min(1.0, over / total)


# ---------------------------------------------------------------------------
# signal snapshots + sliding windows
# ---------------------------------------------------------------------------
#
# A *signal snapshot* is a plain dict of cumulative values:
#   scalars  — "requests", "errors", "sheds", "sheds_unhinted"
#   hist blocks — "ttft", "tpot", "queue_wait":
#       {"le": [finite bounds], "counts": [per-bucket incl +Inf],
#        "sum": float, "count": float}
# A *window delta* has the same shape with deltas instead of cumulative
# values, plus "span_s". Both are JSON round-trippable — the replica
# ships its window deltas inside /health as `slo_windows`.


def _hist_block(hist) -> dict:
    counts, total_sum, total_count = hist.totals()
    return {
        "le": [float(b) for b in hist.buckets],
        "counts": [float(c) for c in counts],
        "sum": float(total_sum),
        "count": float(total_count),
    }


def _delta(new: dict, old: dict) -> dict:
    out: dict = {}
    for k, v in new.items():
        if isinstance(v, dict) and "counts" in v:
            ov = old.get(k)
            if not isinstance(ov, dict) or len(ov.get("counts", ())) != len(
                v["counts"]
            ):
                ov = {"counts": [0.0] * len(v["counts"]), "sum": 0.0,
                      "count": 0.0}
            out[k] = {
                "le": v.get("le", ()),
                # clamp at 0: a registry reset mid-window must read as
                # "no new events", never as negative counts
                "counts": [
                    max(0.0, a - b)
                    for a, b in zip(v["counts"], ov["counts"])
                ],
                "sum": max(0.0, v.get("sum", 0.0) - ov.get("sum", 0.0)),
                "count": max(
                    0.0, v.get("count", 0.0) - ov.get("count", 0.0)
                ),
            }
        elif isinstance(v, (int, float)):
            out[k] = max(0.0, float(v) - float(old.get(k, 0.0)))
    return out


def merge_windows(payloads: Sequence[dict]) -> dict:
    """Sum per-replica window payloads into one fleet payload: counts,
    sums and scalars add; ``span_s`` takes the max (the replicas tick
    independently, so spans differ by at most one tick)."""
    out: dict = {}
    for payload in payloads:
        if not isinstance(payload, dict):
            continue
        for wname, ws in payload.items():
            if not isinstance(ws, dict):
                continue
            acc = out.setdefault(wname, {})
            for k, v in ws.items():
                if k == "span_s":
                    acc[k] = max(acc.get(k, 0.0), float(v or 0.0))
                elif isinstance(v, dict) and "counts" in v:
                    cur = acc.get(k)
                    if not isinstance(cur, dict):
                        acc[k] = {
                            "le": list(v.get("le", ())),
                            "counts": [float(c) for c in v["counts"]],
                            "sum": float(v.get("sum", 0.0)),
                            "count": float(v.get("count", 0.0)),
                        }
                    elif len(cur.get("counts", ())) == len(v["counts"]):
                        cur["counts"] = [
                            a + float(b)
                            for a, b in zip(cur["counts"], v["counts"])
                        ]
                        cur["sum"] += float(v.get("sum", 0.0))
                        cur["count"] += float(v.get("count", 0.0))
                elif isinstance(v, (int, float)):
                    acc[k] = acc.get(k, 0.0) + float(v)
    return out


class SlidingWindows:
    """Bounded per-window rings of signal snapshots.

    Each window keeps its own deque of (t, snapshot) anchors with
    spacing ≥ window / :data:`RING_SLOTS`, pruned to span the window —
    memory is O(windows × RING_SLOTS) refs regardless of tick rate.
    :meth:`advance` appends the current snapshot (subject to spacing)
    and returns per-window deltas against each ring's oldest anchor;
    the effective span is ``min(window, age of oldest anchor)``, so a
    freshly-started process reports honest short spans instead of
    nothing."""

    def __init__(
        self,
        windows: Dict[str, float],
        clock: Callable[[], float] = time.monotonic,
        slots: int = RING_SLOTS,
    ):
        self.windows = dict(windows)
        self.clock = clock
        self.slots = max(2, int(slots))
        self._rings: Dict[str, deque] = {
            name: deque() for name in self.windows
        }

    def advance(
        self, signals: dict, now: Optional[float] = None
    ) -> Dict[str, dict]:
        """Record ``signals`` (cumulative snapshot) at ``now`` and
        return ``{window name: delta-with-span}`` for every window
        that has at least one prior anchor."""
        now = self.clock() if now is None else now
        out: Dict[str, dict] = {}
        for name, w in self.windows.items():
            ring = self._rings[name]
            # prune: keep exactly one anchor at/older than now - w so
            # the delta spans the whole window
            while len(ring) >= 2 and ring[1][0] <= now - w:
                ring.popleft()
            if ring:
                t0, anchor = ring[0]
                span = now - t0
                if span > 0:
                    d = _delta(signals, anchor)
                    d["span_s"] = round(span, 3)
                    out[name] = d
            spacing = w / self.slots
            if not ring or now - ring[-1][0] >= spacing:
                ring.append((now, signals))
        return out


# ---------------------------------------------------------------------------
# signal collectors
# ---------------------------------------------------------------------------


def serve_signals(serve_registry, qos_registry=None) -> dict:
    """Cumulative snapshot of a replica's own registries: requests,
    request errors, TTFT / queue-wait / TPOT histograms, plus QoS shed
    accounting when the process has a QoS edge."""
    sig: dict = {}
    for key, fam in (
        ("requests", "dtpu_serve_requests_total"),
        ("errors", "dtpu_serve_request_errors_total"),
    ):
        f = serve_registry.family(fam)
        if f is not None:
            sig[key] = f.total()
    for key, fam in (
        ("ttft", "dtpu_serve_ttft_seconds"),
        ("queue_wait", "dtpu_serve_queue_wait_seconds"),
        ("tpot", "dtpu_serve_tpot_seconds"),
    ):
        f = serve_registry.family(fam)
        if f is not None:
            sig[key] = _hist_block(f)
    if qos_registry is not None:
        f = qos_registry.family("dtpu_qos_shed_total")
        if f is not None:
            sig["sheds"] = f.total()
        f = qos_registry.family("dtpu_qos_shed_unhinted_total")
        if f is not None:
            sig["sheds_unhinted"] = f.total()
    return sig


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClassTarget:
    """Per-tenant-class latency targets — the loadgen schema, shared."""

    name: str
    ttft_slo_ms: float = DEFAULT_TTFT_SLO_MS
    tpot_slo_ms: float = DEFAULT_TPOT_SLO_MS


@dataclass(frozen=True)
class BurnRule:
    """One multi-window burn condition: every listed window must burn
    at ≥ ``factor`` for the condition to hold (the SRE Workbook's
    short-window/long-window AND)."""

    severity: str  # "fast" | "slow"
    factor: float
    windows: Tuple[str, ...]


_DEFAULT_FAST = BurnRule("fast", 14.4, ("5m", "1h"))
_DEFAULT_SLOW = BurnRule("slow", 1.0, ("6h",))


@dataclass(frozen=True)
class SLOPolicy:
    name: str = "default"
    classes: Tuple[ClassTarget, ...] = (ClassTarget("default"),)
    #: fraction of requests that must meet each latency target
    latency_compliance: float = 0.95
    #: allowed failed-request fraction (the error budget)
    error_rate_slo: float = 0.001
    #: watch the shed contract (429s without a Retry-After hint)
    shed_honesty: bool = True
    fast: BurnRule = _DEFAULT_FAST
    slow: BurnRule = _DEFAULT_SLOW
    #: pending → firing after burning this long (scaled by
    #: DTPU_BG_TICK_SCALE, like the windows)
    hold_down_s: float = 60.0
    #: firing → resolved after NOT burning this long
    resolve_after_s: float = 120.0
    #: windows with fewer total events than this yield no verdict
    min_events: int = 10

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "classes": [
                {
                    "name": c.name,
                    "ttft_slo_ms": c.ttft_slo_ms,
                    "tpot_slo_ms": c.tpot_slo_ms,
                }
                for c in self.classes
            ],
            "latency_compliance": self.latency_compliance,
            "error_rate_slo": self.error_rate_slo,
            "shed_honesty": self.shed_honesty,
            "fast_burn": {
                "factor": self.fast.factor,
                "windows": list(self.fast.windows),
            },
            "slow_burn": {
                "factor": self.slow.factor,
                "windows": list(self.slow.windows),
            },
            "hold_down_s": self.hold_down_s,
            "resolve_after_s": self.resolve_after_s,
            "min_events": self.min_events,
        }


_POLICY_KEYS = {
    "name", "classes", "latency_compliance", "error_rate_slo",
    "shed_honesty", "fast_burn", "slow_burn", "hold_down_s",
    "resolve_after_s", "min_events",
}


def _validate_burn_rule(data, where: str) -> List[str]:
    errors: List[str] = []
    if not isinstance(data, dict):
        return [f"{where}: must be an object"]
    unknown = set(data) - {"factor", "windows"}
    if unknown:
        errors.append(f"{where}: unknown keys {sorted(unknown)}")
    factor = data.get("factor")
    if factor is not None and (
        not isinstance(factor, (int, float)) or factor <= 0
    ):
        errors.append(f"{where}: factor must be positive, got {factor!r}")
    windows = data.get("windows")
    if windows is not None:
        if not isinstance(windows, list) or not windows:
            errors.append(f"{where}: windows must be a non-empty list")
        else:
            for w in windows:
                if parse_window(w) is None:
                    errors.append(
                        f"{where}: unparseable window {w!r} "
                        "(use e.g. '5m', '1h')"
                    )
    return errors


def validate_policy(data) -> List[str]:
    """Offline policy validation → list of error strings (empty =
    valid). Mirrors ``faults.validate_plan`` / ``loadgen.
    validate_spec``: shape and enum checks, nothing instantiated,
    unknown keys rejected so a typo'd objective can't silently score
    against a default."""
    errors: List[str] = []
    if not isinstance(data, dict):
        return [f"policy must be a JSON object, got {type(data).__name__}"]
    unknown = set(data) - _POLICY_KEYS
    if unknown:
        errors.append(f"unknown top-level keys: {sorted(unknown)}")
    name = data.get("name", "default")
    if not isinstance(name, str) or not name:
        errors.append(f"name must be a non-empty string, got {name!r}")
    classes = data.get("classes", [{"name": "default"}])
    if not isinstance(classes, list) or not classes:
        errors.append("classes must be a non-empty list")
        classes = []
    names = []
    for i, c in enumerate(classes):
        where = f"classes[{i}]"
        if not isinstance(c, dict):
            errors.append(f"{where}: must be an object")
            continue
        unknown_cls = set(c) - ({"name"} | set(SLO_TARGET_KEYS))
        if unknown_cls:
            errors.append(f"{where}: unknown keys {sorted(unknown_cls)}")
        if not isinstance(c.get("name"), str) or not c.get("name"):
            errors.append(f"{where}: 'name' is required")
        else:
            names.append(c["name"])
        errors.extend(validate_slo_target_fields(c, where))
    if len(names) != len(set(names)):
        errors.append("class names must be unique")
    for key, lo, hi in (
        ("latency_compliance", 0.0, 1.0),
        ("error_rate_slo", 0.0, 1.0),
    ):
        v = data.get(key)
        if v is not None and (
            not isinstance(v, (int, float)) or not lo < v < hi
        ):
            errors.append(
                f"{key} must be a number in ({lo}, {hi}), got {v!r}"
            )
    if "shed_honesty" in data and not isinstance(
        data["shed_honesty"], bool
    ):
        errors.append("shed_honesty must be a boolean")
    for key in ("fast_burn", "slow_burn"):
        if key in data:
            errors.extend(_validate_burn_rule(data[key], key))
    for key in ("hold_down_s", "resolve_after_s"):
        v = data.get(key)
        if v is not None and (not isinstance(v, (int, float)) or v < 0):
            errors.append(f"{key} must be a non-negative number, got {v!r}")
    me = data.get("min_events")
    if me is not None and (not isinstance(me, int) or me < 1):
        errors.append(f"min_events must be an int >= 1, got {me!r}")
    return errors


def policy_from_dict(data: dict) -> SLOPolicy:
    """Parse + validate → :class:`SLOPolicy`; raises ``ValueError``
    listing every problem (the fault-plan failure mode: loud, before
    any engine evaluates)."""
    errors = validate_policy(data)
    if errors:
        raise ValueError("invalid SLO policy: " + "; ".join(errors))
    classes = tuple(
        ClassTarget(
            name=c["name"],
            ttft_slo_ms=float(c.get("ttft_slo_ms", DEFAULT_TTFT_SLO_MS)),
            tpot_slo_ms=float(c.get("tpot_slo_ms", DEFAULT_TPOT_SLO_MS)),
        )
        for c in data.get("classes", [{"name": "default"}])
    )
    fast_raw = data.get("fast_burn", {})
    slow_raw = data.get("slow_burn", {})
    return SLOPolicy(
        name=data.get("name", "default"),
        classes=classes,
        latency_compliance=float(data.get("latency_compliance", 0.95)),
        error_rate_slo=float(data.get("error_rate_slo", 0.001)),
        shed_honesty=bool(data.get("shed_honesty", True)),
        fast=BurnRule(
            "fast",
            float(fast_raw.get("factor", _DEFAULT_FAST.factor)),
            tuple(fast_raw.get("windows", _DEFAULT_FAST.windows)),
        ),
        slow=BurnRule(
            "slow",
            float(slow_raw.get("factor", _DEFAULT_SLOW.factor)),
            tuple(slow_raw.get("windows", _DEFAULT_SLOW.windows)),
        ),
        hold_down_s=float(data.get("hold_down_s", 60.0)),
        resolve_after_s=float(data.get("resolve_after_s", 120.0)),
        min_events=int(data.get("min_events", 10)),
    )


def load_policy(text: str) -> SLOPolicy:
    """Policy from inline JSON or ``@/path.json`` (the fault-plan
    convention)."""
    text = text.strip()
    if text.startswith("@"):
        with open(text[1:]) as f:
            return policy_from_dict(json.load(f))
    return policy_from_dict(json.loads(text))


def default_policy() -> SLOPolicy:
    """The stock fleet policy: one ``default`` class at the shared
    target defaults, 95% latency compliance, 99.9% availability,
    Workbook burn rules."""
    return SLOPolicy()


def policy_from_env() -> SLOPolicy:
    """``DTPU_SLO_POLICY`` (inline JSON or ``@path``) or the default.
    An unparseable policy falls back to the default LOUDLY (log at
    error) — a broken policy must degrade to stock alerting, not to
    no alerting."""
    raw = os.getenv("DTPU_SLO_POLICY", "").strip()
    if not raw:
        return default_policy()
    try:
        return load_policy(raw)
    except (OSError, ValueError) as e:
        from dstack_tpu_torch.utils.logging import get_logger

        get_logger("obs.slo").error(
            "DTPU_SLO_POLICY invalid (%s); using the default policy", e
        )
        return default_policy()


# ---------------------------------------------------------------------------
# objectives + burn math
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Objective:
    oid: str  # "ttft:interactive" | "tpot:batch" | "error_rate" | ...
    kind: str  # "ttft" | "tpot" | "error_rate" | "shed_honesty"
    budget: float  # allowed bad fraction
    threshold_s: Optional[float] = None  # latency objectives only


def compile_objectives(policy: SLOPolicy) -> Tuple[Objective, ...]:
    """Policy → live objectives. The serve histograms carry NO
    tenant-class label (labeling them per class would multiply bucket
    series by the class count), so the live latency objectives
    evaluate ONE fleet-floor threshold per metric: the LOOSEST class
    target. A request over the loosest target violates every class's
    target including its own, so the fleet-floor violation fraction
    lower-bounds the true per-class one — the live engine can
    under-alert on a strict class, never false-page because lenient
    traffic was slow (the loadgen report stays the per-class ground
    truth). With one class the floor IS that class's target and the
    objective id keeps its name."""
    objs: List[Objective] = []
    latency_budget = max(1e-9, 1.0 - policy.latency_compliance)
    suffix = (
        f":{policy.classes[0].name}" if len(policy.classes) == 1 else ""
    )
    objs.append(Objective(
        f"ttft{suffix}", "ttft", latency_budget,
        max(c.ttft_slo_ms for c in policy.classes) / 1e3,
    ))
    objs.append(Objective(
        f"tpot{suffix}", "tpot", latency_budget,
        max(c.tpot_slo_ms for c in policy.classes) / 1e3,
    ))
    objs.append(Objective(
        "error_rate", "error_rate", max(1e-9, policy.error_rate_slo)
    ))
    if policy.shed_honesty:
        objs.append(Objective("shed_honesty", "shed_honesty", 1e-3))
    return tuple(objs)


def _hist_fraction_over(block, threshold: float) -> Optional[float]:
    if not isinstance(block, dict):
        return None
    le = block.get("le")
    counts = block.get("counts")
    if not le or not counts or len(counts) != len(le) + 1:
        return None
    return fraction_over(le, counts, threshold)


def objective_burn(
    obj: Objective, ws: dict, min_events: int,
    window_s: Optional[float] = None,
) -> Optional[float]:
    """Burn rate of one objective over one window's signal deltas, or
    None when the window carries no verdict (no data / below
    ``min_events``). Burn = bad_fraction / budget, scaled by the
    window's observed **coverage** (``min(1, span_s / window_s)``)
    when ``window_s`` is given: a freshly-started process's "1h"
    window spanning 60s treats the unobserved 59 minutes as good, so
    a startup blip cannot satisfy the long-window materiality check —
    the damping the multi-window AND exists to provide."""
    coverage = 1.0
    if window_s and window_s > 0:
        span = ws.get("span_s")
        if isinstance(span, (int, float)) and span > 0:
            coverage = min(1.0, float(span) / float(window_s))
    burn = _objective_bad_ratio(obj, ws, min_events)
    return None if burn is None else burn * coverage


def _objective_bad_ratio(
    obj: Objective, ws: dict, min_events: int
) -> Optional[float]:
    if obj.kind in ("ttft", "tpot"):
        block = ws.get(obj.kind)
        if not isinstance(block, dict):
            return None
        total = block.get("count") or 0.0
        if total < min_events:
            return None
        frac = _hist_fraction_over(block, obj.threshold_s)
        if frac is None:
            return None
        if obj.kind == "ttft":
            # client TTFT = queue wait + engine TTFT; each component's
            # violation fraction lower-bounds the client's, so take the
            # max (conservative: never alerts on traffic the offline
            # report would score compliant)
            qfrac = _hist_fraction_over(
                ws.get("queue_wait"), obj.threshold_s
            )
            if qfrac is not None:
                frac = max(frac, qfrac)
        return frac / obj.budget
    if obj.kind == "error_rate":
        total = ws.get("requests")
        bad = ws.get("errors")
        if total is None or bad is None or total < min_events:
            return None
        return (bad / total) / obj.budget if total > 0 else None
    # shed_honesty: any shed is signal enough (min_events would hide a
    # broken contract behind low shed volume)
    total = ws.get("sheds")
    bad = ws.get("sheds_unhinted")
    if total is None or bad is None or total <= 0:
        return None
    return (bad / total) / obj.budget


# ---------------------------------------------------------------------------
# alert state machine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlertTransition:
    """One state-machine transition (the ``slo_alert`` run-event and
    soak-artifact payload). ``t`` is the engine clock (monotonic in
    production, fake in tests) — consumers stamp wall time."""

    t: float
    scope: str
    replica: Optional[str]
    objective: str
    severity: str
    state: str  # "pending" | "firing" | "resolved" | "cancelled"
    burn: float

    def to_dict(self) -> dict:
        return {
            "t": round(self.t, 3),
            "scope": self.scope,
            "replica": self.replica,
            "objective": self.objective,
            "severity": self.severity,
            "state": self.state,
            "burn": round(self.burn, 2),
        }


class _Alert:
    """inactive → pending → firing → (resolved →) inactive, with
    hold-down on both edges. Deterministic: state depends only on the
    (now, burning) update sequence."""

    __slots__ = ("state", "pending_since", "fired_at", "clear_since",
                 "last_burn")

    def __init__(self):
        self.state = "inactive"
        self.pending_since = 0.0
        self.fired_at = 0.0
        self.clear_since: Optional[float] = None
        self.last_burn = 0.0

    def update(
        self, now: float, burning: bool, burn: float,
        hold: float, resolve_hold: float,
    ) -> Optional[str]:
        self.last_burn = burn
        if self.state == "inactive":
            if burning:
                self.state = "pending"
                self.pending_since = now
                return "pending"
        elif self.state == "pending":
            if not burning:
                self.state = "inactive"
                return "cancelled"
            if now - self.pending_since >= hold:
                self.state = "firing"
                self.fired_at = now
                self.clear_since = None
                return "firing"
        elif self.state == "firing":
            if burning:
                self.clear_since = None
            elif self.clear_since is None:
                self.clear_since = now
            elif now - self.clear_since >= resolve_hold:
                self.state = "inactive"
                return "resolved"
        return None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def new_slo_registry() -> Registry:
    """Registry pre-populated with every SLO-engine metric family."""
    r = Registry()
    r.gauge(
        "dtpu_slo_burn_rate",
        "Error-budget burn rate per objective, scope, and sliding "
        "window (1 = consuming budget exactly as fast as allowed; the "
        "fast-burn page fires at policy fast_burn.factor across its "
        "windows)",
        labelnames=("objective", "scope", "window"),
        max_series=512,
    )
    r.gauge(
        "dtpu_slo_error_budget_remaining",
        "Error budget remaining over the policy's longest window "
        "(1 = untouched, 0 = fully consumed, clamped at 0)",
        labelnames=("objective", "scope"),
        max_series=512,
    )
    r.gauge(
        "dtpu_slo_alerts_firing",
        "Burn-rate alerts currently in the firing state, by severity",
        labelnames=("severity",),
    )
    r.counter(
        "dtpu_slo_alert_transitions_total",
        "Alert state-machine transitions (pending/firing/resolved/"
        "cancelled) across all objectives and scopes",
        labelnames=("state",),
    )
    r.counter(
        "dtpu_slo_evaluations_total",
        "SLO engine evaluation ticks in this process",
    )
    return r


_registry: Optional[Registry] = None


def get_slo_registry() -> Registry:
    """The process-global SLO registry (rendered on the server's, the
    gateway's, and the OpenAI server's ``/metrics``)."""
    global _registry
    if _registry is None:
        _registry = new_slo_registry()
    return _registry


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_SCOPE_GC_AFTER_TICKS = 120  # evaluations without data before a scope drops


class _Scope:
    __slots__ = ("agg", "ingested_at", "ingested", "latest", "idle_ticks")

    def __init__(self):
        self.agg: Optional[SlidingWindows] = None  # own-aggregated scopes
        self.ingested_at = 0.0  # pre-windowed scopes (replica /health)
        self.ingested: Optional[dict] = None
        self.latest: Dict[str, dict] = {}  # window name -> signal deltas
        self.idle_ticks = 0


class SLOEngine:
    """Multi-scope burn-rate evaluation + alert state machines.

    Scopes are ``(scope, replica)`` keys: ``("server", None)`` for the
    control plane's own traffic, ``("<project>/<run>", None)`` for a
    service fleet, ``("<project>/<run>", "<rid>")`` per replica. Feed
    raw cumulative snapshots with :meth:`tick_scope` (the engine
    aggregates) or pre-windowed payloads with :meth:`ingest_windows`
    (the probe loop relays each replica's own aggregation), then call
    :meth:`evaluate` once per tick."""

    def __init__(
        self,
        policy: Optional[SLOPolicy] = None,
        windows: Optional[Dict[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[Registry] = None,
        scale: Optional[float] = None,
        stale_after: Optional[float] = None,
    ):
        scale = window_scale() if scale is None else scale
        self.policy = policy or policy_from_env()
        self.windows = (
            dict(windows) if windows is not None else default_windows(scale)
        )
        # a burn rule naming a window outside the configured set would
        # otherwise evaluate over an empty (or collapsed) window list —
        # silently disabling the alert and the slo-burn signal. Join
        # rule windows into the set instead (both the server's and each
        # replica's engine derive from the same env, so the window keys
        # stay consistent across the probe transport), loudly.
        for rule in (self.policy.fast, self.policy.slow):
            for name in rule.windows:
                if name not in self.windows:
                    w = parse_window(name)
                    if w is None:
                        continue  # validate_policy already rejects these
                    self.windows[name] = w * scale
                    from dstack_tpu_torch.utils.logging import get_logger

                    get_logger("obs.slo").warning(
                        "%s burn window %r is not in the configured "
                        "window set (DTPU_SLO_WINDOWS); adding it so "
                        "the rule stays evaluable",
                        rule.severity, name,
                    )
        self.objectives = compile_objectives(self.policy)
        self.clock = clock
        self.registry = registry if registry is not None else get_slo_registry()
        self.hold = self.policy.hold_down_s * scale
        self.resolve_hold = self.policy.resolve_after_s * scale
        #: ingested payloads older than this are no verdict (a dead
        #: replica's last windows must age out, not burn forever).
        #: Floor of 5 REAL seconds: probe cadence does not shrink with
        #: DTPU_BG_TICK_SCALE, and a scaled-down staleness bound must
        #: not flap live replicas between probes
        self.stale_after = (
            stale_after
            if stale_after is not None
            else max(5.0, 15.0 * scale, 3.0 * _env_tick() * scale)
        )
        self._scopes: Dict[Tuple[str, Optional[str]], _Scope] = {}
        self._alerts: Dict[Tuple, _Alert] = {}
        self.transitions: deque = deque(maxlen=512)
        self._longest = (
            max(self.windows, key=self.windows.get) if self.windows else None
        )

    # -- feeding --

    def _scope(self, scope: str, replica: Optional[str]) -> _Scope:
        key = (scope, str(replica) if replica is not None else None)
        s = self._scopes.get(key)
        if s is None:
            s = self._scopes[key] = _Scope()
        return s

    def tick_scope(
        self, scope: str, signals: dict,
        replica: Optional[str] = None, now: Optional[float] = None,
    ) -> Dict[str, dict]:
        """Aggregate one cumulative snapshot for a scope this engine
        windows itself; returns the window deltas (the replica /health
        payload shape)."""
        now = self.clock() if now is None else now
        s = self._scope(scope, replica)
        if s.agg is None:
            s.agg = SlidingWindows(self.windows, clock=self.clock)
        s.latest = s.agg.advance(signals, now)
        s.idle_ticks = 0
        return s.latest

    def ingest_windows(
        self, scope: str, replica: Optional[str], windows_payload: dict,
        now: Optional[float] = None,
    ) -> None:
        """Accept a pre-windowed payload (a replica's ``slo_windows``
        /health block, or a fleet merge of several)."""
        if not isinstance(windows_payload, dict):
            return
        s = self._scope(scope, replica)
        s.ingested_at = self.clock() if now is None else now
        s.ingested = windows_payload
        s.idle_ticks = 0

    def scope_windows(
        self, scope: str, replica: Optional[str] = None
    ) -> Dict[str, dict]:
        key = (scope, str(replica) if replica is not None else None)
        s = self._scopes.get(key)
        if s is None:
            return {}
        return s.latest or s.ingested or {}

    # -- evaluation --

    def _current(self, now: float):
        """(key, windows) for every scope with a live verdict source."""
        for key, s in self._scopes.items():
            if s.agg is not None and s.latest:
                yield key, s.latest
            elif (
                s.ingested is not None
                and now - s.ingested_at <= self.stale_after
            ):
                yield key, s.ingested

    def evaluate(self, now: Optional[float] = None) -> List[AlertTransition]:
        """One evaluation tick: burn rates per (scope × objective ×
        window) into the gauges, every alert state machine advanced,
        transitions returned (and appended to :attr:`transitions`)."""
        now = self.clock() if now is None else now
        m = self.registry
        m.family("dtpu_slo_evaluations_total").inc(1)
        out: List[AlertTransition] = []
        live = dict(self._current(now))
        for key, s in self._scopes.items():
            if key not in live:
                s.idle_ticks += 1
        for key, wins in live.items():
            scope, replica = key
            scope_label = scope if replica is None else f"{scope}#{replica}"
            for obj in self.objectives:
                burns: Dict[str, Optional[float]] = {}
                for wname in self.windows:
                    ws = wins.get(wname)
                    burns[wname] = (
                        objective_burn(
                            obj, ws, self.policy.min_events,
                            window_s=self.windows[wname],
                        )
                        if isinstance(ws, dict)
                        else None
                    )
                    if burns[wname] is not None:
                        m.family("dtpu_slo_burn_rate").set(
                            round(burns[wname], 4),
                            obj.oid, scope_label, wname,
                        )
                    else:
                        # no verdict (traffic fell below min_events):
                        # a frozen last value would read as a
                        # sustained burn long after the episode — an
                        # absent series is the honest exposition
                        m.family("dtpu_slo_burn_rate").remove(
                            obj.oid, scope_label, wname,
                        )
                if self._longest is not None:
                    b = burns.get(self._longest)
                    if b is not None:
                        m.family("dtpu_slo_error_budget_remaining").set(
                            round(max(0.0, 1.0 - b), 4),
                            obj.oid, scope_label,
                        )
                    else:
                        m.family("dtpu_slo_error_budget_remaining").remove(
                            obj.oid, scope_label,
                        )
                for rule in (self.policy.fast, self.policy.slow):
                    out.extend(
                        self._update_alert(key, obj, rule, burns, now)
                    )
        # scopes that stopped reporting: let their alerts resolve
        # instead of freezing in firing forever
        for (key, oid, severity), alert in list(self._alerts.items()):
            if key in live or alert.state == "inactive":
                continue
            state = alert.update(
                now, False, 0.0, self.hold, self.resolve_hold
            )
            if state is not None:
                obj_sev = severity
                out.append(AlertTransition(
                    now, key[0], key[1], oid, obj_sev, state, 0.0,
                ))
        self._gc()
        for tr in out:
            m.family("dtpu_slo_alert_transitions_total").inc(1, tr.state)
            self.transitions.append(tr)
        firing = {"fast": 0, "slow": 0}
        for (_, _, severity), alert in self._alerts.items():
            if alert.state == "firing":
                firing[severity] = firing.get(severity, 0) + 1
        m.family("dtpu_slo_alerts_firing").set(firing.get("fast", 0), "fast")
        m.family("dtpu_slo_alerts_firing").set(firing.get("slow", 0), "slow")
        return out

    def _update_alert(
        self, key, obj: Objective, rule: BurnRule,
        burns: Dict[str, Optional[float]], now: float,
    ) -> List[AlertTransition]:
        rule_windows = [w for w in rule.windows if w in self.windows]
        if not rule_windows:
            return []
        vals = [burns.get(w) for w in rule_windows]
        burning = all(v is not None and v >= rule.factor for v in vals)
        present = [v for v in vals if v is not None]
        rep_burn = min(present) if present else 0.0
        akey = (key, obj.oid, rule.severity)
        alert = self._alerts.get(akey)
        if alert is None:
            if not burning:
                return []  # don't mint state for quiet alerts
            alert = self._alerts[akey] = _Alert()
        state = alert.update(
            now, burning, rep_burn, self.hold, self.resolve_hold
        )
        if state is None:
            return []
        return [AlertTransition(
            now, key[0], key[1], obj.oid, rule.severity, state, rep_burn,
        )]

    def _gc(self) -> None:
        dead = [
            key for key, s in self._scopes.items()
            if s.idle_ticks > _SCOPE_GC_AFTER_TICKS
        ]
        for key in dead:
            del self._scopes[key]
            for akey in [a for a in self._alerts if a[0] == key]:
                if self._alerts[akey].state == "inactive":
                    del self._alerts[akey]
            # drop the scope's gauge series with it: scope-label churn
            # (service redeploys minting new replica ids) must not fill
            # the cardinality cap with frozen burn values
            scope, replica = key
            scope_label = scope if replica is None else f"{scope}#{replica}"
            burn_g = self.registry.family("dtpu_slo_burn_rate")
            budget_g = self.registry.family("dtpu_slo_error_budget_remaining")
            for obj in self.objectives:
                for wname in self.windows:
                    burn_g.remove(obj.oid, scope_label, wname)
                budget_g.remove(obj.oid, scope_label)

    # -- consumers --

    def fleet_burn(self, scope: str) -> Optional[float]:
        """Worst current burn across this fleet scope's objectives over
        the policy's FAST windows — the ``slo-burn`` autoscaler signal.
        None when the scope has no verdict (scaler falls back to RPS)."""
        key = (scope, None)
        s = self._scopes.get(key)
        if s is None:
            return None
        wins = s.latest or s.ingested
        if not wins:
            return None
        if s.ingested is not None and not s.latest:
            if self.clock() - s.ingested_at > self.stale_after:
                return None
        worst: Optional[float] = None
        for obj in self.objectives:
            # min across the fast windows — the same AND the alert rule
            # applies, so the scaler's signal decays with the short
            # window instead of pinning high for the long window's span
            per_window = []
            for wname in self.policy.fast.windows:
                ws = wins.get(wname)
                if not isinstance(ws, dict):
                    continue
                b = objective_burn(
                    obj, ws, self.policy.min_events,
                    window_s=self.windows.get(wname),
                )
                if b is not None:
                    per_window.append(b)
            if per_window:
                b = min(per_window)
                if worst is None or b > worst:
                    worst = b
        return worst

    def status_payload(self) -> dict:
        """The ``GET /api/slo`` response body."""
        now = self.clock()
        scopes = []
        for key, wins in self._current(now):
            scope, replica = key
            per_obj = {}
            for obj in self.objectives:
                per_window = {}
                for wname in self.windows:
                    ws = wins.get(wname)
                    b = (
                        objective_burn(
                            obj, ws, self.policy.min_events,
                            window_s=self.windows[wname],
                        )
                        if isinstance(ws, dict)
                        else None
                    )
                    if b is not None:
                        per_window[wname] = round(b, 3)
                if per_window:
                    entry: dict = {"burn": per_window}
                    if self._longest in per_window:
                        entry["budget_remaining"] = round(
                            max(0.0, 1.0 - per_window[self._longest]), 4
                        )
                    per_obj[obj.oid] = entry
            scopes.append({
                "scope": scope,
                "replica": replica,
                "objectives": per_obj,
            })
        alerts = []
        for (key, oid, severity), alert in sorted(
            self._alerts.items(),
            key=lambda kv: (kv[0][0][0], kv[0][0][1] or "", kv[0][1], kv[0][2]),
        ):
            if alert.state == "inactive":
                continue
            alerts.append({
                "scope": key[0],
                "replica": key[1],
                "objective": oid,
                "severity": severity,
                "state": alert.state,
                "since": round(
                    alert.fired_at
                    if alert.state == "firing"
                    else alert.pending_since, 3,
                ),
                "burn": round(alert.last_burn, 2),
            })
        return {
            "enabled": True,
            "policy": self.policy.to_dict(),
            "windows_s": {k: round(v, 3) for k, v in self.windows.items()},
            "scopes": scopes,
            "alerts": alerts,
            "transitions": [tr.to_dict() for tr in list(self.transitions)[-64:]],
        }


# ---------------------------------------------------------------------------
# pool integration (shared by server process_slo and the soak's loop)
# ---------------------------------------------------------------------------


def ingest_pool_windows(
    engine: SLOEngine, pool, scope: str, now: Optional[float] = None
) -> int:
    """Feed one routing pool's probe-relayed ``slo_windows`` captures
    into ``engine``: every fresh replica payload under ``(scope,
    rid)`` plus one fleet merge under ``(scope, None)``. ``pool`` is
    duck-typed (``replica_ids``/``get`` with ``probe``/
    ``last_probe_at`` entries) so this module stays import-light.
    Returns the number of replicas ingested. The server's process_slo
    loop and the soak's live loop share THIS implementation — the
    staleness gate and merge semantics cannot drift between them."""
    now = time.monotonic() if now is None else now
    fleet = []
    for rid in pool.replica_ids():
        entry = pool.get(rid)
        if entry is None:
            continue
        wins = (getattr(entry, "probe", None) or {}).get("slo_windows")
        if not isinstance(wins, dict) or not wins:
            continue
        if (
            entry.last_probe_at <= 0
            or now - entry.last_probe_at > engine.stale_after
        ):
            continue  # a dead replica's last windows must age out
        engine.ingest_windows(scope, rid, wins)
        fleet.append(wins)
    if fleet:
        engine.ingest_windows(scope, None, merge_windows(fleet))
    return len(fleet)


def apply_replica_pins(
    pool, transitions: Sequence[AlertTransition],
    scope: Optional[str] = None,
) -> None:
    """The alert→routing feedback contract (serving.md §12), in one
    place: a per-replica FAST alert firing pins that replica DEGRADED
    on ``pool`` (``set_slo_degraded``); resolved/cancelled releases
    it. With ``scope``, only that scope's transitions apply (a
    multi-service engine feeding per-service pools)."""
    for tr in transitions:
        if tr.replica is None or tr.severity != "fast":
            continue
        if scope is not None and tr.scope != scope:
            continue
        if tr.state == "firing":
            pool.set_slo_degraded(tr.replica, True)
        elif tr.state in ("resolved", "cancelled"):
            pool.set_slo_degraded(tr.replica, False)


# ---------------------------------------------------------------------------
# replica-side holder (the /health `slo_windows` producer)
# ---------------------------------------------------------------------------


def _env_tick() -> float:
    try:
        tick = float(os.getenv("DTPU_SLO_TICK", "") or 5.0)
    except ValueError:
        return 5.0
    return tick if tick > 0 else 5.0


class ReplicaSLO:
    """Per-serve-process aggregation + local evaluation.

    Owns one :class:`SLOEngine` scope (``self``) fed from the process's
    own registries. :meth:`health_windows` is what the replica's
    ``/health`` embeds as ``slo_windows`` — the probe loop relays it to
    the control plane, so there is NO new scrape protocol. Ticking is
    lazy (driven by /health reads, i.e. by the prober's cadence),
    bounded below by ``DTPU_SLO_TICK`` × ``DTPU_BG_TICK_SCALE``."""

    def __init__(
        self,
        signal_fn: Callable[[], dict],
        policy: Optional[SLOPolicy] = None,
        windows: Optional[Dict[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
        tick_s: Optional[float] = None,
    ):
        scale = window_scale()
        self.signal_fn = signal_fn
        self.clock = clock
        self.tick_s = tick_s if tick_s is not None else _env_tick() * scale
        self.engine = SLOEngine(
            policy=policy, windows=windows, clock=clock, scale=scale
        )
        self._last_tick = 0.0

    def maybe_tick(self, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        if self._last_tick and now - self._last_tick < self.tick_s:
            return
        self._last_tick = now
        self.engine.tick_scope("self", self.signal_fn(), now=now)
        self.engine.evaluate(now)

    def health_windows(self) -> Dict[str, dict]:
        """The ``slo_windows`` /health block: this process's rolling
        per-window signal deltas (TTFT/queue-wait/TPOT bucket deltas,
        request/error/shed counts)."""
        self.maybe_tick()
        return self.engine.scope_windows("self")


def _noop_replica_slo(*args, **kwargs) -> None:
    return None


def _replica_slo(
    signal_fn: Callable[[], dict], **kwargs
) -> ReplicaSLO:
    return ReplicaSLO(signal_fn, **kwargs)


# the module-level binding (the faults.fire idiom): DTPU_SLO=0 keeps
# `replica_slo` bound to the no-op — tests pin the identity — and every
# consumer (openai_server, process_slo registration) checks `enabled()`
_enabled = False
replica_slo = _noop_replica_slo


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled, replica_slo
    _enabled = True
    replica_slo = _replica_slo


def disable() -> None:
    global _enabled, replica_slo
    _enabled = False
    replica_slo = _noop_replica_slo


def _env_on(name: str, default: str) -> bool:
    return os.getenv(name, default).strip().lower() not in (
        "0", "false", "no",
    )


def _install_from_env() -> None:
    if _env_on("DTPU_SLO", "1"):
        enable()


_install_from_env()


# ---------------------------------------------------------------------------
# offline CLI: python -m dstack_tpu_torch.obs.slo [--validate POLICY]
# ---------------------------------------------------------------------------


def _cli_load(arg: str) -> dict:
    import sys

    if arg == "-":
        return json.loads(sys.stdin.read())
    text = arg.strip()
    if text.startswith("@"):
        text = open(text[1:]).read()
    elif not text.lstrip().startswith("{"):
        text = open(text).read()  # bare path
    return json.loads(text)


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m dstack_tpu_torch.obs.slo",
        description=(
            "List the default SLO policy's objectives / validate a "
            "DTPU_SLO_POLICY offline."
        ),
    )
    p.add_argument(
        "--validate",
        metavar="POLICY",
        help="policy to validate: a file path, @path, inline JSON, or '-'",
    )
    args = p.parse_args(argv)
    if args.validate is None:
        policy = default_policy()
        windows = default_windows(scale=1.0)
        print(f"policy {policy.name!r} — objectives:\n")
        for obj in compile_objectives(policy):
            thr = (
                f" threshold={obj.threshold_s * 1e3:.0f}ms"
                if obj.threshold_s is not None
                else ""
            )
            print(f"  {obj.oid}: budget={obj.budget:.4f}{thr}")
        print(f"\nwindows: {', '.join(windows)}")
        print(
            f"fast burn: {policy.fast.factor}x over "
            f"{'+'.join(policy.fast.windows)}; slow burn: "
            f"{policy.slow.factor}x over {'+'.join(policy.slow.windows)}"
        )
        print(
            "\nActivate a policy via DTPU_SLO_POLICY (inline JSON or "
            "@path); validate one with --validate."
        )
        return 0
    try:
        data = _cli_load(args.validate)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot load policy: {e}", file=sys.stderr)
        return 1
    errors = validate_policy(data)
    if errors:
        print(f"policy invalid ({len(errors)} problem(s)):", file=sys.stderr)
        for err in errors:
            print(f"  - {err}", file=sys.stderr)
        return 1
    policy = policy_from_dict(data)
    print(
        f"policy {policy.name!r} valid: "
        f"{len(compile_objectives(policy))} objectives, "
        f"{len(policy.classes)} class(es)"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
