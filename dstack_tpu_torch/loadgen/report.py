"""Goodput-under-SLO evaluation → the ``SOAK_*.json`` artifact (the
port's copy of ``dstack_tpu.loadgen.report``).

The scoring contract (DistServe's argument): the
number that matters at scale is **goodput under SLO** — completions
that met their tenant class's TTFT/TPOT targets, per class, as a
fraction of everything that class asked for — not raw throughput. A
449-token/s soak that blew every interactive TTFT target is a failing
soak.

Outcome accounting is deliberately opinionated:

- A **429 with a Retry-After hint is QoS working**, not a failure —
  provided the hints are *honest*: every shed carries one, and within
  a tenant's consecutive run of sheds the hints never grow (the
  monotone contract ``qos.TokenBucket.retry_after`` documents). Sheds
  count against goodput's denominator (the work was asked for and not
  served) but never against ``failures``.
- A **5xx, a truncated stream, or an in-band terminal error event is
  always a failure** — under this harness the router's failover and
  mid-stream resume machinery exist precisely so clients never see
  one, so the chaos acceptance asserts ``failures == 0`` through a
  replica kill.

**Tail amplification** is scored per injected-event window (replica
kill, drain flip): TTFT p95 inside the window over the pre-window
baseline, plus the goodput dip and whether the post-window tail
recovered.

Import-light (stdlib only): unit tests score synthetic record lists
without aiohttp or torch.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: slack when checking the monotone Retry-After contract: hints are
#: floats derived from a refill schedule read a little later each time
_HINT_SLACK_S = 0.05

_FAILURE_OUTCOMES = (
    "failed_5xx", "failed_connect", "failed_truncated",
    "failed_stream_error", "abandoned",
)


@dataclass
class RequestRecord:
    """One fired event's terminal accounting (driver output)."""

    rid: str
    cls: str
    tenant: str
    t_sched: float  # compiled schedule time (soak-relative seconds)
    t_sent: float  # actual fire time (soak-relative seconds)
    outcome: str  # one of metrics.OUTCOMES
    session: Optional[str] = None
    turn: int = 0
    status: Optional[int] = None
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    tokens: int = 0
    retry_after: Optional[float] = None
    detail: str = ""
    # the router's X-DTPU-Trace response echo: the key that links this
    # record to its distributed trace for tail attribution
    trace_id: Optional[str] = None

    @property
    def lag_s(self) -> float:
        return max(0.0, self.t_sent - self.t_sched)


@dataclass(frozen=True)
class EventWindow:
    """One injected-event interval (soak-relative seconds) the report
    scores tail amplification over."""

    name: str
    start: float
    end: float

    def covers(self, t: float) -> bool:
        return self.start <= t < self.end


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over a small sample list (no numpy on
    the report path — same helper contract as serve/bench.py)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, round(q * (len(s) - 1))))]


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 1)


def _meets_slo(
    r: RequestRecord, ttft_slo_ms: float, tpot_slo_ms: float
) -> bool:
    if r.outcome != "ok" or r.ttft_s is None:
        return False
    if r.ttft_s * 1e3 > ttft_slo_ms:
        return False
    if r.tpot_s is not None and r.tpot_s * 1e3 > tpot_slo_ms:
        return False
    return True


def _shed_honesty(records: Sequence[RequestRecord]) -> dict:
    """Honest-shed accounting: every 429 carries a Retry-After, and
    within one tenant's consecutive shed run the hints never grow."""
    missing: List[str] = []
    grew: List[str] = []
    by_tenant: Dict[str, List[RequestRecord]] = {}
    for r in records:
        by_tenant.setdefault(r.tenant, []).append(r)
    sheds = 0
    for tenant, recs in by_tenant.items():
        recs.sort(key=lambda r: (r.t_sent, r.rid))
        prev_hint: Optional[float] = None
        for r in recs:
            if r.outcome != "shed":
                prev_hint = None  # an admit ends the flood run
                continue
            sheds += 1
            if r.retry_after is None:
                missing.append(r.rid)
                prev_hint = None
                continue
            if (
                prev_hint is not None
                and r.retry_after > prev_hint + _HINT_SLACK_S
            ):
                grew.append(r.rid)
            prev_hint = r.retry_after
    return {
        "sheds": sheds,
        "honest": not missing and not grew,
        "missing_retry_after": missing,
        "hint_grew": grew,
    }


#: TTFT-relevant phases a window's worst requests attribute to (decode
#: happens after the first token and is reported but never dominant)
_TTFT_PHASES = ("qos_queue", "prefill", "router_retry")


def attribute_trace_phases(trace) -> Optional[dict]:
    """One completed trace (the ``obs.tracing`` dict shape) → per-phase
    duration sums and the dominant TTFT phase, or None.

    Phases: ``qos_queue`` (serve.queue spans — admission-queue wait),
    ``prefill`` (serve.prefill), ``decode`` (serve.decode), and
    ``router_retry`` (router.dispatch legs that did NOT complete ok —
    the failover/resume overhead a kill window inflicts). Stdlib-only
    on purpose: the lookup callable is injected, so unit tests attribute
    synthetic trace dicts without aiohttp."""
    if not isinstance(trace, dict):
        return None
    sums = {
        "qos_queue": 0.0, "prefill": 0.0, "decode": 0.0,
        "router_retry": 0.0,
    }
    for s in trace.get("spans", []):
        d = s.get("duration_s") or 0.0
        name = s.get("name")
        if name == "serve.queue":
            sums["qos_queue"] += d
        elif name == "serve.prefill":
            sums["prefill"] += d
        elif name == "serve.decode":
            sums["decode"] += d
        elif name == "router.dispatch" and s.get("status") not in ("ok", None):
            sums["router_retry"] += d
    dominant = None
    if any(sums[k] > 0.0 for k in _TTFT_PHASES):
        dominant = max(_TTFT_PHASES, key=lambda k: sums[k])
    return {
        "phase_ms": {k: round(v * 1e3, 2) for k, v in sums.items()},
        "dominant_phase": dominant,
    }


def _worst_request_phases(
    records: Sequence[RequestRecord], trace_lookup, n: int = 3
) -> list:
    """The window's ``n`` worst completed requests by TTFT, each
    attributed to its dominant span phase via ``trace_lookup(trace_id)
    → trace dict or None`` (the soak passes ``obs.tracing.get_trace``
    — router and replicas share one in-process ring there)."""
    worst = sorted(
        (r for r in records if r.outcome == "ok" and r.ttft_s is not None),
        key=lambda r: r.ttft_s,
        reverse=True,
    )[: max(0, int(n))]
    out = []
    for r in worst:
        entry = {
            "rid": r.rid,
            "ttft_ms": _ms(r.ttft_s),
            "trace_id": r.trace_id,
        }
        attributed = (
            attribute_trace_phases(trace_lookup(r.trace_id))
            if r.trace_id
            else None
        )
        if attributed is not None:
            entry.update(attributed)
        else:
            # honest gap: the trace rotated out of the bounded ring (or
            # tracing was off) — the record still lists, unattributed
            entry["dominant_phase"] = None
        out.append(entry)
    return out


def _bucket_stats(
    records: Sequence[RequestRecord],
    slos: Dict[str, Tuple[float, float]],
    span_s: float,
) -> dict:
    """Outcome/latency/goodput stats over one record subset."""
    ok = [r for r in records if r.outcome == "ok"]
    ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
    tpots = [r.tpot_s for r in ok if r.tpot_s is not None]
    met = sum(
        1 for r in records if _meets_slo(r, *slos.get(r.cls, (1e12, 1e12)))
    )
    outcomes: Dict[str, int] = {}
    for r in records:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
    n = len(records)
    return {
        "requests": n,
        "outcomes": outcomes,
        "completed": len(ok),
        "slo_met": met,
        "goodput_ratio": round(met / n, 4) if n else None,
        "goodput_rps": round(met / span_s, 3) if span_s > 0 else None,
        "ttft_ms_p50": _ms(percentile(ttfts, 0.5)) if ttfts else None,
        "ttft_ms_p95": _ms(percentile(ttfts, 0.95)) if ttfts else None,
        "ttft_ms_p99": _ms(percentile(ttfts, 0.99)) if ttfts else None,
        "tpot_ms_p50": _ms(percentile(tpots, 0.5)) if tpots else None,
        "tpot_ms_p95": _ms(percentile(tpots, 0.95)) if tpots else None,
    }


def _window_compile_stalls(
    flight_events: Sequence[dict], w: EventWindow
) -> dict:
    """Compile activity inside one window, from the flight recorder's
    soak-relative event list (``{"t": rel_s, "fn", "seconds",
    "recompile"}``): a tail-amplification window whose worst requests
    line up with compile seconds is a compile stall, not a routing or
    queueing problem."""
    hits = [e for e in flight_events if w.covers(float(e.get("t", -1.0)))]
    return {
        "events": len(hits),
        "recompiles": sum(1 for e in hits if e.get("recompile")),
        "seconds": round(
            sum(float(e.get("seconds", 0.0)) for e in hits), 4
        ),
        "fns": sorted({e.get("fn") for e in hits if e.get("fn")}),
    }


def evaluate(
    records: Sequence[RequestRecord],
    class_slos: Dict[str, Tuple[float, float]],
    duration_s: float,
    windows: Sequence[EventWindow] = (),
    trace_lookup=None,
    flight_events: Optional[Sequence[dict]] = None,
) -> dict:
    """Score one soak run → the report's analysis block.

    ``class_slos`` maps class name → (ttft_slo_ms, tpot_slo_ms);
    ``windows`` are the injected-event intervals (kill, drain) whose
    tail amplification and recovery get scored against the pre-window
    baseline. ``trace_lookup`` (``trace_id → obs.tracing trace dict or
    None``, optional) attributes each window's worst requests to their
    dominant span phase — the "WHY did the kill window amplify TTFT
    2×" block of the artifact. ``flight_events`` (optional, from the
    engine flight recorder, timestamps already soak-relative) adds a
    ``compile_stalls`` block per window so a tail spike caused by a
    compile (a graph capture on the card) — a steady-state recompile
    especially — is attributable as such."""
    records = list(records)
    per_class: Dict[str, dict] = {}
    for name, slos in sorted(class_slos.items()):
        recs = [r for r in records if r.cls == name]
        stats = _bucket_stats(recs, {name: slos}, duration_s)
        stats["ttft_slo_ms"] = slos[0]
        stats["tpot_slo_ms"] = slos[1]
        stats["sheds"] = _shed_honesty(recs)
        per_class[name] = stats
    overall = _bucket_stats(records, class_slos, duration_s)
    overall["sheds"] = _shed_honesty(records)
    failures = sum(
        overall["outcomes"].get(o, 0) for o in _FAILURE_OUTCOMES
    )
    client_5xx = overall["outcomes"].get("failed_5xx", 0)

    lags = [r.lag_s for r in records]
    open_loop = {
        "sched_lag_ms_p95": _ms(percentile(lags, 0.95)) if lags else None,
        "sched_lag_ms_max": _ms(max(lags)) if lags else None,
    }

    window_blocks: Dict[str, dict] = {}
    baseline = tail = None
    if windows:
        first_start = min(w.start for w in windows)
        last_end = max(w.end for w in windows)
        base_recs = [r for r in records if r.t_sched < first_start]
        tail_recs = [r for r in records if r.t_sched >= last_end]
        baseline = _bucket_stats(
            base_recs, class_slos, max(first_start, 1e-9)
        )
        tail = _bucket_stats(
            tail_recs, class_slos, max(duration_s - last_end, 1e-9)
        )
        for w in windows:
            in_w = [r for r in records if w.covers(r.t_sched)]
            blk = _bucket_stats(in_w, class_slos, max(w.end - w.start, 1e-9))
            blk["start"] = w.start
            blk["end"] = w.end
            b95, w95 = baseline["ttft_ms_p95"], blk["ttft_ms_p95"]
            blk["ttft_p95_amplification"] = (
                round(w95 / b95, 2) if b95 and w95 else None
            )
            if trace_lookup is not None:
                blk["worst_requests"] = _worst_request_phases(
                    in_w, trace_lookup
                )
            if flight_events is not None:
                blk["compile_stalls"] = _window_compile_stalls(
                    flight_events, w
                )
            window_blocks[w.name] = blk
        bg, tg = baseline["goodput_ratio"], tail["goodput_ratio"]
        # None (not False): an empty tail or baseline proves nothing —
        # e.g. a kill window clamped to the soak end leaves no tail
        recovered = (
            None
            if bg is None or tg is None
            else tg >= 0.7 * bg
        )
        window_blocks["_recovery"] = {
            "baseline_goodput_ratio": bg,
            "tail_goodput_ratio": tg,
            "recovered": recovered,
        }

    return {
        "overall": overall,
        "classes": per_class,
        "failures": failures,
        "client_5xx": client_5xx,
        "open_loop": open_loop,
        "windows": window_blocks,
        "baseline": baseline,
        "tail": tail,
    }
