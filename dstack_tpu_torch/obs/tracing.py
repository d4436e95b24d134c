"""Distributed request tracing (own copy of ``dstack_tpu.obs.tracing``, no
JAX import): spans from gateway admission to per-phase engine work,
stitched across failover/resume legs.

The serve histograms can say *that* p99 TTFT doubled inside a kill
window; nothing before this module could say *why* — QoS queue wait vs
router retry/backoff vs re-prefill on the resume leg vs engine batch
contention. This is the Dapper-style causal layer (Sigelman et al.
2010): every request gets one trace id at its first edge, every layer
hangs named spans with typed events off it, and the id survives the
whole lifecycle — gateway/proxy receive → QoS ``edge_admit`` →
``ReplicaPool.pick`` → one ``router.dispatch`` child span per
failover/resume leg → replica admission → engine queue/prefill/decode
phases. ``GET /debug/traces`` (server, gateway, replica) and ``dtpu
trace <id>`` render the result; TTFT/TPOT histograms carry trace-id
exemplars so "show me the trace behind p99" is one query.

Design constraints, in order (the ``faults`` contract):

- **Zero cost when disabled.** :func:`span` is a module-level name
  bound to :func:`_noop_span` until a tracer is installed; an
  instrumented hot path pays one module-attribute load and a call
  returning the shared no-op span (tests pin
  ``tracing.span is tracing._noop_span`` under ``DTPU_TRACE=0``).
- **Bounded.** Completed traces live in an in-process ring of
  ``DTPU_TRACE_BUFFER`` (256) traces; one span keeps at most
  ``_MAX_EVENTS`` events (overflow counted, never grown); one trace at
  most ``_MAX_SPANS_PER_TRACE`` spans. Span *names* are literals at
  every call site — dtpu-lint DTPU004 enforces it, same
  bounded-cardinality rationale as metric labels. Attr *values* are
  truncated, and never carry prompt or completion text.
- **Proxy-asserted context.** The ``X-DTPU-Trace`` header
  (``{trace_id}-{span_id}``, a W3C-traceparent reduction) is injected
  by the forwarder per dispatch leg and stripped from client requests
  in ``routing.forward._DROP_REQUEST`` — exactly like
  ``X-DTPU-Tenant`` — so the replica may trust it. The trace id (not
  the span id) is echoed to the client on the response, which is what
  loadgen records for tail attribution.
- **Import-light.** Stdlib + ``obs.metrics`` only — no aiohttp, no
  jax (pinned by test, like ``faults/`` and the loadgen generator
  path).
- **Monotonic.** Span timing uses ``time.monotonic`` with one wall
  anchor per span, so in-process waterfalls never jump on clock steps.

Env (documented in docs/reference/server.md):

- ``DTPU_TRACE`` (default 1): 0/false disables tracing entirely —
  module-level no-op rebinding, nothing is ever recorded.
- ``DTPU_TRACE_BUFFER`` (default 256): completed traces retained.
- ``DTPU_TRACE_SAMPLE`` (default 1.0): probability a NEW root trace
  records; continued traces (a leg arriving with a valid header)
  always record, so sampling is decided once at the first edge.
"""

import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from dstack_tpu_torch.obs.metrics import Registry

__all__ = [
    "TRACE_HEADER",
    "Span",
    "Tracer",
    "span",
    "enabled",
    "enable",
    "disable",
    "get_tracer",
    "get_trace",
    "debug_payload",
    "new_trace_registry",
    "get_trace_registry",
    "NOOP_SPAN",
]

#: the one trace-context header. Request direction: proxy-asserted
#: ``{trace_id}-{span_id}`` (client-supplied values stripped by the
#: forwarder and blanked by nginx, like X-DTPU-Tenant). Response
#: direction: the bare trace id, echoed to the client for lookup.
TRACE_HEADER = "X-DTPU-Trace"

#: aiohttp request-storage key the edges stash the request's root span
#: under (``request[REQUEST_SPAN_KEY]``) so downstream layers — QoS
#: admission, the forwarder — parent their spans to it without any
#: layer importing another's module
REQUEST_SPAN_KEY = "dtpu.trace.span"

DEFAULT_BUFFER = 256
_MAX_EVENTS = 64  # events per span before overflow is counted, not kept
_MAX_SPANS_PER_TRACE = 128
_MAX_ATTR_CHARS = 256  # attr values truncate; spans never carry prompts


def new_trace_registry() -> Registry:
    """Registry pre-populated with every tracing metric family."""
    r = Registry()
    r.counter(
        "dtpu_trace_spans_total",
        "Completed (recorded) trace spans in this process",
    )
    r.counter(
        "dtpu_trace_traces_evicted_total",
        "Completed traces evicted from the bounded ring buffer "
        "(DTPU_TRACE_BUFFER) to make room for newer ones",
    )
    r.counter(
        "dtpu_trace_events_dropped_total",
        "Span events dropped past the per-span cap (the span keeps an "
        "events_dropped count instead of growing without bound)",
    )
    return r


_registry: Optional[Registry] = None


def get_trace_registry() -> Registry:
    """The process-global tracing registry (rendered on the server's,
    the gateway's, and the OpenAI server's ``/metrics``)."""
    global _registry
    if _registry is None:
        _registry = new_trace_registry()
    return _registry


def _trim(v: Any) -> Any:
    if isinstance(v, str) and len(v) > _MAX_ATTR_CHARS:
        return v[:_MAX_ATTR_CHARS]
    return v


class Span:
    """One named, timed unit of work inside a trace.

    Usable as a context manager (an exception ends it with
    ``status="error"``) or via explicit :meth:`end`; ending twice is a
    no-op, so error paths may end defensively. ``attrs`` and
    :meth:`event` carry typed context — identifiers and counts only,
    never prompt/completion text."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_unix",
        "_t0", "duration_s", "status", "attrs", "events",
        "events_dropped", "_tracer", "_ended",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        attrs: dict,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_unix = time.time()
        self._t0 = time.monotonic()
        self.duration_s: Optional[float] = None
        self.status = "ok"
        self.attrs = {k: _trim(v) for k, v in attrs.items()}
        self.events: List[dict] = []
        self.events_dropped = 0
        self._tracer = tracer
        self._ended = False

    # -- recording --

    @property
    def recording(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        for k, v in attrs.items():
            self.attrs[k] = _trim(v)

    def event(self, name: str, **attrs) -> None:
        """Append a typed point-in-time event (bounded per span)."""
        if self._ended:
            return
        if len(self.events) >= _MAX_EVENTS:
            self.events_dropped += 1
            return
        ev: dict = {"t_s": round(time.monotonic() - self._t0, 6), "name": name}
        if attrs:
            ev["attrs"] = {k: _trim(v) for k, v in attrs.items()}
        self.events.append(ev)

    def end(self, status: Optional[str] = None, **attrs) -> None:
        """Complete the span into the tracer's ring (idempotent)."""
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.set(**attrs)
        if status is not None:
            self.status = status
        self.duration_s = time.monotonic() - self._t0
        self._tracer._finish(self)

    # -- propagation --

    def header(self) -> str:
        """The proxy-asserted request-direction ``X-DTPU-Trace`` value
        a child leg dispatched from this span should carry."""
        return f"{self.trace_id}-{self.span_id}"

    # -- serialization --

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": round(self.start_unix, 6),
            "start_mono": round(self._t0, 6),
            "duration_s": (
                round(self.duration_s, 6)
                if self.duration_s is not None
                else None
            ),
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }
        if self.events_dropped:
            d["events_dropped"] = self.events_dropped
        return d

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("error" if exc_type is not None else None)
        return None


class _NoopSpan:
    """The shared do-nothing span: what :func:`span` returns while
    tracing is disabled, for unsampled roots, and for children of
    no-op parents. Every method is a constant-time no-op."""

    __slots__ = ()

    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None
    status = "ok"
    duration_s: Optional[float] = None
    events_dropped = 0

    @property
    def recording(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        return None

    def event(self, name: str, **attrs) -> None:
        return None

    def end(self, status: Optional[str] = None, **attrs) -> None:
        return None

    def header(self) -> Optional[str]:
        return None

    def to_dict(self) -> dict:
        return {}

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_SPAN = _NoopSpan()


def parse_header(value: Optional[str]):
    """``{trace_id}-{span_id}`` → (trace_id, span_id) or None. A
    malformed header must not error the data path — it just starts a
    fresh trace."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 2:
        return None
    tid, sid = parts
    if not (tid and sid and _is_hex(tid) and _is_hex(sid)):
        return None
    return tid, sid


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
    except ValueError:
        return False
    return len(s) <= 32


class Tracer:
    """Span factory + bounded ring of completed traces.

    Thread-safe: spans end from the event loop, worker threads
    (``asyncio.to_thread`` engine dispatches), and handlers
    concurrently; one lock covers the ring."""

    def __init__(self, buffer: int = DEFAULT_BUFFER, sample: float = 1.0):
        self.buffer = max(1, int(buffer))
        self.sample = min(1.0, max(0.0, float(sample)))
        self._lock = threading.Lock()
        # trace_id -> {"spans": [span dicts], "updated_unix": t}
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._rng = random.Random()

    # -- span creation --

    def span(
        self,
        name: str,
        parent: Optional[Any] = None,
        trace: Optional[str] = None,
        **attrs,
    ) -> Any:
        """Start a span.

        ``parent``: an in-process parent :class:`Span` (children of a
        no-op parent are no-ops — the sampling decision propagates).
        ``trace``: an ``X-DTPU-Trace`` request header value from an
        upstream edge; a valid one continues that trace (always
        recorded — the first edge already sampled), an absent or
        malformed one starts a new root (subject to ``sample``)."""
        if parent is not None:
            if not getattr(parent, "recording", False):
                return NOOP_SPAN
            return Span(
                self, name, parent.trace_id, self._span_id(),
                parent.span_id, attrs,
            )
        ctx = parse_header(trace)
        if ctx is not None:
            return Span(self, name, ctx[0], self._span_id(), ctx[1], attrs)
        if self.sample < 1.0 and self._rng.random() >= self.sample:
            return NOOP_SPAN
        return Span(self, name, self._trace_id(), self._span_id(), None, attrs)

    def _trace_id(self) -> str:
        return f"{self._rng.getrandbits(64):016x}"

    def _span_id(self) -> str:
        return f"{self._rng.getrandbits(32):08x}"

    # -- ring --

    def _finish(self, span: Span) -> None:
        m = get_trace_registry()
        with self._lock:
            entry = self._ring.get(span.trace_id)
            if entry is None:
                entry = self._ring[span.trace_id] = {"spans": []}
                while len(self._ring) > self.buffer:
                    self._ring.popitem(last=False)
                    m.family("dtpu_trace_traces_evicted_total").inc(1)
            else:
                # recency order: a trace gaining spans is live, keep it
                self._ring.move_to_end(span.trace_id)
            if len(entry["spans"]) < _MAX_SPANS_PER_TRACE:
                entry["spans"].append(span.to_dict())
            entry["updated_unix"] = time.time()
        m.family("dtpu_trace_spans_total").inc(1)
        if span.events_dropped:
            m.family("dtpu_trace_events_dropped_total").inc(
                span.events_dropped
            )

    # -- queries --

    def trace(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._ring.get(str(trace_id))
            if entry is None:
                return None
            return {
                "trace_id": str(trace_id),
                "spans": [dict(s) for s in entry["spans"]],
                "updated_unix": entry.get("updated_unix"),
            }

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._ring)

    def _summaries(self) -> List[dict]:
        with self._lock:
            out = []
            for tid, entry in self._ring.items():
                spans = entry["spans"]
                durations = [
                    s["duration_s"] for s in spans
                    if s.get("duration_s") is not None
                ]
                roots = [s for s in spans if s.get("parent_id") is None]
                out.append({
                    "trace_id": tid,
                    "spans": len(spans),
                    "duration_s": max(durations) if durations else 0.0,
                    "root": roots[0]["name"] if roots else None,
                    "status": (
                        "error"
                        if any(s.get("status") not in ("ok", None)
                               for s in spans)
                        else "ok"
                    ),
                    "updated_unix": entry.get("updated_unix"),
                })
            return out

    def recent(self, limit: int = 50) -> List[dict]:
        return self._summaries()[-max(0, int(limit)):][::-1]

    def slowest(self, n: int = 10) -> List[dict]:
        return sorted(
            self._summaries(),
            key=lambda s: s["duration_s"],
            reverse=True,
        )[: max(0, int(n))]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# ---------------------------------------------------------------------------
# module-level no-op fast path (the faults.fire idiom)
# ---------------------------------------------------------------------------


def _noop_span(
    name: str,
    parent: Optional[Any] = None,
    trace: Optional[str] = None,
    **attrs,
) -> _NoopSpan:
    return NOOP_SPAN


# the installed tracer (None = disabled); `span` is REBOUND on enable so
# the disabled path is one no-op call — tests assert
# `tracing.span is tracing._noop_span` to pin the zero-cost contract
_tracer: Optional[Tracer] = None
span = _noop_span


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def enable(
    buffer: int = DEFAULT_BUFFER, sample: float = 1.0
) -> Tracer:
    """Install a fresh tracer (rebinding :func:`span`) and return it."""
    global _tracer, span
    tracer = Tracer(buffer=buffer, sample=sample)
    _tracer = tracer
    span = tracer.span
    return tracer


def disable() -> None:
    """Uninstall any tracer and restore the no-op fast path."""
    global _tracer, span
    _tracer = None
    span = _noop_span


def get_trace(trace_id: Optional[str]) -> Optional[dict]:
    """One completed trace by id, or None (also None when disabled or
    the id rotated out of the ring)."""
    if _tracer is None or not trace_id:
        return None
    return _tracer.trace(str(trace_id))


def debug_payload(query) -> dict:
    """The ``GET /debug/traces`` response body, shared verbatim by the
    server, the gateway, and the OpenAI replica (``query`` is any
    mapping of string query params: ``id``, ``slowest``, ``limit``).

    Shapes: ``?id=<trace_id>`` → ``{"trace": {...} | null}``;
    ``?slowest=N`` → the N slowest retained traces; default → the most
    recent (up to ``limit``, 50)."""
    if _tracer is None:
        return {"enabled": False, "traces": []}
    tid = query.get("id")
    if tid:
        return {"enabled": True, "trace": _tracer.trace(str(tid))}
    raw_slowest = query.get("slowest")
    if raw_slowest is not None:
        try:
            n = max(1, int(raw_slowest))
        except (TypeError, ValueError):
            n = 10
        return {"enabled": True, "traces": _tracer.slowest(n)}
    try:
        limit = max(1, int(query.get("limit") or 50))
    except (TypeError, ValueError):
        limit = 50
    return {"enabled": True, "traces": _tracer.recent(limit)}


def _env_on(name: str, default: str) -> bool:
    return os.getenv(name, default).strip().lower() not in (
        "0", "false", "no",
    )


def _install_from_env() -> None:
    """Install the tracer at import per ``DTPU_TRACE`` (default ON —
    the ring is bounded and the per-request cost is a handful of dict
    writes; ``DTPU_TRACE=0`` restores the no-op binding)."""
    if not _env_on("DTPU_TRACE", "1"):
        return
    try:
        buffer = int(os.getenv("DTPU_TRACE_BUFFER", "") or DEFAULT_BUFFER)
    except ValueError:
        buffer = DEFAULT_BUFFER
    try:
        sample = float(os.getenv("DTPU_TRACE_SAMPLE", "") or 1.0)
    except ValueError:
        sample = 1.0
    enable(buffer=buffer, sample=sample)


_install_from_env()
