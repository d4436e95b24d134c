"""Boot recorder (own copy of ``dstack_tpu.obs.boot``, no JAX import):
time-to-first-served-token decomposition for cold replicas, boot-stage
tracing, and the warmup-coverage manifest.

The control plane can *decide* to add capacity in a fraction of a second
(the live SLO engine's burn alerts) but *delivering* it takes minutes.
This module decomposes what a cold replica pays between process start
and its first served token: the boot-side complement of the flight
recorder (``obs/flight.py`` prices steady-state compiles; this prices
the boot itself). The port's server opens JAX's stages around the same
work: ``config_load`` (or ``weights_load`` for ``--hf-model``),
``weights_load`` (the card placement and a ``--weights`` overlay),
``engine_init``, ``tokenizer_load``, ``warmup_compile`` (the kernels'
build included, which the card pays where JAX compiles) and
``warm_prefix_copies``.

- **Boot timeline.** A bounded per-process ring of named boot stages —
  process start → config/tokenizer load → checkpoint/weights load
  (with ``bytes`` + derived ``bytes_per_s``) → engine construction →
  compile-grid warmup → ``warm_prefix_copies`` → HTTP listener up →
  first probe answered → first served token — each either a *scoped*
  stage (:func:`stage`, a context manager measuring a duration) or a
  point-in-time *mark* (:func:`mark`, a once-only milestone at an
  offset from process start). A stable ``boot_id`` is minted at
  recorder construction; ``/health`` carries it so the routing layer
  can tell a restart from a slow replica (an engine restarting and
  re-warming between probes never shows ``prefix_slots=0`` — the
  boot_id change is the authoritative restart signal).
- **Boot trace.** Every recorder owns a ``boot`` root span
  (``obs/tracing.py``); scoped stages are
  ``boot.stage`` children, marks are events on the root, and the root
  ends at the first served token, so the whole boot reads like one
  request trace.
- **Fleet aggregation.** :func:`ingest` folds a probed ``/health``
  ``boot`` block into ``dtpu_boot_stage_seconds{stage}`` /
  ``dtpu_boot_ttfst_seconds`` histograms with a caller-held memo so
  repeated probes of the same boot observe each stage exactly once
  (the probe IS the transport, same as the SLO windows). The routing
  pool calls it; the server/gateway ``/metrics`` render the registry.
- **Warmup-coverage manifest.** :func:`manifest_key` /
  :func:`manifest_diff` are the pure helpers behind the engine's
  boot-compile manifest: the set of per-fn compile keys warmup
  visited. A steady-state compile of a key *absent* from the manifest
  is a warmup-coverage gap (``dtpu_serve_warmup_gap_compiles_total``)
  — the exact un-warmed prefix-copy-grid bug class the first soak hit,
  now detected instead of merely priced.

Design constraints, in order (the ``faults``/``tracing``/``flight``
contract):

- **Zero cost when disabled.** :func:`stage` and :func:`mark` are
  module-level names bound to their no-ops until a recorder is
  installed; tests pin ``boot.stage is boot._noop_stage`` under
  ``DTPU_BOOT=0``.
- **Bounded.** The timeline holds ``DTPU_BOOT_BUFFER`` (64) entries;
  attr values are truncated (spans-style), never prompt text.
- **Import-light.** Stdlib + ``obs.metrics`` + ``obs.tracing`` only —
  no jax, no aiohttp at import (pinned by subprocess test).
- **Monotonic.** Stage offsets and durations use ``time.monotonic``
  against one anchor (``started_at`` is the single wall-clock stamp),
  so the decomposition never jumps on clock steps.

Env (documented in docs/reference/server.md):

- ``DTPU_BOOT`` (default 1): 0/false disables the recorder entirely —
  module-level no-op rebinding, nothing is ever recorded.
- ``DTPU_BOOT_BUFFER`` (default 64): timeline entries retained.
"""

import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

from dstack_tpu_torch.obs import tracing
from dstack_tpu_torch.obs.metrics import Registry
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.boot")

__all__ = [
    "DEFAULT_BUFFER",
    "BOOT_BUCKETS_S",
    "READY_MARK",
    "SERVED_MARK",
    "BootRecorder",
    "stage",
    "mark",
    "enabled",
    "enable",
    "disable",
    "get_recorder",
    "health_block",
    "debug_payload",
    "ingest",
    "manifest_key",
    "manifest_diff",
    "new_boot_registry",
    "get_boot_registry",
]

DEFAULT_BUFFER = 64
_MAX_ATTR_CHARS = 256  # attr values truncate, tracing-style

#: the milestone names the decomposition hangs on: READY_MARK is the
#: first ``/health`` this process answered (the probe loop's first
#: sight of it — time-to-ready), SERVED_MARK the first token queued to
#: any client (time-to-first-served-token; seals the boot root span)
READY_MARK = "first_probe"
SERVED_MARK = "first_served_token"

#: boot stages run seconds-to-minutes (checkpoint loads, compile
#: grids), far past LATENCY_BUCKETS_S's 60s ceiling
BOOT_BUCKETS_S = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0, 600.0, 1800.0,
)


def new_boot_registry() -> Registry:
    """Registry pre-populated with every boot metric family. The
    ``stage`` label is the bounded catalog of boot stage names the
    instrumented call sites emit (config_load / tokenizer_load /
    weights_load / engine_init / warmup_compile / warm_prefix_copies),
    never a request-derived value."""
    r = Registry()
    r.histogram(
        "dtpu_boot_stage_seconds",
        "Seconds one boot stage took, per stage name — replica-local "
        "on a serving process, fleet-aggregated from probed /health "
        "boot blocks on the server/gateway (each boot observes each "
        "stage once; the probe is the transport)",
        labelnames=("stage",),
        buckets=BOOT_BUCKETS_S,
    )
    r.histogram(
        "dtpu_boot_ttfst_seconds",
        "Time from process start to the FIRST token served to any "
        "client (time-to-first-served-token) — the end-to-end "
        "scale-out delivery latency ROADMAP item 4 optimizes; one "
        "observation per boot",
        buckets=BOOT_BUCKETS_S,
    )
    r.counter(
        "dtpu_boot_replicas_total",
        "Distinct replica boots ingested from probed /health boot "
        "blocks (a restart mints a new boot_id and counts again)",
    )
    return r


_registry: Optional[Registry] = None


def get_boot_registry() -> Registry:
    """The process-global boot registry: replica-local stage/TTFST
    observations on a serving process, probe-ingested fleet
    aggregation on the server/gateway (both render it on their
    ``/metrics``)."""
    global _registry
    if _registry is None:
        _registry = new_boot_registry()
    return _registry


def _trim(v: Any) -> Any:
    if isinstance(v, str) and len(v) > _MAX_ATTR_CHARS:
        return v[:_MAX_ATTR_CHARS]
    return v


# ---------------------------------------------------------------------------
# warmup-coverage manifest (pure helpers; the engine holds the set)
# ---------------------------------------------------------------------------


def manifest_key(fn_name: str, key: Any = None) -> str:
    """One canonical string per (jit site, bucket key) compile variant
    — the unit of warmup coverage. Must match how the flight recorder
    stringifies keys (``repr``) so the manifest and the steady-state
    detector can never disagree on identity."""
    return fn_name if key is None else f"{fn_name}{key!r}"


def manifest_diff(manifest, observed) -> dict:
    """Compare a warmup manifest against steady-state compile keys →
    ``{"covered": [...], "gaps": [...]}``: ``gaps`` are variants
    steady traffic compiled that warmup never visited (each one a
    TTFT/TPOT stall some request paid — the warmup-coverage bug the
    gate exists to catch); ``covered`` the observed keys warmup did
    pre-pay."""
    mset = set(manifest)
    oset = set(observed)
    return {
        "covered": sorted(oset & mset),
        "gaps": sorted(oset - mset),
    }


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class _Stage:
    """One scoped boot stage (context manager): measures the duration,
    appends the timeline entry, observes the stage histogram, and ends
    its ``boot.stage`` child span. A ``bytes`` attr gains a derived
    ``bytes_per_s`` on exit (checkpoint-load throughput — the number a
    streamed-weights optimization would move)."""

    __slots__ = ("_rec", "name", "attrs", "_t0", "_span")

    def __init__(self, rec: "BootRecorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = {k: _trim(v) for k, v in attrs.items()}
        self._t0 = 0.0
        self._span = tracing.NOOP_SPAN

    def set(self, **attrs) -> None:
        """Attach context discovered mid-stage (e.g. ``bytes`` once
        the checkpoint size is known)."""
        for k, v in attrs.items():
            self.attrs[k] = _trim(v)

    def __enter__(self) -> "_Stage":
        self._t0 = time.monotonic()
        # dtpu-lint DTPU004: literal span name; the (bounded) stage
        # name rides as an attr, same rationale as metric labels
        self._span = tracing.span(
            "boot.stage", parent=self._rec._root, stage=self.name,
        )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        seconds = time.monotonic() - self._t0
        if self.attrs.get("bytes") and seconds > 0:
            try:
                self.attrs["bytes_per_s"] = round(
                    float(self.attrs["bytes"]) / seconds, 1
                )
            except (TypeError, ValueError):
                pass
        self._rec._finish_stage(
            self.name, self._t0, seconds, self.attrs,
            error=exc_type is not None,
        )
        self._span.set(**self.attrs)
        self._span.end("error" if exc_type is not None else None)
        return None


class _NoopStage:
    """Shared do-nothing stage: what :func:`stage` returns while the
    recorder is disabled."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        return None

    def __enter__(self) -> "_NoopStage":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_STAGE = _NoopStage()


class BootRecorder:
    """Monotonic timeline of one process boot.

    Thread-safe: stages complete on the main thread while the
    scheduler marks the first served token from the event loop and
    ``/health`` reads concurrently; one lock covers the timeline.

    ``registry=None`` observes stage/TTFST histograms into the
    process-global boot registry (the normal one-replica-per-process
    deployment). Multi-replica harnesses (the soak's scale-up replica)
    pass a private registry so replica-local observations never
    double-count against the pool's probe-ingested aggregation in the
    same process."""

    def __init__(
        self,
        buffer: int = DEFAULT_BUFFER,
        registry: Optional[Registry] = None,
    ):
        self.boot_id = uuid.uuid4().hex[:16]
        self.started_at = time.time()  # the one wall anchor
        self._t0 = time.monotonic()
        self.buffer = max(8, int(buffer))
        self._lock = threading.Lock()
        self._timeline: deque = deque(maxlen=self.buffer)
        self._stage_seconds: dict = {}  # name -> summed seconds
        self._marks: dict = {}  # name -> offset seconds from start
        self._registry = registry
        self._sealed = False
        # the boot trace root: stages hang off it as children, marks
        # as events; ends (lands in the trace ring) at the first
        # served token
        self._root = tracing.span("boot", boot_id=self.boot_id)

    def _reg(self) -> Registry:
        return self._registry if self._registry is not None else (
            get_boot_registry()
        )

    # -- recording --

    def stage(self, name: str, **attrs) -> _Stage:
        """A scoped boot stage (use as a context manager)."""
        return _Stage(self, name, attrs)

    def _finish_stage(
        self, name, t0, seconds, attrs, error=False
    ) -> None:
        entry: dict = {
            "stage": name,
            "t": round(t0 - self._t0, 6),
            "seconds": round(seconds, 6),
        }
        if error:
            entry["error"] = True
        for k, v in attrs.items():
            if v is not None:
                entry[k] = v
        with self._lock:
            self._timeline.append(entry)
            self._stage_seconds[name] = round(
                self._stage_seconds.get(name, 0.0) + seconds, 6
            )
        self._reg().family("dtpu_boot_stage_seconds").observe(
            seconds, name
        )

    def mark(self, name: str, **attrs) -> bool:
        """A once-only point-in-time milestone at its offset from
        process start (repeat calls are no-ops → False). Marking
        :data:`SERVED_MARK` observes ``dtpu_boot_ttfst_seconds`` and
        seals the boot root span — the boot is over."""
        t = time.monotonic() - self._t0
        with self._lock:
            if name in self._marks:
                return False
            self._marks[name] = round(t, 6)
            entry: dict = {"stage": name, "t": round(t, 6), "mark": True}
            for k, v in attrs.items():
                if v is not None:
                    entry[k] = _trim(v)
            self._timeline.append(entry)
            seal = name == SERVED_MARK and not self._sealed
            if seal:
                self._sealed = True
        self._root.event(name)
        if seal:
            self._reg().family("dtpu_boot_ttfst_seconds").observe(t)
            self._root.end(ttfst_s=round(t, 3))
            logger.info(
                "boot %s: first served token at t=%.2fs "
                "(time-to-ready %.2fs)",
                self.boot_id, t, self._marks.get(READY_MARK, t),
            )
        return True

    # -- queries --

    @property
    def warm(self) -> bool:
        """Whether this boot reached its first served token (the
        recorder's own notion; servers report the engine's
        ``flight_warm`` in /health instead, which flips at warmup)."""
        with self._lock:
            return self._sealed

    def time_to_ready(self) -> Optional[float]:
        with self._lock:
            return self._marks.get(READY_MARK)

    def ttfst(self) -> Optional[float]:
        with self._lock:
            return self._marks.get(SERVED_MARK)

    def timeline(self, limit: int = DEFAULT_BUFFER) -> list:
        n = max(0, int(limit))
        if n == 0:
            return []
        with self._lock:
            return [dict(e) for e in list(self._timeline)[-n:]]

    def health_block(self, warm: Optional[bool] = None) -> dict:
        """The compact ``boot`` block ``/health`` embeds — what the
        routing probe loop captures: identity (``boot_id`` +
        ``started_at``: the restart detector), the per-stage seconds
        decomposition, the milestone offsets, and the two derived
        latencies. ``warm`` is the caller's warmup flag (the engine's
        ``flight_warm`` on a serve replica)."""
        with self._lock:
            return {
                "boot_id": self.boot_id,
                "started_at": round(self.started_at, 3),
                "stages": dict(self._stage_seconds),
                "marks": dict(self._marks),
                "warm": bool(warm) if warm is not None else self._sealed,
                "time_to_ready_s": self._marks.get(READY_MARK),
                "ttfst_s": self._marks.get(SERVED_MARK),
            }


# ---------------------------------------------------------------------------
# fleet aggregation (the probe loop's half)
# ---------------------------------------------------------------------------


def ingest(
    block: dict, memo: dict, registry: Optional[Registry] = None
) -> int:
    """Fold one probed ``/health`` ``boot`` block into the fleet
    histograms → observations made. ``memo`` is the caller's
    PER-REPLICA state (the pool keeps one per entry), mutated here so
    repeated probes of one boot observe each stage exactly once while
    stages that complete *between* probes still land incrementally
    (the first probes of a booting replica carry a partial
    decomposition — ttfst arrives only once it serves). A boot_id
    change resets the memo and counts a fresh boot."""
    if not isinstance(block, dict) or not block.get("boot_id"):
        return 0
    reg = registry if registry is not None else get_boot_registry()
    boot_id = str(block["boot_id"])
    if memo.get("boot_id") != boot_id:
        memo.clear()
        memo["boot_id"] = boot_id
        memo["stages"] = set()
        memo["ttfst"] = False
        reg.family("dtpu_boot_replicas_total").inc(1)
    n = 0
    stages = block.get("stages")
    if isinstance(stages, dict):
        for name, seconds in stages.items():
            if name in memo["stages"]:
                continue
            try:
                seconds = float(seconds)
            except (TypeError, ValueError):
                continue
            memo["stages"].add(name)
            reg.family("dtpu_boot_stage_seconds").observe(seconds, name)
            n += 1
    ttfst = block.get("ttfst_s")
    if ttfst is not None and not memo["ttfst"]:
        try:
            reg.family("dtpu_boot_ttfst_seconds").observe(float(ttfst))
            memo["ttfst"] = True
            n += 1
        except (TypeError, ValueError):
            pass
    return n


# ---------------------------------------------------------------------------
# module-level no-op fast path (the faults.fire idiom)
# ---------------------------------------------------------------------------


def _noop_stage(name: str, **attrs) -> _NoopStage:
    return NOOP_STAGE


def _noop_mark(name: str, **attrs) -> bool:
    return False


# the installed recorder (None = disabled); `stage`/`mark` are REBOUND
# on enable so the disabled path is one no-op call — tests assert
# `boot.stage is boot._noop_stage` to pin the zero-cost contract
_recorder: Optional[BootRecorder] = None
stage = _noop_stage
mark = _noop_mark


def enabled() -> bool:
    return _recorder is not None


def get_recorder() -> Optional[BootRecorder]:
    return _recorder


def enable(buffer: int = DEFAULT_BUFFER) -> BootRecorder:
    """Install a fresh recorder (rebinding :func:`stage` and
    :func:`mark` — this process 'boots now') and return it."""
    global _recorder, stage, mark
    rec = BootRecorder(buffer=buffer)
    _recorder = rec
    stage = rec.stage
    mark = rec.mark
    return rec


def disable() -> None:
    """Uninstall any recorder and restore the no-op fast path."""
    global _recorder, stage, mark
    _recorder = None
    stage = _noop_stage
    mark = _noop_mark


def health_block(warm: Optional[bool] = None) -> Optional[dict]:
    if _recorder is None:
        return None
    return _recorder.health_block(warm=warm)


def debug_payload(query, recorder: Optional[BootRecorder] = None) -> dict:
    """The ``GET /debug/boot`` response body (``query`` is any mapping
    of string query params; ``limit`` bounds the timeline). The serve
    handler passes its app's recorder explicitly — multi-replica
    harnesses carry one per app — and falls back to the process
    default."""
    rec = recorder if recorder is not None else _recorder
    if rec is None:
        return {"enabled": False, "timeline": []}
    try:
        limit = max(1, int(query.get("limit") or DEFAULT_BUFFER))
    except (TypeError, ValueError):
        limit = DEFAULT_BUFFER
    return {
        "enabled": True,
        "boot_id": rec.boot_id,
        "started_at": round(rec.started_at, 3),
        "uptime_s": round(time.monotonic() - rec._t0, 3),
        "timeline": rec.timeline(limit),
        "summary": rec.health_block(),
    }


def _env_on(name: str, default: str) -> bool:
    return os.getenv(name, default).strip().lower() not in (
        "0", "false", "no",
    )


def _install_from_env() -> None:
    """Install the recorder at import per ``DTPU_BOOT`` (default ON —
    the timeline is bounded and boot stages are a handful of entries
    per process LIFETIME, not per request; ``DTPU_BOOT=0`` restores
    the no-op binding). Import time IS process start for every
    entrypoint that can serve (the recorder's t0 anchors the
    decomposition)."""
    if not _env_on("DTPU_BOOT", "1"):
        return
    try:
        buffer = int(os.getenv("DTPU_BOOT_BUFFER", "") or DEFAULT_BUFFER)
    except ValueError:
        buffer = DEFAULT_BUFFER
    enable(buffer=buffer)


_install_from_env()
