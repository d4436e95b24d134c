"""Engine flight recorder, compile accounting part (own copy of
``dstack_tpu.obs.flight``'s ring and compile accounting, no JAX import).

- **Flight ring.** A bounded per-process ring of records written with
  host-side data only (:func:`record`); the engine writes its ``compile``
  and ``recompile`` records here.
- **Compile accounting.** :func:`watch_jit` wraps each of the engine's
  compiled step sites (``serve/graphs.py``: a CUDA graph captured per
  key on the card, the same site run eagerly on the CPU) so that a
  site's first call of a key is counted and timed per function with the
  causing bucket key (``dtpu_serve_compiles_total{fn}``,
  ``dtpu_serve_compile_seconds{fn}`` in the ENGINE's registry: the
  wrapper is handed the registry) plus a ``compile`` record in the ring.
  A compile observed after the engine declared itself warm is a
  **steady-state recompile** (``recompile`` ring record,
  ``dtpu_serve_recompiles_total{fn}``, WARNING log).

Left for ROADMAP A4, with the watchdog they serve: post-mortems, the
device-memory poll and ``/debug/flight``.

Zero cost when disabled, as in JAX: :func:`record` is bound to
:func:`_noop_record` until a recorder is installed, and :func:`watch_jit`
returns its callable UNCHANGED (identity) when disabled at wrap time.

Env: ``DTPU_FLIGHT`` (default 1; 0/false/no disables the recorder),
``DTPU_FLIGHT_BUFFER`` (default 512 records retained).
"""

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from dstack_tpu_torch.obs.metrics import Registry
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.flight")

DEFAULT_BUFFER = 512
COMPILE_EVENTS_KEEP = 128  # recent compile events retained verbatim


def _tail(seq, n) -> list:
    """Last ``n`` items as plain dict copies (0 means none)."""
    n = max(0, int(n))
    if n == 0:
        return []
    return [dict(x) for x in list(seq)[-n:]]


class FlightRecorder:
    """Bounded ring of flight records and the per-fn compile counts.
    Thread-safe: the engine writes from the server's worker thread while
    the event loop reads; one lock covers everything."""

    def __init__(self, buffer: int = DEFAULT_BUFFER):
        self.buffer = max(16, int(buffer))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.buffer)
        self._seq = 0
        self._compiles: dict = {}
        self._recompiles: dict = {}
        self._compile_seconds: dict = {}
        self._compile_events: deque = deque(maxlen=COMPILE_EVENTS_KEEP)

    def record(self, phase: str = "step", **fields) -> None:
        """Append one flight record (host-side plain values only)."""
        with self._lock:
            self._seq += 1
            entry: dict = {"seq": self._seq, "t": round(time.time(), 6), "phase": phase}
            for k, v in fields.items():
                if v is not None:
                    entry[k] = v
            self._ring.append(entry)

    def records(self, limit: int = 50) -> list:
        with self._lock:
            return _tail(self._ring, limit)

    def note_compile(
        self,
        fn_name: str,
        key: Any,
        seconds: float,
        registry: Optional[Registry] = None,
        recompile: bool = False,
    ) -> None:
        """One observed compile at site ``fn_name`` caused by bucket
        ``key`` (None for a single-variant site). ``seconds`` is the wall
        time of the triggering call: the first, eager run and the
        capture, the cost the caller paid. ``recompile=True`` marks a
        compile observed AFTER the engine declared itself warm."""
        key_s = None if key is None else repr(key)
        with self._lock:
            self._compiles[fn_name] = self._compiles.get(fn_name, 0) + 1
            self._compile_seconds[fn_name] = self._compile_seconds.get(fn_name, 0.0) + seconds
            if recompile:
                self._recompiles[fn_name] = self._recompiles.get(fn_name, 0) + 1
            self._compile_events.append({
                "t": round(time.time(), 6),
                "fn": fn_name,
                "key": key_s,
                "seconds": round(seconds, 6),
                "recompile": recompile,
            })
        self.record(
            phase="recompile" if recompile else "compile",
            fn=fn_name, key=key_s, seconds=round(seconds, 6),
        )
        if registry is not None:
            registry.family("dtpu_serve_compiles_total").inc(1, fn_name)
            registry.family("dtpu_serve_compile_seconds").observe(seconds, fn_name)
            if recompile:
                registry.family("dtpu_serve_recompiles_total").inc(1, fn_name)
        if recompile:
            logger.warning(
                "steady-state recompile: site %r key=%s took %.3fs after warmup: a live "
                "TTFT/TPOT stall (an unwarmed bucket the warmup should cover)",
                fn_name, key_s, seconds,
            )

    def compile_totals(self) -> dict:
        """Cumulative per-fn compile accounting."""
        with self._lock:
            return {
                "compiles": dict(self._compiles),
                "recompiles": dict(self._recompiles),
                "seconds": {k: round(v, 6) for k, v in self._compile_seconds.items()},
            }

    def compile_events(self, limit: int = COMPILE_EVENTS_KEEP) -> list:
        with self._lock:
            return _tail(self._compile_events, limit)


class JitWatch:
    """Compile-accounting proxy around one compiled site (JAX's
    ``JitWatch``): a call that grows the site's cache
    (``fn._cache_size()``: the variants it has compiled, captured on the
    card, run eagerly on the CPU) is a compile, with a first-call fallback
    for a callable without one. ``warm`` is a zero-arg callable (the owning
    engine's warm flag): a compile while it returns True is a
    steady-state recompile. ``on_compile(name, key, seconds, recompile)``
    fires after the recorder is told: the engine's boot-compile manifest
    hangs off it."""

    __slots__ = ("fn", "name", "key", "_registry", "_warm", "_cache_size", "_calls", "_on_compile")

    def __init__(
        self,
        fn: Callable,
        name: str,
        registry: Optional[Registry] = None,
        key: Any = None,
        warm: Optional[Callable[[], bool]] = None,
        on_compile: Optional[Callable[[str, Any, float, bool], None]] = None,
    ):
        self.fn = fn
        self.name = name
        self.key = key
        self._registry = registry
        self._warm = warm
        self._cache_size = getattr(fn, "_cache_size", None)
        self._calls = 0
        self._on_compile = on_compile

    def __call__(self, *args, **kwargs):
        rec = _recorder
        if rec is None:
            return self.fn(*args, **kwargs)
        cs = self._cache_size
        before = cs() if cs is not None else None
        first = self._calls == 0
        self._calls += 1
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        compiled = (cs() > before) if cs is not None else first
        if compiled:
            recompile = bool(self._warm is not None and self._warm())
            rec.note_compile(self.name, self.key, dt, self._registry, recompile=recompile)
            if self._on_compile is not None:
                self._on_compile(self.name, self.key, dt, recompile)
        return out


def watch_jit(
    fn: Callable,
    name: str,
    registry: Optional[Registry] = None,
    key: Any = None,
    warm: Optional[Callable[[], bool]] = None,
    on_compile: Optional[Callable[[str, Any, float, bool], None]] = None,
) -> Callable:
    """Wrap a compiled site for compile accounting, or return it
    UNCHANGED when no recorder is installed at wrap time (an engine
    built under ``DTPU_FLIGHT=0`` carries no wrapper, and so keeps no
    boot-compile manifest)."""
    if _recorder is None:
        return fn
    return JitWatch(fn, name, registry, key=key, warm=warm, on_compile=on_compile)


def _noop_record(phase: str = "step", **fields) -> None:
    return None


# the installed recorder (None = disabled); `record` is rebound on enable
_recorder: Optional[FlightRecorder] = None
record = _noop_record


def enabled() -> bool:
    return _recorder is not None


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def enable(buffer: int = DEFAULT_BUFFER) -> FlightRecorder:
    """Install a fresh recorder (rebinding :func:`record`) and return it."""
    global _recorder, record
    rec = FlightRecorder(buffer=buffer)
    _recorder = rec
    record = rec.record
    return rec


def disable() -> None:
    """Uninstall any recorder and restore the no-op fast path."""
    global _recorder, record
    _recorder = None
    record = _noop_record


def _install_from_env() -> None:
    """Install the recorder at import per ``DTPU_FLIGHT`` (default on)."""
    if os.getenv("DTPU_FLIGHT", "1").strip().lower() in ("0", "false", "no"):
        return
    try:
        buffer = int(os.getenv("DTPU_FLIGHT_BUFFER", "") or DEFAULT_BUFFER)
    except ValueError:
        buffer = DEFAULT_BUFFER
    enable(buffer=buffer)


_install_from_env()
