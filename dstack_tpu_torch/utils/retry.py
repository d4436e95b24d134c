"""Unified retry/backoff (own copy of ``dstack_tpu.utils.retry``, no JAX
import): ONE implementation of jittered exponential backoff, deadline
propagation, and ``Retry-After`` respect. The port's server arms a
:class:`Deadline` per request; the routing layer's forwarder
(ROADMAP A4.2) retries through the rest. In the JAX package it serves every
plane — replacing the ad-hoc ``time.sleep`` loops that used to live in
the GCP transport, the Python API's poll loops, the CLI, tunnel
bring-up, and provisioning handshakes.

Design points:

- **Deterministic under a seeded RNG.** Jitter draws from an injectable
  ``random.Random``; the chaos suite pins the full backoff schedule by
  seeding it (production uses the module default, seeded from entropy).
- **Deadline propagation.** A :class:`Deadline` caps the WHOLE retry
  span, not just each attempt; it composes — a caller's deadline passes
  down through nested retries and sleeps never overshoot it. Exhaustion
  raises :class:`DeadlineExceeded`, a ``TimeoutError`` subclass so
  existing callers catching ``TimeoutError`` keep working.
- **Retry-After respect.** When a retryable error carries a
  ``retry_after`` attribute (a real 429/503's header, or an injected
  :class:`~dstack_tpu_torch.faults.InjectedHTTPError`), the hinted wait
  REPLACES the computed backoff for that attempt (still clamped to the
  deadline).
- **Observable.** Every retry increments
  ``dtpu_retry_attempts_total{site}`` and every give-up increments
  ``dtpu_retry_exhausted_total{site}`` in a process-global registry
  rendered on the server's ``/metrics`` page. ``site`` label values
  are short literals at call sites (bounded cardinality, DTPU004).

Import-light: stdlib + :mod:`dstack_tpu_torch.obs` only.
"""

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

from dstack_tpu_torch.obs import Registry
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("utils.retry")


class DeadlineExceeded(TimeoutError):
    """The overall deadline ran out before the operation succeeded."""


class Deadline:
    """A monotonic wall-clock budget shared down a call chain.

    ``Deadline(None)`` is the infinite deadline (remaining() = None),
    so call sites need no conditional plumbing."""

    __slots__ = ("_expires_at",)

    def __init__(self, seconds: Optional[float]):
        self._expires_at = (
            None if seconds is None else time.monotonic() + seconds
        )

    def remaining(self) -> Optional[float]:
        if self._expires_at is None:
            return None
        return max(0.0, self._expires_at - time.monotonic())

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0

    def clamp(self, delay: float) -> float:
        """A sleep that never overshoots the deadline."""
        rem = self.remaining()
        return delay if rem is None else min(delay, rem)

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what}: deadline exceeded")


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape. ``delay(n, rng)`` for attempt n (0-based) is
    ``min(max_delay, base_delay * multiplier**n)`` scaled by a uniform
    jitter factor in ``[1 - jitter, 1 + jitter]``."""

    max_attempts: int = 5
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25  # fraction of the delay, both directions

    def delay(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if self.jitter <= 0:
            return raw
        return raw * rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)

    def schedule(self, rng: random.Random) -> Iterator[float]:
        """The full backoff schedule (one delay per retry) — what the
        determinism tests pin under a seeded RNG."""
        for n in range(max(0, self.max_attempts - 1)):
            yield self.delay(n, rng)


#: conservative default: the policy cloud SDKs converge on
DEFAULT_POLICY = RetryPolicy()

_RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})


def default_should_retry(exc: BaseException) -> bool:
    """Transient-failure classifier shared by every migrated site:
    connect errors, timeouts, and HTTP 429/5xx (any exception exposing
    a ``status`` attribute — ``BackendRequestError``, aiohttp response
    errors, injected faults — duck-types in)."""
    status = getattr(exc, "status", None)
    if isinstance(status, int):
        return status in _RETRYABLE_STATUSES
    if isinstance(exc, DeadlineExceeded):
        return False  # budget verdicts never retry (subclasses TimeoutError)
    if isinstance(exc, (ConnectionError, asyncio.TimeoutError, TimeoutError)):
        return True
    if isinstance(exc, OSError):
        return True
    # aiohttp client errors without importing aiohttp here
    return type(exc).__module__.startswith("aiohttp")


def should_retry_non_idempotent(exc: BaseException) -> bool:
    """Classifier for NON-idempotent operations (create_instance-style
    calls): retry only failures that prove the request never landed —
    a connection refused/reset before a response, or an explicit 429
    rejection. Timeouts and 5xx are AMBIGUOUS (the create may have
    succeeded with the response lost); retrying those can
    double-provision billed resources, so they propagate."""
    status = getattr(exc, "status", None)
    if isinstance(status, int):
        return status == 429
    if isinstance(exc, (TimeoutError, asyncio.TimeoutError)):
        return False
    if isinstance(exc, ConnectionError):
        return True
    return False


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """The server-provided wait, when the error carries one."""
    ra = getattr(exc, "retry_after", None)
    try:
        return float(ra) if ra is not None else None
    except (TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def new_retry_registry() -> Registry:
    r = Registry()
    r.counter(
        "dtpu_retry_attempts_total",
        "Retries performed (first attempts are not counted), by call site",
        labelnames=("site",),
    )
    r.counter(
        "dtpu_retry_exhausted_total",
        "Operations that gave up after exhausting attempts or deadline, "
        "by call site",
        labelnames=("site",),
    )
    return r


_registry: Optional[Registry] = None


def get_retry_registry() -> Registry:
    global _registry
    if _registry is None:
        _registry = new_retry_registry()
    return _registry


def _count_retry(site: str) -> None:
    get_retry_registry().family("dtpu_retry_attempts_total").inc(1, site)


def _count_exhausted(site: str) -> None:
    get_retry_registry().family("dtpu_retry_exhausted_total").inc(1, site)


# ---------------------------------------------------------------------------
# retry drivers
# ---------------------------------------------------------------------------


def _plan_sleep(
    site: str,
    policy: RetryPolicy,
    attempt: int,
    exc: BaseException,
    deadline: Optional[Deadline],
    rng: random.Random,
    respect_retry_after: bool,
) -> Optional[float]:
    """Delay before the next attempt. Returns None when the ATTEMPT
    budget is spent (the caller re-raises the last error); raises
    :class:`DeadlineExceeded` (chained from the last error) when the
    DEADLINE is spent. A sleep — backoff or Retry-After hint alike —
    is clamped to the remaining budget so a final attempt still runs
    inside it. Advances the RNG exactly once per retry so the schedule
    stays deterministic regardless of Retry-After hints."""
    if attempt + 1 >= policy.max_attempts:
        _count_exhausted(site)
        return None
    delay = policy.delay(attempt, rng)
    if respect_retry_after:
        hinted = retry_after_hint(exc)
        if hinted is not None:
            delay = hinted
    if deadline is not None:
        rem = deadline.remaining()
        if rem is not None:
            if rem <= 0:
                _count_exhausted(site)
                raise DeadlineExceeded(
                    f"{site}: deadline exceeded retrying after {exc!r}"
                ) from exc
            delay = min(delay, rem)
    return delay


async def retry_async(
    fn: Callable[[], Any],
    *,
    site: str,
    policy: RetryPolicy = DEFAULT_POLICY,
    should_retry: Callable[[BaseException], bool] = default_should_retry,
    deadline: Optional[Deadline] = None,
    rng: Optional[random.Random] = None,
    respect_retry_after: bool = True,
) -> Any:
    """Run ``await fn()`` with jittered exponential backoff until it
    succeeds, raises a non-retryable error, or the budget runs out —
    attempts exhausted re-raises the last error; deadline exhausted
    raises :class:`DeadlineExceeded` chained from it. Sleeps never
    overshoot the deadline (clamped, Retry-After hints included)."""
    rng = rng or _default_rng
    attempt = 0
    while True:
        try:
            return await fn()
        except BaseException as e:
            if isinstance(e, (asyncio.CancelledError, KeyboardInterrupt)):
                raise
            if not should_retry(e):
                raise
            delay = _plan_sleep(
                site, policy, attempt, e, deadline, rng, respect_retry_after
            )
            if delay is None:
                raise
            logger.warning(
                "%s: attempt %d failed (%r); retrying in %.2fs",
                site, attempt + 1, e, delay,
            )
            _count_retry(site)
            await asyncio.sleep(delay)
            attempt += 1


def retry_sync(
    fn: Callable[[], Any],
    *,
    site: str,
    policy: RetryPolicy = DEFAULT_POLICY,
    should_retry: Callable[[BaseException], bool] = default_should_retry,
    deadline: Optional[Deadline] = None,
    rng: Optional[random.Random] = None,
    respect_retry_after: bool = True,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Synchronous twin of :func:`retry_async` (CLI / Python API)."""
    rng = rng or _default_rng
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as e:
            if isinstance(e, KeyboardInterrupt):
                raise
            if not should_retry(e):
                raise
            delay = _plan_sleep(
                site, policy, attempt, e, deadline, rng, respect_retry_after
            )
            if delay is None:
                raise
            logger.warning(
                "%s: attempt %d failed (%r); retrying in %.2fs",
                site, attempt + 1, e, delay,
            )
            _count_retry(site)
            sleep(delay)
            attempt += 1


# ---------------------------------------------------------------------------
# bounded polling (the poll-loop half of the old ad-hoc sleeps)
# ---------------------------------------------------------------------------

_SENTINEL = object()


async def wait_for_async(
    fn: Callable[[], Any],
    *,
    site: str,
    interval: float = 2.0,
    deadline: Optional[Deadline] = None,
    what: str = "condition",
) -> Any:
    """Poll ``await fn()`` until it returns non-None (returned), the
    deadline expires (:class:`DeadlineExceeded`), or it raises. Each
    sleep is deadline-clamped; one final check runs at the boundary so
    a condition that comes true exactly at the deadline still wins."""
    while True:
        result = await fn()
        if result is not None:
            return result
        if deadline is not None and deadline.expired():
            _count_exhausted(site)
            raise DeadlineExceeded(f"{what}: deadline exceeded")
        _count_retry(site)
        await asyncio.sleep(
            interval if deadline is None else deadline.clamp(interval)
        )


def wait_for_sync(
    fn: Callable[[], Any],
    *,
    site: str,
    interval: float = 2.0,
    deadline: Optional[Deadline] = None,
    what: str = "condition",
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Synchronous twin of :func:`wait_for_async`."""
    while True:
        result = fn()
        if result is not None:
            return result
        if deadline is not None and deadline.expired():
            _count_exhausted(site)
            raise DeadlineExceeded(f"{what}: deadline exceeded")
        _count_retry(site)
        sleep(interval if deadline is None else deadline.clamp(interval))


# module default RNG: entropy-seeded in production; tests inject their
# own seeded Random for deterministic schedules
_default_rng = random.Random()
