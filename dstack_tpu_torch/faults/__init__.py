"""Deterministic fault injection (own copy of ``dstack_tpu.faults``, no
JAX import; the port's server fires ``serve.admit``, ``serve.deadline`` and
``serve.engine.step``, the catalog keeps every point of the JAX package).

The chaos layer the reconciliation loops, cloud API calls, agent RPCs,
routing pools, and the serve engine are instrumented with: named
injection points (``faults.fire("gcp.api.request")``) driven by a
seeded declarative plan so a test — or an operator game-day — can
provoke exactly the failures production throws (spot preemption, API
429s, runner death mid-stream, a wedged commit) on demand and
reproducibly.

Design constraints, in order:

- **Zero cost when disabled.** ``fire``/``afire``/``mutate`` are
  module-level names bound to no-ops until a plan is installed; an
  instrumented hot path pays one module-attribute load and an empty
  call, no dict lookups, no plan parsing (verified by a test asserting
  the no-op identity). ``DTPU_FAULT_PLAN`` unset also skips all plan
  parsing at import.
- **Deterministic.** The injection schedule is a pure function of
  (plan seed, rule order, per-rule matching-call order). Probabilistic
  rules draw from a per-rule ``random.Random`` seeded with
  ``"{seed}:{rule_index}"``; nth-call rules count matching calls.
  Same plan + same call sequence → same faults, every run.
- **Import-light.** Stdlib only (``fnmatch``, ``json``, ``random``);
  exceptions named by dotted path resolve lazily at fire time, so the
  docs CLI and offline validation never import aiohttp or jax.
- **Loud.** Every injected fault logs at WARNING with the point, rule,
  action, and call number — an injected fault that vanishes into a
  silent ``except Exception`` is a bug the DTPU006 lint rule exists to
  prevent.

Plan format (``DTPU_FAULT_PLAN`` = inline JSON, or ``@/path.json``)::

    {"seed": 7, "rules": [
      {"point": "gcp.api.*",  "action": "raise", "error": "http:429",
       "retry_after": 2, "times": 3},
      {"point": "agent.pull", "action": "raise", "error": "connect",
       "nth": 2},
      {"point": "routing.probe", "action": "delay", "seconds": 0.1,
       "prob": 0.5},
      {"point": "agent.shim.healthcheck", "action": "corrupt",
       "replace": {"interruption_notice": "spot preemption"}},
      {"point": "db.commit", "action": "hang", "seconds": 30}
    ]}

Rule semantics: a rule matches a call when the point name matches the
rule's ``point`` glob and the call's context is a superset of the
rule's ``ctx``. Matching calls increment the rule's counter; the rule
*fires* on the ``nth`` matching call (int or list of ints), with
probability ``prob``, or on every matching call when neither is given
— capped at ``times`` total firings. Actions: ``raise`` (see
:data:`ERROR_SHORTHANDS` + dotted paths), ``delay`` (sleep
``seconds``, default 0.05), ``hang`` (sleep ``seconds``, default 3600
— async sites sleep cancellably so deadlines still fire), ``corrupt``
(``mutate()`` merges ``replace`` into dict responses / substitutes
``value``).

See ``docs/reference/testing.md`` ("Chaos testing") for the point
catalog and determinism contract; ``python -m dstack_tpu_torch.faults``
lists points and validates plans offline.
"""

import fnmatch
import json
import os
import random
from typing import Any, Optional

from dstack_tpu_torch.faults.catalog import POINTS
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("faults")

__all__ = [
    "FaultError",
    "FaultInjected",
    "InjectedHTTPError",
    "FaultPlan",
    "active",
    "install_plan",
    "clear",
    "validate_plan",
    "fire",
    "afire",
    "mutate",
    "POINTS",
]


class FaultError(Exception):
    """Base class of every exception the fault layer injects."""


class FaultInjected(FaultError):
    """Default injected failure (action=raise with no ``error``)."""


class InjectedHTTPError(FaultError):
    """Injected HTTP-style failure: carries ``status`` and optional
    ``retry_after`` so the retry layer's duck-typed classifier
    (:mod:`dstack_tpu_torch.utils.retry`) treats it like a real 429/5xx."""

    def __init__(self, status: int, retry_after: Optional[float] = None,
                 point: str = ""):
        super().__init__(f"injected HTTP {status} at {point or '<point>'}")
        self.status = int(status)
        self.retry_after = retry_after


# error shorthand -> zero-arg exception factory (lazy: nothing imported
# until a rule actually fires)
ERROR_SHORTHANDS = {
    "injected": lambda point: FaultInjected(f"injected fault at {point}"),
    "timeout": lambda point: TimeoutError(f"injected timeout at {point}"),
    "connect": lambda point: ConnectionError(
        f"injected connect error at {point}"
    ),
    "oserror": lambda point: OSError(f"injected OS error at {point}"),
}

_VALID_ACTIONS = ("raise", "delay", "hang", "corrupt")
_VALID_KEYS = {
    "point", "action", "error", "nth", "prob", "times", "seconds",
    "retry_after", "ctx", "replace", "value",
}


def _resolve_error(spec: Optional[str], rule: dict, point: str) -> BaseException:
    """Error spec → exception instance. ``http:<status>`` builds an
    :class:`InjectedHTTPError`; shorthands come from
    :data:`ERROR_SHORTHANDS`; anything with a dot is imported as a
    dotted path (``aiohttp.ClientConnectionError``,
    ``builtins.RuntimeError``, …)."""
    if spec is None:
        spec = "injected"
    if spec.startswith("http:"):
        return InjectedHTTPError(
            int(spec.split(":", 1)[1]),
            retry_after=rule.get("retry_after"),
            point=point,
        )
    if spec in ERROR_SHORTHANDS:
        return ERROR_SHORTHANDS[spec](point)
    mod_name, _, attr = spec.rpartition(".")
    if not mod_name:
        raise ValueError(f"unknown fault error spec: {spec!r}")
    import importlib

    exc_type = getattr(importlib.import_module(mod_name), attr)
    return exc_type(f"injected {spec} at {point}")


def validate_plan(data: Any) -> list:
    """Offline plan validation → list of error strings (empty = valid).
    Checks shape, actions, error specs (shorthand/http/dotted form —
    dotted paths are NOT imported), and that every rule's point glob
    matches at least one cataloged injection point."""
    errors: list = []
    if not isinstance(data, dict):
        return [f"plan must be a JSON object, got {type(data).__name__}"]
    seed = data.get("seed", 0)
    if not isinstance(seed, int):
        errors.append(f"seed must be an int, got {seed!r}")
    unknown_top = set(data) - {"seed", "rules"}
    if unknown_top:
        errors.append(f"unknown top-level keys: {sorted(unknown_top)}")
    rules = data.get("rules")
    if not isinstance(rules, list):
        return errors + ["rules must be a list"]
    for i, rule in enumerate(rules):
        where = f"rules[{i}]"
        if not isinstance(rule, dict):
            errors.append(f"{where}: must be an object")
            continue
        unknown = set(rule) - _VALID_KEYS
        if unknown:
            errors.append(f"{where}: unknown keys {sorted(unknown)}")
        point = rule.get("point")
        if not isinstance(point, str) or not point:
            errors.append(f"{where}: 'point' (glob) is required")
        elif not any(fnmatch.fnmatchcase(p, point) for p in POINTS):
            errors.append(
                f"{where}: point glob {point!r} matches no registered "
                "injection point (see `python -m dstack_tpu_torch.faults`)"
            )
        action = rule.get("action", "raise")
        if action not in _VALID_ACTIONS:
            errors.append(
                f"{where}: action {action!r} not one of {_VALID_ACTIONS}"
            )
        err = rule.get("error")
        if err is not None:
            if not isinstance(err, str):
                errors.append(f"{where}: 'error' must be a string")
            elif err.startswith("http:"):
                try:
                    int(err.split(":", 1)[1])
                except ValueError:
                    errors.append(f"{where}: bad http error spec {err!r}")
            elif err not in ERROR_SHORTHANDS and "." not in err:
                errors.append(
                    f"{where}: unknown error shorthand {err!r} "
                    f"(known: {sorted(ERROR_SHORTHANDS)}, http:<status>, "
                    "or a dotted exception path)"
                )
        nth = rule.get("nth")
        if nth is not None and not (
            isinstance(nth, int)
            or (isinstance(nth, list) and all(isinstance(n, int) for n in nth))
        ):
            errors.append(f"{where}: 'nth' must be an int or list of ints")
        prob = rule.get("prob")
        if prob is not None and not (
            isinstance(prob, (int, float)) and 0.0 <= prob <= 1.0
        ):
            errors.append(f"{where}: 'prob' must be a number in [0, 1]")
        for key in ("times",):
            v = rule.get(key)
            if v is not None and not (isinstance(v, int) and v >= 0):
                errors.append(f"{where}: {key!r} must be a non-negative int")
        secs = rule.get("seconds")
        if secs is not None and not (
            isinstance(secs, (int, float)) and secs >= 0
        ):
            errors.append(f"{where}: 'seconds' must be a non-negative number")
        ctx = rule.get("ctx")
        if ctx is not None and not isinstance(ctx, dict):
            errors.append(f"{where}: 'ctx' must be an object")
        rep = rule.get("replace")
        if rep is not None and not isinstance(rep, dict):
            errors.append(f"{where}: 'replace' must be an object")
    return errors


class _Rule:
    """One compiled plan rule with its deterministic firing state."""

    __slots__ = (
        "index", "raw", "point", "action", "nth", "prob", "times",
        "seconds", "ctx", "rng", "calls", "fired",
    )

    def __init__(self, index: int, raw: dict, seed: int):
        self.index = index
        self.raw = raw
        self.point = raw["point"]
        self.action = raw.get("action", "raise")
        nth = raw.get("nth")
        self.nth = (
            None if nth is None else {nth} if isinstance(nth, int) else set(nth)
        )
        self.prob = raw.get("prob")
        self.times = raw.get("times")
        self.seconds = raw.get("seconds")
        self.ctx = raw.get("ctx") or {}
        # per-rule stream: rule order in the plan is part of the seed,
        # so inserting a rule never perturbs its neighbors' schedules
        self.rng = random.Random(f"{seed}:{index}")
        self.calls = 0  # matching calls seen
        self.fired = 0  # faults actually injected

    def matches(self, point: str, ctx: dict) -> bool:
        if not fnmatch.fnmatchcase(point, self.point):
            return False
        return all(ctx.get(k) == v for k, v in self.ctx.items())

    def wants_fire(self) -> bool:
        """Called once per MATCHING call; advances the call counter
        (and the RNG stream for probabilistic rules) deterministically.
        The caller increments ``fired`` only on the rule that actually
        wins the call (first willing rule in plan order)."""
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None and self.calls not in self.nth:
            return False
        if self.prob is not None and self.rng.random() >= self.prob:
            return False
        return True


class FaultPlan:
    """A compiled, stateful fault plan (one instance per install)."""

    def __init__(self, data: dict):
        errors = validate_plan(data)
        if errors:
            raise ValueError("invalid fault plan: " + "; ".join(errors))
        self.seed = data.get("seed", 0)
        self.rules = [
            _Rule(i, r, self.seed) for i, r in enumerate(data.get("rules", []))
        ]

    # -- injection-point entry points (bound to the module-level names
    # while this plan is installed) --

    def _firing_rule(self, point: str, action_kinds: tuple, ctx: dict):
        # EVERY matching rule's counter advances on every matching call
        # (a rule's schedule is independent of its neighbors firing);
        # the first willing rule in plan order wins the call
        winner = None
        for rule in self.rules:
            if rule.action not in action_kinds:
                continue
            if not rule.matches(point, ctx):
                continue
            if rule.wants_fire() and winner is None:
                winner = rule
        if winner is not None:
            winner.fired += 1
        return winner

    def fire(self, point: str, **ctx) -> None:
        """Synchronous injection point (may raise or sleep)."""
        rule = self._firing_rule(point, ("raise", "delay", "hang"), ctx)
        if rule is None:
            return
        self._log(rule, point)
        if rule.action == "raise":
            raise _resolve_error(rule.raw.get("error"), rule.raw, point)
        import time

        time.sleep(rule.seconds if rule.seconds is not None
                   else (0.05 if rule.action == "delay" else 3600.0))

    async def afire(self, point: str, **ctx) -> None:
        """Async injection point: delays/hangs use ``asyncio.sleep`` so
        caller deadlines and cancellation still work."""
        rule = self._firing_rule(point, ("raise", "delay", "hang"), ctx)
        if rule is None:
            return
        self._log(rule, point)
        if rule.action == "raise":
            raise _resolve_error(rule.raw.get("error"), rule.raw, point)
        import asyncio

        await asyncio.sleep(rule.seconds if rule.seconds is not None
                            else (0.05 if rule.action == "delay" else 3600.0))

    def mutate(self, point: str, value: Any, **ctx) -> Any:
        """Response-corruption injection point: returns the (possibly
        corrupted) value. ``replace`` merges into dict values; ``value``
        substitutes wholesale; with neither, dicts gain a marker key and
        anything else becomes the string ``"__dtpu_corrupt__"``."""
        rule = self._firing_rule(point, ("corrupt",), ctx)
        if rule is None:
            return value
        self._log(rule, point)
        if "value" in rule.raw:
            return rule.raw["value"]
        if isinstance(value, dict):
            return {**value, **(rule.raw.get("replace") or
                                {"__dtpu_corrupted__": True})}
        return "__dtpu_corrupt__"

    def _log(self, rule: _Rule, point: str) -> None:
        logger.warning(
            "fault injected: point=%s rule=%d action=%s call=%d fired=%d",
            point, rule.index, rule.action, rule.calls, rule.fired,
        )


# ---------------------------------------------------------------------------
# module-level no-op fast path
# ---------------------------------------------------------------------------


def _noop_fire(point: str, **ctx) -> None:
    return None


async def _noop_afire(point: str, **ctx) -> None:
    return None


def _noop_mutate(point: str, value: Any, **ctx) -> Any:
    return value


# the installed plan (None = disabled); fire/afire/mutate are REBOUND on
# install so the disabled path is a plain no-op call — tests assert
# `faults.fire is faults._noop_fire` to pin the zero-cost contract
_plan: Optional[FaultPlan] = None
fire = _noop_fire
afire = _noop_afire
mutate = _noop_mutate


def active() -> bool:
    return _plan is not None


def current_plan() -> Optional[FaultPlan]:
    return _plan


def install_plan(data) -> FaultPlan:
    """Compile + install a plan (dict, JSON string, or ``@path``).
    Raises ``ValueError`` on an invalid plan. Returns the compiled plan
    (whose rule counters tests may inspect)."""
    global _plan, fire, afire, mutate
    if isinstance(data, str):
        data = _load_plan_text(data)
    plan = FaultPlan(data)
    _plan = plan
    fire = plan.fire
    afire = plan.afire
    mutate = plan.mutate
    logger.warning(
        "fault plan installed: %d rules, seed=%d", len(plan.rules), plan.seed
    )
    return plan


def clear() -> None:
    """Uninstall any plan and restore the no-op fast path."""
    global _plan, fire, afire, mutate
    _plan = None
    fire = _noop_fire
    afire = _noop_afire
    mutate = _noop_mutate


def _load_plan_text(text: str) -> dict:
    text = text.strip()
    if text.startswith("@"):
        with open(text[1:]) as f:
            return json.load(f)
    return json.loads(text)


def _install_from_env() -> None:
    """Install the plan named by ``DTPU_FAULT_PLAN`` if set — called at
    import so any process (server, agent, serve) picks it up. A broken
    plan fails LOUDLY: a chaos run silently running fault-free would
    green-light invariants it never exercised."""
    raw = os.getenv("DTPU_FAULT_PLAN")
    if not raw:
        return
    install_plan(raw)


_install_from_env()
