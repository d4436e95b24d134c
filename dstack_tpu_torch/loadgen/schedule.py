"""Compile (spec, seed) → a replayable open-loop event schedule (the
port's copy of ``dstack_tpu.loadgen.schedule``: equal events and
``digest()`` for equal inputs).

The compiler is a **pure function**: every draw comes from a named
``random.Random`` stream keyed ``"{seed}:{component}"`` (the
``DTPU_FAULT_PLAN`` determinism idiom — inserting a class or session
never perturbs its neighbors' streams), so the same (spec, seed) always
yields a byte-identical schedule and two soak runs replay the exact
same traffic. The schedule is *open-loop*: event times are fixed at
compile time and the driver fires them regardless of completions —
arrivals never slow down because the system under test is struggling,
which is precisely the queueing behavior closed-loop benches hide
(Schroeder et al., "Open Versus Closed").

Construction, per class:

- Session/request start times come from a Poisson process at the
  class's share of the spec rate (chat classes admit *sessions* at
  ``share × rate / turns`` so their turn stream lands near the share).
  The ``diurnal`` process thins a peak-rate stream against
  ``rate(t) = rate × (1 + amplitude · sin(2πt / period))`` with seeded
  acceptance draws — still a pure function of the seed.
- A chat session's turns follow at seeded exponential think-time gaps;
  turn *k+1*'s message list extends turn *k*'s with a **scripted**
  assistant reply plus the next seeded user message, so prefix chains
  (``routing.affinity.chain_digests``) and the engine's KV prefix
  cache see a real conversation replay while the schedule stays
  completion-independent.
- Completion events carry one seeded prompt string.

Import-light (stdlib + textgen): compiling and diffing schedules needs
neither torch nor aiohttp.
"""

import hashlib
import json
import math
import random
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from dstack_tpu_torch.loadgen.spec import ArrivalSpec, TenantClass, WorkloadSpec
from dstack_tpu_torch.loadgen.textgen import WordRNG, chars_in, session_text


@dataclass(frozen=True)
class Event:
    """One scheduled request. ``t`` is seconds from soak start;
    ``messages`` (chat) or ``prompt`` (completion) is the full request
    content — the driver adds nothing but transport."""

    t: float
    rid: str
    cls: str
    kind: str  # "chat" | "completion"
    tenant: str
    priority: str
    session: Optional[str]  # chat only
    turn: int  # 0-based turn index (0 for completions)
    messages: Optional[Tuple[dict, ...]]  # chat request history
    prompt: Optional[str]  # completion prompt
    max_tokens: int
    stream: bool
    temperature: float
    seed: Optional[int]  # per-request sampling seed (seeded classes)
    ttft_slo_ms: float
    tpot_slo_ms: float

    def to_dict(self) -> dict:
        return {
            "t": round(self.t, 6),
            "rid": self.rid,
            "cls": self.cls,
            "kind": self.kind,
            "tenant": self.tenant,
            "priority": self.priority,
            "session": self.session,
            "turn": self.turn,
            "messages": list(self.messages) if self.messages else None,
            "prompt": self.prompt,
            "max_tokens": self.max_tokens,
            "stream": self.stream,
            "temperature": self.temperature,
            "seed": self.seed,
        }


@dataclass(frozen=True)
class EventSchedule:
    """The compiled schedule plus its identity: ``digest`` is the
    sha256 of the canonical JSONL rendering, so "same workload" is a
    string comparison in a soak artifact."""

    spec: WorkloadSpec
    seed: int
    events: Tuple[Event, ...]

    def to_jsonl(self) -> str:
        return "".join(
            json.dumps(e.to_dict(), sort_keys=True) + "\n"
            for e in self.events
        )

    def digest(self) -> str:
        return hashlib.sha256(self.to_jsonl().encode()).hexdigest()

    def classes(self) -> dict:
        return {c.name: c for c in self.spec.classes}


def _poisson_starts(
    rng: random.Random, arrival: ArrivalSpec, rate: float, duration: float
) -> Iterator[float]:
    """Arrival times on [0, duration) at mean ``rate``; the diurnal
    process thins a peak-rate homogeneous stream (one acceptance draw
    per candidate, always consumed, so the schedule stays a pure
    function of the stream)."""
    if rate <= 0:
        return
    diurnal = arrival.process == "diurnal"
    amp = min(max(arrival.amplitude, 0.0), 1.0) if diurnal else 0.0
    peak = rate * (1.0 + amp)
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration:
            return
        if diurnal:
            inst = rate * (
                1.0 + amp * math.sin(2.0 * math.pi * t / arrival.period_s)
            )
            accept = rng.random() < inst / peak
            if not accept:
                continue
        yield t


def _chat_session_events(
    spec: WorkloadSpec,
    cls: TenantClass,
    seed: int,
    session_ix: int,
    start: float,
) -> List[dict]:
    """All turn events of one session (dicts pre-rid; times past the
    soak end are dropped — the session is truncated, like a user whose
    chat outlives the observation window)."""
    srng = random.Random(f"{seed}:session:{cls.name}:{session_ix}")
    text = WordRNG(random.Random(f"{seed}:text:{cls.name}:{session_ix}"))
    tenant = f"{cls.name}-t{srng.randrange(cls.tenants)}"
    session_id = f"{cls.name}-s{session_ix}"
    out: List[dict] = []
    t = start
    messages: List[dict] = []
    for turn in range(cls.turns):
        if turn > 0:
            t += srng.expovariate(1.0 / max(cls.think_time_s, 1e-6))
            if t >= spec.duration_s:
                break
        messages = list(messages)  # each event owns its prefix snapshot
        messages.append({
            "role": "user",
            "content": session_text(text, chars_in(text, cls.turn_chars)),
        })
        out.append({
            "t": t,
            "cls": cls,
            "tenant": tenant,
            "session": session_id,
            "turn": turn,
            "messages": tuple(messages),
            "prompt": None,
            "max_tokens": _tokens_in(srng, cls.max_tokens),
            "seed": _request_seed(srng, cls),
        })
        # scripted assistant reply: the NEXT turn's history extends this
        # turn's prompt with seeded text, so the prefix chain grows like
        # a live conversation without coupling turn k+1 to turn k's
        # actual completion (open-loop: it may not even have started)
        messages.append({
            "role": "assistant",
            "content": session_text(text, 4 * cls.max_tokens[1]),
        })
    return out


def _tokens_in(rng: random.Random, bounds: Tuple[int, int]) -> int:
    lo, hi = bounds
    return lo if hi <= lo else rng.randint(lo, hi)


def _request_seed(rng: random.Random, cls: TenantClass) -> Optional[int]:
    # ALWAYS advance the stream so toggling `seeded` never shifts the
    # session's later draws (the fault-plan independence idiom)
    s = rng.randrange(1, 2**31)
    return s if cls.seeded else None


def _completion_events(
    spec: WorkloadSpec, cls: TenantClass, seed: int, ix: int, start: float
) -> List[dict]:
    srng = random.Random(f"{seed}:session:{cls.name}:{ix}")
    text = WordRNG(random.Random(f"{seed}:text:{cls.name}:{ix}"))
    tenant = f"{cls.name}-t{srng.randrange(cls.tenants)}"
    return [{
        "t": start,
        "cls": cls,
        "tenant": tenant,
        "session": None,
        "turn": 0,
        "messages": None,
        "prompt": session_text(text, chars_in(text, cls.prompt_chars)),
        "max_tokens": _tokens_in(srng, cls.max_tokens),
        "seed": _request_seed(srng, cls),
    }]


def compile_schedule(spec: WorkloadSpec, seed: int) -> EventSchedule:
    """(spec, seed) → :class:`EventSchedule`. Same inputs, same bytes."""
    if not spec.classes:
        raise ValueError("workload spec has no classes")
    total_share = sum(c.share for c in spec.classes)
    raw: List[dict] = []
    for cls in spec.classes:
        req_rate = spec.arrival.rate_rps * cls.share / total_share
        start_rate = (
            req_rate / cls.turns if cls.kind == "chat" else req_rate
        )
        arng = random.Random(f"{seed}:arrivals:{cls.name}")
        for ix, start in enumerate(
            _poisson_starts(arng, spec.arrival, start_rate, spec.duration_s)
        ):
            if cls.kind == "chat":
                raw.extend(
                    _chat_session_events(spec, cls, seed, ix, start)
                )
            else:
                raw.extend(
                    _completion_events(spec, cls, seed, ix, start)
                )
    # deterministic order: time, then a stable identity tie-break
    raw.sort(
        key=lambda e: (e["t"], e["cls"].name, e["session"] or "", e["turn"])
    )
    events = tuple(
        Event(
            t=e["t"],
            rid=f"e{i:05d}",
            cls=e["cls"].name,
            kind=e["cls"].kind,
            tenant=e["tenant"],
            priority=e["cls"].priority,
            session=e["session"],
            turn=e["turn"],
            messages=e["messages"],
            prompt=e["prompt"],
            max_tokens=e["max_tokens"],
            stream=e["cls"].stream,
            temperature=e["cls"].temperature,
            seed=e["seed"],
            ttft_slo_ms=e["cls"].ttft_slo_ms,
            tpot_slo_ms=e["cls"].tpot_slo_ms,
        )
        for i, e in enumerate(raw)
    )
    return EventSchedule(spec=spec, seed=seed, events=events)
