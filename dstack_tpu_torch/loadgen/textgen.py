"""Seeded workload text and prompt generators (own copy of
``dstack_tpu.loadgen.textgen``): the same rng state gives the same
prompts and conversations as the JAX package's, so a bench line or a
soak of either package measures the same workload.

The serving bench (``serve/bench.py``: burst prompts, repetitive
phrases, ``--sessions`` conversations) and the loadgen schedule compiler
both draw from here. The generators take anything with numpy's
``Generator.integers(lo, hi, n)``: a ``numpy.random.Generator`` (the
bench) or the stdlib-backed :class:`WordRNG` (the schedule compiler,
which imports no numpy); the module imports nothing but the stdlib.
"""

import random
from typing import List, Sequence, Tuple

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


class WordRNG:
    """Stdlib adapter exposing the one rng method the generators use
    (``integers(lo, hi, n)``), so the schedule compiler stays a pure
    function of its ``random.Random`` streams without importing numpy."""

    __slots__ = ("_r",)

    def __init__(self, rng: random.Random):
        self._r = rng

    def integers(self, lo: int, hi: int, n: int) -> List[int]:
        # half-open [lo, hi) like numpy.Generator.integers
        return [self._r.randrange(lo, hi) for _ in range(n)]


def session_text(rng, n_chars: int) -> str:
    """Seeded pseudo-prose: ~5-char lowercase words until ``n_chars``.
    Deterministic in the rng, so two compilations of the same workload
    replay the exact same conversations."""
    words = []
    total = 0
    while total < n_chars:
        w = "".join(_LETTERS[int(i)] for i in rng.integers(0, 26, 5))
        words.append(w)
        total += len(w) + 1
    return " ".join(words)


def conversation_texts(rng, sessions: int, turns: int, turn_chars: int) -> List[List[str]]:
    """Seeded user-turn texts for ``sessions`` multi-turn chats: the
    ``serve/bench.py --sessions`` workload and the loadgen chat classes
    share this construction (rng consumption order included)."""
    return [[session_text(rng, turn_chars) for _ in range(turns)] for _ in range(sessions)]


def token_prompts(rng, vocab_size: int, count: int, length: int) -> List[List[int]]:
    """``count`` random token-id prompts of ``length`` drawn from
    ``[1, vocab_size)``: the bench's burst and throughput workload."""
    return [[int(t) for t in rng.integers(1, vocab_size, length)] for _ in range(count)]


def repetitive_prompts(
    rng, vocab_size: int, count: int, length: int, phrase_len: int = 16
) -> List[List[int]]:
    """``count`` copies of a tiled ``phrase_len``-token phrase: the
    repetition where prompt-lookup speculation pays off (``--repetitive``)."""
    phrase = [int(t) for t in rng.integers(1, vocab_size, phrase_len)]
    reps = length // phrase_len + 1
    return [(phrase * reps)[:length] for _ in range(count)]


def chars_in(rng, bounds: Sequence[int]) -> int:
    """One draw from an inclusive [lo, hi] length range (lo == hi is a
    constant): the schedule compiler's prompt and turn sizing."""
    lo, hi = int(bounds[0]), int(bounds[1])
    if hi <= lo:
        return lo
    return int(rng.integers(lo, hi + 1, 1)[0])


def bounds_pair(value, default: Tuple[int, int]) -> Tuple[int, int]:
    """Normalize a spec length field: an int means a constant, a
    two-item list an inclusive range."""
    if value is None:
        return default
    if isinstance(value, (int, float)):
        v = int(value)
        return (v, v)
    lo, hi = int(value[0]), int(value[1])
    return (min(lo, hi), max(lo, hi))
