"""Seeded prompt generators of the serving bench (own copy of
``token_prompts`` and ``repetitive_prompts`` from
``dstack_tpu.loadgen.textgen``): the same numpy ``Generator`` state gives
the same prompts as the JAX package's, so a bench line of either package
measures the same workload.

The generators take anything with numpy's ``Generator.integers(lo, hi,
n)``; the module imports nothing. The session texts and the loadgen
schedule's helpers come with ``run_session_bench`` (ROADMAP A4).
"""

from typing import List


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
