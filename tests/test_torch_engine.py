"""The port's InferenceEngine against the JAX engine on the CPU.

Both engines run LLAMA_TINY_64 with the same weights (params_from_jax)
on the serial path, pinned (prefill_pack=1, spec_draft=0, turbo_steps=0,
prefix_cache=False), with the flash decode path, and both are driven by
the same call sequence the server's scheduler makes: one prefill chunk
per tick, then one decode step. Greedy output must match token for
token, and every prefill and decode logit row within 1e-4 (f32), so a
near-tie cannot hide a fault. Sampling streams differ by construction
(threefry vs torch.Generator), so a seeded sampled request is checked
for its distribution and its own determinism only."""

import jax
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.serve import engine as tengine

ATOL = 1e-4
MAX_SEQ = 256
CHUNK = 64
# the serial path, pinned: the engine's defaults are the packed, speculative
# and turbo path (tests/test_torch_serve_breadth.py)
SERIAL = dict(prefill_pack=1, spec_draft=0, turbo_steps=0, prefix_cache=False)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jllama.LLAMA_TINY_64, jax.random.key(0))
    tp = tllama.params_from_jax(
        jax.tree.map(np.asarray, jp), tllama.LLAMA_TINY_64, device="cpu"
    )
    return jp, tp


def _jax_engine(jp):
    eng = jengine.InferenceEngine(
        jllama.LLAMA_TINY_64, jp, max_batch=2, max_seq=MAX_SEQ,
        prefill_chunk=CHUNK, decode_kernel="flash", **SERIAL,
    )
    logs = []
    decode, activate = eng._decode, eng._activate

    def rec_decode(*a, **kw):
        logits, cache = decode(*a, **kw)
        logs.append(("decode", np.asarray(logits)))
        return logits, cache

    def rec_activate(slot, prompt, tp, gen, logits):
        logs.append(("prefill", np.asarray(logits)))
        return activate(slot, prompt, tp, gen, logits)

    eng._decode, eng._activate = rec_decode, rec_activate
    return eng, logs


def _torch_engine(tp, monkeypatch):
    eng = tengine.InferenceEngine(
        tllama.LLAMA_TINY_64, tp, max_batch=2, max_seq=MAX_SEQ,
        prefill_chunk=CHUNK, device="cpu", **SERIAL,
    )
    logs = []
    decode = tengine.decode_step
    activate = eng._activate

    def rec_decode(*a, **kw):
        logits, cache = decode(*a, **kw)
        logs.append(("decode", logits.numpy().copy()))
        return logits, cache

    def rec_activate(slot, prompt, n, gen, logits):
        logs.append(("prefill", logits.numpy().copy()))
        return activate(slot, prompt, n, gen, logits)

    monkeypatch.setattr(tengine, "decode_step", rec_decode)
    eng._activate = rec_activate
    return eng, logs


def _drive(eng, prompts, gens) -> dict:
    """The scheduler's call sequence: admit all, then per tick one
    prefill chunk and (when any slot is active) one decode step."""
    slots = [eng.start_request(list(p), g) for p, g in zip(prompts, gens)]
    out = {s: [] for s in slots}
    while eng._prefilling or any(eng.active[s] for s in slots):
        if eng._prefilling:
            for s, tok in eng.prefill_wave().items():
                out[s].append(tok)
        if any(eng.active[s] for s in slots):
            for s, toks in eng.step().items():
                out[s].extend(toks)
    return [out[s] for s in slots]


def _prompts(rng, lens):
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


class TestGreedyParity:
    def test_long_prompt_and_two_concurrent_slots(self, weights, monkeypatch):
        jp, tp = weights
        rng = np.random.default_rng(0)
        # 150 tokens: three 64-token chunks (start 0, 64, 128); 20: one
        # 32-token bucket admitted while the long prompt is mid-prefill
        prompts = _prompts(rng, [150, 20])
        gens = lambda: [jengine.GenParams(max_new_tokens=12), jengine.GenParams(max_new_tokens=9)]
        tgens = [tengine.GenParams(max_new_tokens=12), tengine.GenParams(max_new_tokens=9)]
        je, jlogs = _jax_engine(jp)
        te, tlogs = _torch_engine(tp, monkeypatch)
        jout = _drive(je, prompts, gens())
        tout = _drive(te, prompts, tgens)
        assert tout == jout
        assert [len(o) for o in tout] == [12, 9]
        assert [k for k, _ in tlogs] == [k for k, _ in jlogs]
        for (_, t), (_, j) in zip(tlogs, jlogs):
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=ATOL)

    def test_generate_matches(self, weights, monkeypatch):
        jp, tp = weights
        prompt = _prompts(np.random.default_rng(1), [70])[0]
        je, _ = _jax_engine(jp)
        te, _ = _torch_engine(tp, monkeypatch)
        assert te.generate(prompt, tengine.GenParams(max_new_tokens=10)) == je.generate(
            prompt, jengine.GenParams(max_new_tokens=10)
        )
        assert te.free_slots() == [0, 1]

    def test_einsum_decode_matches_flash(self, weights):
        _, tp = weights
        prompt = _prompts(np.random.default_rng(2), [90])[0]
        outs = [
            tengine.InferenceEngine(
                tllama.LLAMA_TINY_64, tp, max_batch=2, max_seq=MAX_SEQ,
                prefill_chunk=CHUNK, decode_kernel=k, device="cpu", **SERIAL,
            ).generate(prompt, tengine.GenParams(max_new_tokens=8))
            for k in ("flash", "einsum")
        ]
        assert outs[0] == outs[1]


class TestSampling:
    def test_seeded_stream_is_deterministic_and_resumable(self, weights):
        _, tp = weights
        prompt = _prompts(np.random.default_rng(3), [30])[0]

        def run(p, n, skip=0):
            eng = tengine.InferenceEngine(
                tllama.LLAMA_TINY_64, tp, max_batch=2, max_seq=MAX_SEQ,
                prefill_chunk=CHUNK, device="cpu", **SERIAL,
            )
            g = tengine.GenParams(
                max_new_tokens=n, temperature=1.0, seed=7, seed_skip=skip
            )
            return eng.generate(p, g)

        a, b = run(prompt, 8), run(prompt, 8)
        assert a == b
        # resume after 3 delivered tokens: the continuation draws from
        # the original stream (seed_skip), so it reproduces the tail
        assert run(prompt + a[:3], 5, skip=3) == a[3:]

    def test_sampled_tokens_follow_the_jax_distribution(self, weights):
        jp, tp = weights
        prompt = _prompts(np.random.default_rng(4), [24])[0]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :24] = prompt
        cache = jengine.init_cache(jllama.LLAMA_TINY_64, 1, MAX_SEQ)
        logits, _ = jengine.prefill_chunk_step(
            jp, cache, jax.numpy.asarray(toks), jax.numpy.asarray(0),
            jax.numpy.asarray(23), jllama.LLAMA_TINY_64, start=0,
        )
        logits = np.array(logits)  # [1, V], a writable copy
        temp, top_k = 0.05, 8
        top = np.argsort(-logits[0])[:top_k]
        p = np.exp((logits[0, top] - logits[0, top].max()) / temp)
        p /= p.sum()
        n = 3000
        g = torch.Generator().manual_seed(0)
        one = lambda x: torch.tensor([x])
        counts = np.zeros(logits.shape[1])
        zeros = torch.zeros((1, logits.shape[1]), dtype=torch.int32)
        for _ in range(n):
            t = tengine.sample(
                torch.from_numpy(logits), [g], one(temp), one(1.0), one(top_k),
                one(1.0), zeros, one(0.0), one(0.0), zeros,
            )
            counts[int(t[0])] += 1
        assert counts[top].sum() == n  # nothing outside the top-k
        tv = 0.5 * np.abs(counts[top] / n - p).sum()
        assert tv < 0.05, (tv, counts[top] / n, p)


class TestRefusals:
    def test_unknown_kv_quant_raises(self, weights):
        _, tp = weights
        with pytest.raises(ValueError, match="unknown kv_quant 'fp8'"):
            tengine.InferenceEngine(tllama.LLAMA_TINY_64, tp, device="cpu", kv_quant="fp8")

    def test_cwrite_at_drops_out_of_range_rows(self):
        ck = torch.zeros(3, 2, 8, 4)
        new = torch.ones(3, 2, 4)
        pos = torch.tensor([1, 8, -1], dtype=torch.int32)  # rows 1, 2 drop
        tengine._cwrite_at(ck, torch.arange(3), pos, new)
        assert ck[0, :, 1].eq(1).all() and ck.sum() == 8

    def test_cwrite_chunk_clamps_like_dynamic_update_slice(self):
        ck = torch.zeros(2, 1, 8, 1)
        new = torch.arange(1.0, 4.0).reshape(1, 1, 3, 1)
        tengine._cwrite_chunk(ck, new, 1, 7)  # start clamps to 8 - 3
        assert ck[1, 0, 5:, 0].tolist() == [1.0, 2.0, 3.0]
