"""The port's default serving engine against the JAX engine on the CPU:
packed prefill, speculative verify, turbo macro-steps and the prefix
cache, on the bf16-layout cache (f32 here) and on the int8 cache.

The step functions (``prefill_packed_step``, ``verify_step``,
``decode_loop``) run on both packages from the same cache state, made by
the same serial prefill: logits within 1e-4, emitted tokens equal, the
caches equal. The JAX side runs ``decode_kernel="flash"`` through Pallas
interpret mode, as its own tests do; the port runs its kernels' plain
versions. Caches compare f32 values within 1e-4 and int8 values exactly
but for a few one step apart (0 to 10 of 131,072 in these cases): the
two frameworks' f32 inputs to the quantizer differ in their last bits,
and a value that close to a half step rounds to the neighbouring
integer; the next layer's K/V, and so the scales, then differ by up to
6.5e-5 relative. So at most 1e-4 of the int8 values may differ, by one
step, and the scales by 1e-4 (on identical inputs ``kv_quantize`` is
exact: test_torch_kv_int8.py).
Then both engines, at their defaults, take the same
call sequence the server's scheduler makes (``start_request`` for a
burst, ``prefill_wave`` until none is pending, ``step`` until done) and
must return identical per-step outputs and step kinds, with drafts
accepted, a packed wave and a prefix hit. ``turbo_quiet_s`` is pinned
high in both, so the adaptive macro-step size never reads the clock."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.serve import engine as tengine

ATOL = 1e-4
INT8_FLIP_SHARE = 1e-4  # of the int8 cache entries, each off by one step at most
MAX_SEQ = 256
CHUNK = 64
JC, TC = jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JC, jax.random.key(0))
    tp = tllama.params_from_jax(jax.tree.map(np.asarray, jp), TC, device="cpu")
    return jp, tp


def _assert_caches(tc: dict, jc: dict) -> None:
    """f32 values and int8 scales within 1e-4; int8 values equal but for
    at most INT8_FLIP_SHARE of them one step apart (see the module note)."""
    assert set(tc) == set(jc)
    for n in jc:
        got, want = tc[n].numpy(), np.asarray(jc[n])
        if want.dtype == np.int8:
            flips = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert flips.max() <= 1 and (flips != 0).mean() <= INT8_FLIP_SHARE, (n, flips.sum())
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=n)


def _prefilled(weights, kv_quant, prompts):
    """Both caches after the same serial prefill of ``prompts`` into
    slots 0, 1, ... (each a single chunk at start 0)."""
    jp, tp = weights
    jc = jengine.init_cache(JC, 4, MAX_SEQ, kv_quant=kv_quant)
    tc = tengine.init_cache(TC, 4, MAX_SEQ, device="cpu", kv_quant=kv_quant)
    for slot, p in enumerate(prompts):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, : len(p)] = p
        jl, jc = jengine.prefill_chunk_step(
            jp, jc, jnp.asarray(toks), jnp.asarray(slot), jnp.asarray(len(p) - 1), JC, start=0
        )
        tl, tc = tengine.prefill_chunk_step(
            tp, tc, torch.from_numpy(toks).long(), slot, len(p) - 1, TC, start=0
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    _assert_caches(tc, jc)
    return jc, tc


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
class TestStepFunctions:
    def test_prefill_packed_step(self, weights, kv_quant):
        jp, tp = weights
        jc, tc = _prefilled(weights, kv_quant, _prompts(0, [64, 40]))
        # G = 4: a fresh prompt in slot 2, slot 0 continuing at 64, slot 1
        # at the unaligned start 40, and one pad row (last_ix = -1)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, 256, size=(4, CHUNK)).astype(np.int32)
        slots = np.array([2, 0, 1, 0], np.int32)
        starts = np.array([0, 64, 40, 0], np.int32)
        last_ix = np.array([29, 63, 10, -1], np.int32)
        jl, jc = jengine.prefill_packed_step(
            jp, jc, *(jnp.asarray(a) for a in (tokens, slots, starts, last_ix)), JC
        )
        tl, tc = tengine.prefill_packed_step(
            tp, tc, *(torch.from_numpy(a).long() for a in (tokens, slots, starts, last_ix)), TC
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_verify_step(self, weights, kv_quant):
        jp, tp = weights
        prompts = _prompts(2, [20, 63, 5, 33])
        jc, tc = _prefilled(weights, kv_quant, prompts)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, 256, size=(4, 5)).astype(np.int32)  # S = spec_draft + 1
        positions = np.array([len(p) for p in prompts], np.int32)
        write_mask = np.array([True, True, False, True])  # slot 2 inactive: its writes drop
        jl, jc = jengine.verify_step(
            jp, jc, jnp.asarray(tokens), jnp.asarray(positions), JC,
            jnp.asarray(write_mask), decode_kernel="flash",
        )
        tl, tc = tengine.verify_step(
            tp, tc, torch.from_numpy(tokens).long(), torch.from_numpy(positions), TC,
            torch.from_numpy(write_mask), decode_kernel="flash",
        )
        assert tl.shape == (4, 5, TC.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_verify_step_einsum_matches_flash(self, weights, kv_quant):
        _, tp = weights
        prompts = _prompts(4, [12, 50])
        _, tc = _prefilled(weights, kv_quant, prompts + [[1], [2]])
        tokens = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 10], [0] * 4, [0] * 4])
        positions = torch.tensor([12, 50, 1, 1], dtype=torch.int32)
        mask = torch.tensor([True, True, False, False])
        copy = {n: a.clone() for n, a in tc.items()}
        fl, _ = tengine.verify_step(tp, tc, tokens, positions, TC, mask, decode_kernel="flash")
        el, _ = tengine.verify_step(tp, copy, tokens, positions, TC, mask, decode_kernel="einsum")
        np.testing.assert_allclose(fl.numpy(), el.numpy(), atol=ATOL, rtol=ATOL)

    def test_decode_loop(self, weights, kv_quant):
        jp, tp = weights
        prompts = _prompts(5, [9, 30, 64, 17])
        jc, tc = _prefilled(weights, kv_quant, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        rem = np.array([8, 2, 8, 8], np.int32)  # slot 1 runs out after 2 steps
        act = np.array([True, True, False, True])  # slot 2 never writes
        eos = np.array([-1, -1, -1, -1], np.int32)
        jout = jengine.decode_loop(
            jp, jc, *(jnp.asarray(a) for a in (tok, pos, rem, act, eos)), JC,
            steps=4, max_seq=MAX_SEQ, decode_kernel="flash",
        )
        tout = tengine.decode_loop(
            tp, tc, torch.from_numpy(tok).long(), torch.from_numpy(pos),
            torch.from_numpy(rem), torch.from_numpy(act), torch.from_numpy(eos).long(), TC,
            steps=4, max_seq=MAX_SEQ, decode_kernel="flash",
        )
        emitted = tout[0].numpy()
        assert emitted.shape == (4, 4) and (emitted[:, 2] == -1).all() and (emitted[2:, 1] == -1).all()
        np.testing.assert_array_equal(emitted, np.asarray(jout[0]))
        for got, want in zip(tout[2:], jout[2:]):  # token, position, budget, active
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_caches(tout[1], jout[1])


def _drive(eng, gen_cls, waves) -> tuple[list, int]:
    """The scheduler's call sequence, wave by wave: admit every prompt of
    the wave, ``prefill_wave`` until none is pending, then ``step`` until
    the wave's slots are done, recording each call's output and kind →
    (records, draft tokens accepted)."""
    records, accepted = [], 0
    for prompts in waves:
        slots = [eng.start_request(list(p), gen_cls(max_new_tokens=24)) for p in prompts]
        while eng._prefilling:
            records.append(("prefill", eng.prefill_wave()))
        while any(eng.active[s] for s in slots):
            out = eng.step()
            records.append((eng._last_step_phase, out))
        accepted += sum(eng._spec_accepted[s] for s in slots)
        for s in slots:
            eng.release(s)
    return records, accepted


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_default_engines_emit_identical_steps(weights, kv_quant):
    jp, tp = weights
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9,
              kv_quant=kv_quant, decode_kernel="flash")
    je = jengine.InferenceEngine(JC, jp, **kw)
    te = tengine.InferenceEngine(TC, tp, device="cpu", **kw)
    assert (te.prefill_pack, te.spec_draft, te.turbo_steps, te.prefix_cache) == (4, 4, 8, True)
    phrase = [5, 9, 13, 17]
    shared = _prompts(6, [160])[0]  # two 64-token chunks of shared prefix
    waves = [
        [(phrase * 12)[:40]],  # the repetitive prompt: drafts fire
        [[7] * 40],
        _prompts(7, [20, 70, 100]),  # a concurrent burst: a packed wave
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],  # reuses 128 cached positions
    ]
    jrec, jacc = _drive(je, jengine.GenParams, waves)
    trec, tacc = _drive(te, tengine.GenParams, waves)
    assert [k for k, _ in trec] == [k for k, _ in jrec]
    assert trec == jrec
    kinds = {k for k, _ in trec}
    assert {"prefill", "spec", "turbo"} <= kinds
    assert tacc == jacc > 0
    st = te.stats
    assert st["spec_accepted_tokens"] == tacc and st["spec_steps"] >= 1
    assert st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1
    assert st["prefix_hits"] == je.prefix_hits == 1
    assert st["prefix_tokens_reused"] == 128
    assert te.prefix_stats()["prefix_hits"] == 1
    _assert_caches(te.cache, je.cache)


def test_step_counts_match_the_dispatches(weights, monkeypatch):
    """The identities chip_smoke.py checks on the card, counted here
    through the plain versions' calls: the decode attention runs
    n_layers times per plain step, verify and turbo device step, and
    the flash prefill n_layers times per serial chunk."""
    _, tp = weights
    calls = {"decode": 0, "prefill": 0}
    eng = tengine.InferenceEngine(TC, tp, max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                  turbo_quiet_s=1e9, device="cpu")
    real_fd, real_fa = tengine.flash_decode, tengine.attention

    def fd(*a, **kw):
        calls["decode"] += 1
        return real_fd(*a, **kw)

    def fa(*a, **kw):
        calls["prefill"] += isinstance(kw["q_offset"], int)  # a tensor: a packed wave
        return real_fa(*a, **kw)

    monkeypatch.setattr(tengine, "flash_decode", fd)
    monkeypatch.setattr(tengine, "attention", fa)
    _drive(eng, tengine.GenParams, [[[7] * 40], _prompts(8, [30, 90, 150]), [[3] * 5]])
    st = eng.stats
    steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
    assert calls["decode"] == TC.n_layers * steps
    assert calls["prefill"] == TC.n_layers * (st["prefill_dispatches"] - st["packed_dispatches"])
    assert st["packed_dispatches"] >= 1 and st["spec_steps"] >= 1
