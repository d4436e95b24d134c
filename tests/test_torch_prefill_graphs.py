"""The port's prefill step sites (``chunk``, ``packed``, ``copy`` and
``mark_prompt``) against the JAX engine's, on the CPU.

- The prefill functions with their varying scalars as ``[1]`` device
  tensors (JAX traces them): ``prefill_chunk_step`` on the f32, int8 and
  MLA caches and a tiny Llama4 (a NoPE layer whose query temperature
  reads the chunk's positions, 16-token attention chunks) at slots other
  than 0 (one out of range: both clamp it) and
  at several ``last_ix`` (-1 counts from the end; one past the end gives
  NaN logits in both), ``prefill_packed_step``
  with a pad row, ``copy_cache_prefix`` and ``_mark_prompt`` against the
  JAX functions under ``jax.jit``. Logits within 1e-4; the cache outside
  the written chunk, the copies and the counts bitwise, the chunk's own
  K/V within 1e-5 (JAX and torch sum the projections in other orders).
- No site function reads a tensor on the host: each runs under a
  ``TorchFunctionMode`` that raises on ``item``, ``__int__``,
  ``__index__``, ``__bool__``, ``__float__``, ``tolist`` and an index by a
  0-d tensor, any of which a CUDA graph would bake in at capture.
- The compile accounting: the JAX engine and the port's, each warmed by
  its own server's ``_warmup_engine``, serve prompts of 40, 300 and 700
  tokens, a prefix hit and bursts of 3 and of 4 at unequal lengths, on
  the f32 (the bf16 cache's form), int8 and MLA caches and Llama4, with the same
  tokens. On the prefill sites their manifests, their compile events by
  site and key and their compile, recompile, warmup-gap and cache-entry
  series are equal, the gaps of the keys JAX's grid leaves cold included.
  On the decode side the port's warmup visits every site JAX's does and
  ``argmax``, ``logprobs``, ``skip_key`` and ``verify`` besides (JAX's
  warmup leaves them to the first request): the port's manifest holds
  JAX's and those alone beside it, the port compiles nothing there after
  the warm mark, and each decode-side key JAX compiles after its mark is
  one the port's warmup visited.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from dstack_tpu.models import llama as jllama
from dstack_tpu.obs import flight as jflight
from dstack_tpu.serve import engine as jengine
from dstack_tpu.serve import openai_server as jserver
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.obs import flight as tflight
from dstack_tpu_torch.serve import engine as tengine
from dstack_tpu_torch.serve import openai_server as tserver

ATOL = 1e-4  # f32 logits end to end
KV_TOL = 1e-5  # the chunk's own K/V: one projection and a rope in f32
PREFILL_SITES = ("chunk", "packed", "copy", "mark_prompt")
MLA = dataclasses.replace(jllama.MLA_TINY, n_layers=2), dataclasses.replace(tllama.MLA_TINY, n_layers=2)
# Llama4's deltas at LLAMA_TINY_64's widths: layer 1 NoPE with its query
# temperature (moving every 8 positions), 16-token attention chunks, the
# L2 q/k norm, the sigmoid-input router
_LLAMA4 = dict(vocab_size=512, hidden_size=128, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=64,
               intermediate_size=256, max_seq_len=256, remat=False, n_experts=4, nope_pattern=2,
               attention_chunk_size=16, attn_temp_floor=8.0)
LLAMA4 = (dataclasses.replace(jllama.LLAMA4_SCOUT, dtype=jnp.float32, **_LLAMA4),
          dataclasses.replace(tllama.LLAMA4_SCOUT, dtype=torch.float32, **_LLAMA4))
CONFIGS = {  # cache kind → (JAX config, port config, kv_quant)
    "f32": (jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64, None),
    "int8": (jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64, "int8"),
    "mla": (*MLA, None),
    "llama4": (*LLAMA4, None),
}
B, T, C = 4, 64, 16  # the function tests' cache and chunk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS: dict = {}


def _params(kind: str) -> tuple:
    """(JAX config, port config, kv_quant, JAX params, port params): the
    JAX weights from seed 0, built once a module."""
    jc, tc, kvq = CONFIGS[kind]
    if jc not in _PARAMS:
        jp = jllama.init_params(jc, jax.random.key(0))
        _PARAMS[jc] = jp, tllama.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return (jc, tc, kvq, *_PARAMS[jc])


def _random_cache(jc, kvq, seed: int) -> tuple:
    """A JAX cache of random values (int8 values and scales too) and the
    port's copy of it: what a chunk leaves alone must stay bitwise."""
    rng = np.random.default_rng(seed)
    cache = {}
    for n, a in jengine.init_cache(jc, B, T, kv_quant=kvq).items():
        x = rng.standard_normal(a.shape)
        cache[n] = (x * 40 if a.dtype == jnp.int8 else x if n not in ("k_s", "v_s") else abs(x) * 0.02)
        cache[n] = np.asarray(cache[n]).astype(a.dtype)
    return ({n: jnp.asarray(a) for n, a in cache.items()},
            {n: torch.from_numpy(a.copy()) for n, a in cache.items()})


_JITS: dict = {}


def _jit(fn, config=None, **static):
    """``jax.jit`` of a JAX function with its config and static keywords
    bound, one a module: the cases of a test share its compiles."""
    key = (fn.__name__, id(config), tuple(sorted(static.items())))
    if key not in _JITS:
        _JITS[key] = jax.jit(partial(fn, **static) if config is None else partial(fn, config=config, **static))
    return _JITS[key]


def _ix(x) -> torch.Tensor:
    return torch.tensor([x], dtype=torch.long)


def _assert_cache(tc: dict, jc: dict, written: dict) -> None:
    """Bitwise outside ``written`` (name → index tuple of the chunk's
    entries), within KV_TOL inside it."""
    assert set(tc) == set(jc)
    for n, want in jc.items():
        got, want = tc[n].numpy(), np.asarray(want)
        mask = np.zeros(got.shape, bool)
        mask[written[n]] = True
        np.testing.assert_array_equal(got[~mask], want[~mask], err_msg=n)
        np.testing.assert_allclose(got[mask].astype(np.float64), want[mask].astype(np.float64),
                                   atol=KV_TOL, rtol=KV_TOL, err_msg=n)


def _chunk_region(name: str, slot: int, start: int, width: int) -> tuple:
    s = min(max(slot, 0), B - 1)
    if name == "ckv":  # [L, B, T, R]
        return (slice(None), s, slice(start, start + width))
    return (slice(None), s, slice(None), slice(start, start + width))  # [L, B, H, T, (D)]


class TestDeviceScalarFunctions:
    @pytest.mark.parametrize("kind", sorted(CONFIGS))
    @pytest.mark.parametrize(
        "slot,last_ix", [(2, 0), (1, 9), (3, C - 1), (7, -1), (1, C)],
        ids=["slot2-first", "slot1-mid", "slot3-last", "clamped-from-end", "past-the-end"])
    def test_prefill_chunk_step(self, kind, slot, last_ix):
        jc, tc, kvq, jp, tp = _params(kind)
        jcache, tcache = _random_cache(jc, kvq, seed=slot)
        toks = np.random.default_rng(11).integers(1, jc.vocab_size, (1, C)).astype(np.int32)
        start = C
        jl, jcache = _jit(jengine.prefill_chunk_step, jc, start=start)(
            jp, jcache, jnp.asarray(toks), jnp.asarray(slot, jnp.int32), jnp.asarray(last_ix, jnp.int32))
        tl, out = tengine.prefill_chunk_step(tp, tcache, torch.from_numpy(toks).long(), _ix(slot),
                                             _ix(last_ix), tc, start=start)
        assert out is tcache  # in place
        # past the end JAX's take_along_axis fills NaN, and so does the port
        assert np.isnan(tl.numpy()).all() == (last_ix == C) == np.isnan(np.asarray(jl)).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_cache(tcache, jcache, {n: _chunk_region(n, slot, start, C) for n in jcache})

    @pytest.mark.parametrize("kind", sorted(CONFIGS))
    def test_prefill_packed_step_with_a_pad_row(self, kind):
        """Three rows at unequal starts in slots 3, 1, 2 (one ends mid
        chunk), and a pad row (``last_ix = -1``, slot 0) that writes
        nothing."""
        jc, tc, kvq, jp, tp = _params(kind)
        jcache, tcache = _random_cache(jc, kvq, seed=5)
        rng = np.random.default_rng(12)
        toks = rng.integers(1, jc.vocab_size, (4, C)).astype(np.int32)
        slots = np.array([3, 1, 2, 0], np.int32)
        starts = np.array([0, 16, 40, 0], np.int32)
        last_ix = np.array([C - 1, 6, C - 1, -1], np.int32)
        jl, jcache = _jit(jengine.prefill_packed_step, jc)(
            jp, jcache, *(jnp.asarray(a) for a in (toks, slots, starts, last_ix)))
        tl, _ = tengine.prefill_packed_step(tp, tcache, *(torch.from_numpy(a).long() for a in
                                                           (toks, slots, starts, last_ix)), tc)
        np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], atol=ATOL, rtol=ATOL)
        written = {}
        for n in jcache:
            m = np.zeros(jcache[n].shape, bool)
            for s, st, li in zip(slots[:3], starts[:3], last_ix[:3]):
                m[_chunk_region(n, int(s), int(st), int(li) + 1)] = True
            written[n] = m
        _assert_cache(tcache, jcache, written)
        assert all(not w[_chunk_region(n, 0, 0, T)].any() for n, w in written.items())

    @pytest.mark.parametrize("kind", sorted(CONFIGS))
    @pytest.mark.parametrize("src,dst", [(2, 0), (0, 3), (1, 1), (9, -4)],
                             ids=["2to0", "0to3", "self", "clamped"])
    def test_copy_cache_prefix(self, kind, src, dst):
        jc, _, kvq, _, _ = _params(kind)
        jcache, tcache = _random_cache(jc, kvq, seed=7)
        p = 2 * C
        jcache = _jit(jengine.copy_cache_prefix, p=p)(
            jcache, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32))
        out = tengine.copy_cache_prefix(tcache, _ix(src), _ix(dst), p=p)
        assert out is tcache
        for n in jcache:
            np.testing.assert_array_equal(tcache[n].numpy(), np.asarray(jcache[n]), err_msg=n)

    @pytest.mark.parametrize("pad,tp", [(16, 5), (16, 16), (64, 33)])
    def test_mark_prompt(self, pad, tp):
        """Ids past ``tp``, at or past V and below -V drop; a negative id
        counts from the end, as JAX's ``.at[]`` takes it."""
        v = 50
        rng = np.random.default_rng(pad + tp)
        counts = rng.integers(0, 4, (B, v)).astype(np.int32)
        gen = rng.integers(0, 4, (B, v)).astype(np.int32)
        padded = rng.integers(-v - 5, v + 5, pad).astype(np.int32)
        padded[:4] = [0, v - 1, -1, v]
        jcounts, jgen = _jit(jengine._mark_prompt)(jnp.asarray(counts), jnp.asarray(gen), 2,
                                                      jnp.asarray(padded), tp)
        tcounts, tgen = torch.from_numpy(counts.copy()), torch.from_numpy(gen.copy())
        tengine._mark_prompt(tcounts, tgen, _ix(2), torch.from_numpy(padded).long(), _ix(tp))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))
        assert tcounts[2].sum() > 0 and not tgen[2].any()


# ---------------------------------------------------------------------------
# no host reads inside a site
# ---------------------------------------------------------------------------

_HOST_READS = {torch.Tensor.item, torch.Tensor.__int__, torch.Tensor.__index__, torch.Tensor.__bool__,
               torch.Tensor.__float__, torch.Tensor.tolist}


def _zero_dim_index(ix) -> bool:
    items = ix if isinstance(ix, tuple) else (ix,)
    return any(isinstance(i, torch.Tensor) and i.dim() == 0 for i in items)


class _NoHostReads(TorchFunctionMode):
    """Raises on every way a tensor's value reaches the host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            raise AssertionError(f"a host read inside a site: Tensor.{func.__name__}")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) and _zero_dim_index(args[1]):
            raise AssertionError("a host read inside a site: an index by a 0-d tensor")
        return func(*args, **(kwargs or {}))


class TestNoHostReads:
    def test_the_mode_catches_each_read(self):
        t = torch.tensor([3])
        for read in (lambda: int(t), lambda: t.item(), lambda: [0, 1, 2, 3][t], lambda: bool(t),
                     lambda: t.tolist(), lambda: float(t), lambda: torch.zeros(5)[t[0]]):
            with pytest.raises(AssertionError, match="host read"), _NoHostReads():
                read()

    @pytest.mark.parametrize("kind", sorted(CONFIGS))
    def test_no_site_reads_its_arguments(self, kind):
        """Each prefill site's function, called as the engine calls it (a
        chunk at a later start, a packed wave with a pad row, a copy and a
        mark of the prompt), runs through under the mode."""
        _, tc, kvq, _, tp = _params(kind)
        e = tengine.InferenceEngine(tc, tp, max_batch=B, max_seq=T, prefill_chunk=C, kv_quant=kvq,
                                    device="cpu")
        toks = torch.randint(1, tc.vocab_size, (4, C))
        with _NoHostReads():
            logits = e._chunk_site_fn(toks[:1], e.slot_index(2), _ix(5), start=C)
            packed = e._packed_site_fn(toks, torch.tensor([3, 1, 2, 0]), torch.tensor([0, 16, 40, 0]),
                                       torch.tensor([C - 1, 6, C - 1, -1]))
            e._copy_site_fn(e.slot_index(2), e.slot_index(0), p=C)
            e._mark_prompt_fn(e.slot_index(1), toks[0], _ix(9))
        assert logits.shape == (1, tc.vocab_size) and packed.shape == (4, tc.vocab_size)
        assert torch.isfinite(logits).all() and torch.isfinite(packed).all()
        assert int(e._seen[1].sum()) == 9


# ---------------------------------------------------------------------------
# the compile accounting against the JAX engine's, both warmed
# ---------------------------------------------------------------------------

ENGINE = dict(max_batch=4, max_seq=1024, prefill_chunk=256, prefill_pack=4, spec_draft=3, turbo_steps=4)
# the decode-side sites the port's warmup visits and JAX's leaves to the
# first request (JAX's warmup runs no plain greedy step, logprobs or
# seeded skip, and verifies only where its random model drafted)
PORT_WARM_EXTRA = {"argmax", "logprobs", "skip_key", "verify"}


@pytest.fixture
def recorders():
    """Fresh flight recorders in both packages (the prior ones put back)
    and JAX's jit caches emptied, so that each engine compiles from
    nothing."""
    jax.clear_caches()
    priors = [(mod, mod.get_recorder()) for mod in (jflight, tflight)]
    recs = jflight.enable(buffer=1024), tflight.enable(buffer=1024)
    yield recs
    for mod, prior in priors:
        if prior is None:
            mod.disable()
        else:
            mod._recorder, mod.record = prior, prior.record


def _requests(vocab: int) -> list:
    """Waves of prompts: 40, 300 and 700 tokens one at a time, a prompt
    sharing 512 tokens with the 700 (a prefix hit), a burst of 3 and a
    burst of 4, each at unequal lengths."""
    rng = np.random.default_rng(21)
    p = lambda n: rng.integers(1, vocab, n).tolist()  # noqa: E731
    long = p(700)
    return [[p(40)], [p(300)], [long], [long[:512] + p(90)], [p(20), p(50), p(33)],
            [p(64), p(260), p(33), p(520)]]


def _serve(eng, gen_cls, waves) -> list:
    """The scheduler's call sequence for each wave → each request's tokens."""
    outs = []
    for prompts in waves:
        slots = {eng.start_request(list(x), gen_cls(max_new_tokens=3)): i for i, x in enumerate(prompts)}
        got = [[] for _ in prompts]
        while eng.prefilling_slots() or any(eng.active[s] for s in slots):
            for s, t in eng.prefill_wave().items():
                got[slots[s]].append(t)
            for s, toks in eng.step().items():
                got[slots[s]].extend(toks)
        for s in slots:
            eng.release(s)
        outs += got
    return outs


def _events(rec) -> list:
    return sorted((e["fn"], e["key"] or "", e.get("recompile", False)) for e in rec.compile_events(1024))


def _families(eng) -> dict:
    eng.update_state_gauges()
    return {name: {labels[0]: v for labels, v in eng.metrics.family(name).items()}
            for name in ("dtpu_serve_compiles_total", "dtpu_serve_recompiles_total",
                         "dtpu_serve_warmup_gap_compiles_total", "dtpu_serve_compile_cache_entries")}


def _site(manifest_key: str) -> str:
    """A manifest key's site name (the key follows it: ``chunk(256, 0)``,
    ``copy512``)."""
    return manifest_key.split("(")[0].rstrip("0123456789")


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_compile_accounting_matches_jax(kind, recorders):
    jc, tc, kvq, jp, tp = _params(kind)
    je = jengine.InferenceEngine(jc, jp, kv_quant=kvq, **ENGINE)
    jserver._warmup_engine(je)
    te = tengine.InferenceEngine(tc, tp, kv_quant=kvq, device="cpu", **ENGINE)
    tserver._warmup_engine(te)
    waves = _requests(jc.vocab_size)
    assert _serve(te, tengine.GenParams, waves) == _serve(je, jengine.GenParams, waves)  # greedy
    jrec, trec = recorders
    jm, tm = je.compile_manifest(), te.compile_manifest()
    jev, tev = _events(jrec), _events(trec)
    jf, tf = _families(je), _families(te)
    # the prefill sites: the same manifest, the same compile events by
    # key (before and after the warm mark) and the same series
    prefill = lambda keys: {k for k in keys if _site(k) in PREFILL_SITES}  # noqa: E731
    assert prefill(tm) == prefill(jm)
    assert [ev for ev in tev if ev[0] in PREFILL_SITES] == [ev for ev in jev if ev[0] in PREFILL_SITES]
    for name in jf:
        assert ({fn: v for fn, v in tf[name].items() if fn in PREFILL_SITES}
                == {fn: v for fn, v in jf[name].items() if fn in PREFILL_SITES}), name
    # the keys JAX's grid leaves cold: a short prompt's chunk bucket, every
    # later chunk start, a small wave bucket; longer prompts' mark_prompt
    # lengths recompile without a gap (its variants carry no key)
    cold = sorted(ev[:2] for ev in tev if ev[2] and ev[0] in PREFILL_SITES)
    assert [k for fn, k in cold if fn != "mark_prompt"] == [
        "(256, 256)", "(256, 512)", "(64, 0)", "(4, 64)"]
    gaps = tf["dtpu_serve_warmup_gap_compiles_total"]
    assert {fn: gaps[fn] for fn in gaps if fn in PREFILL_SITES} == {"chunk": 3, "packed": 1}
    assert tf["dtpu_serve_recompiles_total"]["mark_prompt"] == 4  # pads 32, 64, 512 and 1024
    # the decode side: the port's warmup visits all JAX's does and a few
    # sites more, so that the port compiles nothing there after the mark,
    # and JAX's post-mark compiles are of keys the port's warmup visited
    assert jm <= tm and {_site(m) for m in tm - jm} <= PORT_WARM_EXTRA
    assert not [ev for ev in tev if ev[2] and ev[0] not in PREFILL_SITES]
    assert {fn + k for fn, k, late in jev if late and fn not in PREFILL_SITES} <= tm
