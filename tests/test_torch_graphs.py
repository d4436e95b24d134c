"""The port's compiled step sites (``serve/graphs.py``), their compile
accounting (``obs/flight.py``, ``obs/boot.py``) and the batched draw of
its sampler, against the JAX engine with its flight recorder enabled.

On the CPU the sites run eagerly, and count a compile on each variant's
first call, as ``jax.jit``'s cache grows. Held here:

- the port's set of compiled (site, key) pairs, and its count a site,
  equal the JAX engine's over the same mixed pass (greedy, sampled,
  seeded with penalties and with a skip, logit bias, logprobs, a packed
  burst, a verify, and every power-of-two turbo ``steps``), on both
  caches; ``compile_manifest()`` equals the observed compiles; a second
  pass after ``mark_flight_warm()`` compiles nothing, and
  ``recompiles_total`` and ``warmup_gap_compiles_total`` stay empty; a key
  first reached after the warm mark counts one gap, in both engines;
- the server's warmup visits the turbo keys {1, 2, 4} at ``turbo_steps=4``
  and every variant real traffic reaches;
- the cache and every fixed buffer the graphs read keep their
  ``data_ptr()`` across every engine path, and a chained turbo (depth 2)
  emits what depth 1 does;
- the batched draw equals a numpy implementation of the same hash bit
  for bit, and its greedy and filtered rows agree with JAX's ``sample``;
- a site's replay credits the launch counts its capture recorded, copies
  its non-fixed arguments, refuses a fixed one that moved, and a failed
  capture raises (a stand-in graph, on the CPU).

``TestGraphsOnTheCard`` (marked ``cuda``, skipped without a card) holds
the graph engine against the eager one (``graphs=False``) on tiny llama
(both caches), gpt-oss (sinks), Gemma (head_dim 256) and MLA, over the
mixed pass and site by site on the prefill side: a chunk, a packed wave,
a copy and mark_prompt captured at one slot and replayed at others.
The prefill sites against JAX's are in ``tests/test_torch_prefill_graphs.py``.
"""

import ast
import contextlib
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.obs import flight as jflight
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.obs import boot as tboot
from dstack_tpu_torch.obs import flight as tflight
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.ops import flash_decode as tflash_decode
from dstack_tpu_torch.serve import engine as tengine
from dstack_tpu_torch.serve import graphs as tgraphs
from dstack_tpu_torch.serve import openai_server as tserver

JC, TC = jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64
DECODE_SITES = ("decode", "verify", "sample", "argmax", "advance_state", "logprobs", "mark_seen",
                "skip_key", "turbo")
PREFILL_SITES = ("chunk", "packed", "copy", "mark_prompt")
SITES = DECODE_SITES + PREFILL_SITES
ENGINE = dict(max_batch=4, max_seq=128, prefill_chunk=16, prefill_pack=4, spec_draft=3,
              turbo_steps=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JC, jax.random.key(0))
    tp = tllama.params_from_jax(jax.tree.map(np.asarray, jp), TC, device="cpu")
    return jp, tp


@pytest.fixture
def recorders():
    """Fresh flight recorders in both packages, the prior ones put back,
    and JAX's compile caches emptied: ``jax.jit`` of one function shares
    its cache across engines, so a second engine in this process would
    otherwise compile nothing that the first had."""
    jax.clear_caches()
    priors = [(mod, mod.get_recorder()) for mod in (jflight, tflight)]
    recs = jflight.enable(buffer=512), tflight.enable(buffer=512)
    yield recs
    for mod, prior in priors:
        if prior is None:
            mod.disable()
        else:
            mod._recorder, mod.record = prior, prior.record


def _engines(weights, **kw):
    jp, tp = weights
    kw = {**ENGINE, **kw}
    return (jengine.InferenceEngine(JC, jp, **kw),
            tengine.InferenceEngine(TC, tp, device="cpu", **kw))


def _drive_packed(eng, prompts, gens):
    """Admit every prompt, drive prefill waves and steps to the end (the
    JAX engine tests' ``_drive_packed``) → per-request tokens."""
    slots, outs = {}, [[] for _ in prompts]
    for i, (p, g) in enumerate(zip(prompts, gens)):
        slots[eng.start_request(p, g)] = i
    while eng.prefilling_slots() or any(eng.active[s] for s in slots):
        for s, t in eng.prefill_wave().items():
            outs[slots[s]].append(t)
        for s, toks in eng.step().items():
            outs[slots[s]].extend(toks)
    for s in slots:
        eng.release(s)
    return outs


def _mixed_pass(eng, gen_cls) -> list:
    """JAX's ``TestSteadyStateRecompiles._mixed_pass`` (greedy serial at
    two buckets, sampled, seeded with a penalty, logit bias, a packed
    burst with a prefix hit), plus a seeded request with a skip, one with
    logprobs, repetitive prompts (drafts fire: verify; the waves of
    ``test_torch_serve_breadth.py``) and budgets that reach every
    power-of-two turbo ``steps``."""
    gen = lambda n=3, **kw: gen_cls(max_new_tokens=n, **kw)  # noqa: E731
    outs = [
        eng.generate(list(range(3, 20)), gen()),
        eng.generate(list(range(40, 80)) + [1], gen()),
        eng.generate([5, 9, 21, 7], gen(temperature=0.8, seed=3)),
        eng.generate([5, 9, 21, 7, 3], gen(temperature=0.9, seed=5, repetition_penalty=1.2)),
        eng.generate([5, 9, 21], gen(logit_bias={"7": 2.0})),
        eng.generate([5, 9, 21, 8], gen(temperature=0.9, seed=5, seed_skip=2)),
        eng.generate([6, 9, 21], gen(logprobs=2)),
        eng.generate(([5, 9, 13, 17] * 12)[:40], gen(24)),
        eng.generate([7] * 40, gen(24)),
        eng.generate(list(range(30, 50)), gen(6)),  # turbo steps 4, then 1
    ]
    outs += _drive_packed(
        eng, [list(range(40, 80)) + [9, 2], list(range(60, 95)), [4, 4]], [gen() for _ in range(3)],
    )
    return outs


def _compiled(rec) -> list:
    """(site, key) of each compile event of this slice's sites."""
    return sorted((e["fn"], e["key"] or "") for e in rec.compile_events(512) if e["fn"] in SITES)


def _series(eng, name: str) -> dict:
    return {labels[0]: v for labels, v in eng.metrics.family(name).items()}


class TestCompileAccounting:
    @pytest.mark.parametrize("kv_quant", [None, "int8"])
    def test_compile_accounting_lands_in_engine_registry(self, weights, recorders, kv_quant):
        """The same compiled (site, key) events as the JAX engine's, event
        for event, in its registry's families and its ring."""
        je, te = _engines(weights, kv_quant=kv_quant)
        jouts, touts = _mixed_pass(je, jengine.GenParams), _mixed_pass(te, tengine.GenParams)
        greedy = [0, 1, 4, 6, 7, 8, 9, 10, 11, 12]  # the sampled streams differ by design
        assert [touts[i] for i in greedy] == [jouts[i] for i in greedy]
        jrec, trec = recorders
        assert _compiled(trec) == _compiled(jrec)
        assert {fn for fn, _ in _compiled(trec)} == set(SITES)
        assert sorted(k for fn, k in _compiled(trec) if fn == "turbo") == ["1", "2", "4"]
        jc = {fn: n for fn, n in _series(je, "dtpu_serve_compiles_total").items() if fn in SITES}
        assert _series(te, "dtpu_serve_compiles_total") == jc
        seconds = te.metrics.family("dtpu_serve_compile_seconds")
        assert {fn: seconds.count(fn) for fn in SITES} == jc
        compiles = [r for r in trec.records(512) if r["phase"] == "compile"]
        assert [(r["fn"], r.get("key", "")) for r in compiles] == [
            (e["fn"], e["key"] or "") for e in trec.compile_events(512)
        ]
        je.update_state_gauges()
        te.update_state_gauges()
        gauge = lambda e: e.metrics.family("dtpu_serve_compile_cache_entries").value("turbo")  # noqa: E731
        assert gauge(te) == gauge(je) == len(te._turbo_sites) == 3

    def test_second_pass_compiles_nothing(self, weights, recorders):
        _, te = _engines(weights)
        _, trec = recorders
        _mixed_pass(te, tengine.GenParams)
        first = _series(te, "dtpu_serve_compiles_total")
        observed = {e["fn"] + (e["key"] or "") for e in trec.compile_events(512)}
        assert te.compile_manifest() == observed
        assert observed == {tboot.manifest_key(fn, k) for fn, k in
                            ((e["fn"], None if e["key"] is None else ast.literal_eval(e["key"]))
                             for e in trec.compile_events(512))}
        te.mark_flight_warm()
        assert te.flight_warm
        _mixed_pass(te, tengine.GenParams)
        assert _series(te, "dtpu_serve_compiles_total") == first
        assert te.metrics.family("dtpu_serve_recompiles_total").items() == []
        assert te.metrics.family("dtpu_serve_warmup_gap_compiles_total").items() == []
        assert not any(r["phase"] == "recompile" for r in trec.records(512))

    def test_a_key_first_reached_after_the_warm_mark_is_one_gap(self, weights, recorders):
        """Warm on a budget that reaches turbo keys 4 and 1 only; a budget
        of 2 then compiles turbo(2): one recompile and one gap, in both
        engines; the manifest stays frozen."""
        engines = _engines(weights)
        for eng, gen_cls in zip(engines, (jengine.GenParams, tengine.GenParams)):
            eng.generate([5, 9, 21, 7], gen_cls(max_new_tokens=6))
            manifest = eng.compile_manifest()
            assert {"turbo4", "turbo1"} <= manifest and "turbo2" not in manifest
            eng.mark_flight_warm()
            eng.generate([5, 9, 21, 8], gen_cls(max_new_tokens=3))
            assert _series(eng, "dtpu_serve_warmup_gap_compiles_total") == {"turbo": 1}
            assert _series(eng, "dtpu_serve_recompiles_total") == {"turbo": 1}
            assert eng.compile_manifest() == manifest
            diff = tboot.manifest_diff(manifest, manifest | {"turbo2"})
            assert diff == {"covered": sorted(manifest), "gaps": ["turbo2"]}

    def test_disabled_recorder_wraps_nothing(self, weights, recorders):
        tflight.disable()
        assert tflight.record is tflight._noop_record
        _, te = _engines(weights)
        assert isinstance(te._decode, tgraphs.GraphSite)
        te.generate([5, 9, 21, 7], tengine.GenParams(max_new_tokens=6))
        assert te.compile_manifest() == set()
        assert te.metrics.family("dtpu_serve_compiles_total").items() == []
        assert tflight.enable(buffer=16).records(10) == []


class TestWarmup:
    def test_warmup_visits_every_key_traffic_reaches(self, weights, recorders):
        """Every decode-side key the traffic reaches, and on the prefill
        side JAX's grid (``tests/test_torch_prefill_graphs.py`` holds the
        prefill keys it leaves cold to JAX's counts): the traffic compiles
        no decode-side variant, and each prefill key it compiles is one
        the warmup never visited."""
        _, te = _engines(weights)
        seconds = tserver._warmup_engine(te)
        assert seconds > 0 and te.flight_warm and te.free_slots() == [0, 1, 2, 3]
        assert sorted(te._turbo_sites) == [1, 2, 4]
        manifest = te.compile_manifest()
        assert {re.match(r"[a-z_]+", m).group() for m in manifest} == set(SITES)
        assert {m for m in manifest if not m.startswith(DECODE_SITES)} == {
            "chunk(16, 0)", "packed(2, 16)", "packed(4, 16)", "mark_prompt",
            *(f"copy{p}" for p in range(16, 128, 16))}
        compiles = _series(te, "dtpu_serve_compiles_total")
        _mixed_pass(te, tengine.GenParams)
        after = _series(te, "dtpu_serve_compiles_total")
        assert {fn: after[fn] for fn in DECODE_SITES} == {fn: compiles[fn] for fn in DECODE_SITES}
        recompiles = _series(te, "dtpu_serve_recompiles_total")
        gaps = _series(te, "dtpu_serve_warmup_gap_compiles_total")
        assert set(recompiles) <= set(PREFILL_SITES) and recompiles["chunk"] > 0
        assert {fn: after[fn] - compiles[fn] for fn in PREFILL_SITES if after[fn] > compiles[fn]} == recompiles
        # a new key is a gap; a new variant of mark_prompt (no key) is not
        assert gaps == {fn: n for fn, n in recompiles.items() if fn != "mark_prompt"}


class TestFixedBuffers:
    def _ptrs(self, e) -> dict:
        bufs = {f"cache_{k}": v for k, v in e.cache.items()}
        bufs.update({f"state{i}": t for i, t in enumerate(e._state)})
        bufs.update({f"sampling{i}": t for i, t in enumerate(e._sampling)})
        bufs.update(key_data=e._key_data, seen=e._seen, gen_counts=e._gen_counts,
                    logit_bias=e._logit_bias, slot_iota=e._slot_iota)
        return {k: t.data_ptr() for k, t in bufs.items()}

    @pytest.mark.parametrize("kv_quant", [None, "int8"])
    def test_every_path_keeps_the_storage(self, weights, kv_quant):
        _, tp = weights
        e = tengine.InferenceEngine(TC, tp, device="cpu", turbo_depth=2, turbo_quiet_s=0.0,
                                    kv_quant=kv_quant, **ENGINE)
        before = self._ptrs(e)
        _mixed_pass(e, tengine.GenParams)
        e.generate(list(range(10, 30)), tengine.GenParams(max_new_tokens=20))  # turbo depth 2
        assert e.stats["turbo_device_steps"] > 4 * e.stats["turbo_dispatches"]
        e.turbo_steps = 0
        e.generate([1, 2, 3], tengine.GenParams(max_new_tokens=4))  # plain greedy
        e.forget_requests()
        tserver._warmup_engine(e)
        assert self._ptrs(e) == before
        assert all(e.stats[k] for k in ("decode_steps", "spec_steps", "turbo_dispatches",
                                         "packed_dispatches", "prefix_hits"))

    def test_chained_turbo_emits_what_one_segment_does(self, weights):
        _, tp = weights
        outs = []
        for depth in (1, 2):
            e = tengine.InferenceEngine(TC, tp, device="cpu", turbo_depth=depth, turbo_quiet_s=0.0,
                                        **{**ENGINE, "spec_draft": 0})
            outs.append(e.generate(list(range(10, 30)), tengine.GenParams(max_new_tokens=30)))
            assert (e.stats["turbo_device_steps"] > 4 * e.stats["turbo_dispatches"]) == (depth == 2)
        assert outs[0] == outs[1] and len(outs[0]) == 30


# ---------------------------------------------------------------------------
# the batched draw
# ---------------------------------------------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def _np_fmix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & M32
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(0xC2B2AE35)) & M32
    return x ^ (x >> np.uint64(16))


def _np_draw_bits(kd: np.ndarray, v: int) -> np.ndarray:
    """The hash of ``engine.draw_bits`` in numpy's unsigned 64-bit
    arithmetic (the int64 key data reinterpreted)."""
    u = kd.astype(np.int64).view(np.uint64)
    seed, ctr = u[:, 0], u[:, 1]
    k = _np_fmix32((ctr >> np.uint64(32)) ^ np.uint64(0x9E3779B9))
    k = _np_fmix32(k ^ (ctr & M32))
    k = _np_fmix32(k ^ (seed >> np.uint64(32)))
    k1 = _np_fmix32(k ^ (seed & M32))[:, None]
    k2 = _np_fmix32(k1 ^ np.uint64(0x7F4A7C15))
    ix = np.arange(v, dtype=np.uint64)[None, :]
    return _np_fmix32(_np_fmix32(ix ^ k1) ^ k2)


KEYS = np.array([[0, 0], [7, 0], [7, 1], [7, 2**40 + 3], [-1, 5], [2**63 - 1, 2**33],
                 [-(2**63), 9], [123456789, 987654321]], np.int64)


class TestBatchedDraw:
    def test_bits_equal_the_numpy_hash(self):
        v = 3001
        got = tengine.draw_bits(torch.from_numpy(KEYS), v).numpy()
        want = _np_draw_bits(KEYS, v)
        assert got.dtype == np.int64 and (got >= 0).all() and (got < 2**32).all()
        np.testing.assert_array_equal(got.astype(np.uint64), want)
        # the uniform is exact in f32; the noise is -log(-log(u))
        u_want = (((want >> np.uint64(9)).astype(np.float64) + 0.5) * 2.0**-23).astype(np.float32)
        u_got = ((tengine.draw_bits(torch.from_numpy(KEYS), v) >> 9).float() + 0.5) * 2.0**-23
        np.testing.assert_array_equal(u_got.numpy(), u_want)
        g = tengine.gumbel_noise(torch.from_numpy(KEYS), v).numpy()
        np.testing.assert_allclose(g, -np.log(-np.log(u_want.astype(np.float64))), rtol=1e-5, atol=1e-6)

    def test_rows_are_independent_deterministic_and_uniform(self):
        v = 4096
        bits = tengine.draw_bits(torch.from_numpy(KEYS), v)
        assert torch.equal(bits, tengine.draw_bits(torch.from_numpy(KEYS), v))
        # a row's draw depends on its own key alone
        assert torch.equal(bits[3], tengine.draw_bits(torch.from_numpy(KEYS[3:4]), v)[0])
        # each row is a permutation of distinct values; rows differ
        assert all(len(set(r.tolist())) == v for r in bits)
        assert len({tuple(r[:8].tolist()) for r in bits}) == len(KEYS)
        u = ((bits >> 9).double() + 0.5) / 2**23
        assert abs(float(u.mean()) - 0.5) < 0.01
        hist = torch.histc(u.float(), bins=8, min=0.0, max=1.0) / u.numel()
        assert float((hist - 0.125).abs().max()) < 0.01

    def test_skip_key_is_the_counter_offset(self):
        kd = torch.tensor([7, 2], dtype=torch.int64)
        skipped = tengine.skip_key_data(kd, torch.tensor(5))
        assert skipped.tolist() == [7, 7]
        assert torch.equal(tengine.draw_bits(skipped[None], 64),
                           tengine.draw_bits(torch.tensor([[7, 7]]), 64))

    def test_greedy_and_filtered_rows_match_jax_sample(self):
        """Key data in place of generators: greedy rows with penalties
        and bias, sampled rows that top_k = 1 or top_p = 1e-6 make
        deterministic: 0 of 1,200 tokens differ from JAX's ``sample``."""
        b, v = 6, 300
        temperature = np.array([0.0, 0.0, 0.8, 1.0, 0.7, 1.2], np.float32)
        top_k = np.array([0, 0, 1, 0, 1, 0], np.int32)
        top_p = np.array([1.0, 1.0, 1.0, 1e-6, 0.9, 1e-6], np.float32)
        rep = np.array([1.3, 1.0, 1.0, 1.0, 1.2, 0.8], np.float32)
        pres = np.array([0.5, 0.0, 0.3, 0.0, 0.4, 0.0], np.float32)
        freq = np.array([0.3, 0.0, 0.0, 0.2, 0.1, 0.0], np.float32)
        min_p = np.array([0.0, 0.0, 0.0, 0.0, 0.1, 0.05], np.float32)
        jsample = jax.jit(jengine.sample)
        jkd = np.asarray(jax.vmap(lambda s: jax.random.key_data(jax.random.key(s)))(jax.numpy.arange(b)))
        tkd = torch.stack([torch.arange(b), torch.zeros(b, dtype=torch.int64)], dim=1)
        rng = np.random.default_rng(5)
        differ = 0
        for _ in range(200):
            logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
            counts = rng.integers(0, 3, (b, v)).astype(np.int32)
            gen_counts = np.minimum(counts, rng.integers(0, 2, (b, v))).astype(np.int32)
            bias = np.zeros((b, v), np.float32)
            bias[[0, 1, 5], rng.integers(0, v, 3)] = 5.0
            args = (temperature, top_p, top_k, rep, counts, pres, freq, gen_counts, bias, min_p)
            jt, jkd = jsample(jax.numpy.asarray(logits), jkd, *map(jax.numpy.asarray, args))
            targs = [torch.from_numpy(a) for a in args]
            targs[2] = targs[2].long()
            tt = tengine.sample(torch.from_numpy(logits), tkd, *targs)
            tkd[:, 1] += 1
            differ += int((tt.numpy() != np.asarray(jt)).sum())
        assert differ == 0


# ---------------------------------------------------------------------------
# the site's mechanics, with a stand-in graph
# ---------------------------------------------------------------------------


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StandInSet(tgraphs.GraphSet):
    """The capture's mechanics without a card: no side stream, a graph
    that counts its replays, a recording that runs the function (as the
    wrappers then bump their counters) or raises."""

    fail = False

    def side(self):
        return contextlib.nullcontext()

    def new_graph(self):
        return _StandInGraph()

    @contextlib.contextmanager
    def recording(self, graph):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        yield


def _launching(x):
    """Stands in for a step whose wrappers launch K4 once and K1 twice."""
    tflash_decode.LAUNCHES += 1
    tflash_decode.LAUNCHES_BY_VARIANT["int8_verify"] += 1
    tflash.LAUNCHES += 2
    return x * 2, x.sum()


class TestSiteMechanics:
    @pytest.fixture(autouse=True)
    def _restore_launch_counts(self):
        """``_launching`` fakes launches on the module-wide counters: put
        them back, so that a later test in this process (the server's
        ``/health`` reads them) counts only its own."""
        saved = tflash_decode.LAUNCHES, dict(tflash_decode.LAUNCHES_BY_VARIANT), tflash.LAUNCHES
        yield
        tflash_decode.LAUNCHES, tflash.LAUNCHES = saved[0], saved[2]
        tflash_decode.LAUNCHES_BY_VARIANT.update(saved[1])

    def test_replay_credits_the_captured_launches(self):
        gs = _StandInSet("cpu", capture=True)
        site = gs.site("verify", _launching)
        x = torch.arange(4.0)
        c0 = tgraphs.launch_counts()
        out = site(x)  # the eager call launches once; the capture is put back
        delta = lambda: {k: v - c0[k] for k, v in tgraphs.launch_counts().items() if v != c0[k]}  # noqa: E731
        assert delta() == {"flash_decode": 1, "flash_decode_int8_verify": 1, "flash_fwd": 2}
        (g,) = site.entries[((((4,), torch.float32),))].values()
        assert g.launches == {**{k: 0 for k in c0}, "flash_decode": 1,
                              "flash_decode_int8_verify": 1, "flash_fwd": 2}
        assert torch.equal(out[0], x * 2) and gs.is_fixed(out[0]) and gs.is_fixed(out[1])
        for _ in range(3):
            assert site(x) is out  # the graph's own outputs
        assert g.graph.replays == 3
        assert delta() == {"flash_decode": 4, "flash_decode_int8_verify": 4, "flash_fwd": 8}
        assert site._cache_size() == 1
        site(torch.arange(6.0))  # another variant: another capture
        assert site._cache_size() == 2
        assert gs.report()["verify"]["captures"] == 2

    def test_arguments_copy_unless_fixed(self):
        """A varying argument is copied into the graph's own buffer; a
        fixed one is read in place, and another fixed tensor of the same
        variant is another capture, not another compile."""
        gs = _StandInSet("cpu", capture=True)
        fixed, other = torch.ones(3), torch.full((3,), 2.0)
        gs.fix(fixed, other)
        site = gs.site("advance_state", lambda a, b: a + b)
        varying = torch.zeros(3)
        site(varying, fixed)
        (g,) = next(iter(site.entries.values())).values()
        assert g.inputs[1] is fixed and g.inputs[0] is not varying
        site(torch.full((3,), 7.0), fixed)
        assert g.inputs[0].tolist() == [7.0] * 3 and g.graph.replays == 1
        assert torch.equal(site(varying, other), varying + other)  # a second capture's eager call
        assert site._cache_size() == 1
        assert gs.report()["advance_state"]["captures"] == 2
        site(varying, other)
        bound = next(iter(site.entries.values()))
        assert [x.graph.replays for x in bound.values()] == [1, 1]

    def test_a_failed_capture_raises(self):
        gs = _StandInSet("cpu", capture=True)
        gs.fail = True
        site = gs.site("turbo", _launching, key=8)
        c0 = tgraphs.launch_counts()
        with pytest.raises(RuntimeError, match="capture of site 'turbo' key 8 failed"):
            site(torch.ones(2))
        assert site._cache_size() == 0
        c1 = tgraphs.launch_counts()
        assert c1["flash_decode"] == c0["flash_decode"] + 1  # the eager call only

    def test_the_cpu_runs_eagerly(self):
        gs = tgraphs.GraphSet("cpu", capture=False)
        calls = []
        site = gs.site("argmax", lambda x: calls.append(1) or x.argmax(-1))
        for _ in range(3):
            site(torch.tensor([[1.0, 3.0]]))
        assert len(calls) == 3 and site._cache_size() == 1
        assert gs.report() == {"argmax": {"entries": 1, "captures": 0, "capture_s": 0.0}}


# ---------------------------------------------------------------------------
# on the card: the graph engine against the eager engine
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the hand-written kernels run only on the card")
    return torch.device("cuda")


def _card_config(name: str) -> tllama.LlamaConfig:
    tiny = dict(vocab_size=512, max_seq_len=256, remat=False, dtype=torch.bfloat16)
    if name == "llama":
        return dataclasses.replace(TC, **tiny)
    if name == "gpt-oss":
        return dataclasses.replace(tllama.GPT_OSS_20B, hidden_size=256, n_layers=4, n_heads=8,
                                   n_kv_heads=2, head_dim=64, intermediate_size=256, n_experts=4,
                                   experts_per_token=2, sliding_window=32, **tiny)
    if name == "gemma":
        return dataclasses.replace(tllama.GEMMA3_4B, hidden_size=128, n_heads=4, n_kv_heads=2,
                                   head_dim=256, intermediate_size=256, n_layers=4, sliding_window=24,
                                   sliding_pattern=3, **tiny)
    # K1's MLA form takes D = 576 (rank 512 + rope 64) and H dividing 16
    return dataclasses.replace(tllama.MLA_TINY, kv_lora_rank=512, qk_rope_head_dim=64, **tiny)


@pytest.mark.cuda
class TestGraphsOnTheCard:
    def _run(self, c, params, graphs: bool, kv_quant):
        """One engine's tokens, every plain decode's and verify's logits,
        and its K4 launches by variant over a mixed pass."""
        e = tengine.InferenceEngine(c, params, max_batch=4, max_seq=256, prefill_chunk=32,
                                    spec_draft=3, turbo_steps=4, kv_quant=kv_quant, graphs=graphs,
                                    device="cuda")
        logits = []
        for name in ("_decode", "_verify"):
            site = getattr(e, name)
            setattr(e, name, lambda *a, site=site: logits.append(site(*a).clone()) or logits[-1])
        before = dict(tflash_decode.LAUNCHES_BY_VARIANT)
        outs = _mixed_pass(e, tengine.GenParams)
        launches = {k: v - before[k] for k, v in tflash_decode.LAUNCHES_BY_VARIANT.items()}
        return e, outs, logits, launches

    @pytest.mark.parametrize("name,kv_quant", [("llama", None), ("llama", "int8"), ("gpt-oss", None),
                                               ("gemma", None), ("mla", None)])
    def test_graphs_match_the_eager_engine(self, cuda, name, kv_quant):
        c = _card_config(name)
        params = tllama.init_params(c, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        if c.attn_sinks:
            params["layers"]["sinks"].normal_(generator=torch.Generator(device=cuda).manual_seed(1))
        ge, gouts, glogits, glaunch = self._run(c, params, True, kv_quant)
        ee, eouts, elogits, elaunch = self._run(c, params, False, kv_quant)
        assert ge.graphs.capture and not ee.graphs.capture
        assert gouts == eouts  # the seeded streams too: the same draws
        assert len(glogits) == len(elogits) > 0
        for g, e in zip(glogits, elogits):
            assert torch.equal(g, e)  # bitwise: the same kernels on the same inputs
        assert glaunch == elaunch
        assert (sum(glaunch.values()) > 0) == (not c.mla)
        report = ge.graphs.report()
        assert set(report) == set(SITES) and all(r["capture_s"] > 0 for r in report.values())
        assert report["advance_state"] == {**report["advance_state"], "entries": 1, "captures": 2}

    @pytest.mark.parametrize("name,kv_quant", [("llama", None), ("llama", "int8"), ("gpt-oss", None),
                                               ("gemma", None), ("mla", None)])
    def test_prefill_sites_replay_at_other_slots(self, cuda, name, kv_quant):
        """Each prefill site captured on its first call at one slot and
        replayed at others (the chunk at (32, 0) and (32, 32), a packed
        wave with a pad row, a prefix copy, mark_prompt) against the same
        calls on the eager engine: bitwise logits, cache and counts, and
        K1's launches by form."""
        c = _card_config(name)
        params = tllama.init_params(c, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        if c.attn_sinks:
            params["layers"]["sinks"].normal_(generator=torch.Generator(device=cuda).manual_seed(1))
        toks = torch.randint(1, c.vocab_size, (8, 32), generator=torch.Generator(device=cuda).manual_seed(3),
                             device=cuda)
        ix = lambda *v: torch.tensor(v, dtype=torch.long, device=cuda)  # noqa: E731
        runs = {}
        for graphs in (True, False):
            e = tengine.InferenceEngine(c, params, max_batch=4, max_seq=256, prefill_chunk=32,
                                        kv_quant=kv_quant, graphs=graphs, device="cuda")
            before = tgraphs.launch_counts()
            logits = []
            for slot, row, last in ((1, 0, 31), (3, 1, 7), (0, 2, 31), (2, 3, 0)):
                logits.append(e._chunk_fn(32, 0)(toks[row : row + 1], e.slot_index(slot), ix(last)).clone())
            for slot, row in ((3, 4), (1, 5)):
                logits.append(e._chunk_fn(32, 32)(toks[row : row + 1], e.slot_index(slot), ix(31)).clone())
            for slots, starts, last in (((2, 0, 1, 0), (64, 64, 32, 0), (31, 10, 31, -1)),
                                        ((0, 3, 2, 1), (96, 64, 96, 40), (5, 31, 31, 20))):
                logits.append(e._packed_fn(4, 32)(toks[4:], ix(*slots), ix(*starts), ix(*last)).clone())
            for src, dst in ((3, 0), (1, 2)):
                e.get_copy_fn(64)(e.slot_index(src), e.slot_index(dst))
            for slot, row, tp in ((2, 6, 20), (0, 7, 32)):
                e._mark_prompt(e.slot_index(slot), toks[row], ix(tp))
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in tgraphs.launch_counts().items()}
            runs[graphs] = e, logits, launches
        (ge, glog, glaunch), (ee, elog, elaunch) = runs[True], runs[False]
        assert all(torch.equal(g, x) for g, x in zip(glog, elog)) and len(glog) == 8
        assert all(torch.equal(ge.cache[n], ee.cache[n]) for n in ee.cache)
        assert torch.equal(ge._seen, ee._seen) and torch.equal(ge._gen_counts, ee._gen_counts)
        assert glaunch == elaunch
        k1 = "flash_fwd_mla" if c.mla else "flash_fwd"
        assert glaunch[k1] == 6 * c.n_layers  # the chunks; a packed wave takes the masked attention
        report = ge.graphs.report()
        assert {k: report[k]["captures"] for k in PREFILL_SITES} == {"chunk": 2, "packed": 1, "copy": 1,
                                                                    "mark_prompt": 1}

    def test_chained_turbo_replays_feed_each_other(self, cuda):
        """``turbo_depth`` 2 replays one graph twice a call, the second
        from the state the first advanced: the tokens of the eager engine
        at depth 1."""
        c = _card_config("llama")
        params = tllama.init_params(c, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        outs = []
        for graphs, depth in ((True, 2), (False, 1)):
            e = tengine.InferenceEngine(c, params, max_batch=4, max_seq=256, prefill_chunk=32,
                                        spec_draft=0, turbo_steps=4, turbo_depth=depth,
                                        turbo_quiet_s=0.0, graphs=graphs, device="cuda")
            outs.append(e.generate(list(range(10, 30)), tengine.GenParams(max_new_tokens=30)))
            chained = e.stats["turbo_device_steps"] > 4 * e.stats["turbo_dispatches"]
            assert chained == (depth == 2)
        assert outs[0] == outs[1] and len(outs[0]) == 30

    def test_a_failed_capture_raises(self, cuda):
        gs = tgraphs.GraphSet(cuda, capture=True)
        site = gs.site("argmax", lambda x: x.argmax(-1) + int(x.sum().item() > 0))
        with pytest.raises(RuntimeError, match="capture of site 'argmax' key None failed"):
            site(torch.ones(4, 8, device=cuda))
        assert site._cache_size() == 0
