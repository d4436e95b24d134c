"""The port's telemetry against the JAX package's on the CPU.

- ``dstack_tpu_torch.obs``: the same operations on JAX's ``Registry`` and
  the port's copy give byte-identical ``render()`` text, equal values,
  quantiles (exact over the sample window, and bucket-interpolated once
  the window is off), exemplars, ``max_series`` truncation and
  ``escape_label`` output.
- ``serve/metrics.py``: ``new_serve_registry()`` has JAX's families with
  the same types, help texts, label names and buckets.
- The engines: the JAX engine and the port's (tiny llama, the JAX weights
  through ``params_from_jax``) take the scheduler's call sequence of
  ``tests/test_torch_serve_breadth.py`` wave by wave on both caches; after
  each wave every counter, every histogram's count, the pack rows' bucket
  counts and the gauges after ``update_state_gauges()`` are equal, and the
  port's ``stats`` seconds sum to its step histogram's sum. The compile
  families (both flight recorders on, JAX's jit caches emptied first)
  count the same compiles, the prefill sites' and the decode sites'.
  Left out are only the device-memory gauges, absent on the CPU in the
  port (JAX sets them only where its flight recorder runs).
- The lifecycle families (``LIFECYCLE_FAMILIES``: watchdog aborts,
  expired deadlines, resumed requests, post-mortems): both servers'
  schedulers over both engines take one scenario that aborts a wedged
  slot, expires a deadline in decode and resumes a stream; then every
  family of the two engines' registries is equal, these four non-zero.
- ``obs/flight.py``: the same compile events noted by JAX's recorder and
  the port's render the compile families byte-identically.
- ``train/step.py``: ``make_step_callback`` gives JAX's registry values
  for the same step times and peak, and ``finetune --profile-dir`` writes
  a trace.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu import faults as jfaults
from dstack_tpu import obs as jobs
from dstack_tpu import qos as jqos
from dstack_tpu.obs import flight as jflight
from dstack_tpu.models import llama as jllama
from dstack_tpu.serve import engine as jengine
from dstack_tpu.serve import openai_server as jserver
from dstack_tpu.serve.metrics import new_serve_registry as jax_serve_registry
from dstack_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from dstack_tpu.train import step as jstep
from dstack_tpu_torch import faults as tfaults
from dstack_tpu_torch import obs as tobs
from dstack_tpu_torch import qos as tqos
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.serve import engine as tengine
from dstack_tpu_torch.obs import flight as tflight
from dstack_tpu_torch.serve import openai_server as tserver
from dstack_tpu_torch.serve.metrics import new_serve_registry as port_serve_registry
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer
from dstack_tpu_torch.train import finetune as tfinetune
from dstack_tpu_torch.train import step as tstep

MEMORY_GAUGES = ("dtpu_serve_device_memory_bytes_in_use", "dtpu_serve_device_memory_peak_bytes")
# fed by the server's scheduler and the flight recorder's post-mortems
LIFECYCLE_FAMILIES = (
    "dtpu_serve_watchdog_aborts_total",
    "dtpu_serve_deadline_expired_total",
    "dtpu_serve_resumed_requests_total",
    "dtpu_serve_postmortems_total",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registry, differential
# ---------------------------------------------------------------------------


def _drive_registry(mod, seed: int, **hist_kw):
    """One seeded sequence of operations on a fresh ``mod.Registry`` →
    (registry, what its read methods returned along the way)."""
    rng = np.random.default_rng(seed)
    r = mod.Registry()
    c = r.counter("t_requests_total", "Requests", ("route", "code"), max_series=4)
    g = r.gauge("t_queue_depth", "Queue depth\nwith a second line")
    h = r.histogram("t_latency_seconds", "Latency", ("route",), **hist_kw)
    u = r.histogram("t_rows", "Rows a dispatch", buckets=(1.0, 2.0, 4.0, 8.0))
    reads = []
    routes = ["/a", '/b"quoted"', "/c\\back", "/d\nnew", "/e", "/f"]
    for i in range(300):
        route = routes[int(rng.integers(0, len(routes)))]
        op = int(rng.integers(0, 5))
        if op == 0:
            c.inc(float(rng.integers(1, 4)), route, int(rng.integers(200, 203)))
        elif op == 1:
            g.set(float(rng.normal()) * 1e3)
        elif op == 2:
            g.inc(0.25)
        elif op == 3:
            ex = f"trace-{i}" if rng.random() < 0.3 else None
            h.observe(float(rng.lognormal(-4.0, 2.0)), route, exemplar=ex)
        else:
            u.observe(float(rng.integers(1, 10)))
        if i % 50 == 49:
            reads.append([
                c.value(route, 200), c.total(), g.value(), h.sum(route), h.count(route),
                h.totals(), h.exemplars(route), h.exemplar_near(0.99, route),
                [h.quantile(q, route) for q in (0.0, 0.5, 0.95, 0.99, 1.0)],
                u.quantile(0.5), sorted(k for k, _ in c.items()),
            ])
    c.remove("/a", 200)
    reads.append([r.metric_names(), c.value("/a", 200)])
    return r, reads


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hist_kw", [{}, {"sample_window": 0}, {"buckets": (0.001, 0.01, 0.1), "max_series": 2}],
                         ids=["window", "interpolated", "truncated"])
def test_registry_renders_and_reads_as_jax(seed, hist_kw):
    jr, jreads = _drive_registry(jobs, seed, **hist_kw)
    tr, treads = _drive_registry(tobs, seed, **hist_kw)
    assert tr.render() == jr.render()
    assert treads == jreads
    # the truncation sentinel really fired (a capped family saw more label sets)
    assert "<truncated>" in tr.render()


@pytest.mark.parametrize("value", ["plain", 'q"uote', "back\\slash", "new\nline", 'all\\"\n', 42, 1.5])
def test_escape_label(value):
    assert tobs.escape_label(value) == jobs.escape_label(value)


def test_buckets_are_jax_buckets():
    for name in ("LATENCY_BUCKETS_S", "SHORT_LATENCY_BUCKETS_S", "THROUGHPUT_BUCKETS"):
        assert getattr(tobs, name) == getattr(jobs, name)


def test_reregistering_a_name_returns_it_or_raises():
    r = tobs.Registry()
    c = r.counter("x_total", "X")
    assert r.counter("x_total", "X again") is c
    with pytest.raises(ValueError, match="different type"):
        r.gauge("x_total", "X")


# ---------------------------------------------------------------------------
# the serve registry
# ---------------------------------------------------------------------------


def _families(r) -> dict:
    return {
        name: (
            type(fam).__name__, fam.kind, fam.help, fam.labelnames, fam.max_series,
            getattr(fam, "buckets", None), getattr(fam, "sample_window", None),
        )
        for name in r.metric_names()
        for fam in [r.family(name)]
    }


def test_serve_registry_has_jax_families():
    jf, tf = _families(jax_serve_registry()), _families(port_serve_registry())
    assert tf == jf
    assert set(LIFECYCLE_FAMILIES) < set(tf)
    assert port_serve_registry().render() == jax_serve_registry().render()


def test_train_registry_has_jax_families():
    assert _families(tstep.new_train_registry()) == _families(jstep.new_train_registry())


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

MAX_SEQ = 256
CHUNK = 64
JC, TC = jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JC, jax.random.key(0))
    tp = tllama.params_from_jax(jax.tree.map(np.asarray, jp), TC, device="cpu")
    return jp, tp


def _prompts(seed: int, lens: list) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, JC.vocab_size, n).tolist() for n in lens]


def _waves() -> list:
    """The waves of ``test_torch_serve_breadth.py``: a repetitive prompt
    (drafts fire), a plain one, a burst (a packed wave), and two prompts
    sharing two chunks of prefix (a prefix hit)."""
    phrase = [5, 9, 13, 17]
    shared = _prompts(6, [160])[0]
    return [
        [(phrase * 12)[:40]],
        [[7] * 40],
        _prompts(7, [20, 70, 100]),
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],
    ]


def _wave(eng, gen_cls, prompts) -> list:
    """The scheduler's call sequence for one wave → (kind, output) records."""
    records = []
    slots = [eng.start_request(list(p), gen_cls(max_new_tokens=24)) for p in prompts]
    while eng.prefilling_slots():
        records.append(("prefill", eng.prefill_wave()))
    while any(eng.active[s] for s in slots):
        out = eng.step()
        records.append((eng._last_step_phase, out))
    for s in slots:
        eng.release(s)
    return records


def _snapshot(reg) -> dict:
    """Every fed family's comparable reading: counter and gauge series,
    histogram counts, and the pack rows' bucket counts."""
    out = {}
    for name in reg.metric_names():
        if name in MEMORY_GAUGES:
            continue
        fam = reg.family(name)
        series = dict(fam.items())
        if fam.kind == "histogram":
            out[name] = {k: s["count"] for k, s in series.items()}
            if name == "dtpu_serve_prefill_pack_rows":
                out[name + ":buckets"] = {k: list(s["counts"]) for k, s in series.items()}
        else:
            out[name] = series
    return out


@pytest.fixture
def recorders():
    """Both flight recorders on (the prior ones put back), and JAX's jit
    caches empty: a function jitted by an earlier engine in this process
    would otherwise compile nothing here."""
    jax.clear_caches()
    priors = [(mod, mod.get_recorder()) for mod in (jflight, tflight)]
    recs = jflight.enable(buffer=512), tflight.enable(buffer=512)
    yield recs
    for mod, prior in priors:
        if prior is None:
            mod.disable()
        else:
            mod._recorder, mod.record = prior, prior.record


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_metrics_match_jax(weights, recorders, kv_quant):
    jp, tp = weights
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9,
              kv_quant=kv_quant, decode_kernel="flash")
    je = jengine.InferenceEngine(JC, jp, **kw)
    te = tengine.InferenceEngine(TC, tp, device="cpu", **kw)
    kinds = set()
    for prompts in _waves():
        jrec, trec = _wave(je, jengine.GenParams, prompts), _wave(te, tengine.GenParams, prompts)
        assert trec == jrec
        kinds |= {k for k, _ in trec}
        je.update_state_gauges()
        te.update_state_gauges()
        assert _snapshot(te.metrics) == _snapshot(je.metrics)
        st = te.stats
        seconds = sum(st[f"{k}_seconds"] for k in ("decode", "spec", "turbo"))
        step_sum = te.metrics.family("dtpu_serve_decode_step_seconds").sum()
        assert step_sum == pytest.approx(seconds, rel=1e-12, abs=1e-12)
        assert te.metrics.family("dtpu_serve_ttft_seconds").sum() == pytest.approx(
            st["ttft_sum_s"], rel=1e-12, abs=1e-12)
    assert {"prefill", "spec", "turbo"} <= kinds
    m = te.metrics
    assert m.family("dtpu_serve_prefix_hits_total").value() == 1
    assert m.family("dtpu_serve_prefix_tokens_reused_total").value() == 128
    assert m.family("dtpu_serve_prefill_pack_rows").count() == te.stats["prefill_dispatches"]
    compiles = dict(m.family("dtpu_serve_compiles_total").items())
    assert {"verify", "turbo", "sample", "mark_seen"} <= {fn for (fn,) in compiles}
    assert m.family("dtpu_serve_recompiles_total").items() == []
    # nothing aborted, expired or resumed here, and the CPU engine sets no
    # device-memory gauge
    assert all(m.family(name).value() == 0.0 for name in LIFECYCLE_FAMILIES)
    assert all(m.family(name).items() == [] for name in MEMORY_GAUGES)


WATCHDOG_S, HANG_S = 2.5, 6.0


async def _lifecycle(server, faults, qos, tok, engine) -> None:
    """One server over ``engine``: a greedy pair (every variant the wedge
    replays compiles here, with the watchdog off), the same pair with a
    hang planted in the first slot's ``serve.engine.step`` under the
    watchdog (an abort and its post-mortem), a streamed chat whose deadline
    the ``serve.deadline`` skew expires mid-decode (a deadline batch-abort
    post-mortem), and a resumed chat."""
    app = server.build_app(engine, tok(), "tiny", qos_policy=qos.QoSPolicy(), watchdog_seconds=0.0,
                           deadline_default=0.0, boot=None)
    c = TestClient(TestServer(app))
    await c.start_server()
    one = {"prompt": "The quick brown fox jumps", "max_tokens": 12}
    ascii_only = {str(i): -100 for i in range(128, JC.vocab_size)}
    chat = {"messages": [{"role": "user", "content": "Tell me about foxes"}], "max_tokens": 12,
            "logit_bias": ascii_only}
    try:
        statuses = [(await c.post("/v1/completions", json=one)).status for _ in range(1)]
        statuses += [r.status for r in await asyncio.gather(*(c.post("/v1/completions", json=one)
                                                                for _ in range(2)))]
        app["scheduler"].watchdog_seconds = WATCHDOG_S
        faults.install_plan({"rules": [{"point": "serve.engine.step", "action": "hang", "seconds": HANG_S,
                                        "nth": 1}]})
        t0 = time.monotonic()
        statuses += sorted(r.status for r in await asyncio.gather(*(c.post("/v1/completions", json=one)
                                                                      for _ in range(2))))
        faults.clear()
        # the steps below may compile new variants: no watchdog over them
        app["scheduler"].watchdog_seconds = 0.0
        faults.install_plan({"rules": [{"point": "serve.deadline", "action": "corrupt", "value": 1e9,
                                        "nth": 3}]})
        r = await c.post("/v1/chat/completions", json={**chat, "stream": True}, headers={"X-DTPU-Deadline": "60"})
        body = await r.text()
        faults.clear()
        assert '"error": "request deadline exceeded"' in body
        r = await c.post("/v1/chat/completions", json={**chat, "dtpu_resume": {"text": "ab"}},
                         headers={"X-DTPU-Resume": "1"})
        statuses.append(r.status)
        assert statuses == [200, 200, 200, 200, 500, 200]
        # the abandoned step's thread sleeps on: let it return first
        await asyncio.sleep(max(0.0, HANG_S - (time.monotonic() - t0)) + 0.5)
    finally:
        faults.clear()
        await c.close()


async def test_lifecycle_families_match_jax(weights, recorders):
    """The four lifecycle families fed through both servers' schedulers
    over both engines by one scenario: every family of the engines'
    registries equal, those four non-zero."""
    jp, tp = weights
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9)
    je = jengine.InferenceEngine(JC, jp, **kw)
    te = tengine.InferenceEngine(TC, tp, device="cpu", **kw)
    await _lifecycle(jserver, jfaults, jqos, JByteTokenizer, je)
    await _lifecycle(tserver, tfaults, tqos, ByteTokenizer, te)
    je.update_state_gauges()
    te.update_state_gauges()
    assert _snapshot(te.metrics) == _snapshot(je.metrics)
    m = te.metrics
    assert [m.family(name).value() for name in LIFECYCLE_FAMILIES] == [1.0, 1.0, 1.0, 2.0]
    reasons = [pm["reason"] for pm in recorders[1].postmortems()]
    assert reasons == [pm["reason"] for pm in recorders[0].postmortems()] == ["watchdog_abort", "deadline_abort"]


def test_compile_families_render_as_jax(recorders):
    """The same compile events through JAX's recorder into its registry
    and the port's into the port's: byte-identical pages; the rings carry
    the same compile and recompile records."""
    events = [("decode", None, 0.25, False), ("turbo", 8, 1.5, False), ("turbo", 1, 0.0625, False),
              ("sample", None, 3e-3, False), ("turbo", 2, 0.5, True), ("verify", None, 12.0, True)]
    regs = jax_serve_registry(), port_serve_registry()
    for rec, reg in zip(recorders, regs):
        for fn, key, seconds, recompile in events:
            rec.note_compile(fn, key, seconds, reg, recompile=recompile)
        reg.family("dtpu_serve_warmup_gap_compiles_total").inc(1, "turbo")
        reg.family("dtpu_serve_compile_cache_entries").set(3, "turbo")
    assert regs[1].render() == regs[0].render()
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("t", "seq")} for r in recs]  # noqa: E731
    jrec, trec = recorders
    assert strip(trec.records(20)) == strip(jrec.records(20))
    assert strip(trec.compile_events()) == strip(jrec.compile_events())
    assert trec.compile_totals() == jrec.compile_totals()


def test_state_gauges_while_slots_are_live(weights):
    """Mid-flight: one slot prefilling, two decoding, one prefix cached."""
    _, tp = weights
    te = tengine.InferenceEngine(TC, tp, device="cpu", max_batch=4, max_seq=MAX_SEQ,
                                 prefill_chunk=CHUNK, turbo_quiet_s=1e9)
    slots = [te.start_request(p, tengine.GenParams(max_new_tokens=8)) for p in _prompts(3, [30, 50])]
    while te.prefilling_slots():
        te.prefill_wave()
    te.start_request(_prompts(4, [150])[0], tengine.GenParams(max_new_tokens=8))
    te.update_state_gauges()
    m = te.metrics
    assert m.family("dtpu_serve_active_slots").value() == 2
    assert m.family("dtpu_serve_max_slots").value() == 4
    assert m.family("dtpu_serve_batch_occupancy_ratio").value() == 0.5
    assert m.family("dtpu_serve_kv_cache_utilization_ratio").value() == round(80 / (4 * MAX_SEQ), 6)
    assert m.family("dtpu_serve_prefix_slots").value() == len(slots)


# ---------------------------------------------------------------------------
# train telemetry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama-tiny-64", "mla-tiny"])
def test_step_callback_matches_jax(name):
    dts = [(0.5, 1), (0.25, 4), (1e-12, 1), (2.0, 10)]
    kw = dict(tokens_per_step=8 * 2048, seq_len=2048, peak_flops_per_chip=989e12)
    jcb = jstep.make_step_callback(jllama.CONFIGS[name], **kw)
    tcb = tstep.make_step_callback(tllama.CONFIGS[name], **kw)
    for dt, steps in dts:
        got, want = tcb(dt, steps=steps), jcb(dt, steps=steps)
        assert got == pytest.approx(want, rel=1e-12)
    assert tcb.registry.render() == jcb.registry.render()
    assert tstep.make_step_callback(tllama.CONFIGS[name], 1, 16).registry is not None


def test_finetune_profile_dir_writes_a_trace(tmp_path, monkeypatch, capsys):
    tfinetune.main([
        "--model", "llama-tiny-64", "--device", "cpu", "--steps", "4", "--seq-len", "32",
        "--batch", "2", "--log-every", "1", "--profile-dir", str(tmp_path / "prof"),
        "--out", str(tmp_path / "out"),
    ])
    out = capsys.readouterr().out
    trace = tmp_path / "prof" / "finetune_trace.json"
    assert trace.stat().st_size > 0 and f"profiler trace saved to {trace}" in out
    assert '"traceEvents"' in trace.read_text()[:4096] or "traceEvents" in trace.read_text()
    summary = [line for line in out.splitlines() if line.startswith('{"event": "summary"')]
    assert summary and '"median_step_s": ' in summary[0]
