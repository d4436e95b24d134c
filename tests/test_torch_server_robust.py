"""The port's server lifecycle against the JAX server on the CPU in f32:
QoS, deadlines, the engine watchdog, resume, trace spans and the
``/debug/*`` routes (ROADMAP A4.1).

The JAX ``build_app`` and the port's serve the same tiny llama weights
(JAX's init carried across by ``params_from_jax``) on engines at their
defaults, and one scripted scenario goes through each, its fault plan
installed in that package's ``faults`` only. The tenant buckets run on one
frozen clock (``TenantBuckets``' default clock replaced in both packages),
so admissions and ``Retry-After`` hints do not depend on the host's speed.

1. Two same-prompt greedy requests (the baseline of step 6).
2. Tenants over their rate: a burst of three from one tenant (two served,
   the second deferred at the in-flight cap of 1, one shed 429), ``n``'s
   fan-out charge (an ``n`` past the burst is a 400), a spent tenant shed.
3. A deadline expired in the queue (``X-DTPU-Deadline: 0``, 504), a
   malformed deadline ignored, a deadline expired mid-decode (forced
   through the ``serve.deadline`` skew point on the sweep after the first
   decode step: the streamed tokens so far, then the error event).
4. ``dtpu_resume``: the continuation of a greedy chat gives the rest of
   the uninterrupted text, is neither charged nor shed (its tenant's
   bucket is empty), and one asking for logprobs is refused.
5. A request continuing a trace (``X-DTPU-Trace``): the id echoed, and
   ``/debug/traces?id=`` holds its request, queue, prefill and decode
   spans; ``/debug/boot`` and ``/debug/flight``.
6. Under a watchdog of 2.5 s, a 6 s hang planted in one slot's
   ``serve.engine.step``: one request gets the watchdog's 500, the other
   finishes with the baseline's tokens, the next request is served, and
   the flight recorder's post-mortem names the wedged slot and its trace.

Held equal between the servers: every status, error detail and
``Retry-After``, the texts, the ``/health`` keys (JAX's within the
port's), the span trees, the post-mortem's shape, and every counter on
``/metrics`` (the four lifecycle families, ``dtpu_qos_*``,
``dtpu_flight_postmortems_total``, the request and token counts) as well
as the set of families the page renders.

The profiler routes: with ``DTPU_PROFILER_DIR`` set, start and stop answer
with JAX's replies (a second start and a stop without a start are 409s) and
write a chrome trace there; without it neither server routes them. And the
port's server takes every flag of the JAX server's but ``--platform`` and
``--tp`` (ROADMAP A6).
"""

import asyncio
import json
import re
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu import faults as jfaults
from dstack_tpu import qos as jqos
from dstack_tpu.models import llama as jllama
from dstack_tpu.obs import boot as jboot
from dstack_tpu.obs import flight as jflight
from dstack_tpu.obs import slo as jslo
from dstack_tpu.obs import tracing as jtracing
from dstack_tpu.qos import metrics as jqm
from dstack_tpu.serve import engine as jengine
from dstack_tpu.serve import openai_server as jserver
from dstack_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from dstack_tpu_torch import faults as tfaults
from dstack_tpu_torch import qos as tqos
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.obs import boot as tboot
from dstack_tpu_torch.obs import flight as tflight
from dstack_tpu_torch.obs import slo as tslo
from dstack_tpu_torch.obs import tracing as ttracing
from dstack_tpu_torch.qos import metrics as tqm
from dstack_tpu_torch.serve import engine as tengine
from dstack_tpu_torch.serve import openai_server as tserver
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer

JC, TC = jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64
PROMPT = "The quick brown fox jumps"
TRACE = "00000000000000aa-00000000000000bb"
WATCHDOG_S, HANG_S = 2.5, 6.0
# ASCII only (the byte tokenizer decodes ids past 255 to nothing): the
# streamed text shows every token, and a resume's splice re-encodes exactly
BAN_HIGH = {str(i): -100 for i in range(128, JC.vocab_size)}
JAX_PKG = types.SimpleNamespace(name="jax", server=jserver, faults=jfaults, qos=jqos, qm=jqm, boot=jboot,
                                flight=jflight, tracing=jtracing, slo=jslo, tok=JByteTokenizer)
PORT_PKG = types.SimpleNamespace(name="port", server=tserver, faults=tfaults, qos=tqos, qm=tqm, boot=tboot,
                                 flight=tflight, tracing=ttracing, slo=tslo, tok=ByteTokenizer)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    # JAX's jit caches are process-wide: a function an earlier test in this
    # process compiled would count no compile here, and the compile
    # families on /metrics are compared
    jax.clear_caches()
    tree = jax.tree.map(np.asarray, jllama.init_params(JC, jax.random.key(0)))
    kw = dict(max_batch=4, max_seq=256, prefill_chunk=64, turbo_quiet_s=1e9)
    return (jengine.InferenceEngine(JC, jax.tree.map(jax.numpy.asarray, tree), **kw),
            tengine.InferenceEngine(TC, tllama.params_from_jax(tree, TC, device="cpu"), device="cpu", **kw))


@pytest.fixture
def frozen_buckets(monkeypatch):
    """Both packages' tenant buckets on one frozen clock; an SLO tick so
    long that each app's SLO windows tick once, at their first read (the
    count of evaluations then depends on the reads, not on the host's
    speed); both packages' process registries and fault plans fresh."""
    monkeypatch.setenv("DTPU_SLO_TICK", "1e6")
    for pkg in (JAX_PKG, PORT_PKG):
        monkeypatch.setattr(pkg.qos.TenantBuckets.__init__, "__defaults__", (256, lambda: 1000.0))
        for mod in (pkg.qm, pkg.tracing, pkg.flight, pkg.slo, pkg.boot):
            monkeypatch.setattr(mod, "_registry", None)
        pkg.faults.clear()
    yield
    for pkg in (JAX_PKG, PORT_PKG):
        pkg.faults.clear()


async def _client(app) -> TestClient:
    c = TestClient(TestServer(app))
    await c.start_server()
    return c


async def _post(c, path, body, **headers):
    r = await c.post(path, json=body, headers=headers)
    try:
        data = await r.json()
    except Exception:  # noqa: BLE001 - a stream: its events
        data = None
    return r.status, data, r.headers.get("Retry-After"), r.headers.get("X-DTPU-Trace")


async def _stream(c, path, body, **headers):
    r = await c.post(path, json=body, headers=headers)
    events = []
    async for raw in r.content:
        line = raw.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            events.append(json.loads(line[len("data: "):]))
    return r.status, events


def _text(resp) -> list:
    return [ch["text"] for ch in resp["choices"]]


def _metrics(page: str) -> tuple:
    """→ (family names, {counter series: value})."""
    families = set(re.findall(r"^# TYPE (\S+) ", page, re.M))
    counters = {name for name in families if re.search(rf"^# TYPE {re.escape(name)} counter$", page, re.M)}
    values = {}
    for line in page.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        series, value = line.split(" # ")[0].rsplit(" ", 1)
        if series.split("{")[0] in counters:
            values[series] = float(value)
    return families, values


def _span_tree(trace: dict) -> list:
    ids = {s["span_id"]: s["name"] for s in trace["spans"]}
    return sorted((s["name"], ids.get(s["parent_id"], s["parent_id"]), s["status"],
                   sorted(e["name"] for e in s["events"]), sorted(s["attrs"])) for s in trace["spans"])


async def _scenario(pkg, engine) -> dict:
    srv = pkg.server
    obs: dict = {}
    policy = pkg.qos.QoSPolicy(rps=0.01, burst=2, tenant_inflight=1)
    boot = pkg.boot.BootRecorder(registry=pkg.boot.new_boot_registry())
    with boot.stage("engine_init"):
        pass
    app = srv.build_app(engine, pkg.tok(), "tiny", qos_policy=policy, watchdog_seconds=0.0,
                        deadline_default=0.0, boot=boot)
    c = await _client(app)
    wd = None
    try:
        one = {"prompt": PROMPT, "max_tokens": 12}
        # 1. the baseline: two same-prompt requests side by side
        base = await asyncio.gather(*(_post(c, "/v1/completions", one, **{"X-DTPU-Tenant": t})
                                      for t in ("w1", "w2")))
        obs["baseline"] = [(s, _text(d), d["usage"]) for s, d, _, _ in base]
        # 2. QoS: a burst over the rate, the cap's deferral, n's charge
        burst = await asyncio.gather(*(_post(c, "/v1/completions", {"prompt": PROMPT, "max_tokens": 4},
                                             **{"X-DTPU-Tenant": "a"}) for _ in range(3)))
        obs["burst"] = sorted((s, ra, d.get("detail") if s != 200 else _text(d)) for s, d, ra, _ in burst)
        s, d, ra, _ = await _post(c, "/v1/completions", {"prompt": PROMPT, "max_tokens": 3, "n": 2},
                                  **{"X-DTPU-Tenant": "b"})
        obs["fan_out"] = (s, ra, _text(d), d["usage"])
        obs["n_past_burst"] = (await _post(c, "/v1/completions", {"prompt": PROMPT, "n": 3},
                                           **{"X-DTPU-Tenant": "d"}))[:3]
        obs["spent"] = (await _post(c, "/v1/completions", {"prompt": PROMPT}, **{"X-DTPU-Tenant": "b"}))[:3]
        # 3. deadlines
        obs["queued_deadline"] = (await _post(c, "/v1/completions", {"prompt": PROMPT, "max_tokens": 4},
                                              **{"X-DTPU-Tenant": "c", "X-DTPU-Deadline": "0"}))[:3]
        s, d, _, _ = await _post(c, "/v1/completions", {"prompt": PROMPT, "max_tokens": 4},
                                 **{"X-DTPU-Tenant": "c", "X-DTPU-Deadline": "soon"})
        obs["bad_deadline"] = (s, _text(d))
        # the chat prompt prefills in two chunks: the request's third check
        # (queued, prefilling, decoding) is the sweep after its first step
        pkg.faults.install_plan({"rules": [{"point": "serve.deadline", "action": "corrupt", "value": 1e9,
                                            "nth": 3}]})
        s, events = await _stream(c, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": PROMPT}], "max_tokens": 60, "stream": True,
            "logit_bias": BAN_HIGH},
            **{"X-DTPU-Tenant": "e", "X-DTPU-Deadline": "1000"})
        pkg.faults.clear()
        obs["decode_deadline"] = (s, "".join(e["choices"][0]["delta"].get("content") or ""
                                             for e in events if "choices" in e),
                                  [e for e in events if "error" in e])
        # 4. resume: the rest of an uninterrupted greedy chat
        chat = {"messages": [{"role": "user", "content": "Tell me about foxes"}], "max_tokens": 16,
                "logit_bias": BAN_HIGH}
        s, full, _, _ = await _post(c, "/v1/chat/completions", chat, **{"X-DTPU-Tenant": "f"})
        text = full["choices"][0]["message"]["content"]
        cut = 6
        resumed = await _post(c, "/v1/chat/completions", {**chat, "dtpu_resume": {"text": text[:cut]}},
                              **{"X-DTPU-Tenant": "a", "X-DTPU-Resume": "1"})
        obs["resume"] = (s, text, resumed[0], resumed[1]["choices"][0]["message"]["content"])
        obs["resume_logprobs"] = (await _post(
            c, "/v1/chat/completions", {**chat, "logprobs": True, "dtpu_resume": {"text": text[:cut]}},
            **{"X-DTPU-Tenant": "a", "X-DTPU-Resume": "1"}))[:3]
        # 5. a continued trace, and the debug routes
        s, d, _, echoed = await _post(c, "/v1/completions", {"prompt": PROMPT, "max_tokens": 12},
                                      **{"X-DTPU-Tenant": "g", "X-DTPU-Trace": TRACE})
        traces = await (await c.get("/debug/traces", params={"id": TRACE.split("-")[0]})).json()
        obs["trace"] = (s, echoed, _span_tree(traces["trace"]))
        dboot = await (await c.get("/debug/boot", params={"limit": "8"})).json()
        obs["boot"] = (sorted(dboot), [e["stage"] for e in dboot["timeline"]], sorted(dboot["summary"]),
                       sorted(dboot["compile_manifest"]))
        # 6. the watchdog: a second app over the same engine
        wd = await _client(srv.build_app(engine, pkg.tok(), "tiny", qos_policy=pkg.qos.QoSPolicy(),
                                         watchdog_seconds=WATCHDOG_S, deadline_default=0.0, boot=None))
        pkg.faults.install_plan({"rules": [{"point": "serve.engine.step", "action": "hang",
                                            "seconds": HANG_S, "nth": 1}]})
        t0 = time.monotonic()
        pair = await asyncio.gather(*(_post(wd, "/v1/completions", one, **{"X-DTPU-Trace": f"{i + 1:016x}-01"})
                                      for i in range(2)))
        pkg.faults.clear()
        obs["wedge"] = sorted((s, d.get("detail") if s != 200 else (_text(d), d["usage"])) for s, d, _, _ in pair)
        obs["after_wedge"] = (await _post(wd, "/v1/completions", one))[0]
        flight = await (await wd.get("/debug/flight", params={"limit": "4", "postmortems": "1"})).json()
        pm = flight["postmortems"][-1]
        wedged = int(pm["ctx"]["wedge"].split(":")[1])
        obs["postmortem"] = (sorted(flight), pm["reason"], sorted(pm), sorted(pm["ctx"]),
                             pm["ctx"]["slots"].get(str(wedged), pm["ctx"]["slots"].get(wedged)),
                             pm["records"][-1]["phase"], pm["records"][-1].get("slot"))
        h = await (await wd.get("/health")).json()
        obs["health"] = (sorted(h), sorted(h["flight"]), h["inflight"], h["queue_depth"])
        obs["metrics"] = _metrics(await (await wd.get("/metrics")).text())
        # the abandoned step's thread sleeps on: let it return before the
        # loop closes
        await asyncio.sleep(max(0.0, HANG_S - (time.monotonic() - t0)) + 0.5)
        obs["health_slo"] = sorted((await (await c.get("/health")).json())["slo_windows"])
    finally:
        pkg.faults.clear()
        await c.close()
        if wd is not None:
            await wd.close()
    return obs


async def test_lifecycle_scenario_matches_jax(engines, frozen_buckets):
    jeng, teng = engines
    want = await _scenario(JAX_PKG, jeng)
    got = await _scenario(PORT_PKG, teng)
    # the scenario did what it says, in JAX's server
    base = want["baseline"]
    assert base[0] == base[1] and base[0][0] == 200
    assert [s for s, _, _ in want["burst"]] == [200, 200, 429] and want["burst"][2][1] == "100"
    assert want["n_past_burst"][0] == 400 and (want["spent"][0], want["spent"][2]) == (429, "100")
    assert want["queued_deadline"] == (504, {"detail": "request deadline exceeded"}, None)
    assert want["decode_deadline"][1] and want["decode_deadline"][2] == [{"error": "request deadline exceeded"}]
    s, text, rs, rest = want["resume"]
    assert s == rs == 200 and rest == text[6:]
    assert want["resume_logprobs"][0] == 400
    assert want["trace"][1] == TRACE.split("-")[0]
    assert {n for n, *_ in want["trace"][2]} == {"serve.request", "serve.queue", "serve.prefill", "serve.decode"}
    assert want["wedge"] == [(200, base[0][1:]), (500, "engine watchdog aborted a wedged decode step")]
    assert want["after_wedge"] == 200 and want["postmortem"][1] == "watchdog_abort"
    # and the port's server did the same
    for key in want:
        if key in ("health", "metrics"):
            continue
        assert got[key] == want[key], key
    # /health: JAX's keys, and the port's run and kernel counts besides
    jkeys, jflight_keys, *jload = want["health"]
    tkeys, tflight_keys, *tload = got["health"]
    assert set(jkeys) <= set(tkeys) and tflight_keys == jflight_keys and tload == jload
    assert set(tkeys) - set(jkeys) == {
        "device", "decode_kernel", "engine", "stats", "kernel_launches",
        "flash_decode_launches", "w8_matmul_launches", "graph_sites", "graph_captures", "flight_warm",
        "device_memory"}
    # /metrics: the same families, every counter equal
    (jfam, jval), (tfam, tval) = want["metrics"], got["metrics"]
    assert tfam == jfam
    assert tval == jval
    for fam in ("dtpu_serve_watchdog_aborts_total", "dtpu_serve_deadline_expired_total",
                "dtpu_serve_resumed_requests_total", "dtpu_serve_postmortems_total",
                "dtpu_qos_inflight_deferred_total{tenant=\"a\"}", "dtpu_qos_shed_total{tenant=\"b\"}",
                "dtpu_flight_postmortems_total"):
        assert tval[fam] >= 1, fam


@pytest.mark.parametrize("pkg", [JAX_PKG, PORT_PKG], ids=["jax", "port"])
async def test_profiler_routes(engines, tmp_path, monkeypatch, pkg):
    engine = engines[0] if pkg is JAX_PKG else engines[1]
    monkeypatch.delenv("DTPU_PROFILER_DIR", raising=False)
    c = await _client(pkg.server.build_app(engine, pkg.tok(), "tiny", boot=None))
    try:
        assert (await c.post("/debug/profiler/start")).status in (404, 405)
    finally:
        await c.close()
    out = tmp_path / "prof"
    monkeypatch.setenv("DTPU_PROFILER_DIR", str(out))
    c = await _client(pkg.server.build_app(engine, pkg.tok(), "tiny", boot=None))
    try:
        r = await c.post("/debug/profiler/start")
        assert (r.status, await r.json()) == (200, {"tracing": True, "dir": str(out)})
        r = await c.post("/debug/profiler/start")
        assert r.status == 409 and "already running" in (await r.json())["detail"]
        assert (await (await c.get("/health")).json())["profiler_tracing"] is True
        s, d, _, _ = await _post(c, "/v1/completions", {"prompt": PROMPT, "max_tokens": 6})
        assert s == 200
        r = await c.post("/debug/profiler/stop")
        assert (r.status, await r.json()) == (200, {"tracing": False, "dir": str(out)})
        r = await c.post("/debug/profiler/stop")
        assert r.status == 409 and (await r.json())["detail"] == "no trace running"
    finally:
        await c.close()
    files = [p for p in Path(out).rglob("*") if p.is_file()]
    assert files
    if pkg is PORT_PKG:
        [trace] = files
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)


def test_the_server_takes_every_jax_flag():
    """Every flag of the JAX server's ``main`` but ``--platform`` and
    ``--tp`` (ROADMAP A6) is a flag of the port's (read from both sources)."""
    flags = {}
    for name, mod in (("jax", jserver), ("port", tserver)):
        src = Path(mod.__file__).read_text()
        flags[name] = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', src))
    assert flags["jax"] - flags["port"] == {"--platform", "--tp"}
    assert {"--tokenizer", "--compile-cache", "--qos-rps", "--qos-burst", "--qos-tenant-inflight"} <= flags["port"]
