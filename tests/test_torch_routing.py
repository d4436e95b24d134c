"""The port's ``routing/`` against the JAX package's on the same inputs.

- ``affinity``: ``request_affinity`` keys over a seeded corpus of chat and
  completion payloads and tenants; ``AffinityMap`` record / lookup /
  invalidate / LRU-eviction / TTL sequences under one fake clock;
  ``AffinityConfig.from_env`` under the same environment.
- ``metrics``: ``new_router_registry`` renders byte-identical.
- ``pool``: one seeded trace of ``sync``, ``pick`` (with and without an
  affinity key), successes, failures, drains, SLO pins and ``/health``
  probe payloads (scripted answers, failed probes, boot blocks) applied to
  both ``ReplicaPool``s under one fake clock gives equal picks, states and
  breaker transitions, and both process-global router registries render
  byte-identical afterwards.
- ``forward``: ``forward_with_failover`` of both packages in front of the
  same aiohttp fake replicas, under one fault plan installed in both
  packages, gives equal status, body and router counters: failover past a
  dead replica, a ``routing.forward`` fault, a mid-stream death resumed
  over ``X-DTPU-Resume``, an in-band error event, the exhausted pool's
  503 and the deadline header rewritten on every leg.
"""

import asyncio
import json
import random
import socket
import types

import aiohttp
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu import faults as jfaults
from dstack_tpu import qos as jqos
from dstack_tpu.routing import affinity as jaff
from dstack_tpu.routing import forward as jfwd
from dstack_tpu.routing import metrics as jmetrics
from dstack_tpu.routing import pool as jpool
from dstack_tpu_torch import faults as tfaults
from dstack_tpu_torch.routing import affinity as taff
from dstack_tpu_torch.routing import forward as tfwd
from dstack_tpu_torch.routing import metrics as tmetrics
from dstack_tpu_torch.routing import pool as tpool

PACKAGES = {
    "jax": types.SimpleNamespace(aff=jaff, pool=jpool, metrics=jmetrics, fwd=jfwd, faults=jfaults),
    "torch": types.SimpleNamespace(aff=taff, pool=tpool, metrics=tmetrics, fwd=tfwd, faults=tfaults),
}


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for the pool and affinity modules of both
    packages (their module-level ``time`` only: event loops keep theirs)."""
    c = FakeClock()
    import time as real_time

    # perf_counter too: the probe histogram observes a probe's round trip
    fake = types.SimpleNamespace(monotonic=c.monotonic, perf_counter=c.monotonic, time=real_time.time)
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.pool, "time", fake)
        monkeypatch.setattr(pkg.aff, "time", fake)
    return c


@pytest.fixture
def fresh_registries(monkeypatch):
    """Both packages' process-global router registries, new for the test."""
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.metrics, "_registry", None)
    yield
    for pkg in PACKAGES.values():
        pkg.metrics._registry = None


@pytest.fixture(autouse=True)
def _no_fault_plan():
    for pkg in PACKAGES.values():
        pkg.faults.clear()
    yield
    for pkg in PACKAGES.values():
        pkg.faults.clear()


# ---------------------------------------------------------------------------
# affinity
# ---------------------------------------------------------------------------


def _words(rng: random.Random, n: int) -> str:
    return " ".join(
        "".join(rng.choice("abcdefghij \t") for _ in range(rng.randint(1, 9))) for _ in range(n)
    )


def _corpus(seed: int, n: int = 60) -> list:
    """Seeded (path, payload, tenant) cases: chats that extend each other,
    completions across the 256-char block edge, malformed bodies, and
    whitespace variants that must key alike."""
    rng = random.Random(seed)
    out = []
    history: list = []
    for _ in range(n):
        kind = rng.choice(["chat", "chat", "completion", "odd"])
        tenant = rng.choice([None, "", "t0", "t1", "tenant-é"])
        if kind == "chat":
            if rng.random() < 0.3:
                history = []
            history = history + [{"role": rng.choice(["system", "user", "assistant"]),
                                  "content": rng.choice([_words(rng, rng.randint(0, 12)), None, 7])}]
            path = rng.choice(["/v1/chat/completions", "v1/chat/completions/", "chat/completions"])
            out.append((path, {"messages": list(history)}, tenant))
        elif kind == "completion":
            prompt = _words(rng, rng.randint(1, 120))
            out.append((rng.choice(["/v1/completions", "completions"]), {"prompt": prompt}, tenant))
        else:
            out.append(rng.choice([
                ("/v1/completions", {"prompt": ""}, tenant),
                ("/v1/completions", {"prompt": ["a"]}, tenant),
                ("/v1/chat/completions", {"messages": "x"}, tenant),
                ("/v1/chat/completions", {"messages": [1, 2]}, tenant),
                ("/v1/embeddings", {"input": "abc"}, tenant),
                ("/v1/chat/completions", None, tenant),
                ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x" * 5}] * 40}, tenant),
            ]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_request_affinity_keys_equal(seed):
    keys = 0
    for path, payload, tenant in _corpus(seed):
        j = jaff.request_affinity(path, payload, tenant)
        t = taff.request_affinity(path, payload, tenant)
        if j is None:
            assert t is None, (path, payload)
            continue
        keys += 1
        assert (t.digests, t.session) == (j.digests, j.session), (path, payload, tenant)
    assert keys > 20  # the corpus keys most of its cases


def test_chain_and_units_equal():
    units = [f"u{i}" for i in range(40)]  # past MAX_PREFIX_UNITS
    assert taff.chain_digests(units) == jaff.chain_digests(units)
    assert taff.MAX_PREFIX_UNITS == jaff.MAX_PREFIX_UNITS
    assert taff.PROMPT_BLOCK_CHARS == jaff.PROMPT_BLOCK_CHARS
    p = {"prompt": "x" * 700}
    assert taff.payload_units("/v1/completions", p) == jaff.payload_units("/v1/completions", p)


@pytest.mark.parametrize("env", [
    {},
    {"DTPU_ROUTER_AFFINITY": "0"},
    {"DTPU_ROUTER_AFFINITY": "False", "DTPU_ROUTER_AFFINITY_MAX_IMBALANCE": "-3"},
    {"DTPU_ROUTER_AFFINITY_MAP_SIZE": "0", "DTPU_ROUTER_AFFINITY_TTL": "0.2"},
    {"DTPU_ROUTER_AFFINITY_MAP_SIZE": "junk", "DTPU_ROUTER_AFFINITY_TTL": " 42 "},
])
def test_affinity_config_from_env_equal(env, monkeypatch):
    for k in ("DTPU_ROUTER_AFFINITY", "DTPU_ROUTER_AFFINITY_MAX_IMBALANCE",
              "DTPU_ROUTER_AFFINITY_MAP_SIZE", "DTPU_ROUTER_AFFINITY_TTL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = jaff.AffinityConfig.from_env(), taff.AffinityConfig.from_env()
    assert vars(t) == vars(j)


@pytest.mark.parametrize("seed", [0, 1])
def test_affinity_map_sequences_equal(seed, clock):
    rng = random.Random(seed)
    cases = [c for c in _corpus(seed + 10, 80) if c[1] is not None]
    maps = {
        name: pkg.aff.AffinityMap(pkg.aff.AffinityConfig(max_entries=12, ttl_seconds=30.0))
        for name, pkg in PACKAGES.items()
    }
    seqs = {name: [] for name in PACKAGES}
    for _ in range(400):
        op = rng.choice(["record", "record", "lookup", "lookup", "invalidate", "tick", "clear"])
        path, payload, tenant = rng.choice(cases)
        rid = rng.choice(["r0", "r1", "r2"])
        dt = rng.choice([0.5, 3.0, 31.0])
        roll = rng.random()
        for name, pkg in PACKAGES.items():
            m = maps[name]
            key = pkg.aff.request_affinity(path, payload, tenant)
            if op == "record":
                m.record(key, rid)
                res = None
            elif op == "lookup":
                res = m.lookup_entry(key)
            elif op == "invalidate":
                m.invalidate_replica(rid)
                res = None
            elif op == "clear" and roll < 0.1:
                m.clear()
                res = None
            else:
                res = None
            seqs[name].append((op, res, len(m), list(m._entries.items())))
        if op == "tick":
            clock.t += dt
    assert seqs["torch"] == seqs["jax"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_router_registry_renders_identical():
    j, t = jmetrics.new_router_registry(), tmetrics.new_router_registry()
    assert t.render() == j.render()
    for reg in (j, t):
        reg.family("dtpu_router_picks_total").inc(3, "ready")
        reg.family("dtpu_router_probe_seconds").observe(0.0123)
        reg.family("dtpu_router_replicas").set(2, "dead")
        reg.family("dtpu_router_failovers_total").inc(1)
    assert t.render() == j.render()


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------


class _FakeResponse:
    def __init__(self, status: int, body):
        self.status = status
        self._body = body
        self.request_info = None

    async def json(self, content_type=None):
        if isinstance(self._body, Exception):
            raise self._body
        return self._body


class _FakeSession:
    """What ``probe_replica`` calls: ``session.get(url, timeout=...)`` as an
    async context manager; the answer is scripted per probe."""

    def __init__(self):
        self.answer = None

    def get(self, url, timeout=None):
        answer = self.answer
        session = self

        class _Ctx:
            async def __aenter__(self):
                if isinstance(answer, Exception):
                    raise answer
                return _FakeResponse(*answer)

            async def __aexit__(self, *exc):
                return False

        session.url = url
        return _Ctx()


def _entry_state(e) -> tuple:
    return (e.replica_id, e.host, e.port, e.state.value, e.outstanding, e.consecutive_failures,
            e.breaker_backoff, e.breaker_open_until, e.half_open, e.last_probe_at,
            e.drain_deadline_at, e.drained_counted, e.slo_degraded, dict(e.probe),
            e.boot_memo.get("boot_id"))


def _probe_answer(rng: random.Random):
    kind = rng.choice(["ok", "ok", "ok", "5xx", "connect", "timeout", "text", "boot"])
    if kind == "5xx":
        return (503, {})
    if kind == "connect":
        return aiohttp.ClientConnectionError("refused")
    if kind == "timeout":
        return asyncio.TimeoutError()
    if kind == "text":
        return (200, ValueError("not json"))
    body = {
        "queue_depth": rng.choice([0, 1, 9, None]),
        "inflight": rng.randint(0, 4),
        "kv_utilization": rng.choice([0.1, 0.5, 0.97]),
        "active_slots": rng.randint(0, 8), "max_slots": 8,
        "prefix_hits": rng.randint(0, 5), "prefix_slots": rng.choice([0, 1, 3, None]),
        "extra_field": "dropped",
    }
    if kind == "boot":
        body["boot"] = {"boot_id": rng.choice(["b1", "b2"]), "stages": {}}
    return (200, body)


def _run_pool_trace(pkg, seed: int, clock: FakeClock, t0: float) -> list:
    clock.t = t0
    rng = random.Random(seed)
    cfg = pkg.pool.PoolConfig(
        fail_threshold=2, breaker_base_backoff=1.0, breaker_max_backoff=6.0,
        startup_grace=rng.choice([0.0, 5.0]), probe_stale_after=15.0, drain_deadline=10.0,
    )
    pool = pkg.pool.ReplicaPool("p", "svc", cfg)
    pool.affinity = pkg.aff.AffinityMap(pkg.aff.AffinityConfig(max_imbalance=1, max_entries=64))
    session = _FakeSession()
    corpus = [c for c in _corpus(seed + 100, 40) if c[1] is not None]
    held: list = []
    out = []

    def sync(ids):
        members = [(rid, "h", 8000 + int(rid[1:]) + (100 if rng.random() < 0.1 else 0)) for rid in ids]
        pool.sync(members)
        for e in pool.entries.values():  # the entry's default factory reads the real clock
            if not getattr(e, "_seen", False):
                e.created_at = clock.t
                e._seen = True

    sync(["r0", "r1", "r2"])
    for step in range(300):
        op = rng.choice(["pick", "pick", "pick", "pick_aff", "pick_aff", "release", "success",
                         "failure", "failure", "drain", "undrain", "drained", "slo", "probe",
                         "probe", "tick", "tick", "sync", "record", "summary"])
        rid = rng.choice(["r0", "r1", "r2", "r3"])
        res = None
        if op in ("pick", "pick_aff"):
            excl = set(rng.sample(["r0", "r1", "r2", "r3"], rng.randint(0, 2)))
            path, payload, tenant = rng.choice(corpus)
            key = pkg.aff.request_affinity(path, payload, tenant) if op == "pick_aff" else None
            e = pool.pick(exclude=excl, affinity=key)
            res = None if e is None else e.replica_id
            if e is not None:
                pool.acquire(e)
                held.append(e.replica_id)
                if rng.random() < 0.5:
                    pool.affinity.record(key, e.replica_id)
        elif op == "release" and held:
            r = held.pop(rng.randrange(len(held)))
            if pool.get(r) is not None:
                pool.release(pool.get(r))
        elif op in ("success", "failure") and pool.get(rid) is not None:
            (pool.report_success if op == "success" else pool.report_failure)(pool.get(rid))
        elif op == "drain":
            res = pool.mark_draining(rid, deadline_seconds=rng.choice([None, 2.0]))
        elif op == "undrain":
            res = pool.cancel_draining(rid)
        elif op == "drained":
            res = pool.drained(rid)
        elif op == "slo":
            res = pool.set_slo_degraded(rid, rng.random() < 0.6)
        elif op == "probe" and pool.get(rid) is not None:
            session.answer = _probe_answer(rng)
            res = asyncio.run(pool.probe_replica(session, pool.get(rid)))
        elif op == "tick":
            clock.t += rng.choice([0.3, 1.1, 4.0, 12.0])
        elif op == "sync":
            ids = sorted(set(rng.sample(["r0", "r1", "r2", "r3"], rng.randint(1, 4))))
            sync(ids)
        elif op == "record":
            path, payload, tenant = rng.choice(corpus)
            pool.affinity.record(pkg.aff.request_affinity(path, payload, tenant), rid)
        elif op == "summary":
            res = (pool.probe_summary(), pool.retry_after_hint(),
                   [e.replica_id for e in pool.probe_targets()])
        out.append((step, op, res, pool._rr, pool.states(),
                    [_entry_state(e) for e in sorted(pool.entries.values(), key=lambda e: e.replica_id)],
                    list(pool.affinity._entries.items())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_trace_equal(seed, clock, fresh_registries):
    """Equal picks, states, breaker windows, probe captures and affinity
    maps step by step; the router registries render byte-identical."""
    jtrace = _run_pool_trace(PACKAGES["jax"], seed, clock, 1000.0)
    ttrace = _run_pool_trace(PACKAGES["torch"], seed, clock, 1000.0)
    for j, t in zip(jtrace, ttrace):
        assert t == j
    assert len(ttrace) == len(jtrace)
    ops = {op for _, op, res, *_ in ttrace if res is not None}
    assert {"pick", "pick_aff", "probe"} <= ops
    states = {s for *_, entries, _ in ttrace for e in entries for s in [e[3]]}
    assert {"ready", "dead", "draining", "degraded"} <= states  # the trace reached them
    jreg, treg = jmetrics.get_router_registry(), tmetrics.get_router_registry()
    assert treg.family("dtpu_router_breaker_opens_total").value() > 0
    assert treg.render() == jreg.render()


def test_pool_registry_gauges_equal(fresh_registries):
    for pkg in PACKAGES.values():
        reg = pkg.pool.PoolRegistry()
        a = reg.pool("p", "a")
        a.sync([("r0", "h", 1), ("r1", "h", 2)])
        a.mark_draining("r1")
        reg.pool("p", "b").sync([("x", "h", 3)])
        reg.prune([("p", "a")])
        reg.update_state_gauge()
    assert tmetrics.get_router_registry().render() == jmetrics.get_router_registry().render()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _chunk(cid: str, text, finish=None) -> bytes:
    delta = {"role": "assistant"}
    if text is not None:
        delta["content"] = text
    obj = {"id": cid, "object": "chat.completion.chunk", "created": 7, "model": "m",
           "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


def _fake_replica(name: str, mode: dict, seen: list) -> web.Application:
    """A scripted replica: JSON answers, SSE streams that die after
    ``mode["die_after"]`` events (the socket torn down mid-body), an
    in-band error event, 5xx answers, and the headers it was sent."""

    async def handler(request):
        body = await request.read()
        payload = json.loads(body) if body else {}
        seen.append((name, request.path, request.headers.get(jqos.RESUME_HEADER),
                     request.headers.get(jqos.DEADLINE_HEADER), request.headers.get(jqos.TENANT_HEADER),
                     payload.get("dtpu_resume"), payload.get("prompt")))
        if mode.get("status"):
            return web.json_response({"detail": f"{name} down"}, status=mode["status"])
        if not payload.get("stream"):
            return web.json_response({"replica": name, "echo": payload.get("prompt")},
                                     headers={"x-request-id": f"req-{name}"})
        resume = (payload.get("dtpu_resume") or {}).get("text", "")
        words = [f"w{i} " for i in range(8)]
        done = "".join(words)
        start = words and next((i for i in range(len(words) + 1) if "".join(words[:i]) == resume), 0)
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        sent = 0
        for w in words[start:]:
            if mode.get("die_after") is not None and sent >= mode["die_after"]:
                await resp.write(b'data: {"partial')  # half an event, then death
                request.transport.close()
                return resp
            if mode.get("error_after") is not None and sent >= mode["error_after"]:
                await resp.write(b'data: {"error": {"message": "engine failed"}}\n\n')
                await resp.write_eof()
                return resp
            await resp.write(_chunk(f"id-{name}", w))
            sent += 1
        assert done
        await resp.write(_chunk(f"id-{name}", None, "stop"))
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_route("*", "/{path:.*}", handler)
    return app


def _router(pkg, members) -> tuple:
    pool = pkg.pool.ReplicaPool("p", "svc", pkg.pool.PoolConfig(startup_grace=0.0))
    pool.sync(members)
    holder = {}
    app = web.Application()

    async def handler(request):
        if "session" not in holder:
            holder["session"] = aiohttp.ClientSession()
        return await pkg.fwd.forward_with_failover(
            request, pool, holder["session"], request.match_info["path"],
            extra_headers={jqos.TENANT_HEADER: "tenant-a"},
        )

    async def cleanup(_):
        if "session" in holder:
            await holder["session"].close()

    app.router.add_route("*", "/{path:.*}", handler)
    app.on_cleanup.append(cleanup)
    return app, pool


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_SCENARIOS = {
    # r0 refuses connections: the JSON request fails over to r1
    "failover_dead": ({"r0": "dead", "r1": {}}, [
        ("POST", "/v1/completions", {"prompt": "hello"}, {}),
        ("POST", "/v1/completions", {"prompt": "hello again"}, {}),
    ], None),
    # r0 answers 503: the request fails over
    "failover_5xx": ({"r0": {"status": 503}, "r1": {}}, [
        ("POST", "/v1/completions", {"prompt": f"p{i}"}, {}) for i in range(4)
    ], None),
    # a routing.forward fault kills the first attempt of every request
    "fault_plan": ({"r0": {}, "r1": {}}, [
        ("POST", "/v1/completions", {"prompt": f"q{i}"}, {}) for i in range(3)
    ], {"seed": 3, "rules": [{"point": "routing.forward", "action": "raise", "error": "connect",
                              "ctx": {"attempt": 1}, "prob": 0.7}]}),
    # the first replica dies after two events: the stream resumes on r1
    "resume": ({"r0": {"die_after": 2}, "r1": {}}, [
        ("POST", "/v1/chat/completions",
         {"messages": [{"role": "user", "content": "hi"}], "stream": True, "max_tokens": 8}, {}),
    ], None),
    # an in-band error event counts as a death too
    "inband_error": ({"r0": {"error_after": 3}, "r1": {}}, [
        ("POST", "/v1/chat/completions",
         {"messages": [{"role": "user", "content": "yo"}], "stream": True}, {}),
    ], None),
    # unseeded sampling is not resumable: an honest terminal error event
    "not_resumable": ({"r0": {"die_after": 1}, "r1": {"die_after": 1}}, [
        ("POST", "/v1/chat/completions",
         {"messages": [{"role": "user", "content": "s"}], "stream": True, "temperature": 0.9}, {}),
    ], None),
    # every replica gone: 503 with Retry-After
    "exhausted": ({"r0": "dead", "r1": "dead"}, [
        ("POST", "/v1/completions", {"prompt": "x"}, {}),
        ("GET", "/v1/models", None, {}),
    ], None),
    # the deadline header is rewritten to the remaining budget per leg
    "deadline": ({"r0": "dead", "r1": {}}, [
        ("POST", "/v1/completions", {"prompt": "d"}, {jqos.DEADLINE_HEADER: "30"}),
    ], None),
}


async def _run_forward(pkg, modes: dict, requests: list, plan) -> tuple:
    seen: list = []
    servers, members = [], []
    for rid, mode in modes.items():
        if mode == "dead":
            members.append((rid, "127.0.0.1", _free_port()))
            continue
        srv = TestServer(_fake_replica(rid, mode, seen))
        await srv.start_server()
        servers.append(srv)
        members.append((rid, srv.host, srv.port))
    app, pool = _router(pkg, members)
    client = TestClient(TestServer(app))
    await client.start_server()
    reg = pkg.metrics.get_router_registry()
    names = ("dtpu_router_failovers_total", "dtpu_router_stream_resumes_total",
             "dtpu_router_exhausted_total", "dtpu_router_breaker_opens_total",
             "dtpu_router_affinity_hits_total", "dtpu_router_affinity_misses_total")
    c0 = {n: reg.family(n).value() for n in names}
    if plan is not None:
        pkg.faults.install_plan(plan)
    answers = []
    try:
        for method, path, payload, headers in requests:
            r = await client.request(method, path, json=payload, headers={
                **headers, jqos.TENANT_HEADER: "spoofed", jqos.RESUME_HEADER: "1"})
            raw = await r.read()
            answers.append((r.status, raw, r.headers.get("Retry-After"), r.headers.get("x-request-id")))
    finally:
        pkg.faults.clear()
        await client.close()
        for s in servers:
            await s.close()
    counters = {n: reg.family(n).value() - c0[n] for n in names}
    # a deadline's remaining budget is wall time: compare its presence
    legs = [s[:3] + (s[3] is not None and 0 < float(s[3]) <= 30.0,) + s[4:] for s in seen]
    states = {rid: e.state.value for rid, e in pool.entries.items()}
    return answers, counters, legs, states


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
async def test_forward_with_failover_equal(name):
    modes, requests, plan = _SCENARIOS[name]
    j = await _run_forward(PACKAGES["jax"], modes, requests, plan)
    t = await _run_forward(PACKAGES["torch"], modes, requests, plan)
    # a dead replica's error text names its port, which differs per run
    def scrub(res, members_ports=None):
        answers, counters, legs, states = res
        out = []
        for status, raw, ra, rid in answers:
            try:
                body = json.loads(raw)
                if "detail" in body:
                    body["detail"] = body["detail"].split("(")[0]
                raw = body
            except ValueError:
                pass
            out.append((status, raw, ra, rid))
        return out, counters, legs, states

    assert scrub(t) == scrub(j)
    answers, counters, legs, _ = t
    if name == "resume":
        assert counters["dtpu_router_stream_resumes_total"] == 1
        assert b"w7 " in answers[0][1] and b"[DONE]" in answers[0][1]
        assert any(leg[2] == "1" and leg[5] for leg in legs)  # the resume leg
    if name in ("failover_5xx", "failover_dead", "fault_plan"):
        assert counters["dtpu_router_failovers_total"] >= 1
    if name == "exhausted":
        assert answers[0][0] == 503 and answers[0][2] is not None
    if name == "deadline":
        assert all(leg[3] for leg in legs)
    # the client's own tenant and resume headers never pass the edge
    assert all(leg[4] == "tenant-a" for leg in legs)


def test_header_filters_equal():
    headers = {"Host": "x", "Authorization": "b", "Content-Length": "3", "X-DTPU-Tenant": "t",
               "x-dtpu-resume": "1", "X-DTPU-Trace": "t:s", "Accept": "*/*", "X-Custom": "y"}
    assert tfwd.filter_request_headers(headers) == jfwd.filter_request_headers(headers)
    assert tfwd.PROXY_ASSERTED_HEADERS == jfwd.PROXY_ASSERTED_HEADERS


@pytest.mark.parametrize("payload", [
    {"messages": [{"role": "user", "content": "a"}], "stream": True},
    {"messages": [], "stream": True, "temperature": 0.7, "seed": 3},
    {"messages": [], "stream": True, "temperature": 0.7},
    {"prompt": "p", "stream": True},
    {"prompt": "p", "stream": True, "temperature": 0.5, "seed": 1},
    {"prompt": ["p"], "stream": True},
    {"messages": [], "stream": True, "n": 2},
    {"messages": [], "stream": True, "logprobs": True},
    {"messages": [], "stream": True, "tools": [{}]},
    {"messages": [], "stream": True, "presence_penalty": 0.5},
    {"messages": [], "stream": False},
])
def test_resume_eligibility_and_body_equal(payload):
    for path in ("/v1/chat/completions", "/v1/completions", "/v1/embeddings"):
        body = json.dumps(payload).encode()
        j = jfwd._resumable_stream("POST", path, body)
        t = tfwd._resumable_stream("POST", path, body)
        assert (t is None) == (j is None)
        if j is not None:
            j.delivered = t.delivered = "abc"
            assert t.resume_body() == j.resume_body()
