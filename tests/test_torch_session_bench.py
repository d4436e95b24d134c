"""The port's multi-replica paths against the JAX package's, on llama-tiny
with JAX's weights carried across by ``params_from_jax``:

- ``run_session_bench``: the port's against JAX's on the same seeded
  conversations gives, for affinity on and off, equal replica choices each
  turn, equal greedy replies, and equal ``prefix_hits`` and
  ``same_replica_rate``; affinity-on keeps every warm turn on its replica.
- ``python -m dstack_tpu_torch.serve.bench --sessions`` prints one JSON
  line on the CPU and, without ``--device cpu`` and a card, raises.
- A greedy stream whose replica dies mid-body, resumed through the port's
  forwarder onto a second port server (``X-DTPU-Resume``), equals the
  uninterrupted stream in f32; so does a seeded sampled one. This is
  ``tests/chaos/test_chaos_stream_resume.py``'s acceptance on the port.
- ``engine.bias_row`` against the JAX engine's loop; a bias body past
  aiohttp's 1 MiB is served by the port (the JAX server answers 400).
"""

import asyncio
import json

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu.models import llama as jllama
from dstack_tpu.routing import pool as jpool
from dstack_tpu.serve import bench as jbench
from dstack_tpu.serve import tokenizer as jtok
from dstack_tpu_torch import faults as tfaults
from dstack_tpu_torch import qos as tqos
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.qos.metrics import get_qos_registry
from dstack_tpu_torch.routing import get_router_registry
from dstack_tpu_torch.routing import pool as tpool
from dstack_tpu_torch.routing.forward import forward_with_failover
from dstack_tpu_torch.serve import bench as tbench
from dstack_tpu_torch.serve import tokenizer as ttok
from dstack_tpu_torch.serve.engine import InferenceEngine
from dstack_tpu_torch.serve.openai_server import build_app

SESSIONS = dict(model="llama-tiny", replicas=2, sessions=4, turns=3, tenants=2, gen_len=6,
                turn_chars=120, batch=4, max_seq=512, prefill_chunk=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tree():
    return jax.tree.map(np.asarray, jllama.init_params(jllama.LLAMA_TINY, jax.random.key(0)))


def _recording(monkeypatch, pool_mod, tok_mod, log):
    """Record every pick and every decoded reply of one package's bench."""
    pick, decode = pool_mod.ReplicaPool.pick, tok_mod.ByteTokenizer.decode

    def rec_pick(self, *a, **kw):
        e = pick(self, *a, **kw)
        log.append(("pick", e.replica_id))
        return e

    def rec_decode(self, ids):
        text = decode(self, ids)
        log.append(("reply", text))
        return text

    monkeypatch.setattr(pool_mod.ReplicaPool, "pick", rec_pick)
    monkeypatch.setattr(tok_mod.ByteTokenizer, "decode", rec_decode)


def test_session_bench_matches_jax(monkeypatch, jax_tree):
    jlog, tlog = [], []
    monkeypatch.setattr(jllama, "init_params", lambda config, key: jax.tree.map(jax.numpy.asarray, jax_tree))
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, gen, device: tllama.params_from_jax(jax_tree, config, device=device))
    _recording(monkeypatch, jpool, jtok, jlog)
    want = jbench.run_session_bench(**SESSIONS)
    monkeypatch.undo()
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, gen, device: tllama.params_from_jax(jax_tree, config, device=device))
    _recording(monkeypatch, tpool, ttok, tlog)
    got = tbench.run_session_bench(**SESSIONS, device="cpu")

    # 2 passes (untimed, timed) x 2 settings x turns x sessions
    assert len([e for e in tlog if e[0] == "pick"]) == 4 * SESSIONS["turns"] * SESSIONS["sessions"]
    assert tlog == jlog  # replica choices and greedy replies, turn by turn
    for mode in ("affinity_on", "affinity_off"):
        for k in ("prefix_hits", "same_replica_rate"):
            assert got["extra"][mode][k] == want["extra"][mode][k], (mode, k)
    assert got["extra"]["affinity_on"]["same_replica_rate"] == 1.0
    assert got["extra"]["affinity_on"]["prefix_hits"] > got["extra"]["affinity_off"]["prefix_hits"]
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    jx = {k for k in want["extra"] if k not in ("backend", "note")}
    assert jx <= set(got["extra"])
    assert got["extra"]["backend"] == "cpu" and got["extra"]["kernel_launches"] == {
        "flash_fwd": 0, "flash_decode": 0}  # the plain versions run on the CPU


def test_sessions_cli_prints_one_line(capsys, tmp_path):
    out = tmp_path / "s.json"
    argv = ["--device", "cpu", "--sessions", "2", "--replicas", "2", "--turns", "2",
            "--tenants", "1", "--turn-chars", "40", "--gen-len", "3", "--batch", "2",
            "--max-seq", "256", "--prefill-chunk", "32", "--output", str(out)]
    assert tbench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "serve_session_ttft_warm_ms[llama-tiny,replicas=2]"
    assert r["extra"]["sessions"] == 2 and r["extra"]["turns"] == 2
    assert json.loads(out.read_text()) == r


def test_sessions_without_device_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--sessions", "2"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bias_row_matches_jax_loop(seed):
    """``engine.bias_row`` against the JAX engine's loop
    (dstack_tpu/serve/engine.py:2282-2286): str and int keys, ids outside
    the vocabulary, and two keys of one id (the later wins)."""
    from dstack_tpu_torch.serve.engine import bias_row

    rng = np.random.default_rng(seed)
    vocab = 300
    bias = {}
    for _ in range(200):
        t = int(rng.integers(-20, vocab + 20))
        bias[str(t) if rng.random() < 0.5 else t] = float(rng.uniform(-100, 100))
    want = np.zeros((vocab,), np.float32)
    for tid, bv in bias.items():
        t = int(tid)
        if 0 <= t < vocab:
            want[t] = float(bv)
    assert np.array_equal(bias_row(bias, vocab).numpy(), want)
    assert not bias_row(None, vocab).any() and not bias_row({}, vocab).any()


def test_one_replica_is_refused():
    with pytest.raises(ValueError, match="replicas must be >= 2"):
        tbench.run_session_bench(replicas=1, device="cpu")


# ---------------------------------------------------------------------------
# a resumed stream through the port's forwarder over two port servers
# ---------------------------------------------------------------------------


def _sse_events(raw: bytes) -> list:
    out = []
    for block in raw.split(b"\n\n"):
        for line in block.split(b"\n"):
            if line.startswith(b"data:"):
                out.append(line[5:].strip())
    return out


def _stream_text(events: list) -> tuple:
    text, ids, done = "", [], False
    for data in events:
        if data == b"[DONE]":
            done = True
            continue
        obj = json.loads(data)
        assert "error" not in obj, f"client saw an error event: {obj}"
        ids.append(obj.get("id"))
        text += (obj["choices"][0].get("delta") or {}).get("content") or ""
    return text, ids, done


async def _serving_stack(jax_tree, qos_policy=None):
    """Two port servers over the same f32 weights (identical greedy
    streams) behind the port's forwarder → (router client, servers)."""
    config = tllama.LLAMA_TINY
    params = tllama.params_from_jax(jax_tree, config, device="cpu")
    servers = []
    for _ in range(2):
        engine = InferenceEngine(config, params, max_batch=2, max_seq=128, decode_kernel="einsum",
                                 device="cpu")
        server = TestServer(build_app(engine, ttok.ByteTokenizer(), "llama-tiny",
                                      qos_policy=qos_policy, boot=None))
        await server.start_server()
        servers.append(server)
    pool = tpool.ReplicaPool("p", "svc", tpool.PoolConfig(startup_grace=0.0))
    pool.sync([(f"r{i}", s.host, s.port) for i, s in enumerate(servers)])
    holder = {}
    app = web.Application()

    async def handler(request):
        if "s" not in holder:
            holder["s"] = aiohttp.ClientSession()
        return await forward_with_failover(request, pool, holder["s"], request.match_info["path"])

    async def cleanup(_):
        if "s" in holder:
            await holder["s"].close()

    app.router.add_route("*", "/{path:.*}", handler)
    app.on_cleanup.append(cleanup)
    client = TestClient(TestServer(app))
    await client.start_server()
    return client, servers


_CHAT = {
    "model": "llama-tiny",
    "messages": [{"role": "user", "content": "abcdefg"}],
    "max_tokens": 24,
    "stream": True,
    # ASCII output only (the byte tokenizer round-trips 0..127) and no eos
    "logit_bias": {str(i): -100 for i in range(128, tllama.LLAMA_TINY.vocab_size)},
}


async def test_a_bias_body_past_1mib_is_served(jax_tree):
    """A logit_bias over a large vocabulary is megabytes of JSON (the soak's
    ASCII bias on llama-3.2-1b: 1.9 MB). Both servers keep aiohttp's 1 MiB
    by default and answer such a body 400 "invalid JSON body"; the soak's
    replicas are built with ``client_max_size=MAX_BODY_BYTES`` and serve it
    (ROADMAP C)."""
    from dstack_tpu.serve import engine as jengine
    from dstack_tpu.serve import openai_server as jserver
    from dstack_tpu_torch.loadgen.soak import MAX_BODY_BYTES

    config = tllama.LLAMA_TINY
    # ids past the vocabulary are skipped by both engines: only the size differs
    payload = {"model": "llama-tiny", "prompt": "abc", "max_tokens": 4,
               "logit_bias": {str(i): -100 for i in range(128, 150_000)}}
    assert 1 << 20 < len(json.dumps(payload)) < MAX_BODY_BYTES
    tengine = InferenceEngine(config, tllama.params_from_jax(jax_tree, config, device="cpu"), max_batch=2,
                              max_seq=128, decode_kernel="einsum", device="cpu")
    jeng = jengine.InferenceEngine(jllama.LLAMA_TINY, jax.tree.map(jax.numpy.asarray, jax_tree),
                                   max_batch=2, max_seq=128)
    answers = {}
    for name, app in (("torch", build_app(tengine, ttok.ByteTokenizer(), "llama-tiny", boot=None)),
                      ("jax", jserver.build_app(jeng, jtok.ByteTokenizer(), "llama-tiny", boot=None)),
                      ("soak", build_app(tengine, ttok.ByteTokenizer(), "llama-tiny", boot=None,
                                         client_max_size=MAX_BODY_BYTES))):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json=payload)
            answers[name] = (r.status, await r.json())
        finally:
            await client.close()
    assert answers["jax"] == (400, {"detail": "invalid JSON body"})
    assert answers["torch"] == answers["jax"]
    status, body = answers["soak"]
    assert status == 200 and body["usage"]["completion_tokens"] == 4
    assert all(ord(ch) < 128 for ch in body["choices"][0]["text"])


@pytest.fixture
def _no_fault_plan():
    tfaults.clear()
    yield
    tfaults.clear()


@pytest.mark.parametrize("extra", [{}, {"temperature": 1.1, "seed": 13, "max_tokens": 20}],
                         ids=["greedy", "seeded"])
async def test_stream_resumed_across_port_replicas_is_identical(extra, jax_tree, _no_fault_plan):
    client, servers = await _serving_stack(jax_tree, qos_policy=tqos.QoSPolicy(rps=1000.0, burst=1000.0))
    payload = {**_CHAT, **extra}
    resumes = get_router_registry().family("dtpu_router_stream_resumes_total")
    admitted = get_qos_registry().family("dtpu_qos_admitted_total")
    try:
        r = await client.post("/v1/chat/completions", json=payload)
        assert r.status == 200
        control, _, done = _stream_text(_sse_events(await r.read()))
        assert done and len(control) >= 10
        r0, a0 = resumes.value(), admitted.value(tqos.ANONYMOUS_TENANT)
        tfaults.install_plan({"rules": [
            {"point": "serve.stream", "action": "raise", "error": "connect", "nth": 2},
        ]})
        r = await client.post("/v1/chat/completions", json=payload)
        assert r.status == 200  # zero client-visible 5xx
        text, ids, done = _stream_text(_sse_events(await r.read()))
        assert text == control  # complete: no token lost, none repeated
        assert done and len(set(ids)) == 1
        assert resumes.value() == r0 + 1
        assert admitted.value(tqos.ANONYMOUS_TENANT) == a0 + 1  # one admission for two legs
    finally:
        await client.close()
        for s in servers:
            await s.close()
        await asyncio.sleep(0)
