"""The port's server features against the JAX server on the CPU in f32.

The JAX ``build_app`` and the port's ``build_app`` serve the same tiny
weights (JAX's init carried across by ``params_from_jax``) at the engines'
defaults (packed prefill, speculative verify, turbo macro-steps, the
prefix cache), each under aiohttp's ``TestClient``, and get the same
requests. Held to JAX:

- token logprobs, completions (``logprobs: 3``) and chat (``top_logprobs:
  2``), whole and streamed, with a stop string that cuts the text: equal
  tokens and top ids, values within 1e-4; ``token_logprobs`` itself, ties
  included, and ``sample``'s penalties, bias, min-p, top-k and top-p (0 of
  1,200 tokens differ);
- ``n``: two greedy choices equal JAX's; the 400s carry JAX's details;
- tools: ``_parse_tool_calls`` and ``_tool_stream_safe_len`` on a corpus
  (the call ids aside), the tool_choice / response_format statuses and
  details, a tool-call history, ``json_object`` and ``--chat-template``;
- ``/v1/embeddings`` within 1e-4 on the tiny llama, tiny Gemma-2 and
  Gemma-3-style configs, ``mla-tiny`` and a tiny gpt-oss (the test of
  ``forward``'s gpt-oss repair: it runs with autograd off and still
  refuses autograd), and the same 400s;
- ``--weights``: ``load_weights_npz`` on a file written as JAX's fine-tune
  writes it and on one the port's writes, and the LoRA refusal with JAX's
  message;
- the start-up warmup leaves every slot free, ``spec_draft`` restored and
  nothing a request could see: greedy, seeded and unseeded ``generate``
  after it equal a fresh engine's.

The ``cuda``-marked class holds ``embed_vectors`` through K1 to its plain
path on the card (bf16, 2e-2) and skips where there is none.
"""

import asyncio
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu.models import llama as jllama
from dstack_tpu.serve import engine as jengine
from dstack_tpu.serve import openai_server as jserver
from dstack_tpu.serve.tokenizer import ByteTokenizer as JByteTokenizer
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.serve import engine as tengine
from dstack_tpu_torch.serve import openai_server as tserver
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer
from dstack_tpu_torch.train import finetune as tfinetune

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4  # f32 end to end
JC, TC = jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64
MAX_SEQ = 256
CHUNK = 64
PROMPT = "The quick brown fox jumps over the lazy dog, then " * 2  # two chunks
# the tiny model's greedy text for PROMPT, from JAX's seed-0 init, is
# '(N�7...': "7" cuts it after three tokens
STOP = "7"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_params(jc, tc, perturb=None, seed=0):
    """JAX's init of ``jc`` (the leaves of ``perturb`` that the config has
    overwritten with seeded values: leaf → (mean, std)) → (JAX tree, the
    port's tree)."""
    tree = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(7)
    for name, (mean, std) in (perturb or {}).items():
        if name not in tree["layers"]:
            continue
        leaf = tree["layers"][name]
        tree["layers"][name] = (mean + std * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return jax.tree.map(jnp.asarray, tree), tllama.params_from_jax(tree, tc, device="cpu")


@pytest.fixture(scope="module")
def engines():
    """The two engines at their defaults over the same weights: shared by
    the tests (each builds its own apps, so each gets fresh schedulers),
    so JAX compiles each step variant once."""
    jp, tp = _tiny_params(JC, TC)
    jeng = jengine.InferenceEngine(JC, jp, max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK)
    teng = tengine.InferenceEngine(TC, tp, max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, device="cpu")
    return jeng, teng


async def _clients(jeng, teng, chat_template=None) -> tuple:
    jc = TestClient(TestServer(jserver.build_app(
        jeng, JByteTokenizer(), "tiny", chat_template, boot=None,
    )))
    tc = TestClient(TestServer(tserver.build_app(teng, ByteTokenizer(), "tiny", chat_template)))
    await jc.start_server()
    await tc.start_server()
    return jc, tc


async def _both(clients, path: str, body: dict) -> tuple:
    """POST to both servers, one after the other → ((status, json), ...)."""
    out = []
    for c in clients:
        r = await c.post(path, json=body)
        out.append((r.status, await r.json()))
    return tuple(out)


async def _sse(resp) -> list:
    events = []
    async for raw in resp.content:
        line = raw.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            events.append(json.loads(line[len("data: "):]))
    return events


async def _close(clients) -> None:
    for c in clients:
        await c.close()


def _close_lists(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=ATOL, rtol=0, err_msg=what)


def _same_chat_entries(got: list, want: list) -> None:
    """Chat logprob entries: equal tokens and alternatives, values 1e-4."""
    assert [e["token"] for e in got] == [e["token"] for e in want]
    _close_lists([e["logprob"] for e in got], [e["logprob"] for e in want], "chosen")
    for g, w in zip(got, want):
        assert [a["token"] for a in g["top_logprobs"]] == [a["token"] for a in w["top_logprobs"]]
        _close_lists([a["logprob"] for a in g["top_logprobs"]],
                     [a["logprob"] for a in w["top_logprobs"]], "alternatives")


# ---------------------------------------------------------------------------
# token logprobs
# ---------------------------------------------------------------------------


class TestTokenLogprobs:
    def test_matches_jax_with_ties(self):
        """The top 5 come in jax.lax.top_k's order, ties included (equal
        logits: the lower id first)."""
        rng = np.random.default_rng(0)
        logits = rng.standard_normal((4, 300)).astype(np.float32)
        logits[0, [3, 50, 7, 200, 9, 120]] = 4.0  # six tied maxima
        logits[1, [10, 11]] = logits[1].max() + 1.0
        logits[2, :] = 0.5  # all tied
        tokens = np.array([50, 11, 299, 0], np.int32)
        jl, ji, jt = (np.asarray(a) for a in jengine.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens)))
        tl, ti, tt = tengine.token_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens))
        assert ti.tolist() == ji.tolist()
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), jt, atol=1e-6)
        assert tengine.TOP_LOGPROBS == jengine.TOP_LOGPROBS == 5

    def test_a_logprobs_request_takes_the_plain_step(self):
        """Off the turbo, speculative and argmax paths, as in JAX: every
        token after the first comes from a plain decode step, with its
        entry; release drops an entry not taken."""
        _, tp = _tiny_params(JC, TC)
        eng = tengine.InferenceEngine(TC, tp, max_batch=2, max_seq=MAX_SEQ, prefill_chunk=CHUNK, device="cpu")
        tok = ByteTokenizer()
        slot, first = eng.add_request(tok.encode(PROMPT), tengine.GenParams(max_new_tokens=6, logprobs=2))
        entries = [eng.take_logprobs(slot)]
        while eng.active[slot]:
            eng.step()
            entries.append(eng.take_logprobs(slot))
        assert eng.stats["decode_steps"] == 5 and eng.stats["turbo_dispatches"] == 0
        assert eng.stats["spec_steps"] == 0
        assert all(e is not None and len(e[1]) == 5 for e in entries)
        assert entries[0][1][0][0] == first  # greedy: the chosen token is the top one
        assert abs(entries[0][0] - entries[0][1][0][1]) < 1e-6
        eng.release(slot)
        slot, _ = eng.add_request([1, 2, 3], tengine.GenParams(max_new_tokens=3, logprobs=0))
        eng.release(slot)
        assert eng.take_logprobs(slot) is None


class TestSample:
    def test_matches_jax_sample(self):
        """B = 6, V = 300, 200 draws: greedy rows with the penalties and
        logit_bias, and sampled rows that top_k = 1 or top_p = 1e-6 make
        deterministic (with min-p and penalties on some): 0 of 1,200
        tokens differ from JAX's ``sample``."""
        b, v, draws = 6, 300, 200
        temperature = np.array([0.0, 0.0, 0.8, 1.0, 0.7, 1.2], np.float32)
        top_k = np.array([0, 0, 1, 0, 1, 0], np.int32)
        top_p = np.array([1.0, 1.0, 1.0, 1e-6, 0.9, 1e-6], np.float32)
        rep = np.array([1.3, 1.0, 1.0, 1.0, 1.2, 0.8], np.float32)
        pres = np.array([0.5, 0.0, 0.3, 0.0, 0.4, 0.0], np.float32)
        freq = np.array([0.3, 0.0, 0.0, 0.2, 0.1, 0.0], np.float32)
        min_p = np.array([0.0, 0.0, 0.0, 0.0, 0.1, 0.05], np.float32)
        jsample = jax.jit(jengine.sample)
        gens = [torch.Generator().manual_seed(i) if t > 0 else None for i, t in enumerate(temperature)]
        key_data = np.asarray(jax.vmap(lambda s: jax.random.key_data(jax.random.key(s)))(jnp.arange(b)))
        rng = np.random.default_rng(3)
        differ = 0
        for _ in range(draws):
            logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
            counts = rng.integers(0, 3, (b, v)).astype(np.int32)
            gen_counts = np.minimum(counts, rng.integers(0, 2, (b, v))).astype(np.int32)
            bias = np.zeros((b, v), np.float32)
            bias[[0, 1, 5], rng.integers(0, v, 3)] = 5.0
            bias[0, rng.integers(0, v, 20)] = -100.0
            jt, key_data = jsample(
                jnp.asarray(logits), jnp.asarray(key_data), jnp.asarray(temperature),
                jnp.asarray(top_p), jnp.asarray(top_k), jnp.asarray(rep), jnp.asarray(counts),
                jnp.asarray(pres), jnp.asarray(freq), jnp.asarray(gen_counts),
                jnp.asarray(bias), jnp.asarray(min_p),
            )
            tt = tengine.sample(
                torch.from_numpy(logits), gens, torch.from_numpy(temperature),
                torch.from_numpy(top_p), torch.from_numpy(top_k).long(), torch.from_numpy(rep),
                torch.from_numpy(counts), torch.from_numpy(pres), torch.from_numpy(freq),
                torch.from_numpy(gen_counts), torch.from_numpy(bias), torch.from_numpy(min_p),
            )
            differ += int((tt.numpy() != np.asarray(jt)).sum())
        assert differ == 0


# ---------------------------------------------------------------------------
# logprobs through the servers
# ---------------------------------------------------------------------------


class TestServerLogprobs:
    async def test_completions_logprobs_match_jax(self, engines):
        clients = await _clients(*engines)
        try:
            body = {"prompt": PROMPT, "max_tokens": 12, "logprobs": 3, "stop": STOP}
            (js, jb), (ts, tb) = await _both(clients, "/v1/completions", body)
            assert js == ts == 200
            jc, tc = jb["choices"][0], tb["choices"][0]
            assert tc["text"] == jc["text"] and tc["finish_reason"] == jc["finish_reason"] == "stop"
            assert STOP not in tc["text"] and tb["usage"] == jb["usage"]
            jl, tl = jc["logprobs"], tc["logprobs"]
            assert tl["tokens"] == jl["tokens"] and tl["text_offset"] == jl["text_offset"]
            assert len(tl["tokens"]) < tb["usage"]["completion_tokens"]  # cut at the stop
            _close_lists(tl["token_logprobs"], jl["token_logprobs"], "chosen")
            for g, w in zip(tl["top_logprobs"], jl["top_logprobs"]):
                assert list(g) == list(w)
                _close_lists(list(g.values()), list(w.values()), "alternatives")
        finally:
            await _close(clients)

    @pytest.mark.parametrize("stream", [False, True])
    async def test_chat_logprobs_match_jax(self, engines, stream):
        clients = await _clients(*engines)
        try:
            body = {"messages": [{"role": "user", "content": PROMPT}], "max_tokens": 10,
                    "logprobs": True, "top_logprobs": 2, "stop": STOP, "stream": stream}
            if not stream:
                (js, jb), (ts, tb) = await _both(clients, "/v1/chat/completions", body)
                assert js == ts == 200
                jc, tc = jb["choices"][0], tb["choices"][0]
                assert tc["message"] == jc["message"] and tc["finish_reason"] == jc["finish_reason"]
                assert all(len(e["top_logprobs"]) == 2 for e in tc["logprobs"]["content"])
                _same_chat_entries(tc["logprobs"]["content"], jc["logprobs"]["content"])
                return
            streams = []
            for c in clients:
                events = await _sse(await c.post("/v1/chat/completions", json=body))
                text = "".join(e["choices"][0]["delta"].get("content") or "" for e in events)
                entries = [x for e in events for x in (e["choices"][0].get("logprobs") or {}).get("content", [])]
                streams.append((text, events[-1]["choices"][0]["finish_reason"], entries))
            (jt, jf, je), (tt, tf, te) = streams
            assert (tt, tf) == (jt, jf)
            assert te  # one entry a delivered token
            _same_chat_entries(te, je)
        finally:
            await _close(clients)

    async def test_streamed_completion_carries_its_logprobs(self, engines):
        """The JAX server answers completions whole; the port's stream
        carries, chunk by chunk, a prefix of the arrays its whole answer
        has: a chunk takes the entries of the tokens consumed since the
        last one, so the tokens of text never delivered (here a trailing
        partial UTF-8 character) carry none, as in JAX's chat stream."""
        _, teng = engines
        client = TestClient(TestServer(tserver.build_app(teng, ByteTokenizer(), "tiny")))
        await client.start_server()
        try:
            body = {"prompt": PROMPT, "max_tokens": 8, "logprobs": 2}
            whole = (await (await client.post("/v1/completions", json=body)).json())["choices"][0]
            events = await _sse(await client.post("/v1/completions", json={**body, "stream": True}))
            arrays = [e["choices"][0]["logprobs"] for e in events if e["choices"][0].get("logprobs")]
            k = sum(len(a["tokens"]) for a in arrays)
            assert 0 < k <= len(whole["logprobs"]["tokens"])
            for key in ("tokens", "text_offset"):
                assert [x for a in arrays for x in a[key]] == whole["logprobs"][key][:k]
            _close_lists([x for a in arrays for x in a["token_logprobs"]],
                         whole["logprobs"]["token_logprobs"][:k], "streamed")
        finally:
            await client.close()


# ---------------------------------------------------------------------------
# n
# ---------------------------------------------------------------------------


class TestN:
    @pytest.mark.parametrize("path", ["/v1/completions", "/v1/chat/completions"])
    async def test_two_greedy_choices_match_jax(self, engines, path):
        clients = await _clients(*engines)
        try:
            body = {"max_tokens": 8, "n": 2}
            body.update({"prompt": PROMPT} if path == "/v1/completions"
                        else {"messages": [{"role": "user", "content": "Hi"}]})
            (js, jb), (ts, tb) = await _both(clients, path, body)
            assert js == ts == 200
            assert [c["index"] for c in tb["choices"]] == [0, 1]
            assert tb["choices"] == [{**c} for c in jb["choices"]]
            assert tb["choices"][0] == {**tb["choices"][1], "index": 0}
            assert tb["usage"] == jb["usage"]
        finally:
            await _close(clients)

    async def test_choice_i_is_the_request_with_seed_plus_i(self, engines):
        _, teng = engines
        client = TestClient(TestServer(tserver.build_app(teng, ByteTokenizer(), "tiny")))
        await client.start_server()
        try:
            body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.8, "seed": 7}
            fanned = await (await client.post("/v1/completions", json={**body, "n": 3})).json()
            single = []
            for i in range(3):
                r = await client.post("/v1/completions", json={**body, "seed": 7 + i})
                single.append((await r.json())["choices"][0]["text"])
            assert [c["text"] for c in fanned["choices"]] == single
            assert fanned["usage"]["completion_tokens"] == 24
        finally:
            await client.close()

    @pytest.mark.parametrize("body", [
        {"n": 2, "stream": True}, {"n": 9}, {"n": 0}, {"n": 1.5}, {"n": True},
    ])
    async def test_refusals_carry_jax_details(self, engines, body):
        clients = await _clients(*engines)
        try:
            for path, extra in (("/v1/completions", {"prompt": "x"}),
                                ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}]})):
                (js, jb), (ts, tb) = await _both(clients, path, {**extra, **body})
                assert js == ts == 400 and tb == jb
        finally:
            await _close(clients)


# ---------------------------------------------------------------------------
# tools, response_format, chat template
# ---------------------------------------------------------------------------

TOOL_TEXTS = [
    '<tool_call>{"name": "get_weather", "arguments": {"city": "Paris"}}</tool_call>',
    'Let me check. <tool_call>\n{"name": "f", "arguments": {"x": 1}}\n</tool_call> Done.',
    '<tool_call>{"name": "a", "arguments": {}}</tool_call><tool_call>{"name": "b", "arguments": "{\\"k\\": 2}"}</tool_call>',
    '{"name": "lookup", "parameters": {"q": "x"}}',
    '  {"name": "lookup", "arguments": {"q": "y"}}  ',
    "Just some prose, no call at all.",
    '<tool_call>{"name": "cut", "arguments": {"x": ',  # truncated block
    '<tool_call>{"name": "ok", "arguments": {}}</tool_call> <tool_call>{"name": "cut"',
    '<tool_call>{"arguments": {}}</tool_call>',  # no name
    '<tool_call>{not json}</tool_call>',
    '{"name": "x"}',  # no arguments
    '[1, 2]',
    "",
]
STREAM_TEXTS = [
    "plain prose", "prose then <tool", "prose then <tool_call>{", "  {\"name\"", "<", "a<t",
    "text <tool_call> more", "", "{", "no tag <tool_cal",
]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather in a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}},
}}]


def _without_ids(out):
    content, calls = out
    return content, None if calls is None else [{k: v for k, v in c.items() if k != "id"} for c in calls]


class TestTools:
    @pytest.mark.parametrize("text", TOOL_TEXTS)
    def test_parse_tool_calls_matches_jax(self, text):
        got = tserver._parse_tool_calls(text)
        assert _without_ids(got) == _without_ids(jserver._parse_tool_calls(text))
        if got[1] is not None:
            assert all(c["id"].startswith("call_") and len(c["id"]) == 29 for c in got[1])

    def test_tool_stream_safe_len_matches_jax(self):
        for text in STREAM_TEXTS + TOOL_TEXTS:
            assert tserver._tool_stream_safe_len(text) == jserver._tool_stream_safe_len(text), text

    @pytest.mark.parametrize("extra", [
        {"tool_choice": "required"},
        {"tool_choice": {"type": "function", "function": {"name": "get_weather"}}},
        {"response_format": {"type": "json_schema", "json_schema": {}}},
        {"response_format": {"type": "yaml"}},
        {"tools": "get_weather"},
        {"tools": [1, 2]},
        {"messages": [{"role": "assistant", "content": None}]},
        {"messages": [{"role": "user"}]},
        {"messages": []},
    ])
    async def test_refusals_carry_jax_details(self, engines, extra):
        clients = await _clients(*engines)
        try:
            body = {"messages": [{"role": "user", "content": "x"}], "tools": TOOLS, **extra}
            (js, jb), (ts, tb) = await _both(clients, "/v1/chat/completions", body)
            assert js == ts == 400 and tb == jb
        finally:
            await _close(clients)

    @pytest.mark.parametrize("extra", [
        {"tools": TOOLS, "messages": [
            {"role": "user", "content": "Weather in Paris?"},
            {"role": "assistant", "content": None, "tool_calls": [{
                "id": "call_1", "type": "function",
                "function": {"name": "get_weather", "arguments": "{\"city\": \"Paris\"}"}}]},
            {"role": "tool", "tool_call_id": "call_1", "content": "sunny"},
        ]},
        {"tools": TOOLS, "tool_choice": "none"},
        {"tools": TOOLS, "tool_choice": "auto", "stream": True},
        {"response_format": {"type": "json_object"}},
        {"response_format": {"type": "text"}},
    ])
    async def test_served_as_jax_serves_them(self, engines, extra):
        clients = await _clients(*engines)
        try:
            body = {"messages": [{"role": "user", "content": "Hello"}], "max_tokens": 6, **extra}
            if body.get("stream"):
                got = []
                for c in clients:
                    r = await c.post("/v1/chat/completions", json=body)
                    assert r.status == 200
                    events = await _sse(r)
                    got.append(("".join(e["choices"][0]["delta"].get("content") or "" for e in events),
                                events[-1]["choices"][0]["finish_reason"]))
                assert got[0] == got[1]
                return
            (js, jb), (ts, tb) = await _both(clients, "/v1/chat/completions", body)
            assert js == ts == 200
            assert tb["choices"] == jb["choices"] and tb["usage"] == jb["usage"]
        finally:
            await _close(clients)

    async def test_chat_template_override_matches_jax(self, engines):
        template = ("{% for m in messages %}{{ m['role'] }}: {{ m['content'] }}\n{% endfor %}"
                    "{% if tools %}tools: {{ tools | length }}\n{% endif %}assistant:")
        clients = await _clients(*engines, chat_template=template)
        try:
            body = {"messages": [{"role": "user", "content": "Hi"}], "max_tokens": 6, "tools": TOOLS}
            (js, jb), (ts, tb) = await _both(clients, "/v1/chat/completions", body)
            assert js == ts == 200 and tb["choices"] == jb["choices"] and tb["usage"] == jb["usage"]
            assert tb["usage"]["prompt_tokens"] == len("user: Hi\ntools: 1\nassistant:")
        finally:
            await _close(clients)


# ---------------------------------------------------------------------------
# /v1/embeddings and forward's gpt-oss repair
# ---------------------------------------------------------------------------

GEMMA_TINY = dict(
    vocab_size=512, hidden_size=128, n_heads=4, n_kv_heads=2, head_dim=256,
    intermediate_size=256, n_layers=4, sliding_window=24, max_seq_len=MAX_SEQ, remat=False,
)
GPT_OSS_TINY = dict(
    vocab_size=512, hidden_size=256, n_layers=4, n_heads=8, n_kv_heads=2, head_dim=64,
    intermediate_size=256, n_experts=4, experts_per_token=2, sliding_window=32,
    max_seq_len=MAX_SEQ, remat=False,
)
NORMS = {name: (0.0, 0.5) for name in ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm",
                                       "q_norm", "k_norm")}
GPT_OSS_NONZERO = {  # JAX's init leaves these 0, which would hide them
    "sinks": (0.0, 1.0), "b_router": (0.0, 0.5), "bq": (0.0, 0.05), "bk": (0.0, 0.05),
    "bv": (0.0, 0.05), "bo": (0.0, 0.02), "b_gate": (0.0, 0.05), "b_up_e": (0.0, 0.05),
    "b_down_e": (0.0, 0.02),
}


def _replace(name: str, **kw) -> tuple:
    return (dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32, **kw),
            dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32, **kw))


EMBED_MODELS = {  # case → (JAX config, port config, perturbed leaves)
    "llama": (JC, TC, {}),
    "gemma2": (*_replace("gemma-2-2b", attn_softcap=2.0, logit_softcap=0.5, **GEMMA_TINY), NORMS),
    "gemma3": (*_replace("gemma-3-4b", sliding_pattern=3, **GEMMA_TINY), NORMS),
    "mla_tiny": (jllama.MLA_TINY, tllama.MLA_TINY, {"router_bias": (0.0, 0.05)}),
    "gpt_oss": (*_replace("gpt-oss-20b", **GPT_OSS_TINY), GPT_OSS_NONZERO),
}
EMBED_INPUTS = ["a", "Hello, world.", "x" * 40, "The quick brown fox. " * 5]


class TestEmbeddings:
    @pytest.mark.parametrize("model", list(EMBED_MODELS))
    async def test_match_jax(self, model):
        jc, tc, perturb = EMBED_MODELS[model]
        jp, tp = _tiny_params(jc, tc, perturb)
        jeng = jengine.InferenceEngine(jc, jp, max_batch=1, max_seq=128, prefill_chunk=32)
        teng = tengine.InferenceEngine(tc, tp, max_batch=1, max_seq=128, prefill_chunk=32, device="cpu")
        clients = await _clients(jeng, teng)
        try:
            (js, jb), (ts, tb) = await _both(clients, "/v1/embeddings", {"input": EMBED_INPUTS})
            assert js == ts == 200
            assert tb["usage"] == jb["usage"] and tb["object"] == "list" and tb["model"] == "tiny"
            assert [d["index"] for d in tb["data"]] == list(range(len(EMBED_INPUTS)))
            for g, w in zip(tb["data"], jb["data"]):
                v = np.asarray(g["embedding"])
                assert v.shape == (tc.hidden_size,) and abs(np.linalg.norm(v) - 1.0) < 1e-5
                _close_lists(v, w["embedding"], f"{model} embedding {g['index']}")
            # a single string is a list of one
            (_, jb1), (_, tb1) = await _both(clients, "/v1/embeddings", {"input": EMBED_INPUTS[1]})
            _close_lists(tb1["data"][0]["embedding"], jb1["data"][0]["embedding"], "one string")
        finally:
            await _close(clients)

    @pytest.mark.parametrize("body", [
        {"input": "y" * 129}, {"input": ["ok", "z" * 200]}, {"input": []}, {"input": 5},
        {"input": ["a", 1]}, {},
    ])
    async def test_refusals_carry_jax_details(self, engines, body):
        jeng, teng = engines
        jeng.max_seq = teng.max_seq = 128  # the 400 names the engine's max_seq
        clients = await _clients(jeng, teng)
        try:
            (js, jb), (ts, tb) = await _both(clients, "/v1/embeddings", body)
            assert js == ts == 400 and tb == jb
        finally:
            jeng.max_seq = teng.max_seq = MAX_SEQ
            await _close(clients)

    async def test_never_run_beside_an_engine_call(self, monkeypatch):
        """Embeddings sent beside a completion: their forwards and the
        engine's prefill waves and steps run one at a time, so a count
        bumped as the kernels' wrappers bump theirs (read, then write
        later) loses no call, as ``/health``'s launch counts must not;
        each answer is the one it gets alone."""
        _, tp = _tiny_params(JC, TC)
        teng = tengine.InferenceEngine(TC, tp, max_batch=2, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                       device="cpu")
        count, calls = [0], []

        def racy(fn):
            def bumped(*args, **kw):
                calls.append(fn.__name__)
                n = count[0]
                time.sleep(0.002)
                count[0] = n + 1
                return fn(*args, **kw)
            return bumped

        monkeypatch.setattr(teng, "step", racy(teng.step))
        monkeypatch.setattr(teng, "prefill_wave", racy(teng.prefill_wave))
        monkeypatch.setattr(tserver, "embed_vectors", racy(tllama.embed_vectors))
        client = TestClient(TestServer(tserver.build_app(teng, ByteTokenizer(), "tiny")))
        await client.start_server()
        try:
            rs = await asyncio.gather(
                client.post("/v1/completions", json={"prompt": PROMPT, "max_tokens": 24}),
                *(client.post("/v1/embeddings", json={"input": EMBED_INPUTS}) for _ in range(4)),
            )
            bodies = [await r.json() for r in rs]
        finally:
            await client.close()
        assert [r.status for r in rs] == [200] * 5
        assert calls.count("embed_vectors") == 4 and calls.count("step") > 0
        assert count[0] == len(calls)
        want = tllama.embed_vectors(tp, TC, [list(t.encode()) for t in EMBED_INPUTS])
        for body in bodies[1:]:
            np.testing.assert_allclose([d["embedding"] for d in body["data"]], want.numpy(), atol=1e-6, rtol=0)

    def test_forward_runs_gpt_oss_without_autograd_only(self):
        """The repair: ``forward`` serves gpt-oss (sinks through K1 and
        ``sink_postscale``, biases, the clamped GLU, the top-k-softmax
        router) with autograd off, matching JAX's forward within 1e-4;
        under autograd (the name is from before it trained) the sinks take
        the masked attention, as JAX's training forward does, and match
        it too."""
        jc, tc, perturb = EMBED_MODELS["gpt_oss"]
        jp, tp = _tiny_params(jc, tc, perturb)
        tokens = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32)
        want = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jc))
        with torch.no_grad():
            got = tllama.forward(tp, torch.from_numpy(tokens).long(), tc)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        live = {**tp, "layers": {**tp["layers"], "sinks": tp["layers"]["sinks"].clone().requires_grad_()}}
        got = tllama.forward(live, torch.from_numpy(tokens).long(), tc)
        assert got.requires_grad
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# --weights
# ---------------------------------------------------------------------------

JC16 = dataclasses.replace(JC, dtype=jnp.bfloat16)
TC16 = dataclasses.replace(TC, dtype=torch.bfloat16)


def _jax_finetune_npz(path: Path, seed: int = 1) -> dict:
    """A bf16 tiny tree saved as the JAX fine-tune saves --full weights
    (dstack_tpu/train/finetune.py:405-418): '/'-joined paths, plus step
    → the tree as numpy."""
    host = jax.tree.map(np.asarray, jllama.init_params(JC16, jax.random.key(seed)))
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(host)}
    flat["step"] = np.asarray(5, np.int32)
    np.savez(path, **flat)
    return host


def _fresh16():
    return tllama.init_params(TC16, torch.Generator().manual_seed(0), device="cpu")


def _assert_trees_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


class TestWeights:
    def test_loads_the_jax_finetune_file(self, tmp_path):
        path = tmp_path / "model_weights.npz"
        host = _jax_finetune_npz(path)
        params = _fresh16()
        n = tllama.load_weights_npz(params, path)
        assert n == len(jax.tree_util.tree_leaves(host)) + 1  # the leaves and step
        _assert_trees_equal(params, tllama.params_from_jax(host, TC16, device="cpu"))

    def test_loads_the_jax_file_without_ml_dtypes(self, tmp_path):
        """The server process imports no JAX, so numpy loads JAX's bf16
        leaves as raw 2-byte values: the loader reads their bits."""
        path = tmp_path / "model_weights.npz"
        host = _jax_finetune_npz(path)
        script = (
            "import sys, torch\n"
            "from dstack_tpu_torch.models import llama\n"
            "from dstack_tpu_torch.models.llama import load_weights_npz\n"
            "c = llama.LLAMA_TINY_64.__class__(**{**llama.LLAMA_TINY_64.__dict__, 'dtype': torch.bfloat16})\n"
            "p = llama.init_params(c, torch.Generator().manual_seed(0), device='cpu')\n"
            f"load_weights_npz(p, {str(path)!r})\n"
            "assert 'ml_dtypes' not in sys.modules and 'jax' not in sys.modules\n"
            "torch.save(p, sys.argv[1])\n"
        )
        out = tmp_path / "loaded.pt"
        subprocess.run([sys.executable, "-c", script, str(out)], cwd=ROOT, check=True, timeout=120)
        _assert_trees_equal(torch.load(out), tllama.params_from_jax(host, TC16, device="cpu"))

    def test_loads_the_port_finetune_file(self, tmp_path):
        """The port's fine-tune writes bf16 leaves as f32
        (``finetune._flat``): they come back bit for bit."""
        src = tllama.init_params(TC16, torch.Generator().manual_seed(3), device="cpu")
        path = tmp_path / "model_weights.npz"
        np.savez(path, **tfinetune._flat(src), step=np.asarray(2, np.int32))
        params = _fresh16()
        tllama.load_weights_npz(params, path)
        _assert_trees_equal(params, src)

    def test_refuses_a_lora_file_with_jax_message(self, tmp_path):
        path = tmp_path / "lora_adapters.npz"
        np.savez(path, **{"layers.wq_lora_a": np.zeros((2, 128, 4), np.float32)})
        with pytest.raises(SystemExit) as want:
            jserver.main(["--model", "llama-tiny", "--weights", str(path), "--platform", "cpu",
                          "--tp", "1"])
        with pytest.raises(SystemExit) as got:
            tllama.load_weights_npz(_fresh16(), str(path))
        assert str(got.value) == str(want.value) and "LoRA adapter" in str(got.value)

    def test_refuses_a_misshapen_leaf(self, tmp_path):
        path = tmp_path / "model_weights.npz"
        np.savez(path, **{"layers/wq": np.zeros((1, 128, 128), np.float32)})
        with pytest.raises(ValueError, match="layers/wq"):
            tllama.load_weights_npz(_fresh16(), path)


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


class TestWarmup:
    def _engine(self):
        params = tllama.init_params(TC, torch.Generator().manual_seed(0), device="cpu")
        return tengine.InferenceEngine(
            TC, params, max_batch=2, max_seq=MAX_SEQ, prefill_chunk=CHUNK, prefill_pack=2,
            spec_draft=3, turbo_steps=4, device="cpu",
        )

    def test_leaves_nothing_behind(self):
        """Every slot free, spec_draft restored, the prefix registry
        empty; the warmup ran the turbo and packed paths; greedy, seeded
        and unseeded generate after it equal a fresh engine's."""
        warm, fresh = self._engine(), self._engine()
        seconds = tserver._warmup_engine(warm)
        assert seconds > 0 and warm.free_slots() == [0, 1] and warm.spec_draft == 3
        assert warm.prefix_stats()["prefix_slots"] == 0 and not warm._prefilling
        st = warm.stats
        assert st["turbo_dispatches"] >= 1 and st["packed_dispatches"] >= 1 and st["decode_steps"] >= 1
        assert not warm._seen.any() and not warm._gen_counts.any()
        tok = ByteTokenizer()
        for gen in (
            tengine.GenParams(max_new_tokens=10),
            tengine.GenParams(max_new_tokens=10, temperature=0.9, seed=11),
            tengine.GenParams(max_new_tokens=10, temperature=0.9),
            tengine.GenParams(max_new_tokens=10, logprobs=1),
        ):
            outs = [e.generate(tok.encode(PROMPT), dataclasses.replace(gen)) for e in (warm, fresh)]
            assert outs[0] == outs[1], gen

    async def test_a_warmed_server_answers_as_a_cold_one(self):
        """The same requests to a server over a warmed engine and one
        over a fresh engine: the same answers."""
        warm, fresh = self._engine(), self._engine()
        tserver._warmup_engine(warm)
        answers = []
        for eng in (warm, fresh):
            client = TestClient(TestServer(tserver.build_app(eng, ByteTokenizer(), "tiny")))
            await client.start_server()
            try:
                rs = await asyncio.gather(*(
                    client.post("/v1/completions", json={"prompt": p, "max_tokens": 6, **kw})
                    for p, kw in ((PROMPT, {}), ("abc", {"temperature": 0.7, "seed": 3}),
                                  ("x" * 70, {"n": 2}))
                ))
                answers.append([[c["text"] for c in (await r.json())["choices"]] for r in rs])
            finally:
                await client.close()
        assert answers[0] == answers[1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestEmbeddingsOnTheCard:
    @pytest.mark.parametrize("model", ["llama", "gemma2", "gemma3", "gpt_oss"])
    def test_kernel_path_matches_the_plain_path(self, cuda, model):
        """``embed_vectors`` in bf16 through K1 (with the sink rescale on
        gpt-oss: the whole forward's q/k/v are strided views) against
        the plain path, within bf16's 2e-2, at padded lengths 16 to 256."""
        _, tc, perturb = EMBED_MODELS[model]
        _, tp = _tiny_params(EMBED_MODELS[model][0], tc, perturb)
        c16 = dataclasses.replace(tc, dtype=torch.bfloat16)
        params = tllama.params_from_jax(
            jax.tree.map(lambda t: t.float().numpy(), tp), c16, device=cuda
        )
        ids = [list(t.encode()) for t in EMBED_INPUTS + ["y" * 200]]
        got = tllama.embed_vectors(params, c16, ids)
        want = tllama.embed_vectors(params, c16, ids, impl="plain")
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
