"""The port's OpenAI server on the CPU, at the engine's defaults (packed
prefill, speculative verify, turbo macro-steps, the prefix cache),
answers with the same tokens as the engine's ``generate`` for the same
weights and prompt: completions whole and streamed, chat completions
whole and streamed; with ``kv_quant="int8"`` too. ``/health`` carries the
engine's configuration and path counts."""

import json

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu_torch.models import llama
from dstack_tpu_torch.serve.chat_template import render_chat
from dstack_tpu_torch.serve.engine import GenParams, InferenceEngine
from dstack_tpu_torch.serve.openai_server import build_app
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer

CONFIG = llama.LLAMA_TINY_64


def _engine(kv_quant=None):
    params = llama.init_params(CONFIG, torch.Generator().manual_seed(0), device="cpu")
    return InferenceEngine(
        CONFIG, params, max_batch=4, max_seq=256, prefill_chunk=64, kv_quant=kv_quant,
        device="cpu",
    )


def _expected(prompt: str, n: int, streamed: bool = False, kv_quant=None) -> str:
    """generate()'s tokens as the server renders them: a stream holds
    back a trailing partial UTF-8 character it never completes."""
    tok = ByteTokenizer()
    ids = _engine(kv_quant).generate(
        tok.encode(prompt), GenParams(max_new_tokens=n, eos_id=tok.eos_id)
    )
    text = tok.decode([i for i in ids if i != tok.eos_id])
    return text.rstrip("\ufffd") if streamed else text


async def _client(kv_quant=None):
    client = TestClient(TestServer(build_app(_engine(kv_quant), ByteTokenizer(), "llama-tiny-64")))
    await client.start_server()
    return client


async def _sse(resp) -> list:
    events = []
    async for raw in resp.content:
        line = raw.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            events.append(json.loads(line[len("data: "):]))
    return events


PROMPT = "The quick brown fox jumps over the lazy dog, then " * 2  # > one chunk


class TestOpenAIServer:
    async def test_health_and_models(self):
        client = await _client()
        try:
            h = await (await client.get("/health")).json()
            assert h["status"] == "ok" and h["max_slots"] == 4
            assert h["device"] == "cpu" and h["decode_kernel"] == "flash"
            assert h["stats"]["decode_steps"] == 0
            assert set(h["kernel_launches"]) == {"flash_fwd", "flash_fwd_mla", "flash_decode", "w8_matmul"}
            assert h["w8_matmul_launches"] == {"proj": 0, "head": 0, "experts": 0}
            assert h["engine"] == {
                "prefill_pack": 4, "spec_draft": 4, "turbo_steps": 8, "turbo_depth": 1,
                "prefix_cache": True, "kv_quant": None,
            }
            assert set(h["flash_decode_launches"]) == {
                "bf16_decode", "bf16_verify", "int8_decode", "int8_verify",
                "bf16_decode_sinks", "bf16_verify_sinks", "int8_decode_sinks", "int8_verify_sinks",
            }
            assert h["prefix_hits"] == 0 and h["kv_utilization"] == 0.0
            m = await (await client.get("/v1/models")).json()
            assert m["data"][0]["id"] == "llama-tiny-64"
        finally:
            await client.close()

    async def test_completions_whole_matches_generate(self):
        client = await _client()
        try:
            r = await client.post("/v1/completions", json={"prompt": PROMPT, "max_tokens": 12})
            assert r.status == 200
            body = await r.json()
            assert body["choices"][0]["text"] == _expected(PROMPT, 12)
            assert body["usage"]["prompt_tokens"] == len(PROMPT)
            assert 1 <= body["usage"]["completion_tokens"] <= 12
            h = await (await client.get("/health")).json()
            assert h["stats"]["prefill_dispatches"] == 2  # 101 tokens, 64-token chunks
        finally:
            await client.close()

    async def test_completions_streamed_matches_generate(self):
        client = await _client()
        try:
            r = await client.post(
                "/v1/completions", json={"prompt": PROMPT, "max_tokens": 12, "stream": True}
            )
            events = await _sse(r)
            text = "".join(e["choices"][0]["text"] for e in events)
            assert text == _expected(PROMPT, 12, streamed=True)
            assert events[-1]["choices"][0]["finish_reason"] in ("length", "stop")
        finally:
            await client.close()

    async def test_chat_whole_and_streamed_match_generate(self):
        messages = [{"role": "user", "content": "Say something."}]
        want = _expected(render_chat(messages), 10)
        want_streamed = _expected(render_chat(messages), 10, streamed=True)
        client = await _client()
        try:
            r = await client.post("/v1/chat/completions", json={"messages": messages, "max_tokens": 10})
            body = await r.json()
            assert body["choices"][0]["message"]["content"] == want
            r = await client.post(
                "/v1/chat/completions",
                json={"messages": messages, "max_tokens": 10, "stream": True},
            )
            events = await _sse(r)
            text = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
            assert text == want_streamed
        finally:
            await client.close()

    async def test_concurrent_requests_each_match_generate(self):
        import asyncio

        prompts = ["alpha " * 3, "beta " * 30, "gamma"]
        client = await _client()
        try:
            rs = await asyncio.gather(*(
                client.post("/v1/completions", json={"prompt": p, "max_tokens": 8})
                for p in prompts
            ))
            texts = [(await r.json())["choices"][0]["text"] for r in rs]
            assert texts == [_expected(p, 8) for p in prompts]
        finally:
            await client.close()

    @pytest.mark.parametrize("kv_quant", [None, "int8"])
    async def test_default_path_counts_on_health(self, kv_quant):
        """Four concurrent completions and one stream at the defaults: a
        packed wave and turbo steps run, every answer matches generate(),
        and a repeat of the long prompt hits the prefix cache."""
        import asyncio

        prompts = ["alpha " * 3, "beta " * 30, "gamma", PROMPT]
        client = await _client(kv_quant)
        try:
            rs = await asyncio.gather(*(
                client.post("/v1/completions", json={"prompt": p, "max_tokens": 8})
                for p in prompts
            ))
            texts = [(await r.json())["choices"][0]["text"] for r in rs]
            assert texts == [_expected(p, 8, kv_quant=kv_quant) for p in prompts]
            r = await client.post(
                "/v1/completions", json={"prompt": PROMPT + "again", "max_tokens": 8, "stream": True}
            )
            events = await _sse(r)
            text = "".join(e["choices"][0]["text"] for e in events)
            assert text == _expected(PROMPT + "again", 8, streamed=True, kv_quant=kv_quant)
            h = await (await client.get("/health")).json()
            st = h["stats"]
            assert h["engine"]["kv_quant"] == kv_quant
            assert st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1
            assert h["prefix_hits"] == st["prefix_hits"] == 1 and h["prefix_slots"] >= 1
            # the plain versions run on the CPU: no kernel launches
            assert not any(h["flash_decode_launches"].values())
        finally:
            await client.close()

    @pytest.mark.parametrize("stream", [False, True])
    async def test_stop_string_truncates(self, stream):
        full = _expected(PROMPT, 12, streamed=True)
        assert len(full) >= 4
        stop = full[2:4]
        want = full[: full.find(stop)]
        client = await _client()
        try:
            r = await client.post(
                "/v1/completions",
                json={"prompt": PROMPT, "max_tokens": 12, "stop": stop, "stream": stream},
            )
            if stream:
                events = await _sse(r)
                text = "".join(e["choices"][0]["text"] for e in events)
                finish = events[-1]["choices"][0]["finish_reason"]
            else:
                choice = (await r.json())["choices"][0]
                text, finish = choice["text"], choice["finish_reason"]
            assert (text, finish) == (want, "stop")
        finally:
            await client.close()

    @pytest.mark.parametrize(
        "extra", [{"n": 2, "stream": True}, {"n": 9}, {"n": True}]
    )
    async def test_unported_options_are_refused(self, extra):
        """``n``, logprobs and tools are served now (held to the JAX
        server in test_torch_server_features.py); what the JAX server
        refuses stays refused: streaming with n > 1, n outside [1, 8]."""
        client = await _client()
        try:
            r = await client.post("/v1/completions", json={"prompt": "x", **extra})
            assert r.status == 400
        finally:
            await client.close()
