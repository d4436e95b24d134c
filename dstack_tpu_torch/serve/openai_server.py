"""OpenAI-compatible inference server over the PyTorch engine
(counterpart of dstack_tpu.serve.openai_server).

``python -m dstack_tpu_torch.serve.openai_server --model llama-3.2-1b``
serves random weights drawn from ``--seed`` on the card (``--device
cuda``, the default) with the byte tokenizer; ``--hf-model DIR`` serves a
``save_pretrained`` checkpoint of the llama, gemma, gemma2 or gemma3
model types instead (config and weights from the directory, the model
named after it), still with the byte tokenizer: an HF tokenizer needs the
``tokenizers`` package, which the port does not depend on yet.

Endpoints: ``/health``, ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions``, whole and streamed (SSE). One scheduler task
admits requests into engine slots, runs one prefill wave and one engine
step per tick on a worker thread, and routes tokens to each request with
eos, ``max_tokens`` and stop strings. The engine runs the JAX server's
defaults: ``--prefill-pack 4``, ``--spec-draft 4``, ``--turbo-steps 8``
and the prefix cache; ``--kv-quant int8`` halves the cache.

Not in this slice (each answers 400 when asked for): ``n > 1``, token
logprobs, tools and ``response_format``. QoS, tracing, SLO windows, the
flight and boot recorders, fault points, embeddings and ``/metrics``
come with later slices.
"""

import argparse
import asyncio
import collections
import json
import time
import uuid
from pathlib import Path
from typing import Optional

from aiohttp import web

from dstack_tpu_torch.ops import flash, flash_decode
from dstack_tpu_torch.serve.chat_template import ChatTemplateError, render_chat
from dstack_tpu_torch.serve.engine import GenParams, InferenceEngine
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.openai")


class _Request:
    def __init__(self, prompt_ids: list[int], gen: GenParams):
        self.prompt_ids = prompt_ids
        self.gen = gen
        self.queue: asyncio.Queue = asyncio.Queue()  # token ids, then None
        self.error: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.cancelled = False
        self.gen_ids: list[int] = []  # for stop-string matching


class Scheduler:
    """Bridges HTTP handlers and the synchronous engine: a background
    task admits pending requests (FIFO) into free slots, advances one
    prefill chunk per tick, and steps the engine while anything is
    active. Engine calls run on a worker thread so the event loop keeps
    serving."""

    def __init__(self, engine: InferenceEngine, tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer
        self.pending: collections.deque = collections.deque()
        self._wake = asyncio.Event()
        self.by_slot: dict[int, _Request] = {}
        self.by_prefill: dict[int, _Request] = {}  # chunked prefills in flight
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def submit(self, req: _Request) -> None:
        self.pending.append(req)
        self._wake.set()

    def cancel(self, req: _Request) -> None:
        """Client went away (or the request finished): free its slot so
        decode stops burning steps on it."""
        req.cancelled = True
        for table in (self.by_slot, self.by_prefill):
            for slot, r in list(table.items()):
                if r is req:
                    self.engine.release(slot)
                    del table[slot]

    def _fail(self, req: _Request, error: str) -> None:
        req.error = error
        req.queue.put_nowait(None)

    async def _loop(self) -> None:
        # the loop must survive any engine error: fail the affected
        # requests and keep serving
        while True:
            try:
                await self._tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - reported per request
                logger.exception("scheduler tick failed: %s", e)
                for slot, req in list(self.by_slot.items()):
                    self.engine.release(slot)
                    self._fail(req, str(e))
                self.by_slot.clear()

    def _hit_stop(self, req: _Request, tok: int) -> bool:
        """Track generated ids; True once a stop string appears in the
        decoded tail (bounded: a char spans up to 4 byte tokens)."""
        req.gen_ids.append(tok)
        if not req.gen.stop:
            return False
        keep = 4 * max(len(t) for t in req.gen.stop) + 8
        text = self.tokenizer.decode(req.gen_ids[-keep:])
        return any(t in text for t in req.gen.stop)

    def _deliver(self, slot: int, req: _Request, tok: int) -> bool:
        """Queue one token to the client; True when a stop string ended
        the request (its slot is then released)."""
        req.queue.put_nowait(tok)
        if self._hit_stop(req, tok):
            self.engine.release(slot)
            req.finish_reason = "stop"
            req.queue.put_nowait(None)
            return True
        return False

    async def _tick(self) -> None:
        free = len(self.engine.free_slots())
        while free and self.pending:
            req = self.pending.popleft()
            if req.cancelled:
                continue
            try:
                slot = self.engine.start_request(req.prompt_ids, req.gen)
            except Exception as e:  # noqa: BLE001 - reported per request
                logger.exception("admission failed: %s", e)
                self._fail(req, str(e))
                continue
            self.by_prefill[slot] = req
            free -= 1
        # a request still waiting for a slot is arrival pressure: the
        # engine keeps its macro-steps short so that request soon gets one
        self.engine.waiting_requests = int(any(not r.cancelled for r in self.pending))
        for slot in [s for s, r in self.by_prefill.items() if r.cancelled]:
            self.engine.release(slot)
            del self.by_prefill[slot]
        if self.by_prefill:
            # ONE prefill wave per tick (a chunk of up to prefill_pack
            # prompts), so decode steps for running slots interleave
            # between the chunks of a long prompt
            try:
                firsts = await asyncio.to_thread(self.engine.prefill_wave)
            except Exception as e:  # noqa: BLE001 - reported per request
                logger.exception("prefill failed: %s", e)
                for slot in self.engine.last_wave_slots:
                    req = self.by_prefill.pop(slot, None)
                    if req is not None:
                        self.engine.release(slot)
                        self._fail(req, str(e))
                return
            for slot, first in firsts.items():
                req = self.by_prefill.pop(slot, None)
                if req is None or req.cancelled:
                    self.engine.release(slot)
                    continue
                if first != req.gen.eos_id and self._deliver(slot, req, first):
                    continue
                if self.engine.active[slot]:
                    self.by_slot[slot] = req
                else:
                    req.finish_reason = self.engine.finish_reason[slot]
                    req.queue.put_nowait(None)
        if not self.by_slot:
            if self.by_prefill:
                return  # keep chunking
            self._wake.clear()
            if not self.pending:
                await self._wake.wait()
            return
        out = await asyncio.to_thread(self.engine.step)
        for slot, toks in out.items():
            req = self.by_slot.get(slot)
            if req is None:
                continue
            stopped = False
            for tok in toks:
                if tok == req.gen.eos_id:
                    continue
                if self._deliver(slot, req, tok):
                    del self.by_slot[slot]
                    stopped = True
                    break
            if not stopped and not self.engine.active[slot]:
                req.finish_reason = self.engine.finish_reason[slot]
                req.queue.put_nowait(None)
                del self.by_slot[slot]
        await asyncio.sleep(0)


def _truncate_stop(text: str, stop) -> str:
    """Cut the completion at the first stop-string occurrence."""
    if not stop:
        return text
    cut = len(text)
    for t in stop:
        i = text.find(t)
        if i != -1:
            cut = min(cut, i)
    return text[:cut]


def _stop_holdback(text: str, stop) -> int:
    """Chars to withhold from streaming: the longest trailing substring
    of ``text`` that is a proper prefix of some stop string (OpenAI
    streams never deliver any part of a stop sequence)."""
    if not stop:
        return 0
    hold = 0
    for t in stop:
        for p in range(min(len(t) - 1, len(text)), 0, -1):
            if text.endswith(t[:p]):
                hold = max(hold, p)
                break
    return hold


def _gen_params(payload: dict, tokenizer) -> GenParams:
    stop = payload.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    elif not (isinstance(stop, list) and all(isinstance(s, str) for s in stop)):
        stop = None
    if stop:  # an empty string would match every completion immediately
        stop = [s for s in stop if s]
    seed = payload.get("seed")
    return GenParams(
        max_new_tokens=int(payload.get("max_tokens") or 256),
        temperature=float(payload.get("temperature") or 0.0),
        top_p=float(payload.get("top_p") or 1.0),
        top_k=int(payload.get("top_k") or 0),
        repetition_penalty=float(payload.get("repetition_penalty") or 1.0),
        presence_penalty=float(payload.get("presence_penalty") or 0.0),
        frequency_penalty=float(payload.get("frequency_penalty") or 0.0),
        min_p=float(payload.get("min_p") or 0.0),
        logit_bias=(
            {int(k): max(-100.0, min(100.0, float(v)))
             for k, v in payload["logit_bias"].items()}
            if isinstance(payload.get("logit_bias"), dict) and payload["logit_bias"]
            else None
        ),
        seed=int(seed) if seed is not None else None,
        eos_id=tokenizer.eos_id,
        stop=stop or None,
    )


def _bad_request(payload: dict) -> Optional[str]:
    """Validate what can't be coerced, and refuse what this slice does
    not serve yet → error string for a 400, or None."""
    mp = payload.get("min_p")
    if mp is not None:
        try:
            mp = float(mp)
        except (TypeError, ValueError):
            return "'min_p' must be a number"
        if not 0.0 <= mp <= 1.0:
            return "'min_p' must be in [0, 1]"
    lb = payload.get("logit_bias")
    if lb is not None:
        if not isinstance(lb, dict):
            return "'logit_bias' must be an object of {token_id: bias}"
        for k, v in lb.items():
            try:
                int(k)
                float(v)
            except (TypeError, ValueError):
                return f"'logit_bias' entry {k!r} is not numeric"
    if payload.get("n") not in (None, 1):
        return "'n' > 1 is not served by this port yet"
    if payload.get("logprobs") not in (None, False):
        return "'logprobs' is not served by this port yet"
    if payload.get("tools") or payload.get("response_format"):
        return "'tools' and 'response_format' are not served by this port yet"
    return None


def _valid_chat_message(m) -> bool:
    return isinstance(m, dict) and isinstance(m.get("content"), str)


def build_app(engine: InferenceEngine, tokenizer, model_name: str) -> web.Application:
    app = web.Application()
    sched = Scheduler(engine, tokenizer)

    async def on_startup(_):
        sched.start()

    async def on_cleanup(_):
        await sched.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    async def health(request):
        """Liveness, load, the engine's configuration, and the counts a
        run reads to show which path it took: prefill chunks and packed
        waves, plain, speculative and turbo steps, prefix hits, and each
        hand-written kernel's launches in this process (K4's also by
        variant)."""
        e = sched.engine
        return web.json_response({
            "status": "ok",
            "model": model_name,
            "device": str(e.device),
            "decode_kernel": e.decode_kernel,
            "engine": {
                "prefill_pack": e.prefill_pack,
                "spec_draft": e.spec_draft,
                "turbo_steps": e.turbo_steps,
                "turbo_depth": e.turbo_depth,
                "prefix_cache": e.prefix_cache,
                "kv_quant": e.kv_quant,
            },
            "queue_depth": len(sched.pending),
            "inflight": len(sched.by_slot) + len(sched.by_prefill),
            "active_slots": sum(1 for a in e.active if a),
            "max_slots": e.max_batch,
            "kv_cache_utilization": e.kv_cache_utilization(),
            **e.prefix_stats(),
            "stats": dict(e.stats),
            "kernel_launches": {
                "flash_fwd": flash.LAUNCHES,
                "flash_fwd_mla": flash.LAUNCHES_MLA,
                "flash_decode": flash_decode.LAUNCHES,
            },
            "flash_decode_launches": dict(flash_decode.LAUNCHES_BY_VARIANT),
        })

    async def models(request):
        return web.json_response({
            "object": "list",
            "data": [{"id": model_name, "object": "model", "owned_by": "dstack-tpu"}],
        })

    async def _submit(prompt: str, payload: dict) -> _Request:
        req = _Request(tokenizer.encode(prompt), _gen_params(payload, tokenizer))
        await sched.submit(req)
        return req

    def _emittable(req: _Request, ids: list, final: bool = False) -> str:
        """Streamed text safe to deliver: re-decoded from all ids
        (per-token decode would split multi-byte UTF-8), trailing
        replacement chars and, until the end, any stop-string prefix
        held back."""
        full = tokenizer.decode(ids)
        while full.endswith("\ufffd"):
            full = full[:-1]
        full = _truncate_stop(full, req.gen.stop)
        if final:
            return full
        return full[: len(full) - _stop_holdback(full, req.gen.stop)]

    def _whole_text(req: _Request, ids: list) -> str:
        return _truncate_stop(tokenizer.decode(ids), req.gen.stop)

    async def _stream(request, req: _Request, chunk_of) -> web.StreamResponse:
        """SSE: one chunk per delivered delta, then a finish chunk and
        ``[DONE]``. ``chunk_of(delta, finish_reason)`` shapes a chunk."""
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)

        async def send(obj) -> None:
            await resp.write(b"data: " + json.dumps(obj).encode() + b"\n\n")

        ids: list[int] = []
        sent = ""
        try:
            while True:
                tok = await req.queue.get()
                if tok is None:
                    break
                ids.append(tok)
                out = _emittable(req, ids)
                if len(out) > len(sent):
                    await send(chunk_of(out[len(sent):], None))
                    sent = out
            tail = _emittable(req, ids, final=True)[len(sent):]
            if tail:
                await send(chunk_of(tail, None))
        finally:
            sched.cancel(req)  # no-op when finished; frees the slot on disconnect
        if req.error:
            await send({"error": req.error})
        else:
            await send(chunk_of(None, req.finish_reason or "stop"))
        await resp.write(b"data: [DONE]\n\n")
        return resp

    async def _collect(req: _Request) -> list:
        ids = []
        try:
            while True:
                tok = await req.queue.get()
                if tok is None:
                    break
                ids.append(tok)
        finally:
            sched.cancel(req)
        return ids

    async def _read_payload(request):
        try:
            payload = await request.json()
        except Exception:  # noqa: BLE001 - any malformed body is a 400
            return None, web.json_response({"detail": "invalid JSON body"}, status=400)
        if not isinstance(payload, dict):
            return None, web.json_response({"detail": "JSON object expected"}, status=400)
        bad = _bad_request(payload)
        if bad:
            return None, web.json_response({"detail": bad}, status=400)
        return payload, None

    def _usage(req: _Request, n_completion: int) -> dict:
        n_prompt = len(req.prompt_ids)
        return {
            "prompt_tokens": n_prompt,
            "completion_tokens": n_completion,
            "total_tokens": n_prompt + n_completion,
        }

    async def completions(request):
        payload, err = await _read_payload(request)
        if err is not None:
            return err
        prompt = payload.get("prompt")
        if not isinstance(prompt, str):
            return web.json_response({"detail": "'prompt' required"}, status=400)
        req = await _submit(prompt, payload)
        cid = f"cmpl-{uuid.uuid4().hex}"
        created = int(time.time())

        def chunk_of(delta, finish):
            return {
                "id": cid, "object": "text_completion", "created": created,
                "model": model_name,
                "choices": [{"index": 0, "text": delta or "", "finish_reason": finish}],
            }

        if payload.get("stream"):
            return await _stream(request, req, chunk_of)
        ids = await _collect(req)
        if req.error:
            return web.json_response({"detail": req.error}, status=500)
        body = chunk_of(_whole_text(req, ids), req.finish_reason or "stop")
        body["usage"] = _usage(req, len(ids))
        return web.json_response(body)

    async def chat_completions(request):
        payload, err = await _read_payload(request)
        if err is not None:
            return err
        messages = payload.get("messages")
        if not isinstance(messages, list) or not messages or not all(
            _valid_chat_message(m) for m in messages
        ):
            return web.json_response(
                {"detail": "'messages' must be [{role, content}, ...]"}, status=400
            )
        try:
            prompt = render_chat(messages)
        except ChatTemplateError as e:
            return web.json_response({"detail": str(e)}, status=e.status)
        req = await _submit(prompt, payload)
        cid = f"chatcmpl-{uuid.uuid4().hex}"
        created = int(time.time())

        def chunk_of(delta, finish):
            return {
                "id": cid, "object": "chat.completion.chunk", "created": created,
                "model": model_name,
                "choices": [{
                    "index": 0,
                    "delta": {} if delta is None else {"role": "assistant", "content": delta},
                    "finish_reason": finish,
                }],
            }

        if payload.get("stream"):
            return await _stream(request, req, chunk_of)
        ids = await _collect(req)
        if req.error:
            return web.json_response({"detail": req.error}, status=500)
        return web.json_response({
            "id": cid, "object": "chat.completion", "created": created,
            "model": model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": _whole_text(req, ids)},
                "finish_reason": req.finish_reason or "stop",
            }],
            "usage": _usage(req, len(ids)),
        })

    app.router.add_get("/health", health)
    app.router.add_get("/v1/models", models)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/chat/completions", chat_completions)
    return app


def main(argv=None) -> int:
    import torch

    from dstack_tpu_torch.models import llama
    from dstack_tpu_torch.models.convert_hf import load_checkpoint
    from dstack_tpu_torch.ops import cuda_build
    from dstack_tpu_torch.serve.engine import resolve_device
    from dstack_tpu_torch.utils.logging import configure_logging

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="llama-3.2-1b", choices=sorted(llama.CONFIGS))
    p.add_argument(
        "--hf-model", default=None,
        help="HF save_pretrained dir (llama/gemma/gemma2/gemma3): loads the "
             "config and weights, overrides --model and --seed",
    )
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--prefill-chunk", type=int, default=256)
    p.add_argument(
        "--prefill-pack", type=int, default=4,
        help="max concurrent prompt chunks packed into one prefill dispatch "
             "(floored to a power of two; 0/1 = serial per-prompt prefill)",
    )
    p.add_argument(
        "--spec-draft", type=int, default=4,
        help="prompt-lookup speculative decoding draft length for greedy "
             "requests (0 disables)",
    )
    p.add_argument(
        "--turbo-steps", type=int, default=8,
        help="device-side decode steps per host round trip for all-greedy "
             "batches (0/1 disables)",
    )
    p.add_argument(
        "--turbo-depth", type=int, default=1,
        help="macro-steps chained per host round trip once the adaptive "
             "turbo cap is fully open",
    )
    p.add_argument(
        "--no-prefix-cache", action="store_true",
        help="disable automatic prefix caching (KV-row reuse across "
             "requests sharing a chunk-aligned prompt prefix)",
    )
    p.add_argument(
        "--kv-quant", default=None, choices=["int8"],
        help="int8 KV cache with per-(token, head) f32 scales: half the "
             "cache bytes a decode step reads",
    )
    p.add_argument(
        "--decode-kernel", default="flash", choices=["flash", "einsum"],
        help="decode attention: the ragged flash-decode kernel, or the "
             "plain masked attention over the whole row (reference)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = p.parse_args(argv)
    configure_logging()

    device = resolve_device(args.device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        cuda_build.build_all()
        logger.info("kernels ready in %.1fs", time.perf_counter() - t0)
    if args.hf_model:
        t0 = time.perf_counter()
        config, params = load_checkpoint(args.hf_model, device=device)
        args.model = Path(args.hf_model).resolve().name
        logger.info(
            "loaded HF checkpoint %s (%.2fB params) in %.1fs; tokenizer: byte (an HF "
            "tokenizer comes with the text corpora, ROADMAP A3)",
            args.hf_model, config.num_params() / 1e9, time.perf_counter() - t0,
        )
    else:
        config = llama.CONFIGS[args.model]
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed)
        params = llama.init_params(config, generator, device=device)
    engine = InferenceEngine(
        config, params, max_batch=args.max_batch, max_seq=args.max_seq,
        seed=args.seed, prefill_chunk=args.prefill_chunk, prefill_pack=args.prefill_pack,
        spec_draft=args.spec_draft, turbo_steps=args.turbo_steps, turbo_depth=args.turbo_depth,
        prefix_cache=not args.no_prefix_cache, kv_quant=args.kv_quant,
        decode_kernel=args.decode_kernel, device=device,
    )
    app = build_app(engine, ByteTokenizer(), args.model)
    logger.info("openai server: %s on %s, :%d", args.model, device, args.port)
    web.run_app(app, host="0.0.0.0", port=args.port, print=None)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
