"""OpenAI-compatible inference server over the PyTorch engine
(counterpart of dstack_tpu.serve.openai_server).

``python -m dstack_tpu_torch.serve.openai_server --model llama-3.2-1b``
serves random weights drawn from ``--seed`` on the card (``--device
cuda``, the default) with the byte tokenizer; ``--weights FILE`` overlays
a fine-tune's ``model_weights.npz`` (the port's or the JAX package's);
``--hf-model DIR`` serves a ``save_pretrained`` checkpoint of a model
type ``models/convert_hf.py`` loads (llama, the Gemma types, qwen2,
qwen3, qwen3_moe, mixtral, gpt_oss, mistral, phi3, granite, starcoder2,
nemotron, cohere, cohere2, olmo2, glm, glm4, llama4, llama4_text,
deepseek_v2, deepseek_v3) instead (config and weights from the directory, the model named
after it), still with the byte tokenizer: an
HF tokenizer needs the ``tokenizers`` package, which the port does not
depend on yet. ``--chat-template`` overrides the Llama-3-style default.

Endpoints: ``/health``, ``/metrics`` (the engine's ``dtpu_serve_*``
registry in Prometheus text, byte for byte as the JAX server renders
it), ``/v1/models``, ``/v1/completions`` and ``/v1/chat/completions``,
whole and streamed (SSE), and ``/v1/embeddings``. One scheduler task
admits requests into engine slots, runs one prefill wave and one engine
step per tick on a worker thread,
and routes tokens to each request with eos, ``max_tokens`` and stop
strings. An embedding's forward runs on a worker thread between engine
calls, where the JAX server runs it beside them, so the kernels' launch
counts in ``/health`` stay exact under mixed traffic. The engine runs the JAX server's defaults: ``--prefill-pack
4``, ``--spec-draft 4``, ``--turbo-steps 8`` and the prefix cache;
``--kv-quant int8`` halves the cache. Before it listens, the server warms
the engine's paths up (``_warmup_engine``; ``--no-warmup`` skips it), so
the first request does not pay the card's start-up.

Requests take token logprobs (``logprobs``, ``top_logprobs``), ``n`` of 1
to 8 choices (``seed + i`` for choice i; not streamed), ``tools`` with
``tool_choice`` ``auto`` or ``none`` (Hermes ``<tool_call>`` blocks and
Llama-3.1 JSON calls parsed into ``tool_calls``) and ``response_format``
``text`` or ``json_object``, with the JAX server's checks, error strings
and statuses. ``/v1/completions`` also streams, which the JAX server
does not; a streamed chunk carries the logprobs of the tokens consumed
since the last one.

Not in this slice: the JAX server's QoS (per-tenant buckets and the fan-out
charge of ``n``), request deadlines, trace spans, the engine watchdog,
``dtpu_resume`` (and its refusal of logprobs), the flight and boot
recorders (``mark_flight_warm``), fault points, and the QoS, trace, SLO,
flight and boot registries that JAX's ``/metrics`` appends to the
engine's (ROADMAP A4).
"""

import argparse
import asyncio
import collections
import dataclasses
import json
import re
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

import torch
from aiohttp import web

from dstack_tpu_torch.models.llama import embed_vectors, load_weights_npz
from dstack_tpu_torch.ops import flash, flash_decode, w8_matmul
from dstack_tpu_torch.serve.chat_template import ChatTemplateError, render_chat
from dstack_tpu_torch.serve.engine import TOP_LOGPROBS, GenParams, InferenceEngine
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
        self.submitted_at: Optional[float] = None  # perf_counter at submit
        self.gen_ids: list[int] = []  # for stop-string matching
        # per generated token: (logprob, [(alt_id, alt_lp), ...])
        self.logprob_entries: list = []


class Scheduler:
    """Bridges HTTP handlers and the synchronous engine: a background
    task admits pending requests (FIFO) into free slots, advances one
    prefill chunk per tick, and steps the engine while anything is
    active. Engine calls run on a worker thread so the event loop keeps
    serving, one at a time with the embeddings' forwards
    (:meth:`run_on_device`)."""

    def __init__(self, engine: InferenceEngine, tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer
        self.pending: collections.deque = collections.deque()
        self._wake = asyncio.Event()
        self.by_slot: dict[int, _Request] = {}
        self.by_prefill: dict[int, _Request] = {}  # chunked prefills in flight
        self._task: Optional[asyncio.Task] = None
        self._device = threading.Lock()

    async def run_on_device(self, fn):
        """``fn()`` on a worker thread, never beside another call made
        through here: the kernels' launch counters are module ints whose
        ``+= 1`` is not atomic across threads, and ``/health`` reports
        them."""

        def locked():
            with self._device:
                return fn()

        return await asyncio.to_thread(locked)

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
        req.submitted_at = time.perf_counter()
        self.engine.metrics.family("dtpu_serve_requests_total").inc(1)
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
        """Fail one request on an engine, prefill or admission error:
        counted in ``dtpu_serve_request_errors_total``."""
        self.engine.metrics.family("dtpu_serve_request_errors_total").inc(1)
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

    def _take_logprobs(self, slot: int, req: _Request) -> None:
        """The engine's entry for the slot's newest token, kept beside
        the token (requests that asked for logprobs only)."""
        if req.gen.logprobs is not None:
            entry = self.engine.take_logprobs(slot)
            if entry is not None:
                req.logprob_entries.append(entry)

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
            # the queue's share of the client's TTFT; the engine's
            # dtpu_serve_ttft_seconds starts here
            self.engine.metrics.family("dtpu_serve_queue_wait_seconds").observe(
                time.perf_counter() - req.submitted_at
            )
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
                firsts = await self.run_on_device(self.engine.prefill_wave)
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
                # the first token's entry is taken even for eos, as JAX's
                # _handle_first_token takes it
                self._take_logprobs(slot, req)
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
        out = await self.run_on_device(self.engine.step)
        for slot, toks in out.items():
            req = self.by_slot.get(slot)
            if req is None:
                continue
            stopped = False
            for tok in toks:
                if tok == req.gen.eos_id:
                    continue
                self._take_logprobs(slot, req)
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


def _logprobs_requested(payload: dict) -> Optional[int]:
    """→ top-n alternatives wanted, or None when logprobs are off. 0 is
    valid (the chosen tokens' logprobs, no alternatives). Takes the
    completions convention (``logprobs: int``) and the chat one
    (``logprobs: true`` + ``top_logprobs: int``), capped at TOP_LOGPROBS."""
    lp = payload.get("logprobs")
    if lp is True:
        n = int(payload.get("top_logprobs") or 0)
        return min(max(n, 0), TOP_LOGPROBS)
    if isinstance(lp, int) and not isinstance(lp, bool) and lp >= 0:
        return min(lp, TOP_LOGPROBS)
    return None


def _kept_token_count(tokenizer, ids: list, text: str) -> int:
    """Smallest token count whose decoded prefix covers ``text``, so the
    logprobs arrays align with a stop-truncated completion. Coverage is
    the common prefix with the FULL decode: the replacement chars of a
    partly decoded multi-byte character differ from the final text and
    do not count, while a genuine U+FFFD the model emitted does."""
    full = tokenizer.decode(ids)
    if len(full) <= len(text):
        return len(ids)
    for k in range(len(ids) + 1):
        prefix = tokenizer.decode(ids[:k])
        common = 0
        for a, b in zip(prefix, full):
            if a != b:
                break
            common += 1
        if common >= len(text):
            return k
    return len(ids)


def _completions_logprob_arrays(req, tokenizer, top_n: int, lo: int, hi: int, pos: int = 0) -> dict:
    """The legacy /v1/completions logprobs block (4 parallel arrays) of
    generated tokens [lo, hi), text offsets counted from ``pos``."""
    tokens, token_lps, tops, offsets = [], [], [], []
    for tok, (lp, alts) in list(zip(req.gen_ids, req.logprob_entries))[lo:hi]:
        piece = tokenizer.decode([tok])
        tokens.append(piece)
        token_lps.append(lp)
        offsets.append(pos)
        pos += len(piece)
        top: dict = {}
        for i, alp in alts[:top_n]:
            # distinct ids can decode to the same text: keep the best
            # (the alternatives come sorted, best first)
            top.setdefault(tokenizer.decode([i]), alp)
        tops.append(top)
    return {"tokens": tokens, "token_logprobs": token_lps, "top_logprobs": tops, "text_offset": offsets}


def _format_completions_logprobs(req, tokenizer, top_n: int, text: str) -> dict:
    """The whole completion's logprobs block, aligned with its text."""
    n = _kept_token_count(tokenizer, req.gen_ids, text)
    return _completions_logprob_arrays(req, tokenizer, top_n, 0, n)


def _chat_logprob_entries(req, tokenizer, top_n: int, lo: int, hi: int) -> list:
    """Chat-format content entries for generated tokens [lo, hi)."""
    pairs = list(zip(req.gen_ids, req.logprob_entries))[lo:hi]
    return [
        {
            "token": tokenizer.decode([tok]),
            "logprob": lp,
            "top_logprobs": [
                {"token": tokenizer.decode([i]), "logprob": alp} for i, alp in alts[:top_n]
            ],
        }
        for tok, (lp, alts) in pairs
    ]


def _format_chat_logprobs(req, tokenizer, top_n: int, text: str) -> dict:
    """Chat completions logprobs block, aligned with the final text."""
    n = _kept_token_count(tokenizer, req.gen_ids, text)
    return {"content": _chat_logprob_entries(req, tokenizer, top_n, 0, n)}


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
        logprobs=_logprobs_requested(payload),
    )


def _bad_sampling_params(payload: dict) -> Optional[str]:
    """Validate the sampling knobs that can't be coerced → error string
    for a 400, or None. Runs before prefill, so a malformed request
    costs no prompt compute."""
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
    return None


def _valid_chat_message(m) -> bool:
    """OpenAI chat message shapes: plain {role, content: str}, assistant
    tool-call messages (content may be null), and role=tool results."""
    if not isinstance(m, dict):
        return False
    if isinstance(m.get("content"), str):
        return True
    return m.get("role") == "assistant" and isinstance(m.get("tool_calls"), list)


_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)


def _tool_stream_safe_len(out: str) -> int:
    """How much of the accumulated stream text is provably not part of a
    tool call and may stream as prose right away. A Llama-3.1 JSON call
    is the whole reply, so a reply whose first non-space char is ``{``
    buffers entirely; a Hermes block starts at ``<tool_call>``, so hold
    back from the first complete tag, or from a trailing partial prefix
    of it (the tag may still be arriving)."""
    if out.lstrip().startswith("{"):
        return 0
    i = out.find("<tool_call>")
    if i != -1:
        return i
    tag = "<tool_call>"
    for k in range(min(len(tag) - 1, len(out)), 0, -1):
        if out.endswith(tag[:k]):
            return len(out) - k
    return len(out)


def _parse_tool_calls(text: str) -> tuple[Optional[str], Optional[list]]:
    """The two common open-model tool-call formats → (remaining content
    or None, OpenAI ``tool_calls`` list or None).

    - Hermes/Qwen: one or more ``<tool_call>{...}</tool_call>`` blocks;
      the prose around them stays as content (OpenAI returns both)
    - Llama-3.1 JSON: the whole reply is one object with ``name`` and
      ``arguments``/``parameters``

    Anything else (prose, partial JSON) stays ordinary content."""
    t = text.strip()
    raw = []
    content = None
    if "<tool_call>" in t:
        for m in _TOOL_CALL_RE.findall(t):
            try:
                obj = json.loads(m)
            except json.JSONDecodeError:
                return text, None
            if not (isinstance(obj, dict) and "name" in obj):
                return text, None
            raw.append(obj)
        remainder = _TOOL_CALL_RE.sub("", t).strip()
        if not raw or "<tool_call>" in remainder:
            # no complete block, or a truncated trailing one (a length
            # cut mid-call): all of it stays content, so the client sees
            # the real finish_reason, not a partial call
            return text, None
        content = remainder or None
    else:
        try:
            obj = json.loads(t)
        except json.JSONDecodeError:
            return text, None
        if not (isinstance(obj, dict) and "name" in obj
                and ("arguments" in obj or "parameters" in obj)):
            return text, None
        raw.append(obj)
    calls = []
    for obj in raw:
        args = obj.get("arguments", obj.get("parameters", {}))
        calls.append({
            "id": f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {
                "name": str(obj["name"]),
                "arguments": args if isinstance(args, str) else json.dumps(args),
            },
        })
    return content, calls


def _bad_tools(payload: dict) -> tuple[Optional[str], Optional[list]]:
    """Check ``tools``, ``tool_choice`` and ``response_format`` → (error
    string for a 400 or None, the tools to render: None under
    ``tool_choice: "none"``). Forcing a call (``required``, a named
    function) and ``json_schema`` need constrained decoding, which the
    engine does not do: refused, not silently ignored."""
    tools = payload.get("tools")
    if tools is not None and not (isinstance(tools, list) and all(isinstance(t, dict) for t in tools)):
        return "'tools' must be a list of objects", None
    tool_choice = payload.get("tool_choice")
    if tool_choice == "none":
        tools = None  # opt-out: render no tools, parse nothing
    elif tool_choice not in (None, "auto"):
        return "tool_choice supports 'auto' and 'none' only", None
    rf = payload.get("response_format")
    if rf is not None:
        kind = rf.get("type") if isinstance(rf, dict) else None
        if kind == "json_schema":
            return ("response_format 'json_schema' is not supported (no constrained "
                    "decoding); 'json_object' and 'text' are"), None
        if kind not in (None, "text", "json_object"):
            return "response_format.type must be 'text' or 'json_object'", None
    return None, tools


# best-effort JSON mode: an instruction rendered as the last system turn;
# the output is not validated
_JSON_OBJECT_TURN = {
    "role": "system",
    "content": "Respond ONLY with a valid JSON object. No prose, no markdown fences.",
}


def build_app(
    engine: InferenceEngine, tokenizer, model_name: str, chat_template: Optional[str] = None
) -> web.Application:
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
        e.update_state_gauges()
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
                "w8_matmul": w8_matmul.LAUNCHES,
            },
            "flash_decode_launches": dict(flash_decode.LAUNCHES_BY_VARIANT),
            "w8_matmul_launches": dict(w8_matmul.LAUNCHES_BY_FORM),
            # the step sites: graphs (eager variants on the CPU) and capture seconds
            "graph_sites": e.graphs.report(),
            "graph_captures": e.graphs.captures(),
            "flight_warm": e.flight_warm,
            # the card's allocator: what the engine, its graphs' pool and its cache hold
            "device_memory": None if e.device.type != "cuda" else {
                "allocated_bytes": torch.cuda.memory_allocated(e.device),
                "reserved_bytes": torch.cuda.memory_reserved(e.device),
            },
        })

    async def metrics(request):
        """Prometheus text of the engine's registry, its state gauges and
        the queue depth refreshed first. Rendered under the registry's
        lock only: a scrape never waits for a step on the card."""
        e = sched.engine
        e.update_state_gauges()
        e.metrics.family("dtpu_serve_queue_depth").set(len(sched.pending))
        return web.Response(text=e.metrics.render(), content_type="text/plain")

    async def models(request):
        return web.json_response({
            "object": "list",
            "data": [{"id": model_name, "object": "model", "owned_by": "dstack-tpu"}],
        })

    async def _submit(prompt: str, payload: dict) -> _Request:
        req = _Request(tokenizer.encode(prompt), _gen_params(payload, tokenizer))
        await sched.submit(req)
        return req

    def _final_text(req: _Request, ids: list) -> str:
        """The streamed text once generation ended: no trailing
        replacement chars, cut at a stop string."""
        full = tokenizer.decode(ids)
        while full.endswith("\ufffd"):
            full = full[:-1]
        return _truncate_stop(full, req.gen.stop)

    def _emittable(req: _Request, ids: list) -> str:
        """Streamed text safe to deliver: re-decoded from all ids
        (per-token decode would split multi-byte UTF-8), trailing
        replacement chars and any stop-string prefix held back."""
        full = _final_text(req, ids)
        return full[: len(full) - _stop_holdback(full, req.gen.stop)]

    def _whole_text(req: _Request, ids: list) -> str:
        return _truncate_stop(tokenizer.decode(ids), req.gen.stop)

    async def _stream(request, req: _Request, chunk_of, lp_block, tools=None) -> web.StreamResponse:
        """SSE: one chunk per delivered delta, then a finish chunk and
        ``[DONE]``. ``chunk_of(delta, finish, logprobs, tool_calls)``
        shapes a chunk; ``lp_block(lo, hi)`` the logprobs of generated
        tokens [lo, hi) (the tokens consumed since the last chunk: delta
        boundaries are char diffs, so the alignment is approximate at
        hold-back edges, as in JAX). With ``tools`` the text streams up to
        the first point that could still become a tool call; the rest is
        parsed once generation ends."""
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)

        async def send(obj) -> None:
            await resp.write(b"data: " + json.dumps(obj).encode() + b"\n\n")

        ids: list[int] = []
        sent = ""
        lp_emitted = 0

        async def emit(delta, tool_calls=None) -> None:
            nonlocal lp_emitted
            lp = None
            if req.gen.logprobs is not None:
                hi = len(req.logprob_entries)
                lp = lp_block(lp_emitted, hi)
                lp_emitted = hi
            await send(chunk_of(delta, None, lp, tool_calls))

        finish = None
        try:
            while True:
                tok = await req.queue.get()
                if tok is None:
                    break
                ids.append(tok)
                out = _emittable(req, ids)
                if tools:
                    out = out[: _tool_stream_safe_len(out)]
                if len(out) > len(sent):
                    delta, sent = out[len(sent):], out
                    await emit(delta)
            rest = _final_text(req, ids)[len(sent):] if ids else ""
            content, tool_calls = _parse_tool_calls(rest) if tools and rest else (None, None)
            if tool_calls:
                await emit(content, tool_calls=[{**c, "index": ci} for ci, c in enumerate(tool_calls)])
                finish = "tool_calls"
            elif rest:
                await emit(rest)
        finally:
            sched.cancel(req)  # no-op when finished; frees the slot on disconnect
        if req.error:
            await send({"error": req.error})
        else:
            await send(chunk_of(None, finish or req.finish_reason or "stop", None, None))
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

    async def _read_json(request):
        try:
            payload = await request.json()
        except Exception:  # noqa: BLE001 - any malformed body is a 400
            return None, web.json_response({"detail": "invalid JSON body"}, status=400)
        if not isinstance(payload, dict):
            return None, web.json_response({"detail": "JSON object expected"}, status=400)
        return payload, None

    def _n_choices(payload: dict):
        """Validated OpenAI ``n`` (choices a request) → int or an error
        response. Explicit null means the default."""
        n = payload.get("n")
        if n is None:
            n = 1
        if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= 8:
            return web.json_response({"detail": "'n' must be an integer in [1, 8]"}, status=400)
        if n > 1 and payload.get("stream"):
            return web.json_response(
                {"detail": "streaming with n > 1 is not supported"}, status=400
            )
        return n

    async def _fan_out(first: _Request, n: int):
        """Submit the other n - 1 choices (the prompt tokenized once, the
        gen params copied with ``seed + i`` for choice i: a distinct
        deterministic stream each), collect all → (reqs, id lists, total
        completion tokens), or an error response."""
        reqs = [first]
        for i in range(1, n):
            gen = dataclasses.replace(first.gen)
            if gen.seed is not None:
                gen.seed += i
            req = _Request(list(first.prompt_ids), gen)
            await sched.submit(req)
            reqs.append(req)
        id_lists = await asyncio.gather(*(_collect(r) for r in reqs))
        failed = next((r for r in reqs if r.error), None)
        if failed is not None:
            return web.json_response({"detail": failed.error}, status=500)
        return reqs, id_lists, sum(len(ids) for ids in id_lists)

    def _usage(n_prompt: int, n_completion: int) -> dict:
        return {
            "prompt_tokens": n_prompt,
            "completion_tokens": n_completion,
            "total_tokens": n_prompt + n_completion,
        }

    async def completions(request):
        payload, err = await _read_json(request)
        if err is not None:
            return err
        prompt = payload.get("prompt")
        if not isinstance(prompt, str):
            return web.json_response({"detail": "'prompt' required"}, status=400)
        bad = _bad_sampling_params(payload)
        if bad:
            return web.json_response({"detail": bad}, status=400)
        n = _n_choices(payload)
        if not isinstance(n, int):
            return n
        first = await _submit(prompt, payload)
        cid = f"cmpl-{uuid.uuid4().hex}"
        created = int(time.time())

        def body_of(choices: list) -> dict:
            return {
                "id": cid, "object": "text_completion", "created": created,
                "model": model_name, "choices": choices,
            }

        if payload.get("stream"):
            top_n = first.gen.logprobs or 0
            pos = 0

            def lp_block(lo, hi):
                nonlocal pos
                block = _completions_logprob_arrays(first, tokenizer, top_n, lo, hi, pos)
                pos += sum(len(t) for t in block["tokens"])
                return block

            def chunk_of(delta, finish, lp, _tool_calls):
                choice = {"index": 0, "text": delta or "", "finish_reason": finish}
                if lp is not None:
                    choice["logprobs"] = lp
                return body_of([choice])

            return await _stream(request, first, chunk_of, lp_block)
        fanned = await _fan_out(first, n)
        if not isinstance(fanned, tuple):
            return fanned
        reqs, id_lists, total = fanned
        choices = []
        for i, (r, ids) in enumerate(zip(reqs, id_lists)):
            choice = {
                "index": i, "text": _whole_text(r, ids), "finish_reason": r.finish_reason or "stop",
            }
            if r.gen.logprobs is not None:
                choice["logprobs"] = _format_completions_logprobs(
                    r, tokenizer, r.gen.logprobs, choice["text"]
                )
            choices.append(choice)
        body = body_of(choices)
        body["usage"] = _usage(len(first.prompt_ids), total)
        return web.json_response(body)

    async def chat_completions(request):
        payload, err = await _read_json(request)
        if err is not None:
            return err
        bad = _bad_sampling_params(payload)
        if bad:
            return web.json_response({"detail": bad}, status=400)
        messages = payload.get("messages")
        if not isinstance(messages, list) or not messages or not all(
            _valid_chat_message(m) for m in messages
        ):
            return web.json_response(
                {"detail": "'messages' must be [{role, content}, ...] "
                           "(assistant tool_calls / role=tool allowed)"},
                status=400,
            )
        bad, tools = _bad_tools(payload)
        if bad:
            return web.json_response({"detail": bad}, status=400)
        rf = payload.get("response_format")
        if isinstance(rf, dict) and rf.get("type") == "json_object":
            messages = list(messages) + [_JSON_OBJECT_TURN]
        try:
            prompt = render_chat(messages, chat_template, tools=tools)
        except ChatTemplateError as e:
            return web.json_response({"detail": str(e)}, status=e.status)
        n = _n_choices(payload)
        if not isinstance(n, int):
            return n
        first = await _submit(prompt, payload)
        cid = f"chatcmpl-{uuid.uuid4().hex}"
        created = int(time.time())

        if payload.get("stream"):
            top_n = first.gen.logprobs or 0

            def chunk_of(delta, finish, lp, tool_calls):
                d = {}
                if finish is None:
                    d = {"role": "assistant", "content": delta}
                    if tool_calls is not None:
                        d["tool_calls"] = tool_calls
                choice = {"index": 0, "delta": d, "finish_reason": finish}
                if lp is not None:
                    choice["logprobs"] = lp
                return {
                    "id": cid, "object": "chat.completion.chunk", "created": created,
                    "model": model_name, "choices": [choice],
                }

            def lp_block(lo, hi):
                return {"content": _chat_logprob_entries(first, tokenizer, top_n, lo, hi)}

            return await _stream(request, first, chunk_of, lp_block, tools=tools)
        fanned = await _fan_out(first, n)
        if not isinstance(fanned, tuple):
            return fanned
        reqs, id_lists, total = fanned
        choices = []
        for i, (r, ids) in enumerate(zip(reqs, id_lists)):
            text = _whole_text(r, ids)
            content, tool_calls = _parse_tool_calls(text) if tools else (text, None)
            if tool_calls:
                message = {"role": "assistant", "content": content, "tool_calls": tool_calls}
                finish = "tool_calls"
            else:
                message = {"role": "assistant", "content": text}
                finish = r.finish_reason or "stop"
            choice = {"index": i, "message": message, "finish_reason": finish}
            if r.gen.logprobs is not None:
                choice["logprobs"] = _format_chat_logprobs(r, tokenizer, r.gen.logprobs, text)
            choices.append(choice)
        return web.json_response({
            "id": cid, "object": "chat.completion", "created": created,
            "model": model_name, "choices": choices,
            "usage": _usage(len(first.prompt_ids), total),
        })

    async def embeddings(request):
        payload, err = await _read_json(request)
        if err is not None:
            return err
        inputs = payload.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not all(isinstance(s, str) for s in inputs) or not inputs:
            return web.json_response(
                {"detail": "'input' must be a string or list of strings"}, status=400
            )
        id_lists = [tokenizer.encode(text) or [0] for text in inputs]
        for i, ids in enumerate(id_lists):
            if len(ids) > engine.max_seq:
                # a context-length error, not a silently truncated embedding
                return web.json_response(
                    {"detail": f"input {i} has {len(ids)} tokens, over "
                               f"the model's {engine.max_seq} maximum"},
                    status=400,
                )
        total = sum(len(ids) for ids in id_lists)
        # off the event loop, so other connections' streams keep flowing,
        # and between engine steps (one device-to-host copy after every
        # forward is queued)
        vecs = await sched.run_on_device(
            lambda: embed_vectors(engine.params, engine.config, id_lists).cpu().tolist()
        )
        return web.json_response({
            "object": "list",
            "data": [
                {"object": "embedding", "index": i, "embedding": vec} for i, vec in enumerate(vecs)
            ],
            "model": model_name,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        })

    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/v1/models", models)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/embeddings", embeddings)
    return app


def _warmup_engine(engine: InferenceEngine) -> float:
    """Run, at start-up and not in the first request's TTFT, every path
    real requests take (the JAX ``_warmup_engine``'s grid): the full
    prefill chunk with the largest turbo macro-step, the short prompt,
    each smaller power-of-two turbo variant, the sampled path (seeded with
    a skip, so the resume's counter offset is visited too), a request
    with logprobs, a plain greedy step (turbo off for it), a packed wave
    at every power-of-two G up to ``prefill_pack``, and a verify when
    ``spec_draft`` is on. On the card this captures every decode-side
    step site's graph (serve/graphs.py) for every key real requests reach
    and the prefill sites' graphs for JAX's grid below, and moves the CUDA
    context, cuBLAS's handles, the allocator's first blocks and each
    kernel's first launch out of the first request. Then
    the engine forgets the warmup (:meth:`InferenceEngine.forget_requests`,
    with ``spec_draft`` and ``turbo_steps`` restored): no request can see
    it; every prefix-copy length is compiled
    (:meth:`InferenceEngine.warm_prefix_copies`, as JAX does); and it is
    marked warm (:meth:`InferenceEngine.mark_flight_warm`): a later
    compile counts as a recompile. The prefill keys are JAX's grid: the
    chunk at (C, 0) and (16, 0), the packed waves at (G, C), every copy
    length and the mark_prompt lengths those reach; a later chunk start,
    a smaller chunk or wave bucket, or a longer prompt's mark_prompt is
    captured when a request first reaches it, as JAX compiles it then.
    → seconds."""
    t0 = time.perf_counter()
    spec, turbo = engine.spec_draft, engine.turbo_steps
    full = [(i % 251) + 1 for i in range(engine.prefill_chunk)]
    runs = 0

    def run(prompt, gen):
        nonlocal runs
        runs += 1
        slot, _ = engine.add_request(prompt, gen)
        while engine.active[slot]:
            engine.step()
        engine.release(slot)

    engine.spec_draft = 0
    try:
        # the full chunk + the largest turbo variant (and its 1-step tail)
        run(full, GenParams(max_new_tokens=max(2, engine.turbo_steps + 2)))
        run(full[:5], GenParams(max_new_tokens=2))  # the smallest chunk bucket
        # the smaller turbo variants: a budget of s + 1 picks steps = s
        s = engine.turbo_steps // 2
        while s >= 2:
            run(full[:5], GenParams(max_new_tokens=s + 1))
            s //= 2
        # the sampler, the skip of a resumed seeded stream, and logprobs
        run(full[:5], GenParams(max_new_tokens=2, temperature=0.7, seed=0, seed_skip=1))
        run(full[:5], GenParams(max_new_tokens=2, logprobs=0))
        engine.turbo_steps = 0  # a plain greedy step (a prompt prefilling beside it)
        run(full[:5], GenParams(max_new_tokens=2))
        engine.turbo_steps = turbo
        # packed waves at every power-of-two G, at the full chunk width
        g = 2
        while g <= engine.prefill_pack and g <= engine.max_batch:
            slots = [engine.start_request(list(full), GenParams(max_new_tokens=2)) for _ in range(g)]
            runs += g
            pending = set(slots)
            while pending:
                pending -= set(engine.prefill_wave())
            while any(engine.active[s] for s in slots):
                engine.step()
            for s in slots:
                engine.release(s)
            g *= 2
        engine.spec_draft = spec
        if spec:
            # a repetitive prompt: drafts fire, and verify_step runs
            rep = (full[:4] * (engine.prefill_chunk // 4 + 1))[: engine.prefill_chunk]
            spec_steps = engine.stats["spec_steps"]
            run(rep, GenParams(max_new_tokens=spec + 2))
            if engine.stats["spec_steps"] == spec_steps:
                engine.warm_verify()  # the model drafted nothing: verify once all the same
                runs += 1
    finally:
        engine.spec_draft, engine.turbo_steps = spec, turbo
    # warmup prompts are not real: none may linger as a reusable prefix,
    # a seen-token count or a sampling stream
    engine.forget_requests()
    engine.warm_prefix_copies()
    engine.mark_flight_warm()
    seconds = time.perf_counter() - t0
    logger.info(
        "warmup: %d requests ran prefill/decode/sample/logprobs%s in %.2fs (%d compiled variants)",
        runs, "/verify" if spec else "", seconds, len(engine.compile_manifest()),
    )
    return seconds


def main(argv=None) -> int:
    from dstack_tpu_torch.models import llama, quant
    from dstack_tpu_torch.models.convert_hf import load_checkpoint
    from dstack_tpu_torch.ops import cuda_build
    from dstack_tpu_torch.serve.engine import resolve_device
    from dstack_tpu_torch.utils.logging import configure_logging

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="llama-3.2-1b", choices=sorted(llama.CONFIGS))
    p.add_argument(
        "--weights", default=None,
        help="model_weights.npz from a full fine-tune (the port's or the JAX "
             "package's), overlaid on the model's weights",
    )
    p.add_argument(
        "--hf-model", default=None,
        help="HF save_pretrained dir (a model type models/convert_hf.py loads: llama, "
             "gemma*, qwen2/3, qwen3_moe, mixtral, gpt_oss, mistral, phi3, granite, "
             "starcoder2, nemotron, cohere, cohere2, olmo2, glm/glm4, llama4/llama4_text, "
             "deepseek_v2/v3): loads the config and weights, overrides --model and --seed",
    )
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--chat-template", default=None, help="jinja chat template override")
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
        "--no-warmup", action="store_true",
        help="skip the start-up warmup (the first request then pays the "
             "card's start-up in its TTFT)",
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
        "--decode-kernel", default=None, choices=["flash", "einsum"],
        help="decode attention: the ragged flash-decode kernel, or the "
             "plain masked attention over the whole row (reference); by "
             "default the kernel, but the einsum for a chunked-attention "
             "model (Llama4), whose chunk mask the kernel does not take",
    )
    p.add_argument(
        "--quantize", default=None, choices=["int8"],
        help="weight-only int8 (per-output-channel scales), applied on the host "
             "after --hf-model, --seed and --weights: half the weight bytes a "
             "decode step reads",
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
    # with --quantize the tree is built or loaded on the host and only its
    # int8 form goes to the card, as JAX quantizes its host tree
    # (dstack_tpu/models/quant.py:48-56)
    load_device = torch.device("cpu") if args.quantize else device
    if args.hf_model:
        t0 = time.perf_counter()
        config, params = load_checkpoint(args.hf_model, device=load_device)
        args.model = Path(args.hf_model).resolve().name
        logger.info(
            "loaded HF checkpoint %s (%.2fB params) in %.1fs; tokenizer: byte (an HF "
            "tokenizer comes with the text corpora, ROADMAP A3)",
            args.hf_model, config.num_params() / 1e9, time.perf_counter() - t0,
        )
    else:
        config = llama.CONFIGS[args.model]
        generator = torch.Generator(device=load_device)
        generator.manual_seed(args.seed)
        params = llama.init_params(config, generator, device=load_device)
    if args.weights:
        t0 = time.perf_counter()
        n = load_weights_npz(params, args.weights)
        logger.info("loaded %d weight arrays from %s in %.1fs", n, args.weights, time.perf_counter() - t0)
    if args.quantize == "int8":
        params = quant.tree_to(quant.quantize_tree(params, config), device)
        logger.info("weights quantized to int8 (per-output-channel scales)")
    engine = InferenceEngine(
        config, params, max_batch=args.max_batch, max_seq=args.max_seq,
        seed=args.seed, prefill_chunk=args.prefill_chunk, prefill_pack=args.prefill_pack,
        spec_draft=args.spec_draft, turbo_steps=args.turbo_steps, turbo_depth=args.turbo_depth,
        prefix_cache=not args.no_prefix_cache, kv_quant=args.kv_quant,
        decode_kernel=args.decode_kernel, device=device,
    )
    if not args.no_warmup:
        _warmup_engine(engine)
    app = build_app(engine, ByteTokenizer(), args.model, args.chat_template)
    logger.info("openai server: %s on %s, :%d", args.model, device, args.port)
    web.run_app(app, host="0.0.0.0", port=args.port, print=None)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
