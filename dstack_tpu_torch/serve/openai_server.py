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
deepseek_v2, deepseek_v3) instead (config and weights from the directory,
the model named after it), with the directory's HF tokenizer when one
ships there (``--tokenizer`` names another, or ``byte``; an HF tokenizer
needs the ``tokenizers`` package). ``--chat-template`` overrides the
Llama-3-style default. ``--compile-cache DIR`` (``DSTACK_TPU_COMPILE_CACHE``)
moves the kernels' build directory.

Endpoints: ``/health``, ``/metrics`` (the engine's ``dtpu_serve_*``
registry, then the QoS, trace, SLO, flight and boot registries, in
Prometheus text byte for byte as the JAX server renders them),
``/v1/models``, ``/v1/completions`` and ``/v1/chat/completions``, whole
and streamed (SSE), ``/v1/embeddings``, ``/debug/traces``,
``/debug/flight`` and ``/debug/boot``, and ``/debug/profiler/start`` and
``/stop`` when ``DTPU_PROFILER_DIR`` is set (``obs/profiling.py``: a
``torch.profiler`` chrome trace of the CPU and the card). One scheduler
task admits requests into engine slots, runs one prefill wave and one
engine step per tick on a worker thread, and routes tokens to each
request with eos, ``max_tokens`` and stop strings. An embedding's forward
runs on a worker thread between engine calls, where the JAX server runs
it beside them, so the kernels' launch counts in ``/health`` stay exact
under mixed traffic. The engine runs the JAX server's defaults:
``--prefill-pack 4``, ``--spec-draft 4``, ``--turbo-steps 8`` and the
prefix cache; ``--kv-quant int8`` halves the cache. Before it listens,
the server warms the engine's paths up (``_warmup_engine``;
``--no-warmup`` skips it), so the first request does not pay the card's
start-up; the boot recorder (``obs/boot.py``) times each start-up stage.

Requests take token logprobs (``logprobs``, ``top_logprobs``), ``n`` of 1
to 8 choices (``seed + i`` for choice i; not streamed), ``tools`` with
``tool_choice`` ``auto`` or ``none`` (Hermes ``<tool_call>`` blocks and
Llama-3.1 JSON calls parsed into ``tool_calls``) and ``response_format``
``text`` or ``json_object``, with the JAX server's checks, error strings
and statuses. ``/v1/completions`` also streams, which the JAX server
does not; a streamed chunk carries the logprobs of the tokens consumed
since the last one.

The JAX server's request lifecycle, with its headers, variables and
statuses:

- **QoS** (``qos/``): per-tenant token buckets (``--qos-rps``,
  ``--qos-burst``; ``DTPU_QOS_*``) shed an over-budget tenant with 429 and
  ``Retry-After`` before any prompt work (the ``serve.admit`` fault point
  fires first), ``n`` choices are charged n tokens, admission pops by
  priority class (``X-DTPU-Priority``) and a tenant at its in-flight cap
  (``--qos-tenant-inflight``) waits, counted once. A charge is refunded
  when its request dies before its first token.
- **Deadlines**: ``X-DTPU-Deadline`` seconds (else
  ``DTPU_REQUEST_DEADLINE_DEFAULT``) follow a request from the queue into
  its slot; the once-a-tick sweep (``serve.deadline`` adds clock skew)
  frees an expired slot and answers 504.
- **Watchdog**: ``DTPU_ENGINE_WATCHDOG_SECONDS`` bounds one engine step.
  A slot wedged in the ``serve.engine.step`` fault point is aborted and
  the others keep serving; a wedged dispatch fails the batch, and new
  arrivals get 503 until the stuck thread returns. Each abort leaves a
  post-mortem in ``/debug/flight``.
- **Resume**: a chat request with ``X-DTPU-Resume: 1`` and ``dtpu_resume``
  ``{"text": ...}`` continues a failed-over stream (the delivered text
  appended to the prompt, the budget shrunk, a seeded stream's draws
  skipped), neither charged nor shed again; it refuses logprobs.
- **Tracing**: a ``serve.request`` root span (parented by a proxy's
  ``X-DTPU-Trace``) with ``serve.queue``, ``serve.prefill`` and
  ``serve.decode`` phases; its trace id answers in ``X-DTPU-Trace`` on
  every response and rides the TTFT and TPOT exemplars.
- **SLO windows**: ``/health``'s ``slo_windows`` (``obs/slo.py``,
  ``DTPU_SLO``) for a router's probe loop.
"""

import argparse
import asyncio
import dataclasses
import functools
import json
import os
import re
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

import torch
from aiohttp import web

from dstack_tpu_torch import faults, qos
from dstack_tpu_torch.models.llama import embed_vectors, load_weights_npz
from dstack_tpu_torch.obs import boot as obs_boot
from dstack_tpu_torch.obs import flight
from dstack_tpu_torch.obs import profiling as obs_profiling
from dstack_tpu_torch.obs import slo as obs_slo
from dstack_tpu_torch.obs import tracing
from dstack_tpu_torch.ops import flash, flash_decode, w8_matmul
from dstack_tpu_torch.qos.metrics import get_qos_registry
from dstack_tpu_torch.serve.chat_template import ChatTemplateError, render_chat
from dstack_tpu_torch.serve.engine import TOP_LOGPROBS, GenParams, InferenceEngine
from dstack_tpu_torch.serve.tokenizer import TOKENIZER_FILES, load_tokenizer
from dstack_tpu_torch.utils.logging import get_logger
from dstack_tpu_torch.utils.retry import Deadline

logger = get_logger("serve.openai")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.getenv(name, "") or default)
    except ValueError:
        return default


# build_app's boot default: "the process-global recorder", distinct from an
# explicit None ("this app has no boot recorder")
_BOOT_FROM_ENV = object()


class _Request:
    def __init__(self, prompt_ids: list[int], gen: GenParams, tenant: str = qos.ANONYMOUS_TENANT,
                 priority: int = qos.PRIORITY_STANDARD):
        self.prompt_ids = prompt_ids
        self.gen = gen
        self.tenant = tenant
        self.priority = priority
        self.cap_deferred = False  # counted once in dtpu_qos_inflight_deferred_total
        self.queue: asyncio.Queue = asyncio.Queue()  # token ids, then None
        self.error: Optional[str] = None
        self.error_status = 500  # the HTTP status a non-streamed error maps to
        self.retry_after: Optional[int] = None  # the hint of a 429 or 503
        self.finish_reason: Optional[str] = None
        self.cancelled = False
        self.submitted_at: Optional[float] = None  # perf_counter at submit
        self.gen_ids: list[int] = []  # for stop-string matching
        # per generated token: (logprob, [(alt_id, alt_lp), ...])
        self.logprob_entries: list = []
        self.deadline: Optional[Deadline] = None
        self.bucket = None  # the qos.TokenBucket its admission charged
        self.refunded = False
        self.started = False  # at least one token queued to the client
        # the request's root span and its open phase child (serve.queue →
        # serve.prefill → serve.decode), both the no-op span by default
        self.span = tracing.NOOP_SPAN
        self.phase = tracing.NOOP_SPAN


def _reap_abandoned_step(task) -> None:
    """Done-callback of a watchdog-abandoned step: its outcome is
    discarded (the epoch made it a no-op); reading the exception keeps
    asyncio from logging it as never retrieved."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.warning("abandoned engine step finally returned: %r", exc)


class Scheduler:
    """Bridges HTTP handlers and the synchronous engine: a background
    task admits pending requests into free slots, advances one prefill
    wave per tick, and steps the engine while anything is active. Engine
    calls run on a worker thread so the event loop keeps serving, and
    their step sites one at a time with the embeddings' forwards
    (:meth:`run_on_device`, ``engine.step(device_lock=...)``).

    Admission is JAX's: pending requests pop by (priority class, arrival)
    from ``qos.PriorityPending``, and a per-tenant in-flight cap
    (``tenant_inflight``) skips, but keeps queued, a request whose tenant
    already holds its share of slots. Every tick first aborts the requests
    whose deadline expired (504); a step that outlasts ``watchdog_seconds``
    is abandoned and its wedged slot aborted (:meth:`_guarded_step`)."""

    def __init__(self, engine: InferenceEngine, tokenizer, tenant_inflight: int = 0,
                 watchdog_seconds: float = 0.0, boot=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.pending = qos.PriorityPending()
        self.tenant_inflight = max(0, int(tenant_inflight))  # 0 = off
        # the boot recorder's first-served-token mark: a bool guards the
        # hot path, so steady state pays one attribute read a token
        self._boot = boot
        self._boot_served = boot is None
        self.watchdog_seconds = max(0.0, float(watchdog_seconds))  # 0 = off
        # a dispatch-abandoned step still owns the engine until its thread
        # returns: while set, ticks neither admit nor dispatch
        self._abandoned: Optional[asyncio.Task] = None
        self.by_slot: dict[int, _Request] = {}
        self.by_prefill: dict[int, _Request] = {}  # chunked prefills in flight
        self._task: Optional[asyncio.Task] = None
        self._device = threading.Lock()

    async def run_on_device(self, fn):
        """``fn()`` on a worker thread, never beside another call made
        through here or a step's dispatch: the kernels' launch counters
        are module ints whose ``+= 1`` is not atomic across threads, and
        ``/health`` reports them."""

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

    def _note_served_token(self) -> None:
        """The first token of the process's life queued to a client: the
        boot recorder's last milestone (it seals the boot trace)."""
        if not self._boot_served:
            self._boot_served = True
            self._boot.mark(obs_boot.SERVED_MARK)

    async def submit(self, req: _Request) -> None:
        req.submitted_at = time.perf_counter()
        self.engine.metrics.family("dtpu_serve_requests_total").inc(1)
        req.phase = tracing.span("serve.queue", parent=req.span)
        self.pending.push(req, req.priority)

    def cancel(self, req: _Request) -> None:
        """Client went away (or the request finished): free its slot so
        decode stops burning steps on it, and refund a charge that bought
        no token."""
        req.cancelled = True
        self._refund_unstarted(req)
        req.phase.end("cancelled")
        for table in (self.by_slot, self.by_prefill):
            for slot, r in list(table.items()):
                if r is req:
                    self.engine.release(slot)
                    del table[slot]

    def _refund_unstarted(self, req: _Request) -> None:
        """Return the admission charge of a request that dies before its
        first token (disconnect, deadline, watchdog, engine failure);
        idempotent."""
        if req.bucket is not None and not req.refunded and not req.started and req.finish_reason is None:
            req.refunded = True
            req.bucket.refund(1.0)

    def _fail(self, req: _Request, error: str, status: int = 500, end: str = "error") -> None:
        """Fail one request (engine, prefill or admission error, watchdog
        abort, expired deadline): counted in
        ``dtpu_serve_request_errors_total``, its charge refunded if it got
        no token."""
        self.engine.metrics.family("dtpu_serve_request_errors_total").inc(1)
        self._refund_unstarted(req)
        req.phase.end(end)
        req.error = error
        req.error_status = status
        req.queue.put_nowait(None)

    # ---- per-request deadlines ----

    def _deadline_expired(self, req: _Request) -> bool:
        """One deadline check; the ``serve.deadline`` fault point's mutate
        value is added as clock skew, so a plan can force expiry."""
        if req.deadline is None or req.cancelled:
            return False
        skew = faults.mutate("serve.deadline", 0.0)
        try:
            skew = float(skew)
        except (TypeError, ValueError):
            skew = 0.0
        rem = req.deadline.remaining()
        return rem is not None and rem - skew <= 0.0

    def _abort_expired(self) -> None:
        """The once-a-tick deadline sweep: an expired slot is released (its
        KV free for this tick's admissions), an expired queued request
        fails instead of rotting in the queue."""
        for table in (self.by_slot, self.by_prefill):
            expired = [(slot, req) for slot, req in list(table.items()) if self._deadline_expired(req)]
            for slot, req in expired:
                del table[slot]
                self.engine.release(slot)
                self._fail_deadline(req)
            if expired and flight.enabled():
                flight.post_mortem(
                    "deadline_abort", registry=self.engine.metrics,
                    slots={slot: (req.span.trace_id if req.span.recording else None) for slot, req in expired},
                    **self.engine.fault_ctx,
                )
        if self.pending.qsize():
            for req in self.pending.drain_matching(self._deadline_expired):
                self._fail_deadline(req)

    def _fail_deadline(self, req: _Request) -> None:
        self.engine.metrics.family("dtpu_serve_deadline_expired_total").inc(1)
        req.span.event("deadline_expired")
        self._fail(req, "request deadline exceeded", status=504, end="deadline")

    # ---- engine watchdog ----

    async def _guarded_step(self) -> Optional[dict]:
        """``engine.step`` on a worker thread, under the watchdog: a step
        that outlasts ``watchdog_seconds`` is abandoned and its wedged
        slot aborted (the others keep serving), or, when the dispatch
        itself is stuck, the whole batch fails and the scheduler quiesces
        until the thread returns. None when the watchdog tripped."""
        step = functools.partial(self.engine.step, device_lock=self._device)
        if self.watchdog_seconds <= 0:
            return await asyncio.to_thread(step)
        task = asyncio.ensure_future(asyncio.to_thread(step))
        done, _ = await asyncio.wait({task}, timeout=self.watchdog_seconds)
        if done:
            return task.result()
        phase = self.engine.abandon_step()
        if phase is None:
            # the step finished as the watchdog tripped: slow, not wedged
            done, _ = await asyncio.wait({task}, timeout=max(1.0, self.watchdog_seconds))
            if done:
                return task.result()
        self.engine.metrics.family("dtpu_serve_watchdog_aborts_total").inc(1)
        task.add_done_callback(_reap_abandoned_step)
        error = "engine watchdog aborted a wedged decode step"
        if phase is not None and phase[0] == "slot":
            slot = phase[1]
            req = self.by_slot.pop(slot, None) or self.by_prefill.pop(slot, None)
            self.engine.release(slot)
            logger.error(
                "engine watchdog: step wedged on slot %d for > %.1fs; aborted that slot, "
                "%d other requests keep serving",
                slot, self.watchdog_seconds, len(self.by_slot) + len(self.by_prefill),
            )
            if req is not None:
                req.span.event("watchdog_abort", slot=slot)
                self._fail(req, error)
            return None
        # wedged inside the dispatch: no slot to blame, so the batch fails,
        # and the stuck thread keeps the engine until it returns
        logger.error(
            "engine watchdog: dispatch wedged for > %.1fs with no attributable slot; failing "
            "all %d in-flight requests and quiescing until it returns",
            self.watchdog_seconds, len(self.by_slot) + len(self.by_prefill),
        )
        for table in (self.by_slot, self.by_prefill):
            for slot, req in list(table.items()):
                self.engine.release(slot)
                req.span.event("watchdog_abort", attributable=False)
                self._fail(req, error)
            table.clear()
        self._abandoned = task
        return None

    # ---- admission ----

    def _tenant_held_counts(self) -> dict:
        """tenant → slots it holds (prefilling or decoding), once a tick."""
        counts: dict = {}
        for r in list(self.by_slot.values()) + list(self.by_prefill.values()):
            counts[r.tenant] = counts.get(r.tenant, 0) + 1
        return counts

    def _tenant_cap_ok(self, req: _Request, counts: dict) -> bool:
        """The in-flight cap against the tick's held counts; the deferred
        counter ticks once a request, the first time it waits at the cap."""
        if self.tenant_inflight <= 0 or counts.get(req.tenant, 0) < self.tenant_inflight:
            return True
        if not req.cap_deferred:
            req.cap_deferred = True
            get_qos_registry().family("dtpu_qos_inflight_deferred_total").inc(1, req.tenant)
        return False

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
                flight.post_mortem(
                    "engine_error", registry=self.engine.metrics, error=str(e)[:200],
                    slots=sorted(self.by_slot), **self.engine.fault_ctx,
                )
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
        req.started = True  # the charge is earned once a token ships
        self._note_served_token()
        req.queue.put_nowait(tok)
        if self._hit_stop(req, tok):
            self.engine.release(slot)
            req.finish_reason = "stop"
            req.queue.put_nowait(None)
            return True
        return False

    async def _quiesced(self) -> bool:
        """While a dispatch-abandoned step's thread still owns the engine,
        new arrivals fail fast with a 503 and a hint of one watchdog
        budget; True while quiesced. Once it returns, the mirrors it
        rebuilt are dropped."""
        if self._abandoned is None:
            return False
        if not self._abandoned.done():
            for req in self.pending.drain_matching(lambda r: True):
                self._refund_unstarted(req)
                req.span.event("engine_wedged")
                req.phase.end("error")
                req.error = "engine wedged: a decode dispatch exceeded the watchdog budget"
                req.error_status = 503
                req.retry_after = max(1, int(round(self.watchdog_seconds)))
                req.queue.put_nowait(None)
            await asyncio.sleep(0.05)
            return True
        self._abandoned = None
        self.engine.finish_abandoned_step()
        return False

    async def _tick(self) -> None:
        if await self._quiesced():
            return
        # the deadline sweep first: an expired slot's KV serves this
        # tick's admissions
        self._abort_expired()
        # admission in one heap walk, priority-ordered; a tenant at its
        # cap is skipped and stays queued, and the walk charges `held`, so
        # a tenant cannot take every slot of the batch
        held = self._tenant_held_counts()

        def cap_and_charge(r: _Request) -> bool:
            if not self._tenant_cap_ok(r, held):
                return False
            held[r.tenant] = held.get(r.tenant, 0) + 1
            return True

        free = len(self.engine.free_slots())
        admitted = (self.pending.pop_admissible_many(free, cap_and_charge, discard=lambda r: r.cancelled)
                    if free else [])
        # arrival pressure for the adaptive turbo cap: only work that could
        # take a slot (a cap-blocked backlog must not shrink the others'
        # macro-steps)
        self.engine.waiting_requests = int(self.pending.any_admissible(
            lambda r: self._tenant_cap_ok(r, held), discard=lambda r: r.cancelled))
        for req in admitted:
            try:
                slot = self.engine.start_request(req.prompt_ids, req.gen)
            except Exception as e:  # noqa: BLE001 - reported per request
                logger.exception("admission failed: %s", e)
                self._fail(req, str(e))
                continue
            # the queue's share of the client's TTFT; the engine's
            # dtpu_serve_ttft_seconds starts here
            wait = time.perf_counter() - req.submitted_at
            self.engine.metrics.family("dtpu_serve_queue_wait_seconds").observe(wait)
            get_qos_registry().family("dtpu_qos_queue_wait_seconds").observe(
                wait, qos.priority_class_name(req.priority))
            req.phase.end()
            req.phase = tracing.span("serve.prefill", parent=req.span, slot=slot,
                                     prompt_tokens=len(req.prompt_ids))
            self.by_prefill[slot] = req
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
                flight.post_mortem(
                    "prefill_error", registry=self.engine.metrics, error=str(e)[:200],
                    slots=list(self.engine.last_wave_slots), **self.engine.fault_ctx,
                )
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
                req.phase.end()  # serve.prefill: slot grant → first token
                req.phase = tracing.NOOP_SPAN
                # the first token's entry is taken even for eos, as JAX's
                # _handle_first_token takes it
                self._take_logprobs(slot, req)
                if first != req.gen.eos_id and self._deliver(slot, req, first):
                    continue
                if self.engine.active[slot]:
                    req.phase = tracing.span("serve.decode", parent=req.span, slot=slot)
                    self.by_slot[slot] = req
                else:
                    req.finish_reason = self.engine.finish_reason[slot]
                    req.queue.put_nowait(None)
        if not self.by_slot:
            if self.by_prefill:
                return  # keep chunking
            # idle: with nothing in flight no cap defers anyone, so an
            # empty table means an empty queue; park until the next push
            await self.pending.wait()
            return
        out = await self._guarded_step()
        if out is None:
            return  # the watchdog tripped: its bookkeeping is done
        for slot, toks in out.items():
            req = self.by_slot.get(slot)
            if req is None:
                continue
            # one event per dispatch, with its token yield
            req.phase.event("macro_step", tokens=len(toks))
            stopped = False
            for tok in toks:
                if tok == req.gen.eos_id:
                    continue
                self._take_logprobs(slot, req)
                if self._deliver(slot, req, tok):
                    del self.by_slot[slot]
                    stopped = True
                    break
            if stopped:
                req.phase.end(tokens=len(req.gen_ids), finish="stop")
            elif not self.engine.active[slot]:
                req.finish_reason = self.engine.finish_reason[slot]
                req.phase.end(tokens=len(req.gen_ids), finish=req.finish_reason)
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
    engine: InferenceEngine,
    tokenizer,
    model_name: str,
    chat_template: Optional[str] = None,
    qos_policy: Optional[qos.QoSPolicy] = None,
    watchdog_seconds: Optional[float] = None,
    deadline_default: Optional[float] = None,
    boot=_BOOT_FROM_ENV,
) -> web.Application:
    """The server's routes over ``engine``, with JAX's defaults: the QoS
    policy from ``DTPU_QOS_*``, the watchdog from
    ``DTPU_ENGINE_WATCHDOG_SECONDS``, the default deadline from
    ``DTPU_REQUEST_DEADLINE_DEFAULT`` (0 = off each) and the process's boot
    recorder (an explicit None opts this app out)."""
    if qos_policy is None:
        qos_policy = qos.QoSPolicy.from_env()
    if watchdog_seconds is None:
        watchdog_seconds = _env_float("DTPU_ENGINE_WATCHDOG_SECONDS", 0.0)
    if deadline_default is None:
        deadline_default = _env_float("DTPU_REQUEST_DEADLINE_DEFAULT", 0.0)
    if boot is _BOOT_FROM_ENV:
        boot = obs_boot.get_recorder()
    app = web.Application()
    app["boot"] = boot
    sched = Scheduler(engine, tokenizer, tenant_inflight=qos_policy.tenant_inflight,
                      watchdog_seconds=watchdog_seconds, boot=boot)
    app["scheduler"] = sched
    # live SLO windows over this replica's registries (None under
    # DTPU_SLO=0): /health embeds them as `slo_windows`, which a router's
    # probe loop relays; per app, as a test runs several in one process
    replica_slo_state = obs_slo.replica_slo(
        lambda: obs_slo.serve_signals(engine.metrics, get_qos_registry()))
    app["replica_slo"] = replica_slo_state
    buckets = (
        qos.TenantBuckets(qos_policy.rps, qos_policy.effective_burst(), max_tenants=qos_policy.max_tenants)
        if qos_policy.enabled else None
    )

    def _is_resume(request) -> bool:
        """A router-asserted continuation of a stream that failed over
        (the proxy strips a client's own X-DTPU-Resume, as X-DTPU-Tenant)."""
        return request.headers.get(qos.RESUME_HEADER) == "1"

    def _request_deadline(request) -> Optional[Deadline]:
        """The request's budget: X-DTPU-Deadline seconds, else
        DTPU_REQUEST_DEADLINE_DEFAULT, else none. A malformed header is
        ignored, never a 400."""
        raw = request.headers.get(qos.DEADLINE_HEADER)
        seconds = None
        if raw:
            try:
                seconds = max(0.0, float(raw))
            except (TypeError, ValueError):
                seconds = None
        if seconds is None and deadline_default > 0:
            seconds = deadline_default
        return None if seconds is None else Deadline(seconds)

    def _tenant(request) -> str:
        # the tenant header reaching a replica is proxy-asserted
        return qos.tenant_from_headers(request.headers, trust_header=True)

    def _admit(request, span=tracing.NOOP_SPAN) -> Optional[web.Response]:
        """The tenant bucket's decision before any prompt work → a 429 with
        a monotone Retry-After, or None when admitted (a resumed
        continuation was charged on its first leg: never charged or shed
        again). The decision lands on ``span`` as an ``edge_admit`` event."""
        if _is_resume(request):
            return None
        hint = qos.edge_admit(qos_policy, buckets, _tenant(request), run_name=model_name,
                              fault_point="serve.admit", span=span)
        if hint is None:
            return None
        return web.json_response({"detail": "tenant request budget exhausted; retry later"},
                                 status=429, headers={"Retry-After": str(hint)})

    def _admit_extra(request, extra: int) -> Optional[web.Response]:
        """The fan-out charge: ``n`` choices are n generations, and _admit
        spent one token; charge the other n - 1 once ``n`` is known. A shed
        refunds the first token (a shed is free), and an ``n`` that never
        fits the burst is a 400 (a Retry-After no wait can honour)."""
        if extra <= 0 or buckets is None or not qos_policy.enabled:
            return None
        tenant = _tenant(request)
        burst = qos_policy.effective_burst()
        if 1 + extra > burst:
            buckets.bucket(tenant).refund(1.0)
            return web.json_response(
                {"detail": f"'n' exceeds this service's request budget (n tokens needed, burst is {int(burst)})"},
                status=400,
            )
        hint = qos.edge_admit(qos_policy, buckets, tenant, run_name=model_name, fault_point=None,
                              cost=float(extra))
        if hint is None:
            return None
        buckets.bucket(tenant).refund(1.0)
        return web.json_response({"detail": "tenant request budget exhausted for n choices; retry later"},
                                 status=429, headers={"Retry-After": str(hint)})

    async def on_startup(_):
        sched.start()
        if boot is not None:
            boot.mark("listener_up")  # the closest in-process anchor

    async def on_cleanup(_):
        await sched.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    async def health(request):
        """Liveness and load (JAX's keys), the engine's configuration, and
        the counts a run reads to show which path it took: prefill chunks
        and packed waves, plain, speculative and turbo steps, prefix hits,
        and each hand-written kernel's launches in this process (K4's also
        by variant)."""
        e = sched.engine
        e.update_state_gauges()
        m = e.metrics
        body = {
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
            "queue_depth": sched.pending.qsize(),
            "inflight": len(sched.by_slot) + len(sched.by_prefill),
            "active_slots": int(m.family("dtpu_serve_active_slots").value()),
            "max_slots": int(m.family("dtpu_serve_max_slots").value()),
            "kv_utilization": m.family("dtpu_serve_kv_cache_utilization_ratio").value(),
            **e.prefix_stats(),
            "profiler_tracing": obs_profiling.is_tracing(),
            "flight": {
                "enabled": flight.enabled(),
                "warm": e.flight_warm,
                "compiles": int(m.family("dtpu_serve_compiles_total").total()),
                "recompiles": int(m.family("dtpu_serve_recompiles_total").total()),
                "postmortems": int(m.family("dtpu_serve_postmortems_total").value()),
            },
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
        }
        if replica_slo_state is not None:
            body["slo_windows"] = replica_slo_state.health_windows()
        if boot is not None:
            # the first /health answered is the readiness probe
            boot.mark(obs_boot.READY_MARK)
            body["boot"] = boot.health_block(warm=e.flight_warm)
        return web.json_response(body)

    async def metrics(request):
        """Prometheus text: the engine's registry (its state gauges and the
        queue depth refreshed first), then this process's QoS, trace, SLO,
        flight and boot registries, in JAX's order. Rendered under the
        registries' locks only: a scrape never waits for a step."""
        e = sched.engine
        e.update_state_gauges()
        e.metrics.family("dtpu_serve_queue_depth").set(sched.pending.qsize())
        if replica_slo_state is not None:
            replica_slo_state.maybe_tick()
        return web.Response(
            text=e.metrics.render() + get_qos_registry().render() + tracing.get_trace_registry().render()
            + obs_slo.get_slo_registry().render() + flight.get_flight_registry().render()
            + obs_boot.get_boot_registry().render(),
            content_type="text/plain",
        )

    async def debug_traces(request):
        """Completed traces from this process's ring (``?id=``,
        ``?slowest=N``)."""
        return web.json_response(tracing.debug_payload(request.query))

    async def debug_flight(request):
        """The flight recorder: the step ring, compile accounting, memory
        watermarks and post-mortems (``?limit=``, ``?postmortems=``)."""
        return web.json_response(flight.debug_payload(request.query))

    async def debug_boot(request):
        """The boot recorder's timeline (``?limit=``) and summary, with the
        engine's boot-compile manifest and its coverage gaps."""
        if boot is None:
            return web.json_response({"enabled": False, "timeline": []})
        payload = obs_boot.debug_payload(request.query, recorder=boot)
        if payload.get("enabled"):
            payload["compile_manifest"] = {
                "warm": sched.engine.flight_warm,
                "variants": sorted(sched.engine.compile_manifest()),
                "gap_compiles": int(
                    sched.engine.metrics.family("dtpu_serve_warmup_gap_compiles_total").total()),
            }
        return web.json_response(payload)

    async def models(request):
        return web.json_response({
            "object": "list",
            "data": [{"id": model_name, "object": "model", "owned_by": "dstack-tpu"}],
        })

    async def _submit(prompt: str, payload: dict, request, resume_text=None,
                      span=tracing.NOOP_SPAN) -> _Request:
        gen = _gen_params(payload, tokenizer)
        if span.recording:
            gen.trace_id = span.trace_id  # the TTFT/TPOT exemplars
        prompt_ids = tokenizer.encode(prompt)
        resumed_ids: list = []
        if resume_text:
            # a continuation is a longer prompt: the delivered text is
            # appended (the prefix cache serves the re-prefill), the budget
            # shrinks by what shipped, and a seeded stream skips the draws
            # it spent, so it samples the original stream's tokens. The
            # count comes from re-tokenizing the splice: exact when the
            # text re-encodes to the tokens drawn (the byte tokenizer;
            # canonical BPE output)
            full_ids = tokenizer.encode(prompt + resume_text)
            n_resumed = max(0, len(full_ids) - len(prompt_ids))
            resumed_ids = full_ids[len(full_ids) - n_resumed:]
            gen.max_new_tokens = max(1, gen.max_new_tokens - n_resumed)
            if gen.seed is not None:
                gen.seed_skip = n_resumed
            prompt_ids = full_ids
            engine.metrics.family("dtpu_serve_resumed_requests_total").inc(1)
        tenant = _tenant(request)
        req = _Request(prompt_ids, gen, tenant=tenant, priority=qos.parse_priority_class(
            request.headers.get(qos.PRIORITY_HEADER) or payload.get("priority")))
        # the delivered tail joins the stop-string window across the splice
        req.gen_ids = list(resumed_ids)
        req.span = span
        if resume_text:
            span.set(resumed=True, resumed_tokens=len(resumed_ids))
        if buckets is not None and not _is_resume(request):
            req.bucket = buckets.bucket(tenant)  # refunded if it dies unstarted
        req.deadline = _request_deadline(request)
        await sched.submit(req)
        return req

    def _final_text(req: _Request, ids: list) -> str:
        """The streamed text once generation ended: no trailing
        replacement chars, cut at a stop string."""
        full = tokenizer.decode(ids)
        while full.endswith("�"):
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
        ``[DONE]`` (a failed request ends with an ``error`` event instead of
        the finish chunk). ``chunk_of(delta, finish, logprobs, tool_calls)``
        shapes a chunk; ``lp_block(lo, hi)`` the logprobs of generated
        tokens [lo, hi) (the tokens consumed since the last chunk: delta
        boundaries are char diffs, so the alignment is approximate at
        hold-back edges, as in JAX). With ``tools`` the text streams up to
        the first point that could still become a tool call; the rest is
        parsed once generation ends."""
        headers = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        if req.span.recording:
            headers[tracing.TRACE_HEADER] = req.span.trace_id  # headers commit at prepare()
        resp = web.StreamResponse(headers=headers)
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
        deterministic stream each; each charged one bucket token, the same
        deadline, phases under the same root span), collect all → (reqs,
        id lists, total completion tokens), or the first failure's error
        response with its status (and Retry-After on a 429 or 503)."""
        reqs = [first]
        for i in range(1, n):
            gen = dataclasses.replace(first.gen)
            if gen.seed is not None:
                gen.seed += i
            req = _Request(list(first.prompt_ids), gen, tenant=first.tenant, priority=first.priority)
            req.bucket, req.deadline, req.span = first.bucket, first.deadline, first.span
            await sched.submit(req)
            reqs.append(req)
        id_lists = await asyncio.gather(*(_collect(r) for r in reqs))
        failed = next((r for r in reqs if r.error), None)
        if failed is not None:
            headers = {}
            if failed.retry_after is not None and failed.error_status in (429, 503):
                headers["Retry-After"] = str(failed.retry_after)
            return web.json_response({"detail": failed.error}, status=failed.error_status, headers=headers)
        return reqs, id_lists, sum(len(ids) for ids in id_lists)

    def _usage(n_prompt: int, n_completion: int) -> dict:
        return {
            "prompt_tokens": n_prompt,
            "completion_tokens": n_completion,
            "total_tokens": n_prompt + n_completion,
        }

    def _traced(endpoint: str, handler):
        """The request's root span around ``handler``: parented to a
        router's dispatch leg by a proxy-asserted ``X-DTPU-Trace``, a fresh
        trace otherwise; its id echoed in ``X-DTPU-Trace`` on every
        response (a stream's at prepare). Attrs carry ids and counts, never
        text."""

        async def traced(request):
            root = tracing.span("serve.request", trace=request.headers.get(tracing.TRACE_HEADER),
                                endpoint=endpoint)
            try:
                resp = await handler(request, root)
                if root.recording and not resp.prepared:
                    resp.headers[tracing.TRACE_HEADER] = root.trace_id
                return resp
            finally:
                root.end()

        return traced

    async def completions(request, root):
        shed = _admit(request, span=root)
        if shed is not None:
            return shed
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
        shed = _admit_extra(request, n - 1)
        if shed is not None:
            return shed
        first = await _submit(prompt, payload, request, span=root)
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

    async def chat_completions(request, root):
        shed = _admit(request, span=root)
        if shed is not None:
            return shed
        payload, err = await _read_json(request)
        if err is not None:
            return err
        bad = _bad_sampling_params(payload)
        if bad:
            return web.json_response({"detail": bad}, status=400)
        resume_text = None
        if _is_resume(request):
            r = payload.get("dtpu_resume")
            if isinstance(r, dict) and isinstance(r.get("text"), str) and r["text"]:
                if _logprobs_requested(payload) is not None:
                    # logprob entries cannot align across the splice
                    return web.json_response(
                        {"detail": "a resumed continuation cannot carry logprobs"}, status=400)
                resume_text = r["text"]
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
        shed = _admit_extra(request, n - 1)
        if shed is not None:
            return shed
        first = await _submit(prompt, payload, request, resume_text=resume_text, span=root)
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
        shed = _admit(request)
        if shed is not None:
            return shed
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
    app.router.add_get("/debug/traces", debug_traces)
    app.router.add_get("/debug/flight", debug_flight)
    app.router.add_get("/debug/boot", debug_boot)
    app.router.add_get("/v1/models", models)
    app.router.add_post("/v1/completions", _traced("completions", completions))
    app.router.add_post("/v1/chat/completions", _traced("chat", chat_completions))
    app.router.add_post("/v1/embeddings", embeddings)

    if obs_profiling.profiler_dir():
        # on-demand profiler capture, routed only when DTPU_PROFILER_DIR
        # is set, as in JAX
        async def profiler_start(request):
            try:
                return web.json_response(obs_profiling.start_trace())
            except RuntimeError as e:
                return web.json_response({"detail": str(e)}, status=409)

        async def profiler_stop(request):
            try:
                return web.json_response(obs_profiling.stop_trace())
            except RuntimeError as e:
                return web.json_response({"detail": str(e)}, status=409)

        app.router.add_post("/debug/profiler/start", profiler_start)
        app.router.add_post("/debug/profiler/stop", profiler_stop)
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

    # the boot stage of the compile grid: every run below adds its
    # variants to the engine's boot-compile manifest
    with obs_boot.stage("warmup_compile") as boot_stage:
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
        boot_stage.set(runs=runs, manifest=len(engine.compile_manifest()))
    with obs_boot.stage("warm_prefix_copies"):
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
    from dstack_tpu_torch.train.step import tree_leaves
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
             "deepseek_v2/v3): loads the config and weights (and the tokenizer, when one "
             "ships there), overrides --model and --seed",
    )
    p.add_argument(
        "--tokenizer", default=None,
        help="'byte' or a HF tokenizer directory (default: the --hf-model dir when it "
             "ships a tokenizer, else byte; needs the 'tokenizers' package)",
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
    p.add_argument(
        "--compile-cache", default=os.environ.get("DSTACK_TPU_COMPILE_CACHE"),
        help="directory of the built kernels (default: DSTACK_TPU_COMPILE_CACHE, else "
             "build/torch_kernels in the checkout); a volume there spares a restart the build",
    )
    p.add_argument(
        "--qos-rps", type=float, default=None,
        help="per-tenant sustained requests/second; over-budget tenants get 429 + "
             "Retry-After (default: DTPU_QOS_RPS env, 0 = off)",
    )
    p.add_argument(
        "--qos-burst", type=float, default=None,
        help="per-tenant bucket capacity (default: DTPU_QOS_BURST env, 0 = 2x rps)",
    )
    p.add_argument(
        "--qos-tenant-inflight", type=int, default=None,
        help="max engine slots one tenant may hold concurrently (default: "
             "DTPU_QOS_TENANT_INFLIGHT env, 0 = off)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = p.parse_args(argv)
    configure_logging()

    device = resolve_device(args.device)
    if args.compile_cache:
        cuda_build.set_build_dir(args.compile_cache)
    if device.type == "cuda":
        # the kernels' build is the card's share of the compile cost: it
        # sums into the warmup_compile stage
        t0 = time.perf_counter()
        with obs_boot.stage("warmup_compile", phase="kernel_build"):
            cuda_build.build_all()
        logger.info("kernels ready in %.1fs (%s)", time.perf_counter() - t0, cuda_build.BUILD_DIR)
    # with --quantize the tree is built or loaded on the host and only its
    # int8 form goes to the card, as JAX quantizes its host tree
    # (dstack_tpu/models/quant.py:48-56)
    load_device = torch.device("cpu") if args.quantize else device
    if args.hf_model:
        # one pass reads config and weights: the whole read is weights_load
        t0 = time.perf_counter()
        with obs_boot.stage("weights_load", source="hf") as bs:
            config, params = load_checkpoint(args.hf_model, device=load_device)
            bs.set(bytes=sum(int(t.nbytes) for t in tree_leaves(params)))
        args.model = Path(args.hf_model).resolve().name
        if args.tokenizer is None and any((Path(args.hf_model) / f).exists() for f in TOKENIZER_FILES):
            args.tokenizer = args.hf_model  # the tokenizer ships alongside
        logger.info(
            "loaded HF checkpoint %s (%.2fB params) in %.1fs",
            args.hf_model, config.num_params() / 1e9, time.perf_counter() - t0,
        )
    else:
        with obs_boot.stage("config_load", model=args.model):
            config = llama.CONFIGS[args.model]
        # the random tree drawn where it is served: the weights' placement
        with obs_boot.stage("weights_load", phase="device_put"):
            generator = torch.Generator(device=load_device)
            generator.manual_seed(args.seed)
            params = llama.init_params(config, generator, device=load_device)
    if args.weights:
        t0 = time.perf_counter()
        with obs_boot.stage("weights_load", source="npz") as bs:
            n = load_weights_npz(params, args.weights)
            bs.set(bytes=os.path.getsize(args.weights))
        logger.info("loaded %d weight arrays from %s in %.1fs", n, args.weights, time.perf_counter() - t0)
    if args.quantize == "int8":
        params = quant.tree_to(quant.quantize_tree(params, config), device)
        logger.info("weights quantized to int8 (per-output-channel scales)")
    with obs_boot.stage("engine_init"):
        engine = InferenceEngine(
            config, params, max_batch=args.max_batch, max_seq=args.max_seq,
            seed=args.seed, prefill_chunk=args.prefill_chunk, prefill_pack=args.prefill_pack,
            spec_draft=args.spec_draft, turbo_steps=args.turbo_steps, turbo_depth=args.turbo_depth,
            prefix_cache=not args.no_prefix_cache, kv_quant=args.kv_quant,
            decode_kernel=args.decode_kernel, device=device,
        )
    # the tokenizer before the warmup: cheap and fail-fast, a typo'd path
    # must not cost a warmup first
    with obs_boot.stage("tokenizer_load"):
        tokenizer = load_tokenizer(args.tokenizer or "byte")
    logger.info("tokenizer: %s", args.tokenizer or "byte")
    if not args.no_warmup:
        _warmup_engine(engine)
    env_policy = qos.QoSPolicy.from_env()
    qos_policy = qos.QoSPolicy(
        rps=env_policy.rps if args.qos_rps is None else args.qos_rps,
        burst=env_policy.burst if args.qos_burst is None else args.qos_burst,
        tenant_inflight=(env_policy.tenant_inflight if args.qos_tenant_inflight is None
                         else args.qos_tenant_inflight),
        max_tenants=env_policy.max_tenants,
    )
    if qos_policy.enabled or qos_policy.tenant_inflight:
        logger.info(
            "qos: %.3g rps/tenant (burst %.3g), tenant inflight cap %d",
            qos_policy.rps, qos_policy.effective_burst(), qos_policy.tenant_inflight,
        )
    app = build_app(engine, tokenizer, args.model, args.chat_template, qos_policy=qos_policy)
    logger.info("openai server: %s on %s, :%d", args.model, device, args.port)
    web.run_app(app, host="0.0.0.0", port=args.port, print=None)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
