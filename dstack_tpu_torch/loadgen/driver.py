"""Asyncio open-loop driver: fire the schedule, record the truth (the
port's copy of ``dstack_tpu.loadgen.driver``).

The driver is the "open" in open-loop: every event fires at its
compiled schedule time **regardless of what happened to earlier
requests** — no back-pressure coupling, no waiting for completions, no
retry loops. When the stack under test slows down, requests pile up
against it exactly like production arrivals would, which is the
queueing behavior a closed-loop client (one outstanding request per
virtual user) structurally cannot produce. The only honesty check the
driver applies to *itself* is schedule lag (``dtpu_loadgen_sched_lag_
seconds``): if the driver cannot keep up, the report says so instead
of silently thinning the workload.

Per fired request it records (:class:`~dstack_tpu_torch.loadgen.report.
RequestRecord`): client-observed TTFT (send → first non-empty content
delta), TPOT (mean inter-delta gap), token count, terminal outcome
(``metrics.OUTCOMES``), and the 429 ``Retry-After`` hint for the
report's honest-shed accounting. SSE streams are parsed event-wise: a
``[DONE]``-terminated stream is ``ok``, an in-band ``error`` event is
``failed_stream_error``, and a connection death without ``[DONE]`` is
``failed_truncated`` — the exact truncation the router's mid-stream
resume exists to prevent.

This module imports aiohttp (keep it OUT of the package's import-light
generator path — ``dstack_tpu_torch.loadgen`` imports it lazily).
"""

import asyncio
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import aiohttp

from dstack_tpu_torch.loadgen.metrics import get_loadgen_registry
from dstack_tpu_torch.obs.tracing import TRACE_HEADER
from dstack_tpu_torch.loadgen.report import RequestRecord
from dstack_tpu_torch.loadgen.schedule import Event
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("loadgen.driver")

#: how long past the last event the driver waits for stragglers before
#: recording them as ``abandoned`` (generous: covers a full generation
#: plus a failover/resume leg)
DEFAULT_DRAIN_S = 30.0


def default_payload(event: Event, model: str) -> dict:
    """The OpenAI-shaped request body for one event. The soak runner
    wraps this to add model-specific extras (e.g. a ``logit_bias``
    pinning a byte tokenizer to ASCII so resumed streams splice
    exactly)."""
    p: dict = {
        "model": model,
        "max_tokens": event.max_tokens,
        "temperature": event.temperature,
    }
    if event.kind == "chat":
        p["messages"] = list(event.messages or ())
    else:
        p["prompt"] = event.prompt or ""
    if event.stream:
        p["stream"] = True
    if event.seed is not None:
        p["seed"] = event.seed
    if event.priority:
        p["priority"] = event.priority
    return p


class _SSETally:
    """Incremental SSE parse of one response body: counts content
    deltas and spots terminal markers, without buffering the stream."""

    __slots__ = ("buf", "deltas", "done", "error", "finished")

    def __init__(self):
        self.buf = b""
        self.deltas = 0  # non-empty content deltas seen
        self.done = False  # [DONE] sentinel arrived
        self.error: Optional[str] = None  # in-band error event
        self.finished = False  # a finish_reason chunk arrived

    def feed(self, chunk: bytes) -> int:
        """→ number of new non-empty content deltas in this chunk."""
        self.buf += chunk
        new = 0
        while True:
            i = self.buf.find(b"\n\n")
            if i < 0:
                return new
            block, self.buf = self.buf[:i], self.buf[i + 2:]
            data_lines = [
                ln[5:].strip()
                for ln in block.split(b"\n")
                if ln.startswith(b"data:")
            ]
            if not data_lines:
                continue
            data = b"\n".join(data_lines)
            if data == b"[DONE]":
                self.done = True
                continue
            try:
                obj = json.loads(data)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            if "error" in obj and "choices" not in obj:
                detail = obj.get("error")
                if isinstance(detail, dict):
                    detail = detail.get("message") or str(detail)
                self.error = str(detail)
                continue
            choices = obj.get("choices")
            if isinstance(choices, list) and choices:
                c0 = choices[0]
                if isinstance(c0, dict):
                    delta = c0.get("delta")
                    text = (
                        delta.get("content")
                        if isinstance(delta, dict)
                        else c0.get("text")
                    )
                    if text:
                        new += 1
                        self.deltas += 1
                    if c0.get("finish_reason"):
                        self.finished = True
        # not reached


def _retry_after(resp) -> Optional[float]:
    raw = resp.headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


class OpenLoopDriver:
    """Fires a compiled schedule at a base URL and collects records.

    ``payload_for(event)`` builds each request body; ``headers_for
    (event)`` the per-request headers (the soak runner uses it to carry
    the tenant identity the router re-asserts as ``X-DTPU-Tenant``,
    exactly like an authenticated edge would)."""

    def __init__(
        self,
        base_url: str,
        payload_for: Callable[[Event], dict],
        headers_for: Optional[Callable[[Event], Dict[str, str]]] = None,
        drain_s: float = DEFAULT_DRAIN_S,
        request_timeout_s: float = 120.0,
        registry=None,
    ):
        self.base_url = base_url.rstrip("/")
        self.payload_for = payload_for
        self.headers_for = headers_for or (lambda e: {})
        self.drain_s = drain_s
        self.request_timeout_s = request_timeout_s
        # callers that embed the render in a per-run artifact pass a
        # fresh registry so back-to-back soaks in one process can't
        # leak each other's counts; the process-global default serves
        # ad-hoc driving
        self.metrics = (
            registry if registry is not None else get_loadgen_registry()
        )

    async def run(self, events: Sequence[Event]) -> List[RequestRecord]:
        """Fire every event at its schedule time → records (one per
        event, schedule order)."""
        m = self.metrics
        records: List[RequestRecord] = []
        loop = asyncio.get_running_loop()
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=self.request_timeout_s)
        ) as session:
            t0 = loop.time()
            tasks = []
            for ev in events:
                delay = t0 + ev.t - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                m.family("dtpu_loadgen_events_fired_total").inc(1)
                tasks.append(
                    asyncio.ensure_future(
                        self._fire(session, ev, t0, records)
                    )
                )
            if tasks:
                done, pending = await asyncio.wait(
                    tasks, timeout=self.drain_s
                )
                for p in pending:
                    p.cancel()
                if pending:
                    await asyncio.gather(*pending, return_exceptions=True)
        # schedule order, not lexicographic rid order (rids pad to 5
        # digits; a >100k-event schedule would interleave e100000
        # between e10000 and e10001 under a string sort)
        records.sort(key=lambda r: (r.t_sched, r.rid))
        return records

    async def _fire(
        self, session, ev: Event, t0: float, records: List[RequestRecord]
    ) -> None:
        loop = asyncio.get_running_loop()
        m = self.metrics
        t_sent = loop.time() - t0
        m.family("dtpu_loadgen_sched_lag_seconds").observe(
            max(0.0, t_sent - ev.t)
        )
        m.family("dtpu_loadgen_inflight").inc(1)
        rec = RequestRecord(
            rid=ev.rid, cls=ev.cls, tenant=ev.tenant,
            t_sched=ev.t, t_sent=t_sent, outcome="abandoned",
            session=ev.session, turn=ev.turn,
        )
        path = (
            "/v1/chat/completions" if ev.kind == "chat"
            else "/v1/completions"
        )
        try:
            await self._request(session, ev, path, rec)
        except asyncio.CancelledError:
            rec.outcome = "abandoned"
            rec.detail = "still in flight at drain timeout"
        except (aiohttp.ClientError, OSError) as e:
            if rec.ttft_s is None and rec.status is None:
                rec.outcome = "failed_connect"
            else:
                rec.outcome = "failed_truncated"
            rec.detail = repr(e)
        except asyncio.TimeoutError:
            rec.outcome = (
                "failed_connect" if rec.status is None
                else "failed_truncated"
            )
            rec.detail = "client request timeout"
        except Exception as e:  # noqa: BLE001 - the record IS the report
            # anything unexpected (e.g. a 200 whose body isn't JSON
            # from a misbehaving edge) must surface as a classified
            # failure with its detail, never masquerade as a
            # drain-timeout 'abandoned' straggler
            rec.outcome = (
                "failed_connect" if rec.status is None
                else "failed_truncated"
            )
            rec.detail = f"unexpected: {e!r}"
        finally:
            m.family("dtpu_loadgen_inflight").inc(-1)
            m.family("dtpu_loadgen_requests_total").inc(1, rec.outcome)
            if rec.ttft_s is not None:
                m.family("dtpu_loadgen_ttft_seconds").observe(rec.ttft_s)
            if rec.tpot_s is not None:
                m.family("dtpu_loadgen_tpot_seconds").observe(rec.tpot_s)
            records.append(rec)

    async def _request(self, session, ev: Event, path, rec) -> None:
        send = time.perf_counter()
        async with session.post(
            self.base_url + path,
            json=self.payload_for(ev),
            headers=self.headers_for(ev),
        ) as resp:
            rec.status = resp.status
            # the router's trace-id echo: links this record to its
            # distributed trace for the report's tail attribution
            rec.trace_id = resp.headers.get(TRACE_HEADER)
            if resp.status == 429:
                rec.outcome = "shed"
                rec.retry_after = _retry_after(resp)
                await resp.read()
                return
            if resp.status >= 500:
                rec.outcome = "failed_5xx"
                rec.detail = (await resp.text())[:200]
                return
            if resp.status >= 400:
                rec.outcome = "client_error"
                rec.detail = (await resp.text())[:200]
                return
            ctype = resp.headers.get("Content-Type", "")
            if not ctype.startswith("text/event-stream"):
                body = await resp.json(content_type=None)
                rec.ttft_s = time.perf_counter() - send
                usage = (
                    body.get("usage") if isinstance(body, dict) else None
                )
                if isinstance(usage, dict):
                    rec.tokens = int(usage.get("completion_tokens") or 0)
                rec.outcome = "ok"
                return
            tally = _SSETally()
            first = last = None
            async for chunk in resp.content.iter_chunked(16 * 1024):
                if tally.feed(chunk):
                    now = time.perf_counter()
                    if first is None:
                        first = now
                    last = now
            rec.tokens = tally.deltas
            if first is not None:
                rec.ttft_s = first - send
                if tally.deltas >= 2 and last is not None:
                    rec.tpot_s = (last - first) / (tally.deltas - 1)
            if tally.error is not None:
                # the honest terminal event the forwarder emits when a
                # stream could not be resumed — a failure by contract
                rec.outcome = "failed_stream_error"
                rec.detail = tally.error[:200]
            elif tally.done:
                rec.outcome = "ok"
            else:
                rec.outcome = "failed_truncated"
                rec.detail = "stream ended without [DONE]"
