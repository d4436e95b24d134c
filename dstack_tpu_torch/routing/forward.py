"""Health-aware request forwarding with failover — including MID-STREAM
(the port's copy of ``dstack_tpu.routing.forward``, on the port's
``faults``, ``qos``, ``obs.tracing`` and ``utils.retry``).

The one data-path helper both proxies share: pick a replica from the
pool, forward, and on a connect error or 5xx retry on a different
replica. Only when every routable replica has been tried does the
client see an error, and then it is a 503 with a ``Retry-After``
derived from the earliest breaker half-open, never a raw upstream 502.

Failover alone would stop the moment a response started streaming: a
replica dying mid-decode would truncate every in-flight completion
stream it carried. A *resumable* SSE completion stream survives the
death of the replica producing it:

- The forwarder records, per in-flight completion, the request payload
  plus the text already delivered to the client (only COMPLETE SSE
  events are ever forwarded, so the record is exact — a half-received
  event is dropped and regenerated, giving at-most-once delivery of
  every token).
- When the upstream dies mid-body (connect reset, 5xx-free socket
  death, an in-band engine error event, a ``serve.stream`` chaos
  fault), the stream is re-dispatched to another replica with the
  prompt extended by the delivered text: ``dtpu_resume`` payload +
  ``X-DTPU-Resume`` header for chat completions (the serve engine
  re-prefills prompt+delivered — cheap under the prefix cache — and
  continues the same token stream), plain prompt extension for legacy
  completions backends. Greedy and seeded-sampled requests resume
  deterministically (the engine replays the PRNG advance).
- Chunk ``id``/``created`` fields of resumed legs are rewritten to the
  original stream's, so the client sees ONE completion.
- When resume is impossible — sampling without a seed, logprobs,
  ``DTPU_STREAM_RESUME=0``, pool exhausted — the stream ends with an
  honest terminal SSE ``error`` event plus ``[DONE]``, never a silent
  truncation or a hang.

Per-request deadlines ride the same path: an ``X-DTPU-Deadline``
header (seconds) is rewritten to the REMAINING budget on every
failover/resume leg, so the budget spans the whole request.

Response headers pass through minus hop-by-hop ones, so
``x-request-id``, cache headers, and SSE headers survive the proxy.
"""

import asyncio
import json
import os
from typing import Optional

import aiohttp
from aiohttp import web

from dstack_tpu_torch import faults, qos
from dstack_tpu_torch.obs import tracing
from dstack_tpu_torch.routing.affinity import request_affinity
from dstack_tpu_torch.routing.metrics import get_router_registry
from dstack_tpu_torch.routing.pool import ReplicaPool
from dstack_tpu_torch.utils.logging import get_logger
from dstack_tpu_torch.utils.retry import Deadline

logger = get_logger("routing.forward")

#: The ONE list of proxy-asserted request headers — context the edges
#: derive/inject themselves and a client must never smuggle through:
#: the authenticated tenant identity (QoS bucket key), the mid-stream
#: resume marker (skips the serve edge's admission charge), and the
#: trace context (one spoofed value would graft an attacker's spans
#: onto a victim's trace). Shared by the forwarder's request-header
#: filter below, the serve edge's trust decisions, and the nginx site
#: template (``gateway/nginx.py`` blanks each of these), so the strip
#: list cannot drift between the three enforcement points.
PROXY_ASSERTED_HEADERS = (
    qos.TENANT_HEADER,
    qos.RESUME_HEADER,
    tracing.TRACE_HEADER,
)

# RFC 9110 hop-by-hop headers, plus the framing headers aiohttp manages
# itself. content-encoding is dropped because the client session
# auto-decompresses upstream bodies: re-advertising gzip over an
# already-inflated stream would corrupt it. The proxy-asserted headers
# are stripped here and re-injected by the edge (tenant, via
# ``extra_headers``) or the forwarder itself (resume marker and trace
# context, per dispatch leg).
_DROP_REQUEST = frozenset({
    "host", "authorization", "transfer-encoding",
    # recomputed by the client session from the body it actually sends:
    # a resume re-dispatch carries a LONGER body than the original
    # request, and relaying the stale length would truncate it upstream
    "content-length",
}) | frozenset(h.lower() for h in PROXY_ASSERTED_HEADERS)
_DROP_RESPONSE = frozenset({
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailers", "transfer-encoding", "upgrade",
    "content-length", "content-encoding",
})


def filter_request_headers(headers) -> dict:
    return {k: v for k, v in headers.items() if k.lower() not in _DROP_REQUEST}


def copy_response_headers(upstream, resp: web.StreamResponse) -> None:
    for k, v in upstream.headers.items():
        if k.lower() not in _DROP_RESPONSE:
            resp.headers.add(k, v)


def stream_resume_enabled() -> bool:
    """``DTPU_STREAM_RESUME`` gate (default on): 0/false disables the
    resumable-stream machinery — mid-stream upstream death then ends
    the stream with a terminal SSE error event instead of resuming."""
    return os.getenv("DTPU_STREAM_RESUME", "1").strip().lower() not in (
        "0", "false", "no",
    )


def resume_record_max_chars() -> int:
    """``DTPU_STREAM_RESUME_MAX_CHARS`` (default 2_000_000): cap on
    the delivered-text record one resumable stream may accumulate.
    A stream past the cap stops being resumable (its record is the
    resume prompt — unbounded growth would be a per-stream memory
    flood) and ends with an honest terminal error if its replica
    dies."""
    try:
        return int(
            os.getenv("DTPU_STREAM_RESUME_MAX_CHARS", "").strip()
            or 2_000_000
        )
    except (TypeError, ValueError):
        return 2_000_000


def _json_payload(body: bytes) -> Optional[dict]:
    """The request body as a JSON object, or None (non-JSON bodies are
    forwarded verbatim; they just carry no resume/affinity context)."""
    try:
        payload = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


# "caller did not parse" sentinel: distinguishes a pre-parsed body that
# turned out not to be a JSON object (payload=None — do NOT parse again)
# from a direct call that never parsed at all
_UNPARSED = object()


def _edge_deadline(headers) -> Optional[Deadline]:
    """The request's wall-clock budget from ``X-DTPU-Deadline``
    (seconds, float), or None. Malformed values are ignored — a bad
    header must not 400 the data path."""
    raw = headers.get(qos.DEADLINE_HEADER)
    if not raw:
        return None
    try:
        return Deadline(max(0.0, float(raw)))
    except (TypeError, ValueError):
        return None


def _is_sse(headers) -> bool:
    return headers.get("Content-Type", "").startswith("text/event-stream")


async def _write_stream_error(resp: web.StreamResponse, detail: str) -> None:
    """Terminal in-band failure for a stream whose headers are already
    committed: an OpenAI-shaped ``error`` event plus ``[DONE]`` so
    client SSE parsers fail cleanly instead of hanging on a truncated
    stream or choking on a mid-stream raw 5xx."""
    event = {"error": {"message": detail, "type": "upstream_error"}}
    try:
        # leading blank line: the opaque relay path may have left a
        # PARTIAL event on the wire — without the separator the error
        # event would glue onto the garbled line and the truncation
        # would be silent, the exact failure this event exists to
        # surface (SSE parsers ignore stray blank lines, so the
        # separator is harmless on event-aligned streams)
        await resp.write(b"\n\n")
        await resp.write(b"data: " + json.dumps(event).encode() + b"\n\n")
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
    except (ConnectionError, RuntimeError, aiohttp.ClientError):
        pass  # client already gone: nobody left to tell


class _ResumeState:
    """Everything needed to continue one in-flight completion stream on
    another replica: the original payload, the text already delivered
    to the client, and the first leg's stream identity."""

    __slots__ = (
        "kind", "payload", "prompt", "delivered", "completion_id",
        "created", "finished", "done_sent", "resumes", "max_chars",
        "oversized",
    )

    def __init__(self, kind: str, payload: dict):
        self.kind = kind  # "chat" | "completions"
        self.payload = payload
        self.prompt = payload.get("prompt") if kind == "completions" else None
        self.delivered = ""  # text relayed to the client so far
        self.completion_id: Optional[str] = None
        self.created = None
        self.finished = False  # a finish_reason chunk was relayed
        self.done_sent = False  # the [DONE] sentinel was relayed
        self.resumes = 0
        # the delivered record IS the resume prompt: bound it so one
        # pathological stream cannot grow proxy memory without limit —
        # past the cap the stream simply stops being resumable
        self.max_chars = resume_record_max_chars()
        self.oversized = False

    def resume_body(self) -> bytes:
        """The re-dispatch payload: the original request with the
        prompt extended by the delivered text. Chat requests carry it
        as the ``dtpu_resume`` extension (the serve engine appends it
        after the rendered chat template and skips re-charging QoS,
        gated on the proxy-asserted ``X-DTPU-Resume`` header); legacy
        completions extend ``prompt`` directly — standard OpenAI
        semantics any backend understands (the continuation may then
        over-generate by up to the delivered token count, since the
        proxy cannot re-tokenize to shrink ``max_tokens``)."""
        p = dict(self.payload)
        if self.kind == "completions":
            p["prompt"] = (self.prompt or "") + self.delivered
        else:
            p["dtpu_resume"] = {"text": self.delivered}
        return json.dumps(p).encode()


def _resumable_stream(
    method: str, path: str, body: bytes, payload=_UNPARSED
) -> Optional[_ResumeState]:
    """→ a :class:`_ResumeState` when this request is a resumable
    OpenAI completion stream, else None.

    Eligibility (the serving.md §9 table): a streaming single-choice
    completions/chat-completions POST whose token sequence is a pure
    function of the (extended) prompt — greedy, or seeded sampling —
    with no generated-only state the continuation cannot reconstruct
    (presence/frequency penalties count only generated tokens; logprob
    streams would misalign across the splice)."""
    if method != "POST" or not stream_resume_enabled():
        return None
    leaf = path.rstrip("/")
    if leaf.endswith("chat/completions"):
        kind = "chat"
    elif leaf.endswith("completions"):
        kind = "completions"
    else:
        return None
    if payload is _UNPARSED:
        payload = _json_payload(body)
    if not isinstance(payload, dict) or not payload.get("stream"):
        return None
    if payload.get("n") not in (None, 1):
        return None
    if payload.get("logprobs") or payload.get("top_logprobs"):
        return None
    if payload.get("tools"):
        # tool-call deltas never enter the delivered-text record (only
        # prose content does), so a resume would regenerate and
        # re-emit tool calls the client already received
        return None
    if kind == "completions" and not isinstance(payload.get("prompt"), str):
        return None

    def _f(key: str) -> float:
        try:
            return float(payload.get(key) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    if _f("temperature") > 0.0 and (
        payload.get("seed") is None or kind != "chat"
    ):
        # unseeded sampling can't replay its RNG at all; seeded resume
        # needs the dtpu_resume extension to carry the PRNG advance —
        # legacy completions resume by plain prompt extension, which
        # can't, so only GREEDY completions are resumable there
        return None
    if _f("presence_penalty") != 0.0 or _f("frequency_penalty") != 0.0:
        return None  # generated-only penalty state is lost at the splice
    return _ResumeState(kind, payload)


class _SSERelay:
    """Parses an upstream SSE byte stream into complete events, so the
    forwarder only ever delivers whole events and knows exactly what
    text the client has — the record a resume continues from."""

    def __init__(self, state: _ResumeState):
        self.state = state
        self._buf = b""

    def reset(self) -> None:
        """Drop any half-received event before pumping a resumed leg:
        un-forwarded bytes are regenerated by the continuation."""
        self._buf = b""

    def feed(self, chunk: bytes) -> tuple[list, Optional[str]]:
        """→ (event blocks to forward to the client, in-band error
        detail or None). Only COMPLETE (blank-line-terminated) events
        leave the buffer; an in-band ``{"error": ...}`` event is
        withheld from the client and reported for failover instead."""
        self._buf += chunk
        out: list = []
        while True:
            i = self._buf.find(b"\n\n")
            if i < 0:
                return out, None
            block, self._buf = self._buf[: i + 2], self._buf[i + 2:]
            fwd, err = self._event(block)
            if err is not None:
                return out, err
            if fwd is not None:
                out.append(fwd)

    def _event(self, block: bytes) -> tuple[Optional[bytes], Optional[str]]:
        st = self.state
        data_lines = [
            line[5:].strip()
            for line in block.split(b"\n")
            if line.startswith(b"data:")
        ]
        if not data_lines:
            return block, None  # comment/keepalive frames pass through
        data = b"\n".join(data_lines)
        if data == b"[DONE]":
            st.done_sent = True
            return block, None
        try:
            obj = json.loads(data)
        except ValueError:
            return block, None  # not a JSON event: relay verbatim
        if isinstance(obj, dict) and "error" in obj and "choices" not in obj:
            # the replica reported failure in-band (engine fault,
            # watchdog abort): that's upstream death, not a payload
            detail = obj.get("error")
            if isinstance(detail, dict):
                detail = detail.get("message") or str(detail)
            return None, str(detail)
        choices = obj.get("choices") if isinstance(obj, dict) else None
        delta_text = ""
        if isinstance(choices, list) and choices:
            c0 = choices[0]
            if isinstance(c0, dict):
                delta = c0.get("delta")
                if isinstance(delta, dict):
                    delta_text = delta.get("content") or ""
                else:
                    delta_text = c0.get("text") or ""
                if c0.get("finish_reason"):
                    st.finished = True
        if st.completion_id is None and isinstance(obj, dict):
            st.completion_id = obj.get("id")
            st.created = obj.get("created")
        if (
            st.resumes
            and isinstance(obj, dict)
            and st.completion_id is not None
            and obj.get("id") != st.completion_id
        ):
            # a resumed leg mints its own completion id; the client
            # must see ONE stream — rewrite to the original identity
            obj["id"] = st.completion_id
            if st.created is not None:
                obj["created"] = st.created
            block = b"data: " + json.dumps(obj).encode() + b"\n\n"
        if not st.oversized:
            st.delivered += delta_text
            if len(st.delivered) > st.max_chars:
                st.oversized = True
                st.delivered = ""  # free the record; it can't be used now
        return block, None


async def _pump_resumable(
    pool, entry, upstream, resp: web.StreamResponse, relay: _SSERelay
) -> str:
    """Relay one upstream leg of a resumable stream → ``"done"`` (the
    leg delivered its terminal [DONE]), ``"upstream_died"`` (replica's
    fault — caller should resume elsewhere), ``"client_gone"``, or
    ``"timeout"`` (the proxy's own total-timeout budget: not the
    replica's fault and not resumable, the budget is spent)."""
    chunk_no = 0
    try:
        async for chunk in upstream.content.iter_chunked(64 * 1024):
            chunk_no += 1
            # chaos hook: kill the upstream mid-body on the nth chunk
            await faults.afire(
                "serve.stream", replica=entry.replica_id, chunk=chunk_no
            )
            events, inband_error = relay.feed(chunk)
            for block in events:
                try:
                    await resp.write(block)
                except (ConnectionError, RuntimeError):
                    return "client_gone"
            if inband_error is not None:
                pool.report_failure(entry)
                logger.warning(
                    "replica %s of %s/%s failed in-band mid-stream: %s",
                    entry.replica_id, pool.project, pool.run_name,
                    inband_error,
                )
                return "upstream_died"
    except asyncio.TimeoutError:
        # ordering matters: TimeoutError subclasses OSError, and this
        # is the proxy session's own budget, not replica failure
        logger.warning(
            "stream to %s/%s hit the proxy timeout budget",
            pool.project, pool.run_name,
        )
        return "timeout"
    except (aiohttp.ClientError, OSError) as e:
        pool.report_failure(entry)
        logger.warning(
            "replica %s died mid-stream for %s/%s: %r",
            entry.replica_id, pool.project, pool.run_name, e,
        )
        return "upstream_died"
    if relay.state.done_sent:
        return "done"
    # clean EOF without [DONE]: the replica closed mid-generation
    pool.report_failure(entry)
    logger.warning(
        "replica %s of %s/%s closed its stream without [DONE]",
        entry.replica_id, pool.project, pool.run_name,
    )
    return "upstream_died"


async def _stream_body(pool, entry, upstream, resp: web.StreamResponse):
    """Relay the upstream body chunk by chunk (the non-resumable path),
    attributing failures to the right side: an upstream read error is
    the replica's fault (it died mid-stream — breaker accounting,
    truncated stream ended); a client write error is not (clients abort
    streams routinely; marking a healthy replica DEAD for that would
    503 real traffic). SSE streams that die — upstream death or the
    proxy's own total-timeout — end with a terminal error event plus
    [DONE], so OpenAI-client parsers fail cleanly instead of hanging."""
    try:
        async for chunk in upstream.content.iter_chunked(64 * 1024):
            try:
                await resp.write(chunk)
            except (ConnectionError, RuntimeError):
                return resp  # client disconnected: no replica penalty
        await resp.write_eof()
    except (aiohttp.ClientError, asyncio.TimeoutError) as e:
        if not isinstance(e, aiohttp.ClientError):
            # the proxy session's own total-timeout budget ran out on a
            # long stream — the proxy's limit, not replica failure: no
            # breaker penalty, just end the truncated stream
            logger.warning(
                "stream to %s/%s hit the proxy timeout budget",
                pool.project, pool.run_name,
            )
            detail = "proxy stream timeout budget exceeded"
        else:
            pool.report_failure(entry)
            logger.warning(
                "replica %s died mid-stream for %s/%s: %r",
                entry.replica_id, pool.project, pool.run_name, e,
            )
            detail = "upstream replica died mid-stream"
        if _is_sse(getattr(resp, "headers", {})):
            await _write_stream_error(resp, detail)
            return resp
        try:
            await resp.write_eof()
        except (ConnectionError, RuntimeError, aiohttp.ClientError):
            pass
    return resp


async def forward_with_failover(
    request: web.Request,
    pool: ReplicaPool,
    session: aiohttp.ClientSession,
    path: str,
    max_attempts: Optional[int] = None,
    extra_headers: Optional[dict] = None,
) -> web.StreamResponse:
    """Forward ``request`` to a pool replica, failing over across
    replicas until one answers or the pool is exhausted — including
    MID-STREAM for resumable completion streams (see module docs).

    ``extra_headers`` lets the edge inject proxy-derived context the
    client cannot be trusted to set itself — e.g. the authenticated
    tenant identity (``X-DTPU-Tenant``) the replica's QoS layer keys
    on; they override same-named client headers."""
    body = await request.read()
    req_headers = filter_request_headers(request.headers)
    if extra_headers:
        req_headers.update(extra_headers)
    deadline = _edge_deadline(request.headers)
    # parse the body once, and ONLY when something will consume it:
    # a completion-path POST with resume or affinity on. Arbitrary
    # proxied POSTs (uploads, non-completion APIs) must not pay an
    # O(body) json.loads on the event loop for nothing.
    wants_payload = (
        request.method == "POST"
        and path.rstrip("/").endswith("completions")
        and (stream_resume_enabled() or pool.affinity.config.enabled)
    )
    payload = _json_payload(body) if wants_payload else None
    resume = _resumable_stream(request.method, path, body, payload)
    # prompt-prefix affinity: completion payloads digest into a prefix
    # chain + tenant session key; pick() prefers the replica whose KV
    # already covers the deepest shared prefix (serving.md §10). A
    # resume leg re-keys to the SAME digests, so a resumed stream also
    # prefers whichever peer may hold its prefix.
    affinity_key = (
        request_affinity(path, payload, req_headers.get(qos.TENANT_HEADER))
        if pool.affinity.config.enabled
        else None
    )
    query = f"?{request.query_string}" if request.query_string else ""
    limit = max_attempts if max_attempts is not None else max(1, pool.size())
    # the forward span: parented to the edge's root (the server
    # middleware / gateway handler stash it on the request) or — at an
    # edge without one — a fresh root. Client-supplied X-DTPU-Trace is
    # NEVER honored here: it was stripped above, and each dispatch leg
    # below gets its own child span whose header() the replica trusts.
    fspan = tracing.span(
        "router.forward",
        parent=request.get(tracing.REQUEST_SPAN_KEY),
        service=f"{pool.project}/{pool.run_name}",
    )
    try:
        return await _forward_legs(
            request, pool, session, path, fspan, body, req_headers,
            deadline, resume, affinity_key, query, limit,
        )
    finally:
        fspan.end()


async def _forward_legs(
    request, pool, session, path, fspan, body, req_headers, deadline,
    resume, affinity_key, query, limit,
) -> web.StreamResponse:
    """The per-leg failover loop of :func:`forward_with_failover`
    (split out so the forward span's lifetime is one try/finally)."""
    m = get_router_registry()
    tried: set = set()
    attempts = 0
    last_error = "no routable replicas"
    resp: Optional[web.StreamResponse] = None  # committed client response
    relay: Optional[_SSERelay] = None
    while attempts < limit:
        if deadline is not None and deadline.expired():
            last_error = "request deadline exceeded"
            break
        entry = pool.pick(exclude=tried, affinity=affinity_key, span=fspan)
        if entry is None:
            break
        if attempts > 0 and resp is None:
            # pre-stream retry; mid-stream re-dispatches count in
            # dtpu_router_stream_resumes_total instead
            m.family("dtpu_router_failovers_total").inc(1)
        attempts += 1
        tried.add(entry.replica_id)
        is_resume_leg = resp is not None and resume is not None
        # one child span per dispatch leg: failover retries and resume
        # legs attach to the ORIGINAL trace as siblings, so a stitched
        # waterfall shows the dead leg next to the one that continued it
        leg = tracing.span(
            "router.dispatch", parent=fspan,
            replica=entry.replica_id, attempt=attempts,
            resume=is_resume_leg,
        )
        url = f"http://{entry.host}:{entry.port}/{path.lstrip('/')}{query}"
        send_body, send_headers = body, req_headers
        if is_resume_leg:
            # resuming mid-stream: prompt extended by delivered text,
            # marker header asserted (clients can't — _DROP_REQUEST)
            send_body = resume.resume_body()
            send_headers = {**req_headers, qos.RESUME_HEADER: "1"}
        if leg.recording:
            # proxy-asserted trace context: the replica parents its
            # serve.request span to THIS leg (client values stripped)
            send_headers = {
                **send_headers, tracing.TRACE_HEADER: leg.header(),
            }
        if deadline is not None:
            # replace case-insensitively: an HTTP/2-terminating LB
            # lowercases header names, and a dict-spread under a
            # differently-cased key would DUPLICATE the header — the
            # replica would read the stale full budget first
            send_headers = {
                k: v for k, v in send_headers.items()
                if k.lower() != qos.DEADLINE_HEADER.lower()
            }
            send_headers[qos.DEADLINE_HEADER] = f"{deadline.remaining():.3f}"
        pool.acquire(entry)
        try:
            try:
                await faults.afire(
                    "routing.forward",
                    replica=entry.replica_id, attempt=attempts,
                )
                upstream_ctx = session.request(
                    request.method, url, data=send_body, headers=send_headers
                )
                upstream = await upstream_ctx.__aenter__()
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
                # connect/send failure: replica's fault, safe to retry
                pool.report_failure(entry)
                last_error = repr(e)
                leg.end("error", error=last_error)
                continue
            try:
                if upstream.status >= 500:
                    # response not committed: another replica may serve
                    pool.report_failure(entry)
                    last_error = f"replica answered {upstream.status}"
                    leg.end("error", http_status=upstream.status)
                    continue
                if resp is not None:
                    # a resume leg must stream a 200 SSE continuation;
                    # anything else is that replica refusing the resume
                    if upstream.status != 200 or not _is_sse(upstream.headers):
                        pool.report_failure(entry)
                        last_error = (
                            f"resume answered {upstream.status} "
                            f"({upstream.headers.get('Content-Type', '')!r})"
                        )
                        leg.end("error", error=last_error)
                        continue
                    pool.report_success(entry)
                    pool.affinity.record(affinity_key, entry.replica_id)
                    resume.resumes += 1
                    relay.reset()
                    m.family("dtpu_router_stream_resumes_total").inc(1)
                    logger.warning(
                        "stream for %s/%s resumed on replica %s "
                        "(%d chars already delivered)",
                        pool.project, pool.run_name, entry.replica_id,
                        len(resume.delivered),
                    )
                else:
                    pool.report_success(entry)
                    if upstream.status < 300:
                        # learn the mapping only from ACCEPTED requests:
                        # this replica's prefix registry will hold the
                        # prompt's KV once prefill lands, and future
                        # turns extend exactly this digest chain. A
                        # 4xx (QoS shed, over-length prompt) never
                        # prefilled — recording it would steer the
                        # session back at the replica that just shed it
                        pool.affinity.record(affinity_key, entry.replica_id)
                    resp = web.StreamResponse(status=upstream.status)
                    copy_response_headers(upstream, resp)
                    if fspan.recording:
                        # echo the BARE trace id (never the span id —
                        # that would let the client mint trusted child
                        # context) so callers can query /debug/traces
                        resp.headers[tracing.TRACE_HEADER] = fspan.trace_id
                    if resume is not None and _is_sse(upstream.headers):
                        relay = _SSERelay(resume)
                    try:
                        await resp.prepare(request)
                    except (ConnectionError, RuntimeError) as e:
                        # the CLIENT went away before/while the response
                        # was being committed — not the replica's fault;
                        # no breaker penalty, nothing left to answer
                        logger.debug("client gone during response: %r", e)
                        leg.end("client_gone")
                        return resp
                    if relay is None:
                        out = await _stream_body(pool, entry, upstream, resp)
                        leg.end("ok", http_status=upstream.status, opaque=True)
                        return out
                outcome = await _pump_resumable(
                    pool, entry, upstream, resp, relay
                )
                leg.end(
                    "ok" if outcome == "done"
                    else "error" if outcome == "upstream_died"
                    else outcome,
                    http_status=upstream.status,
                )
            finally:
                await upstream_ctx.__aexit__(None, None, None)
        finally:
            pool.release(entry)
            # safety net for paths that raise out of the leg (e.g. an
            # injected routing.forward HTTP fault): idempotent, so
            # every explicitly-ended leg above keeps its status
            leg.end("error", aborted=True)
        if outcome in ("done", "client_gone"):
            if outcome == "done":
                try:
                    await resp.write_eof()
                except (ConnectionError, RuntimeError, aiohttp.ClientError):
                    pass
            return resp
        if outcome == "timeout":
            await _write_stream_error(
                resp, "proxy stream timeout budget exceeded"
            )
            return resp
        # upstream_died: resume on another replica. If the generation
        # actually finished and only the [DONE] sentinel was lost,
        # close out the stream honestly instead of re-dispatching.
        if resume.finished:
            await _write_stream_error_suffix(resp)
            return resp
        if resume.oversized:
            # delivered record outgrew DTPU_STREAM_RESUME_MAX_CHARS
            # and was dropped: no prompt to splice a continuation from
            await _write_stream_error(
                resp,
                "stream not resumable: delivered text exceeded the "
                "resume record cap",
            )
            return resp
        last_error = "replica died mid-stream"
    if resp is not None:
        # stream committed and no replica can continue it: honest
        # terminal error event (sampled-without-seed and resume-off
        # streams never get here — they take the _stream_body path)
        await _write_stream_error(
            resp,
            f"stream could not be resumed: {last_error} "
            f"({len(resume.delivered)} chars delivered)",
        )
        return resp
    err_headers = (
        {tracing.TRACE_HEADER: fspan.trace_id} if fspan.recording else {}
    )
    if deadline is not None and deadline.expired():
        fspan.event("deadline_expired")
        return web.json_response(
            {"detail": f"request deadline exceeded before {pool.run_name} answered"},
            status=504,
            headers=err_headers,
        )
    m.family("dtpu_router_exhausted_total").inc(1)
    fspan.event("pool_exhausted", error=last_error)
    return web.json_response(
        {
            "detail": (
                f"no healthy replicas for {pool.run_name} "
                f"({last_error})"
            )
        },
        status=503,
        headers={"Retry-After": str(pool.retry_after_hint()), **err_headers},
    )


async def _write_stream_error_suffix(resp: web.StreamResponse) -> None:
    """A finish chunk was delivered but the [DONE] sentinel died with
    the replica: emit it so parsers terminate cleanly."""
    try:
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
    except (ConnectionError, RuntimeError, aiohttp.ClientError):
        pass
