"""Registry of named injection points (own copy of
``dstack_tpu.faults.catalog``: the same ``POINTS``, so one plan validates
and fires alike in both packages).

Static on purpose: ``python -m dstack_tpu_torch.faults`` must list every
point and validate a plan OFFLINE — without importing aiohttp, jax, or
the server — so the catalog cannot be populated by side effects of
importing the instrumented modules. A tier-1 test greps the source
tree for ``faults.fire/afire/mutate`` literals and fails when an
instrumented point is missing here (or a cataloged point has no call
site), so the two cannot drift.

Context keys listed per point are what the call site passes — a plan
rule's ``ctx`` may match on any subset of them.
"""

#: point name -> (description, context keys)
POINTS: dict = {
    "gcp.api.request": (
        "GCP TPU/GCE REST call (backends/gcp/api.py Transport.request); "
        "fires before the HTTP request, mutate corrupts the parsed "
        "response",
        ("method", "url"),
    ),
    "agent.request": (
        "any shim/runner agent HTTP call "
        "(server/services/agent_client.py); raising 'connect', "
        "'oserror', 'timeout', or aiohttp.ClientConnectionError "
        "surfaces as AgentNotReady (the unreachable-agent path)",
        ("method", "path"),
    ),
    "agent.pull": (
        "the runner /api/pull poll specifically (log/state pull during "
        "RUNNING); same error mapping as agent.request",
        ("method", "path"),
    ),
    "agent.shim.healthcheck": (
        "the shim /api/healthcheck; mutate corrupts the raw response "
        "dict BEFORE schema validation — e.g. replace "
        "{'interruption_notice': ...} to simulate a spot preemption "
        "notice",
        ("method", "path"),
    ),
    "agent.tunnel.open": (
        "SSH tunnel establishment to an instance "
        "(agent_client.TunnelPool)",
        ("host", "port"),
    ),
    "routing.probe": (
        "replica /health probe (routing/pool.probe_replica); raise "
        "'connect'/'timeout' to fail the probe through the normal "
        "breaker accounting",
        ("replica",),
    ),
    "routing.forward": (
        "one forwarding attempt to a replica "
        "(routing/forward.forward_with_failover); raise "
        "'connect'/'oserror' to kill the attempt before the response "
        "streams (failover path)",
        ("replica", "attempt"),
    ),
    "routing.admit": (
        "one QoS admission decision at the proxy/gateway edge "
        "(qos.edge_admit); raise 'http:429' (+retry_after) to force "
        "the shed path deterministically, independent of bucket state",
        ("tenant", "run"),
    ),
    "serve.admit": (
        "one QoS admission decision at the OpenAI server's edge "
        "(serve/openai_server build_app _admit, via qos.edge_admit); "
        "raise 'http:429' to force a shed before any prompt work",
        ("tenant", "run"),
    ),
    "serve.engine.step": (
        "one decode step of the inference engine (serve/engine.py), "
        "fired once per live slot before the dispatch with ctx "
        "slot=<index>; runs on the worker thread — sync actions only. "
        "'hang' with a ctx slot wedges exactly that slot's step, the "
        "shape the serve scheduler's engine watchdog "
        "(DTPU_ENGINE_WATCHDOG_SECONDS) attributes and aborts. "
        "Multi-replica-in-one-process harnesses add replica=<id> via "
        "engine.fault_ctx so a rule can target one engine",
        ("slot", "replica"),
    ),
    "serve.stream": (
        "one relayed upstream chunk of a resumable SSE completion "
        "stream (routing/forward); raise 'connect'/'oserror' on the "
        "nth chunk to kill the replica mid-body — the forwarder must "
        "resume the stream on another replica (or end it with a "
        "terminal SSE error event), never a truncated/hung stream",
        ("replica", "chunk"),
    ),
    "serve.deadline": (
        "one per-request deadline check in the serve scheduler "
        "(serve/openai_server); a mutate rule's 'value' is added as "
        "clock skew (seconds) to the check, so value: 1e9 forces "
        "every armed deadline to read expired deterministically",
        (),
    ),
    "db.commit": (
        "a control-plane DB write commit (server/db.py execute/"
        "executemany/transaction); nth-call targeting provokes "
        "mid-transition reconciler crashes",
        ("sql",),
    ),
    "db.query": (
        "a control-plane DB read (server/db.py + db_pg.py "
        "fetchall/fetchone); raising makes a reconciler's read path "
        "fail independently of its writes — added when DTPU011 showed "
        "reads were the one DB path no chaos plan could fail",
        ("sql",),
    ),
    "db.lock": (
        "a cross-replica advisory-lock claim "
        "(server/db_pg.py claim_one/claim_batch); raise "
        "'connect'/'timeout' to starve a reconciler's claim pass "
        "without touching query traffic",
        ("namespace",),
    ),
    "gateway.auth": (
        "the gateway's end-user token check against the server "
        "(gateway/app.py check_user_token); raise 'oserror' to "
        "exercise the deny-on-unreachable path",
        ("url",),
    ),
    "gateway.agent": (
        "one server->gateway-agent API call "
        "(server/services/gateways.py call_agent); raise "
        "'connect'/'timeout' to make a gateway unreachable per call "
        "(the None-on-failure contract)",
        ("gateway", "path"),
    ),
    "logs.relay": (
        "the /logs_ws runner websocket dial "
        "(server/routers/logs_ws.py); raise 'connect' to fail the "
        "relay before the client upgrade (clean 502, not a dead "
        "stream)",
        ("job",),
    ),
    "db.notify": (
        "a wakeup enqueue (server/services/wakeups.enqueue); raising "
        "here LOSES the event — the entity must converge via the "
        "safety-net sweep (the enqueue is fire-and-forget, so the "
        "state transition itself is unaffected)",
        ("queue", "entity"),
    ),
    "reconciler.wakeup": (
        "one drain-worker pass, fired AFTER its wakeup batch is "
        "claimed and BEFORE any entity is processed "
        "(server/background/wakeup_drain.drain_queue); raising here is "
        "a worker killed mid-batch — its claims re-deliver to a "
        "sibling shard after the lease expires",
        ("queue", "shard"),
    ),
    "reconciler.lease": (
        "a wakeup-queue claim/lease acquisition "
        "(server/services/wakeups.claim); raise 'timeout'/'connect' to "
        "starve a shard's claim path without touching its siblings",
        ("queue", "shard"),
    ),
    "background.tick": (
        "one tick of a background reconciliation loop "
        "(server/background/scheduler.py); ctx task = loop name, e.g. "
        "process_runs",
        ("task",),
    ),
    "logs.write": (
        "job log persistence (server/services/logs file storage)",
        ("run_name",),
    ),
}
