"""Full-stack soak: real replicas, real router, real QoS, real chaos
(the port's copy of ``dstack_tpu.loadgen.soak``).

The runner behind ``python -m dstack_tpu_torch.loadgen``: stands up N (≥ 2)
REAL in-process replicas — each a live :class:`InferenceEngine` of the
port, on the card unless ``SoakConfig.device`` is ``cpu``, behind its
own :func:`serve.openai_server.build_app` with QoS admission enabled —
puts the REAL :func:`routing.forward.forward_with_failover` over a
:class:`routing.pool.ReplicaPool` in front of them (probe loop
included, exactly the production data path), fires the compiled
open-loop schedule through the router, and writes a ``SOAK_rNN.json``
artifact scoring goodput under SLO (by default under ``build/``).

The harness replicas share one weights tree and, on the card, one
device lock: their engines take turns on the card as one server's calls
do, so every kernel launch is counted once and no graph capture runs
beside another replica's launches. The scale-up replica draws its own tree
from nothing (seed 1), timed by its boot recorder.

Mid-soak chaos, on by default:

- **Drain flip**: one replica is marked DRAINING partway in and put
  back in rotation (``cancel_draining``) at the window's end — the
  scale-down/upgrade shape; the picker must route around it with zero
  client-visible errors.
- **Replica kill**: later, a different replica "dies": a
  ``serve.stream`` fault rule (installed through the real
  :mod:`dstack_tpu_torch.faults` plan machinery, merged into any active
  ``DTPU_FAULT_PLAN``) severs every in-flight and future stream chunk
  from that replica while its listener socket stops accepting — so
  in-flight streams take the mid-stream resume path onto a
  survivor and new requests fail over, and the breaker converges the
  pool to DEAD. The replica's *process* survives (this is an
  in-process harness) but the router must treat it exactly like a
  death. The acceptance bar: **zero client 5xx through the kill**.

Both windows land in the report's tail-amplification block.

This module imports torch and aiohttp lazily — keep it out of the
package's import-light generator path (``__main__`` imports it
directly).
"""

import asyncio
import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from dstack_tpu_torch.loadgen.report import EventWindow, evaluate
from dstack_tpu_torch.loadgen.schedule import EventSchedule
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("loadgen.soak")

#: router metric families snapshotted into the artifact (delta over
#: the soak, so back-to-back runs in one process stay honest)
_ROUTER_FAMILIES = (
    "dtpu_router_failovers_total",
    "dtpu_router_stream_resumes_total",
    "dtpu_router_breaker_opens_total",
    "dtpu_router_exhausted_total",
    "dtpu_router_affinity_hits_total",
    "dtpu_router_affinity_overrides_total",
    "dtpu_router_slo_degraded_total",
    "dtpu_router_slo_restored_total",
)


@dataclass
class SoakConfig:
    """Everything about the soak that is NOT the workload (the
    workload lives in the spec; this is the stack under test)."""

    replicas: int = 2
    model: str = "llama-tiny"
    qos_rps: float = 2.0  # per-tenant bucket rate at each serve edge
    qos_burst: float = 6.0
    tenant_inflight: int = 0
    max_batch: int = 8
    max_seq: int = 2048
    prefill_chunk: int = 64
    probe_interval_s: float = 0.5
    # chaos (soak-relative fractions of the schedule duration)
    chaos: bool = True
    drain_start_frac: float = 0.25
    drain_end_frac: float = 0.40
    kill_frac: float = 0.60
    kill_window_s: float = 8.0  # scored amplification window after kill
    # extra fault rules merged into the plan AT kill time (rule
    # counters restart with the new plan, so nth counts from the kill)
    # — the SLO chaos acceptance injects bounded serve.engine.step
    # errors on a SURVIVOR here: clients ride the resume path, the
    # replica's own error counter burns its SLO
    kill_extra_rules: Optional[list] = None
    # scale-up (obs/boot.py): mid-soak a COLD extra replica is built
    # from nothing — params init, engine construction, HTTP warmup,
    # prefix-copy warm — under its own boot recorder, then joins the
    # pool via sync(); the artifact gains a `boot` block decomposing
    # its time-to-first-served-token by stage plus a scored
    # `scale_up` goodput/tail window around the join: the
    # scale-out-latency baseline (BOOT_rNN.json).
    scale_up: bool = False
    scale_up_frac: float = 0.45  # spawn at this fraction of the soak
    scale_up_window_s: float = 8.0  # scored window after the spawn
    # live SLO engine over the soak's own pool (obs/slo.py): a policy
    # dict turns it on — per-replica windows are ingested from the
    # probe loop's /health captures, burn alerts evaluated every
    # slo_tick_s, per-replica fast-burn firing pins the replica
    # DEGRADED exactly like the server's process_slo, and the artifact
    # gains an `slo` block with the transition timeline
    slo_policy: Optional[dict] = None
    slo_windows: Optional[dict] = None  # window name -> seconds (as-is)
    slo_tick_s: float = 0.5
    drain_s: float = 30.0  # driver straggler budget past the last event
    # under the gitignored build/: the repo root's SOAK_r01.json is the
    # JAX package's artifact
    output: Optional[str] = os.path.join("build", "SOAK_r01.json")
    device: str = "cuda"  # the replicas' device: the card unless "cpu"


#: the largest request body the soak's replicas and router read. aiohttp's
#: default, 1 MiB, which a server keeps (the JAX server's and the port's
#: ``build_app`` default), refuses the ASCII bias over a large vocabulary:
#: 128,128 banned ids of llama-3.2-1b's vocabulary are 1.9 MB of JSON
#: (ROADMAP C)
MAX_BODY_BYTES = 16 << 20


class _Replica:
    __slots__ = ("rid", "engine", "app", "runner", "site", "port", "killed")

    def __init__(self, rid, engine, app, runner, site, port):
        self.rid = rid
        self.engine = engine
        self.app = app
        self.runner = runner
        self.site = site
        self.port = port
        self.killed = False


async def _start_replica(
    rid: str, engine, model: str, policy, device_lock, boot=None
):
    from aiohttp import web

    from dstack_tpu_torch.serve.openai_server import build_app
    from dstack_tpu_torch.serve.tokenizer import ByteTokenizer

    # boot=None keeps the harness replicas OFF the process-global boot
    # recorder (one process, many replicas — only the scale-up replica
    # carries one, and it brings its own)
    app = build_app(
        engine, ByteTokenizer(), model, qos_policy=policy, boot=boot,
        device_lock=device_lock, client_max_size=MAX_BODY_BYTES,
    )
    runner = web.AppRunner(app)
    await runner.setup()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    site = web.SockSite(runner, sock)
    await site.start()
    return _Replica(rid, engine, app, runner, site, port)


def _router_app(pool, session_holder):
    """The minimal production edge: every request forwarded through
    ``forward_with_failover``, with the soak's tenant identity
    re-asserted as the proxy-trusted ``X-DTPU-Tenant`` (the driver
    sends ``X-Soak-Tenant``; a real edge would derive it from auth —
    either way the client-supplied QoS header never passes through)."""
    from aiohttp import web

    from dstack_tpu_torch import qos
    from dstack_tpu_torch.routing.forward import forward_with_failover

    # the replicas' body limit: the ASCII bias over a large vocabulary
    # passes aiohttp's default 1 MiB
    app = web.Application(client_max_size=MAX_BODY_BYTES)

    async def handler(request):
        tenant = request.headers.get("X-Soak-Tenant") or "anonymous"
        return await forward_with_failover(
            request, pool, session_holder["session"],
            request.match_info["path"],
            extra_headers={qos.TENANT_HEADER: tenant},
        )

    app.router.add_route("*", "/{path:.*}", handler)
    return app


async def _probe_loop(pool, interval: float):
    import aiohttp

    async with aiohttp.ClientSession() as session:
        while True:
            targets = pool.probe_targets()
            if targets:
                await asyncio.gather(
                    *(pool.probe_replica(session, e) for e in targets),
                    return_exceptions=True,
                )
            await asyncio.sleep(interval)


async def _warmup(replicas: List[_Replica], model: str, bias: dict):
    """Capture every step variant the soak will hit, per replica,
    outside the timed schedule. The timed numbers must measure the
    stack, not graph captures: that means covering not just one prompt but the shape
    *buckets* the schedule exercises — short and long chat prompts
    (different chunk counts), a completion prompt, a full-size decode
    budget, and CONCURRENT arrivals (the packed-prefill G=2/G=4
    variants capture only when a wave actually packs). Warmup text is
    then dropped from the prefix cache so the soak starts cold."""
    import aiohttp

    long_text = " ".join(f"warm{i}" for i in range(180))
    short_text = " ".join(f"warm{i}" for i in range(30))

    def _chat(text):
        return ("/v1/chat/completions", {
            "model": model, "max_tokens": 16, "stream": True,
            "temperature": 0.0, "logit_bias": bias,
            "messages": [{"role": "user", "content": text}],
        })

    def _completion(text):
        return ("/v1/completions", {
            "model": model, "max_tokens": 16, "stream": True,
            "temperature": 0.0, "logit_bias": bias, "prompt": text,
        })

    seq = iter(range(10_000))

    async def _one(session, base, path, payload):
        # one tenant per warmup request: warmup must never collide
        # with the replica's own QoS burst (a shed here would abort
        # the soak, and warmup traffic is not part of the workload)
        async with session.post(
            base + path, json=payload,
            headers={"X-DTPU-Tenant": f"warmup-{next(seq)}"},
        ) as resp:
            await resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"warmup {path} answered {resp.status}"
                )

    async with aiohttp.ClientSession() as session:
        for r in replicas:
            base = f"http://127.0.0.1:{r.port}"
            # serial pass: each shape bucket compiles alone
            for path, payload in (
                _chat(short_text), _chat(long_text),
                _completion(long_text),
            ):
                await _one(session, base, path, payload)
            # concurrent pass: four at once so prefill waves PACK and
            # the G>1 bucket variants compile now, not mid-soak
            await asyncio.gather(*(
                _one(session, base, path, dict(payload))
                for path, payload in (
                    _chat(short_text + " a"), _chat(short_text + " b"),
                    _chat(long_text + " a"), _chat(long_text + " b"),
                )
            ))
            r.engine.reset_prefix_cache()


async def _drain_flip(pool, rid: str, start: float, end: float):
    await asyncio.sleep(start)
    pool.mark_draining(rid)
    logger.warning("soak chaos: replica %s DRAINING at t=%.1fs", rid, start)
    await asyncio.sleep(max(0.0, end - start))
    pool.cancel_draining(rid)
    logger.warning("soak chaos: replica %s drain cancelled", rid)


async def _slo_loop(engine, pool, scope: str, interval: float):
    """The soak's in-process analogue of the server's process_slo
    loop — ingest, evaluate, pin — via the SAME obs.slo helpers the
    server uses, so the chaos acceptance exercises the production
    contract, not a reimplementation."""
    from dstack_tpu_torch.obs import slo as obs_slo

    while True:
        obs_slo.ingest_pool_windows(engine, pool, scope)
        transitions = engine.evaluate()
        obs_slo.apply_replica_pins(pool, transitions, scope=scope)
        for tr in transitions:
            logger.warning(
                "soak slo_alert %s: %s %s%s burn=%.1fx",
                tr.state, tr.severity, tr.objective,
                f" replica={tr.replica}" if tr.replica else "", tr.burn,
            )
        await asyncio.sleep(interval)


async def _kill_replica(
    replica: _Replica, seed: int, at: float, extra_rules=None
):
    """The mid-soak death: merge a ``serve.stream`` connect-error rule
    for this replica into the active fault plan (the deterministic
    kill of every in-flight stream — the forwarder resumes them
    elsewhere), stop its listener (new connects fail over), and
    force-close its established connections (a dead process holds no
    keep-alive sockets — without this, pooled router and probe
    connections would keep reaching the 'corpse' and the breaker
    would never learn it died)."""
    from dstack_tpu_torch import faults

    await asyncio.sleep(at)
    rules = []
    prior = faults.current_plan()
    if prior is not None:
        rules.extend(r.raw for r in prior.rules)
    rules.append({
        "point": "serve.stream",
        "ctx": {"replica": replica.rid},
        "action": "raise",
        "error": "connect",
    })
    if extra_rules:
        rules.extend(extra_rules)
    faults.install_plan({"seed": seed, "rules": rules})
    await replica.site.stop()
    if replica.runner.server is not None:
        # a SMALL positive timeout, then cancel in-progress handlers
        # and close their transports (aiohttp treats timeout=0 as "no
        # timeout" and would wait forever for in-flight streams — the
        # exact opposite of a death); the outer bound keeps a wedged
        # handler from stalling the chaos task itself
        try:
            await asyncio.wait_for(
                replica.runner.server.shutdown(timeout=0.05), timeout=2.0
            )
        except asyncio.TimeoutError:
            pass
    replica.killed = True
    logger.warning(
        "soak chaos: replica %s killed at t=%.1fs (listener stopped, "
        "connections severed, serve.stream fault installed)",
        replica.rid, at,
    )


async def _on_device(device_lock, fn):
    """``fn()`` under the replicas' shared device lock on a worker thread,
    as their schedulers run their device work, so that it never overlaps
    another replica's graph capture; directly where there is no lock
    (the CPU, where each engine keeps its own)."""
    if device_lock is None:
        return fn()

    def locked():
        with device_lock:
            return fn()

    return await asyncio.to_thread(locked)


async def _scale_up_replica(
    state: dict, replicas: List["_Replica"], pool, config, cfg,
    policy, bias: dict, at: float, device_lock,
):
    """The mid-soak scale-up: build a COLD replica from nothing under
    its own boot recorder — params init (honest bytes: a fresh tree,
    not a shared reference), engine construction, listener, the same
    HTTP shape-bucket warmup the baseline replicas got, prefix-copy
    warm — then join the pool via sync(). From there the production
    machinery takes over: the probe loop's first /health answers the
    ``first_probe`` (time-to-ready) mark and ingests the boot block,
    and the first soak-workload token it serves seals TTFST.

    The recorder carries a PRIVATE registry: its replica-local
    histogram observations must not double-count against the pool's
    probe-ingested fleet aggregation living in the same process (in a
    real deployment those are different processes)."""
    import torch

    from dstack_tpu_torch.models import llama
    from dstack_tpu_torch.obs import boot as obs_boot
    from dstack_tpu_torch.serve.engine import InferenceEngine, default_decode_kernel
    from dstack_tpu_torch.train.step import tree_leaves

    await asyncio.sleep(at)
    rid = f"r{cfg.replicas}"
    rec = obs_boot.BootRecorder(registry=obs_boot.new_boot_registry())
    state["recorder"] = rec
    state["t_spawn"] = at
    logger.warning(
        "soak scale-up: spawning cold replica %s at t=%.1fs (boot %s)",
        rid, at, rec.boot_id,
    )
    dev = torch.device(cfg.device)

    def draw():
        fresh = llama.init_params(
            config, torch.Generator(device=dev).manual_seed(1), device=dev
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the draw is the stage's work
        return fresh

    with rec.stage("weights_load", source="init") as st:
        fresh = await _on_device(device_lock, draw)
        st.set(bytes=sum(int(x.nbytes) for x in tree_leaves(fresh)))
    with rec.stage("engine_init"):
        engine = await _on_device(device_lock, lambda: InferenceEngine(
            config, fresh, max_batch=cfg.max_batch,
            max_seq=cfg.max_seq, prefill_chunk=cfg.prefill_chunk,
            decode_kernel=default_decode_kernel(config, cfg.max_seq), device=dev,
        ))
    engine.fault_ctx = {"replica": rid}
    replica = await _start_replica(
        rid, engine, cfg.model, policy, device_lock, boot=rec,
    )
    # shared teardown list FIRST: if anything below fails, the soak's
    # finally block still stops this replica
    replicas.append(replica)
    state["engine"] = engine
    sched = replica.app["scheduler"]
    # warmup tokens are harness traffic, not the workload: suppress
    # the TTFST mark until the replica is in rotation, so the boot
    # block measures first token served THROUGH THE ROUTER
    sched._boot_served = True
    with rec.stage("warmup_compile") as st:
        await _warmup([replica], cfg.model, bias)
        st.set(manifest=len(engine.compile_manifest()))
    with rec.stage("warm_prefix_copies"):
        await _on_device(device_lock, engine.warm_prefix_copies)
    engine.mark_flight_warm()
    sched._boot_served = False
    # join: re-sync with the full membership — existing entries keep
    # their probed health state, the newcomer starts STARTING and the
    # probe loop promotes it (its first probe is the READY mark)
    pool.sync(state["members"] + [(rid, "127.0.0.1", replica.port)])
    state["joined_at"] = time.monotonic()
    logger.warning(
        "soak scale-up: replica %s joined the pool (warm, %d manifest "
        "variants)", rid, len(engine.compile_manifest()),
    )


def _snapshot(registry, families) -> dict:
    return {name: registry.family(name).value() for name in families}


async def _soak_async(
    schedule: EventSchedule, cfg: SoakConfig, params=None
) -> dict:
    import torch

    from dstack_tpu_torch import faults, qos
    from dstack_tpu_torch.loadgen.driver import OpenLoopDriver, default_payload
    from dstack_tpu_torch.loadgen.metrics import new_loadgen_registry
    from dstack_tpu_torch.models import llama
    from dstack_tpu_torch.routing.metrics import get_router_registry
    from dstack_tpu_torch.routing.pool import (
        PoolConfig,
        ReplicaPool,
        ReplicaState,
    )
    from dstack_tpu_torch.ops import cuda_build
    from dstack_tpu_torch.serve.engine import (
        InferenceEngine,
        default_decode_kernel,
        resolve_device,
    )
    from dstack_tpu_torch.utils.backend import backend_info

    dev = resolve_device(cfg.device)  # no card and no "cpu": raises
    spec, seed = schedule.spec, schedule.seed
    if cfg.replicas < 2:
        raise ValueError("soak needs >= 2 replicas: the point is routing")
    if cfg.chaos and cfg.replicas == 2 and cfg.drain_end_frac > cfg.kill_frac:
        # with two replicas, the drained one must be BACK IN ROTATION
        # before the other dies — overlapping windows would leave zero
        # routable replicas and report a harness-config artifact as a
        # stack failure
        raise ValueError(
            "chaos windows overlap with only 2 replicas: drain ends at "
            f"{cfg.drain_end_frac} but the kill fires at "
            f"{cfg.kill_frac}; end the drain first or add a third "
            "replica"
        )
    # size the trace ring to the whole schedule: the report attributes
    # each window's worst requests from the ring AFTER the soak, and
    # the default 256-trace buffer would evict the drain window's
    # traces long before then (warmup + per-request churn included)
    from dstack_tpu_torch.obs import tracing as obs_tracing

    if obs_tracing.enabled():
        obs_tracing.enable(
            buffer=max(
                obs_tracing.get_tracer().buffer,
                4 * len(schedule.events) + 64,
            ),
            sample=1.0,
        )
    config = llama.CONFIGS[cfg.model]
    if dev.type == "cuda":
        cuda_build.build_all()  # a no-op where the libraries exist
    if params is None:
        # one tree for every harness replica, drawn on the device
        params = llama.init_params(
            config, torch.Generator(device=dev).manual_seed(0), device=dev
        )
    decode_kernel = default_decode_kernel(config, cfg.max_seq)
    # one card, one lock (see the module note); on the CPU, where nothing
    # is launched or captured, each replica keeps its own
    device_lock = threading.Lock() if dev.type == "cuda" else None
    # pin the random-init model to ASCII output (ban non-byte ids incl.
    # eos): resumed streams splice delivered TEXT back into the prompt,
    # so output must round-trip the byte tokenizer exactly, and banning
    # eos keeps generations at their full token budget
    ascii_bias = {str(i): -100 for i in range(128, config.vocab_size)}
    policy = qos.QoSPolicy(
        rps=cfg.qos_rps, burst=cfg.qos_burst,
        tenant_inflight=cfg.tenant_inflight,
    )
    prior_plan = faults.current_plan()
    prior_rules = (
        {"seed": prior_plan.seed, "rules": [r.raw for r in prior_plan.rules]}
        if prior_plan is not None
        else None
    )
    replicas: List[_Replica] = []
    chaos_tasks: List[asyncio.Task] = []
    probe_task = None
    router_runner = None
    session_holder: dict = {"session": None}
    try:
        for i in range(cfg.replicas):
            engine = InferenceEngine(
                config, params, max_batch=cfg.max_batch,
                max_seq=cfg.max_seq, prefill_chunk=cfg.prefill_chunk,
                decode_kernel=decode_kernel, device=dev,
            )
            # both engines share this process's fault plan: the replica
            # ctx lets a chaos rule target ONE of them (e.g. bounded
            # serve.engine.step errors on a survivor)
            engine.fault_ctx = {"replica": f"r{i}"}
            replicas.append(
                await _start_replica(
                    f"r{i}", engine, cfg.model, policy, device_lock
                )
            )
        pool = ReplicaPool("soak", "loadgen", PoolConfig(startup_grace=0.0))
        members = [
            ("r%d" % i, "127.0.0.1", r.port)
            for i, r in enumerate(replicas)
        ]
        pool.sync(members)
        # serial warmup traffic + optimistic-STARTING would pin every
        # request to the first success (READY outranks STARTING): start
        # READY like a probed pool; the probe loop maintains it from here
        for e in pool.entries.values():
            e.state = ReplicaState.READY
        router = await _start_router(pool, session_holder)
        router_runner = router
        probe_task = asyncio.ensure_future(
            _probe_loop(pool, cfg.probe_interval_s)
        )
        slo_engine = None
        if cfg.slo_policy is not None:
            from dstack_tpu_torch.obs import slo as obs_slo

            if obs_slo.enabled():
                # scale=None: windows and hold-downs ride
                # DTPU_BG_TICK_SCALE exactly like the replicas' own
                # aggregators, so both sides window the same spans
                slo_engine = obs_slo.SLOEngine(
                    policy=obs_slo.policy_from_dict(cfg.slo_policy),
                    windows=cfg.slo_windows,
                    registry=obs_slo.new_slo_registry(),  # per-soak
                )
                slo_task = asyncio.ensure_future(_slo_loop(
                    slo_engine, pool, "soak/loadgen", cfg.slo_tick_s
                ))
                chaos_tasks.append(slo_task)
        await _warmup(replicas, cfg.model, ascii_bias)
        # flight steady state: the HTTP warmup covered every shape
        # bucket the schedule exercises, and the prefix-copy grid
        # compiles lazily per reuse length — precompile it like the
        # server warmup does (the flight recorder FOUND this gap: the
        # first soak flagged mid-soak `copy` compiles as steady-state
        # recompiles). From here on any compile the timed soak
        # observes is a real recompile — flagged in the artifact's
        # flight block and attributable to its tail window.
        for r in replicas:
            r.engine.warm_prefix_copies()
            r.engine.mark_flight_warm()

        windows: List[EventWindow] = []
        if cfg.chaos:
            d0 = spec.duration_s * cfg.drain_start_frac
            d1 = spec.duration_s * cfg.drain_end_frac
            kill_at = spec.duration_s * cfg.kill_frac
            # drain one replica we are NOT going to kill, so at least
            # one replica stays routable at every moment
            drain_rid, kill_ix = "r1", 0
            chaos_tasks.append(asyncio.ensure_future(
                _drain_flip(pool, drain_rid, d0, d1)
            ))
            chaos_tasks.append(asyncio.ensure_future(
                _kill_replica(
                    replicas[kill_ix], seed, kill_at,
                    extra_rules=cfg.kill_extra_rules,
                )
            ))
            windows = [
                EventWindow("drain", d0, d1),
                EventWindow(
                    "kill", kill_at,
                    min(spec.duration_s, kill_at + cfg.kill_window_s),
                ),
            ]
        scale_state: dict = {"members": members}
        if cfg.scale_up:
            up_at = spec.duration_s * cfg.scale_up_frac
            chaos_tasks.append(asyncio.ensure_future(_scale_up_replica(
                scale_state, replicas, pool, config, cfg, policy,
                ascii_bias, up_at, device_lock,
            )))
            # the scored join window: goodput/tails while a cold
            # replica boots, warms, and enters rotation next to live
            # traffic — the acceptance bar is zero client 5xx and no
            # goodput regression vs the baseline soak
            windows.append(EventWindow(
                "scale_up", up_at,
                min(spec.duration_s, up_at + cfg.scale_up_window_s),
            ))

        router_url = f"http://127.0.0.1:{router.port}"
        driver = OpenLoopDriver(
            router_url,
            payload_for=lambda ev: {
                **default_payload(ev, cfg.model),
                "logit_bias": ascii_bias,
            },
            headers_for=lambda ev: {"X-Soak-Tenant": ev.tenant},
            drain_s=cfg.drain_s,
            # fresh per-soak registry: the artifact embeds its render,
            # which must count THIS soak only (back-to-back runs in
            # one process must not leak into each other's artifacts —
            # the same honesty the router-family deltas get)
            registry=new_loadgen_registry(),
        )
        r0 = _snapshot(get_router_registry(), _ROUTER_FAMILIES)
        # flight-recorder baseline: the artifact's flight block deltas
        # compile/post-mortem accounting over the TIMED soak only
        # (warmup compiles are the point of warmup, not a finding)
        from dstack_tpu_torch.obs import flight as obs_flight

        flight_rec = obs_flight.get_recorder()
        f0 = (
            flight_rec.compile_totals() if flight_rec is not None else None
        )
        # monotonic capture count, NOT len(postmortems()): the snapshot
        # buffer saturates at POSTMORTEM_KEEP, which would undercount a
        # stormy soak and zero out back-to-back soaks in one process
        pm0 = (
            flight_rec.postmortems_total() if flight_rec is not None else 0
        )
        # schedule-time anchor for the live SLO transition timeline
        # (the chaos tasks anchored their sleeps moments earlier; the
        # skew is milliseconds against seconds-scale windows)
        soak_t0 = time.monotonic()
        wall_t0 = time.time()  # flight events carry wall-clock stamps
        records = await driver.run(schedule.events)
        router_delta = {
            k: int(v - r0[k])
            for k, v in _snapshot(
                get_router_registry(), _ROUTER_FAMILIES
            ).items()
        }
    finally:
        for t in chaos_tasks:
            t.cancel()
        if probe_task is not None:
            probe_task.cancel()
        await asyncio.gather(
            *chaos_tasks,
            *( [probe_task] if probe_task is not None else [] ),
            return_exceptions=True,
        )
        if session_holder.get("session") is not None:
            await session_holder["session"].close()
        if router_runner is not None:
            await _stop_runner(router_runner.runner)
        for r in replicas:
            if not r.killed:
                try:
                    await r.site.stop()
                except RuntimeError:
                    pass
            await _stop_runner(r.runner)
        # restore whatever fault plan the process came in with
        if prior_rules is not None:
            faults.install_plan(prior_rules)
        elif faults.active():
            faults.clear()

    # trace-based tail attribution: router and replicas all run in this
    # process, so the obs.tracing ring (imported above, where the soak
    # sized it to the schedule) holds the STITCHED trace — router legs
    # + replica phases — for the report to attribute each window's
    # worst requests from
    # flight block: compile/post-mortem deltas over the timed soak +
    # memory watermarks, and the soak-relative compile-event list so
    # the report can attribute tail-amplification windows to compile
    # stalls (a steady-state recompile inside the kill window is a
    # different finding than router retry overhead)
    flight_block = None
    flight_events: list = []
    if flight_rec is not None and f0 is not None:
        f1 = flight_rec.compile_totals()
        mem = flight_rec.memory()
        flight_events = [
            {
                "t": round(e["t"] - wall_t0, 3),
                "fn": e["fn"],
                "key": e.get("key"),
                "seconds": e["seconds"],
                "recompile": e.get("recompile", False),
            }
            for e in flight_rec.compile_events()
            if e["t"] >= wall_t0
        ]
        flight_block = {
            "compiles": {
                fn: int(n - f0["compiles"].get(fn, 0))
                for fn, n in f1["compiles"].items()
                if n - f0["compiles"].get(fn, 0)
            },
            "recompiles": int(
                sum(f1["recompiles"].values())
                - sum(f0["recompiles"].values())
            ),
            "compile_seconds": round(
                sum(f1["seconds"].values()) - sum(f0["seconds"].values()),
                4,
            ),
            "postmortems": flight_rec.postmortems_total() - pm0,
            "peak_memory_bytes": (
                mem.get("peak_bytes_in_use")
                if mem.get("available")
                else None
            ),
            "memory_available": bool(mem.get("available")),
            "events": flight_events,
        }
    analysis = evaluate(
        records,
        {c.name: (c.ttft_slo_ms, c.tpot_slo_ms) for c in spec.classes},
        spec.duration_s,
        windows=windows,
        trace_lookup=obs_tracing.get_trace,
        flight_events=flight_events if flight_block is not None else None,
    )
    # the scale-up replica's TTFST decomposition (obs/boot.py): the
    # per-stage boot timeline from its private recorder, schedule-
    # relative spawn time, and the /health-shaped summary — read next
    # to the `scale_up` entry in the window analysis (goodput/tails
    # around the join). Same backend/note labels as the whole
    # artifact: on the CPU these stage durations are not card numbers.
    boot_block = None
    boot_rec = scale_state.get("recorder") if cfg.scale_up else None
    if boot_rec is not None:
        up_engine = scale_state.get("engine")
        boot_block = {
            "replica": f"r{cfg.replicas}",
            "t_spawn": round(scale_state.get("t_spawn", 0.0), 3),
            **boot_rec.health_block(
                warm=bool(up_engine is not None and up_engine.flight_warm)
            ),
            "timeline": boot_rec.timeline(),
            "manifest_variants": (
                len(up_engine.compile_manifest())
                if up_engine is not None else 0
            ),
        }
    info = backend_info(dev)
    result = {
        "metric": (
            f"loadgen_goodput_under_slo[{cfg.model},"
            f"replicas={cfg.replicas}]"
        ),
        "value": analysis["overall"]["goodput_ratio"],
        "unit": "ratio",
        "seed": seed,
        "schedule_digest": schedule.digest(),
        "events": len(schedule.events),
        "duration_s": spec.duration_s,
        "replicas": cfg.replicas,
        "qos": {
            "rps": cfg.qos_rps,
            "burst": cfg.qos_burst,
            "tenant_inflight": cfg.tenant_inflight,
        },
        "chaos": (
            {
                "drain": [w.start for w in windows if w.name == "drain"]
                + [w.end for w in windows if w.name == "drain"],
                "kill_at": next(
                    (w.start for w in windows if w.name == "kill"), None
                ),
            }
            if cfg.chaos
            else None
        ),
        **info,
        # engine-side observability over the timed soak (obs/flight.py;
        # same backend label as the artifact — CPU-run honesty
        # applies to memory/compile numbers too)
        "flight": flight_block,
        # scale-up boot decomposition (None unless cfg.scale_up): the
        # TTFST baseline
        "boot": boot_block,
        "slo": (
            {
                "policy": slo_engine.policy.name,
                "windows_s": {
                    k: round(v, 3) for k, v in slo_engine.windows.items()
                },
                # schedule-relative timestamps, matching the report's
                # tail-amplification windows — live and offline views
                # of the same soak line up by construction
                "transitions": [
                    {**tr.to_dict(), "t": round(tr.t - soak_t0, 3)}
                    for tr in slo_engine.transitions
                ],
            }
            if slo_engine is not None
            else None
        ),
        "router": router_delta,
        "spec": spec.to_dict(),
        # the dtpu_loadgen_* families' Prometheus text, embedded so
        # the artifact carries the driver's own raw accounting next to
        # the derived analysis (docs/reference/server.md)
        "loadgen_metrics": driver.metrics.render(),
        **analysis,
    }
    return result


class _Router:
    __slots__ = ("runner", "port")

    def __init__(self, runner, port):
        self.runner = runner
        self.port = port


async def _start_router(pool, session_holder) -> _Router:
    import aiohttp
    from aiohttp import web

    # one shared upstream session, created on the running loop before
    # any request (a lazy per-handler create would race on the first
    # concurrent burst and leak the losers)
    session_holder["session"] = aiohttp.ClientSession()
    app = _router_app(pool, session_holder)
    runner = web.AppRunner(app)
    await runner.setup()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    site = web.SockSite(runner, sock)
    await site.start()
    return _Router(runner, port)


async def _stop_runner(runner) -> None:
    """Bounded cleanup: a wedged handler must not hang the soak's
    teardown (the report is already computed from driver records)."""
    try:
        await asyncio.wait_for(runner.cleanup(), timeout=5.0)
    except (asyncio.TimeoutError, RuntimeError):
        pass


def run_soak(
    schedule: EventSchedule, cfg: Optional[SoakConfig] = None, params=None
) -> dict:
    """Synchronous entry: run one soak → the artifact dict (written to
    ``cfg.output`` when set). ``params``: the harness replicas' weights
    tree on ``cfg.device`` (default: drawn from seed 0)."""
    cfg = cfg or SoakConfig()
    result = asyncio.run(_soak_async(schedule, cfg, params))
    if cfg.output:
        os.makedirs(os.path.dirname(cfg.output) or ".", exist_ok=True)
        with open(cfg.output, "w") as f:
            json.dump(result, f, indent=1, sort_keys=False)
            f.write("\n")
        logger.warning("soak artifact written to %s", cfg.output)
    return result
