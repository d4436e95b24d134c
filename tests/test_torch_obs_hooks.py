"""The port's tracing, SLO, flight and boot copies against the JAX
package's, on the same seeded events under one fake clock (``time.time``
and ``time.monotonic`` stepped by the test, the tracers' id streams seeded
alike, so ids and times agree as well and nothing needs masking but the
boot id).

- ``obs/tracing.py``: one sequence of roots (fresh, continued from an
  ``X-DTPU-Trace`` header, malformed), children, events past the per-span
  cap, statuses and ends gives equal span trees and equal
  ``debug_payload`` for the recent, ``?id=`` and ``?slowest=`` queries;
  the trace registries render byte-identically.
- ``obs/slo.py``: ``quantile_from_counts``, ``fraction_over`` and
  ``merge_windows`` on seeded histograms; ``SlidingWindows``; an
  ``SLOEngine`` burning fast then recovering gives the same alert
  transitions, status payload and registry; ``ReplicaSLO`` over seeded
  serve and QoS registries gives the same ``slo_windows``;
  ``validate_policy`` the same errors on a corpus.
- ``obs/flight.py``: the same records, compile events and post-mortems
  give equal snapshots, ``debug_payload`` and health summaries (memory
  unavailable on the CPU in both), and the flight registries render
  alike.
- ``obs/boot.py``: the same stages and marks give equal timelines,
  health blocks and ``debug_payload`` (the boot id aside), ``ingest``
  observes the same, and the boot registries render alike.
"""

import time

import numpy as np
import pytest

from dstack_tpu import obs as jobs
from dstack_tpu.obs import boot as jboot
from dstack_tpu.obs import flight as jflight
from dstack_tpu.obs import slo as jslo
from dstack_tpu.obs import tracing as jtracing
from dstack_tpu.qos import metrics as jqm
from dstack_tpu.serve.metrics import new_serve_registry as jserve_registry
from dstack_tpu_torch import obs as tobs
from dstack_tpu_torch.obs import boot as tboot
from dstack_tpu_torch.obs import flight as tflight
from dstack_tpu_torch.obs import slo as tslo
from dstack_tpu_torch.obs import tracing as ttracing
from dstack_tpu_torch.qos import metrics as tqm
from dstack_tpu_torch.serve.metrics import new_serve_registry as tserve_registry


class _Clock:
    def __init__(self):
        self.mono, self.wall = 500.0, 1.7e9

    def step(self, dt: float) -> None:
        self.mono += dt
        self.wall += dt


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "monotonic", lambda: c.mono)
    monkeypatch.setattr(time, "time", lambda: c.wall)
    return c


@pytest.fixture
def fresh_registries():
    """Every module-global registry of both packages starts empty."""
    mods = (jtracing, ttracing, jflight, tflight, jboot, tboot, jslo, tslo, jqm, tqm)
    saved = [(m, m._registry) for m in mods]
    for m in mods:
        m._registry = None
    yield
    for m, r in saved:
        m._registry = r


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def _drive_tracing(mod, clock, seed: int) -> list:
    tracer = mod.enable(buffer=6)
    tracer._rng.seed(1234)
    rng = np.random.default_rng(seed)
    out = []
    roots = []
    for i in range(14):
        kind = int(rng.integers(0, 3))
        trace = None if kind == 0 else ("00ab-00cd" if kind == 1 else "not-a-header-x")
        root = mod.span("serve.request", trace=trace, endpoint="chat", i=i)
        roots.append(root)
        phase = mod.span("serve.queue", parent=root)
        clock.step(float(rng.exponential(0.05)))
        phase.end()
        phase = mod.span("serve.decode", parent=root, slot=int(rng.integers(0, 4)), text="x" * 300)
        for _ in range(int(rng.integers(0, 80))):
            clock.step(1e-3)
            phase.event("macro_step", tokens=int(rng.integers(1, 9)))
        phase.end(None if rng.random() < 0.7 else "error", tokens=7)
        phase.end("ignored")  # idempotent
        root.event("edge_admit", shed=False)
        root.end()
        out.append((root.header(), root.trace_id, root.recording))
    for q in ({}, {"limit": "3"}, {"slowest": "2"}, {"slowest": "bad"}, {"id": roots[-1].trace_id},
              {"id": "feed"}):
        out.append(mod.debug_payload(q))
    out.append(mod.span("x", parent=mod.NOOP_SPAN) is mod.NOOP_SPAN)
    mod.disable()
    out.append((mod.span is mod._noop_span, mod.debug_payload({})))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tracing_matches_jax(clock, fresh_registries, seed):
    prior = [(m, m.get_tracer()) for m in (jtracing, ttracing)]
    try:
        jout = _drive_tracing(jtracing, clock, seed)
        clock.mono, clock.wall = 500.0, 1.7e9
        tout = _drive_tracing(ttracing, clock, seed)
    finally:
        for m, t in prior:
            if t is None:
                m.disable()
            else:
                m._tracer, m.span = t, t.span
    assert tout == jout
    assert ttracing.TRACE_HEADER == jtracing.TRACE_HEADER
    assert ttracing.get_trace_registry().render() == jtracing.get_trace_registry().render()
    assert "dtpu_trace_events_dropped_total" in ttracing.get_trace_registry().render()


# ---------------------------------------------------------------------------
# SLO
# ---------------------------------------------------------------------------

BOUNDS = list(jobs.LATENCY_BUCKETS_S)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_estimators_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        counts = [float(x) for x in rng.poisson(rng.uniform(0, 4), len(BOUNDS) + 1)]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert tslo.quantile_from_counts(BOUNDS, counts, q) == jslo.quantile_from_counts(BOUNDS, counts, q)
        for thr in (0.0, 0.01, 0.3, 2.0, 1e4):
            assert tslo.fraction_over(BOUNDS, counts, thr) == jslo.fraction_over(BOUNDS, counts, thr)
    payloads = []
    for _ in range(4):
        payloads.append({w: {"requests": float(rng.integers(0, 50)), "span_s": float(rng.uniform(1, 300)),
                             "ttft": {"le": BOUNDS, "counts": [float(c) for c in rng.poisson(1, len(BOUNDS) + 1)],
                                      "sum": float(rng.uniform(0, 9)), "count": 3.0}}
                         for w in ("5m", "1h")})
    payloads.append("junk")
    assert tslo.merge_windows(payloads) == jslo.merge_windows(payloads)
    for name in ("5m", "30m", "1h", "6h", "90s", "2d", "bad", ""):
        assert tslo.parse_window(name) == jslo.parse_window(name)
    assert tslo.default_windows(0.5) == jslo.default_windows(0.5)


def _feed(reg, rng, n: int, slow: bool) -> None:
    reg.family("dtpu_serve_requests_total").inc(n)
    reg.family("dtpu_serve_request_errors_total").inc(int(rng.integers(0, 3)) if slow else 0)
    for _ in range(n):
        reg.family("dtpu_serve_ttft_seconds").observe(float(rng.uniform(2.5, 9) if slow else rng.uniform(0, 0.5)))
        reg.family("dtpu_serve_queue_wait_seconds").observe(float(rng.uniform(0, 0.2)))
        reg.family("dtpu_serve_tpot_seconds").observe(float(rng.uniform(0.001, 0.05)))


def _drive_slo(slo, serve_registry, qm, clock, seed: int) -> list:
    rng = np.random.default_rng(seed)
    reg, qreg = serve_registry(), qm.get_qos_registry()
    windows = {"5m": 300.0, "1h": 3600.0, "6h": 21600.0}
    eng = slo.SLOEngine(policy=slo.default_policy(), windows=windows, clock=lambda: clock.mono, scale=1.0)
    rep = slo.ReplicaSLO(lambda: slo.serve_signals(reg, qreg), windows=windows, clock=lambda: clock.mono,
                         tick_s=5.0)
    sw = slo.SlidingWindows(windows, clock=lambda: clock.mono, slots=6)
    out = []
    for tick in range(160):
        clock.step(30.0)
        slow = 20 <= tick < 70
        _feed(reg, rng, int(rng.integers(5, 20)), slow)
        if rng.random() < 0.2:
            qreg.family("dtpu_qos_shed_total").inc(1, "t1")
        sig = slo.serve_signals(reg, qreg)
        out.append(sw.advance(sig))
        eng.tick_scope("svc", sig)
        eng.tick_scope("svc", sig, replica="r0")
        out.append([t.to_dict() for t in eng.evaluate()])
        if tick % 10 == 0:
            out.append(rep.health_windows())
            out.append(eng.fleet_burn("svc"))
    out.append(eng.status_payload())
    out.append(eng.registry.render())
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_slo_engine_burns_and_recovers_as_jax(clock, fresh_registries, seed):
    jout = _drive_slo(jslo, jserve_registry, jqm, clock, seed)
    clock.mono, clock.wall = 500.0, 1.7e9
    tout = _drive_slo(tslo, tserve_registry, tqm, clock, seed)
    assert tout == jout
    states = {t["state"] for step in tout if isinstance(step, list) for t in step}
    assert {"firing", "resolved"} <= states


BAD_POLICIES = [
    [],
    {"wat": 1, "name": ""},
    {"classes": []},
    {"classes": [{"name": "a"}, {"name": "a", "ttft_slo_ms": -1}, 3, {"x": 1}]},
    {"latency_compliance": 1.5, "error_rate_slo": "x", "shed_honesty": 1},
    {"fast_burn": {"factor": -1, "windows": []}, "slow_burn": "x"},
    {"fast_burn": {"factor": 2, "windows": ["5m", "bogus"], "extra": 1}},
    {"hold_down_s": -1, "resolve_after_s": "x", "min_events": 0},
]


@pytest.mark.parametrize("i", range(len(BAD_POLICIES)))
def test_validate_policy_gives_jax_errors(i):
    want = jslo.validate_policy(BAD_POLICIES[i])
    assert tslo.validate_policy(BAD_POLICIES[i]) == want and want
    assert tslo.validate_policy(jslo.default_policy().to_dict()) == []
    assert tslo.default_policy().to_dict() == jslo.default_policy().to_dict()


# ---------------------------------------------------------------------------
# flight
# ---------------------------------------------------------------------------


def _drive_flight(mod, serve_registry, clock) -> list:
    rec = mod.FlightRecorder(buffer=20)
    reg = serve_registry()
    out = []
    for i in range(40):
        clock.step(0.01)
        rec.record(phase=["decode", "turbo", "prefill"][i % 3], slots=[i % 4], tokens=i, skip=None,
                   traces={i % 4: f"{i:016x}"} if i % 2 else None)
        if i % 9 == 0:
            rec.note_compile("turbo", i, 0.5, reg, recompile=i > 20)
    out.append(rec.maybe_poll_memory(reg))
    clock.step(1.0)
    out.append(rec.maybe_poll_memory(reg))
    out.append(rec.post_mortem("watchdog_abort", registry=reg, wedge="slot:2", slots={2: "ab", 1: None},
                               none_key=None))
    out.append(rec.post_mortem("engine_error", error="boom"))
    out += [rec.snapshot(limit=5, postmortems=1), rec.health_summary(), rec.postmortems_total(),
            rec.records(3), rec.memory(), reg.render()]
    prior = mod.get_recorder()
    mod._recorder, mod.record = rec, rec.record
    try:
        for q in ({}, {"limit": "2", "postmortems": "0"}, {"limit": "x", "postmortems": "y"}):
            out.append(mod.debug_payload(q))
        out.append(mod.health_summary())
    finally:
        if prior is None:
            mod.disable()
        else:
            mod._recorder, mod.record = prior, prior.record
    return out


def test_flight_payloads_match_jax(clock, fresh_registries):
    jout = _drive_flight(jflight, jserve_registry, clock)
    clock.mono, clock.wall = 500.0, 1.7e9
    tout = _drive_flight(tflight, tserve_registry, clock)
    assert tout == jout
    assert tout[0] == {"available": False}  # no device memory on the CPU, in either
    assert tflight.get_flight_registry().render() == jflight.get_flight_registry().render()
    assert tflight.POSTMORTEM_KEEP == jflight.POSTMORTEM_KEEP
    assert tflight.POSTMORTEM_RECORDS == jflight.POSTMORTEM_RECORDS


def test_disabled_flight_is_the_noop_identity():
    prior = tflight.get_recorder()
    tflight.disable()
    try:
        assert tflight.record is tflight._noop_record
        assert tflight.post_mortem("x") is None and tflight.maybe_poll_memory() is None
        assert tflight.debug_payload({}) == {"enabled": False, "records": [], "postmortems": []}
        assert tflight.health_summary() == {"enabled": False}
    finally:
        if prior is not None:
            tflight._recorder, tflight.record = prior, prior.record


# ---------------------------------------------------------------------------
# boot
# ---------------------------------------------------------------------------

STAGES = ("config_load", "weights_load", "engine_init", "tokenizer_load", "warmup_compile",
          "warm_prefix_copies")


def _drive_boot(mod, clock) -> list:
    reg = mod.new_boot_registry()
    rec = mod.BootRecorder(buffer=8, registry=reg)
    out = []

    def block(**kw):
        b = rec.health_block(**kw)
        assert b.pop("boot_id") == rec.boot_id
        return b

    for i, name in enumerate(STAGES + ("weights_load",)):
        with rec.stage(name, model="m", detail="x" * 300) as st:
            clock.step(0.25 * (i + 1))
            if name == "weights_load":
                st.set(bytes=4096 * (i + 1))
    try:
        with rec.stage("engine_init"):
            clock.step(0.5)
            raise RuntimeError("x")
    except RuntimeError:
        pass
    out.append(rec.mark("listener_up"))
    clock.step(0.5)
    out.append(rec.mark(mod.READY_MARK))
    out.append(rec.mark(mod.READY_MARK))
    out.append(block(warm=False))
    clock.step(1.0)
    out.append(rec.mark(mod.SERVED_MARK, detail="first"))
    out += [rec.warm, rec.time_to_ready(), rec.ttfst(), rec.timeline(4), block()]
    for q in ({}, {"limit": "3"}, {"limit": "x"}):
        payload = mod.debug_payload(q, recorder=rec)
        assert payload.pop("boot_id") == payload["summary"].pop("boot_id") == rec.boot_id
        out.append(payload)
    memo: dict = {}
    fleet = mod.new_boot_registry()
    block = rec.health_block()
    out.append(mod.ingest(block, memo, fleet))
    out.append(mod.ingest(block, memo, fleet))
    out.append(mod.ingest({**block, "boot_id": "other", "ttfst_s": None}, memo, fleet))
    out.append(mod.ingest({}, memo, fleet))
    out += [reg.render(), fleet.render(), mod.READY_MARK, mod.SERVED_MARK, mod.BOOT_BUCKETS_S]
    out.append(mod.manifest_diff({"chunk(16, 0)", "turbo8"}, ["turbo8", "copy256"]))
    return out


def test_boot_recorder_matches_jax(clock, fresh_registries):
    jout = _drive_boot(jboot, clock)
    clock.mono, clock.wall = 500.0, 1.7e9
    tout = _drive_boot(tboot, clock)
    assert tout == jout
    assert tout[9]["stages"].keys() == set(STAGES) and tout[9]["ttfst_s"] is not None
    assert ttracing.get_trace_registry().render() == jtracing.get_trace_registry().render()


def test_obs_package_exports_match_jax():
    assert set(tobs.__all__) == set(jobs.__all__)
    for mod_t, mod_j in ((ttracing, jtracing), (tflight, jflight), (tboot, jboot), (tslo, jslo)):
        missing = set(mod_j.__all__) - set(mod_t.__all__)
        assert missing <= {"server_signals"}, (mod_t.__name__, missing)
