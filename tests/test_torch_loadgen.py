"""The port's ``loadgen/`` against the JAX package's on the same inputs.

- ``schedule``: ``compile_schedule(spec, seed)`` gives equal event lists,
  JSONL and ``digest()`` for ``default_spec`` and for each spec the JAX
  package's own loadgen tests compile (one class, several classes, a
  diurnal arrival, chat sessions), and the CLIs' ``--schedule-only`` and
  ``--validate-spec`` print alike.
- ``spec``: ``validate_spec`` returns the same errors on the same bad specs;
  ``spec_from_dict``/``to_dict`` round trips alike.
- ``textgen``: the session texts, conversations and the schedule's sizing
  helpers draw alike from the same rng state.
- ``report``: ``evaluate`` on the same seeded records, windows, trace
  lookups and compile events gives equal reports.
- ``metrics``: the ``dtpu_loadgen_*`` registry renders byte-identical.
- ``driver``: ``OpenLoopDriver`` of both packages in front of the JAX
  tests' scripted edge classifies every event alike.
- The generator path (``__init__``, ``spec``, ``schedule``, ``textgen``,
  ``report``, ``metrics``) imports no torch, aiohttp or numpy, checked by
  the AST and by a subprocess; the soak refuses to run with no card and no
  ``--device cpu``.
"""

import ast
import contextlib
import io
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestServer

from dstack_tpu.loadgen import __main__ as jmain
from dstack_tpu.loadgen import driver as jdriver
from dstack_tpu.loadgen import metrics as jmetrics
from dstack_tpu.loadgen import report as jreport
from dstack_tpu.loadgen import schedule as jschedule
from dstack_tpu.loadgen import spec as jspec
from dstack_tpu.loadgen import textgen as jtext
from dstack_tpu_torch.loadgen import __main__ as tmain
from dstack_tpu_torch.loadgen import driver as tdriver
from dstack_tpu_torch.loadgen import metrics as tmetrics
from dstack_tpu_torch.loadgen import report as treport
from dstack_tpu_torch.loadgen import schedule as tschedule
from dstack_tpu_torch.loadgen import spec as tspec
from dstack_tpu_torch.loadgen import textgen as ttext
from tests.loadgen.test_loadgen_driver import _event as _jevent
from tests.loadgen.test_loadgen_driver import _ScriptedEdge

REPO = Path(__file__).resolve().parents[1]
LOADGEN = REPO / "dstack_tpu_torch" / "loadgen"

# the specs the JAX package's own loadgen tests compile
# (tests/loadgen/test_loadgen_schedule.py), as data
_SPECS = {
    "one_class": {
        "duration_s": 60.0, "arrival": {"process": "poisson", "rate_rps": 20.0},
        "classes": [{"name": "only", "kind": "completion", "share": 1.0, "tenants": 2}],
    },
    "one_chat_class": {
        "duration_s": 60.0, "arrival": {"process": "poisson", "rate_rps": 3.0},
        "classes": [{"name": "only", "kind": "chat", "share": 1.0, "tenants": 2, "turns": 4}],
    },
    "two_classes": {
        "duration_s": 120.0, "arrival": {"rate_rps": 6.0},
        "classes": [
            {"name": "a", "kind": "completion", "share": 1.0},
            {"name": "b", "kind": "chat", "share": 1.0, "turns": 2},
        ],
    },
    "three_classes": {
        "duration_s": 120.0, "arrival": {"rate_rps": 9.0},
        "classes": [
            {"name": "a", "kind": "completion", "share": 1.0},
            {"name": "b", "kind": "chat", "share": 1.0, "turns": 2},
            {"name": "c", "kind": "completion", "share": 1.0},
        ],
    },
    "diurnal": {
        "duration_s": 400.0,
        "arrival": {"process": "diurnal", "rate_rps": 10.0, "amplitude": 0.8, "period_s": 400.0},
        "classes": [{"name": "only", "kind": "completion", "share": 1.0}],
    },
}


def _schedules(jspec_obj, tspec_obj, seed):
    return jschedule.compile_schedule(jspec_obj, seed), tschedule.compile_schedule(tspec_obj, seed)


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("duration, rate", [(10.0, 5.0), (30.0, 3.0), (75.0, 3.0)])
def test_default_spec_schedule_equal(seed, duration, rate):
    j, t = _schedules(jspec.default_spec(duration, rate), tspec.default_spec(duration, rate), seed)
    assert [e.to_dict() for e in t.events] == [e.to_dict() for e in j.events]
    assert t.to_jsonl() == j.to_jsonl()
    assert t.digest() == j.digest()
    assert t.spec.to_dict() == j.spec.to_dict()


@pytest.mark.parametrize("name", sorted(_SPECS))
@pytest.mark.parametrize("seed", [5, 9])
def test_spec_schedules_equal(name, seed):
    data = _SPECS[name]
    j, t = _schedules(jspec.spec_from_dict(data), tspec.spec_from_dict(data), seed)
    assert len(j.events) > 0
    assert t.to_jsonl() == j.to_jsonl()
    assert t.digest() == j.digest()


_BAD_SPECS = [
    {"duration_s": -1, "arrival": {"process": "warp", "rate_rps": 0},
     "classes": [{"name": "", "kind": "nope", "share": -2, "priority": "vip"},
                 {"name": "x", "seeded": True}], "bogus": 1},
    {"arrival": {"process": "diurnal", "period_s": 0, "amplitude": 2.0, "warp": 1},
     "classes": [{"name": "a", "kind": "completion", "ttft_slo": 123}]},
    {"classes": []},
    {"classes": [{"name": "a", "kind": "chat", "turns": 0, "ttft_slo_ms": -5}]},
    {"classes": [{"name": "a"}, {"name": "a"}], "fault_plan": {"rules": [{"point": "nope"}]}},
    "not a dict",
    {"duration_s": "x", "classes": [{"name": "a", "prompt_chars": [5, "z"]}]},
]


@pytest.mark.parametrize("i", range(len(_BAD_SPECS)))
def test_validate_spec_errors_equal(i):
    data = _BAD_SPECS[i]
    assert tspec.validate_spec(data) == jspec.validate_spec(data)
    with pytest.raises(ValueError) as te:
        tspec.spec_from_dict(data)
    with pytest.raises(ValueError) as je:
        jspec.spec_from_dict(data)
    assert str(te.value) == str(je.value)


def _cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--schedule-only", "--seed", "5"],
    ["--schedule-only", "--seed", "2", "--duration", "20", "--rate", "4"],
    ["--schedule-only", "--seed", "1", "--spec", json.dumps(_SPECS["two_classes"])],
    ["--validate-spec", "--spec", json.dumps(_BAD_SPECS[0])],
    ["--validate-spec", "--spec", json.dumps(_SPECS["diurnal"])],
])
def test_cli_offline_modes_equal(argv):
    assert _cli(tmain.main, argv) == _cli(jmain.main, argv)


def test_soak_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--duration", "2", "--rate", "1", "--output", ""])


def test_artifact_defaults_under_build(monkeypatch):
    """The repo root's SOAK_r01.json is the JAX package's artifact: the
    port's default lands under the gitignored build/."""
    from dstack_tpu_torch.loadgen import soak

    assert soak.SoakConfig().output == str(Path("build") / "SOAK_r01.json")
    seen = {}

    def fake_run_soak(schedule, cfg):
        seen["cfg"] = cfg
        return {k: None for k in ("metric", "value", "unit", "seed", "schedule_digest", "events",
                                  "duration_s", "replicas", "backend", "note", "failures",
                                  "client_5xx", "router")}

    monkeypatch.setattr(soak, "run_soak", fake_run_soak)
    rc, out, _ = _cli(tmain.main, ["--duration", "2", "--rate", "1"])
    assert rc == 0 and json.loads(out)["metric"] is None
    assert seen["cfg"].output == str(Path("build") / "SOAK_r01.json")
    assert seen["cfg"].device == "cuda"
    _cli(tmain.main, ["--duration", "2", "--device", "cpu", "--output", ""])
    assert seen["cfg"].device == "cpu" and seen["cfg"].output is None


@pytest.mark.parametrize("seed", [0, 4])
def test_textgen_equal(seed):
    for rng_of in (lambda: np.random.default_rng(seed),
                   lambda: jtext.WordRNG(random.Random(seed))):
        a, b = rng_of(), rng_of()
        assert ttext.conversation_texts(a, 3, 4, 90) == jtext.conversation_texts(b, 3, 4, 90)
        assert ttext.session_text(a, 33) == jtext.session_text(b, 33)
        assert [ttext.chars_in(a, (5, 40)) for _ in range(20)] == [jtext.chars_in(b, (5, 40)) for _ in range(20)]
    r1, r2 = random.Random(seed), random.Random(seed)
    assert ttext.WordRNG(r1).integers(0, 26, 50) == jtext.WordRNG(r2).integers(0, 26, 50)
    for v in (None, 7, 7.9, [9, 3], (2, 2)):
        assert ttext.bounds_pair(v, (1, 2)) == jtext.bounds_pair(v, (1, 2))


def _records(mod, seed: int, n: int = 160) -> list:
    rng = random.Random(seed)
    outcomes = ["ok"] * 6 + ["shed", "client_error", "failed_5xx", "failed_connect",
                             "failed_truncated", "failed_stream_error", "abandoned"]
    recs = []
    for i in range(n):
        t = rng.uniform(0.0, 30.0)
        outcome = rng.choice(outcomes)
        ok = outcome == "ok"
        recs.append(mod.RequestRecord(
            rid=f"e{i:04d}", cls=rng.choice(["interactive", "standard", "batch"]),
            tenant=f"t{rng.randint(0, 3)}", t_sched=t, t_sent=t + rng.uniform(0.0, 0.2),
            outcome=outcome, session=rng.choice([None, "s1", "s2"]), turn=rng.randint(0, 3),
            status=200 if ok else rng.choice([429, 400, 500, None]),
            ttft_s=rng.uniform(0.01, 3.0) if ok else None,
            tpot_s=rng.uniform(0.001, 0.8) if ok else None,
            tokens=rng.randint(1, 64) if ok else 0,
            retry_after=rng.choice([None, 1.0, 2.0, 0.5]) if outcome == "shed" else None,
            detail="" if ok else "x", trace_id=f"tr{i}" if ok and rng.random() < 0.8 else None,
        ))
    return recs


def _trace(trace_id):
    """A stitched trace for the worst-request attribution: router legs and
    replica phases, deterministic in the id."""
    if trace_id is None or trace_id.endswith("7"):
        return None
    k = int(trace_id[2:])
    return {"spans": [
        {"name": "router.forward", "start_unix": 0.0, "end_unix": 0.5, "events": []},
        {"name": "router.dispatch", "start_unix": 0.0, "end_unix": 0.1 * (k % 3), "attrs": {"attempt": 1}},
        {"name": "router.dispatch", "start_unix": 0.1, "end_unix": 0.4, "attrs": {"attempt": 2}},
        {"name": "serve.queue", "start_unix": 0.1, "end_unix": 0.1 + 0.01 * (k % 5)},
        {"name": "serve.prefill", "start_unix": 0.2, "end_unix": 0.2 + 0.02 * (k % 4)},
        {"name": "serve.decode", "start_unix": 0.3, "end_unix": 0.45},
    ]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_equal(seed):
    slos = {"interactive": (500.0, 100.0), "standard": (2000.0, 300.0), "batch": (8000.0, 800.0)}
    windows_j = [jreport.EventWindow("drain", 5.0, 9.0), jreport.EventWindow("kill", 15.0, 18.0)]
    windows_t = [treport.EventWindow("drain", 5.0, 9.0), treport.EventWindow("kill", 15.0, 18.0)]
    flight = [{"t": 6.0, "fn": "chunk", "key": "(64, 0)", "seconds": 0.4, "recompile": True},
              {"t": 16.5, "fn": "copy", "key": "64", "seconds": 0.1, "recompile": False}]
    j = jreport.evaluate(_records(jreport, seed), slos, 30.0, windows=windows_j,
                         trace_lookup=_trace, flight_events=flight)
    t = treport.evaluate(_records(treport, seed), slos, 30.0, windows=windows_t,
                         trace_lookup=_trace, flight_events=flight)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert j["windows"]["kill"]["worst_requests"]  # the trace attribution ran
    for q in (0.0, 0.5, 0.95, 1.0):
        vals = [r.ttft_s for r in _records(treport, seed) if r.ttft_s]
        assert treport.percentile(vals, q) == jreport.percentile(vals, q)


def test_loadgen_registry_renders_identical():
    j, t = jmetrics.new_loadgen_registry(), tmetrics.new_loadgen_registry()
    assert t.render() == j.render()
    assert tmetrics.OUTCOMES == jmetrics.OUTCOMES


async def test_driver_classifies_alike():
    """Both drivers in front of the JAX tests' scripted edge: every event's
    outcome, status, tokens, Retry-After and detail alike, and both
    registries count the same outcomes."""
    events = [
        _jevent("e00", 0.00, tenant="ok-a"),
        _jevent("e01", 0.02, tenant="shed-a"),
        _jevent("e02", 0.04, tenant="flap-a"),
        _jevent("e03", 0.06, tenant="trunc-a"),
        _jevent("e04", 0.08, tenant="errevent-a"),
        _jevent("e05", 0.10, kind="completion", tenant="ok-b"),
        _jevent("e06", 0.12, tenant="shed-b", stream=False),
    ]
    out = {}
    for name, mod in (("jax", jdriver), ("torch", tdriver)):
        edge = _ScriptedEdge()
        server = TestServer(edge.app())
        await server.start_server()
        registry = (jmetrics if name == "jax" else tmetrics).new_loadgen_registry()
        try:
            driver = mod.OpenLoopDriver(
                f"http://{server.host}:{server.port}",
                payload_for=lambda ev, mod=mod: mod.default_payload(ev, "llama-tiny"),
                headers_for=lambda ev: {"X-Soak-Tenant": ev.tenant},
                drain_s=5.0, registry=registry,
            )
            records = await driver.run(events)
        finally:
            await server.close()
        out[name] = (
            [(r.rid, r.outcome, r.status, r.tokens, r.retry_after, r.detail, r.ttft_s is not None)
             for r in sorted(records, key=lambda r: r.rid)],
            [body for _, body in sorted(edge.seen, key=lambda s: json.dumps(s[1], sort_keys=True))],
            registry.family("dtpu_loadgen_requests_total").value("fast", "ok"),
        )
    assert out["torch"] == out["jax"]
    assert {r[1] for r in out["torch"][0]} >= {"ok", "shed", "failed_5xx", "failed_truncated",
                                             "failed_stream_error"}


_HEAVY = {"torch", "aiohttp", "numpy", "jax", "jaxlib"}
IMPORT_LIGHT = ("__init__.py", "spec.py", "schedule.py", "textgen.py", "report.py", "metrics.py")


@pytest.mark.parametrize("name", IMPORT_LIGHT)
def test_generator_path_static_imports_are_light(name):
    tree = ast.parse((LOADGEN / name).read_text())
    imported = {
        (n.module or "").split(".")[0] if isinstance(n, ast.ImportFrom) else a.name.split(".")[0]
        for n in ast.walk(tree)
        if isinstance(n, (ast.Import, ast.ImportFrom))
        for a in (n.names if isinstance(n, ast.Import) else [None])
    }
    assert not imported & _HEAVY, (name, imported & _HEAVY)


def test_generator_path_imports_no_heavy_runtime():
    code = (
        "import sys\n"
        "from dstack_tpu_torch.loadgen import compile_schedule, default_spec, evaluate\n"
        "import dstack_tpu_torch.loadgen.textgen\n"
        "s = compile_schedule(default_spec(10.0, 2.0), 1)\n"
        "assert s.digest()\n"
        "bad = [m for m in ('aiohttp', 'torch', 'numpy', 'jax') if m in sys.modules]\n"
        "assert not bad, f'loadgen pulled in {bad}'\n"
        "print('LIGHT')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "LIGHT" in proc.stdout, proc.stderr


def test_routing_imports_no_torch():
    """The routing package needs aiohttp (its forwarder), never torch."""
    code = (
        "import sys\n"
        "import dstack_tpu_torch.routing\n"
        "bad = [m for m in ('torch', 'numpy', 'jax') if m in sys.modules]\n"
        "assert not bad, f'routing pulled in {bad}'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
