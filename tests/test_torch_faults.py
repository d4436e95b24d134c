"""The port's fault layer (``dstack_tpu_torch.faults``) against the JAX
package's (``dstack_tpu.faults``) on the same plans and the same seeded call
sequences.

- ``POINTS`` is equal, so a plan validates alike in both packages.
- With no plan installed both packages' ``fire``, ``afire`` and ``mutate``
  are their no-op functions (the zero-cost identity), and installing a
  plan in one package leaves the other's untouched: each package's server
  fires its own global.
- The firing schedule: one seeded plan (nth, prob, times, ctx, globs, and
  the raise, delay, hang and corrupt actions at zero seconds) and one
  seeded call sequence give the same outcome on every call (the exception
  raised, its HTTP status and ``retry_after``, the mutated value) and the
  same per-rule call and fire counts.
- ``validate_plan`` gives the same errors on a corpus of bad plans (the
  CLI's module name aside); ``python -m dstack_tpu_torch.faults`` lists
  every point and validates a plan offline; ``DTPU_FAULT_PLAN`` installs at
  import.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dstack_tpu import faults as jfaults
from dstack_tpu_torch import faults as tfaults

REPO = Path(__file__).resolve().parents[1]
MODS = (jfaults, tfaults)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    for m in MODS:
        m.clear()
    yield
    for m in MODS:
        m.clear()


def test_points_are_jax_points():
    assert tfaults.POINTS == jfaults.POINTS
    assert tfaults.ERROR_SHORTHANDS.keys() == jfaults.ERROR_SHORTHANDS.keys()


def test_no_plan_is_the_noop_identity_in_both():
    for m in MODS:
        assert not m.active()
        assert m.fire is m._noop_fire and m.afire is m._noop_afire and m.mutate is m._noop_mutate
        assert m.mutate("serve.deadline", 0.25) == 0.25
    tfaults.install_plan({"rules": [{"point": "serve.deadline", "action": "corrupt", "value": 3}]})
    assert tfaults.mutate("serve.deadline", 0.0) == 3
    assert jfaults.mutate is jfaults._noop_mutate and not jfaults.active()
    tfaults.clear()
    assert tfaults.fire is tfaults._noop_fire


def _plan(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    rules = [
        {"point": "serve.engine.step", "action": "raise", "prob": float(rng.uniform(0.2, 0.6)),
         "ctx": {"slot": 1}},
        {"point": "serve.*", "action": "raise", "error": "http:429", "retry_after": 2,
         "nth": sorted(int(x) for x in rng.choice(np.arange(1, 60), 5, replace=False))},
        {"point": "serve.admit", "action": "raise", "error": "timeout", "prob": 0.3, "times": 4},
        {"point": "serve.deadline", "action": "corrupt", "value": float(rng.uniform(1, 9)), "nth": [2, 5, 9]},
        {"point": "routing.*", "action": "corrupt", "replace": {"x": int(rng.integers(0, 9))}, "prob": 0.5},
        {"point": "db.commit", "action": "delay", "seconds": 0, "prob": 0.5},
        {"point": "serve.engine.step", "action": "hang", "seconds": 0, "nth": 3, "ctx": {"slot": 0}},
        {"point": "agent.*", "action": "raise", "error": "builtins.ValueError", "times": 2},
        {"point": "routing.probe", "action": "raise", "error": "connect", "prob": 0.25},
    ]
    return {"seed": int(seed), "rules": rules}


def _calls(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(1000 + seed)
    points = ["serve.engine.step", "serve.admit", "serve.deadline", "routing.probe", "routing.forward",
              "db.commit", "agent.request", "agent.pull"]
    out = []
    for _ in range(n):
        p = points[int(rng.integers(0, len(points)))]
        kind = "mutate" if p in ("serve.deadline", "routing.forward") or rng.random() < 0.1 else (
            "afire" if rng.random() < 0.3 else "fire")
        ctx = {"slot": int(rng.integers(0, 3))} if p == "serve.engine.step" else {"tenant": "t"}
        out.append((p, kind, ctx))
    return out


def _outcome(mod, point, kind, ctx):
    try:
        if kind == "mutate":
            return ("value", mod.mutate(point, {"v": 1} if point.startswith("routing") else 0.0, **ctx))
        if kind == "afire":
            asyncio.run(mod.afire(point, **ctx))
        else:
            mod.fire(point, **ctx)
        return ("ok",)
    except Exception as e:  # noqa: BLE001 - the injected fault is the outcome
        return ("raised", type(e).__name__, str(e), getattr(e, "status", None), getattr(e, "retry_after", None))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_plan_same_calls_same_schedule(seed):
    plan, calls = _plan(seed), _calls(seed)
    schedules, counts = [], []
    for mod in MODS:
        compiled = mod.install_plan(json.dumps(plan))
        schedules.append([_outcome(mod, *c) for c in calls])
        counts.append([(r.index, r.calls, r.fired) for r in compiled.rules])
        mod.clear()
    assert schedules[1] == schedules[0]
    assert counts[1] == counts[0]
    fired = sum(1 for o in schedules[1] if o[0] != "ok" and o != ("value", 0.0) and o != ("value", {"v": 1}))
    assert 10 < fired < len(calls)  # the plan really fired, and not on every call


BAD_PLANS = [
    [],
    {"seed": "x", "rules": []},
    {"rules": "nope", "extra": 1},
    {"rules": [{"action": "raise"}]},
    {"rules": [{"point": "no.such.point"}]},
    {"rules": [{"point": "db.commit", "action": "explode"}]},
    {"rules": [{"point": "db.commit", "error": "bogus"}, {"point": "db.commit", "error": "http:x"}]},
    {"rules": [{"point": "db.commit", "error": 5}]},
    {"rules": [{"point": "db.commit", "nth": "x", "prob": 2, "times": -1, "seconds": -1}]},
    {"rules": [{"point": "db.commit", "wat": 1, "ctx": 3, "replace": []}]},
    {"rules": ["x", {"point": "serve.*", "action": "hang", "seconds": 1}]},
]


@pytest.mark.parametrize("i", range(len(BAD_PLANS)))
def test_validate_plan_gives_jax_errors(i):
    plan = BAD_PLANS[i]
    want = jfaults.validate_plan(plan)
    got = [e.replace("dstack_tpu_torch.faults", "dstack_tpu.faults") for e in tfaults.validate_plan(plan)]
    assert got == want and want
    with pytest.raises(ValueError, match="invalid fault plan"):
        tfaults.install_plan(plan)
    assert not tfaults.active()


def test_cli_lists_points_and_validates_offline(tmp_path):
    r = subprocess.run([sys.executable, "-m", "dstack_tpu_torch.faults"], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-500:]
    assert all(p in r.stdout for p in tfaults.POINTS)
    good = tmp_path / "plan.json"
    good.write_text(json.dumps({"seed": 1, "rules": [{"point": "serve.engine.step", "action": "hang",
                                                      "seconds": 4, "ctx": {"slot": 2}, "times": 1}]}))
    r = subprocess.run([sys.executable, "-m", "dstack_tpu_torch.faults", "--validate", str(good)],
                       cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "OK: 1 rule(s), seed=1; points: serve.engine.step" in r.stdout
    r = subprocess.run([sys.executable, "-m", "dstack_tpu_torch.faults", "--validate",
                        '{"rules": [{"point": "no.such.point"}]}'],
                       cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 1 and "matches no registered" in r.stderr


def test_env_plan_installs_at_import_without_jax():
    src = ("import sys, dstack_tpu_torch.faults as f\n"
           "assert f.active()\n"
           "try:\n    f.fire('serve.admit')\nexcept f.InjectedHTTPError as e:\n    print('INJECTED', e.status)\n"
           "print('JAX' if 'jax' in sys.modules else 'NOJAX')\n")
    env = {"DTPU_FAULT_PLAN": json.dumps({"rules": [{"point": "serve.admit", "error": "http:429"}]}),
           "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", src], cwd=REPO, capture_output=True, text=True, timeout=60,
                       env=env)
    assert r.returncode == 0, r.stderr[-800:]
    assert "INJECTED 429" in r.stdout and "NOJAX" in r.stdout
