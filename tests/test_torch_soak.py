"""The port's loadgen soak (``dstack_tpu_torch.loadgen.soak.run_soak``) on
the CPU, held to the JAX soak's own acceptance: replicas of the port's
server on llama-tiny (JAX's weights carried across by
``params_from_jax``) behind the port's router with QoS on.

- ``tests/chaos/test_chaos_loadgen.py``: a drain flip and a replica kill
  under open-loop load give zero client 5xx and zero failures, an opened
  breaker, resumes or failovers, a bounded dip that recovers, honest
  sheds, worst requests attributed from the stitched traces, the flight
  block's compile accounting, and the compiled schedule's digest;
- ``tests/chaos/test_chaos_boot.py``: a cold scale-up replica built from
  nothing under its own boot recorder joins the pool with every boot stage
  and milestone recorded and goodput held;
- ``tests/chaos/test_chaos_slo.py``: the live SLO engine fires a fast
  error-rate burn on a soft-failing survivor inside the kill window,
  resolves it after, and pins and releases the replica through the pool.
"""

import jax
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu_torch import faults
from dstack_tpu_torch.loadgen import compile_schedule, default_spec
from dstack_tpu_torch.loadgen.soak import SoakConfig, run_soak
from dstack_tpu_torch.models import llama as tllama


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def params():
    tree = jax.tree.map(np.asarray, jllama.init_params(jllama.LLAMA_TINY, jax.random.key(0)))
    return tllama.params_from_jax(tree, tllama.LLAMA_TINY, device="cpu")


def test_kill_and_drain_under_open_loop_load(params):
    schedule = compile_schedule(default_spec(duration_s=10.0, rate_rps=5.0), 7)
    assert len(schedule.events) >= 10
    cfg = SoakConfig(replicas=2, chaos=True, drain_start_frac=0.20, drain_end_frac=0.35,
                     kill_frac=0.55, kill_window_s=2.5, output=None, device="cpu")
    report = run_soak(schedule, cfg, params=params)

    assert report["schedule_digest"] == schedule.digest()
    assert report["overall"]["requests"] == len(schedule.events)
    assert report["client_5xx"] == 0, report["overall"]["outcomes"]
    assert report["failures"] == 0, report["overall"]["outcomes"]
    router = report["router"]
    assert router["dtpu_router_breaker_opens_total"] >= 1, router
    assert router["dtpu_router_stream_resumes_total"] + router["dtpu_router_failovers_total"] >= 1
    kill = report["windows"]["kill"]
    assert kill["requests"] >= 1 and kill["goodput_ratio"] is not None
    assert kill["goodput_ratio"] >= 0.25, kill
    assert report["windows"]["_recovery"]["recovered"] is True, report["windows"]["_recovery"]
    assert report["overall"]["sheds"]["honest"] is True

    for wname in ("drain", "kill"):
        worst = report["windows"][wname].get("worst_requests")
        assert worst is not None
        attributed = [w for w in worst if w.get("phase_ms")]
        assert not worst or attributed, f"{wname}: no worst request resolved to a trace"
        for entry in attributed:
            assert entry["trace_id"]
            assert entry["dominant_phase"] in ("qos_queue", "prefill", "router_retry")
            assert set(entry["phase_ms"]) == {"qos_queue", "prefill", "decode", "router_retry"}

    fl = report["flight"]
    assert fl is not None and fl["postmortems"] == 0
    assert fl["memory_available"] is False and fl["peak_memory_bytes"] is None  # the CPU: honest
    assert fl["recompiles"] == len([e for e in fl["events"] if e["recompile"]])
    assert sum(fl["compiles"].values()) == len(fl["events"])
    for wname in ("drain", "kill"):
        stalls = report["windows"][wname]["compile_stalls"]
        assert stalls["events"] >= stalls["recompiles"] >= 0
    for name, cls in report["classes"].items():
        assert cls["goodput_ratio"] is not None, name
        assert "ttft_ms_p50" in cls and "tpot_ms_p50" in cls and "sheds" in cls
    assert report["open_loop"]["sched_lag_ms_p95"] < 2000.0
    assert report["backend"] == "cpu" and report["note"]


def test_cold_replica_scale_up_under_open_loop_load(params):
    schedule = compile_schedule(default_spec(duration_s=30.0, rate_rps=3.0), 11)
    cfg = SoakConfig(replicas=2, chaos=False, scale_up=True, scale_up_frac=0.1,
                     scale_up_window_s=10.0, output=None, device="cpu")
    report = run_soak(schedule, cfg, params=params)

    assert report["schedule_digest"] == schedule.digest()
    assert report["overall"]["requests"] == len(schedule.events)
    assert report["client_5xx"] == 0 and report["failures"] == 0, report["overall"]["outcomes"]
    boot = report["boot"]
    assert boot is not None and boot["replica"] == "r2" and boot["boot_id"]
    assert boot["t_spawn"] > 0.0
    stages = boot["stages"]
    for name in ("weights_load", "engine_init", "warmup_compile", "warm_prefix_copies"):
        assert stages.get(name, 0.0) > 0.0, (name, stages)
    marks = boot["marks"]
    for name in ("listener_up", "first_probe", "first_served_token"):
        assert marks.get(name) is not None, (name, marks)
    assert marks["listener_up"] <= marks["first_probe"] <= marks["first_served_token"]
    assert boot["time_to_ready_s"] == marks["first_probe"]
    assert boot["ttfst_s"] == marks["first_served_token"]
    assert sum(stages.values()) <= boot["ttfst_s"] + 1e-6, boot
    assert boot["warm"] is True and boot["manifest_variants"] >= 1
    by_stage = {e["stage"]: e for e in boot["timeline"]}
    assert by_stage["weights_load"]["bytes"] > 0 and by_stage["weights_load"]["bytes_per_s"] > 0
    assert by_stage["warmup_compile"]["manifest"] >= 1
    ts = [e["t"] for e in boot["timeline"]]
    assert ts == sorted(ts)
    up = report["windows"]["scale_up"]
    assert up["requests"] >= 1 and up["goodput_ratio"] is not None, up
    assert report["overall"]["goodput_ratio"] >= 0.5, report["overall"]


SLO_POLICY = {
    "name": "chaos-acceptance",
    "classes": [{"name": "soak", "ttft_slo_ms": 60000.0, "tpot_slo_ms": 60000.0}],
    "latency_compliance": 0.5,
    "error_rate_slo": 0.001,
    "shed_honesty": True,
    "fast_burn": {"factor": 14.4, "windows": ["5m", "1h"]},
    "slow_burn": {"factor": 1.0, "windows": ["6h"]},
    "hold_down_s": 60.0,
    "resolve_after_s": 120.0,
    "min_events": 2,
}


def test_fast_burn_fires_in_kill_window_and_closes_the_loop(params, monkeypatch):
    monkeypatch.setenv("DTPU_BG_TICK_SCALE", "0.01")
    schedule = compile_schedule(default_spec(duration_s=16.0, rate_rps=3.5), 11)
    assert len(schedule.events) >= 20
    cfg = SoakConfig(
        replicas=3, chaos=True, drain_start_frac=0.15, drain_end_frac=0.30, kill_frac=0.45,
        kill_window_s=4.0,
        # bounded engine-step errors on survivor r1, installed at kill time
        kill_extra_rules=[{"point": "serve.engine.step", "ctx": {"replica": "r1"},
                           "action": "raise", "nth": [1, 20]}],
        slo_policy=SLO_POLICY, slo_tick_s=0.4, probe_interval_s=0.4, output=None, device="cpu",
    )
    report = run_soak(schedule, cfg, params=params)

    assert report["schedule_digest"] == schedule.digest()
    assert report["client_5xx"] == 0 and report["failures"] == 0, report["overall"]["outcomes"]
    router = report["router"]
    assert router["dtpu_router_breaker_opens_total"] >= 1, router
    assert router["dtpu_router_stream_resumes_total"] + router["dtpu_router_failovers_total"] >= 1
    slo = report["slo"]
    assert slo is not None and slo["policy"] == "chaos-acceptance"
    kill = report["windows"]["kill"]
    fast_err = [tr for tr in slo["transitions"]
                if tr["severity"] == "fast" and tr["objective"] == "error_rate"]
    fired = [tr for tr in fast_err if tr["state"] == "firing"]
    assert fired, slo["transitions"]
    fired_t = min(tr["t"] for tr in fired)
    assert kill["start"] <= fired_t <= kill["end"], (fired_t, kill, fast_err)
    resolved = [tr for tr in fast_err if tr["state"] == "resolved"]
    assert resolved, fast_err
    resolved_t = max(tr["t"] for tr in resolved)
    assert resolved_t > kill["end"] and resolved_t > fired_t
    assert {tr["replica"] for tr in fired if tr["replica"] is not None} == {"r1"}, fast_err
    assert router["dtpu_router_slo_degraded_total"] >= 1, router
    assert router["dtpu_router_slo_restored_total"] >= 1, router
    latency_fired = [tr for tr in slo["transitions"]
                     if tr["state"] == "firing" and tr["objective"].split(":")[0] in ("ttft", "tpot")]
    assert latency_fired == []
    assert report["overall"]["sheds"]["honest"] is True
