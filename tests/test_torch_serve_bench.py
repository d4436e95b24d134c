"""The port's serving bench and ``/metrics`` on the CPU.

- ``serve/bench.py``'s ``run_bench`` against the JAX package's at the
  same small arguments (llama-tiny, batch 4, max_seq 256, 64-token
  prompts, 16 tokens, 32-token chunks, bursts of 4, turbo 8, spec 0; and
  the serial engine and the int8 cache): the same result keys (the port's
  extra keys aside) and ``metric``, and equal step, token, prefix-reuse
  and burst dispatch counts. The weights differ (each package's own
  seed-0 init), which these counts do not read: no request has an eos, and
  at ``turbo_steps`` 8 the macro-step cap never reads the clock.
- ``main``: one JSON line with ``--device cpu``; without it on a machine
  with no GPU it raises (``--quantize int8``:
  tests/test_torch_quant_engine.py; ``--sessions``:
  tests/test_torch_session_bench.py).
- ``loadgen/textgen.py``: the same numpy seed gives JAX's prompts.
- The server: ``/metrics`` answers ``text/plain`` with every serve family;
  after completions (one with ``n`` = 2) the request, queue-wait, TTFT,
  token and dispatch series moved by what was served; an engine error is
  counted; ``/health`` keeps its keys.
- On the card (``cuda``-marked, skipped here): the bench with a positive
  rate and K4's launches n_layers times the timed device steps, and
  ``/metrics`` of a card engine with the device-memory gauges.
"""

import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu.loadgen import textgen as jtextgen
from dstack_tpu.serve import bench as jbench
from dstack_tpu_torch.loadgen import textgen as ttextgen
from dstack_tpu_torch.models import llama
from dstack_tpu_torch.serve import bench as tbench
from dstack_tpu_torch.serve import engine as engine_mod
from dstack_tpu_torch.serve.engine import InferenceEngine
from dstack_tpu_torch.serve.graphs import GraphSet
from dstack_tpu_torch.serve.metrics import new_serve_registry
from dstack_tpu_torch.serve.openai_server import build_app
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer
from dstack_tpu_torch.utils import backend

SMALL = dict(model="llama-tiny", batch=4, max_seq=256, prompt_len=64, gen_len=16,
             prefill_chunk=32, arrival_burst=4, turbo_steps=8, spec_draft=0)
PORT_EXTRA = {"kernel_launches", "timed_steps", "host", "graphs", "graph_sites", "timed_compiles"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the bench against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", [{}, {"turbo_steps": 0, "prefill_pack": 1}, {"kv_quant": "int8"}],
                         ids=["default", "serial", "int8"])
def test_bench_counts_match_jax(delta):
    args = {**SMALL, **delta}
    want = jbench.run_bench(**args)
    got = tbench.run_bench(**args, device="cpu")
    assert set(got) == set(want) and got["metric"] == want["metric"] and got["unit"] == want["unit"]
    gx, wx = got["extra"], want["extra"]
    assert set(gx) - set(wx) == PORT_EXTRA and set(wx) <= set(gx)
    for key in ("decode_steps", "tokens", "tokens_per_step", "prefix_reuse_tokens", "prefill_pack",
                "spec_draft", "turbo_steps", "turbo_depth", "quantize", "kv_quant", "backend"):
        assert gx[key] == wx[key], key
    assert gx["tokens"] == SMALL["batch"] * (SMALL["gen_len"] - 1)
    # the CPU runs the step sites eagerly; the bench's warmup reaches every
    # variant its timed sections run
    assert gx["graphs"] is False and gx["timed_compiles"] == 0 and gx["graph_sites"]["decode"]["entries"] == 1
    for run in ("packed", "serial"):
        assert set(gx["concurrent"][run]) == set(wx["concurrent"][run])
        assert gx["concurrent"][run]["prefill_dispatches"] == wx["concurrent"][run]["prefill_dispatches"]
    assert gx["concurrent"]["dispatch_ratio"] == wx["concurrent"]["dispatch_ratio"]
    assert set(gx["concurrent"]) == set(wx["concurrent"])
    # llama-tiny's head_dim 32 has no K4 form: the engine's einsum decode,
    # and no kernel launched on the CPU
    assert gx["decode_kernel"] == "einsum" and gx["note"] == backend.CPU_NOTE
    assert gx["kernel_launches"]["flash_decode"] == 0 and gx["kernel_launches"]["flash_fwd"] == 0
    st = gx["timed_steps"]
    assert st["decode_steps"] + st["turbo_device_steps"] >= gx["decode_steps"]
    for key in ("value", "wall_tokens_per_sec", "ttft_ms_p50", "ttft_prefix_hit_ms", "ttft_long_cold_ms"):
        assert (got if key == "value" else gx)[key] > 0
    host = gx["host"]
    assert set(host) == {"wall_s", "cpu_s", "thread_cpu_s", "gc_collections", "gc_s"}
    # the process's CPU seconds come from getrusage, a coarser clock than the thread's
    assert host["wall_s"] > 0 and 0 < host["thread_cpu_s"] <= host["cpu_s"] + 0.01 and host["gc_s"] >= 0


def test_timed_sums_the_host_over_its_sections():
    """``_Timed.host`` adds each section's counters and the collector's
    passes made inside them, and leaves ``gc.callbacks`` as it found them."""
    import gc

    class Eng:
        stats = dict.fromkeys(tbench._STEP_KEYS, 0)
        graphs = GraphSet("cpu", capture=False)  # no step site: no compile

    timed = tbench._Timed(Eng())
    callbacks = list(gc.callbacks)
    with timed:
        gc.collect()
    gc.collect()  # outside: not counted
    with timed:
        gc.collect()
        sum(i * i for i in range(200_000))
    host = timed.host_counters()
    assert gc.callbacks == callbacks
    assert host["gc_collections"] == 2 and 0 < host["gc_s"] <= host["wall_s"]
    assert 0 < host["thread_cpu_s"] <= host["cpu_s"] + 0.01
    assert timed.compiles == 0


def test_bench_labels_k4_where_it_takes_the_model():
    r = tbench.run_bench(**{**SMALL, "model": "llama-tiny-64", "arrival_burst": 0}, device="cpu")
    assert r["extra"]["decode_kernel"] == "flash" and r["extra"]["concurrent"] is None
    assert r["metric"] == "serve_decode_tokens_per_sec[llama-tiny-64,batch=4]"


def test_main_prints_one_json_line(capsys, tmp_path):
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in SMALL.items()]
    out_file = tmp_path / "bench.json"
    assert tbench.main([*argv, "--device", "cpu", "--output", str(out_file)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "serve_decode_tokens_per_sec[llama-tiny,batch=4]" and r["value"] > 0
    assert json.loads(out_file.read_text()) == r


def test_main_without_device_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.main(["--model", "llama-tiny"])


def test_a_burst_wider_than_the_batch_is_refused():
    with pytest.raises(ValueError, match="needs --batch >= burst"):
        tbench.run_bench(**{**SMALL, "arrival_burst": 8}, device="cpu")


# ---------------------------------------------------------------------------
# prompts and the backend label
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed, vocab, count, length", [(0, 512, 4, 64), (3, 128256, 8, 256), (9, 2, 1, 1)])
def test_prompts_match_jax(seed, vocab, count, length):
    for fn in ("token_prompts", "repetitive_prompts"):
        got = getattr(ttextgen, fn)(np.random.default_rng(seed), vocab, count, length)
        want = getattr(jtextgen, fn)(np.random.default_rng(seed), vocab, count, length)
        assert got == want and len(got) == count and all(len(p) == length for p in got)


def test_backend_info(monkeypatch):
    assert backend.backend_info("cpu") == {"backend": "cpu", "note": backend.CPU_NOTE}

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(backend.subprocess, "run", lambda *a, **k: Done())
    assert backend._nvidia_smi(0) == ("NVIDIA H100 80GB HBM3", "700.00 W")
    monkeypatch.setattr(backend.subprocess, "run", lambda *a, **k: (_ for _ in ()).throw(OSError()))
    assert backend._nvidia_smi(0) is None


# ---------------------------------------------------------------------------
# the server's /metrics
# ---------------------------------------------------------------------------

CONFIG = llama.LLAMA_TINY_64
HEALTH_KEYS = {
    "status", "model", "device", "decode_kernel", "engine", "queue_depth", "inflight",
    "active_slots", "max_slots", "prefix_hits", "prefix_slots",
    "prefix_occupancy", "prefix_tokens", "stats", "kernel_launches", "flash_decode_launches",
    "w8_matmul_launches", "graph_sites", "graph_captures", "flight_warm", "device_memory",
    # the JAX server's lifecycle keys (the profiler, the flight summary, the
    # SLO windows and the boot block)
    "kv_utilization", "profiler_tracing", "flight", "slo_windows", "boot",
}


def _engine(device="cpu"):
    params = llama.init_params(CONFIG, torch.Generator(device=device).manual_seed(0), device=device)
    return InferenceEngine(CONFIG, params, max_batch=4, max_seq=256, prefill_chunk=64, device=device)


def _series(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.split(" # ", 1)[0].rsplit(" ", 1)
            out[key] = float(value)
    return out


async def _scrape(client) -> tuple:
    r = await client.get("/metrics")
    assert r.status == 200 and r.content_type == "text/plain"
    text = await r.text()
    return text, _series(text)


class TestMetricsEndpoint:
    async def test_every_family_and_what_was_served(self):
        eng = _engine()
        client = TestClient(TestServer(build_app(eng, ByteTokenizer(), "llama-tiny-64")))
        await client.start_server()
        try:
            text, m0 = await _scrape(client)
            for name in new_serve_registry().metric_names():
                fam = eng.metrics.family(name)
                assert f"# HELP {name} {fam.help}" in text and f"# TYPE {name} {fam.kind}" in text
            assert m0["dtpu_serve_max_slots"] == 4 and m0["dtpu_serve_queue_depth"] == 0
            assert "dtpu_serve_device_memory_bytes_in_use" not in m0  # absent on the CPU
            h0 = await (await client.get("/health")).json()
            for body in ({"prompt": "The quick brown fox " * 5, "max_tokens": 8},
                         {"prompt": "abcd" * 10, "max_tokens": 6, "n": 2}):
                r = await client.post("/v1/completions", json=body)
                assert r.status == 200
            _, m1 = await _scrape(client)
            h1 = await (await client.get("/health")).json()
            assert set(h1) == HEALTH_KEYS and set(h0) == HEALTH_KEYS
            # the CPU runs the step sites eagerly: no graph, no card memory
            assert h1["graph_captures"] == [] and h1["device_memory"] is None
            st = {k: h1["stats"][k] - h0["stats"][k] for k in h1["stats"]}
            d = {k: m1[k] - m0.get(k, 0.0) for k in m1}
            assert d["dtpu_serve_requests_total"] == 3
            assert d["dtpu_serve_queue_wait_seconds_count"] == 3
            assert d["dtpu_serve_ttft_seconds_count"] == st["ttft_count"] == 3
            assert d["dtpu_serve_tokens_generated_total"] == 3 + sum(
                st[f"{k}_tokens"] for k in ("decode", "spec", "turbo"))
            assert d["dtpu_serve_prefill_dispatches_total"] == st["prefill_dispatches"] > 0
            assert d["dtpu_serve_decode_step_seconds_sum"] == pytest.approx(
                sum(st[f"{k}_seconds"] for k in ("decode", "spec", "turbo")), abs=1e-9)
            assert d.get("dtpu_serve_request_errors_total", 0.0) == 0
            assert m1["dtpu_serve_active_slots"] == 0 and m1["dtpu_serve_prefix_slots"] >= 1
            # every step site's first call of a variant is one compile
            compiles = sum(v for k, v in m1.items() if k.startswith("dtpu_serve_compiles_total{"))
            assert compiles == sum(r["entries"] for r in h1["graph_sites"].values()) > 0
            assert not h1["flight_warm"]  # no warmup ran here
        finally:
            await client.close()

    async def test_an_engine_error_is_counted(self, monkeypatch):
        eng = _engine()

        def broken(*a, **kw):
            raise RuntimeError("planted prefill failure")

        # inside the wave, after the engine published the wave's slots
        monkeypatch.setattr(engine_mod, "prefill_chunk_step", broken)
        client = TestClient(TestServer(build_app(eng, ByteTokenizer(), "llama-tiny-64")))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json={"prompt": "hello", "max_tokens": 4})
            assert r.status >= 400
            _, m = await _scrape(client)
            assert m["dtpu_serve_request_errors_total"] == 1 and m["dtpu_serve_requests_total"] == 1
        finally:
            await client.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_bench_runs_the_kernels(self, cuda):
        # the kernels take bf16: llama-3.2-1b at full width, small shapes
        r = tbench.run_bench(**{**SMALL, "model": "llama-3.2-1b"}, device=cuda)
        x = r["extra"]
        st, lc, n = x["timed_steps"], x["kernel_launches"], llama.CONFIGS["llama-3.2-1b"].n_layers
        steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
        assert r["value"] > 0 and x["backend"] == "cuda" and x["decode_kernel"] == "flash"
        assert lc["flash_decode"] == n * steps > 0
        assert lc["flash_fwd"] == n * (st["prefill_dispatches"] - st["packed_dispatches"]) > 0

    async def test_metrics_carry_the_device_memory(self, cuda):
        client = TestClient(TestServer(build_app(_engine("cuda"), ByteTokenizer(), "llama-tiny-64")))
        await client.start_server()
        try:
            _, m = await _scrape(client)
            used, peak = m["dtpu_serve_device_memory_bytes_in_use"], m["dtpu_serve_device_memory_peak_bytes"]
            assert 0 < used <= peak
        finally:
            await client.close()
