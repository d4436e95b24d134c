"""The port's serving paths on int8 weight trees against the JAX package on
the CPU.

Each package quantizes its own copy of one tiny f32 tree (bit for bit the
same int8 tree: tests/test_torch_quant.py), then: the engine's chunk,
packed, decode and verify step functions within 1e-4 on the bf16 and the
int8 cache (MLA: its latent cache only), with the caches, and the default
engines' greedy tokens wave by wave (packed prefill, speculative verify,
turbo, the prefix cache). Then the entry points: the server's
``--quantize int8`` in a subprocess on the CPU answers a greedy completion
with the tokens of an in-process engine over the same tree, and
``run_bench(quantize="int8")`` on the CPU counts JAX's steps, tokens and
dispatches.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.serve import bench as jbench
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.models import quant as tquant
from dstack_tpu_torch.ops import flash_decode
from dstack_tpu_torch.serve import bench as tbench
from dstack_tpu_torch.serve import engine as tengine
from tests.test_torch_quant import configs, trees

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4  # f32 end to end
INT8_PREFILL_ATOL = 4e-3  # int8-cache logits (tests/test_torch_gemma.py's module note)
INT8_FLIP_SHARE = 3e-2  # int8 cache entries one step apart
MAX_SEQ = 128
CHUNK = 32
STEP_CONFIGS = ("llama_untied", "moe", "shared_expert", "gpt_oss", "mla", "gateless", "biased")
ENGINE_CONFIGS = ("llama_untied", "moe", "gpt_oss", "mla")

_J_CHUNK = jax.jit(jengine.prefill_chunk_step, static_argnames=("config", "start"))
_J_PACKED = jax.jit(jengine.prefill_packed_step, static_argnames=("config",))
_J_DECODE = jax.jit(jengine.decode_step, static_argnames=("config", "decode_kernel"))
_J_VERIFY = jax.jit(jengine.verify_step, static_argnames=("config", "decode_kernel"))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


PROMPTS = _prompts(3, [20, 45, 5, 40])  # one past a chunk
_PREFILLED: dict = {}


def _assert_caches(tc: dict, jc: dict, flip_share: float) -> None:
    assert set(tc) == set(jc)
    for n in jc:
        got, want = tc[n].numpy(), np.asarray(jc[n])
        if want.dtype == np.int8:
            flips = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert flips.max() <= 1 and (flips != 0).mean() <= flip_share, (n, flips.sum())
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=n)


def _setup(name, kv_quant):
    jc, tc = configs(name)
    if kv_quant and tc.mla:
        pytest.skip("MLA's latent cache has no int8 form (in JAX either)")
    jp, tp = trees(name)
    return jc, tc, jp, tp


def _prefilled(name, kv_quant) -> tuple:
    """Both caches after the serial prefill of PROMPTS into slots 0-3, each
    chunk's logits checked → (JAX cache, a copy of the port's; on the int8
    cache a copy of JAX's, so that each later step starts from equal
    caches)."""
    jcfg, tcfg, jp, tp = _setup(name, kv_quant)
    key = (name, kv_quant)
    if key not in _PREFILLED:
        atol = INT8_PREFILL_ATOL if kv_quant else ATOL
        jc = jengine.init_cache(jcfg, 4, MAX_SEQ, kv_quant=kv_quant)
        tc = tengine.init_cache(tcfg, 4, MAX_SEQ, device="cpu", kv_quant=kv_quant)
        for slot, p in enumerate(PROMPTS):
            for start in range(0, len(p), CHUNK):
                part = p[start: start + CHUNK]
                toks = np.zeros((1, CHUNK), np.int32)
                toks[0, : len(part)] = part
                jl, jc = _J_CHUNK(jp, jc, jnp.asarray(toks), jnp.asarray(slot), jnp.asarray(len(part) - 1),
                                  config=jcfg, start=start)
                tl, tc = tengine.prefill_chunk_step(tp, tc, torch.from_numpy(toks).long(), slot,
                                                    len(part) - 1, tcfg, start=start)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=ATOL)
        _assert_caches(tc, jc, INT8_FLIP_SHARE)
        _PREFILLED[key] = (jc, tc)
    jc, tc = _PREFILLED[key]
    copy = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()} if kv_quant else tc
    return jc, {n: a.clone() for n, a in copy.items()}


@pytest.fixture(params=STEP_CONFIGS)
def name(request):
    return request.param


@pytest.mark.parametrize("kv_quant", [None, "int8"])
class TestStepFunctions:
    def test_prefill_chunk_step(self, name, kv_quant):
        _prefilled(name, kv_quant)

    def test_prefill_packed_step(self, name, kv_quant):
        jcfg, tcfg, jp, tp = _setup(name, kv_quant)
        jc, tc = _prefilled(name, kv_quant)
        tokens = np.random.default_rng(2).integers(0, 256, size=(4, CHUNK)).astype(np.int32)
        slots = np.array([2, 0, 3, 0], np.int32)
        starts = np.array([5, 45, 40, 0], np.int32)
        last_ix = np.array([29, 31, 10, -1], np.int32)  # the last row is a pad row
        jl, jc = _J_PACKED(jp, jc, *(jnp.asarray(a) for a in (tokens, slots, starts, last_ix)), config=jcfg)
        tl, tc = tengine.prefill_packed_step(tp, tc, *(torch.from_numpy(a).long() for a in
                                                       (tokens, slots, starts, last_ix)), tcfg)
        np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], rtol=ATOL,
                                   atol=INT8_PREFILL_ATOL if kv_quant else ATOL)
        _assert_caches(tc, jc, INT8_FLIP_SHARE)

    def test_decode_step(self, name, kv_quant):
        jcfg, tcfg, jp, tp = _setup(name, kv_quant)
        jc, tc = _prefilled(name, kv_quant)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in PROMPTS], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = _J_DECODE(jp, jc, jnp.asarray(tok), jnp.asarray(pos), write_mask=jnp.asarray(mask),
                           config=jcfg, decode_kernel="einsum")
        tl, tc = tengine.decode_step(tp, tc, _t(tok).long(), _t(pos), tcfg, write_mask=_t(mask),
                                     decode_kernel=None if tcfg.mla else "flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc, 1e-3)

    def test_verify_step(self, name, kv_quant):
        jcfg, tcfg, jp, tp = _setup(name, kv_quant)
        jc, tc = _prefilled(name, kv_quant)
        tokens = np.random.default_rng(5).integers(0, 256, size=(4, 5)).astype(np.int32)
        positions = np.array([len(p) for p in PROMPTS], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = _J_VERIFY(jp, jc, jnp.asarray(tokens), jnp.asarray(positions), write_mask=jnp.asarray(mask),
                           config=jcfg, decode_kernel="einsum")
        tl, tc = tengine.verify_step(tp, tc, _t(tokens).long(), _t(positions), tcfg, _t(mask),
                                     decode_kernel=None if tcfg.mla else "flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=ATOL,
                                   atol=INT8_PREFILL_ATOL if kv_quant else ATOL)
        _assert_caches(tc, jc, INT8_FLIP_SHARE)


def _drive(eng, gen_cls, waves) -> list:
    """The scheduler's call sequence, wave by wave (test_torch_gpt_oss.py)."""
    records = []
    for prompts in waves:
        slots = [eng.start_request(list(p), gen_cls(max_new_tokens=10)) for p in prompts]
        while eng._prefilling:
            records.append(("prefill", eng.prefill_wave()))
        while any(eng.active[s] for s in slots):
            out = eng.step()
            records.append((eng._last_step_phase, out))
        for s in slots:
            eng.release(s)
    return records


@pytest.mark.parametrize("engine_name", ENGINE_CONFIGS)
def test_engines_emit_identical_greedy_tokens(engine_name):
    """The default engines on the bf16 cache: the same records wave by
    wave, the prefix cache hit once."""
    jcfg, tcfg, jp, tp = _setup(engine_name, None)
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9)
    je = jengine.InferenceEngine(jcfg, jp, decode_kernel="einsum", **kw)
    # K4's plain version where K4 takes the model (head_dim 64), else the einsum
    route = None if tcfg.mla or flash_decode.flash_decode_supported(tcfg, MAX_SEQ) else "einsum"
    te = tengine.InferenceEngine(tcfg, tp, device="cpu", decode_kernel=route, **kw)
    phrase = [5, 9, 13, 17]
    shared = _prompts(8, [70])[0]
    waves = [
        [(phrase * 10)[:36]],
        _prompts(9, [20, 45, 70]),  # a concurrent burst: a packed wave
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],  # reuses 64 cached positions
    ]
    assert _drive(te, tengine.GenParams, waves) == _drive(je, jengine.GenParams, waves)
    st = te.stats
    assert st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1
    assert st["prefix_hits"] == je.prefix_hits == 1


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_bench_int8_counts_match_jax():
    """``run_bench(quantize="int8")`` on the CPU (the host random tree)
    against JAX's at the small arguments of tests/test_torch_serve_bench.py:
    equal step, token, prefix-reuse and dispatch counts."""
    args = dict(model="llama-tiny", batch=4, max_seq=256, prompt_len=64, gen_len=16, prefill_chunk=32,
                arrival_burst=4, turbo_steps=8, spec_draft=0, quantize="int8")
    want = jbench.run_bench(**args)
    got = tbench.run_bench(**args, device="cpu")
    gx, wx = got["extra"], want["extra"]
    for key in ("decode_steps", "tokens", "tokens_per_step", "prefix_reuse_tokens", "prefill_pack",
                "quantize", "kv_quant"):
        assert gx[key] == wx[key], key
    assert gx["quantize"] == "int8" and got["metric"] == want["metric"] and got["value"] > 0
    for run in ("packed", "serial"):
        assert gx["concurrent"][run]["prefill_dispatches"] == wx["concurrent"][run]["prefill_dispatches"]
    # on the CPU the plain version runs: no launch is counted
    assert gx["kernel_launches"]["w8_matmul"] == 0
    assert gx["kernel_launches"]["w8_matmul_by_form"] == {"proj": 0, "head": 0, "experts": 0}


def test_bench_main_takes_quantize(capsys):
    argv = ["--model", "llama-tiny", "--batch", "2", "--max-seq", "128", "--prompt-len", "16",
            "--gen-len", "4", "--prefill-chunk", "16", "--quantize", "int8", "--device", "cpu"]
    assert tbench.main(argv) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["extra"]["quantize"] == "int8" and r["value"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_quantize_int8_answers_with_the_engine_tokens(tmp_path):
    """``openai_server --quantize int8 --device cpu`` in a subprocess: the
    seed-0 tree built on the host, quantized, served; a greedy completion
    equals an in-process engine's over the same tree."""
    port = _free_port()
    log = open(tmp_path / "server.log", "w")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.serve.openai_server", "--model", "llama-tiny-64",
         "--device", "cpu", "--quantize", "int8", "--port", str(port), "--max-seq", "256",
         "--no-warmup"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=env,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError((tmp_path / "server.log").read_text())
                time.sleep(0.5)
        assert health["kernel_launches"]["w8_matmul"] == 0 and health["device"] == "cpu"
        prompt = "int8 weights, per-output-channel scales"
        body = json.dumps({"prompt": prompt, "max_tokens": 12, "temperature": 0}).encode()
        req = urllib.request.Request(base + "/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert "weights quantized to int8" in (tmp_path / "server.log").read_text()
    from dstack_tpu_torch.serve.tokenizer import ByteTokenizer

    config = tllama.CONFIGS["llama-tiny-64"]
    params = tllama.init_params(config, torch.Generator().manual_seed(0), device="cpu")
    tree = tquant.quantize_tree(params, config)
    eng = tengine.InferenceEngine(config, tree, max_batch=8, max_seq=256, device="cpu")
    tok = ByteTokenizer()
    ids = eng.generate(tok.encode(prompt), tengine.GenParams(max_new_tokens=12, eos_id=tok.eos_id))
    assert answer["choices"][0]["text"] == tok.decode([i for i in ids if i != tok.eos_id])
    assert answer["usage"]["completion_tokens"] == len(ids)
