#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card's name and power limit (``nvidia-smi``), build the
   hand-written kernels from ``dstack_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card in bf16 at the serving shapes (flash prefill at C = 16 and 256
   with q_offset 0 and 512; ragged flash decode with positions from 0 to
   2047), within atol = rtol = 2e-2. Times each kernel, its plain
   version and one PyTorch library call of the same function
   (``scaled_dot_product_attention`` with an explicit mask, a yardstick
   the port never calls) with CUDA events, L2 flushed before each
   launch, and reckons each call's bound from the bytes it must move at
   3.35 TB/s and its FLOPs at 989 TFLOP/s.
3. Path phase: start ``python -m dstack_tpu_torch.serve.openai_server
   --model llama-3.2-1b --device cuda --decode-kernel flash`` (full
   width, random weights from seed 0) on a free port, check every launch
   count reads 0, send 4 concurrent greedy ``/v1/completions`` (prompts
   of 40, 200, 300 and 700 byte tokens) and then one streamed
   ``/v1/chat/completions``, 32 tokens each, check every answer's shape,
   and read ``/health``: the prefill kernel must have run n_layers times
   per prefill chunk and the decode kernel n_layers times per decode
   step. Then, in this process, a teacher-forced comparison on one
   prompt over the prefill and 8 decode steps: the kernel path's logits
   against the plain path's, both held to the plain path in f32 (the
   kernel path's relative RMS logit error may be at most 1.5 times the
   plain bf16 path's).
4. Print the ``kernels`` JSON line, then the card line, then the last
   line ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import torch

from dstack_tpu_torch.models import llama
from dstack_tpu_torch.ops import cuda_build, flash, flash_decode
from dstack_tpu_torch.serve import engine
from dstack_tpu_torch.serve.chat_template import render_chat

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
TOL = 2e-2  # bf16: atol = rtol, the JAX package's own bf16 tolerance
# end to end, the kernel path's relative RMS logit error against the f32
# path may be at most this multiple of the plain bf16 path's (see
# teacher_forced_phase)
KERNEL_RMS_MARGIN = 1.5
MODEL = "llama-3.2-1b"
PROMPT_LENS = (40, 200, 300, 700)
MAX_TOKENS = 32
CHUNK = 256  # the server's --prefill-chunk default


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30) -> float:
    """Mean device time of ``fn`` from CUDA events, each launch after a
    64 MiB write that evicts the inputs from the 50 MB L2 (the serving
    path reads each layer's K/V cold). A spin of about 1 ms on the card
    before the start event lets the host finish enqueueing ``fn`` (the
    plain versions are a dozen eager ops), so the events bracket device
    work and no host-side gap."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def assert_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got.float() - want.float()).abs()
    limit = TOL + TOL * want.float().abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{what}: max |err| {err.max().item():.4g} beyond atol=rtol={TOL}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase() -> dict:
    c = llama.LLAMA_32_1B
    g = torch.Generator(device="cuda").manual_seed(0)
    h, hkv, d, t = c.n_heads, c.n_kv_heads, c.head_dim, 2048
    scale = c.attention_scale
    rows = {}

    k = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, hkv, t, d, generator=g, device="cuda").bfloat16()
    err_fwd, fwd = 0.0, None
    for chunk in (16, 256):
        for q_offset in (0, 512):
            q = torch.randn(1, h, chunk, d, generator=g, device="cuda").bfloat16()
            kw = dict(scale=scale, q_offset=q_offset)
            o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
            po, plse = flash.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err_fwd = max(err_fwd, assert_close(o, po, f"flash_fwd C={chunk} q_offset={q_offset}"))
            assert_close(lse, plse, f"flash_fwd lse C={chunk} q_offset={q_offset}")
            qi = q_offset + torch.arange(chunk, device="cuda")[:, None]
            mask = qi >= torch.arange(t, device="cuda")[None, :]
            keys = q_offset + chunk  # the causal frontier: what this call needs
            nbytes = 2 * q.numel() * 2 + lse.numel() * 4 + 2 * keys * hkv * d * 2
            flops = 4 * d * h * (chunk * q_offset + chunk * (chunk + 1) // 2)
            b_ms, b_by = bound_ms(nbytes, flops)
            row = {
                "ms": time_ms(lambda: flash.flash_attention_with_lse(q, k, v, **kw)),
                "plain_ms": time_ms(lambda: flash.flash_attention_plain(q, k, v, **kw)),
                "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)),
                "bound_ms": b_ms,
                "bound_by": b_by,
            }
            log(f"kernel flash_fwd C={chunk} q_offset={q_offset}: {json.dumps(row)}")
            if (chunk, q_offset) == (256, 512):
                fwd = row  # the reported shape: a middle chunk of a long prompt
    rows["flash_fwd"] = {**fwd, "max_abs_err": err_fwd}

    b, grp = 8, h // hkv
    q = torch.randn(b, hkv, grp, d, generator=g, device="cuda").bfloat16()
    kc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    vc = torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
    pos = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2047], dtype=torch.int32, device="cuda")
    o = flash_decode.flash_decode(q, kc, vc, pos, scale=scale)
    po = flash_decode.flash_decode_plain(q, kc, vc, pos, scale=scale)
    torch.cuda.synchronize()
    err_dec = assert_close(o, po, "flash_decode")
    mask = (torch.arange(t, device="cuda")[None, :] <= pos[:, None].long())[:, None, None, :]
    keys = int((pos.long() + 1).sum())
    nbytes = 2 * q.numel() * 2 + pos.numel() * 4 + 2 * keys * hkv * d * 2
    flops = 4 * d * grp * hkv * keys
    b_ms, b_by = bound_ms(nbytes, flops)
    dec = {
        "ms": time_ms(lambda: flash_decode.flash_decode(q, kc, vc, pos, scale=scale)),
        "plain_ms": time_ms(lambda: flash_decode.flash_decode_plain(q, kc, vc, pos, scale=scale)),
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, scale=scale)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    log(f"kernel flash_decode B=8 positions={pos.tolist()}: {json.dumps(dec)}")
    rows["flash_decode"] = {**dec, "max_abs_err": err_dec}
    return rows


# ---------------------------------------------------------------------------
# phase 3: the serving path through the server, then teacher forcing
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url: str, body: dict, timeout: float = 300) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(url: str, body: dict) -> tuple[list, float, list]:
    """POST an SSE request → (events, send time, arrival time of each event)."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    events, arrivals = [], []
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                events.append("[DONE]")
                break
            events.append(json.loads(line[len("data: "):]))
            arrivals.append(time.perf_counter())
    return events, t0, arrivals


def _chunks(n_tokens: int) -> int:
    """Prefill chunks the engine runs for a prompt: one bucket up to
    CHUNK tokens, else ceil(n / CHUNK)."""
    return 1 if n_tokens <= CHUNK else -(-n_tokens // CHUNK)


def path_phase() -> dict:
    c = llama.CONFIGS[MODEL]
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    server_log = ROOT / "build" / "chip_smoke_server.log"
    server_log.parent.mkdir(parents=True, exist_ok=True)
    with open(server_log, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dstack_tpu_torch.serve.openai_server",
             "--model", MODEL, "--device", "cuda", "--decode-kernel", "flash",
             "--port", str(port), "--seed", "0"],
            cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
        )
        try:
            return _drive_server(c, base, proc)
        except BaseException:
            log("server log tail:\n" + server_log.read_text()[-4000:])
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def _drive_server(c, base: str, proc) -> dict:
    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode} before it was ready")
        try:
            h0 = _get(base + "/health")
            break
        except OSError:
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("server not ready after 600 s")
            time.sleep(0.5)
    log(f"server ready in {time.perf_counter() - t0:.1f} s")
    # the counts start at 0 in the fresh server process: nothing ran yet
    if any(h0["kernel_launches"].values()) or h0["stats"]["decode_steps"]:
        raise AssertionError(f"counts not zero before the path phase: {h0}")

    prompts = [("".join(chr(97 + (i * 7 + n) % 26) for i in range(n))) for n in PROMPT_LENS]
    results: list = [None] * len(prompts)
    errors: list = []

    def one(i: int) -> None:
        try:
            results[i] = _post(base + "/v1/completions",
                               {"prompt": prompts[i], "max_tokens": MAX_TOKENS, "temperature": 0})
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    t_batch = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    batch_s = time.perf_counter() - t_batch
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"completions failed: {errors}")
    for n, body in zip(PROMPT_LENS, results):
        ch = body["choices"][0]
        u = body["usage"]
        if not (body["object"] == "text_completion" and isinstance(ch["text"], str)
                and ch["finish_reason"] in ("length", "stop")
                and u["prompt_tokens"] == n and 1 <= u["completion_tokens"] <= MAX_TOKENS):
            raise AssertionError(f"malformed completion for a {n}-token prompt: {body}")
    log(f"4 concurrent completions in {batch_s:.3f} s: "
        + json.dumps([b["usage"]["completion_tokens"] for b in results]))

    # random weights over a 128k vocab rarely pick one of the 256 byte
    # ids, so a stream may carry few content deltas: TTFT comes from the
    # engine's own count (admission to first sampled token)
    st_before = _get(base + "/health")["stats"]
    messages = [{"role": "user", "content": "Name three colours of the rainbow."}]
    events, t_send, arrivals = _stream(
        base + "/v1/chat/completions",
        {"messages": messages, "max_tokens": MAX_TOKENS, "temperature": 0, "stream": True},
    )
    body = events[:-1]
    if (events[-1] != "[DONE]" or not body
            or body[-1]["choices"][0]["finish_reason"] not in ("length", "stop")
            or not all(e["object"] == "chat.completion.chunk" for e in body)):
        raise AssertionError(f"malformed chat stream: {events[-3:]}")
    chat_s = arrivals[-1] - t_send
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in body)

    h = _get(base + "/health")
    st, launches = h["stats"], h["kernel_launches"]
    chat_ttft = st["ttft_sum_s"] - st_before["ttft_sum_s"]
    log(f"chat stream: TTFT {chat_ttft:.4f} s (engine), whole stream {chat_s:.4f} s, "
        f"{len(body) - 1} content deltas, {len(text)} chars")
    want_chunks = sum(_chunks(n) for n in PROMPT_LENS) + _chunks(len(render_chat(messages)))
    if st["prefill_dispatches"] != want_chunks:
        raise AssertionError(f"prefill chunks {st['prefill_dispatches']} != {want_chunks}")
    if launches["flash_fwd"] != c.n_layers * st["prefill_dispatches"] or not launches["flash_fwd"]:
        raise AssertionError(f"flash_fwd launches {launches} vs stats {st}")
    if launches["flash_decode"] != c.n_layers * st["decode_steps"] or not launches["flash_decode"]:
        raise AssertionError(f"flash_decode launches {launches} vs stats {st}")
    path = {
        "launches": launches,
        "stats": st,
        "ttft_mean_s": st["ttft_sum_s"] / st["ttft_count"],
        "ttft_max_s": st["ttft_max_s"],
        "chat_ttft_s": chat_ttft,
        "decode_tokens_per_s": st["decode_tokens"] / st["decode_seconds"],
        "decode_step_ms": 1e3 * st["decode_seconds"] / st["decode_steps"],
        "chat_stream_s": chat_s,
    }
    log("path: " + json.dumps(path))
    return path


def teacher_forced_phase() -> dict:
    """Kernel path vs plain path on the card, teacher-forced: one
    300-token prompt (two chunks, the second at q_offset 256), then 8
    decode steps fed the kernel path's greedy tokens.

    Through 16 bf16 layers the two paths drift apart by the model's own
    bf16 noise (each attention call agrees within one bf16 ulp, yet
    logits of scale ~4 differ by ~0.1 at the worst of 128k entries), so
    both are held to a third path, the plain one in f32 on the same
    weights. The max over correlated logits is a noisy statistic; the
    relative RMS error is not, and at every step the kernel path's may
    be at most KERNEL_RMS_MARGIN times the plain bf16 path's. A wrong
    mask or a dropped key shows as a multiple of that noise."""
    c = llama.CONFIGS[MODEL]
    c32 = dataclasses.replace(c, dtype=torch.float32)
    params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    params32 = {
        k: {n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float()
        for k, v in params.items()
    }
    paths = {  # name → (params, config, prefill impl, decode kernel)
        "kernel": (params, c, None, "flash"),
        "plain": (params, c, "plain", "einsum"),
        "f32": (params32, c32, "plain", "einsum"),
    }
    prompt = [(i * 7 + 300) % 26 + 97 for i in range(300)]
    caches = {p: engine.init_cache(cfg, 1, 2048, device="cuda") for p, (_, cfg, _, _) in paths.items()}
    logits = {}
    for start in range(0, len(prompt), CHUNK):
        part = prompt[start : start + CHUNK]
        tokens = torch.tensor([part + [0] * (CHUNK - len(part))], device="cuda")
        for p, (w, cfg, impl, _) in paths.items():
            logits[p], caches[p] = engine.prefill_chunk_step(
                w, caches[p], tokens, 0, len(part) - 1, cfg, start=start, impl=impl,
            )
    report = {
        "max_kernel_vs_plain": 0.0, "max_kernel_vs_f32": 0.0, "max_plain_vs_f32": 0.0,
        "rel_rms_kernel_vs_f32": 0.0, "rel_rms_plain_vs_f32": 0.0, "argmax_agree": 0,
    }

    def rel_rms(a, ref):
        return ((a - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()

    def check(what: str) -> None:
        k, p, f = logits["kernel"], logits["plain"], logits["f32"]
        e = {
            "max_kernel_vs_plain": (k - p).abs().max().item(),
            "max_kernel_vs_f32": (k - f).abs().max().item(),
            "max_plain_vs_f32": (p - f).abs().max().item(),
            "rel_rms_kernel_vs_f32": rel_rms(k, f),
            "rel_rms_plain_vs_f32": rel_rms(p, f),
        }
        if not e["rel_rms_kernel_vs_f32"] <= KERNEL_RMS_MARGIN * e["rel_rms_plain_vs_f32"]:
            raise AssertionError(f"{what}: kernel path drifts from the f32 path: {e}")
        for name, v in e.items():
            report[name] = max(report[name], v)
        report["argmax_agree"] += int(
            logits["kernel"].argmax().item() == logits["plain"].argmax().item()
        )

    check("prefill")
    pos = len(prompt)
    for step in range(8):
        tok = logits["kernel"].argmax(dim=-1)
        positions = torch.tensor([pos], dtype=torch.int32, device="cuda")
        for p, (w, cfg, _, kern) in paths.items():
            logits[p], caches[p] = engine.decode_step(
                w, caches[p], tok, positions, cfg, decode_kernel=kern,
            )
        check(f"decode step {step}")
        pos += 1
    log("teacher-forced logits over prefill + 8 decode steps (max |err|): " + json.dumps(report))
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    seconds = cuda_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (per source: {json.dumps(seconds)})")

    rows = kernel_phase()
    path = path_phase()
    teacher_forced_phase()

    meta = {
        "flash_fwd": ("dstack_tpu_torch/csrc/flash_fwd.cu", "dstack_tpu/ops/flash.py:190"),
        "flash_decode": ("dstack_tpu_torch/csrc/flash_decode.cu", "dstack_tpu/ops/flash_decode.py:266"),
    }
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": path["launches"][name],
            "max_abs_err": rows[name]["max_abs_err"],
            "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
            "library_ms": rows[name]["library_ms"],
        }
        for name, (src, rep) in meta.items()
    ]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
