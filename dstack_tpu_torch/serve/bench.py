"""Serving benchmark of the port: decode throughput and TTFT of the slot
engine (counterpart of ``dstack_tpu.serve.bench``).

``python -m dstack_tpu_torch.serve.bench --model llama-3.2-1b --batch 8``
drives the engine directly (no HTTP) on the card and prints one JSON
line: decode tokens/s across the concurrent slots, TTFT p50/p99 through
chunked prefill, the TTFT of a prefix-cache hit against a cold prompt of
the same length, and with ``--arrival-burst N`` a burst of N prompts
admitted at once, prefilled packed and then serially. Every number is
read from the engine's own registry (``serve/metrics.py``), the series
the server renders on ``/metrics``, not from stopwatches of the bench's
own. ``--device cpu`` runs the plain versions on the CPU: a smoke run,
labelled so. Without it, and without a card, the bench raises.

The same arguments give the JAX bench's result keys and ``metric``.
Deltas from it:

- ``--device`` (default ``cuda``) in place of ``--platform``;
- ``decode_kernel`` is the engine's: ``"flash"`` (K4) when the argument
  is None and K4 takes the model, as the port's engine defaults to it
  (JAX's default is its einsum), else ``"einsum"``;
- ``extra`` adds ``kernel_launches``: the launches of K1, K1's MLA form,
  K4 (by form) and W8 (by form) during the timed sections, as
  ``/health`` reports them (0 on the CPU, where the plain versions run),
  and ``timed_steps``: the engine's dispatch counts over the same
  sections, so that K4's launches can be held to n_layers x (plain +
  verify + turbo device steps); ``host``: what the host did over the same sections (wall
  seconds, the CPU seconds of this process and of the engine's thread,
  garbage collections and their seconds); ``graphs``: whether the
  engine's decode-side steps ran as CUDA graphs (``serve/graphs.py``;
  ``run_bench(graphs=False)`` runs the eager engine, the reference, and
  is no CLI flag), each site's captures and capture seconds
  (``graph_sites``), and the variants first compiled inside the timed
  sections (``timed_compiles``: 0 when the warmup covered them); and the
  card's name and power limit (``utils/backend.py``);
- ``--quantize int8`` serves a random int8 tree (``models/quant.py``):
  ``random_quantized_params`` on the host with ``--device cpu``, else
  ``random_quantized_params_on_device`` drawn on the card, so a model too
  large for the card in bf16 (llama-3-70b) runs at full depth; its
  products go through W8 (``ops/w8_matmul.py``), whose launches by form
  ``kernel_launches`` adds;
- ``--sessions`` and its flags (``run_session_bench``) need ``routing/``
  and come with ROADMAP A4, and are refused.

The host clock around ``step()`` and the clock up to a slot's activation
include the device's work only because each ends in a device-to-host
copy of the sampled tokens; the bench adds no synchronisation of its own
inside a timed section.
"""

import argparse
import gc
import json
import resource
import time

import numpy as np
import torch

from dstack_tpu_torch.loadgen.textgen import repetitive_prompts, token_prompts
from dstack_tpu_torch.models import llama, quant
from dstack_tpu_torch.ops import cuda_build, flash_decode
from dstack_tpu_torch.serve.engine import (
    GenParams,
    InferenceEngine,
    resolve_device,
)
from dstack_tpu_torch.serve.graphs import launch_counts
from dstack_tpu_torch.utils.backend import backend_info

# the engine's dispatch counts that the kernels' launches are held to
_STEP_KEYS = ("decode_steps", "spec_steps", "turbo_device_steps", "prefill_dispatches",
              "packed_dispatches")


def _host_counters() -> dict:
    """The wall clock, this process's CPU seconds (every thread) and the
    calling thread's."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime,
            "thread_cpu_s": time.thread_time()}


class _Timed:
    """Launch and dispatch counts summed over the timed sections: each
    ``with timed:`` block adds what ran inside it. ``host`` sums what the
    host did meanwhile: wall seconds, CPU seconds of this process and of
    the thread that drives the engine, and the garbage collector's passes
    and seconds (the step is host-bound, so these say what a run's rate
    met: a thread kept off its core reads less CPU than wall)."""

    def __init__(self, eng):
        self.eng = eng
        self.launches = {k: 0 for k in launch_counts()}
        self.compiles = 0
        self.steps = {k: 0 for k in _STEP_KEYS}
        self.host = {"wall_s": 0.0, "cpu_s": 0.0, "thread_cpu_s": 0.0, "gc_collections": 0, "gc_s": 0.0}
        self._gc_t0 = None

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.host["gc_collections"] += 1
            self.host["gc_s"] += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def _variants(self) -> int:
        return sum(site._cache_size() for site in self.eng.graphs.sites)

    def __enter__(self):
        self._c0 = self._variants()
        self._l0 = launch_counts()
        self._s0 = {k: self.eng.stats[k] for k in _STEP_KEYS}
        gc.callbacks.append(self._gc)
        self._h0 = _host_counters()
        return self

    def __exit__(self, *exc):
        for k, v in _host_counters().items():
            self.host[k] += v - self._h0[k]
        gc.callbacks.remove(self._gc)
        for k, v in launch_counts().items():
            self.launches[k] += v - self._l0[k]
        self.compiles += self._variants() - self._c0
        for k in _STEP_KEYS:
            self.steps[k] += self.eng.stats[k] - self._s0[k]
        return False

    def host_counters(self) -> dict:
        return {k: v if isinstance(v, int) else round(v, 4) for k, v in self.host.items()}

    def kernel_launches(self) -> dict:
        lc = self.launches
        return {
            "flash_fwd": lc["flash_fwd"],
            "flash_fwd_mla": lc["flash_fwd_mla"],
            "flash_decode": lc["flash_decode"],
            "flash_decode_by_variant": {
                k[len("flash_decode_"):]: v for k, v in lc.items() if k.startswith("flash_decode_")
            },
            "w8_matmul": lc["w8_matmul"],
            "w8_matmul_by_form": {k[len("w8_matmul_"):]: v for k, v in lc.items() if k.startswith("w8_matmul_")},
        }


def _drive_burst(eng, prompts, gen_len):
    """Admit every prompt at once (concurrent arrival), then drive
    prefill waves and decode interleaved to completion: the scheduler's
    tick pattern, minus HTTP."""
    slots = [eng.start_request(list(p), GenParams(max_new_tokens=gen_len)) for p in prompts]
    while eng.prefilling_slots() or any(eng.active[s] for s in slots):
        if eng.prefilling_slots():
            eng.prefill_wave()
        if any(eng.active[s] for s in slots):
            eng.step()
    for s in slots:
        eng.release(s)


def _concurrent_arrival_bench(eng, rng, vocab, burst, prompt_len, gen_len, timed):
    """Burst TTFT and prefill-dispatch accounting → result dict. The SAME
    burst runs twice, packed (the engine's prefill_pack) and serial
    (prefill_pack 0), so one line shows the dispatch reduction and the
    TTFT under load it buys. ``timed`` sums the measured bursts' counts."""
    ttft_hist = eng.metrics.family("dtpu_serve_ttft_seconds")
    disp = eng.metrics.family("dtpu_serve_prefill_dispatches_total")
    prompts = token_prompts(rng, vocab, burst, prompt_len)
    pack = eng.prefill_pack

    def measure():
        eng.reset_prefix_cache()  # identical-length bursts must not hit
        ttft_hist.clear()
        d0 = disp.value()
        with timed:
            _drive_burst(eng, prompts, gen_len)
        return {
            "ttft_ms_p50": round((ttft_hist.quantile(0.5) or 0.0) * 1e3, 1),
            "ttft_ms_p95": round((ttft_hist.quantile(0.95) or 0.0) * 1e3, 1),
            "prefill_dispatches": int(disp.value() - d0),
        }

    # both paths once outside the measured bursts (first use of each shape)
    _drive_burst(eng, prompts, 2)
    eng.prefill_pack = 0
    _drive_burst(eng, prompts, 2)
    eng.prefill_pack = pack
    packed = measure()
    eng.prefill_pack = 0
    serial = measure()
    eng.prefill_pack = pack
    return {
        "burst": burst,
        "prefill_pack": pack,
        "packed": packed,
        "serial": serial,
        "dispatch_ratio": round(
            serial["prefill_dispatches"] / max(packed["prefill_dispatches"], 1), 2
        ),
    }


def run_bench(
    model: str = "llama-tiny",
    batch: int = 4,
    max_seq: int = 1024,
    prompt_len: int = 256,
    gen_len: int = 64,
    spec_draft: int = 0,
    repetitive: bool = False,
    quantize=None,
    turbo_steps: int = 8,
    turbo_depth: int = 1,
    kv_quant=None,
    prefill_chunk: int = 256,
    prefill_pack: int = 4,
    arrival_burst: int = 0,  # 0 = off; else the concurrent-arrival burst's size
    decode_kernel=None,  # None (K4 where it takes the model) | "flash" | "einsum"
    device="cuda",
    graphs: bool = True,  # False: the eager engine on the card (the reference)
) -> dict:
    """Measure the engine directly → result dict (the importable core)."""
    dev = resolve_device(device)
    config = llama.CONFIGS[model]
    if arrival_burst and arrival_burst > batch:
        raise ValueError(
            f"--arrival-burst {arrival_burst} needs --batch >= burst "
            f"(got {batch}): the burst is admitted all at once"
        )
    if dev.type == "cuda":
        cuda_build.build_all()  # a no-op where the libraries exist
    if quantize == "int8" and dev.type == "cpu":
        params = quant.random_quantized_params(config)
    elif quantize == "int8":
        params = quant.random_quantized_params_on_device(config, device=dev)
    else:
        params = llama.init_params(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    if decode_kernel is None and not (config.mla or flash_decode.flash_decode_supported(config, max_seq)):
        decode_kernel = "einsum"  # K4 has no form for this head width
    eng = InferenceEngine(
        config, params, max_batch=batch, max_seq=max_seq,
        spec_draft=spec_draft, turbo_steps=turbo_steps,
        turbo_depth=turbo_depth, kv_quant=kv_quant,
        prefill_chunk=prefill_chunk, prefill_pack=prefill_pack,
        decode_kernel=decode_kernel, device=dev, graphs=graphs,
    )
    rng = np.random.default_rng(0)
    if repetitive:
        prompts = repetitive_prompts(rng, config.vocab_size, batch, prompt_len)
    else:
        prompts = token_prompts(rng, config.vocab_size, batch, prompt_len)

    # warmup, outside every timed section, of what the timed sections run
    # first: the kernels' first launches (their modules load lazily), and
    # cuBLAS's first call at each shape: the full-length prompt's prefill
    # chunks, the decode path at the SAME generation length (the turbo
    # macro-step is capped to power-of-two step counts, so a shorter
    # warmup would leave the longer ones unrun), and with --spec-draft
    # the speculative verify step
    spec = eng.spec_draft
    eng.spec_draft = 0  # the plain/turbo decode
    slot, _ = eng.add_request(list(prompts[0]), GenParams(max_new_tokens=gen_len))
    while eng.active[slot]:
        eng.step()
    eng.release(slot)
    # each smaller power-of-two turbo variant (a budget of s + 1 picks
    # steps = s): a verify's uneven advance leaves such budgets, and on
    # the card each variant's first call captures its graph
    s = turbo_steps // 2
    while s >= 1:
        slot, _ = eng.add_request(list(prompts[0][:16]), GenParams(max_new_tokens=s + 1))
        while eng.active[slot]:
            eng.step()
        eng.release(slot)
        s //= 2
    eng.spec_draft = spec
    if spec:
        phrase = prompts[0][:16]
        warm = (phrase * (prompt_len // 16 + 1))[:prompt_len]
        spec_steps = eng.stats["spec_steps"]
        slot, _ = eng.add_request(warm, GenParams(max_new_tokens=6))
        while eng.active[slot]:
            eng.step()  # repetition drafts → verify
        eng.release(slot)
        if eng.stats["spec_steps"] == spec_steps:
            eng.warm_verify()  # the model drafted nothing: verify once all the same

    # cold TTFT must stay cold: the warmup request registered its prompt
    # for prefix reuse (repetitive mode's identical prompts would hit it)
    eng.reset_prefix_cache()

    # the timed sections read the ENGINE's registry, the series /metrics
    # renders; the warmup's observations are dropped first
    ttft_hist = eng.metrics.family("dtpu_serve_ttft_seconds")
    step_hist = eng.metrics.family("dtpu_serve_decode_step_seconds")
    tok_counter = eng.metrics.family("dtpu_serve_tokens_generated_total")
    ttft_hist.clear()
    timed = _Timed(eng)

    with timed:
        # TTFT: admission → first sampled token, per request (chunked
        # prefill), observed inside the engine at slot activation
        slots = []
        for prompt in prompts:
            # per-admission clear: in repetitive mode requests 2..N would
            # otherwise prefix-hit against request 1's registration
            eng.reset_prefix_cache()
            slot, _ = eng.add_request(prompt, GenParams(max_new_tokens=gen_len))
            slots.append(slot)
        assert ttft_hist.count() == len(prompts)

        # decode throughput across all concurrent slots: tokens over the
        # engine's step seconds, both from the registry
        tokens0, secs0 = tok_counter.value(), step_hist.sum()
        t0 = time.perf_counter()
        steps = 0
        while any(eng.active[s] for s in slots):
            eng.step()
            steps += 1
        dt = time.perf_counter() - t0
        tokens = int(tok_counter.value() - tokens0)
        step_secs = step_hist.sum() - secs0
    for s in slots:
        eng.release(s)
    # the quantiles NOW: the prefix section below admits more requests
    ttft_ms_p50 = round((ttft_hist.quantile(0.5) or 0.0) * 1e3, 1)
    ttft_ms_p99 = round((ttft_hist.quantile(0.99) or 0.0) * 1e3, 1)

    # prefix-cache TTFT: a request sharing a long prefix with a served one
    # skips the shared chunks (a chunk-aligned copy of cache rows); the
    # pair is 2x prompt_len so that at least one chunk is reusable
    C = eng.prefill_chunk
    # mirror start_request's tail truncation (max_new_tokens=2 here)
    plen2 = min(2 * prompt_len, max_seq - 3)
    long_prompt = rng.integers(1, config.vocab_size, plen2).tolist()
    follow = long_prompt[:-8] + rng.integers(1, config.vocab_size, 8).tolist()
    reuse = min(plen2 - 8, len(follow) - 1) // C * C
    ttft_prefix_ms = ttft_long_cold_ms = None
    # batch 1 cannot prefix-hit: the only slot is also the source
    if reuse >= C and batch >= 2:
        # the prefill chunks past prompt_len, once outside the timed window
        warm = rng.integers(1, config.vocab_size, plen2).tolist()
        slot, _ = eng.add_request(warm, GenParams(max_new_tokens=2))
        while eng.active[slot]:
            eng.step()
        eng.release(slot)
        eng.reset_prefix_cache()
        ttft_hist.clear()  # the single cold sample IS the number
        with timed:
            slot, _ = eng.add_request(long_prompt, GenParams(max_new_tokens=2))
            ttft_long_cold_ms = round((ttft_hist.quantile(0.5) or 0.0) * 1e3, 1)
            while eng.active[slot]:
                eng.step()
        eng.release(slot)
        # the row copy's site once outside the timed window (slot 0 onto
        # itself changes nothing)
        zero = eng.slot_index(0)
        eng.get_copy_fn(reuse)(zero, zero)
        hits0 = eng.stats["prefix_hits"]
        ttft_hist.clear()
        with timed:
            slot, _ = eng.add_request(follow, GenParams(max_new_tokens=2))
            ttft_prefix_ms = round((ttft_hist.quantile(0.5) or 0.0) * 1e3, 1)
            assert eng.stats["prefix_hits"] == hits0 + 1, "expected a prefix hit"
            while eng.active[slot]:
                eng.step()
        eng.release(slot)

    # concurrent arrival: an N-prompt burst through the packed prefill
    # wave against serial per-prompt prefill, from the engine's registry
    concurrent = None
    if arrival_burst:
        concurrent = _concurrent_arrival_bench(
            eng, rng, config.vocab_size, arrival_burst, prompt_len, gen_len, timed
        )

    backend = backend_info(dev)
    return {
        "metric": f"serve_decode_tokens_per_sec[{model},batch={batch}]",
        # engine-step time, not the bench loop's wall clock: the number a
        # /metrics scrape of a server derives
        "value": round(tokens / max(step_secs, 1e-9), 1),
        "unit": "tokens/s",
        "extra": {
            "ttft_ms_p50": ttft_ms_p50,
            "ttft_ms_p99": ttft_ms_p99,
            "wall_tokens_per_sec": round(tokens / max(dt, 1e-9), 1),
            # 2x-length prompt pair: cold full prefill against a prefix hit
            "ttft_long_cold_ms": ttft_long_cold_ms,
            "ttft_prefix_hit_ms": ttft_prefix_ms,
            "prefix_reuse_tokens": reuse if reuse >= C else 0,
            "decode_steps": steps,
            "tokens": tokens,
            "tokens_per_step": round(tokens / max(steps, 1), 2),
            "concurrent": concurrent,
            # the engine's EFFECTIVE pack width (power-of-two floored,
            # capped at batch), not the raw argument
            "prefill_pack": eng.prefill_pack,
            "spec_draft": spec_draft,
            "turbo_steps": turbo_steps,
            "turbo_depth": turbo_depth,
            "quantize": quantize,
            "kv_quant": kv_quant,
            "decode_kernel": eng.decode_kernel,
            "kernel_launches": timed.kernel_launches(),
            "timed_steps": dict(timed.steps),
            "host": timed.host_counters(),
            "graphs": eng.graphs.capture,
            "graph_sites": eng.graphs.report(),
            "timed_compiles": timed.compiles,
            **backend,
        },
    }


# the JAX bench's --sessions mode and its flags: routing/ comes with A4
_SESSION_FLAGS = ("sessions", "replicas", "turns", "tenants", "turn_chars")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dstack_tpu_torch.serve.bench")
    p.add_argument("--model", default="llama-tiny")
    p.add_argument("--batch", type=int, default=4, help="concurrent slots")
    p.add_argument("--max-seq", type=int, default=1024)
    p.add_argument("--prompt-len", type=int, default=256)
    p.add_argument("--gen-len", type=int, default=64)
    p.add_argument("--spec-draft", type=int, default=0)
    p.add_argument(
        "--repetitive", action="store_true",
        help="tile a short phrase as the prompt (the repetition where "
             "prompt-lookup speculation pays off); random prompts measure "
             "the no-speculation floor",
    )
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight-only int8: a random int8 tree, drawn on the card "
                        "(on the host with --device cpu)")
    p.add_argument("--kv-quant", default=None, choices=["int8"],
                   help="int8 KV cache (half the cache bytes a decode step reads)")
    p.add_argument("--turbo-steps", type=int, default=8,
                   help="device-side decode steps per host round trip (0/1 = per token)")
    p.add_argument("--turbo-depth", type=int, default=1,
                   help="macro-steps chained per host round trip")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="prefill chunk length (prefix reuse is chunk-granular)")
    p.add_argument("--prefill-pack", type=int, default=4,
                   help="max prompt chunks packed into one prefill dispatch "
                        "(0/1 = serial per-prompt prefill)")
    p.add_argument(
        "--arrival-burst", type=int, default=0,
        help="admit this many prompts at once and report packed-vs-serial "
             "prefill dispatches and TTFT p50/p95 under load (needs --batch >= burst)",
    )
    p.add_argument(
        "--decode-kernel", default=None, choices=["einsum", "flash"],
        help="decode attention: the ragged flash-decode kernel (the default "
             "where it takes the model) or the plain masked attention",
    )
    for flag in _SESSION_FLAGS:
        p.add_argument("--" + flag.replace("_", "-"), type=int, default=None,
                       help="--sessions mode: not ported yet (ROADMAP A4)")
    p.add_argument("--output", default=None, help="also write the result JSON to this file")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if any(getattr(args, f) for f in _SESSION_FLAGS):
        p.error("not ported yet: --sessions (and --replicas/--turns/--tenants/"
                "--turn-chars) routes sessions across replicas, which needs "
                "routing/ (ROADMAP A4)")

    result = run_bench(
        model=args.model,
        batch=args.batch,
        max_seq=args.max_seq,
        prompt_len=args.prompt_len,
        gen_len=args.gen_len,
        spec_draft=args.spec_draft,
        repetitive=args.repetitive,
        quantize=args.quantize,
        turbo_steps=args.turbo_steps,
        turbo_depth=args.turbo_depth,
        kv_quant=args.kv_quant,
        decode_kernel=args.decode_kernel,
        prefill_chunk=args.prefill_chunk,
        prefill_pack=args.prefill_pack,
        arrival_burst=args.arrival_burst,
        device=args.device,
    )
    line = json.dumps(result)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
