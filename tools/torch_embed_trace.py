"""Trace where a server process's first ``/v1/embeddings`` forward spends
the time that later ones do not, on one NVIDIA GPU.

    python3 tools/torch_embed_trace.py [--model llama-3.2-1b] [--tokens 100] [--out FILE]

The process stands up what ``openai_server.main`` stands up before it
listens, at the server's defaults: the kernels built, random weights
from seed 0, the engine, and the start-up warmup (``_warmup_engine``).
Then it starts ``torch.profiler`` once on a throwaway matmul (so
CUPTI's own start-up is out of the way) and runs ``embed_vectors`` on
one ``--tokens``-token input three times, each call under the profiler
(CPU and CUDA activities) with its host clock around it, synchronised.
It prints one JSON line a call: the host ms, the device ms (the sum of
the kernels' self device time), the number of kernel launches, and the
ten events whose host time is largest; then one line with the events
whose host time in the first call exceeds the second call's by the
most, and the card's name and power limit. ``--out`` writes each call's
whole ``key_averages`` table as text. Run it as
``CUDA_MODULE_LOADING=EAGER python3 tools/torch_embed_trace.py`` to load
every kernel module at start-up instead of at first use, and compare.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dstack_tpu_torch.models import llama  # noqa: E402
from dstack_tpu_torch.ops import cuda_build  # noqa: E402
from dstack_tpu_torch.serve.engine import InferenceEngine  # noqa: E402
from dstack_tpu_torch.serve.openai_server import _warmup_engine  # noqa: E402


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _host_ms(ev) -> float:
    return ev.cpu_time_total / 1e3


def _device_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return getattr(ev, name)
    return 0.0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="llama-3.2-1b", choices=sorted(llama.CONFIGS))
    p.add_argument("--tokens", type=int, default=100)
    p.add_argument("--out", default=None, help="write each call's key_averages table here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_embed_trace: CUDA is not available", file=sys.stderr)
        return 2
    card = _card()
    cuda_build.build_all()
    c = llama.CONFIGS[args.model]
    params = llama.init_params(c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = InferenceEngine(c, params, max_batch=8, max_seq=2048, seed=0, prefill_chunk=256,
                          prefill_pack=4, spec_draft=4, turbo_steps=8, turbo_depth=1, device="cuda")
    warm_s = _warmup_engine(eng)
    ids = [[(7 * i) % 95 + 32 for i in range(args.tokens)]]
    x = torch.randn(64, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ x).sum().item()

    tables, per_call = [], []
    for call in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            llama.embed_vectors(params, c, ids)
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        by_host = {e.key: _host_ms(e) for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
        per_call.append(by_host)
        tables.append(events.table(sort_by="cpu_time_total", row_limit=60))
        print(json.dumps({
            "call": call + 1, "model": args.model, "tokens": args.tokens, "host_ms": host_ms,
            "device_ms": sum(_device_us(e) for e in kernels) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "top_host_ms": sorted(by_host.items(), key=lambda kv: -kv[1])[:10],
            "card": card,
        }), flush=True)
    excess = {k: v - per_call[1].get(k, 0.0) for k, v in per_call[0].items()}
    print(json.dumps({
        "first_minus_second_host_ms": sorted(excess.items(), key=lambda kv: -kv[1])[:15],
        "warmup_s": warm_s, "CUDA_MODULE_LOADING": os.environ.get("CUDA_MODULE_LOADING"),
        "card": card,
    }), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n\n".join(f"call {i + 1}\n{t}" for i, t in enumerate(tables)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
