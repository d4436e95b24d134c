"""What two ranks sharing one card can use: which gloo collectives take
CUDA tensors as they are, what NCCL says to two ranks on one device, and
the ring's kernel forms (K1-K3 non-causal at ``Tq == Tk``, and at a
``q_offset`` of one shard with a window) against their plain versions,
and how fast gloo moves host bytes between two ranks by collective (the
transport of ranks that share a card stages every CUDA tensor through
host copies).

Run on the card: ``python3 tools/torch_gloo_probe.py`` (spawns its own
ranks; prints one JSON line a part). ``--parts gloo,nccl,forms,bandwidth``
picks; ``bandwidth`` alone runs on the CPU too.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(kind: str) -> None:
    """One rank of a probe (RANK etc. in the environment)."""
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if kind == "bandwidth":  # host bytes only
        dist.init_process_group("gloo", rank=rank, world_size=world)
        print(json.dumps({"rank": rank, "bandwidth": _bandwidth(rank)}), flush=True)
        return
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if kind == "nccl":
        dist.init_process_group("nccl", rank=rank, world_size=world)
        try:
            x = torch.ones(4, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            print(json.dumps({"rank": rank, "nccl": "ran", "value": x.tolist()}), flush=True)
        except Exception as e:  # the refusal is the finding
            print(json.dumps({"rank": rank, "nccl": "refused", "error": f"{type(e).__name__}: {e}"[:2000]}),
                  flush=True)
        return
    dist.init_process_group("gloo", rank=rank, world_size=world)
    name, where = kind.split(":")[1:]
    peer = 1 - rank
    tests = {
        "all_reduce": lambda x: dist.all_reduce(x),
        "all_gather_into_tensor": lambda x: dist.all_gather_into_tensor(torch.empty(2 * x.numel(), device=x.device), x),
        "reduce_scatter_tensor": lambda x: dist.reduce_scatter_tensor(torch.empty(x.numel() // 2, device=x.device), x),
        "all_to_all_single": lambda x: dist.all_to_all_single(torch.empty_like(x), x),
        "batch_isend_irecv": lambda x: [w.wait() for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, torch.empty_like(x), peer)])],
    }
    x = torch.arange(8, dtype=torch.float32, device=dev if where == "cuda" else "cpu")
    try:
        tests[name](x)
        if where == "cuda":
            torch.cuda.synchronize()
        verdict = "ok"
    except Exception as e:
        verdict = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    print(json.dumps({"rank": rank, "collective": name, "tensor": where, "verdict": verdict}), flush=True)


BANDWIDTH_MB = 256  # host bytes a rank hands each collective


def _bandwidth(rank: int) -> dict:
    """Seconds (median of 3, after one untimed) and GB/s of a rank's
    BANDWIDTH_MB host bytes through each collective, where GB/s counts the
    bytes that cross between the two ranks each way: an all-gather's
    input, half an all-to-all's, a send's."""
    import time

    import torch.distributed as dist

    n = BANDWIDTH_MB << 20
    x = torch.ones(n, dtype=torch.uint8)
    out, half = torch.empty(2 * n, dtype=torch.uint8), torch.empty(n, dtype=torch.uint8)
    peer = 1 - rank
    parts = {
        "all_gather_into_tensor": (lambda: dist.all_gather_into_tensor(out, x), n),
        "all_to_all_single": (lambda: dist.all_to_all_single(half, x), n // 2),
        "batch_isend_irecv": (lambda: [w.wait() for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, half, peer)])], n),
        "all_reduce_f32": (lambda: dist.all_reduce(x.view(torch.float32)), n // 2),
    }
    from dstack_tpu_torch.parallel.mesh import STREAMS

    # the mesh's transport: the all-to-all cut into STREAMS parts, each on a
    # group of its own, in flight together
    groups = [dist.new_group([0, 1]) for _ in range(STREAMS)]
    cuts = [(n // 2) * j // STREAMS for j in range(STREAMS + 1)]
    sends = [x.view(2, -1)[:, lo:hi].contiguous() for lo, hi in zip(cuts, cuts[1:])]
    recvs = [torch.empty_like(t) for t in sends]

    def streamed():
        works = [dist.all_to_all_single(r, t, group=g, async_op=True) for r, t, g in zip(recvs, sends, groups)]
        for w in works:
            w.wait()

    parts[f"all_to_all_single_x{STREAMS}"] = (streamed, n // 2)
    rows = {}
    for name, (fn, crossing) in parts.items():
        fn()
        times = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        s = sorted(times)[1]
        rows[name] = {"s": s, "GB/s": crossing / s / 1e9}
    return rows


def _spawn(kind: str, timeout: float) -> list:
    port = _port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen([sys.executable, __file__, "--rank-of", kind], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + f"\n(killed after {timeout} s)")
    return outs


def forms() -> dict:
    """K1-K3 in the ring's new forms at each model's shard (T/sp = 1024)
    against the plain versions; max abs errors."""
    from dstack_tpu_torch.ops import flash

    rows = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, h, hkv, d, window, cap) in {
        "llama-3.2-1b": (8, 32, 8, 64, 0, 0.0), "deepseek-d192": (4, 16, 16, 192, 0, 0.0),
        "gemma-3-1b-w512": (8, 4, 1, 256, 512, 0.0), "gemma-2-2b-w4096-cap50": (8, 8, 4, 256, 4096, 50.0),
    }.items():
        tl = 1024
        q, do = (torch.randn(b, h, tl, d, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, hkv, tl, d, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(2))
        for form, kw in (("noncausal", dict(causal=False)),
                         ("offset", dict(causal=False, q_offset=tl, window=window))):
            if form == "offset" and not window:
                continue
            kw = dict(kw, softcap=cap)
            o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
            po, plse = flash.flash_attention_plain(q, k, v, **kw)
            grads = flash.flash_bwd(q, k, v, o, lse, do, **kw)
            pgrads = flash.flash_bwd_plain(q, k, v, po.to(q.dtype), plse, do, **kw)
            torch.cuda.synchronize()
            rows[f"{name}/{form}"] = {n: float((a.float() - r.float()).abs().max()) for n, a, r in
                                      zip(("o", "dq", "dk", "dv"), (o, *grads), (po, *pgrads))}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank-of", default=None)
    ap.add_argument("--parts", default="gloo,nccl,forms,bandwidth")
    args = ap.parse_args()
    if args.rank_of:
        _rank_main(args.rank_of)
        return 0
    parts = args.parts.split(",")
    if "gloo" in parts:  # one pair of ranks a collective: a crash costs that one only
        for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
                     "batch_isend_irecv"):
            for where in ("cuda", "cpu"):
                outs = _spawn(f"gloo:{name}:{where}", 60)
                lines = [ln for o in outs for ln in o.splitlines() if ln.startswith('{"rank"')]
                print(json.dumps({"collective": name, "tensor": where, "ranks": [json.loads(x) for x in lines],
                                  "crashed": len(lines) < 2}), flush=True)
    if "nccl" in parts:
        print("\n".join(_spawn("nccl", 90)), flush=True)
    if "bandwidth" in parts:
        outs = _spawn("bandwidth", 300)
        line = [ln for o in outs for ln in o.splitlines() if ln.startswith('{"rank": 0')]
        print(line[0] if line else "\n".join(outs), flush=True)
    if "forms" in parts:
        print(json.dumps({"forms": forms()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
