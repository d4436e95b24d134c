"""Time W8 (``csrc/w8_matmul.cu``) under the plan ``w8_plan`` picks and
under its neighbours, on one NVIDIA GPU: the measurements behind the
plan's constants (``STREAM_MAX_M``, the minimum k tiles a split, one wave
of blocks, the chunk form's 128-column tiles with paired k tiles).

    python3 tools/torch_w8_plans.py

For each shape of ``chip_smoke.W8_PROJ_SHAPES``, ``W8_HEAD_SHAPES`` and
``W8_EXPERT_SHAPES``, and llama-3-70b's w_gate at M = 16 and 17 (the two
sides of the form threshold), it prints one JSON line with the card's
name and power limit: the time of each plan (``chip_smoke.time_ms``: CUDA
events, L2 flushed), each output first held to ``w8_matmul_plain`` by
chip_smoke.py's element-wise rule. The plans: ``w8_plan``'s; one split,
half and twice its splits; in the chunk form the other tile width (128
or 256 columns); up to M = 64 the other form.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from dstack_tpu_torch.ops import cuda_build, w8_matmul  # noqa: E402

EDGE_SHAPES = (("w_gate", 16, 8192, 28672), ("w_gate", 17, 8192, 28672))


def run(form: str, x, q, s, e: int, m: int, k: int, n: int, plan) -> torch.Tensor:
    """One launch of the kernel's entry under ``plan`` (rows, cols,
    splits, per) → [E, M, N]."""
    head = form == "head"
    out = torch.empty(e, m, n, dtype=torch.float32 if head else torch.bfloat16, device="cuda")
    ws = torch.empty(plan[2] * e * m * n, dtype=torch.float32, device="cuda") if plan[2] > 1 else None
    err = w8_matmul._lib().dtpu_w8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
        e, m, k, n, *plan, 1 if head else 0, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, f"w8_matmul {form} under {plan}")
    return out


def plans(e: int, m: int, k: int, n: int, sms: int) -> dict:
    """``w8_plan``'s plan and its neighbours, by label."""
    ktiles = -(-k // w8_matmul.BK)
    chosen = w8_matmul.w8_plan(e, m, k, n, sms)

    def split(rows, cols, splits):
        per = -(-ktiles // splits)
        return w8_matmul.W8Plan(rows, cols, -(-ktiles // per), per)

    out = {"plan": chosen}
    for splits in (1, chosen.splits // 2, 2 * chosen.splits):
        if 1 <= splits <= ktiles and splits != chosen.splits:
            other = split(chosen.rows, chosen.cols, splits)
            out[f"splits={other.splits}"] = other
    if chosen.rows == w8_matmul.CHUNK_ROWS:
        cols = w8_matmul.CHUNK_BN if chosen.cols != w8_matmul.CHUNK_BN else w8_matmul.CHUNK_BN // 2
        out[f"cols={cols}"] = split(chosen.rows, cols, chosen.splits)
    if m <= 64:
        rows = w8_matmul.STREAM_ROWS if chosen.rows == w8_matmul.CHUNK_ROWS else w8_matmul.CHUNK_ROWS
        out[f"rows={rows}"] = split(rows, w8_matmul.CHUNK_BN, 1)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w8_plans: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    cuda_build.build_all(("w8_matmul",))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(8)
    for form, shapes in (("proj", chip_smoke.W8_PROJ_SHAPES + EDGE_SHAPES), ("head", chip_smoke.W8_HEAD_SHAPES),
                         ("experts", chip_smoke.W8_EXPERT_SHAPES)):
        for what, *dims in shapes:
            *es, m, k, n = dims
            e = es[0] if es else 1
            q = torch.randint(-127, 128, (e, k, n), generator=g, device="cuda", dtype=torch.int8)
            s = (0.8 + 0.4 * torch.rand(e, n, generator=g, device="cuda")) * (0.02 / 127)
            x = torch.randn(e, m, k, generator=g, device="cuda").bfloat16()
            want = (w8_matmul.w8_matmul_plain(x[0], q[0], s[0], form)[None] if form != "experts"
                    else w8_matmul.w8_matmul_plain(x, q, s, form))
            ms = {}
            for label, plan in plans(e, m, k, n, sms).items():
                got = run(form, x, q, s, e, m, k, n, plan)
                torch.cuda.synchronize()
                chip_smoke.assert_close(got, want, f"w8 {form} {what} M={m} under {label} {tuple(plan)}")
                ms[label] = {"plan": list(plan), "ms": chip_smoke.time_ms(lambda: run(form, x, q, s, e, m, k, n, plan))}
            b_ms, b_by = chip_smoke.w8_bound(form, e, m, k, n)
            print(json.dumps({"card": card, "w8": form, "what": what, "E": e, "M": m, "K": k, "N": n,
                              "bound_ms": b_ms, "bound_by": b_by, "plans": ms}), flush=True)
            del q, s, x, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
