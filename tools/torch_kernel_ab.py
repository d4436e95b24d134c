"""A/B the port's flash kernels K1 (forward), K2 and K3 (backward) against
another build of the same sources, in turns on one NVIDIA GPU, and the
full fine-tune step with each.

    python3 tools/torch_kernel_ab.py --other DIR [--sources flash_fwd,flash_bwd_dq,flash_bwd_dkv]
    python3 tools/torch_kernel_ab.py --other DIR --sources flash_fwd_mla
    python3 tools/torch_kernel_ab.py --other DIR --sources w8_matmul

``DIR`` holds the other version of each source named by ``--sources``
(default: ``flash_bwd_dq`` and ``flash_bwd_dkv``) with the headers they
include, for example the parent commit's sources unpacked into a
directory ``.gitignore`` lists:

    git archive <commit> dstack_tpu_torch/csrc | tar -x -C build/other --strip-components=2

Each of those launchers keeps its C signature from build to build, so
swapping the loaded libraries swaps the kernels under the same Python
wrappers. K4 (``flash_decode``) swaps so only with a build whose
split-K entry point takes the grid plan and the f32 workspaces, as this
tree's does. K1's D = 576 form (``flash_fwd_mla``) changed its entry
between builds, and its exported name with it, so the other build's
entry is read from the symbol it exports: ``dtpu_flash_mla(q, row,
...)``, this tree's, is called through ``flash.flash_mla_with_lse`` with
the library swapped under it; the older ``dtpu_flash_fwd_mla(q, k, v,
...)`` with v the row with its rope columns zeroed and its o 576 wide.
W8's entry (``dtpu_w8_matmul``) changed its plan arguments: a build that
exports ``dtpu_w8_arrivals`` (the fused combine's counters) is this
tree's (rows, cols, splits, per) and is called through the wrappers with
the library swapped under them; PR 18's takes (M-tiles, splits, per) and
launches a second kernel for the combine, and is called through its own
entry under the plan this tool reproduces (``pr18_w8_plan``). Prints one
JSON line per measurement, each with the card's name and power limit:

1. each selected training kernel's ms (``chip_smoke.time_ms``: CUDA
   events, L2 flushed) at q/dO [B,32,2048,64] over k/v [B,8,2048,64],
   causal, for B = 4 and 8, in the order other, this, this, other;
2. with ``flash_decode``: K4's bf16 and int8, decode and verify forms at
   D = 64 and 128 over an [8,8,2048,D] cache at chip_smoke.py's
   positions 0..2047, with window 0 and 128, without sinks (G 4: q
   [8,8,4,D], verify q [8,8,20,D]) and with sinks from N(0, 1) (G 8 as
   gpt-oss: q [8,8,8,D], verify q [8,8,40,D]), each checked against its
   plain version and timed in the same order;
3. with ``flash_fwd_mla``: q [1,16,C,576] over a latent row
   [1,1,2048,576] at ``chip_smoke.MLA_SHAPES``, each build's o (sliced to
   512) and lse held to the plain version by both of chip_smoke.py's
   rules, then timed in the order other, this, this, other, beside the
   bound and this build's NSPLIT;
4. with ``w8_matmul``: W8 at every shape of ``chip_smoke.W8_PROJ_SHAPES``,
   ``W8_HEAD_SHAPES`` and ``W8_EXPERT_SHAPES`` (random int8 weights and
   scales as chip_smoke.py draws them), each build held to
   ``w8_matmul_plain`` by both of chip_smoke.py's rules and rerun
   bit-identical, then timed in the order other, this, this, other beside
   the bound and each build's plan;
5. with a training kernel: the full fine-tune step of llama-3.2-1b at
   batch 8 x 2048 (random weights from seed 0; host clock around each
   step, synchronised): 4 steps a turn in the order other, this, this,
   other, other, this; the median, tokens/s and MFU (``flops_per_token``
   over 989 TFLOP/s) of each.
"""

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from dstack_tpu_torch.models import llama  # noqa: E402
from dstack_tpu_torch.ops import cuda_build, flash, flash_decode, w8_matmul  # noqa: E402
from dstack_tpu_torch.serve import engine  # noqa: E402
from dstack_tpu_torch.train import step as train_step  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode", "flash_fwd_mla", "w8_matmul")
SWAPPED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode")  # launchers alike in both builds
TRAINING = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
KERNEL_TURNS = ("other", "this", "this", "other")
STEP_TURNS = ("other", "this", "this", "other", "other", "this")
STEPS_A_TURN = 4


def build_other(src: Path, names) -> dict:
    """nvcc each named source of ``src`` with the port's flags → {name: CDLL};
    ptxas's report beside each library as ``<name>.ptxas.log``."""
    libs, procs = {}, {}
    for name in names:
        out = src / f"{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(out), str(src / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src / name}.cu failed:\n{log}")
        (src / f"{name}.ptxas.log").write_text(log)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def decode_ab(card: str, use) -> None:
    """K4's four forms at D = 64 and 128 with each build (section 2)."""
    b, hkv, t = 8, 8, 2048
    pos = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2047], dtype=torch.int32, device="cuda")
    pos_v = torch.tensor([0, 40, 200, 300, 700, 1024, 1500, 2043], dtype=torch.int32, device="cuda")
    s_rows = chip_smoke.SPEC_ROWS
    for d in (64, 128):
        g = torch.Generator(device="cuda").manual_seed(4)
        kc, vc = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        int8 = (*engine.kv_quantize(kc), *engine.kv_quantize(vc))
        for (form, rows, quant), window, sinks in itertools.product(
            (("bf16_decode", 1, False), ("bf16_verify", s_rows, False),
             ("int8_decode", 1, True), ("int8_verify", s_rows, True)), (0, 128), (False, True)):
            grp = 8 if sinks else 4
            q = torch.randn(b, hkv, grp * rows, d, generator=g, device="cuda").bfloat16()
            k, v = (int8[0], int8[2]) if quant else (kc, vc)
            kw = dict(scale=d**-0.5, rows_per_slot=rows, window=window)
            if quant:
                kw.update(k_scale=int8[1], v_scale=int8[3])
            if sinks:
                kw["sinks"] = torch.randn(hkv, grp * rows, generator=g, device="cuda")
            p = pos_v if rows > 1 else pos
            want = flash_decode.flash_decode_plain(q, k, v, p, **kw)
            ms: dict = {}
            for tag in KERNEL_TURNS:
                use(tag)
                chip_smoke.assert_close(flash_decode.flash_decode(q, k, v, p, **kw), want,
                                        f"{tag} {form} D={d} window={window} sinks={sinks}")
                ms.setdefault(tag, []).append(chip_smoke.time_ms(lambda: flash_decode.flash_decode(q, k, v, p, **kw)))
            print(json.dumps({"card": card, "flash_decode": form, "window": window, "sinks": sinks,
                              "q": list(q.shape), "cache": list(k.shape), "ms": ms}), flush=True)


def mla_ab(card: str, other: ctypes.CDLL) -> None:
    """K1's D = 576 form of each build at chip_smoke's MLA shapes
    (section 3), each build called through the entry it exports."""
    c = llama.CONFIGS[chip_smoke.DEEPSEEK]
    h, rank, t = c.n_heads, c.kv_lora_rank, 2048
    d, scale = rank + c.qk_rope_head_dim, c.attention_scale
    this = cuda_build.load("flash_fwd_mla")
    takes_row = hasattr(other, "dtpu_flash_mla")
    fn = None if takes_row else other.dtpu_flash_fwd_mla
    if fn is not None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + flash._SHAPE_ARGS
    g = torch.Generator(device="cuda").manual_seed(8)
    row = torch.randn(1, 1, t, d, generator=g, device="cuda").bfloat16()
    value = flash.mla_value(row, rank)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for chunk, q_offset in chip_smoke.MLA_SHAPES:
        q = torch.randn(1, h, chunk, d, generator=g, device="cuda").bfloat16()
        o_other = torch.empty_like(q)
        lse_other = torch.empty(1, h, chunk, dtype=torch.float32, device="cuda")
        kw = dict(rank=rank, scale=scale, q_offset=q_offset)

        def run_other():
            if takes_row:
                cuda_build._libs["flash_fwd_mla"] = other
                try:
                    return flash.flash_mla_with_lse(q, row, **kw)
                finally:
                    cuda_build._libs["flash_fwd_mla"] = this
            err = fn(q.data_ptr(), row.data_ptr(), value.data_ptr(), o_other.data_ptr(), lse_other.data_ptr(),
                     *flash._shape_args(q, row, scale, True, q_offset, 0, 0, 0.0))
            cuda_build.check(err, "other flash_fwd_mla")
            return o_other[..., :rank], lse_other

        calls = {"other": run_other, "this": lambda: flash.flash_mla_with_lse(q, row, **kw)}
        po, plse = flash.flash_mla_plain(q, row, **kw)
        for tag, call in calls.items():
            o, lse = call()
            torch.cuda.synchronize()
            chip_smoke.grad_close(o, po, f"{tag} flash_fwd_mla C={chunk} q_offset={q_offset}")
            chip_smoke.assert_close(lse, plse, f"{tag} flash_fwd_mla C={chunk} q_offset={q_offset} lse")
        ms: dict = {}
        for tag in KERNEL_TURNS:
            ms.setdefault(tag, []).append(chip_smoke.time_ms(calls[tag]))
        b_ms, b_by = chip_smoke.mla_bound(h, chunk, q_offset, d, rank)
        print(json.dumps({"card": card, "flash_fwd_mla": {"q": list(q.shape), "q_offset": q_offset},
                          "other_entry": "dtpu_flash_mla" if takes_row else "dtpu_flash_fwd_mla",
                          "nsplit": flash.mla_plan(1, h, chunk, t, q_offset, sms), "ms": ms,
                          "bound_ms": b_ms, "bound_by": b_by}), flush=True)


def pr18_w8_plan(e: int, m: int, k: int, n: int, sms: int) -> tuple:
    """PR 18's W8 grid (its ``ops/w8_matmul.py`` ``w8_plan``) → (mtiles,
    splits, ktiles_per_split): one M-tile of 16 rows a block when M <= 16,
    else four; where the grid has fewer blocks than the SMs, splits of the
    64-row K tiles for about 2 blocks an SM, at least 4 tiles a split."""
    mtiles = 1 if m <= 16 else 4
    blocks = -(-m // (16 * mtiles)) * -(-n // 128) * e
    ktiles = -(-k // 64)
    splits = 1
    if blocks < sms:
        splits = max(1, min(ktiles // 4, -(-2 * sms // blocks), 65535 // e))
    per = -(-ktiles // splits)
    return mtiles, -(-ktiles // per), per


def w8_ab(card: str, other: ctypes.CDLL) -> None:
    """W8 of each build at chip_smoke.py's shapes (section 4)."""
    this = cuda_build.load("w8_matmul")
    takes_rows = hasattr(other, "dtpu_w8_arrivals")
    entry = other.dtpu_w8_matmul
    if not takes_rows:  # PR 18's entry: x q s out ws, E M K N mtiles splits per epilogue, stream
        entry.restype = ctypes.c_int
        entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wrappers = {"proj": w8_matmul.w8_proj, "head": w8_matmul.w8_head, "experts": w8_matmul.w8_experts}
    g = torch.Generator(device="cuda").manual_seed(8)
    for form, shapes in (("proj", chip_smoke.W8_PROJ_SHAPES), ("head", chip_smoke.W8_HEAD_SHAPES),
                         ("experts", chip_smoke.W8_EXPERT_SHAPES)):
        fn = wrappers[form]
        for what, *dims in shapes:
            *es, m, k, n = dims
            e = es[0] if es else 1
            q = torch.randint(-127, 128, (*es, k, n), generator=g, device="cuda", dtype=torch.int8)
            s = (0.8 + 0.4 * torch.rand(*es, n, generator=g, device="cuda")) * (0.02 / 127)
            x = torch.randn(*es, m, k, generator=g, device="cuda").bfloat16()
            plan = pr18_w8_plan(e, m, k, n, sms)

            def run_other():
                if takes_rows:
                    cuda_build._libs["w8_matmul"] = other
                    try:
                        return fn(x, q, s)
                    finally:
                        cuda_build._libs["w8_matmul"] = this
                out = torch.empty(e, m, n, dtype=torch.float32 if form == "head" else torch.bfloat16, device="cuda")
                ws = torch.empty(plan[1] * e * m * n, dtype=torch.float32, device="cuda") if plan[1] > 1 else None
                err = entry(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                            ws.data_ptr() if ws is not None else None, e, m, k, n, *plan,
                            1 if form == "head" else 0, torch.cuda.current_stream().cuda_stream)
                cuda_build.check(err, "other w8_matmul")
                return out if es else out[0]

            calls = {"other": run_other, "this": lambda: fn(x, q, s)}
            want = w8_matmul.w8_matmul_plain(x, q, s, form)
            for tag, call in calls.items():
                got, again = call(), call()
                torch.cuda.synchronize()
                label = f"{tag} w8 {form} {what} E={e} M={m} K={k} N={n}"
                chip_smoke.assert_close(got, want, label)
                g3, w3 = (got, want) if got.dim() == 3 else (got[None], want[None])
                rms = chip_smoke.tile_rel_rms(g3[:, None].float(), w3[:, None].float())
                if not rms <= chip_smoke.GRAD_RMS_TOL:
                    raise AssertionError(f"{label}: a tile's relative RMS error {rms:.4g}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{label}: two launches differ")
            ms: dict = {}
            for tag in KERNEL_TURNS:
                ms.setdefault(tag, []).append(chip_smoke.time_ms(calls[tag]))
            b_ms, b_by = chip_smoke.w8_bound(form, e, m, k, n)
            print(json.dumps({"card": card, "w8": form, "what": what, "E": e, "M": m, "K": k, "N": n,
                              "plan_this": list(w8_matmul.w8_plan(e, m, k, n, sms)),
                              "plan_other": "this tree's" if takes_rows else list(plan),
                              "ms": ms, "bound_ms": b_ms, "bound_by": b_by}), flush=True)
            del q, s, x, want
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="directory with the other sources")
    ap.add_argument("--sources", default="flash_bwd_dq,flash_bwd_dkv",
                    help=f"comma-separated sources to swap, of {','.join(SOURCES)}")
    args = ap.parse_args()
    names = tuple(args.sources.split(","))
    if not names or set(names) - set(SOURCES):
        ap.error(f"--sources takes names of {SOURCES}, got {args.sources}")
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    cuda_build.build_all(names)
    others = build_other(args.other.resolve(), names)
    swapped = [n for n in names if n in SWAPPED]
    libs = {"this": {n: cuda_build.load(n) for n in swapped}, "other": {n: others[n] for n in swapped}}

    def use(tag: str) -> None:
        cuda_build._libs.update(libs[tag])

    if "flash_fwd_mla" in names:
        mla_ab(card, others["flash_fwd_mla"])
    if "w8_matmul" in names:
        w8_ab(card, others["w8_matmul"])
    if "flash_decode" in names:
        decode_ab(card, use)
    train = [n for n in names if n in TRAINING]
    if not train:
        return 0
    h, hkv, t, d = 32, 8, 2048, 64
    for b in (4, 8):
        g = torch.Generator(device="cuda").manual_seed(2)
        q, do = (torch.randn(b, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        o, lse = flash.flash_attention_with_lse(q, k, v)
        delta = flash.bwd_delta(o, do)
        calls = {
            "flash_fwd": lambda: flash.flash_attention_with_lse(q, k, v),
            "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta),
            "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta),
        }
        ms: dict = {}
        for tag in KERNEL_TURNS:
            use(tag)
            ms.setdefault(tag, []).append({n: chip_smoke.time_ms(calls[n]) for n in train})
        print(json.dumps({"card": card, "kernels_ms": ms, "q": [b, h, t, d], "kv": [b, hkv, t, d]}), flush=True)
        del q, do, k, v, o, lse, delta
    torch.cuda.empty_cache()

    c = llama.CONFIGS["llama-3.2-1b"]
    opt = train_step.default_optimizer(lr=2e-4, decay_steps=10)
    state = train_step.init_train_state(c, opt, seed=0, device="cuda")
    fn = train_step.make_train_step(c, opt)
    g = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, c.vocab_size, (8, 2048), generator=g, device="cuda")
    mask = torch.ones_like(tok)
    mask[:, -1] = 0
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, dims=1), "mask": mask}
    for _ in range(2):  # CUDA and cuBLAS start-up
        fn(state, batch)
    times: dict = {}
    for tag in STEP_TURNS:
        use(tag)
        for _ in range(STEPS_A_TURN):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state, batch)
            torch.cuda.synchronize()
            times.setdefault(tag, []).append(time.perf_counter() - t0)
    tokens = tok.numel()
    ftok = train_step.flops_per_token(c, tok.shape[1])
    steps = {}
    for tag, ts in times.items():
        med = statistics.median(ts)
        steps[tag] = {"median_step_s": med, "tokens_per_s": tokens / med,
                      "mfu": ftok * tokens / med / chip_smoke.PEAK_BF16_FLOPS, "step_s": ts}
    print(json.dumps({"card": card, "full_step_batch_8x2048": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
