"""Plant faults in K3 (``csrc/flash_bwd_dkv.cu``) and check that
``chip_smoke.py``'s gradient rule (``grad_close``) refuses each one, while
this tree's build passes it. Run on one NVIDIA GPU, from the root of a
checkout:

    python3 tools/torch_bwd_fault.py

Each fault is a copy of the source with one change, written with the
headers under ``build/bwd_fault/<fault>/``, built with the port's nvcc
flags and swapped in for the loaded K3 under the same Python wrapper (as
``tools/torch_kernel_ab.py`` swaps builds):

- ``skip_tile``: at D = 256, key block 5 (keys 320..383) skips the
  second query tile of its walk: 32 query rows of one head missing from
  64 keys' dK and dV;
- ``skip_far_tile``: at D = 256, key block 0 (keys 0..63) skips the last
  query tile of its walk: the 32 query rows farthest from those keys, of
  the last head of the group, whose probabilities are the smallest;
- ``window_floor``: the window's floor three keys off: in tiles that
  straddle a mask edge, a key 1 to 3 places inside the window's far end
  is dropped.

Forms: ``chip_smoke.py``'s D = 256 forms (q/dO [4,8,2048,256] over k/v
[4,4,2048,256]: window 1024, window 0, window 4096 with softcap 50),
gemma-3-1b's micro-batch (q/dO [4,4,2048,256] over k/v [4,1,2048,256],
windows 512 and 0) and the D = 64 forms of its backward phase (q/dO
[4,32,2048,64] over k/v [4,8,2048,64], causal, and window 512 with
softcap 30). For each build and form one JSON line: dk's and dv's max
|err| against ``flash_bwd_plain``, whether the element-wise rule alone
(atol = rtol = 2e-2) passes, the worst tile's relative RMS error and
whether ``grad_close`` passes; and whether the fault changed the output.
Exits 1 if this tree's build fails ``grad_close`` anywhere, or a fault
passes it on a form whose output it changed.
"""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from dstack_tpu_torch.models import llama  # noqa: E402
from dstack_tpu_torch.ops import cuda_build, flash  # noqa: E402
from torch_kernel_ab import build_other  # noqa: E402

SOURCE = "flash_bwd_dkv"
FAULTS = {  # fault → (the text it changes, once, in the source; what it becomes)
    "skip_tile": (
        "const bool skip = kc_lo >= p.Tk ||",
        "const bool skip = (D == 256 && blockIdx.z == 5 && i == 1) || kc_lo >= p.Tk ||",
    ),
    "skip_far_tile": (
        "const bool skip = kc_lo >= p.Tk ||",
        "const bool skip = (D == 256 && blockIdx.z == 0 && i == n_items - 1) || kc_lo >= p.Tk ||",
    ),
    "window_floor": (
        "sees(p.q_offset + qc, kpos[e >> 1], p)",
        "sees(p.q_offset + qc, kpos[e >> 1], p) &&\n"
        "                           (p.window <= 0 || p.q_offset + qc - kpos[e >> 1] < p.window - 3)",
    ),
}


def fault_source(name: str) -> Path:
    """``build/bwd_fault/<name>/``: the headers and K3's source with the fault."""
    old, new = FAULTS[name]
    out = ROOT / "build" / "bwd_fault" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    text = (cuda_build.CSRC / f"{SOURCE}.cu").read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"fault {name}: {old!r} is not in {SOURCE}.cu exactly once")
    (out / f"{SOURCE}.cu").write_text(text.replace(old, new))
    return out


def forms():
    """(name, (B, H, Hkv, T, D), keyword arguments of the kernels)."""
    c3, c2, c1 = (llama.CONFIGS[m] for m in (chip_smoke.GEMMA3, chip_smoke.GEMMA2, chip_smoke.GEMMA3_1B))
    d256, d64 = chip_smoke.BWD_D256_SHAPE, chip_smoke.BWD_SHAPE
    g1b = (4, c1.n_heads, c1.n_kv_heads, 2048, c1.head_dim)
    return [
        ("d256_w1024", d256, dict(scale=c3.attention_scale, window=1024)),
        ("d256_w0", d256, dict(scale=c3.attention_scale, window=0)),
        ("d256_w4096_cap50", d256, dict(scale=c2.attention_scale, window=4096, softcap=50.0)),
        ("gemma3_1b_w512", g1b, dict(scale=c1.attention_scale, window=512)),
        ("gemma3_1b_w0", g1b, dict(scale=c1.attention_scale, window=0)),
        ("d64_causal", d64, {}),
        ("d64_w512_cap30", d64, dict(window=512, softcap=30.0)),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_fault: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    cuda_build.build_all(("flash_fwd", "flash_bwd_dq", SOURCE))
    libs = {"this": cuda_build.load(SOURCE)}
    for name in FAULTS:
        libs[name] = build_other(fault_source(name), (SOURCE,))[SOURCE]
    ok = True
    g = torch.Generator(device="cuda").manual_seed(11)
    for form, (b, h, hkv, t, d), kw in forms():
        q, do = (torch.randn(b, h, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        o, lse = flash.flash_attention_with_lse(q, k, v, **kw)
        delta = flash.bwd_delta(o, do)
        _, pdk, pdv = flash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        sound = None
        for build, lib in libs.items():
            cuda_build._libs[SOURCE] = lib
            dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            changed = sound is not None and not (torch.equal(dk, sound[0]) and torch.equal(dv, sound[1]))
            if sound is None:
                sound = (dk, dv)
            report = {"build": build, "form": form, "shape": [b, h, hkv, t, d], **kw, "changed": changed,
                      "card": card}
            passes = True
            for grad, got, want in (("dk", dk, pdk), ("dv", dv, pdv)):
                err = (got.float() - want.float()).abs()
                elementwise = bool((err <= chip_smoke.TOL + chip_smoke.TOL * want.float().abs()).all())
                rms = chip_smoke.tile_rel_rms(got, want)
                report[grad] = {"max_abs_err": err.max().item(), "elementwise_passes": elementwise,
                                "tile_rel_rms": rms}
                passes = passes and elementwise and rms <= chip_smoke.GRAD_RMS_TOL
            report["grad_close_passes"] = passes
            print(json.dumps(report), flush=True)
            if (build == "this" and not passes) or (changed and passes):
                ok = False
        cuda_build._libs[SOURCE] = libs["this"]
        del q, k, v, do, o, lse, delta, pdk, pdv, sound
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "grad_rms_tol": chip_smoke.GRAD_RMS_TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
