"""Run ``chip_smoke.py``'s training phases of the served families alone, on
one NVIDIA GPU: the quick check of the trainer's paths, without the
whole script's servers and benches.

    python3 tools/torch_train_phases.py [PART ...]

Parts (all four when none is named): ``g9`` (K1-K3 at starcoder2-7b's
training micro-batch, ``chip_smoke.d128_train_kernel_phase``), each run
of ``chip_smoke.TRAIN_RUNS`` by its name (``gptoss_lora``, ...:
``chip_smoke._finetune``, the fine-tune driver's ``main`` in this process
with that script's checks), ``opt8:<model>`` (a model of
``chip_smoke.TRAIN_OPT8`` fully fine-tuned in this process:
``chip_smoke.train_opt8_phase``),
``parity`` (``chip_smoke.grad_parity_phase`` on every model that ROADMAP
A5.7-A5.9 brought into ``GRAD_PARITY``), or ``parity:<model>`` for one
model of ``GRAD_PARITY``. The kernels are built first. Each part's log
lines are chip_smoke's; a failed part prints its traceback and the run
goes on, ending in ``== <part> ok`` or ``FAILED`` lines, the card's name
and power limit, and exit code 1 if any part failed. The fine-tune logs
are ``build/chip_smoke_train_<run>.log``.
"""

import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NEW_PARITY = ("qwen-2.5-7b", cs.GLM, cs.OLMO, "command-r-35b", "minitron-4b", cs.STARCODER2, cs.GPT_OSS,
              cs.LLAMA4)


def main(argv: list) -> int:
    parts = argv or ["g9", "gptoss_lora", f"opt8:{cs.STARCODER2}", "parity"]
    card = cs.card_line()
    t0 = time.perf_counter()
    cs.log(f"kernels built in {time.perf_counter() - t0:.1f} s: {cs.cuda_build.build_all()}")
    jobs = []
    for part in parts:
        if part == "g9":
            jobs.append((part, lambda: cs.d128_train_kernel_phase(cs.STARCODER2, cs.D128_G9_TRAIN_SHAPE, "_g9")))
        elif part in cs.TRAIN_RUNS:
            jobs.append((part, lambda run=part: cs._finetune(run)))
        elif part.startswith("opt8:"):
            jobs.append((part, lambda m=part.split(":", 1)[1]: cs.train_opt8_phase(m)))
        elif part == "parity" or part.startswith("parity:"):
            names = NEW_PARITY if part == "parity" else [part.split(":", 1)[1]]
            jobs += [(f"parity:{n}", lambda n=n: cs.grad_parity_phase(n)) for n in names]
        else:
            raise SystemExit(f"unknown part {part!r}: g9, a TRAIN_RUNS name, opt8:<model>, parity or "
                             "parity:<model>")
    failed = []
    for name, fn in jobs:
        t = time.perf_counter()
        try:
            fn()
            cs.log(f"== {name} ok in {time.perf_counter() - t:.1f} s")
        except Exception:  # noqa: BLE001 - reported, then the next part runs
            failed.append(name)
            cs.log(f"== {name} FAILED in {time.perf_counter() - t:.1f} s\n{traceback.format_exc()}")
        cs.free_card()
    cs.log(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
