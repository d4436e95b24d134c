"""Fine-tune entry point for the PyTorch port:
``python -m dstack_tpu_torch.train.finetune``.

Counterpart of ``python -m dstack_tpu.train.finetune`` on one GPU: the
same model names, defaults (llama-3.2-1b, ``--seq-len 2048 --batch 8``,
LoRA on wq/wk/wv/wo unless ``--full``) and outputs
(``model_weights.npz`` or ``lora_adapters.npz`` under ``--out``). Every
family of ``CONFIGS`` trains, as in JAX: the dense Llama, the Gemma family
at head_dim 256, the dense families' deltas (qwen-2.5-7b, starcoder2-7b,
minitron-4b, command-r-35b, olmo-2-7b, glm-4-9b, ...), the MoE families,
Llama4, gpt-oss and DeepSeek (MLA at head_dim 192, the MoE with its
router aux loss; LoRA refuses MLA, as JAX's does, so ``--full``). The
flash layers run the kernels: K1 forward (once a layer: its residuals are
kept across remat), K2/K3 backward; gpt-oss's sinks and a Llama4 chunk
mask past the first chunk take the masked attention, as JAX trains them,
and launch none. With ``--opt-bits 8`` the moments are int8 and each
quantized leaf's update is one launch of A8 (``ops/adam8.py``).
Weights are random from
``--seed``, or a ``save_pretrained`` checkpoint with ``--hf-model DIR``
(the model types ``models/convert_hf.py`` reads; the run is named after
the directory); data is a synthetic token
stream unless ``--data`` names a corpus: pre-tokenized ``.npy``/``.bin``,
or ``.jsonl``/``.txt`` tokenized by the HF tokenizer at
``--data-tokenizer``.

``--ckpt-dir`` saves the train state every ``--ckpt-every`` steps
(``train/checkpoint.py``: the port's own format, so a JAX checkpoint does
not resume here, nor the reverse) and ``--resume`` starts at the latest
saved step. As in JAX, a resumed run with ``--data`` starts its data
stream again from the first batch (the synthetic stream is seeded by the
step index, so it resumes where it was). On SIGTERM (a spot preemption)
the step in flight finishes, the state is saved and the run exits 0.
``--eval-data`` evaluates a held-out corpus (one unshuffled epoch, at most
``--eval-batches`` batches) every ``--eval-every`` steps and at the end:
``eval[<tag>] loss=... ppl=...``, the mask-weighted mean, under no_grad
on K1.

Output: the ``first_train_step`` JSON event, one line per logged step
(loss, tokens/s, MFU against the H100 SXM dense-bf16 peak), and as the
last line a JSON summary (losses, the last step's router aux loss, the
optimizer's bits, the full fine-tune's loss (``loss_impl_for``: the
chunked one where the f32 logits pass 256 MiB), the eval losses, median
step time, tokens/s, MFU, peak device memory, kernel launch counts). Step times, tokens/s and MFU go through the ``dtpu_train_*``
registry of ``make_step_callback``, fed at each log window's sync (the
loss read), as JAX's finetune feeds it, and the lines are read from it;
the summary's median step is that of the histogram's sample window, the
last 1024 steps.
``--export-hf DIR`` also writes the final weights as an HF
``save_pretrained`` directory (``convert_hf.save_checkpoint``: the
trained tree with ``--full``, else the base with the adapters merged in),
as the JAX finetune does.
``--profile-dir DIR`` traces three steady steps with ``torch.profiler``
(the JAX finetune's step arithmetic) into a Chrome trace in DIR. Runs on
``cuda`` unless ``--device cpu`` asks for the plain versions on the CPU.

Multi-rank (ROADMAP A6.1): under ``torchrun --nproc-per-node N`` every
rank runs this script on a mesh of JAX's axes (``--dp``, ``--fsdp``
absorbing the rest by default as in JAX, ``--sp`` with ``--seq-parallel
ring|ulysses``); see ``train/step.py`` and ``parallel/``. Each rank builds
the same global batch and trains on its part; the first line names the
backend, the rank-to-device map and the mesh (``parallel/mesh.py``: NCCL
where every rank has its own card, gloo where ranks share one), and rank 0
alone logs, checkpoints, writes the weights and the summary, and exports.
Tokens/s counts the global batch; MFU divides by the ranks' peaks.
``--tp > 1`` exits non-zero and names the slice that brings it (ROADMAP
A6.2).
"""

import argparse
import dataclasses
import json
import math
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dstack_tpu_torch.models import convert_hf, llama
from dstack_tpu_torch.ops import adam8, flash
from dstack_tpu_torch.parallel.mesh import Mesh, MeshConfig, init_distributed, mesh_shape
from dstack_tpu_torch.train import checkpoint as ckpt_mod
from dstack_tpu_torch.train import data as data_mod
from dstack_tpu_torch.train import lora as lora_mod
from dstack_tpu_torch.train.step import (
    PEAK_FLOPS,
    default_optimizer,
    flops_per_token,
    eval_loss,
    gather_params,
    gathered_leaves,
    local_batch,
    loss_impl_for,
    make_step_callback,
    make_train_step,
    init_train_state,
    sharded_init,
    tree_leaves,
)

PEAK_NAME = "H100 SXM dense bf16 peak, 989 TFLOP/s"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dstack_tpu_torch.train.finetune")
    p.add_argument("--model", default="llama-3.2-1b", choices=sorted(llama.CONFIGS))
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--grad-accum", type=int, default=1, help="mask-weighted microbatches per update")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--full", action="store_true", help="full fine-tune (no LoRA)")
    p.add_argument("--lora-rank", type=int, default=16)
    p.add_argument("--lora-alpha", type=float, default=32.0)
    p.add_argument("--data", default=None,
                   help="corpus: pre-tokenized .npy/.bin, or .jsonl/.txt with --data-tokenizer")
    p.add_argument("--data-tokenizer", default=None, help="local HF tokenizer path for text corpora")
    p.add_argument("--data-seed", type=int, default=0, help="shuffle seed")
    p.add_argument("--data-bin-dtype", default="uint16", choices=["uint16", "uint32"])
    p.add_argument("--eval-data", default=None,
                   help="held-out corpus (same formats); evaluated every --eval-every steps and at the end")
    p.add_argument("--eval-every", type=int, default=0, help="0 = final only")
    p.add_argument("--eval-batches", type=int, default=32, help="max eval batches per evaluation")
    p.add_argument("--out", default="adapters", help="output dir for weights")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    # the mesh axes (JAX's defaults: fsdp absorbs every rank); --tp > 1 waits
    # for a later slice (see _refusals)
    for axis, default in (("--dp", 1), ("--fsdp", -1), ("--sp", 1), ("--tp", 1)):
        p.add_argument(axis, type=int, default=default, help="mesh axis size (-1: the rest)")
    p.add_argument("--seq-parallel", default=None, choices=["ring", "ulysses"],
                   help="sequence-parallel attention on sp > 1 meshes (default: ring)")
    p.add_argument("--opt-bits", type=int, default=32, choices=[8, 32],
                   help="8 stores the Adam moments as blockwise int8 (train/opt8.py)")
    p.add_argument("--ckpt-dir", default=None, help="checkpoint dir; enables periodic saves")
    p.add_argument("--ckpt-every", type=int, default=50, help="steps between saves")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--hf-model", default=None,
                   help="HF save_pretrained dir (any model type models/convert_hf.py reads): "
                        "fine-tune from those weights; overrides --model")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of 3 steady-state steps here")
    p.add_argument(
        "--export-hf", default=None,
        help="also write the final weights as an HF save_pretrained dir (LoRA "
             "adapters are merged into the base first): servable by transformers "
             "or openai_server --hf-model",
    )
    return p


def _refusals(args) -> list[str]:
    """What this slice cannot honour, each with the slice that brings it."""
    out = []
    if args.tp > 1:
        out.append("--tp > 1 comes with the tensor-parallel slice (A6.2)")
    return out


def _synthetic_batch(i: int, args, config, dev) -> dict:
    """Random ids seeded by the step index (the JAX finetune's
    ``jax.random.key(i)``; the bits differ). The roll wraps the last
    target to the row's first token, so that position is masked out."""
    gen = torch.Generator(device=dev).manual_seed(i)
    tok = torch.randint(0, config.vocab_size, (args.batch, args.seq_len), generator=gen, device=dev)
    mask = torch.ones_like(tok)
    mask[:, -1] = 0
    return {"tokens": tok, "targets": torch.roll(tok, -1, dims=1), "mask": mask}


def _host(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy: bf16 goes out as f32 (numpy has no bfloat16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flat(tree: dict, layout=None, mesh=None, prefix: str = "") -> dict:
    """{path: numpy leaf} of a tree; on a mesh each sharded leaf gathered
    in turn (every rank takes part; the host copies are rank 0's)."""
    if mesh is not None:
        return {k: _host(v) for k, v in gathered_leaves(tree, layout, mesh) if mesh.rank == 0}
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        out.update(_flat(v, prefix=key + "/") if isinstance(v, dict) else {key: _host(v)})
    return out


def _whole(tree: dict, layout, mesh) -> dict:
    """The whole parameters (sharded leaves gathered) on a mesh, else ``tree``."""
    return tree if mesh is None else gather_params(tree, layout, mesh)


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    for msg in _refusals(args):
        p.error(f"not ported yet: {msg} (ROADMAP.md, queue A)")
    if args.batch % max(args.grad_accum, 1):
        p.error(f"--batch {args.batch} not divisible by --grad-accum {args.grad_accum}")
    env = init_distributed(args.device)
    try:
        mesh = Mesh(MeshConfig(dp=args.dp, fsdp=args.fsdp, sp=args.sp, tp=args.tp), env)
    except ValueError as e:
        p.error(str(e))
    dev, rank0 = env.device, env.rank == 0
    # one rank runs the single-device code paths, unchanged
    pmesh = mesh if mesh.world > 1 else None
    say = print if rank0 else (lambda *a, **k: None)
    described = mesh.describe()
    say(described, flush=True)
    params = None
    if args.hf_model:
        try:
            config, params = convert_hf.load_checkpoint(args.hf_model, device=dev)
        except (OSError, ValueError) as e:
            p.error(f"--hf-model {args.hf_model}: {e}")
        args.model = Path(args.hf_model).resolve().name
    else:
        config = llama.CONFIGS[args.model]
    if args.seq_parallel:
        config = dataclasses.replace(config, seq_parallel=args.seq_parallel)
    rows_per_rank = args.batch // max(args.grad_accum, 1) // mesh.batch_index()[1]
    if args.batch % (max(args.grad_accum, 1) * mesh.batch_index()[1]) or args.seq_len % mesh.size("sp"):
        p.error(f"--batch {args.batch} (--grad-accum {args.grad_accum}) and --seq-len {args.seq_len} do not "
                f"split over the mesh {described.rsplit('mesh=', 1)[1]}")
    if not args.full:
        try:
            lora_mod.check_lora(config)
        except ValueError as e:
            p.error(f"--model {args.model}: {e}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    shape = mesh_shape(mesh)
    say(
        f"model={args.model} params={config.num_params() / 1e9:.2f}B mesh={shape} chips={mesh.world} mode="
        f"{'full' if args.full else 'lora'} device={dev} ({kind})",
        flush=True,
    )

    def corpus(path: str, what: str) -> np.ndarray:
        try:
            rows = data_mod.load_tokens(path, args.seq_len, tokenizer=args.data_tokenizer,
                                        bin_dtype=args.data_bin_dtype)
        except (ValueError, ImportError, OSError) as e:
            p.error(str(e))
        if rows.shape[0] < args.batch:
            p.error(f"{what}corpus packs to {rows.shape[0]} rows < batch {args.batch}")
        return rows

    rows = corpus(args.data, "") if args.data else None
    eval_rows = corpus(args.eval_data, "eval ") if args.eval_data else None

    t0 = time.perf_counter()
    opt = default_optimizer(lr=args.lr, decay_steps=args.steps, opt_bits=args.opt_bits)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if params is None:
        params = llama.init_params(config, gen, device=dev)
    layout = base_layout = None
    try:
        if args.full and pmesh is None:
            state = init_train_state(config, opt, params=params)
        elif args.full:
            state, layout = sharded_init(config, opt, pmesh, params=params)
            params = None  # the whole tree goes: the state holds this rank's shards
            base_layout = layout["params"]
        else:
            lora_conf = lora_mod.LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha)
            if pmesh is None:
                state = lora_mod.init_lora_state(lora_mod.init_lora_params(config, lora_conf, gen, device=dev), opt)
            else:
                params, state, base_layout = lora_mod.sharded_lora_init(config, lora_conf, opt, pmesh, gen,
                                                                        params=params)
                layout = {"lora": None, "opt_state": None, "step": None}  # the adapters: whole on every rank
        step_fn = (make_train_step(config, opt, grad_accum=args.grad_accum, mesh=pmesh) if args.full else
                   lora_mod.make_lora_train_step(config, lora_conf, opt, grad_accum=args.grad_accum, mesh=pmesh))
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    say(f"init done in {time.perf_counter() - t0:.1f}s", flush=True)

    start_step = 0
    checkpointer = None
    if args.ckpt_dir:
        if args.resume:
            state, restored = ckpt_mod.restore_checkpoint(args.ckpt_dir, state, layout, pmesh)
            if restored is not None:
                start_step = restored
                say(f"resumed from checkpoint step {start_step}", flush=True)
        checkpointer = ckpt_mod.Checkpointer(args.ckpt_dir, layout=layout, mesh=pmesh)

    def mine(batch: dict) -> dict:
        """This rank's part of a global batch."""
        return batch if pmesh is None else local_batch(batch, pmesh, args.grad_accum)

    if rows is not None:
        # as in JAX, the stream starts at its first batch on a resume too
        data_iter = data_mod.prefetch_to_device(data_mod.batches(rows, args.batch, seed=args.data_seed), dev)

        def next_batch(i):
            return mine(next(data_iter))
    else:

        def next_batch(i):
            return mine(_synthetic_batch(i, args, config, dev))

    evals = []

    def run_eval(tag: str) -> float:
        """One unshuffled epoch of the eval corpus, at most
        ``--eval-batches`` batches → the mask-weighted mean loss, printed
        as JAX prints it; → the seconds it took."""
        t_eval = time.perf_counter()
        total, weight = 0.0, 0.0
        it = data_mod.batches(eval_rows, args.batch, seed=0, epochs=1)
        whole = _whole(state["params"] if args.full else params, base_layout, pmesh)
        for n, b in enumerate(data_mod.prefetch_to_device(it, dev)):
            if n >= args.eval_batches:
                break
            b = b if pmesh is None else local_batch(b, pmesh)
            lora_kw = {} if args.full else dict(lora=state["lora"], lora_scale=lora_conf.scale)
            loss, w = eval_loss(whole, b, config, mesh=pmesh, **lora_kw)
            loss, w = float(loss), float(w)
            total += loss * w
            weight += w
        if weight:
            mean = total / weight
            evals.append({"tag": tag, "loss": mean, "ppl": math.exp(min(mean, 30))})
            say(f"eval[{tag}] loss={mean:.4f} ppl={math.exp(min(mean, 30)):.2f}", flush=True)
        return time.perf_counter() - t_eval

    tokens_per_step = args.batch * args.seq_len
    # step time, tokens/s and MFU into the train registry, fed at the log
    # windows' sync points; MFU over the ranks' peaks
    step_cb = make_step_callback(config, tokens_per_step, args.seq_len, peak_flops_per_chip=PEAK_FLOPS * mesh.world)
    step_hist = step_cb.registry.family("dtpu_train_step_seconds")

    # Spot preemption arrives as SIGTERM with a short grace period: finish
    # the step in flight, save a final checkpoint and exit 0, so that a
    # retry resumes from this step (the JAX finetune's contract)
    interrupted = {"flag": False}

    def on_sigterm(signum, frame):
        interrupted["flag"] = True
        say("SIGTERM: checkpointing before exit", flush=True)

    previous_handler = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        previous_handler = None  # not the main thread (a test calling main())

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the counts of this run's launches start here
    flash.LAUNCHES = flash.LAUNCHES_DQ = flash.LAUNCHES_DKV = adam8.LAUNCHES = 0
    flash.LAUNCHES_BY_FORM.clear()
    first_loss = metrics = None
    eval_s = ckpt_s = 0.0
    # profile 3 steady-state steps, past the first steps' start-up
    prof_start = start_step + min(2, max(args.steps - start_step - 3, 0))
    prof_stop = prof_start + min(3, args.steps - start_step)
    prof = None
    t_window = time.perf_counter()
    for i in range(start_step, args.steps):
        stop = interrupted["flag"]
        if mesh.world > 1:  # every rank stops at the same step
            stop = bool(mesh.all_reduce(torch.tensor(float(stop), device=dev)).item())
        if stop:
            if checkpointer is not None:
                checkpointer.save(i, state)
                checkpointer.close()
                say(f"interrupted: checkpoint saved at step {i}; exiting", flush=True)
            if previous_handler is not None:
                signal.signal(signal.SIGTERM, previous_handler)
            return 0
        if args.profile_dir and i == prof_start and rank0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        batch = next_batch(i)
        if args.full:
            state, metrics = step_fn(state, batch)
        else:
            state, metrics = step_fn(params, state, batch)
        if prof is not None and i + 1 == prof_stop:
            float(metrics["loss"])  # the traced steps' device work is done
            prof.stop()
            Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
            trace_path = Path(args.profile_dir) / "finetune_trace.json"
            prof.export_chrome_trace(str(trace_path))
            prof = None
            say(f"profiler trace saved to {trace_path}", flush=True)
        if checkpointer is not None and (i + 1) % args.ckpt_every == 0:
            # only the device-to-host copy blocks: the write runs on a
            # background thread while training continues
            t_save = time.perf_counter()
            checkpointer.save(i + 1, state)
            took = time.perf_counter() - t_save
            ckpt_s += took
            t_window += took  # the step times leave the save out
            say(f"checkpoint saved at step {i + 1}", flush=True)
        if first_loss is None:
            first_loss = float(metrics["loss"])  # waits for the step
            # the provision → first-train-step marker the JAX finetune prints
            say(json.dumps({"event": "first_train_step", "t_unix": time.time()}), flush=True)
        if eval_rows is not None and args.eval_every and (i + 1) % args.eval_every == 0:
            took = run_eval(f"step {i + 1}")
            eval_s += took
            t_window += took  # the step times leave the eval out
        if (i + 1) % args.log_every == 0:
            loss = float(metrics["loss"])  # host sync: the window's steps are done
            dt = (time.perf_counter() - t_window) / args.log_every
            t_window = time.perf_counter()
            tel = step_cb(dt, steps=args.log_every)
            mfu = f"{tel['mfu']:.2%} of the {PEAK_NAME}" if dev.type == "cuda" else "n/a on the CPU"
            if mesh.world > 1:
                mfu += f" x {mesh.world} ranks"
            say(
                f"step {i + 1}/{args.steps} loss={loss:.4f} step_s={tel['step_time_s']:.4f} "
                f"tokens/s={tel['tokens_per_sec']:,.0f} mfu={mfu}",
                flush=True,
            )
    if eval_rows is not None:
        eval_s += run_eval("final")
    if checkpointer is not None:
        checkpointer.close()  # drain the write in flight
    last_loss = float(metrics["loss"]) if metrics is not None else None
    aux_loss = float(metrics["aux_loss"]) if metrics is not None and "aux_loss" in metrics else None
    launches = {
        "flash_fwd": flash.LAUNCHES,
        "flash_bwd_dq": flash.LAUNCHES_DQ,
        "flash_bwd_dkv": flash.LAUNCHES_DKV,
        "adam8": adam8.LAUNCHES,
    }
    by_form = dict(sorted(flash.LAUNCHES_BY_FORM.items()))

    trained = state["params"] if args.full else state["lora"]
    flat = _flat(trained, base_layout, pmesh) if args.full else \
        {f"layers.{k}": _host(v) for k, v in trained["layers"].items()}
    fname = "model_weights.npz" if args.full else "lora_adapters.npz"
    out = Path(args.out)
    if rank0:
        if args.full:
            flat["step"] = np.asarray(state["step"], np.int32)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / fname, **flat)
    say(f"weights saved to {out}/{fname} ({len(tree_leaves(trained))} leaves)", flush=True)
    if args.export_hf:
        whole = _whole(state["params"] if args.full else params, base_layout, pmesh)
        merged = whole if args.full else lora_mod.merge_lora_params(whole, state["lora"], lora_conf)
        if rank0:
            convert_hf.save_checkpoint(config, merged, args.export_hf)
        del whole, merged
        say(f"HF checkpoint exported to {args.export_hf}", flush=True)

    # the registry's median window: a window's mean step time once a step,
    # over the histogram's sample window (its last 1024 steps; a longer run
    # reports the median of those, not of the whole run)
    med = step_hist.quantile(0.5)
    tps = tokens_per_step / med if med else None
    ftok = flops_per_token(config, args.seq_len)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    per_rank = [None] * mesh.world
    if mesh.world > 1:
        torch.distributed.all_gather_object(per_rank, {"peak_memory_bytes": peak, "launches": launches,
                                                       "launches_by_form": by_form})
    else:
        per_rank = [{"peak_memory_bytes": peak, "launches": launches, "launches_by_form": by_form}]
    say(json.dumps({
        "event": "summary",
        "model": args.model,
        "mode": "full" if args.full else "lora",
        "device": str(dev),
        "device_name": kind,
        "batch": args.batch,
        "seq_len": args.seq_len,
        "mesh": shape,
        "ranks": mesh.world,
        "backend": mesh.backend,
        "rows_per_rank": rows_per_rank,
        "steps": args.steps,
        "start_step": start_step,
        "opt_bits": args.opt_bits,
        "loss_impl": loss_impl_for(args.batch // max(args.grad_accum, 1), args.seq_len, config.vocab_size)
        if args.full else None,
        "first_loss": first_loss,
        "last_loss": last_loss,
        "aux_loss": aux_loss,
        "eval": evals,
        "eval_seconds": eval_s,
        "checkpoint_seconds": ckpt_s,
        "median_step_s": med,
        "tokens_per_s": tps,
        "mfu": ftok * tps / (PEAK_FLOPS * mesh.world) if on_card and tps else None,
        "mfu_peak": PEAK_NAME + (f" x {mesh.world} ranks" if mesh.world > 1 else ""),
        "peak_memory_bytes": peak,
        "launches": launches,
        "launches_by_form": by_form,
        "by_rank": per_rank,
    }), flush=True)
    if previous_handler is not None:
        signal.signal(signal.SIGTERM, previous_handler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
