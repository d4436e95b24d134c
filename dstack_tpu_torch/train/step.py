"""Training step for the PyTorch port (counterpart of dstack_tpu.train.step).

One step is: forward (``llama.forward`` with ``return_hidden`` and
``return_aux``; K1 flash forward once a layer, its residuals kept across
remat), the head fused into the cross-entropy (``loss_impl="fused"``, or
``"chunked"`` over sequence chunks, which a step whose f32 logits pass
``MAX_LOGITS_BYTES`` takes by default), plus the MoE router aux loss,
backward (K2/K3 per layer), then clip-by-global-norm and AdamW under a
warmup-cosine schedule, with bf16 moments or int8 ones
(``default_optimizer(opt_bits=8)``: ``train/opt8.py``, A8 on the card).
JAX builds the step as one ``jit``
over a mesh; the port runs it eagerly on one device and updates the
parameters and moments in place (the JAX step donates its state, so the
old state is never read again either).

Parameters, gradients and moments are plain nested dicts of tensors in
the JAX package's layout (stacked ``[L, ...]`` layers), so the parity
tests compare them leaf for leaf. ``make_step_callback`` feeds the
``dtpu_train_*`` series of ``new_train_registry`` (the port's own
``obs`` registry) at the trainer's sync points; ``make_eval_step`` is
the held-out loss. The parallel paths (meshes, pipeline) are not ported
yet (ROADMAP.md).
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from dstack_tpu_torch.models import llama

# ---------------------------------------------------------------------------
# parameter trees (nested dicts of tensors)
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same keys of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order, the same for every tree of one shape."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        return next(it)

    return fill(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    return torch.sqrt(sum(leaf.float().pow(2).sum() for leaf in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _mask(targets: torch.Tensor, mask: Optional[torch.Tensor]) -> tuple:
    m = torch.ones_like(targets, dtype=torch.float32) if mask is None else mask.float()
    return m, m.sum().clamp(min=1.0)


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, T, V] f32
    targets: torch.Tensor,  # [B, T] int
    mask: Optional[torch.Tensor] = None,  # [B, T] 0/1
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (mean loss over the mask, total weight) (step.py:25)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    m, total = _mask(targets, mask)
    return -(ll * m).sum() / total, total


def fused_cross_entropy(
    x: torch.Tensor,  # [B, T, E] final hidden (model dtype)
    head: torch.Tensor,  # [E, V]
    targets: torch.Tensor,  # [B, T] int
    mask: Optional[torch.Tensor],  # [B, T] 0/1
    softcap: float = 0.0,  # Gemma2's final-logit tanh cap
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy in logsumexp form, loss = lse(logits) - logit[y]
    (step.py:40): the f32-accumulated logits, tanh-capped first under
    ``softcap``, are the only full-vocab tensor the forward keeps; no f32
    log-probabilities."""
    logits = llama.matmul_f32(x, head)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    m, total = _mask(targets, mask)
    return ((lse - tgt) * m).sum() / total, total


# the f32 logits the fused loss may hold in one piece: past it the default
# loss is the chunked one, whose chunks fit it (chunked_cross_entropy's
# max_chunk_bytes)
MAX_LOGITS_BYTES = 256 * 1024 * 1024


def chunk_count(b: int, t: int, v: int, max_chunk_bytes: int) -> int:
    """The chunks of :func:`chunked_cross_entropy`: the smallest divisor c
    of T whose f32 logits chunk [B, T/c, V] fits ``max_chunk_bytes``, or
    T (step.py:96-102)."""
    c = 1
    while c < t and (b * (t // c) * v * 4 > max_chunk_bytes or t % c != 0):
        c += 1
    while t % c != 0:
        c += 1
    return c


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
               softcap: float) -> torch.Tensor:
    """One chunk's masked negative log-likelihood sum: its f32 logits
    (tanh-capped under ``softcap``), log-softmax, the targets' entries."""
    logits = llama.matmul_f32(x, head)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    ll = torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]
    return -(ll * mask).sum()


def chunked_cross_entropy(
    x: torch.Tensor,  # [B, T, E] final hidden (model dtype)
    head: torch.Tensor,  # [E, V]
    targets: torch.Tensor,  # [B, T] int
    mask: Optional[torch.Tensor],  # [B, T] 0/1
    max_chunk_bytes: int = MAX_LOGITS_BYTES,
    softcap: float = 0.0,  # Gemma2's final-logit tanh cap
) -> tuple[torch.Tensor, torch.Tensor]:
    """The head fused into the loss, chunked over the sequence
    (step.py:73-127): :func:`chunk_count` chunks, each chunk's head
    product and log-softmax under ``torch.utils.checkpoint``, so at most
    one chunk's f32 logits exist at a time, in the forward and in the
    backward, which recomputes them. → (mean loss over the mask, total
    weight)."""
    m, total = _mask(targets, mask)
    n = x.shape[1] // chunk_count(x.shape[0], x.shape[1], head.shape[-1], max_chunk_bytes)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    # one split node: its backward joins the chunks' gradients at once
    for xc, tc, mc in zip(x.split(n, dim=1), targets.split(n, dim=1), m.split(n, dim=1)):
        nll = nll + checkpoint(_chunk_nll, xc, head, tc, mc, softcap, use_reentrant=False)
    return nll / total, total


LOSS_IMPLS = ("fused", "chunked")


def loss_impl_for(b: int, t: int, v: int) -> str:
    """The loss a step of B x T tokens over V classes takes by default:
    ``"fused"`` where its f32 logits fit MAX_LOGITS_BYTES in one piece,
    else ``"chunked"``. JAX leaves the choice to its caller (default
    ``"fused"``); the two agree wherever the logits fit."""
    return "fused" if chunk_count(b, t, v, MAX_LOGITS_BYTES) == 1 else "chunked"


def objective(params: dict, batch: dict, config: llama.LlamaConfig, impl=None,
              loss_impl: Optional[str] = None) -> tuple:
    """The full fine-tune objective as the JAX step's ``loss_fn`` returns
    it (step.py:305-331) → (CE + aux, (CE, aux)): the cross-entropy
    (:func:`fused_cross_entropy`, or :func:`chunked_cross_entropy` with
    ``loss_impl="chunked"``; None picks by :func:`loss_impl_for`) with the
    config's final-logit cap inside it, and the router aux loss summed
    over the MoE layers (0 for a dense model)."""
    if loss_impl is None:
        loss_impl = loss_impl_for(*batch["tokens"].shape, config.vocab_size)
    if loss_impl not in LOSS_IMPLS:
        raise ValueError(f"loss_impl {loss_impl!r} not in {LOSS_IMPLS}")
    x, aux = llama.forward(params, batch["tokens"], config, return_hidden=True, return_aux=True,
                           impl=impl)
    head = llama.lm_head_weight(params, config)
    loss = chunked_cross_entropy if loss_impl == "chunked" else fused_cross_entropy
    ce = loss(x, head, batch["targets"], batch.get("mask"), softcap=config.logit_softcap)[0]
    return ce + aux, (ce, aux)


def full_loss(params: dict, batch: dict, config: llama.LlamaConfig, impl=None,
              loss_impl: Optional[str] = None) -> torch.Tensor:
    """The full fine-tune loss, CE + aux: what the JAX step differentiates."""
    return objective(params, batch, config, impl, loss_impl)[0]


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def value_and_grad(fn: Callable, wrt: dict, *args, has_aux: bool = False) -> tuple:
    """(fn(wrt, *args), d fn / d wrt) as a tree shaped like ``wrt``;
    ``args`` are constants. The leaves share ``wrt``'s storage; a leaf
    the loss does not depend on gets zeros. With
    ``has_aux`` ``fn`` returns (loss, aux) and the value is that pair
    (``jax.value_and_grad(..., has_aux=True)``); aux is a tuple of
    tensors, not differentiated."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), wrt)
    out = fn(live, *args)
    loss = out[0] if has_aux else out
    # a leaf the loss does not reach (DeepSeek's selection bias selects
    # only) gets zeros, as jax.grad gives it
    grads = _unflatten(wrt, torch.autograd.grad(loss, tree_leaves(live), materialize_grads=True))
    if has_aux:
        return (loss.detach(), tuple(a.detach() for a in out[1])), grads
    return loss.detach(), grads


def accumulate_grads(
    fn: Callable, wrt: dict, batch: dict, grad_accum: int, *args, has_aux: bool = False
) -> tuple:
    """``grad_accum`` microbatches over the batch's leading dim, gradients
    averaged with each one weighted by its mask sum (step.py:336-357):
    f32 accumulators, the mean cast back to each leaf's dtype; with
    ``has_aux`` each aux tensor is averaged with the same weights, as
    JAX weights the aux loss like the cross-entropy. ``fn`` is called as
    ``fn(wrt, microbatch, *args)``; the result is
    :func:`value_and_grad`'s."""
    if grad_accum == 1:
        return value_and_grad(fn, wrt, batch, *args, has_aux=has_aux)
    n = batch["tokens"].shape[0]
    if n % grad_accum:
        raise ValueError(f"batch {n} not divisible by grad_accum {grad_accum}")
    size = n // grad_accum
    g_acc = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), wrt)
    val_acc = None
    w_acc = 0.0
    for i in range(grad_accum):
        mb = {k: v[i * size : (i + 1) * size] for k, v in batch.items()}
        value, g = value_and_grad(fn, wrt, mb, *args, has_aux=has_aux)
        w = _mask(mb["tokens"], mb.get("mask"))[1]
        tree_map(lambda acc, gi: acc.add_(gi.float() * w), g_acc, g)
        flat = [value[0], *value[1]] if has_aux else [value]
        val_acc = [v * w for v in flat] if val_acc is None else [a + v * w for a, v in zip(val_acc, flat)]
        w_acc = w_acc + w
    grads = tree_map(lambda acc, t: (acc / w_acc).to(t.dtype), g_acc, wrt)
    mean = [a / w_acc for a in val_acc]
    return ((mean[0], tuple(mean[1:])) if has_aux else mean[0]), grads


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def warmup_cosine_decay(peak: float, warmup: int, decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup,
    decay_steps)``: linear from 0 over ``warmup`` counts, then cosine to
    0 at ``decay_steps`` (which includes the warmup)."""
    cos_steps = decay_steps - warmup
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup {warmup}")

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, cos_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))

    return schedule


@dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1,
    b2, eps, weight_decay))`` as functions on tensor lists:

    - the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
      (no ``+1e-6`` as ``torch.nn.utils.clip_grad_norm_`` adds);
    - the moments keep each parameter's dtype;
    - bias correction uses the incremented count, the schedule the count
      before it (so the first update has lr = schedule(0));
    - weight decay applies to every leaf, the norms included.

    :meth:`update` writes the new parameters and moments in place."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_norm: float = 1.0

    def init(self, params: dict) -> dict:
        return {
            "count": 0,
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> dict:
        """One step: ``params`` and ``state``'s moments are updated in
        place (``grads`` are not); returns ``state`` with its count
        advanced. Scalars enter each dtype's arithmetic rounded to that
        dtype, as optax casts them."""
        norm = global_norm(grads)
        clip = norm >= self.max_norm
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = (1 - torch.tensor(self.b1, dtype=f32) ** count).item()
        bc2 = (1 - torch.tensor(self.b2, dtype=f32) ** count).item()
        step_size = -self.schedule(state["count"])
        groups = {}
        for leaves in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"])
        ):
            groups.setdefault(leaves[0].dtype, []).append(leaves)
        for dtype, leaves in groups.items():
            p, g, mu, nu = (list(x) for x in zip(*leaves))

            def cast(x: float, dtype=dtype) -> float:
                return torch.tensor(x, dtype=dtype).item()

            g = [torch.where(clip, x / norm.to(dtype) * self.max_norm, x) for x in g]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
            del g
            upd = torch._foreach_div(mu, cast(bc1))
            denom = torch._foreach_div(nu, cast(bc2))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_mul_(upd, cast(step_size))
            torch._foreach_add_(p, upd)
        state["count"] = count
        return state


def default_optimizer(
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    warmup: int = 100,
    decay_steps: int = 10000,
    opt_bits: int = 32,
):
    """clip-by-global-norm(1.0) then AdamW(b1 0.9, b2 0.95) under
    warmup-cosine (step.py:141); ``opt_bits=8`` keeps the moments as
    blockwise int8 (``train/opt8.py``'s :class:`AdamW8`, step.py:154-160)."""
    if opt_bits not in (8, 32):
        raise ValueError(f"opt_bits must be 8 or 32, got {opt_bits}")
    schedule = warmup_cosine_decay(lr, warmup, max(decay_steps, warmup + 1))
    if opt_bits == 8:
        from dstack_tpu_torch.train.opt8 import AdamW8

        return AdamW8(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay)
    return AdamW(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def init_train_state(
    config: llama.LlamaConfig,
    optimizer: AdamW,
    *,
    params: Optional[dict] = None,
    seed: int = 0,
    device="cuda",
) -> dict:
    """{params, opt_state, step}; random weights from ``seed`` unless
    ``params`` is given."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llama.init_params(config, gen, device=device)
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


def make_train_step(
    config: llama.LlamaConfig,
    optimizer,
    grad_accum: int = 1,
    impl: Optional[str] = None,
    loss_impl: Optional[str] = None,
) -> Callable:
    """(state, batch{tokens, targets, mask}) → (state, metrics): the full
    fine-tune step, whose gradients are of CE + the router aux loss.
    ``loss_impl`` picks the head's fusion into the loss, as JAX's does
    (step.py:276): ``"fused"`` (one f32 logits tensor) or ``"chunked"``
    (:func:`chunked_cross_entropy`: one chunk's at a time); the default,
    None, picks by the micro-batch's size (:func:`loss_impl_for`), so a
    step whose logits would not fit the card takes the chunked loss.
    ``optimizer`` is :class:`AdamW` or ``opt8.AdamW8``.
    ``state`` is updated in place and returned; ``metrics`` hold 0-dim
    device tensors (``loss``: the CE, ``aux_loss``, and ``grad_norm``
    before the clip; the JAX step's, step.py:374), read without a host
    sync."""

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        (_, (ce, aux)), grads = accumulate_grads(objective, state["params"], batch, grad_accum, config,
                                                 impl, loss_impl, has_aux=True)
        gnorm = global_norm(grads)
        optimizer.update(grads, state["opt_state"], state["params"])
        state["step"] += 1
        return state, {"loss": ce, "aux_loss": aux, "grad_norm": gnorm}

    if loss_impl is not None and loss_impl not in LOSS_IMPLS:
        raise ValueError(f"loss_impl {loss_impl!r} not in {LOSS_IMPLS}")
    return step


def eval_loss(params: dict, batch: dict, config: llama.LlamaConfig, *, lora: Optional[dict] = None,
              lora_scale: float = 1.0, impl: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The held-out loss of one batch with autograd off → (mean loss
    over the mask, total weight): the forward's f32 logits (K1 once a
    layer, no backward) and :func:`cross_entropy_loss`, as the JAX
    finetune's ``_eval_fwd`` takes them (finetune.py:237-245); with
    ``lora`` the adapters' bypass."""
    with torch.no_grad():
        logits = llama.forward(params, batch["tokens"], config, lora=lora, lora_scale=lora_scale, impl=impl)
        return cross_entropy_loss(logits, batch["targets"], batch.get("mask"))


def make_eval_step(config: llama.LlamaConfig, impl: Optional[str] = None) -> Callable:
    """(params, batch) → {"loss"}: the JAX ``make_eval_step``
    (step.py:387-399) on one device."""

    def step(params: dict, batch: dict) -> dict:
        return {"loss": eval_loss(params, batch, config, impl=impl)[0]}

    return step


def flops_per_token(config: llama.LlamaConfig, seq_len: int) -> float:
    """Approximate train FLOPs per token (step.py:402): 6·N plus the
    attention term. N counts the active parameters, as JAX's
    ``num_active_params`` does: every parameter of a dense model (Gemma's
    tied embedding once and its four norms a layer), and on an MoE model
    only the routed experts a token takes."""
    attn = 12 * config.n_layers * config.hidden_size * seq_len  # fwd+bwd qk/av
    return 6.0 * config.num_active_params() + attn


# ---------------------------------------------------------------------------
# step telemetry (obs registry hook)
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)


def new_train_registry():
    """Registry with every train metric family (JAX's, same names,
    types, help texts and buckets; the serve twin is serve/metrics.py)."""
    from dstack_tpu_torch.obs import LATENCY_BUCKETS_S, Registry

    r = Registry()
    r.histogram(
        "dtpu_train_step_seconds",
        "Train-step wall time (averaged over the sync window)",
        buckets=LATENCY_BUCKETS_S,
    )
    r.gauge("dtpu_train_tokens_per_sec", "Training throughput over all chips")
    r.gauge("dtpu_train_mfu", "Model-FLOPs utilization vs the configured per-chip peak")
    r.counter("dtpu_train_steps_total", "Optimizer steps completed")
    r.counter("dtpu_train_tokens_total", "Tokens consumed by training")
    return r


def make_step_callback(
    config: llama.LlamaConfig,
    tokens_per_step: int,
    seq_len: int,
    peak_flops_per_chip: float = PEAK_FLOPS,
):
    """Step-telemetry hook → ``cb(dt_seconds, steps=1)``.

    The trainer calls it at its host-sync points (finetune syncs once a
    log window, by reading the loss: a sync every step would stall the
    queued device work), so ``dt_seconds`` is the window's mean step time
    and ``steps`` its width. Each call observes the step time and
    refreshes tokens/s and MFU (one card: the port has no multi-card
    trainer yet); a fresh ``new_train_registry()`` rides on the callback
    as ``cb.registry``."""
    reg = new_train_registry()
    fpt = flops_per_token(config, seq_len)
    step_hist = reg.family("dtpu_train_step_seconds")
    tps_gauge = reg.family("dtpu_train_tokens_per_sec")
    mfu_gauge = reg.family("dtpu_train_mfu")
    steps_ctr = reg.family("dtpu_train_steps_total")
    tokens_ctr = reg.family("dtpu_train_tokens_total")

    def cb(dt_seconds: float, steps: int = 1) -> dict:
        dt = max(float(dt_seconds), 1e-9)
        tps = tokens_per_step / dt
        mfu = tps * fpt / peak_flops_per_chip
        for _ in range(steps):
            step_hist.observe(dt)
        tps_gauge.set(round(tps, 3))
        mfu_gauge.set(round(mfu, 6))
        steps_ctr.inc(steps)
        tokens_ctr.inc(tokens_per_step * steps)
        return {"tokens_per_sec": tps, "mfu": mfu, "step_time_s": dt}

    cb.registry = reg
    return cb
