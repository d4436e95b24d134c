"""Sparse Mixture-of-Experts MLP (counterpart of dstack_tpu.models.moe).

The same function as the JAX ``moe_mlp`` (dstack_tpu/models/moe.py:159),
capacity drops included. Each batch row is a routing group: every
expert has ``capacity`` slots a row, assigned in sequence order by a
cumsum over the row's tokens, and a token's earlier (higher-gate)
choices take priority over every token's later ones. A choice that
finds its expert full is dropped (its combine weight is 0; the residual
stream carries the token). Pad tokens route like any other, so the
caller must pass the shapes the JAX engine does: ``[B, 1, H]`` at
decode, ``[B, S, H]`` at verify, ``[1, C, H]`` for a serial chunk and
``[G, C, H]`` for a packed wave.

JAX builds one-hot dispatch and combine tensors ``[B, T, E, C]`` and
runs three einsums. Here the router returns each choice's expert and
slot, the dispatch is a scatter of token rows into ``[E, B, C, H]``,
the expert FFNs are batched matmuls over the stacked expert axis, and
the combine is a gather: the same arithmetic without the one-hot
products. The FFNs still run on every expert's ``C`` slots, used or
not, so a step reads every expert's weights, as JAX's dense form does.
The JAX module has no Pallas kernel, so this is plain PyTorch, but for
an int8 tree's expert stacks (models/quant.py), whose products go
through W8's expert form (ops/w8_matmul.py).

Ported branches: the softmax top-k router (optionally renormalized),
the gpt-oss router (a linear layer with an f32 logit bias, selecting by
raw logit and softmaxing over the selected logits), DeepSeek's deltas
(sigmoid scores, a selection bias that selects only, the group limit,
the routed scale), SwiGLU and gpt-oss's clamped GLU, the expert biases,
the dense shared expert and, for training, the Switch aux losses in f32
(load balance over the top-1 choices, and the router z-loss), which only
a caller that asks gets (``with_aux``/``return_aux``): the serving steps
compute none of it. So does Llama4's router, whose sigmoid gate
scales the expert input instead of the output.

The dispatch is differentiable end to end: gradients reach the router
through the kept choices' gates and through the aux terms, and the
experts' and the shared expert's weights through the scatter and the
gather. A dropped choice (slot >= capacity) has combine weight 0 and
carries no gradient, as JAX's zero combine weight carries none.

Every top-k here is :func:`topk`, which orders as ``jax.lax.top_k``
does: by the floats' total order (-0.0 below +0.0), the lower index first
among equal values. ``torch.topk`` promises neither, and DeepSeek's
group limit zeroes whole groups (a negative score masked to -0.0), so a
choice among the zeroed experts (HF's quirk, kept by JAX) would
otherwise differ.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from dstack_tpu_torch.models.llama import _proj, matmul_f32
from dstack_tpu_torch.ops import w8_matmul


def expert_capacity(
    seq_len: int, n_experts: int, experts_per_token: int, capacity_factor: float
) -> int:
    """Per-expert token slots a batch row (a multiple of 8, at least 8,
    at most ``seq_len``): the JAX ``expert_capacity``."""
    raw = capacity_factor * seq_len * experts_per_token / n_experts
    cap = max(8, int(-(-raw // 8) * 8))
    return min(cap, seq_len)


def topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of f32 ``x`` along the last axis
    in ``jax.lax.top_k``'s order: the floats' total order (their bits as
    sign-magnitude integers, so -0.0 < +0.0), the lower index first among
    equal values."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    indices = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, indices), indices


def _group_limit(sel: torch.Tensor, groups: tuple, score: str) -> torch.Tensor:
    """DeepSeek's group-limited top-k (dstack_tpu/models/moe.py:41): the
    experts fall into ``n_group`` groups, and only the best ``topk_group``
    groups stay eligible, the rest zeroed (HF's ``masked_fill(~mask, 0)``,
    a zeroed expert outranking a negative score included). A group's
    score is its best member (softmax, V2) or the sum of its top two
    (sigmoid, V3)."""
    n_group, topk_group = groups
    gs = sel.reshape(*sel.shape[:-1], n_group, sel.shape[-1] // n_group)
    g_score = topk(gs, 2)[0].sum(dim=-1) if score == "sigmoid" else gs.amax(dim=-1)
    gidx = topk(g_score, topk_group)[1]
    gmask = torch.zeros_like(g_score).scatter_(-1, gidx, 1.0)
    return (gs * gmask[..., None]).reshape(sel.shape)


def router(
    x: torch.Tensor,  # [B, T, H] (model dtype)
    w_router: torch.Tensor,  # [H, E]
    n_experts: int,
    experts_per_token: int,
    capacity: int,
    renorm: bool = False,
    sigmoid: bool = False,
    score: str = "softmax",
    groups: tuple = (),
    bias: Optional[torch.Tensor] = None,
    routed_scale: float = 1.0,
    pre_bias: Optional[torch.Tensor] = None,  # gpt-oss linear router bias [E]
    topk_softmax: bool = False,
    expert: Optional[torch.Tensor] = None,  # [B, T, k]: these choices instead of the top-k
    with_aux: bool = False,
) -> tuple:
    """Top-k routing with capacity → (expert [B, T, k] int64, slot
    [B, T, k] int64, combine [B, T, k] in x's dtype). ``combine`` is the
    gate rounded to x's dtype for a kept choice and 0 for a dropped one
    (``slot >= capacity``); JAX's ``dispatch[b, t, e, c]`` is 1 exactly
    where some choice of token t has expert e, slot c and a nonzero
    keep. Logits are f32 products of the model-dtype inputs (JAX's
    ``preferred_element_type=f32``): rounding them to bf16 flips choices.
    With ``expert`` the choices are given (their gates still come from
    these logits): two runs of one model at different precisions can
    then be compared without a near-tie flipping a choice.

    Llama4 (``sigmoid``, dstack_tpu/models/moe.py:105-107): experts are
    chosen by raw logit, as the softmax would choose them, and the gate is
    sigmoid(logit).

    DeepSeek (dstack_tpu/models/moe.py:95-126): ``score="sigmoid"``
    scores each expert by sigmoid(logit) instead of the softmax; ``bias``
    [E] shifts the scores for the choice only (the gates are the unbiased
    scores); ``groups`` limits the choice to the best expert groups
    (:func:`_group_limit`); ``renorm`` divides the gates by their sum (plus
    1e-20 for sigmoid scores, HF V3's epsilon); ``routed_scale``
    multiplies them, in f32, before the cast.

    With ``with_aux`` a fourth element, the Switch aux terms in f32
    (dstack_tpu/models/moe.py:148-156): ``balance = E * sum(frac_tokens *
    frac_probs)``, where ``frac_tokens`` counts each token's first choice
    only and ``frac_probs`` averages the softmax of the logits (whatever
    the score function), and ``z = mean(logsumexp(logits)^2)``."""
    k = experts_per_token
    logits = matmul_f32(x, w_router.to(x.dtype))  # [B, T, E] f32
    if pre_bias is not None:
        logits = logits + pre_bias.float()
    if topk_softmax or sigmoid:  # select by raw logit (gpt-oss, Llama4)
        if expert is None:
            expert = topk(logits, k)[1]
        top = logits.gather(-1, expert)
        # gpt-oss softmaxes over the selected logits; Llama4 takes sigmoid(logit)
        gates = torch.sigmoid(top) if sigmoid else torch.softmax(top, dim=-1)
    else:
        scores = torch.sigmoid(logits) if score == "sigmoid" else torch.softmax(logits, dim=-1)
        if expert is None:
            sel = scores if bias is None else scores + bias.float()
            if groups:
                sel = _group_limit(sel, groups, score)
            expert = topk(sel, k)[1]
        gates = scores.gather(-1, expert)
    if renorm:
        denom = gates.sum(dim=-1, keepdim=True)
        gates = gates / (denom + 1e-20 if score == "sigmoid" else denom)
    if routed_scale != 1.0:
        gates = gates * routed_scale
    # slot of choice j of token t in its expert's buffer: the row's tokens
    # before t with the same choice-j expert, past every assignment of the
    # row's earlier choices (JAX's cumsum(onehot_j) - 1 + used.sum)
    onehot = F.one_hot(expert, n_experts)  # [B, T, k, E]
    per_choice = onehot.sum(dim=1, keepdim=True)  # [B, 1, k, E]
    earlier = per_choice.cumsum(dim=2) - per_choice  # choices before j, whole row
    pos = onehot.cumsum(dim=1) - 1 + earlier  # [B, T, k, E]
    slot = pos.gather(-1, expert[..., None])[..., 0]
    combine = torch.where(slot < capacity, gates, torch.zeros_like(gates)).to(x.dtype)
    if not with_aux:
        return expert, slot, combine
    frac_tokens = F.one_hot(expert[..., 0], n_experts).float().mean(dim=(0, 1))
    frac_probs = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    aux = {
        "balance": n_experts * (frac_tokens * frac_probs).sum(),
        "z": torch.logsumexp(logits, dim=-1).pow(2).mean(),
    }
    return expert, slot, combine, aux


def _oai_glu(g: torch.Tensor, u: torch.Tensor, limit: float) -> torch.Tensor:
    """gpt-oss clamped GLU: (up + 1) * gate * sigmoid(1.702 * gate), gate
    clamped above and up on both sides (moe.py:221-226)."""
    g = g.clamp(max=limit)
    u = u.clamp(-limit, limit)
    return (u + 1.0) * (g * torch.sigmoid(1.702 * g))


def _experts(x: torch.Tensor, layer: dict, name: str) -> torch.Tensor:
    """The batched expert product x [E, M, K] · ``layer[name]`` [E, K, N],
    or with the int8 stack (``{name}_q`` and its scales ``{name}_s`` [E,
    N], models/quant.py) W8's expert form: each output channel scaled
    before any expert bias, as JAX's ``qw`` products (moe.py:183-232)."""
    w = layer.get(name)
    if w is not None:
        return torch.matmul(x, w)
    return w8_matmul.w8_experts(x, layer[f"{name}_q"], layer[f"{name}_s"])


def moe_mlp(
    x: torch.Tensor,  # [B, T, H]: the normed hidden states
    layer: dict,  # w_router [H,E], w_gate/w_up [E,H,F], w_down [E,F,H] (+ biases)
    n_experts: int,
    experts_per_token: int,
    capacity_factor: float,
    renorm: bool = False,
    sigmoid_input: bool = False,  # Llama4: the sigmoid gate scales the expert input
    score: str = "softmax",  # DeepSeek-V3: "sigmoid" scores
    groups: tuple = (),  # DeepSeek (n_group, topk_group)
    routed_scale: float = 1.0,  # DeepSeek's routed_scaling_factor
    topk_softmax: bool = False,
    act: str = "silu",  # "silu" SwiGLU | "oai_glu" gpt-oss clamped glu
    act_limit: float = 7.0,
    return_aux: bool = False,
):
    """Sparse FFN → [B, T, H] in x's dtype, or with ``return_aux`` →
    (that, the router's aux terms: :func:`router`'s ``with_aux``). Expert products in x's dtype
    (each a matmul with f32 accumulation), biases added in that dtype,
    the k weighted expert outputs summed in f32 and rounded once, as
    JAX's combine einsum does. A layer with ``w_shared_gate`` adds the
    dense shared expert (a SwiGLU MLP of plain products) to every token
    (DeepSeek, dstack_tpu/models/moe.py:238); with ``router_bias`` the
    router selects with DeepSeek's bias. With ``sigmoid_input`` (Llama4,
    where JAX swaps dispatch and combine, moe.py:199-202) a kept choice's
    gate, rounded to x's dtype, scales the token row it scatters before
    the expert FFN, and the expert outputs come back unweighted (still
    summed in f32 and rounded once); a dropped choice contributes
    nothing either way."""
    if act not in ("silu", "oai_glu"):
        raise ValueError(f"moe_mlp: unknown act {act!r}")
    b, t, h = x.shape
    e, k = n_experts, experts_per_token
    cap = expert_capacity(t, e, k, capacity_factor)
    expert, slot, combine, *aux = router(
        x, layer["w_router"], e, k, cap, renorm=renorm, sigmoid=sigmoid_input, score=score, groups=groups,
        bias=layer.get("router_bias"), routed_scale=routed_scale,
        pre_bias=layer.get("b_router"), topk_softmax=topk_softmax, with_aux=return_aux,
    )
    # flat row of each choice in [E, B, C]; a dropped choice goes to the
    # extra row E*B*C (zeros in, discarded out)
    bi = torch.arange(b, device=x.device)[:, None, None]
    keep = slot < cap
    dump = e * b * cap
    row = torch.where(keep, (expert * b + bi) * cap + slot.clamp(max=cap - 1), dump)
    rows = x[:, :, None, :].expand(b, t, k, h)
    if sigmoid_input:  # the gate on the dispatch side: the expert input is g·x
        rows = rows * combine[..., None]
    xe = x.new_zeros(dump + 1, h)
    xe.index_copy_(0, row.reshape(-1), rows.reshape(-1, h))
    xe = xe[:dump].view(e, b * cap, h)
    g = _experts(xe, layer, "w_gate")  # [E, B*C, F]
    u = _experts(xe, layer, "w_up")
    if "b_gate" in layer:  # gpt-oss expert biases [E, F]
        g = g + layer["b_gate"][:, None, :].to(g.dtype)
        u = u + layer["b_up_e"][:, None, :].to(u.dtype)
    inner = _oai_glu(g, u, act_limit) if act == "oai_glu" else F.silu(g) * u
    y = _experts(inner, layer, "w_down")  # [E, B*C, H]
    if "b_down_e" in layer:
        y = y + layer["b_down_e"][:, None, :].to(y.dtype)
    y = torch.cat([y.reshape(dump, h), y.new_zeros(1, h)])
    picked = y.index_select(0, row.reshape(-1)).view(b, t, k, h)
    # a dropped choice picked the zero row; with sigmoid_input the combine is unweighted
    weighted = picked.float() if sigmoid_input else picked.float() * combine.float()[..., None]
    out = weighted.sum(dim=2).to(x.dtype)
    if "w_shared_gate" in layer or "w_shared_gate_q" in layer:
        inner = F.silu(_proj(layer, "w_shared_gate", x)) * _proj(layer, "w_shared_up", x)
        out = out + _proj(layer, "w_shared_down", inner)
    return (out, aux[0]) if return_aux else out
