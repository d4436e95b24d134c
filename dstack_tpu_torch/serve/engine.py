"""KV-cache inference engine on PyTorch for dense Llama, the dense
families at head_dim 128 (Qwen2/3, Mistral, StarCoder2, Nemotron,
Command-R, OLMo-2, GLM-4, Granite), gpt-oss, Gemma, DeepSeek's MLA,
Mixtral, Qwen3-MoE, Llama4 and Cohere2 (counterpart of
dstack_tpu.serve.engine).

The engine owns a fixed pool of ``max_batch`` sequence slots over
preallocated KV caches ``[L, B, Hkv, T_max, D]``; a request prefills its
prompt chunk by chunk into a free slot, and every decode step advances
all active slots at once (continuous batching). Where the JAX engine
donates the cache buffers to its jitted steps (dstack_tpu/serve/
engine.py:1880) so XLA updates them in place, the port writes the cache
tensors in place and hands the same dict back.

Attention runs through the port's hand-written Hopper kernels on the
card: every serial prefill chunk through the flash forward kernel
(ops/flash.py), and the cache attention of every decode step, turbo
macro-step and speculative verify through the ragged flash-decode kernel
(ops/flash_decode.py). A packed prefill wave attends through the masked
attention with per-row offsets, as JAX's does. On the CPU the kernels
take their plain versions, which is what the parity tests run.

gpt-oss runs through the same functions: per-layer windows from
``layer_windows``, q/k/v and output biases, attention sinks (K1 with the
exact σ(lse - sink) rescale in a serial chunk, the sinks form of K4 at
decode and verify, ``sink_softmax`` on the plain paths) and the sparse
MoE MLP (``models/moe.py``) wherever a layer carries ``w_router``. So
does the Gemma family, at head_dim 256: each layer's rope picked by its
window (``layer_rope``: Gemma3's sliding layers rotate at the local
theta), q/k norms before rope, the attention softcap inside K1, K4 and
the masked attention, sandwich norms on both sublayers' outputs, the
sqrt(H) embedding scale and the final-logit cap. DeepSeek's MLA caches
one latent row a token (``ckv``, 576 values on V2-Lite) and attends in
the absorbed form: a serial chunk through K1's MLA entry
(``flash_mla_with_lse``) over the slot's latent row, a packed wave
through the masked attention, decode and verify through plain products
over the row, as JAX's einsums do;
its MoE layers add DeepSeek's router deltas and shared expert after a
dense prelude. The dense families' deltas live in the model's layer
pieces, which every step calls (``_attn_input``, ``_qkv_heads``,
``_attn_out``, ``_residual``): the LayerNorm flavours, Cohere's parallel
block, OLMo-2's post-norm-only layers, the gateless MLPs and biases, and
Granite's multipliers; the rope's convention (interleaved for Cohere and
GLM) and its partial split (GLM, Nemotron) ride every rope applier. They
take K1's and K4's D = 128 forms at their GQA groups (1 to 16). So do the
remaining families': the softmax-routed MoE (Mixtral, Qwen3-MoE), Llama4's
NoPE layers (no rope, a query temperature read from the positions
tensors), L2 q/k norm after rope, chunk masks (K1 where every query of a
chunk lies in the first attention chunk, the masked attention beyond it,
the einsum at decode and verify: a chunked config routes there by
default, as JAX's engine does, since no kernel takes the mask) and
sigmoid-input router, Cohere2's NoPE global layers, and DeepSeek-V3's MLA
at 128 heads (K1's D = 576 form in 64-head groups).

The engine runs the JAX engine's default configuration: packed
multi-slot prefill (``prefill_pack``), prompt-lookup speculative decoding
(``spec_draft``), device-side greedy macro-steps (``turbo_steps``), the
chunk-aligned prefix cache, and the optional int8 KV cache
(``kv_quant="int8"``). A request that asks for token logprobs
(``GenParams.logprobs``) takes the plain step, as in JAX: the speculative,
turbo and argmax paths never compute them.

Every step runs as the JAX engine's compiled step functions do: on the
decode side each of ``decode``, ``verify``, ``sample``, ``argmax``,
``advance_state``, ``logprobs``, ``mark_seen`` and ``skip_key``, and
``turbo`` (``decode_loop``) once per power-of-two ``steps``; on the
prefill side ``chunk`` per (C, start), ``packed`` per (G, C), ``copy``
per prefix length and ``mark_prompt``, is a step site
(``serve/graphs.py``): a CUDA graph captured on a variant's first call
and replayed after that, the same function run eagerly on the CPU, or on
the card with ``graphs=False`` (the graphs' reference). K1 runs inside
the chunk graphs. A site's varying scalars (a slot, an index, a prompt
length) are ``[1]`` device tensors, as JAX traces them, so that a graph
replays at any slot; only the static key is a Python int. The sites read
the engine's fixed buffers in place: the cache, the device mirrors of
the slot state and of the sampling parameters (rewritten with ``copy_``
after a host mutation), the seen-token counts, the logit bias and the
per-slot key data. Sampling is one batched draw: Gumbel noise hashed
from each slot's (seed, draw counter) and the vocab index in plain
integer ops (:func:`draw_bits`), where JAX splits a threefry key a slot.
Each site's first call of a variant counts as a compile in the flight
recorder (``obs/flight.py``), which feeds the compile families; the
server's warmup marks the engine warm
(:meth:`InferenceEngine.mark_flight_warm`).

Telemetry is recorded at the source, as in JAX: the engine's
``metrics`` registry (``serve/metrics.py``) takes TTFT at activation,
each emitting step's seconds, tokens, TPOT and tokens/s, prefill
dispatches with their pack rows, and prefix hits, from the same clock
readings as ``stats``, so the two cannot disagree. The server renders the
registry on ``/metrics`` and the bench (``serve/bench.py``) reads it.
"""

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from dstack_tpu_torch import faults
from dstack_tpu_torch.models.llama import (
    LlamaConfig,
    _attn_input,
    _attn_out,
    _embed_lookup,
    _head_logits,
    _mla_latents,
    _mla_q,
    _position_qk,
    _qkv_heads,
    _residual,
    apply_rope,
    attn_temp_scales,
    check_layer_layout,
    dual_rope_freqs,
    layer_nope,
    layer_params,
    layer_rope,
    layer_stack,
    layer_windows,
    model_norm,
    rotate,
)
from dstack_tpu_torch.models.moe import topk
from dstack_tpu_torch.ops.attention import attention
from dstack_tpu_torch.ops.flash import flash_mla_plain, flash_mla_with_lse, mla_value
from dstack_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_plain,
    flash_decode_supported,
    kv_dequant,
)
from dstack_tpu_torch.obs import boot as obs_boot
from dstack_tpu_torch.obs import flight
from dstack_tpu_torch.serve.graphs import GraphSet
from dstack_tpu_torch.serve.metrics import new_serve_registry
from dstack_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.engine")

NEG_INF = -1e30


def bias_row(logit_bias: Optional[dict], vocab_size: int) -> torch.Tensor:
    """An OpenAI ``logit_bias`` as the f32 row the sampler adds, on the
    host: JAX's loop (ids outside the vocabulary skipped, a later key of
    one id wins), written in one indexed store. A store per entry costs
    ~6 us on the host: 0.8 s for the soak's 128,128-entry ASCII bias.
    Int keys (the server's ``GenParams``), one id each, convert in bulk:
    the loop took 40-60 ms of the H100 machine's host for that bias
    (ROADMAP B16)."""
    row = torch.zeros((vocab_size,), dtype=torch.float32)
    if not logit_bias:
        return row
    ids, n = None, len(logit_bias)
    if all(type(t) is int for t in logit_bias):
        try:
            ids = np.fromiter(logit_bias, dtype=np.int64, count=n)
        except OverflowError:  # an id past int64: the loop below skips it
            pass
    if ids is not None:
        vals = np.fromiter(map(float, logit_bias.values()), dtype=np.float64, count=n)
        keep = (ids >= 0) & (ids < vocab_size)
        row[torch.from_numpy(ids[keep])] = torch.from_numpy(vals[keep]).to(torch.float32)
        return row
    bias = {}
    for tid, bv in logit_bias.items():
        t = int(tid)
        if 0 <= t < vocab_size:
            bias[t] = float(bv)
    if bias:
        row[torch.tensor(list(bias), dtype=torch.long)] = torch.tensor(list(bias.values()), dtype=torch.float32)
    return row


def default_decode_kernel(config: LlamaConfig, max_seq: int) -> Optional[str]:
    """The ``decode_kernel`` a caller passes for the engine's default:
    None (K4, or MLA's latent products) where K4 takes the model, else
    "einsum" (K4 has no form for llama-tiny's head width, for one)."""
    if config.mla or flash_decode_supported(config, max_seq):
        return None
    return "einsum"


def resolve_device(device) -> torch.device:
    """The port's entry points run on ``cuda`` unless the caller asks for
    ``cpu``; a missing CUDA device raises instead of quietly running the
    plain versions on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU; pass "
            "device='cpu' (or --device cpu) to run its plain versions on "
            "the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class GenParams:
    max_new_tokens: int = 256
    temperature: float = 0.0  # 0 = greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 = off
    repetition_penalty: float = 1.0  # HF-style multiplicative; 1 = off
    presence_penalty: float = 0.0  # OpenAI additive: once-seen tokens
    frequency_penalty: float = 0.0  # OpenAI additive: per occurrence
    min_p: float = 0.0  # mask tokens with p < min_p * p_max (0 = off)
    logit_bias: Optional[dict] = None  # {token_id: bias in [-100, 100]}
    seed: Optional[int] = None  # per-request sampling seed
    # resumable generation: advance the seeded stream by this many draws
    # before the first sample (ignored when seed is None)
    seed_skip: int = 0
    eos_id: Optional[int] = None
    stop: Optional[list] = None  # stop strings (matched by the server)
    # None = off; n >= 0 = collect logprobs with n alternatives (<= 5)
    logprobs: Optional[int] = None
    # the request's trace id (the server's root span): the TTFT and TPOT
    # histograms attach it as the exemplar of the bucket it lands in
    trace_id: Optional[str] = None


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] → (int8 values, per-vector f32 scale [...]): symmetric
    absmax per (token, head) vector, the scale floored at 1e-8. The
    division is ``x / s`` and ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the int8 values match the JAX ones exactly."""
    x32 = x.float()
    s = torch.clamp_min(x32.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


# Quantized caches travel through the compute paths as (int8, scale)
# tuples of one layer's views in place of the plain tensor (JAX's tuple
# leaves); only the write/read helpers below branch on them.


def init_cache(
    config: LlamaConfig, max_batch: int, max_seq: int, device="cuda", kv_quant=None
) -> dict:
    """Preallocated KV cache: k/v ``[L, B, Hkv, T_max, D]`` in the model
    dtype, or (``kv_quant="int8"``) int8 with f32 per-(token, head)
    scales ``k_s``/``v_s`` ``[L, B, Hkv, T_max]``: half the bytes a
    decode step reads. The ``k_s`` key is what the compute paths branch
    on.

    MLA (DeepSeek): one latent tensor ``ckv`` ``[L, B, T_max,
    kv_lora_rank + qk_rope_head_dim]`` in the model dtype, the shared
    compressed latent beside the rope key, in place of per-head K/V
    (dstack_tpu/serve/engine.py:219): 576 values a token and layer on
    DeepSeek-V2, against 16 heads x (192 + 128). It takes no int8 form."""
    if config.mla:
        if kv_quant:
            raise ValueError(
                "kv_quant does not combine with MLA (the latent cache is already the compression)"
            )
        shape = (config.n_layers, max_batch, max_seq, config.kv_lora_rank + config.qk_rope_head_dim)
        return {"ckv": torch.zeros(shape, dtype=config.dtype, device=device)}
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    shape = (config.n_layers, max_batch, config.n_kv_heads, max_seq, config.head_dim)
    dt = torch.int8 if kv_quant else config.dtype
    cache = {n: torch.zeros(shape, dtype=dt, device=device) for n in ("k", "v")}
    if kv_quant:
        for n in ("k_s", "v_s"):
            cache[n] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _cache_layer(cache: dict, i: int) -> tuple:
    """Layer ``i``'s (ck, cv): views of the cache tensors, or (int8,
    scale) view pairs for the int8 cache (``_cache_pack`` for one layer).
    Writes through them land in the cache."""
    if "k_s" in cache:
        return (cache["k"][i], cache["k_s"][i]), (cache["v"][i], cache["v_s"][i])
    return cache["k"][i], cache["v"][i]


def _slot_ix(slot, b: int, device) -> torch.Tensor:
    """A slot as the ``[1]`` long index the cache helpers take, clamped to
    ``[0, b)`` as ``lax.dynamic_slice`` clamps it: on the device for a
    tensor (the step sites' traced scalars, never read on the host), on
    the host for an int (a caller outside the sites)."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).long().clamp(0, b - 1)
    return torch.tensor([min(max(int(slot), 0), b - 1)], dtype=torch.long, device=device)


def _cwrite_chunk(ckv, new: torch.Tensor, slot, start: int):
    """Write a prefill chunk ``new [1, H, C, D]`` at (slot, start) in
    place. ``slot`` is an int, or a ``[1]`` long tensor already clamped
    (:func:`_slot_ix`); ``start`` is static. ``lax.dynamic_update_slice``
    CLAMPS an out-of-range start so the slice fits; torch slicing would
    silently shorten the write, so the clamp is explicit (the engine keeps
    ``start + C <= T_max``)."""
    if isinstance(ckv, tuple):
        q, s = kv_quantize(new)
        _cwrite_chunk(ckv[0], q, slot, start)
        _cwrite_chunk(ckv[1], s, slot, start)
        return ckv
    b, t, c = ckv.shape[0], ckv.shape[2], new.shape[2]
    if not isinstance(slot, torch.Tensor):
        slot = _slot_ix(slot, b, ckv.device)
    start = min(max(int(start), 0), t - c)
    ckv[:, :, start : start + c].index_copy_(0, slot, new.to(ckv.dtype))
    return ckv


def _cread_row(ckv, slot, dtype) -> torch.Tensor:
    """One slot's row ``[1, H, T_max, D]`` in the compute dtype: a gather
    (a copy) at an int slot or at a ``[1]`` long tensor already clamped
    (:func:`_slot_ix`)."""
    if isinstance(ckv, tuple):
        return kv_dequant(_cread_row(ckv[0], slot, dtype), _cread_row(ckv[1], slot, dtype), dtype)
    if not isinstance(slot, torch.Tensor):
        slot = _slot_ix(slot, ckv.shape[0], ckv.device)
    return ckv.index_select(0, slot)


def _row_at(x: torch.Tensor, ix) -> torch.Tensor:
    """``x [1, C, E]`` at the chunk index ``ix`` (an int or a ``[1]``
    tensor) → ``[1, E]``, as ``jnp.take_along_axis`` takes it: a negative
    index counts from the end, one out of range gives NaN. No host read."""
    c = x.shape[1]
    ix = torch.as_tensor(ix, device=x.device).reshape(1).long()
    ix = torch.where(ix < 0, ix + c, ix)
    row = x.index_select(1, ix.clamp(0, c - 1))[:, 0]
    ok = (ix >= 0) & (ix < c)
    return torch.where(ok[:, None], row, torch.full_like(row, float("nan")))


def _cread_rows(ckv, slots: torch.Tensor, dtype) -> torch.Tensor:
    """Gather ``slots``' rows ``[G, H, T_max, D]`` in the compute dtype
    (packed prefill: G concurrent prompt chunks attend over their own
    rows)."""
    if isinstance(ckv, tuple):
        return kv_dequant(ckv[0].index_select(0, slots), ckv[1].index_select(0, slots), dtype)
    return ckv.index_select(0, slots)


def _cwrite_at(ckv, batch_ix: torch.Tensor, write_pos: torch.Tensor, new: torch.Tensor):
    """Scatter per-slot tokens in place: ``new [B, H, D]`` at ``[B]``
    positions, or ``[B, S, H, D]`` at ``[B, S]`` positions (speculative
    verify, packed prefill). JAX's ``mode="drop"`` discards entries whose
    position is out of range; torch indexing would raise or wrap, so
    those entries write a value that is already due at their redirected
    index instead — no device-to-host sync for a mask."""
    if isinstance(ckv, tuple):
        q, s = kv_quantize(new)
        _cwrite_at(ckv[0], batch_ix, write_pos, q)
        _cwrite_at(ckv[1], batch_ix, write_pos, s)
        return ckv
    t = ckv.shape[2]
    new = new.to(ckv.dtype)
    if new.dim() == ckv.dim() - 1:
        # one entry per slot: a dropped row writes its own old value back
        valid = (write_pos >= 0) & (write_pos < t)
        pos = torch.where(valid, write_pos, torch.zeros_like(write_pos)).long()
        old = ckv[batch_ix, :, pos]  # [B, H, (D)]
        keep = valid.view(-1, *([1] * (new.dim() - 1)))
        ckv[batch_ix, :, pos] = torch.where(keep, new, old)
        return ckv
    # S entries per slot: a dropped entry could share its redirected index
    # with a kept one, and duplicate indices must carry equal values. So
    # every dropped entry repeats the first kept entry's write (index and
    # value); when none is kept, all of them write one old value back
    bi = batch_ix[:, None].expand_as(write_pos).reshape(-1)
    wp = write_pos.reshape(-1).long()
    vals = new.reshape(-1, *new.shape[2:])  # [N, H, (D)]
    valid = (wp >= 0) & (wp < t)
    # the first kept entry, else 0, as a [1] index: indexing with a 0-d
    # tensor would read it on the host (a sync, which breaks a capture)
    donor = valid.to(torch.int32).argmax().view(1)
    bi = torch.where(valid, bi, bi.index_select(0, donor))
    wp = torch.where(valid, wp, wp.index_select(0, donor)).clamp(0, t - 1)
    shape = (-1, *([1] * (vals.dim() - 1)))
    vals = torch.where(valid.view(shape), vals, vals.index_select(0, donor))
    vals = torch.where(valid.index_select(0, donor).view(shape), vals, ckv[bi, :, wp])
    ckv[bi, :, wp] = vals
    return ckv


def _cfull(ckv, dtype) -> torch.Tensor:
    """The whole cache tensor in the compute dtype (the einsum paths;
    bf16 cache: itself)."""
    if isinstance(ckv, tuple):
        return kv_dequant(ckv[0], ckv[1], dtype)
    return ckv


def copy_cache_prefix(cache: dict, src, dst, *, p: int) -> dict:
    """Copy the first ``p`` cached positions of slot ``src`` into slot
    ``dst`` in place, for every cache tensor (k/v and the int8 scales:
    the token axis is the fourth; MLA's latent ``ckv``: the third):
    prefix caching, a new request whose prompt shares a prefix with an
    already-cached sequence skips prefilling it. ``p`` is static; ``src``
    and ``dst`` are ints or ``[1]`` long tensors (JAX's traced scalars,
    clamped on the device as ``dynamic_index_in_dim`` and
    ``dynamic_update_slice`` clamp them), so one site serves every pair
    of slots."""
    for name, a in cache.items():
        b = a.shape[1]
        s, d = (_slot_ix(x, b, a.device) for x in (src, dst))
        head = a.narrow(2 if name == "ckv" else 3, 0, p)  # [L, B, (H,) p, ...]
        head.index_copy_(1, d, head.index_select(1, s))
    return cache


def _common_prefix_len(a: list, b: list) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


# ---------------------------------------------------------------------------
# model: prefill + single-token decode over the cache
# ---------------------------------------------------------------------------


def _apply_rope_batch(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      interleaved: bool = False) -> torch.Tensor:
    """x [B, H, 1, D]; cos/sin [B, rope_dim/2] (per-slot positions), cast
    to x's dtype before the multiply; rotate-half, or interleaved (MLA,
    Cohere, GLM); narrower cos/sin rotate only the leading dims (GLM,
    Nemotron: ``rotate``'s partial split)."""
    return rotate(x, cos[:, None, None, :].to(x.dtype), sin[:, None, None, :].to(x.dtype), interleaved)


def _rope_rows(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """Rope with per-(row, step) angles: t ``[B, Hh, S, D]``, cos/sin
    ``[B, S, rope_dim/2]`` — the grid form wherever rows sit at unequal
    positions (speculative verify at width S, packed prefill at width C).
    Rotate-half, or interleaved (MLA's rope is always interleaved; Cohere's
    and GLM's by the config), partial where cos/sin are narrower."""
    return rotate(t, cos[:, None].to(t.dtype), sin[:, None].to(t.dtype), interleaved)


def _scan_layers_kv(params: dict, cache: dict, x: torch.Tensor, one_layer, c: LlamaConfig):
    """Drive ``one_layer(x, layer, ck, cv, window, nope) -> x`` over the
    layers (the Python loop where JAX runs ``lax.scan``) with each layer's
    window from ``layer_windows`` and NoPE flag from ``layer_nope``
    (refusing the layouts JAX's ``grouped_scan_layout`` refuses);
    ``ck``/``cv`` are the layer's cache views (or int8 view pairs),
    updated in place → (final hidden, cache)."""
    check_layer_layout(c)
    for i, (window, nope) in enumerate(zip(layer_windows(c), layer_nope(c))):
        ck, cv = _cache_layer(cache, i)
        x = one_layer(x, layer_params(params, i), ck, cv, window, nope)
    return x, cache


def _prefill_one_layer(c: LlamaConfig, ropes: tuple, *, rope_apply, kv_update, q_offset, temp_apply=None,
                       impl=None):
    """The dense prefill attention + MLP sublayer shared by the serial
    chunk and the packed multi-slot forms, which differ only in the rope
    application, the NoPE temperature's broadcast, the cache write/read
    and the causal offset (an int, or a ``[G]`` tensor of per-row
    starts). ``ropes`` is the
    (global, local) pair of :func:`dual_rope_freqs`: each layer takes
    its own by its window. Every family delta lives in the model's layer
    pieces (the input norm, the projections and q/k norms, the rope's
    convention, the output, the residual add), so it exists once for both
    forms (JAX's ``one_layer``, engine.py:761-809)."""
    scale = c.attention_scale

    def one_layer(x, layer, ck, cv, window, nope=False):
        b, cl = x.shape[0], x.shape[1]
        cos, sin = layer_rope(ropes, c, window)
        q, k, v = _qkv_heads(_attn_input(x, layer, c), layer, c)
        q, k = _position_qk(q, k, c, nope, lambda t: rope_apply(t, cos, sin, interleaved=c.rope_interleaved),
                             temp_apply)
        # write the chunk K/V into the slot rows, then attend over the
        # whole rows: keys past each causal frontier are masked (and the
        # kernel never reads their tiles), so stale data is never used
        row_k, row_v = kv_update(ck, cv, k, v)
        # serving never differentiates: a sinks model rides K1 with the
        # exact σ(lse - sink) rescale in a serial chunk
        o = attention(
            q.contiguous(), row_k, row_v, causal=True, scale=scale,
            q_offset=q_offset, window=window, softcap=c.attn_softcap, impl=impl,
            chunk=0 if nope else c.attention_chunk_size,
            sinks=layer["sinks"] if c.attn_sinks else None, sinks_forward_only=True,
        )
        o = o.transpose(1, 2).reshape(b, cl, c.q_dim)
        return _residual(x, _attn_out(o, layer, c), layer, c)

    return one_layer


def prefill_chunk_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [1, C] int (right-padded on the last chunk)
    slot,  # [1] long tensor (an int from a caller outside the engine's sites)
    last_ix,  # [1] long tensor (or int): the prompt's last real index MINUS start
    config: LlamaConfig,
    *,
    start: int,  # static: global position of the chunk's first token
    impl: Optional[str] = None,  # attention impl: None = by device | "plain"
) -> tuple[torch.Tensor, dict]:
    """One prompt chunk → (f32 logits at ``last_ix`` [1, V], cache).

    The chunk's K/V are written into the slot's cache row first, then
    the chunk queries attend over the row with causal masking at the
    offset ``start`` — the flash kernel's ``q_offset``. ``slot`` and
    ``last_ix`` are device scalars, as JAX traces them: a CUDA graph of
    the function replays at any slot and index, with no host read (the
    slot clamped as ``dynamic_update_slice`` clamps it, the row taken as
    :func:`_row_at` takes it). An MLA config takes
    :func:`_prefill_chunk_mla`."""
    c = config
    if c.mla:
        return _prefill_chunk_mla(params, cache, tokens, slot, last_ix, c, start=start, impl=impl)
    x = _embed_lookup(params, tokens, c)
    chunk_pos = start + torch.arange(tokens.shape[1], device=tokens.device)
    si = _slot_ix(slot, cache["k"].shape[1], tokens.device)

    def kv_update(ck, cv, k, v):
        _cwrite_chunk(ck, k, si, start)
        _cwrite_chunk(cv, v, si, start)
        return _cread_row(ck, si, k.dtype), _cread_row(cv, si, v.dtype)

    one_layer = _prefill_one_layer(
        c, dual_rope_freqs(c, chunk_pos), rope_apply=apply_rope,
        temp_apply=lambda q: q * attn_temp_scales(chunk_pos, c)[None, None, :, None].to(q.dtype),
        kv_update=kv_update, q_offset=int(start), impl=impl,
    )
    x, cache = _scan_layers_kv(params, cache, x, one_layer, c)
    x = model_norm(x, params["final_norm"], c)
    return _head_logits(params, _row_at(x, last_ix), c), cache


def prefill_packed_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [G, C] int chunk rows (right-padded)
    slots: torch.Tensor,  # [G] int cache rows (distinct per real row)
    starts: torch.Tensor,  # [G] int per-row global start positions
    last_ix: torch.Tensor,  # [G] int last real index minus start; -1 = pad row
    config: LlamaConfig,
) -> tuple[torch.Tensor, dict]:
    """Packed multi-slot prefill: G prompt chunks, one dispatch →
    (per-row f32 logits at ``last_ix`` [G, V], cache).

    :func:`prefill_chunk_step` generalised from ``[1, C]`` at one start
    to ``[G, C]`` at per-row starts: rope angles from the position grid,
    cache writes that drop padding and pad rows (``last_ix = -1``), and
    per-row causal frontiers through the masked attention with a vector
    ``q_offset`` (no flash kernel tiles per-row offsets, on the TPU or
    here). An MLA config takes :func:`_prefill_packed_mla`."""
    c = config
    if c.mla:
        return _prefill_packed_mla(params, cache, tokens, slots, starts, last_ix, c)
    g, cl = tokens.shape
    x = _embed_lookup(params, tokens, c)
    ar = torch.arange(cl, device=tokens.device)
    pos_grid = starts[:, None] + ar[None, :]  # [G, C]
    ropes = tuple(
        (cos.reshape(g, cl, -1), sin.reshape(g, cl, -1))
        for cos, sin in dual_rope_freqs(c, pos_grid.reshape(-1))
    )
    si = slots.long()
    tmax = cache["k"].shape[3]
    # positions past each row's real tokens (padding, pad rows) drop
    valid = ar[None, :] <= last_ix[:, None]
    write_pos = torch.where(valid, pos_grid, torch.full_like(pos_grid, tmax))

    def kv_update(ck, cv, k, v):
        # scatter each row's chunk K/V at its own positions, then gather
        # the packed rows for attention
        _cwrite_at(ck, si, write_pos, k.transpose(1, 2))
        _cwrite_at(cv, si, write_pos, v.transpose(1, 2))
        return _cread_rows(ck, si, k.dtype), _cread_rows(cv, si, v.dtype)

    one_layer = _prefill_one_layer(
        c, ropes, rope_apply=_rope_rows,
        temp_apply=lambda q: q * attn_temp_scales(pos_grid, c)[:, None, :, None].to(q.dtype),
        kv_update=kv_update, q_offset=starts,
    )
    x, cache = _scan_layers_kv(params, cache, x, one_layer, c)
    x = model_norm(x, params["final_norm"], c)
    last = x[torch.arange(g, device=x.device), last_ix.clamp_min(0).long()]  # [G, E]
    return _head_logits(params, last, c), cache


def _row_sinks(layer: dict, c: LlamaConfig, rows_per_slot: int) -> Optional[torch.Tensor]:
    """The layer's [H] sink leaf expanded to K4's [Hkv, G * S] rows: row
    g*S + s carries group g's sink (dstack_tpu/serve/engine.py:1037-1042);
    None for a model without sinks."""
    if not c.attn_sinks:
        return None
    grp = c.n_heads // c.n_kv_heads
    snk = layer["sinks"].float().view(c.n_kv_heads, grp, 1)
    return snk.expand(c.n_kv_heads, grp, rows_per_slot).reshape(c.n_kv_heads, grp * rows_per_slot)


def _attend_cache(q_rows, ck, cv, positions, window, *, config, scale, rows_per_slot,
                  sinks, decode_kernel, nope=False):
    """The cache attention of decode_step (one row group a slot) and
    verify_step (``rows_per_slot`` = S), with the config's softcap: the
    ragged kernel with the int8 tuple unpacked into values and scales
    (the ``mesh=None`` form of the JAX ``_flash_attend``), or with
    ``decode_kernel="einsum"`` the plain masked attention over the whole
    (dequantized) row, with Llama4's chunk mask on a rope layer (a
    chunked config never routes to the kernel: ``flash_decode_supported``)."""
    softcap = config.attn_softcap
    if decode_kernel != "flash":
        dtype = q_rows.dtype
        return flash_decode_plain(
            q_rows, _cfull(ck, dtype), _cfull(cv, dtype), positions, scale=scale,
            window=window, softcap=softcap, rows_per_slot=rows_per_slot, sinks=sinks,
            chunk=0 if nope else config.attention_chunk_size,
        )
    kq, ks = ck if isinstance(ck, tuple) else (ck, None)
    vq, vs = cv if isinstance(cv, tuple) else (cv, None)
    return flash_decode(
        q_rows, kq, vq, positions, scale=scale, window=window, softcap=softcap,
        k_scale=ks, v_scale=vs, rows_per_slot=rows_per_slot, sinks=sinks,
    )


def decode_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [B] int: the freshly sampled tokens
    positions: torch.Tensor,  # [B] int32: where to write (== current length)
    config: LlamaConfig,
    write_mask: Optional[torch.Tensor] = None,  # [B] bool: rows allowed to write K/V
    decode_kernel: str = "flash",  # "flash" (ops/flash_decode) | "einsum" (plain)
) -> tuple[torch.Tensor, dict]:
    """One token for every slot → (f32 logits [B, V], cache).

    ``write_mask`` guards the cache writes: an inactive row (finished,
    or mid-prefill for another request) must not scribble stale K/V
    into its slot. ``decode_kernel="einsum"`` runs the plain masked
    attention over the full (dequantized) row — the reference the kernel
    is held to. An MLA config takes :func:`_decode_step_mla`, which
    reads no ``decode_kernel``."""
    c = config
    b = tokens.shape[0]
    positions = positions.to(torch.int32)
    if write_mask is None:
        write_mask = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    if c.mla:
        return _decode_step_mla(params, cache, tokens, positions, c, write_mask)
    t_max = cache["k"].shape[3]
    # out-of-range positions drop the write (_cwrite_at)
    write_pos = torch.where(write_mask, positions, torch.full_like(positions, t_max))
    x = _embed_lookup(params, tokens, c)[:, None, :]
    ropes = dual_rope_freqs(c, positions)  # [B, D/2] pairs: global, local
    batch_ix = torch.arange(b, device=tokens.device)
    scale = c.attention_scale
    grp = c.n_heads // c.n_kv_heads
    # the NoPE temperature from the positions tensor: a graph replays it
    temp = attn_temp_scales(positions, c)[:, None, None, None] if c.attn_temp_scale else None

    for i, (window, nope) in enumerate(zip(layer_windows(c), layer_nope(c))):
        layer = layer_params(params, i)
        ck, cv = _cache_layer(cache, i)  # [B, Hkv, Tmax, D] views (or int8 pairs)
        cos, sin = layer_rope(ropes, c, window)
        q, k, v = _qkv_heads(_attn_input(x, layer, c), layer, c)
        q, k = _position_qk(q, k, c, nope, lambda t: _apply_rope_batch(t, cos, sin, c.rope_interleaved),
                             lambda q: q * temp.to(q.dtype))
        _cwrite_at(ck, batch_ix, write_pos, k[:, :, 0, :])
        _cwrite_at(cv, batch_ix, write_pos, v[:, :, 0, :])
        # q regrouped [B, Hkv, G, D] against the [B, Hkv, T, D] cache:
        # the cache is read once at KV width, never G times
        qg = q[:, :, 0, :].reshape(b, c.n_kv_heads, grp, c.head_dim).contiguous()
        o = _attend_cache(
            qg, ck, cv, positions, window, config=c, scale=scale, rows_per_slot=1,
            sinks=_row_sinks(layer, c, 1), decode_kernel=decode_kernel, nope=nope,
        )
        # [B, Hkv, G, D] row-major flatten == query-head order
        o = o.reshape(b, 1, c.q_dim)
        x = _residual(x, _attn_out(o, layer, c), layer, c)
    x = model_norm(x, params["final_norm"], c)
    return _head_logits(params, x[:, 0], c), cache


def verify_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [B, S] int: last sampled token + S-1 draft tokens
    positions: torch.Tensor,  # [B] int32: each row's current length (pos of tokens[:, 0])
    config: LlamaConfig,
    write_mask: torch.Tensor,  # [B] bool
    decode_kernel: str = "flash",
) -> tuple[torch.Tensor, dict]:
    """Multi-token decode for speculative verification → (f32 logits
    [B, S, V], cache).

    :func:`decode_step` generalised to S tokens a row at per-row
    positions: one call verifies S-1 drafted tokens, costing about S
    decode steps' compute but replacing up to S steps when the drafts are
    accepted. K/V written at rejected positions is garbage until the
    real tokens decode over it, the masked-future invariant padding
    relies on. An MLA config takes :func:`_verify_step_mla`."""
    c = config
    b, sdraft = tokens.shape
    positions = positions.to(torch.int32)
    if c.mla:
        return _verify_step_mla(params, cache, tokens, positions, c, write_mask)
    x = _embed_lookup(params, tokens, c)  # [B, S, E]
    # per-row positions: row i covers [pos_i, pos_i + S)
    pos_grid = positions[:, None] + torch.arange(sdraft, device=tokens.device, dtype=torch.int32)
    ropes = tuple(  # [B, S, D/2] pairs: global, local
        (cos.reshape(b, sdraft, -1), sin.reshape(b, sdraft, -1))
        for cos, sin in dual_rope_freqs(c, pos_grid.reshape(-1))
    )
    batch_ix = torch.arange(b, device=tokens.device)
    scale = c.attention_scale
    grp = c.n_heads // c.n_kv_heads
    tmax = cache["k"].shape[3]
    write_pos = torch.where(write_mask[:, None], pos_grid, torch.full_like(pos_grid, tmax))
    temp = attn_temp_scales(pos_grid, c)[:, None, :, None] if c.attn_temp_scale else None

    for i, (window, nope) in enumerate(zip(layer_windows(c), layer_nope(c))):
        layer = layer_params(params, i)
        ck, cv = _cache_layer(cache, i)
        cos, sin = layer_rope(ropes, c, window)
        q, k, v = _qkv_heads(_attn_input(x, layer, c), layer, c)
        q, k = _position_qk(q, k, c, nope, lambda t: _rope_rows(t, cos, sin, c.rope_interleaved),
                             lambda q: q * temp.to(q.dtype))
        # scatter the S tokens' K/V at their per-row positions
        _cwrite_at(ck, batch_ix, write_pos, k.transpose(1, 2))
        _cwrite_at(cv, batch_ix, write_pos, v.transpose(1, 2))
        # rows flatten [G, S] row-major; row g*S+s attends keys <= pos+s
        # (verify attends with the same sink column as decode)
        qr = q.reshape(b, c.n_kv_heads, grp * sdraft, c.head_dim)
        o = _attend_cache(
            qr, ck, cv, positions, window, config=c, scale=scale, rows_per_slot=sdraft,
            sinks=_row_sinks(layer, c, sdraft), decode_kernel=decode_kernel, nope=nope,
        )
        o = o.view(b, c.n_kv_heads, grp, sdraft, c.head_dim)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, sdraft, c.q_dim)
        x = _residual(x, _attn_out(o, layer, c), layer, c)
    x = model_norm(x, params["final_norm"], c)
    return _head_logits(params, x, c), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek): absorbed attention over the latent cache
# ---------------------------------------------------------------------------
#
# Per head, k_nope = ckv · W_kb^nope and v = ckv · W_kb^v, so
#   q_nope · k_nope = (q_nope · W_kb^nope) · ckv   (absorbed into q)
#   attention out   = (probs · ckv) · W_kb^v       (absorbed into the out)
# which makes attention MQA with ONE shared KV head [ckv ; k_pe] of width
# kv_lora_rank + qk_rope_head_dim (576 on DeepSeek-V2) whose value is the
# latent itself, its rope columns zeroed; the cache never holds per-head
# K/V (dstack_tpu/serve/engine.py:389-660). A serial chunk attends through
# K1's MLA entry, which reads the value as the row's first kv_lora_rank
# columns and never builds it; a packed wave through the masked attention
# over the built value (per-row offsets); decode and verify are plain
# products over the latent row, as JAX's einsums are (K4 has no MLA form
# on either side).


def _mla_kb(layer: dict, c: LlamaConfig) -> tuple:
    """wkv_b [rank, H*(nope+v)] → (w_kb_nope [rank, H, nope], w_kb_v
    [rank, H, v]) views."""
    w = layer["wkv_b"].view(c.kv_lora_rank, c.n_heads, c.qk_nope_head_dim + c.v_head_dim)
    return w[..., : c.qk_nope_head_dim], w[..., c.qk_nope_head_dim :]


def _mla_layer(x: torch.Tensor, layer: dict, c: LlamaConfig, rope, attend, ck) -> torch.Tensor:
    """One MLA layer of any step (the steps' ``one_layer`` in JAX):
    ``rope(t)`` rotates ``[B, Hh, T, rope]`` by the step's angles
    (interleaved); ``attend(q_abs, rows, ck)`` writes the step's latent
    rows ``[B, T, R]`` into the layer's cache view ``ck`` ``[B, 1, T_max,
    R]`` and returns the absorbed output ``o_lat`` ``[B, H, T, rank]``. Then
    the value up-projection, ``wo`` and the layer's MLP (dense in the
    prelude, the MoE with its shared expert after)."""
    b, t = x.shape[0], x.shape[1]
    h = _attn_input(x, layer, c)
    q = _mla_q(h, layer, c)
    q_pe = rope(q[..., c.qk_nope_head_dim :])
    ckv, k_pe = _mla_latents(h, layer, c)
    k_pe = rope(k_pe[:, None])[:, 0]
    w_kb_nope, w_kb_v = _mla_kb(layer, c)
    q_lat = torch.einsum("bhcn,rhn->bhcr", q[..., : c.qk_nope_head_dim], w_kb_nope)
    o_lat = attend(torch.cat([q_lat, q_pe], dim=-1), torch.cat([ckv, k_pe], dim=-1), ck)
    o = torch.einsum("bhcr,rhv->bchv", o_lat, w_kb_v).reshape(b, t, c.o_dim)
    return _residual(x, _attn_out(o, layer, c), layer, c)


def _mla_walk(params: dict, cache: dict, x: torch.Tensor, c: LlamaConfig, rope, attend) -> torch.Tensor:
    """Every layer in order (the dense prelude, then the MoE stack: JAX's
    ``_mla_scan``) with its ``[B, 1, T_max, R]`` view of the latent cache,
    then the final norm."""
    for i, layer in enumerate(layer_stack(params)):
        x = _mla_layer(x, layer, c, rope, attend, cache["ckv"][i].unsqueeze(1))
    return model_norm(x, params["final_norm"], c)


def _prefill_chunk_mla(params, cache, tokens, slot, last_ix, c, *, start, impl=None):
    """MLA chunked prefill (``_prefill_chunk_mla``, engine.py:482): the
    chunk's latent rows write into the slot's row, then the absorbed
    queries ``[1, H, C, R]`` attend over the whole row as MQA with one
    KV head of width R, causal at ``q_offset=start``, the value the row's
    first ``kv_lora_rank`` columns: ``flash_mla_with_lse`` (K1's MLA
    kernel on the card), or its plain version with ``impl="plain"``."""
    if impl not in (None, "plain"):
        raise ValueError(f"attention: impl={impl!r}: expected None or 'plain'")
    cos, sin = dual_rope_freqs(c, start + torch.arange(tokens.shape[1], device=tokens.device))[0]
    si = _slot_ix(slot, cache["ckv"].shape[1], tokens.device)

    def attend(q_abs, rows, ck):
        _cwrite_chunk(ck, rows[:, None], si, start)
        row = _cread_row(ck, si, rows.dtype)  # [1, 1, T_max, R]
        fwd = flash_mla_plain if impl == "plain" else flash_mla_with_lse
        return fwd(q_abs.to(c.dtype).contiguous(), row, rank=c.kv_lora_rank,
                   scale=c.attention_scale, q_offset=int(start))[0]

    x = _mla_walk(params, cache, _embed_lookup(params, tokens, c), c,
                  lambda t: apply_rope(t, cos, sin, interleaved=True), attend)
    return _head_logits(params, _row_at(x, last_ix), c), cache


def _prefill_packed_mla(params, cache, tokens, slots, starts, last_ix, c):
    """MLA packed prefill (``_prefill_packed_mla``, engine.py:873): G
    chunks write their latent rows into their own slots (padding and pad
    rows drop), then attend over their rows with per-row causal frontiers:
    the masked attention, as JAX's vector offset takes."""
    g, cl = tokens.shape
    ar = torch.arange(cl, device=tokens.device)
    pos_grid = starts[:, None] + ar[None, :]  # [G, C]
    cos, sin = (a.reshape(g, cl, -1) for a in dual_rope_freqs(c, pos_grid.reshape(-1))[0])
    si = slots.long()
    tmax = cache["ckv"].shape[2]
    write_pos = torch.where(ar[None, :] <= last_ix[:, None], pos_grid, torch.full_like(pos_grid, tmax))

    def attend(q_abs, rows, ck):
        _cwrite_at(ck, si, write_pos, rows[:, :, None])
        row = _cread_rows(ck, si, rows.dtype)  # [G, 1, T_max, R]
        o = attention(q_abs.to(c.dtype), row, mla_value(row, c.kv_lora_rank), causal=True,
                      scale=c.attention_scale, q_offset=starts)
        return o[..., : c.kv_lora_rank]

    x = _mla_walk(params, cache, _embed_lookup(params, tokens, c), c,
                  lambda t: _rope_rows(t, cos, sin, interleaved=True), attend)
    last = x[torch.arange(g, device=x.device), last_ix.clamp_min(0).long()]
    return _head_logits(params, last, c), cache


def _mla_attend_rows(q_abs, row, live, c):
    """The absorbed attention of decode and verify over whole latent rows:
    q_abs [B, H, S, R] against row [B, T_max, R]; scores as f32 products
    of the model-dtype values (JAX's ``preferred_element_type=f32``),
    keys past ``live`` [B, S, T_max] masked, the f32 softmax cast to the
    cache's dtype for the product with the latent → [B, H, S, rank]. The
    heads and steps share a slot's row, so both products are batched over
    slots with the H x S query rows as M: a broadcast over the head axis
    would copy the row once a head."""
    b, h, steps, width = q_abs.shape
    s = torch.bmm(q_abs.reshape(b, h * steps, width).float(), row.float().transpose(1, 2))
    s = s.view(b, h, steps, -1) * c.attention_scale
    s = torch.where(live[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(row.dtype)
    o = torch.bmm(p.view(b, h * steps, -1), row[:, :, : c.kv_lora_rank])
    return o.view(b, h, steps, c.kv_lora_rank)


def _decode_step_mla(params, cache, tokens, positions, c, write_mask):
    """Absorbed MLA decode (``_decode_step_mla``, engine.py:546): each
    layer reads each slot's latent row once at width R."""
    b = tokens.shape[0]
    tmax = cache["ckv"].shape[2]
    write_pos = torch.where(write_mask, positions, torch.full_like(positions, tmax))
    cos, sin = dual_rope_freqs(c, positions)[0]  # [B, rope/2]
    batch_ix = torch.arange(b, device=tokens.device)
    live = (torch.arange(tmax, device=tokens.device)[None, :] <= positions[:, None])[:, None]

    def attend(q_abs, rows, ck):
        _cwrite_at(ck, batch_ix, write_pos, rows)  # [B, 1, R]: one row a slot
        return _mla_attend_rows(q_abs, ck[:, 0], live, c)

    x = _mla_walk(params, cache, _embed_lookup(params, tokens, c)[:, None, :], c,
                  lambda t: _apply_rope_batch(t, cos, sin, interleaved=True), attend)
    return _head_logits(params, x[:, 0], c), cache


def _verify_step_mla(params, cache, tokens, positions, c, write_mask):
    """Absorbed MLA verify (``_verify_step_mla``, engine.py:603): S tokens
    a slot at per-row positions, row s attending keys <= pos + s."""
    b, sdraft = tokens.shape
    tmax = cache["ckv"].shape[2]
    pos_grid = positions[:, None] + torch.arange(sdraft, device=tokens.device, dtype=torch.int32)
    cos, sin = (a.reshape(b, sdraft, -1) for a in dual_rope_freqs(c, pos_grid.reshape(-1))[0])
    write_pos = torch.where(write_mask[:, None], pos_grid, torch.full_like(pos_grid, tmax))
    batch_ix = torch.arange(b, device=tokens.device)
    live = torch.arange(tmax, device=tokens.device)[None, None, :] <= pos_grid[:, :, None]

    def attend(q_abs, rows, ck):
        _cwrite_at(ck, batch_ix, write_pos, rows[:, :, None])  # [B, S, 1, R]
        return _mla_attend_rows(q_abs, ck[:, 0], live, c)

    x = _mla_walk(params, cache, _embed_lookup(params, tokens, c), c,
                  lambda t: _rope_rows(t, cos, sin, interleaved=True), attend)
    return _head_logits(params, x, c), cache


def advance_decode_state(tok, pos, rem, act, eos_ids, sampled, *, max_seq: int):
    """One decode step's slot-state transition → (tok, pos, rem, act):
    the device mirror of the host replay in ``_advance_slot``."""
    new_tok = torch.where(act, sampled.to(tok.dtype), tok)
    step = act.to(pos.dtype)
    pos = pos + step
    rem = rem - step
    act = act & (new_tok != eos_ids) & (rem > 0) & (pos < max_seq - 1)
    return new_tok, pos, rem, act


def decode_loop(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [B] int: last sampled token per slot
    positions: torch.Tensor,  # [B] int32 current lengths
    remaining: torch.Tensor,  # [B] int32 generation budget left
    active: torch.Tensor,  # [B] bool
    eos_ids: torch.Tensor,  # [B] int (-1 = no EOS)
    config: LlamaConfig,
    *,
    steps: int,
    max_seq: int,
    decode_kernel: str = "flash",
) -> tuple:
    """``steps`` greedy decode steps on the device → (emitted [steps, B]
    with -1 for inactive rows, cache, last token, positions, remaining,
    active). Nothing here reads the device from the host: argmax and the
    slot-state transition stay on the device, so the caller pays one
    device-to-host copy a macro-step, not one a token. A slot that hits
    EOS, its budget or the cache end stops writing K/V mid-loop (the
    same ``write_mask`` guard as :func:`decode_step`)."""
    tok, pos, rem, act = tokens, positions, remaining, active
    emitted = []
    for _ in range(steps):
        logits, cache = decode_step(
            params, cache, tok, pos, config, write_mask=act, decode_kernel=decode_kernel,
        )
        tok, pos, rem, act2 = advance_decode_state(
            tok, pos, rem, act, eos_ids, logits.argmax(dim=-1), max_seq=max_seq
        )
        emitted.append(torch.where(act, tok, torch.full_like(tok, -1)))
        act = act2
    return torch.stack(emitted), cache, tok, pos, rem, act


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """The low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32): ``c``
    split into 16-bit halves, so that no product leaves int64's range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 tensors holding [0, 2^32):
    a bijection whose every output bit depends on every input bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def draw_bits(key_data: torch.Tensor, v: int) -> torch.Tensor:
    """The counter-based hash of the batched draw: key data [B, 2] int64
    (seed, draw counter) per row → [B, V] int64 in [0, 2^32), each
    element a hash of (seed, counter, vocab index). Plain integer ops,
    so the CPU and the card give the same bits, and a row's draw depends
    on its own key alone: the port's counterpart of JAX's per-slot
    threefry keys (a different stream)."""
    seed, ctr = key_data[:, 0], key_data[:, 1]
    k = _fmix32(((ctr >> 32) & MASK32) ^ 0x9E3779B9)
    k = _fmix32(k ^ (ctr & MASK32))
    k = _fmix32(k ^ ((seed >> 32) & MASK32))
    k1 = _fmix32(k ^ (seed & MASK32))[:, None]  # two row keys [B, 1]
    k2 = _fmix32(k1 ^ 0x7F4A7C15)
    ix = torch.arange(v, dtype=torch.int64, device=key_data.device)[None, :]
    return _fmix32(_fmix32(ix ^ k1) ^ k2)


def gumbel_noise(key_data: torch.Tensor, v: int) -> torch.Tensor:
    """[B, V] f32 Gumbel noise of one draw a row: the top 23 hash bits
    as a uniform u = (n + 1/2) / 2^23 in (0, 1), exact in f32, then
    -log(-log(u)) (JAX's ``categorical`` is Gumbel-max too)."""
    u = ((draw_bits(key_data, v) >> 9).float() + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def skip_key_data(kd: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Advance one slot's key data ``kd`` [2] by ``n`` draws (a 0-d int64
    tensor): the counter offset that replays what :func:`sample`
    consumes a token, so a resumed seeded request continues the original
    stream (the counterpart of JAX's ``skip_key_data``)."""
    return kd + torch.stack([torch.zeros_like(n), n])


def _keys_of(generators: list, device) -> torch.Tensor:
    """Key data [B, 2] for a list of per-row ``torch.Generator`` (or
    None): one draw of each generator seeds its row at counter 0."""
    seeds = [0 if g is None else int(torch.randint(0, 2**62, (1,), generator=g)) for g in generators]
    return torch.tensor([[s, 0] for s in seeds], dtype=torch.int64, device=device)


def sample(
    logits: torch.Tensor,  # [B, V] f32
    keys,  # [B, 2] int64 key data (seed, draw counter), or a list of torch.Generator / None
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int, 0 = off
    rep_pen: torch.Tensor,  # [B] f32, 1.0 = off
    counts: torch.Tensor,  # [B, V] int: occurrences in prompt + generated
    pres_pen: torch.Tensor,  # [B]
    freq_pen: torch.Tensor,  # [B]
    gen_counts: torch.Tensor,  # [B, V] int: occurrences in GENERATED text
    logit_bias: Optional[torch.Tensor] = None,  # [B, V] f32
    min_p: Optional[torch.Tensor] = None,  # [B] f32
) -> torch.Tensor:
    """→ tokens [B]. Greedy where temperature == 0, else penalized
    temperature / min-p / top-k / top-p sampling, as the JAX ``sample``
    computes it, with one batched draw (:func:`gumbel_noise`) from each
    row's key data; the caller advances the counters. A list of
    generators (a caller outside the engine) seeds each row's key from
    one draw of its generator. The stream differs from JAX's threefry,
    so only greedy output is comparable token for token across the two
    packages."""
    v = logits.shape[-1]
    if not isinstance(keys, torch.Tensor):
        keys = _keys_of(keys, logits.device)
    if logit_bias is not None:
        logits = logits + logit_bias
    seen = counts > 0
    pen = rep_pen[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    logits = torch.where(seen & (pen != 1.0), penalized, logits)
    logits = logits - pres_pen[:, None] * (gen_counts > 0).float()
    logits = logits - freq_pen[:, None] * gen_counts.float()
    greedy = logits.argmax(dim=-1)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    neg = torch.full_like(scaled, NEG_INF)
    if min_p is not None:
        probs_mp = torch.softmax(scaled, dim=-1)
        floor = min_p[:, None] * probs_mp.amax(dim=-1, keepdim=True)
        scaled = torch.where((min_p[:, None] <= 0.0) | (probs_mp >= floor), scaled, neg)
    # one descending sort serves both filters
    sorted_full = scaled.sort(dim=-1, descending=True).values
    kth_ix = (top_k.long() - 1).clamp(0, v - 1)
    kth = sorted_full.gather(-1, kth_ix[:, None])
    scaled = torch.where((top_k[:, None] > 0) & (scaled < kth), neg, scaled)
    ar = torch.arange(v, device=logits.device)[None, :]
    sorted_logits = torch.where(
        (top_k[:, None] > 0) & (ar >= top_k.clamp_min(1)[:, None]), neg, sorted_full
    )
    # top_p >= 1 bypasses the mask: an f32 cumsum may never reach 1.0
    cumulative = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_ix = (cumulative >= top_p[:, None]).int().argmax(dim=-1)
    cutoff = sorted_logits.gather(-1, cutoff_ix[:, None])
    masked = torch.where(scaled >= cutoff, scaled, neg)
    masked = torch.where(top_p[:, None] >= 1.0, scaled, masked)
    sampled = (masked + gumbel_noise(keys, v)).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


TOP_LOGPROBS = 5  # alternatives computed a token (OpenAI's maximum)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Raw f32 logits [B, V] and the sampled tokens [B] → (chosen logprob
    [B], top ids [B, K], top logprobs [B, K]) of the model's own
    distribution, before temperature, penalties and bias (the JAX
    ``token_logprobs``). The top K come in ``jax.lax.top_k``'s order
    (:func:`moe.topk`), which ``torch.topk`` does not keep on ties."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = logp.gather(-1, tokens.long()[:, None])[:, 0]
    top_lp, top_ids = topk(logp, TOP_LOGPROBS)
    return chosen, top_ids, top_lp


def _mark_seen(counts, gen_counts, rows, tokens) -> None:
    """Count sampled tokens in both maps (in place)."""
    one = torch.ones_like(tokens, dtype=counts.dtype)
    counts.index_put_((rows, tokens.long()), one, accumulate=True)
    gen_counts.index_put_((rows, tokens.long()), one, accumulate=True)


def _mark_prompt(counts, gen_counts, slot: torch.Tensor, padded: torch.Tensor, tp: torch.Tensor) -> None:
    """Reset the slot's rows (``slot`` a ``[1]`` long tensor) and count
    the first ``tp`` (a ``[1]`` tensor) ids of ``padded`` (the prompt
    padded to a power-of-two length) in the all-tokens map only, in
    place: the JAX ``_mark_prompt``'s scatter-add, where an index counts
    from the end when negative and drops when out of range (``.at[]``
    with ``mode="drop"``), as does every position past ``tp``."""
    v = counts.shape[-1]
    ids = padded.long()
    ids = torch.where(ids < 0, ids + v, ids)
    keep = (torch.arange(ids.shape[0], device=ids.device) < tp) & (ids >= 0) & (ids < v)
    row = torch.zeros(v + 1, dtype=counts.dtype, device=counts.device)  # column v: the drops
    row.index_add_(0, torch.where(keep, ids, torch.full_like(ids, v)),
                   torch.ones_like(ids, dtype=counts.dtype))
    counts.index_copy_(0, slot, row[None, :v])
    gen_counts.index_fill_(0, slot, 0)


# ---------------------------------------------------------------------------
# the engine: slots + continuous batching
# ---------------------------------------------------------------------------


class InferenceEngine:
    """Slot-based continuous batching (the JAX ``InferenceEngine``).
    Synchronous; the OpenAI server drives it from one scheduler task
    (``start_request`` into a free slot, ``prefill_wave`` until no prompt
    is pending, ``step`` for every active slot). ``step`` dispatches, in
    the reference's order, a speculative verify when at least half the
    greedy batch has a prompt-lookup draft, else a device-side greedy
    macro-step when no prompt is prefilling, else one plain decode
    step."""

    def __init__(
        self,
        config: LlamaConfig,
        params: dict,
        max_batch: int = 8,
        max_seq: int = 2048,
        seed: int = 0,
        prefill_chunk: int = 256,
        prefill_pack: int = 4,
        spec_draft: int = 4,
        turbo_steps: int = 8,
        prefix_cache: bool = True,
        kv_quant=None,  # None | "int8": quantized KV cache
        turbo_quiet_s: float = 0.5,
        turbo_depth: int = 1,
        decode_kernel: Optional[str] = None,  # None (by the config) | "flash" | "einsum"
        device="cuda",
        registry=None,  # obs.Registry (default: a fresh serve registry)
        graphs: bool = True,  # False: the eager engine on the card (the graphs' reference)
    ):
        self.device = resolve_device(device)
        if decode_kernel not in (None, "flash", "einsum"):
            raise ValueError(
                f"decode_kernel={decode_kernel!r}: expected 'flash' or 'einsum'"
            )
        # the default routes by the config, as the engine's caller gates it in
        # JAX (engine.py:1868-1875): K4, but the einsum for a chunked config
        # (Llama4), whose chunk mask no kernel takes; a routing, not a fallback
        self.decode_kernel = decode_kernel or (
            "einsum" if config.attention_chunk_size and not config.mla else "flash")
        # an MLA model never consults K4 (its decode is the latent products)
        if self.decode_kernel == "flash" and not config.mla and not flash_decode_supported(config, max_seq):
            raise ValueError("decode_kernel='flash' unsupported for this model (chunked attention, "
                             "head_dim, GQA group)")
        if decode_kernel is None and self.decode_kernel == "einsum":
            logger.info("decode_kernel: einsum (the config's attention_chunk_size %d is a chunk "
                        "mask no decode kernel takes, as in JAX)", config.attention_chunk_size)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is {self.device}"
            )
        self.config = config
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_quant = kv_quant
        # telemetry at the source: the server's /metrics and the bench
        # read these series (one source of truth with stats below)
        self.metrics = registry or new_serve_registry()
        self.metrics.family("dtpu_serve_max_slots").set(max_batch)
        self.cache = init_cache(config, max_batch, max_seq, device=self.device, kv_quant=kv_quant)
        self._seed = seed
        self._auto_seed = seed
        # per-slot host state
        self.lengths = [0] * max_batch  # tokens currently in cache
        self.active = [False] * max_batch
        self.remaining = [0] * max_batch
        self.eos = [None] * max_batch
        self.last_token = [0] * max_batch
        self.temps = [0.0] * max_batch
        self.top_ps = [1.0] * max_batch
        self.top_ks = [0] * max_batch
        self.rep_pens = [1.0] * max_batch
        self.pres_pens = [0.0] * max_batch
        self.freq_pens = [0.0] * max_batch
        self.min_ps = [0.0] * max_batch
        self.has_bias = [False] * max_batch
        self.finish_reason = [None] * max_batch  # "stop" | "length" once done
        self.want_logprobs = [False] * max_batch
        # most recent token's (logprob, [(alt_id, alt_lp), ...]) a slot
        self._last_logprobs: dict = {}
        # per-slot sampling streams (key data: seed, draw counter) and
        # seen-token counts for penalties
        v = config.vocab_size
        dev = self.device
        self._key_data = torch.zeros((max_batch, 2), dtype=torch.int64, device=dev)
        self._seen = torch.zeros((max_batch, v), dtype=torch.int32, device=dev)
        self._gen_counts = torch.zeros((max_batch, v), dtype=torch.int32, device=dev)
        self._logit_bias = torch.zeros((max_batch, v), dtype=torch.float32, device=dev)
        self._slot_iota = torch.arange(max_batch, device=dev)
        # fixed device mirrors of host lists: (token, position, budget,
        # active, eos) and the seven sampling parameters, rewritten in
        # place after a host-side slot mutation (_invalidate_decode_cache),
        # so that a graph's addresses stay valid
        self._state = (
            torch.zeros(max_batch, dtype=torch.long, device=dev),
            torch.zeros(max_batch, dtype=torch.int32, device=dev),
            torch.zeros(max_batch, dtype=torch.int32, device=dev),
            torch.zeros(max_batch, dtype=torch.bool, device=dev),
            torch.zeros(max_batch, dtype=torch.long, device=dev),
        )
        self._sampling = tuple(
            torch.zeros(max_batch, dtype=dt, device=dev)
            for dt in (torch.float32, torch.float32, torch.int64, torch.float32,
                       torch.float32, torch.float32, torch.float32)
        )
        self._state_valid = False
        self._sampling_valid = False
        # pending chunked prefills: slot → {prompt, tp, next, gen}
        self._prefilling: dict[int, dict] = {}
        # prompt-lookup speculative decoding (greedy slots): draft
        # spec_draft tokens from the last n-gram match in the slot's
        # history and verify them in ONE multi-token decode. 0 disables
        self.spec_draft = max(0, spec_draft)
        self.spec_ngram = 2
        self.history: list = [[] for _ in range(max_batch)]
        # incremental {n-gram: last index} per slot: O(1) draft lookup
        self._ngram_ix: list = [dict() for _ in range(max_batch)]
        # per-request acceptance: slots whose drafts keep failing stop
        self._spec_tries = [0] * max_batch
        self._spec_accepted = [0] * max_batch
        self._spec_off = [False] * max_batch
        self.prefill_chunk = max(16, min(prefill_chunk, max_seq))
        # packed multi-slot prefill: up to this many chunk rows in one
        # prefill_packed_step, floored to a power of two (the G buckets);
        # 0/1 = serial per-slot prefill
        pack = max(0, min(prefill_pack, max_batch))
        while pack & (pack - 1):
            pack &= pack - 1
        self.prefill_pack = pack
        # automatic prefix caching: slots whose rows still hold a fully
        # prefilled prompt (valid after release, until the slot is
        # reused) → a new request sharing a chunk-aligned prefix copies
        # those rows and skips their chunks
        self.prefix_cache = prefix_cache
        self._prefix_registry: dict[int, list] = {}  # slot → prompt ids
        # device-side greedy macro-steps (decode_loop): K tokens a host
        # round trip; 0/1 = per step. K starts at its floor (8), doubles
        # while arrival-quiet for turbo_quiet_s and snaps back whenever
        # requests arrive or wait; once fully open, up to turbo_depth
        # macro-steps are chained before the one device-to-host copy
        self.turbo_steps = max(0, turbo_steps)
        self.turbo_quiet_s = turbo_quiet_s
        self.waiting_requests = 0  # hint set by the serving scheduler
        self._turbo_k = min(8, self.turbo_steps) or self.turbo_steps
        self._last_admit = 0.0
        self.turbo_depth = max(1, turbo_depth)
        self.last_wave_slots: list = []
        self._last_step_phase = "decode"  # "decode" | "spec" | "turbo"
        # serving counts on the host: with the kernels' launch counts they
        # show which path a run took (K4 launches = n_layers x
        # (decode_steps + spec_steps + turbo_device_steps); K1 launches =
        # n_layers x (prefill_dispatches - packed_dispatches)). TTFT runs
        # from admission to the first sampled token; each step kind's
        # seconds are the host clock around its step() calls, which end
        # in a device-to-host copy of their tokens
        self.stats = {
            "prefill_dispatches": 0,  # serial chunks and packed waves
            "packed_dispatches": 0,
            "prefix_hits": 0,
            "prefix_tokens_reused": 0,
            "decode_steps": 0,  # plain one-token steps
            "decode_tokens": 0,
            "decode_seconds": 0.0,
            "spec_steps": 0,
            "spec_draft_tokens": 0,
            "spec_accepted_tokens": 0,
            "spec_tokens": 0,
            "spec_seconds": 0.0,
            "turbo_dispatches": 0,
            "turbo_device_steps": 0,  # steps x depth: the device runs each one
            "turbo_tokens": 0,
            "turbo_seconds": 0.0,
            "ttft_count": 0,
            "ttft_sum_s": 0.0,
            "ttft_max_s": 0.0,
        }
        self._admit_t0: dict[int, float] = {}
        self._trace_ids: dict[int, str] = {}  # slot → exemplar trace id
        # watchdog plumbing, as in JAX: the server runs step() on a worker
        # thread and may give up on a wedged one (abandon_step). The
        # abandoned thread checks the epoch after every pre-dispatch fault
        # point, so its eventual return never touches slot state (or a
        # step site's buffers) the scheduler has reused since
        self._step_epoch = 0
        self._step_wedge: Optional[tuple] = None  # ("slot", i) | ("dispatch",)
        # extra context merged into every serve.engine.step fire and flight
        # record (a harness with several engines in one process sets e.g.
        # {"replica": "r1"} so a fault rule can target one engine)
        self.fault_ctx: dict = {}
        # the compiled step sites (serve/graphs.py), with the JAX jit
        # sites' names and keys: CUDA graphs on the card unless
        # graphs=False, the same functions run eagerly on the CPU. Each is
        # wrapped for compile accounting (obs/flight.py: identity when
        # DTPU_FLIGHT=0); a compile after mark_flight_warm() is a
        # steady-state recompile, and one of a key the boot-compile
        # manifest lacks is a warmup-coverage gap
        self.graphs = GraphSet(self.device, capture=graphs and self.device.type == "cuda")
        self.graphs.fix(
            *self.cache.values(), self._key_data, self._seen, self._gen_counts,
            self._logit_bias, self._slot_iota, *self._state, *self._sampling,
        )
        self._flight_warm = False
        self._compile_manifest: set = set()
        self._site = lambda name, fn, key=None, fixed_outputs=True: flight.watch_jit(
            self.graphs.site(name, fn, key=key, fixed_outputs=fixed_outputs), name,
            registry=self.metrics, key=key, warm=lambda: self._flight_warm,
            on_compile=self._note_boot_compile,
        )
        self._decode = self._site("decode", self._decode_fn)
        self._verify = self._site("verify", self._verify_fn)
        self._sample = self._site("sample", self._sample_fn)
        self._argmax = self._site("argmax", partial(torch.argmax, dim=-1))
        self._advance_state = self._site("advance_state", self._advance_fn)
        self._logprobs = self._site("logprobs", token_logprobs)
        self._mark_seen = self._site("mark_seen", self._mark_seen_fn)
        self._skip_key = self._site("skip_key", skip_key_data)
        self._turbo_sites: dict = {}  # steps → the decode_loop site
        # the prefill side, keyed as JAX keys its jit grids: a serial
        # chunk by (C, start), a packed wave by (G, C), a prefix copy by
        # its length p; mark_prompt's variants by the padded prompt's
        # length alone
        self._chunk_fns: dict = {}
        self._packed_fns: dict = {}
        self._copy_fns: dict = {}
        self._mark_prompt = self._site("mark_prompt", self._mark_prompt_fn)

    # -- the step sites' functions: the engine's fixed buffers in place --

    def _decode_fn(self) -> torch.Tensor:
        tok, pos, _, act, _ = self._state
        return decode_step(self.params, self.cache, tok, pos, self.config,
                           write_mask=act, decode_kernel=self.decode_kernel)[0]

    def _verify_fn(self, tokens: torch.Tensor) -> torch.Tensor:
        _, pos, _, act, _ = self._state
        return verify_step(self.params, self.cache, tokens, pos, self.config,
                           write_mask=act, decode_kernel=self.decode_kernel)[0]

    def _sample_fn(self, logits: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """:func:`sample` over the slots ``rows`` (all of them, or the one
        a prompt just filled), then each of those rows' draw counter
        advances by one."""
        temps, top_ps, top_ks, rep_pens, pres_pens, freq_pens, min_ps = self._sampling
        toks = sample(
            logits, self._key_data[rows], temps[rows], top_ps[rows], top_ks[rows], rep_pens[rows],
            self._seen[rows], pres_pens[rows], freq_pens[rows], self._gen_counts[rows],
            self._logit_bias[rows], min_ps[rows],
        )
        one_draw = torch.stack([torch.zeros_like(rows), torch.ones_like(rows)], dim=1)
        self._key_data.index_add_(0, rows, one_draw)
        return toks

    def _mark_seen_fn(self, rows: torch.Tensor, tokens: torch.Tensor) -> tuple:
        _mark_seen(self._seen, self._gen_counts, rows, tokens)
        return ()

    def _advance_fn(self, sampled: torch.Tensor) -> tuple:
        """:func:`advance_decode_state` written back into the mirror."""
        new = advance_decode_state(*self._state, sampled, max_seq=self.max_seq)
        for buf, t in zip(self._state, new):
            buf.copy_(t)
        return ()

    def _turbo_fn(self, steps: int) -> torch.Tensor:
        """:func:`decode_loop` from the mirror, its advanced state written
        back into it → emitted [steps, B]."""
        emitted, _, *new = decode_loop(
            self.params, self.cache, *self._state, self.config, steps=steps,
            max_seq=self.max_seq, decode_kernel=self.decode_kernel,
        )
        for buf, t in zip(self._state, new):
            buf.copy_(t)
        return emitted

    def _chunk_site_fn(self, tokens, slot, last_ix, *, start: int) -> torch.Tensor:
        return prefill_chunk_step(self.params, self.cache, tokens, slot, last_ix, self.config,
                                  start=start)[0]

    def _packed_site_fn(self, tokens, slots, starts, last_ix) -> torch.Tensor:
        return prefill_packed_step(self.params, self.cache, tokens, slots, starts, last_ix,
                                   self.config)[0]

    def _copy_site_fn(self, src, dst, *, p: int) -> tuple:
        copy_cache_prefix(self.cache, src, dst, p=p)
        return ()

    def _mark_prompt_fn(self, slot, padded, tp) -> tuple:
        _mark_prompt(self._seen, self._gen_counts, slot, padded, tp)
        return ()

    def _chunk_fn(self, cl: int, start: int):
        """The serial chunk's site at (C, start): C a power-of-two bucket,
        start chunk-aligned (prefill_step), so the grid is at most
        log2(C) x (T/C). Its logits feed the sampler through the
        sampler's own input buffer (``fixed_outputs=False``): one capture
        of ``sample`` serves every chunk and wave key."""
        key = (cl, start)
        if key not in self._chunk_fns:
            self._chunk_fns[key] = self._site(
                "chunk", partial(self._chunk_site_fn, start=start), key=key, fixed_outputs=False)
        return self._chunk_fns[key]

    def _packed_fn(self, g: int, cl: int):
        """The packed wave's site at (G, C), both powers of two
        (prefill_wave); its starts are arguments, so one variant serves
        every mix of starts."""
        key = (g, cl)
        if key not in self._packed_fns:
            self._packed_fns[key] = self._site(
                "packed", self._packed_site_fn, key=key, fixed_outputs=False)
        return self._packed_fns[key]

    def get_copy_fn(self, p: int):
        """The prefix copy's site for reuse length ``p``, called with the
        source and destination slots' :meth:`slot_index`: the single
        construction point (the warmup's :meth:`warm_prefix_copies` and
        the bench build through it, so their variants cannot drift from
        what start_request builds)."""
        if p not in self._copy_fns:
            # p is chunk-aligned (_find_prefix_source): at most T/C keys
            self._copy_fns[p] = self._site("copy", partial(self._copy_site_fn, p=p), key=p)
        return self._copy_fns[p]

    def slot_index(self, slot: int) -> torch.Tensor:
        """Slot ``slot`` as the ``[1]`` long device tensor the prefill
        sites take (a view of a fixed buffer: no upload)."""
        return self._slot_iota[slot : slot + 1]

    def _turbo_site(self, steps: int):
        if steps not in self._turbo_sites:
            # steps is a power of two at most turbo_steps (_turbo_step)
            self._turbo_sites[steps] = self._site("turbo", partial(self._turbo_fn, steps), key=steps)
        return self._turbo_sites[steps]

    def free_slots(self) -> list[int]:
        return [
            i for i in range(self.max_batch)
            if not self.active[i] and i not in self._prefilling
        ]

    def prefilling_slots(self) -> list[int]:
        """Slots with a queued or running chunked prefill (admission order)."""
        return list(self._prefilling)

    def _find_prefix_source(self, prompt: list) -> tuple[int, Optional[int]]:
        """Longest chunk-aligned cached prefix of ``prompt`` among
        registered slots → (reusable length, source slot)."""
        c = self.prefill_chunk
        best_len, best_src = 0, None
        for s, cached in self._prefix_registry.items():
            common = _common_prefix_len(cached, prompt)
            # at least one real tail token must prefill (it produces the
            # first-token logits), and reuse stays chunk-aligned
            reuse = min(common, len(prompt) - 1) // c * c
            if reuse >= c and reuse > best_len:
                best_len, best_src = reuse, s
        return best_len, best_src

    def start_request(self, prompt: list[int], gen: GenParams) -> int:
        """Reserve a slot and queue the prompt for chunked prefill (host
        bookkeeping, plus the prefix copy on a prefix-cache hit). Raises
        RuntimeError when full."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        self._last_admit = time.monotonic()  # arrival signal → small K
        # cap the generation budget by the cache, then keep as much
        # prompt tail as fits alongside it (never less than 1 token)
        gen.max_new_tokens = max(1, min(gen.max_new_tokens, self.max_seq - 2))
        keep = max(1, self.max_seq - 1 - gen.max_new_tokens)
        if len(prompt) > keep:
            prompt = prompt[-keep:]
        reuse_len, src = (
            self._find_prefix_source(prompt) if self.prefix_cache else (0, None)
        )
        return self._start_request_inner(prompt, gen, free, reuse_len, src)

    def _start_request_inner(self, prompt, gen, free, reuse_len, src) -> int:
        # prefer slots NOT holding a reusable prefix (keep the registry),
        # and never overwrite the chosen source itself
        candidates = [s for s in free if s != src] or free
        slot = min(candidates, key=lambda s: (s in self._prefix_registry, s))
        if slot == src:
            reuse_len, src = 0, None
        self._prefix_registry.pop(slot, None)  # rows about to be overwritten
        start = 0
        if src is not None and reuse_len > 0:
            self.get_copy_fn(reuse_len)(self.slot_index(src), self.slot_index(slot))
            start = reuse_len
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += reuse_len
            self.metrics.family("dtpu_serve_prefix_hits_total").inc(1)
            self.metrics.family("dtpu_serve_prefix_tokens_reused_total").inc(reuse_len)
        self._admit_t0[slot] = time.perf_counter()
        self._prefilling[slot] = {
            "prompt": list(prompt),
            "tp": len(prompt),
            "next": start,  # next chunk's global start position
            "gen": gen,
        }
        return slot

    def prefill_step(self, slot: int):
        """Process ONE prompt chunk for ``slot``; None while incomplete,
        the first sampled token once the prompt is fully prefilled."""
        st = self._prefilling.get(slot)
        if st is None:
            return None  # released concurrently (client cancelled)
        tp, start = st["tp"], st["next"]
        if tp <= self.prefill_chunk:
            # short prompt: one chunk at the smallest power-of-2 bucket
            cl = 16
            while cl < tp:
                cl *= 2
            cl = min(cl, self.prefill_chunk)
        else:
            cl = self.prefill_chunk
        # never overflow the cache row (the write would clamp and shift)
        cl = min(cl, self.max_seq - start)
        chunk = st["prompt"][start : start + cl]
        final = start + cl >= tp
        chunk = chunk + [0] * (cl - len(chunk))
        last_ix = (tp - 1 - start) if final else (cl - 1)
        # the chunk and its index in one upload, outside the site
        up = torch.tensor([chunk + [last_ix]], dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        logits = self._chunk_fn(cl, start)(up[:, :cl], self.slot_index(slot), up[0, cl:])
        self.stats["prefill_dispatches"] += 1
        self.metrics.family("dtpu_serve_prefill_dispatches_total").inc(1)
        self.metrics.family("dtpu_serve_prefill_pack_rows").observe(1)
        if flight.enabled():
            # host-side data only: the serial chunk at its (C, start) key
            trace = st["gen"].trace_id
            flight.record(
                phase="prefill", slots=[slot], rows=1, g=1, cl=cl, start=start, final=final,
                dispatch_s=round(time.perf_counter() - t0, 6),
                traces={slot: trace} if trace else None, **self.fault_ctx,
            )
        if not final:
            st["next"] = start + cl
            return None
        gen = st["gen"]
        if self._prefilling.pop(slot, None) is None:
            return None  # released while the final chunk ran
        return self._activate(slot, st["prompt"], tp, gen, logits)

    def prefill_wave(self) -> dict[int, int]:
        """ONE prefill dispatch advancing up to ``prefill_pack`` pending
        prompts a chunk each → {slot: first token} for the prompts that
        completed. Rows at unequal starts share one packed dispatch; a
        lone chunk-aligned row takes the serial path (so the flash
        prefill kernel serves it), and a row a packed wave left at an
        unaligned start finishes packed at G = 1."""
        states = {s: st for s, st in list(self._prefilling.items())}
        if not states:
            return {}
        pending = list(states)  # admission order
        if self.prefill_pack <= 1 or (
            len(pending) == 1 and states[pending[0]]["next"] % self.prefill_chunk == 0
        ):
            slot = pending[0]
            self.last_wave_slots = [slot]
            tok = self.prefill_step(slot)
            return {} if tok is None else {slot: tok}
        rows = pending[: self.prefill_pack]
        self.last_wave_slots = list(rows)
        # chunk length: the power-of-2 bucket covering the widest
        # remaining chunk in the pack, capped at prefill_chunk
        need = max(min(states[s]["tp"] - states[s]["next"], self.prefill_chunk) for s in rows)
        cl = 16
        while cl < need:
            cl *= 2
        cl = min(cl, self.prefill_chunk)
        # G bucketed by powers of two; pad rows carry last_ix = -1
        g = 1
        while g < len(rows):
            g *= 2
        g = min(g, self.prefill_pack)
        tok_rows, slot_ix, starts, last_ix = [], [], [], []
        final = {}
        for s in rows:
            st = states[s]
            tp, start = st["tp"], st["next"]
            chunk = st["prompt"][start : start + cl]
            final[s] = start + cl >= tp
            tok_rows.append(chunk + [0] * (cl - len(chunk)))
            slot_ix.append(s)
            starts.append(start)
            last_ix.append((tp - 1 - start) if final[s] else (cl - 1))
        for _ in range(g - len(rows)):
            tok_rows.append([0] * cl)
            slot_ix.append(0)
            starts.append(0)
            last_ix.append(-1)
        # the rows and their three columns in one upload, outside the site
        up = torch.tensor([r + [sl, s0, ix] for r, sl, s0, ix in zip(tok_rows, slot_ix, starts, last_ix)],
                          dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        logits = self._packed_fn(g, cl)(up[:, :cl], up[:, cl], up[:, cl + 1], up[:, cl + 2])
        self.stats["prefill_dispatches"] += 1
        self.stats["packed_dispatches"] += 1
        self.metrics.family("dtpu_serve_prefill_dispatches_total").inc(1)
        self.metrics.family("dtpu_serve_prefill_pack_rows").observe(len(rows))
        if flight.enabled():
            # the wave's composition from its host lists: the (G, C) key,
            # the real rows packed and their starts
            flight.record(
                phase="prefill_packed", g=g, cl=cl, rows=len(rows), slots=list(rows),
                starts=starts[: len(rows)], dispatch_s=round(time.perf_counter() - t0, 6),
                traces={s: states[s]["gen"].trace_id for s in rows if states[s]["gen"].trace_id} or None,
                **self.fault_ctx,
            )
        out: dict[int, int] = {}
        for i, s in enumerate(rows):
            st = self._prefilling.get(s)
            if st is None:
                continue  # released while the wave ran
            if not final[s]:
                st["next"] += cl
                continue
            self._prefilling.pop(s, None)
            # each row samples before the next wave replays the graph
            # over its logits
            out[s] = self._activate(s, st["prompt"], st["tp"], st["gen"], logits[i : i + 1])
        return out

    def add_request(self, prompt: list[int], gen: GenParams) -> tuple[int, int]:
        """Prefill ``prompt`` into a free slot → (slot, first token)."""
        slot = self.start_request(prompt, gen)
        tok = None
        while tok is None:
            tok = self.prefill_step(slot)
        return slot, tok

    def _activate(self, slot: int, prompt: list[int], tp: int, gen: GenParams, logits) -> int:
        """Final-prefill tail: seed the slot's stream, mark seen tokens,
        sample the first token, and publish the slot state."""
        if gen.seed is not None:
            req_seed = int(gen.seed)
        else:
            self._auto_seed += 1
            req_seed = self._auto_seed
        dev = self.device
        req_seed = (req_seed + 2**63) % 2**64 - 2**63  # its 64 bits as int64
        kd = torch.tensor([req_seed, 0], dtype=torch.int64, device=dev)
        if gen.seed is not None and gen.seed_skip > 0:
            # resumable generation: the draw counter starts past the
            # delivered tokens, so the continuation samples from the
            # original stream
            kd = self._skip_key(kd, torch.tensor(int(gen.seed_skip), dtype=torch.int64, device=dev))
        self._key_data[slot] = kd
        pad = 16  # mark_prompt's variants: the power-of-two padded lengths
        while pad < tp:
            pad *= 2
        up = torch.tensor(list(prompt[:tp]) + [0] * (pad - tp) + [tp], dtype=torch.long, device=dev)
        self._mark_prompt(self.slot_index(slot), up[:pad], up[pad:])
        if gen.logit_bias or self.has_bias[slot]:
            self._logit_bias[slot] = bias_row(gen.logit_bias, self.config.vocab_size).to(self.device)
        self.min_ps[slot] = gen.min_p
        self.has_bias[slot] = bool(gen.logit_bias)
        self.temps[slot] = gen.temperature
        self.top_ps[slot] = gen.top_p
        self.top_ks[slot] = gen.top_k
        self.rep_pens[slot] = gen.repetition_penalty
        self.pres_pens[slot] = gen.presence_penalty
        self.freq_pens[slot] = gen.frequency_penalty
        self._invalidate_decode_cache()
        self._sampling_params()
        rows = self._slot_iota[slot : slot + 1]
        toks = self._sample(logits, rows)
        tok = int(toks[0])
        self._mark_seen(rows, toks)
        self.want_logprobs[slot] = gen.logprobs is not None
        if gen.logprobs is not None:
            lp, tids, tlps = (a.tolist() for a in self._logprobs(logits, toks))
            self._last_logprobs[slot] = (lp[0], list(zip(tids[0], tlps[0])))
        if gen.trace_id:
            self._trace_ids[slot] = gen.trace_id
        t_admit = self._admit_t0.pop(slot, None)
        if t_admit is not None:
            ttft = time.perf_counter() - t_admit
            self.stats["ttft_count"] += 1
            self.stats["ttft_sum_s"] += ttft
            self.stats["ttft_max_s"] = max(self.stats["ttft_max_s"], ttft)
            self.metrics.family("dtpu_serve_ttft_seconds").observe(ttft, exemplar=gen.trace_id)
        self.metrics.family("dtpu_serve_tokens_generated_total").inc(1)
        self.active[slot] = True
        if self.prefix_cache:
            # the slot's rows now hold this fully prefilled prompt; they
            # stay reusable until the slot is reassigned
            self._prefix_registry[slot] = list(prompt)
        self.history[slot] = []
        self._ngram_ix[slot] = {}
        self._spec_tries[slot] = 0
        self._spec_accepted[slot] = 0
        self._spec_off[slot] = False
        self._record_tokens(slot, list(prompt) + [tok])
        self.lengths[slot] = tp
        self.remaining[slot] = gen.max_new_tokens - 1
        self.eos[slot] = gen.eos_id
        self.last_token[slot] = tok
        self.finish_reason[slot] = None
        if tok == gen.eos_id or gen.max_new_tokens <= 1:
            # finished immediately; the slot never enters the decode loop
            self.active[slot] = False
            self.finish_reason[slot] = "stop" if tok == gen.eos_id else "length"
        return tok

    def _record_tokens(self, slot: int, toks: list) -> None:
        """Append to the slot's history, keeping the n-gram index current
        (each n-gram's LAST occurrence, registered one step behind so a
        lookup never matches the tail itself)."""
        h = self.history[slot]
        ix = self._ngram_ix[slot]
        n = self.spec_ngram
        for tok in toks:
            h.append(tok)
            if len(h) > n:
                ix[tuple(h[-n - 1 : -1])] = len(h) - 1 - n

    def _find_draft(self, slot: int) -> list:
        """Prompt-lookup draft: the tokens that followed the most recent
        earlier occurrence of the history's trailing n-gram."""
        if not self.spec_draft or self._spec_off[slot]:
            return []
        h = self.history[slot]
        n = self.spec_ngram
        if len(h) <= n:
            return []
        j = self._ngram_ix[slot].get(tuple(h[-n:]))
        if j is None:
            return []
        return h[j + n : j + n + self.spec_draft]

    def step(self, device_lock=None) -> dict:
        """Advance every active slot → {slot: [tokens]}. Slots that hit
        EOS, their budget or the cache end deactivate. A speculative or
        turbo step may emit several tokens a slot; a plain step one.

        The ``serve.engine.step`` fault point fires once per live slot
        with ctx ``slot=<i>`` first, on the host and before any step site
        replays (a no-op call when no plan is installed): a raise is a
        mid-decode engine failure, a hang with a ctx slot wedges exactly
        that slot's step, the shape the server's watchdog attributes
        (``_step_wedge``) and aborts (:meth:`abandon_step`). Only the
        dispatch runs under ``device_lock`` (the server's lock that keeps
        the kernels' launch counters exact), so a slot wedged in the fault
        point holds no lock and the next step serves the other slots."""
        epoch = self._step_epoch
        t_all0 = time.perf_counter()
        for i in range(self.max_batch):
            if not self.active[i]:
                continue
            self._step_wedge = ("slot", i)
            faults.fire("serve.engine.step", slot=i, **self.fault_ctx)
            if epoch != self._step_epoch:
                # abandoned while wedged here: the slot state may have been
                # reused since, so return before touching anything
                return {}
        self._step_wedge = ("dispatch",)
        t0 = time.perf_counter()
        if device_lock is None:
            out = self._step_dispatch()
        else:
            with device_lock:
                out = self._step_dispatch()
        self._step_wedge = None
        # no epoch check after the dispatch (JAX's order): its host and
        # device mutations already happened; a dispatch-abandoned step is
        # neutralised by the server, which quiesces until this thread
        # returns and then calls finish_abandoned_step()
        if out:
            dt = time.perf_counter() - t0
            n_tokens = sum(len(v) for v in out.values())
            kind = self._last_step_phase
            self.stats[f"{kind}_tokens"] += n_tokens
            self.stats[f"{kind}_seconds"] += dt
            m = self.metrics
            m.family("dtpu_serve_decode_steps_total").inc(1)
            m.family("dtpu_serve_decode_step_seconds").observe(dt)
            m.family("dtpu_serve_tokens_generated_total").inc(n_tokens)
            if n_tokens and dt > 0:
                # TPOT covers the batch: the exemplar is the trace of the
                # slot that yielded the most tokens (ties by slot order)
                ex = None
                for s in sorted(out, key=lambda s: -len(out[s])):
                    ex = self._trace_ids.get(s)
                    if ex is not None:
                        break
                m.family("dtpu_serve_tpot_seconds").observe(dt / n_tokens, exemplar=ex)
                m.family("dtpu_serve_decode_tokens_per_sec").observe(n_tokens / dt)
            if flight.enabled():
                # one record per emitting step, host-side fields only
                flight.record(
                    phase=kind, slots=list(out), tokens=n_tokens, dispatch_s=round(dt, 6),
                    host_s=round(max(0.0, time.perf_counter() - t_all0 - dt), 6),
                    kv_util=round(self.kv_cache_utilization(), 4),
                    prefix_slots=len(self._prefix_registry),
                    traces={s: self._trace_ids[s] for s in out if s in self._trace_ids} or None,
                    **self.fault_ctx,
                )
                flight.maybe_poll_memory(self.metrics)
        return out

    def abandon_step(self) -> Optional[tuple]:
        """Watchdog entry: give up on a wedged :meth:`step` running on a
        worker thread → the wedge: ``("slot", i)`` when the hang is in one
        slot's pre-dispatch fault point (only that slot need die; the epoch
        bump makes the sleeping thread return before it touches any state
        or replays a step site), ``("dispatch",)`` when the dispatch itself
        is stuck (the whole batch fails, and the caller must quiesce until
        the thread returns, then call :meth:`finish_abandoned_step`), or
        None when the step finished concurrently with the trip (harvest its
        result, abort nothing)."""
        phase = self._step_wedge
        self._step_epoch += 1
        self._step_wedge = None
        if phase is not None and flight.enabled():
            # the wedge itself is the post-mortem's last record: the slot
            # and its trace when attributable, a dispatch marker when not
            if phase[0] == "slot":
                flight.record(phase="wedge", slot=phase[1], trace=self._trace_ids.get(phase[1]),
                              **self.fault_ctx)
            else:
                flight.record(phase="wedge", dispatch=True, **self.fault_ctx)
            flight.post_mortem(
                "watchdog_abort", registry=self.metrics,
                wedge=f"slot:{phase[1]}" if phase[0] == "slot" else "dispatch",
                slots={i: self._trace_ids.get(i) for i in range(self.max_batch) if self.active[i]},
                **self.fault_ctx,
            )
        return phase

    def finish_abandoned_step(self) -> None:
        """Once a dispatch-abandoned step's thread has returned: it rebuilt
        the device mirrors from slot state the scheduler has released
        since, so drop them and the next dispatch rebuilds from the host."""
        self._invalidate_decode_cache()

    def _step_dispatch(self) -> dict:
        live = [i for i in range(self.max_batch) if self.active[i]]
        if not live:
            return {}
        if self.spec_draft > 0 and self._all_greedy(live):
            drafts = {i: self._find_draft(i) for i in live}
            drafting = sum(1 for d in drafts.values() if d)
            # non-drafting slots pay ~S x the decode compute for nothing:
            # speculate only when at least half the batch drafts
            if drafting and drafting * 2 >= len(live):
                self._last_step_phase = "spec"
                return self._spec_step(live, drafts)
        if self.turbo_steps > 1 and not self._prefilling and self._all_greedy(live):
            self._last_step_phase = "turbo"
            return self._turbo_step(live)
        self._last_step_phase = "decode"
        return {i: [tok] for i, tok in self._plain_step(live).items()}

    def _spec_step(self, live: list, drafts: dict) -> dict:
        """One verify_step call emits 1 .. spec_draft + 1 tokens a slot."""
        sdraft = self.spec_draft + 1
        rows = []
        for i in range(self.max_batch):
            row = [self.last_token[i]] + drafts.get(i, [])
            rows.append((row + [0] * (sdraft - len(row)))[:sdraft])
        self._decode_state()  # positions and write mask: the host lists
        logits = self._verify(torch.tensor(rows, dtype=torch.long, device=self.device))
        preds = self._argmax(logits).tolist()  # [B, S]: one device-to-host copy
        self._state_valid = False  # the host replay below advances outside the mirror
        self.stats["spec_steps"] += 1
        out: dict = {}
        for i in live:
            draft = drafts.get(i, [])
            emitted = [preds[i][0]]
            for j, dtok in enumerate(draft):
                if preds[i][j] != dtok:
                    break
                emitted.append(preds[i][j + 1])
            if draft:
                self._spec_tries[i] += 1
                self._spec_accepted[i] += len(emitted) - 1
                self.stats["spec_draft_tokens"] += len(draft)
                self.stats["spec_accepted_tokens"] += len(emitted) - 1
                if self._spec_tries[i] >= 4 and self._spec_accepted[i] < self._spec_tries[i]:
                    # < 1 accepted draft token a try: drafting this slot
                    # costs more than it saves
                    self._spec_off[i] = True
            toks = []
            for tok in emitted:
                toks.append(tok)
                if not self._advance_slot(i, tok):
                    break
            if toks:
                out[i] = toks
            # _seen is not updated: the spec path is gated to requests
            # without penalties, where the counts have no effect
        return out

    def warm_verify(self) -> None:
        """One speculative verify over a throwaway request, whatever the
        model drafts (the server's warmup: a model with random weights
        rarely repeats a prompt's n-gram, and then no draft fires)."""
        slot, tok = self.add_request([1, 2, 3], GenParams(max_new_tokens=self.spec_draft + 2))
        if self.active[slot]:
            self._last_step_phase = "spec"
            self._spec_step([slot], {slot: [tok] * self.spec_draft})
        self.release(slot)

    def _arrival_busy(self) -> bool:
        """Requests waiting or recently admitted: the regime where long
        device loops tax a newcomer's first token."""
        return (
            self.waiting_requests > 0
            or (time.monotonic() - self._last_admit) < self.turbo_quiet_s
        )

    def _adaptive_turbo_cap(self) -> int:
        """Current macro-step budget: the floor (8) while requests arrive
        or wait, doubling toward ``turbo_steps`` once arrival-quiet."""
        if self.turbo_steps <= 1:
            return self.turbo_steps
        floor = min(8, self.turbo_steps)
        if self._arrival_busy():
            self._turbo_k = floor
        else:
            self._turbo_k = min(self._turbo_k * 2, self.turbo_steps)
        return self._turbo_k

    def _turbo_step(self, live: list) -> dict:
        """One decode_loop macro-step (or ``depth`` chained ones) →
        {slot: [tokens]}. The host replays the device's per-step
        deactivation rules token by token, so lengths/remaining/
        finish_reason end as ``steps`` plain steps would leave them."""
        # cap the loop by the widest live budget, bucketed to powers of two
        budget = max(self.remaining[i] for i in live)
        needed = min(self._adaptive_turbo_cap(), budget)
        steps = 1
        while steps < needed:
            steps *= 2
        steps = min(steps, self.turbo_steps)
        # pipelined segments only when saturated: cap fully open AND
        # arrival-quiet, and never past the widest remaining budget
        depth = 1
        if (
            self.turbo_depth > 1
            and steps == self.turbo_steps
            and self._turbo_k == self.turbo_steps
            and not self._arrival_busy()
        ):
            depth = min(self.turbo_depth, -(-budget // steps))
        self._decode_state()
        turbo = self._turbo_site(steps)
        # each segment advances the mirror in place for the next; its
        # tokens are copied out before the next replay overwrites them
        segs = [turbo().clone() for _ in range(depth)]
        self.stats["turbo_dispatches"] += 1
        self.stats["turbo_device_steps"] += steps * depth
        # ONE device-to-host copy for every segment ([depth * steps, B])
        toks = torch.cat(segs).tolist()
        out: dict = {}
        for i in live:
            emitted: list = []
            for k in range(depth * steps):
                tok = toks[k][i]
                if tok < 0:  # the row deactivated on an earlier step
                    break
                emitted.append(tok)
                if not self._advance_slot(i, tok):
                    break
            if emitted:
                out[i] = emitted
        # the host replay applied the device's transitions, so the
        # mirror the graph advanced holds the valid next inputs
        self._state_valid = True
        return out

    def _invalidate_decode_cache(self) -> None:
        """EVERY host-side slot-state mutation must call this, or the
        next step would run from stale device mirrors."""
        self._state_valid = False
        self._sampling_valid = False

    def _sampling_params(self) -> tuple:
        """The device mirror of the seven per-slot sampling-parameter
        lists, rewritten in place when stale."""
        if not self._sampling_valid:
            lists = (self.temps, self.top_ps, self.top_ks, self.rep_pens, self.pres_pens,
                     self.freq_pens, self.min_ps)
            for buf, v in zip(self._sampling, lists):
                buf.copy_(torch.tensor(v, dtype=buf.dtype))
            self._sampling_valid = True
        return self._sampling

    def _decode_state(self) -> tuple:
        """The device mirror of (token, position, budget, active, eos),
        shared by the plain, verify and turbo paths, rewritten in place
        when stale."""
        if not self._state_valid:
            eos = [e if e is not None else -1 for e in self.eos]
            lists = (self.last_token, self.lengths, self.remaining, self.active, eos)
            for buf, v in zip(self._state, lists):
                buf.copy_(torch.tensor(v, dtype=buf.dtype))
            self._state_valid = True
        return self._state

    def _all_greedy(self, live: list) -> bool:
        """Every live slot plain-greedy with no penalties, bias or
        logprobs: the gate of the speculative and turbo paths and the
        argmax fast path."""
        return all(
            self.temps[i] <= 0.0
            and self.rep_pens[i] == 1.0
            and self.pres_pens[i] == 0.0
            and self.freq_pens[i] == 0.0
            and self.min_ps[i] == 0.0
            and not self.has_bias[i]
            and not self.want_logprobs[i]
            for i in live
        )

    def _plain_step(self, live: list) -> dict[int, int]:
        self._decode_state()
        logits = self._decode()
        if self._all_greedy(live):
            # argmax only: the sampler's [B, V] sort buys nothing here
            sampled = self._argmax(logits)
        else:
            self._sampling_params()
            sampled = self._sample(logits, self._slot_iota)
            self._mark_seen(self._slot_iota, sampled)
            if any(self.want_logprobs[i] for i in live):
                lp, tids, tlps = (a.tolist() for a in self._logprobs(logits, sampled))
                for i in live:
                    if self.want_logprobs[i]:
                        self._last_logprobs[i] = (lp[i], list(zip(tids[i], tlps[i])))
        self._advance_state(sampled)
        out = self._emit(live, sampled.tolist())
        self.stats["decode_steps"] += 1
        return out

    def _advance_slot(self, i: int, tok: int) -> bool:
        """Publish ONE sampled token for slot ``i``, shared by the plain,
        speculative and turbo paths: length/budget accounting, the n-gram
        history, and the eos→stop / budget→length finish rules. Returns
        whether the slot is still active."""
        self.lengths[i] += 1
        self.remaining[i] -= 1
        self.last_token[i] = tok
        self._record_tokens(i, [tok])
        if tok == self.eos[i]:
            self.active[i] = False
            self.finish_reason[i] = "stop"
        elif self.remaining[i] <= 0 or self.lengths[i] >= self.max_seq - 1:
            self.active[i] = False
            self.finish_reason[i] = "length"
        return self.active[i]

    def _emit(self, live: list, toks: list) -> dict[int, int]:
        """Publish one sampled token per live slot (host bookkeeping). The
        mirror stays valid: ``advance_state`` applied the same transition
        on the device."""
        out: dict[int, int] = {}
        for i in live:
            out[i] = toks[i]
            self._advance_slot(i, toks[i])
        return out

    def take_logprobs(self, slot: int):
        """(logprob, [(alt_id, alt_lp), ...]) of the slot's most recent
        token, or None when the request did not ask for logprobs."""
        return self._last_logprobs.pop(slot, None)

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self._invalidate_decode_cache()
        self._prefilling.pop(slot, None)
        self._admit_t0.pop(slot, None)
        self._trace_ids.pop(slot, None)
        self._last_logprobs.pop(slot, None)

    def warm_prefix_copies(self) -> None:
        """Compile every chunk-aligned prefix-copy variant, slot 0 onto
        itself (which changes nothing), so that no request's TTFT pays for
        one and no copy counts as a recompile: JAX's loop over p = C, 2C,
        ... < max_seq, called by the server's warmup before the warm
        mark."""
        if not self.prefix_cache:
            return
        zero = self.slot_index(0)
        p = self.prefill_chunk
        while p < self.max_seq:
            self.get_copy_fn(p)(zero, zero)
            p += self.prefill_chunk

    def mark_flight_warm(self) -> None:
        """Declare the warmup complete: any compile the flight recorder
        observes from here on is a steady-state recompile
        (``dtpu_serve_recompiles_total``), and one of a key the warmup
        never visited also a warmup-coverage gap. Called by the server's
        warmup after its traffic; per engine."""
        self._flight_warm = True

    @property
    def flight_warm(self) -> bool:
        return self._flight_warm

    def _note_boot_compile(self, fn_name: str, key, seconds: float, recompile: bool) -> None:
        """``watch_jit``'s on_compile hook: a compile before the warm mark
        joins the boot-compile manifest; one after it, of a variant the
        manifest lacks, is a warmup-coverage gap
        (``dtpu_serve_warmup_gap_compiles_total{fn}``)."""
        mk = obs_boot.manifest_key(fn_name, key)
        if not self._flight_warm:
            self._compile_manifest.add(mk)
            return
        if mk not in self._compile_manifest:
            self.metrics.family("dtpu_serve_warmup_gap_compiles_total").inc(1, fn_name)
            logger.warning(
                "warmup-coverage gap: %s compiled %.3fs post-warm but was never visited by "
                "warmup (manifest of %d variants)", mk, seconds, len(self._compile_manifest),
            )

    def compile_manifest(self) -> set:
        """The boot-compile manifest: every ``manifest_key`` the warmup
        visited (a copy)."""
        return set(self._compile_manifest)

    def reset_prefix_cache(self) -> None:
        """Forget every registered reusable prompt prefix (no device
        work: the rows just stop being reuse candidates)."""
        self._prefix_registry.clear()

    def forget_requests(self) -> None:
        """Return an idle engine's request state to a fresh engine's (the
        server's warmup): no reusable prefix, no seen-token counts or
        logprobs, no sampling streams, the unseeded requests' seeds and
        the turbo cap from the start. The stats stay, and so do the
        cache's rows: no request reads past its own positions."""
        if any(self.active) or self._prefilling:
            raise RuntimeError("forget_requests: a request is still in a slot")
        self.reset_prefix_cache()
        self._auto_seed = self._seed
        self._key_data.zero_()
        self._seen.zero_()
        self._gen_counts.zero_()
        self._last_logprobs.clear()
        self._turbo_k = min(8, self.turbo_steps) or self.turbo_steps
        self._last_admit = 0.0

    def kv_cache_utilization(self) -> float:
        """Cached tokens across live (active or prefilling) slots as a
        fraction of the cache's capacity. The server reads it on its
        event loop while the scheduler mutates slots on a worker thread:
        the prefill dict is snapshotted first."""
        prefilling = list(self._prefilling.values())
        live_tokens = sum(
            self.lengths[i] for i in range(self.max_batch) if self.active[i]
        ) + sum(st["next"] for st in prefilling)
        return live_tokens / float(self.max_batch * self.max_seq)

    def prefix_stats(self) -> dict:
        """Prefix-cache registry occupancy for ``/health``: lifetime hit
        count, occupied registry slots, occupancy ratio, and the cached
        prompt tokens still reusable (snapshotted like
        :meth:`kv_cache_utilization`)."""
        cached = list(self._prefix_registry.values())
        return {
            "prefix_hits": self.stats["prefix_hits"],
            "prefix_slots": len(cached),
            "prefix_occupancy": round(len(cached) / float(self.max_batch), 6),
            "prefix_tokens": sum(len(p) for p in cached),
        }

    def update_state_gauges(self) -> None:
        """Refresh the engine-state gauges (at scrape time, on the event
        loop while a step may run on the worker thread: the slot list is
        snapshotted first, and so are the dicts by the helpers). The
        device-memory gauges read the allocator's counts of the engine's
        card; on the CPU they stay unset, absent rather than zero."""
        active = sum(1 for a in list(self.active) if a)
        m = self.metrics
        m.family("dtpu_serve_active_slots").set(active)
        m.family("dtpu_serve_max_slots").set(self.max_batch)
        m.family("dtpu_serve_batch_occupancy_ratio").set(active / float(self.max_batch))
        m.family("dtpu_serve_kv_cache_utilization_ratio").set(round(self.kv_cache_utilization(), 6))
        m.family("dtpu_serve_prefix_slots").set(self.prefix_stats()["prefix_slots"])
        # the memoized site grids, as JAX counts its jit grids
        entries = m.family("dtpu_serve_compile_cache_entries")
        entries.set(len(self._chunk_fns), "chunk")
        entries.set(len(self._packed_fns), "packed")
        entries.set(len(self._turbo_sites), "turbo")
        entries.set(len(self._copy_fns), "copy")
        # scrape-time memory freshness through the flight recorder's
        # throttled poll; without a recorder, the engine's card directly
        if flight.maybe_poll_memory(m) is None and self.device.type == "cuda":
            in_use = m.family("dtpu_serve_device_memory_bytes_in_use")
            peak = m.family("dtpu_serve_device_memory_peak_bytes")
            in_use.set(torch.cuda.memory_allocated(self.device))
            # a running high-water mark across polls, as JAX keeps it
            peak.set(max(peak.value(), torch.cuda.max_memory_allocated(self.device)))

    def generate(self, prompt: list[int], gen: GenParams) -> list[int]:
        """Convenience single-prompt generation (tests, CLI)."""
        slot, tok = self.add_request(prompt, gen)
        out = [tok]
        if tok == gen.eos_id:
            return out
        while self.active[slot]:
            for tok in self.step().get(slot, []):
                if tok == gen.eos_id:
                    break
                out.append(tok)
        self.release(slot)
        return out
