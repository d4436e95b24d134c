"""KV-cache inference engine for dense Llama on PyTorch (counterpart of
dstack_tpu.serve.engine).

The engine owns a fixed pool of ``max_batch`` sequence slots over
preallocated KV caches ``[L, B, Hkv, T_max, D]``; a request prefills its
prompt chunk by chunk into a free slot, and every decode step advances
all active slots at once (continuous batching). Where the JAX engine
donates the cache buffers to its jitted steps (dstack_tpu/serve/
engine.py:1880) so XLA updates them in place, the port writes the cache
tensors in place and hands the same dict back.

Attention runs through the port's hand-written Hopper kernels on the
card: every prefill chunk through the flash forward kernel
(ops/flash.py) and every decode step's cache attention through the
ragged flash-decode kernel (ops/flash_decode.py). On the CPU both take
their plain versions, which is what the parity tests run.

This slice ports the serial path only: ``prefill_pack`` 0/1,
``spec_draft=0``, ``turbo_steps=0``, ``prefix_cache=False`` and the bf16
cache. Other values of those switches and the int8 cache raise
``NotImplementedError``; token logprobs are not ported yet.
"""

import time
from dataclasses import dataclass
from typing import Optional

import torch

from dstack_tpu_torch.models.llama import (
    LlamaConfig,
    _proj,
    act_fn,
    apply_rope,
    dual_rope_freqs,
    embed_tokens,
    head_matmul,
    layer_params,
    model_norm,
)
from dstack_tpu_torch.ops.attention import attention
from dstack_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_plain,
    flash_decode_supported,
)
NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_cache(
    config: LlamaConfig, max_batch: int, max_seq: int, device="cuda", kv_quant=None
) -> dict:
    """Preallocated KV cache: k/v ``[L, B, Hkv, T_max, D]`` in the model
    dtype (the int8 cache comes with the kv_quant slice)."""
    if kv_quant is not None:
        raise NotImplementedError("init_cache: the int8 KV cache comes with the kv_quant slice")
    shape = (config.n_layers, max_batch, config.n_kv_heads, max_seq, config.head_dim)
    return {
        n: torch.zeros(shape, dtype=config.dtype, device=device) for n in ("k", "v")
    }


def _cwrite_chunk(ckv: torch.Tensor, new: torch.Tensor, slot: int, start: int) -> torch.Tensor:
    """Write a prefill chunk ``new [1, H, C, D]`` at (slot, start) in
    place. ``lax.dynamic_update_slice`` CLAMPS an out-of-range start so
    the slice fits; torch slicing would silently shorten the write, so
    the clamp is explicit (the engine keeps ``start + C <= T_max``)."""
    b, _, t, _ = ckv.shape
    c = new.shape[2]
    slot = min(max(int(slot), 0), b - 1)
    start = min(max(int(start), 0), t - c)
    ckv[slot, :, start : start + c] = new[0]
    return ckv


def _cread_row(ckv: torch.Tensor, slot: int) -> torch.Tensor:
    """One slot's row ``[1, H, T_max, D]`` (a view; slot clamped as
    ``dynamic_slice`` does)."""
    slot = min(max(int(slot), 0), ckv.shape[0] - 1)
    return ckv[slot : slot + 1]


def _cwrite_at(
    ckv: torch.Tensor, batch_ix: torch.Tensor, write_pos: torch.Tensor, new: torch.Tensor
) -> torch.Tensor:
    """Scatter per-slot tokens ``new [B, H, D]`` at ``[B]`` positions in
    place. JAX's ``mode="drop"`` discards rows whose position is out of
    range (inactive slots get ``T_max``); torch indexing would raise or
    wrap, so those rows write their own old value back instead — no
    device-to-host sync for a mask."""
    t = ckv.shape[2]
    valid = (write_pos >= 0) & (write_pos < t)
    pos = torch.where(valid, write_pos, torch.zeros_like(write_pos)).long()
    old = ckv[batch_ix, :, pos]  # [B, H, D]
    ckv[batch_ix, :, pos] = torch.where(valid[:, None, None], new.to(ckv.dtype), old)
    return ckv


def _cfull(ckv: torch.Tensor) -> torch.Tensor:
    """The whole cache tensor in compute dtype (bf16 cache: itself)."""
    return ckv


# ---------------------------------------------------------------------------
# model: prefill + single-token decode over the cache
# ---------------------------------------------------------------------------


def _apply_rope_batch(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, 1, D]; cos/sin [B, D/2] (per-slot positions), cast to
    x's dtype before the multiply; rotate-half, not interleaved."""
    c = cos[:, None, None, :].to(x.dtype)
    s = sin[:, None, None, :].to(x.dtype)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mlp(x: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    """x + MLP sublayer (shared by prefill and decode)."""
    return x + _mlp_out(x, layer, c)


def _mlp_out(x: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    m = model_norm(x, layer["mlp_norm"], c)
    u = _proj(layer, "w_up", m)
    g = _proj(layer, "w_gate", m)
    return _proj(layer, "w_down", act_fn(c)(g) * u)


def _qkv(h: torch.Tensor, layer: dict, c: LlamaConfig) -> tuple:
    return _proj(layer, "wq", h), _proj(layer, "wk", h), _proj(layer, "wv", h)


def _embed_lookup(params: dict, tokens: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    """Embedding rows; out-of-range ids give zeros (JAX ``mode="fill"``)."""
    return embed_tokens(params, tokens, c)


def _head_logits(params: dict, x: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    """Post-final-norm hidden [..., E] → f32 logits [..., V]."""
    return head_matmul(params, x, c)


def _scan_layers_kv(params: dict, cache: dict, x: torch.Tensor, one_layer, c: LlamaConfig):
    """Drive ``one_layer(x, layer, ck, cv, window) -> x`` over the layers
    (the Python loop where JAX runs ``lax.scan``); ``ck``/``cv`` are the
    layer's cache views, updated in place → (final hidden, cache)."""
    for i in range(c.n_layers):
        x = one_layer(x, layer_params(params, i), cache["k"][i], cache["v"][i], 0)
    return x, cache


def _prefill_one_layer(c: LlamaConfig, ropes: tuple, *, kv_update, q_offset: int, impl=None):
    """The dense prefill attention + MLP sublayer of one chunk."""
    scale = c.attention_scale
    cos, sin = ropes[0]

    def one_layer(x, layer, ck, cv, window):
        b, cl = x.shape[0], x.shape[1]
        h = model_norm(x, layer["attn_norm"], c)
        q, k, v = _qkv(h, layer, c)
        q = q.view(b, cl, c.n_heads, c.head_dim).transpose(1, 2)
        k = k.view(b, cl, c.n_kv_heads, c.head_dim).transpose(1, 2)
        v = v.view(b, cl, c.n_kv_heads, c.head_dim).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # write the chunk K/V into the slot row, then attend over the
        # whole row: keys past the causal frontier are masked (and the
        # kernel never reads their tiles), so stale data is never used
        row_k, row_v = kv_update(ck, cv, k, v)
        o = attention(
            q.contiguous(), row_k, row_v, causal=True, scale=scale,
            q_offset=q_offset, window=window, impl=impl,
        )
        o = o.transpose(1, 2).reshape(b, cl, c.q_dim)
        x = x + _proj(layer, "wo", o)
        return _mlp(x, layer, c)

    return one_layer


def prefill_chunk_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [1, C] int (right-padded on the last chunk)
    slot: int,
    last_ix: int,  # the prompt's last real index MINUS start
    config: LlamaConfig,
    *,
    start: int,  # global position of the chunk's first token
    impl: Optional[str] = None,  # attention impl: None = by device | "plain"
) -> tuple[torch.Tensor, dict]:
    """One prompt chunk → (f32 logits at ``last_ix`` [1, V], cache).

    The chunk's K/V are written into the slot's cache row first, then
    the chunk queries attend over the row with causal masking at the
    offset ``start`` — the flash kernel's ``q_offset``."""
    c = config
    x = _embed_lookup(params, tokens, c)
    chunk_pos = start + torch.arange(tokens.shape[1], device=tokens.device)

    def kv_update(ck, cv, k, v):
        _cwrite_chunk(ck, k, slot, start)
        _cwrite_chunk(cv, v, slot, start)
        return _cread_row(ck, slot), _cread_row(cv, slot)

    one_layer = _prefill_one_layer(
        c, dual_rope_freqs(c, chunk_pos), kv_update=kv_update, q_offset=int(start), impl=impl,
    )
    x, cache = _scan_layers_kv(params, cache, x, one_layer, c)
    x = model_norm(x, params["final_norm"], c)
    return _head_logits(params, x[:, int(last_ix)], c), cache


def _flash_attend(q_rows, ck, cv, positions, window, *, config, scale):
    """Decode attention through the ragged kernel (``mesh=None`` form of
    the JAX ``_flash_attend``: no int8 tuple, no sinks, no softcap, one
    row per slot)."""
    return flash_decode(q_rows, ck, cv, positions, scale=scale, window=window)


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
    attention over the full row — the reference the kernel is held to."""
    c = config
    b = tokens.shape[0]
    t_max = cache["k"].shape[3]
    positions = positions.to(torch.int32)
    if write_mask is None:
        write_mask = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    # out-of-range positions drop the write (_cwrite_at)
    write_pos = torch.where(write_mask, positions, torch.full_like(positions, t_max))
    x = _embed_lookup(params, tokens, c)[:, None, :]
    (cos, sin), _ = dual_rope_freqs(c, positions)  # [B, D/2]
    batch_ix = torch.arange(b, device=tokens.device)
    scale = c.attention_scale
    grp = c.n_heads // c.n_kv_heads
    window = 0  # dense Llama: full attention on every layer

    for i in range(c.n_layers):
        layer = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]  # [B, Hkv, Tmax, D] views
        h = model_norm(x, layer["attn_norm"], c)
        q, k, v = _qkv(h, layer, c)
        q = q.view(b, 1, c.n_heads, c.head_dim).transpose(1, 2)
        k = k.view(b, 1, c.n_kv_heads, c.head_dim).transpose(1, 2)
        v = v.view(b, 1, c.n_kv_heads, c.head_dim).transpose(1, 2)
        q = _apply_rope_batch(q, cos, sin)
        k = _apply_rope_batch(k, cos, sin)
        _cwrite_at(ck, batch_ix, write_pos, k[:, :, 0, :])
        _cwrite_at(cv, batch_ix, write_pos, v[:, :, 0, :])
        # q regrouped [B, Hkv, G, D] against the [B, Hkv, T, D] cache:
        # the cache is read once at KV width, never G times
        qg = q[:, :, 0, :].reshape(b, c.n_kv_heads, grp, c.head_dim).contiguous()
        if decode_kernel == "flash":
            o = _flash_attend(qg, ck, cv, positions, window, config=c, scale=scale)
        else:
            o = flash_decode_plain(
                qg, _cfull(ck), _cfull(cv), positions, scale=scale, window=window
            )
        # [B, Hkv, G, D] row-major flatten == query-head order
        o = o.reshape(b, 1, c.q_dim)
        x = x + _proj(layer, "wo", o)
        x = _mlp(x, layer, c)
    x = model_norm(x, params["final_norm"], c)
    return _head_logits(params, x[:, 0], c), cache


def advance_decode_state(tok, pos, rem, act, eos_ids, sampled, *, max_seq: int):
    """One decode step's slot-state transition → (tok, pos, rem, act):
    the device mirror of the host replay in ``_advance_slot``."""
    new_tok = torch.where(act, sampled.to(tok.dtype), tok)
    step = act.to(pos.dtype)
    pos = pos + step
    rem = rem - step
    act = act & (new_tok != eos_ids) & (rem > 0) & (pos < max_seq - 1)
    return new_tok, pos, rem, act


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _gumbel(generator: torch.Generator, v: int, device) -> torch.Tensor:
    """One draw of the slot's stream: [V] Gumbel noise (JAX's
    ``categorical`` is Gumbel-max too)."""
    u = torch.rand((v,), generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def skip_draws(generator: torch.Generator, n: int, v: int, device) -> None:
    """Advance a slot's stream by ``n`` draws, replaying exactly what
    :func:`sample` consumes per token (counterpart of ``skip_key_data``):
    a resumed seeded request continues the original stream."""
    for _ in range(int(n)):
        torch.rand((v,), generator=generator, device=device)


def sample(
    logits: torch.Tensor,  # [B, V] f32
    generators: list,  # [B] torch.Generator, or None for a row that draws nothing
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
    computes it. Each sampling row draws from its own slot generator
    (one draw per token), so a request's stream depends only on its seed;
    the stream differs from JAX's threefry, so only greedy output is
    comparable token for token across the two packages."""
    v = logits.shape[-1]
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
    sampled = greedy.clone()
    for i, g in enumerate(generators):
        if g is not None:
            sampled[i] = (masked[i] + _gumbel(g, v, logits.device)).argmax()
    return torch.where(temperature <= 0.0, greedy, sampled)


def _mark_seen(counts, gen_counts, rows, tokens) -> None:
    """Count sampled tokens in both maps (in place)."""
    one = torch.ones_like(tokens, dtype=counts.dtype)
    counts.index_put_((rows, tokens.long()), one, accumulate=True)
    gen_counts.index_put_((rows, tokens.long()), one, accumulate=True)


def _mark_prompt(counts, gen_counts, slot: int, prompt: list) -> None:
    """Reset the slot's rows and count the prompt in the all-tokens map
    only (out-of-vocab ids dropped, as JAX's ``mode="drop"``)."""
    v = counts.shape[-1]
    ids = torch.tensor([t for t in prompt if 0 <= t < v], dtype=torch.long)
    counts[slot] = torch.bincount(ids, minlength=v).to(counts.device, counts.dtype)
    gen_counts[slot].zero_()


# ---------------------------------------------------------------------------
# the engine: slots + continuous batching
# ---------------------------------------------------------------------------


class InferenceEngine:
    """Slot-based continuous batching over the decode step (the serial
    path of the JAX ``InferenceEngine``). Synchronous; the OpenAI server
    drives it from one scheduler task (``start_request`` into a free
    slot, ``prefill_wave`` chunk by chunk, ``step`` for every active
    slot)."""

    def __init__(
        self,
        config: LlamaConfig,
        params: dict,
        max_batch: int = 8,
        max_seq: int = 2048,
        seed: int = 0,
        prefill_chunk: int = 256,
        prefill_pack: int = 1,
        spec_draft: int = 0,
        turbo_steps: int = 0,
        prefix_cache: bool = False,
        kv_quant=None,
        decode_kernel: Optional[str] = None,  # None/"flash" | "einsum"
        device="cuda",
    ):
        self.device = resolve_device(device)
        later = {
            "prefill_pack > 1 (packed prefill)": prefill_pack > 1,
            "spec_draft > 0 (speculative verify)": spec_draft > 0,
            "turbo_steps > 1 (device macro-steps)": turbo_steps > 1,
            "prefix_cache=True": bool(prefix_cache),
            "kv_quant (int8 KV cache)": kv_quant is not None,
        }
        todo = [k for k, on in later.items() if on]
        if todo:
            raise NotImplementedError(
                f"InferenceEngine: {todo} not ported yet; the PyTorch port "
                "serves the serial path (prefill_pack=1, spec_draft=0, "
                "turbo_steps=0, prefix_cache=False, bf16 cache)"
            )
        if decode_kernel not in (None, "flash", "einsum"):
            raise ValueError(
                f"decode_kernel={decode_kernel!r}: expected 'flash' or 'einsum'"
            )
        self.decode_kernel = decode_kernel or "flash"
        if self.decode_kernel == "flash" and not flash_decode_supported(config, max_seq):
            raise ValueError("decode_kernel='flash' unsupported for this model (head_dim, GQA group)")
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is {self.device}"
            )
        self.config = config
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache = init_cache(config, max_batch, max_seq, device=self.device)
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
        # per-slot sampling streams and seen-token counts for penalties
        self._generators: list = [None] * max_batch
        v = config.vocab_size
        dev = self.device
        self._seen = torch.zeros((max_batch, v), dtype=torch.int32, device=dev)
        self._gen_counts = torch.zeros((max_batch, v), dtype=torch.int32, device=dev)
        self._logit_bias = torch.zeros((max_batch, v), dtype=torch.float32, device=dev)
        self._slot_iota = torch.arange(max_batch, device=dev)
        # device mirrors of host lists, rebuilt after a host-side slot
        # mutation (_invalidate_decode_cache)
        self._sampling_state = None
        self._decode_mirror = None
        # pending chunked prefills: slot → {prompt, tp, next, gen}
        self._prefilling: dict[int, dict] = {}
        self.prefill_chunk = max(16, min(prefill_chunk, max_seq))
        self.last_wave_slots: list = []
        # serving counts on the host: with the kernels' launch counts
        # they show which path a run took. TTFT runs from admission to
        # the first sampled token; decode time is the host clock around
        # each step, which ends in a device-to-host copy of its tokens
        self.stats = {
            "prefill_dispatches": 0,
            "decode_steps": 0,
            "decode_tokens": 0,
            "decode_seconds": 0.0,
            "ttft_count": 0,
            "ttft_sum_s": 0.0,
            "ttft_max_s": 0.0,
        }
        self._admit_t0: dict[int, float] = {}

    def free_slots(self) -> list[int]:
        return [
            i for i in range(self.max_batch)
            if not self.active[i] and i not in self._prefilling
        ]

    def start_request(self, prompt: list[int], gen: GenParams) -> int:
        """Reserve a slot and queue the prompt for chunked prefill (host
        bookkeeping only). Raises RuntimeError when full."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        # cap the generation budget by the cache, then keep as much
        # prompt tail as fits alongside it (never less than 1 token)
        gen.max_new_tokens = max(1, min(gen.max_new_tokens, self.max_seq - 2))
        keep = max(1, self.max_seq - 1 - gen.max_new_tokens)
        if len(prompt) > keep:
            prompt = prompt[-keep:]
        slot = min(free)
        self._admit_t0[slot] = time.perf_counter()
        self._prefilling[slot] = {
            "prompt": list(prompt),
            "tp": len(prompt),
            "next": 0,  # next chunk's global start position
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
        logits, self.cache = prefill_chunk_step(
            self.params, self.cache,
            torch.tensor([chunk], dtype=torch.long, device=self.device),
            slot, last_ix, self.config, start=start,
        )
        self.stats["prefill_dispatches"] += 1
        if not final:
            st["next"] = start + cl
            return None
        gen = st["gen"]
        if self._prefilling.pop(slot, None) is None:
            return None  # released while the final chunk ran
        return self._activate(slot, st["prompt"], tp, gen, logits)

    def prefill_wave(self) -> dict[int, int]:
        """ONE prefill dispatch → {slot: first token} for a prompt that
        completed (serial branch: the oldest pending prompt, one chunk)."""
        pending = list(self._prefilling)  # admission order
        if not pending:
            return {}
        slot = pending[0]
        self.last_wave_slots = [slot]
        tok = self.prefill_step(slot)
        return {} if tok is None else {slot: tok}

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
        g = torch.Generator(device=self.device)
        g.manual_seed(req_seed)
        if gen.seed is not None and gen.seed_skip > 0:
            skip_draws(g, gen.seed_skip, self.config.vocab_size, self.device)
        self._generators[slot] = g
        _mark_prompt(self._seen, self._gen_counts, slot, prompt[:tp])
        if gen.logit_bias or self.has_bias[slot]:
            row = torch.zeros((self.config.vocab_size,), dtype=torch.float32)
            for tid, bv in (gen.logit_bias or {}).items():
                t = int(tid)
                if 0 <= t < self.config.vocab_size:
                    row[t] = float(bv)
            self._logit_bias[slot] = row.to(self.device)
        self.min_ps[slot] = gen.min_p
        self.has_bias[slot] = bool(gen.logit_bias)
        self.temps[slot] = gen.temperature
        self.top_ps[slot] = gen.top_p
        self.top_ks[slot] = gen.top_k
        self.rep_pens[slot] = gen.repetition_penalty
        self.pres_pens[slot] = gen.presence_penalty
        self.freq_pens[slot] = gen.frequency_penalty
        self._invalidate_decode_cache()
        temps, top_ps, top_ks, rep_pens, pres_pens, freq_pens, min_ps = self._sampling_params()
        row = slice(slot, slot + 1)
        toks = sample(
            logits,
            [g if gen.temperature > 0.0 else None],
            temps[row], top_ps[row], top_ks[row], rep_pens[row],
            self._seen[row], pres_pens[row], freq_pens[row],
            self._gen_counts[row], self._logit_bias[row], min_ps[row],
        )
        tok = int(toks[0])
        _mark_seen(self._seen, self._gen_counts, self._slot_iota[row], toks)
        t_admit = self._admit_t0.pop(slot, None)
        if t_admit is not None:
            ttft = time.perf_counter() - t_admit
            self.stats["ttft_count"] += 1
            self.stats["ttft_sum_s"] += ttft
            self.stats["ttft_max_s"] = max(self.stats["ttft_max_s"], ttft)
        self.active[slot] = True
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

    def step(self) -> dict:
        """Advance every active slot one token → {slot: [token]}. Slots
        that hit EOS, their budget or the cache end deactivate."""
        live = [i for i in range(self.max_batch) if self.active[i]]
        if not live:
            return {}
        return {i: [tok] for i, tok in self._plain_step(live).items()}

    def _invalidate_decode_cache(self) -> None:
        """EVERY host-side slot-state mutation must call this, or the
        next step would run from stale device mirrors."""
        self._decode_mirror = None
        self._sampling_state = None

    def _sampling_params(self) -> tuple:
        """Device mirrors of the seven per-slot sampling-parameter lists."""
        if self._sampling_state is None:
            fields = (
                (self.temps, torch.float32),
                (self.top_ps, torch.float32),
                (self.top_ks, torch.int64),
                (self.rep_pens, torch.float32),
                (self.pres_pens, torch.float32),
                (self.freq_pens, torch.float32),
                (self.min_ps, torch.float32),
            )
            self._sampling_state = tuple(
                torch.tensor(v, dtype=dt, device=self.device) for v, dt in fields
            )
        return self._sampling_state

    def _decode_state(self) -> tuple:
        """Device mirrors of (token, position, budget, active, eos)."""
        if self._decode_mirror is None:
            eos = [e if e is not None else -1 for e in self.eos]
            dev = self.device
            self._decode_mirror = (
                torch.tensor(self.last_token, dtype=torch.long, device=dev),
                torch.tensor(self.lengths, dtype=torch.int32, device=dev),
                torch.tensor(self.remaining, dtype=torch.int32, device=dev),
                torch.tensor(self.active, dtype=torch.bool, device=dev),
                torch.tensor(eos, dtype=torch.long, device=dev),
            )
        return self._decode_mirror

    def _all_greedy(self, live: list) -> bool:
        """Every live slot plain-greedy with no penalties or bias."""
        return all(
            self.temps[i] <= 0.0
            and self.rep_pens[i] == 1.0
            and self.pres_pens[i] == 0.0
            and self.freq_pens[i] == 0.0
            and self.min_ps[i] == 0.0
            and not self.has_bias[i]
            for i in live
        )

    def _plain_step(self, live: list) -> dict[int, int]:
        t0 = time.perf_counter()
        tok_d, pos_d, rem_d, act_d, eos_d = self._decode_state()
        logits, self.cache = decode_step(
            self.params, self.cache, tok_d, pos_d, self.config,
            write_mask=act_d, decode_kernel=self.decode_kernel,
        )
        sp = None
        if self._all_greedy(live):
            # argmax only: the sampler's [B, V] sort buys nothing here
            sampled = logits.argmax(dim=-1)
        else:
            sp = self._sampling_params()
            temps, top_ps, top_ks, rep_pens, pres_pens, freq_pens, min_ps = sp
            gens = [
                self._generators[i] if self.active[i] and self.temps[i] > 0.0 else None
                for i in range(self.max_batch)
            ]
            sampled = sample(
                logits, gens, temps, top_ps, top_ks, rep_pens, self._seen,
                pres_pens, freq_pens, self._gen_counts, self._logit_bias, min_ps,
            )
            _mark_seen(self._seen, self._gen_counts, self._slot_iota, sampled)
        adv = advance_decode_state(
            tok_d, pos_d, rem_d, act_d, eos_d, sampled, max_seq=self.max_seq
        )
        out = self._emit(live, sampled.tolist())
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(live)
        self.stats["decode_seconds"] += time.perf_counter() - t0
        # the host replay applied the same transition as the device
        # advance, so the advanced arrays are the valid next inputs
        self._decode_mirror = (*adv, eos_d)
        if sp is not None:
            self._sampling_state = sp  # the per-token advance never touches them
        return out

    def _advance_slot(self, i: int, tok: int) -> bool:
        """Publish ONE sampled token for slot ``i`` (length/budget
        accounting and the eos→stop / budget→length finish rules).
        Returns whether the slot is still active."""
        self.lengths[i] += 1
        self.remaining[i] -= 1
        self.last_token[i] = tok
        if tok == self.eos[i]:
            self.active[i] = False
            self.finish_reason[i] = "stop"
        elif self.remaining[i] <= 0 or self.lengths[i] >= self.max_seq - 1:
            self.active[i] = False
            self.finish_reason[i] = "length"
        return self.active[i]

    def _emit(self, live: list, toks: list) -> dict[int, int]:
        """Publish one sampled token per live slot (host bookkeeping)."""
        self._invalidate_decode_cache()
        out: dict[int, int] = {}
        for i in live:
            out[i] = toks[i]
            self._advance_slot(i, toks[i])
        return out

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self._invalidate_decode_cache()
        self._prefilling.pop(slot, None)
        self._admit_t0.pop(slot, None)

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

