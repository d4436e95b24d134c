"""Dense Llama for the PyTorch port (counterpart of dstack_tpu.models.llama).

Parameters are a plain dict of tensors in the JAX package's layout:
layers stacked on a leading ``[L, ...]`` dim (``param_specs`` at
dstack_tpu/models/llama.py:548), so one JAX leaf maps to exactly one
tensor and :func:`params_from_jax` is a key-for-key copy. The serving
engine loops over layers in Python where JAX runs ``lax.scan``.

Of the JAX config's model-family deltas the port carries the gpt-oss
ones (llama.py:45-59,160-174): sparse experts (``models/moe.py``), q/k/v
and output biases, attention sinks, alternating sliding windows, the
linear top-k-softmax router with expert biases, the clamped GLU and
yarn rope; and the Gemma ones (llama.py:54-76): the tanh GELU, RMSNorm
scaling by (1 + w), the sqrt(H) embedding scale, sandwich norms around
both sublayers, the attention and final-logit tanh caps, per-head q/k
norms and Gemma3's dual rope (a local theta on sliding layers, linear
interpolation on global ones). The layer pieces that carry them
(:func:`_qkv_heads`, :func:`_attn_out`, :func:`_mlp_out`,
:func:`_embed_lookup`, :func:`_head_logits`) live here, as JAX keeps
them in its model module, and both the serving engine and the
whole-sequence :func:`forward` call them. DeepSeek's deltas
(llama.py:138-170) are here too: MLA's latent projections (the engine
keeps its absorbed attention), the router's sigmoid scores, selection
bias, group limit and routed scale, the shared expert, and the dense
prelude layers in ``params["dense_layers"]`` (:func:`layer_stack` walks
both stacks in order). So are the dense families' (llama.py:105-139):
Qwen2/GLM/StarCoder2's q/k/v biases, Qwen3's per-head q/k norms, Mistral's
uniform window, the three LayerNorm flavours (Cohere's weight-only
``layernorm``, Nemotron's ``layernorm1p`` and StarCoder2's
``layernorm_bias``, the latter two stored stacked ``[..., 2, H]`` as
(scale, bias)), Cohere's parallel block over one input norm, per-head
LayerNorm q/k norms and logit scale, OLMo-2's post-norm-only layers and
flat q/k norms, Nemotron and StarCoder2's gateless MLP (with StarCoder2's
MLP biases) and relu², GLM's interleaved partial rope and Nemotron's
rotate-half one (:func:`rotate`), and Granite's embedding, residual
and attention multipliers. Serving runs every delta; :func:`forward`
(training) runs the dense Llama and Gemma families, Qwen3 and Mistral,
and refuses gpt-oss and the other dense-family deltas under autograd
(:func:`check_trainable`). Llama4's deltas (NoPE layers, chunked
attention, the sigmoid-input router) are here too (llama.py:78-99,
956-982, 1224-1235): every ``nope_pattern``-th layer skips rope and
scales its queries by a position-dependent temperature
(:func:`layer_nope`, :func:`attn_temp_scales`), rope layers apply the
weightless L2 q/k norm after rope (:func:`l2_norm`) and attend within
``attention_chunk_size`` blocks, and the router gates the expert input
with sigmoid(top-k logit). Cohere2's NoPE layers are its global layers
(:func:`check_layer_layout`). They run with autograd off and are
refused under autograd (ROADMAP A5.9).

:func:`forward` is the whole-sequence forward the trainer differentiates
(counterpart of ``forward``, dstack_tpu/models/llama.py:1431): attention
through ``FlashAttention`` (K1 forward, K2/K3 backward on the card), the
LoRA bypass in every projection, and, with ``config.remat``, each layer
recomputed in the backward but for its flash call: q, k, v, o and lse
are kept across the remat boundary, as JAX's ``flash_residuals`` are
(llama.py:1494-1504), so K1 runs once a layer and micro-batch
(:func:`_layer_remat`).
"""

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dstack_tpu_torch.ops import w8_matmul
from dstack_tpu_torch.ops.attention import attention

@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # Llama-3.1+ rope scaling: (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings), or the tagged
    # forms ("llama3", ...) / ("linear", factor); None = plain rope
    rope_scaling: Optional[tuple] = None
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    # recompute each layer's activations in the backward (training only)
    remat: bool = True
    # Mixture-of-Experts (models/moe.py): n_experts == 0 → dense MLP
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    # the router's Switch aux losses in the training objective (load balance
    # and z-loss, models/moe.py)
    router_balance_coef: float = 0.01
    router_z_coef: float = 1e-3
    # --- gpt-oss deltas (all default to Llama behavior) ---
    qkv_bias: bool = False  # biases bq/bk/bv on the q/k/v projections
    proj_bias: bool = False  # bias bo on the o projection
    # learned per-head sink logits joining the softmax denominator only
    # (params["layers"]["sinks"], f32)
    attn_sinks: bool = False
    sliding_window: int = 0  # 0 = full attention
    # every `sliding_pattern` layers the LAST is global, the rest use the
    # window (pattern 2: layers 0, 2, ... sliding); 0/1 = uniform window
    sliding_pattern: int = 0
    # linear router (f32 bias b_router), gates softmaxed over the top-k
    # logits only
    router_topk_softmax: bool = False
    # biases on every expert matmul (b_gate/b_up_e [E,F], b_down_e [E,H])
    moe_bias: bool = False
    # expert activation: "silu" (SwiGLU) | "oai_glu" (clamped glu:
    # (up+1) * gate * sigmoid(1.702 * gate), inputs clamped to act_limit)
    moe_act: str = "silu"
    act_limit: float = 7.0
    # --- Gemma deltas (all default to Llama behavior) ---
    hidden_act: str = "silu"  # "silu" | "gelu_tanh" (Gemma)
    norm_offset: bool = False  # RMSNorm scales by (1 + w): w = 0 is identity
    embed_scale: bool = False  # embeddings times sqrt(H), cast to the model dtype
    post_norms: bool = False  # Gemma2/3 sandwich norms on the sublayer outputs
    attn_softcap: float = 0.0  # tanh cap on the attention scores (Gemma2: 50)
    logit_softcap: float = 0.0  # tanh cap on the final logits (Gemma2: 30)
    qk_norm: bool = False  # per-head RMSNorm over head_dim on q and k, before rope
    # Gemma3 dual rope: sliding layers rotate at this unscaled theta, global
    # layers at rope_theta with rope_scaling; 0 = one rope for every layer
    rope_local_theta: float = 0.0
    # --- DeepSeek MLA deltas (multi-head latent attention) ---
    # kv_lora_rank > 0 enables MLA: k and v decode from one shared low-rank
    # latent (wkv_a, kv_a_norm, wkv_b), the q/k heads split into a rope-free
    # "nope" part and a rope part shared by every head, and v has its own
    # head width; head_dim and n_kv_heads are unused under MLA
    q_lora_rank: int = 0  # 0 = a direct wq projection (V2-Lite)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- DeepSeek MoE deltas (models/moe.py) ---
    router_renorm: bool = False  # renormalize the top-k gates to sum 1
    router_score: str = "softmax"  # "softmax" (V2) | "sigmoid" (V3)
    router_bias: bool = False  # V3's selection bias (f32 router_bias; the gates stay unbiased)
    # (n_group, topk_group): only the best topk_group of n_group expert
    # groups are eligible (group score: best member for softmax, top-2 sum
    # for sigmoid)
    router_groups: tuple = ()
    routed_scale: float = 1.0  # multiplier on the routed gates
    moe_shared_expert: bool = False  # a dense shared expert on every MoE layer
    moe_shared_intermediate: int = 0  # its width (0 = intermediate_size)
    # the first k layers carry a dense MLP of width dense_intermediate, in
    # a params["dense_layers"] stack that runs before params["layers"]
    first_k_dense: int = 0
    dense_intermediate: int = 0
    # --- dense-family deltas (all default to Llama behavior) ---
    # rope rotates interleaved (even, odd) pairs as complex numbers (Cohere,
    # GLM) instead of rotate-half; MLA's rope is interleaved regardless
    rope_interleaved: bool = False
    # rope rotates only the first head_dim * partial_rotary dims (GLM:
    # interleaved, Nemotron: rotate-half); the rest pass through
    partial_rotary: float = 1.0
    # OLMo-2: no input norms, the sublayer outputs are normed instead
    # (pre_norm=False needs post_norms=True; attn_norm/mlp_norm leave the tree)
    pre_norm: bool = True
    # OLMo-2: q/k RMSNorm over the whole projection width, before the head
    # reshape (qk_norm is the per-head one)
    qk_norm_flat: bool = False
    # "rms"; "layernorm": mean-centred, weight only (Cohere); "layernorm1p":
    # (1 + w) scale and a bias, "layernorm_bias": scale and bias (Nemotron,
    # StarCoder2), both stored stacked [..., 2, H] as (scale, bias) rows
    norm_type: str = "rms"
    # Cohere: attention and MLP read the same input through one norm
    # (attn_norm) and both outputs join the residual at once
    parallel_block: bool = False
    logit_scale: float = 0.0  # multiplier on the final logits (Cohere, Granite); 0 = off
    mlp_gateless: bool = False  # down(act(up(x))), no w_gate (Nemotron, StarCoder2)
    embed_multiplier: float = 0.0  # Granite: scales the embeddings; 0 = off
    residual_multiplier: float = 0.0  # Granite: scales each sublayer output; 0 = off
    # --- Llama4 deltas (all default to Llama behavior) ---
    # every nope_pattern-th layer skips rope and attends globally (Llama4: 4;
    # Cohere2's global layers); 1 = every layer, 0 = none
    nope_pattern: int = 0
    # weightless RMS norm (f32) on q and k after rope, rope layers only
    qk_l2_norm: bool = False
    # rope layers attend within attention_chunk_size-token blocks (blockwise
    # local, not a sliding window); NoPE layers stay global; 0 = off
    attention_chunk_size: int = 0
    # NoPE layers' query temperature:
    # q *= 1 + attn_temp_scale * log1p(floor((pos + 1) / attn_temp_floor))
    attn_temp_scale: float = 0.0
    attn_temp_floor: float = 8192.0
    # Llama4's router: gates are sigmoid(top-k logit), applied to the expert
    # input (the combine is unweighted)
    router_sigmoid_input: bool = False

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads "
                f"{self.n_kv_heads}"
            )
        if self.qk_norm and self.qk_norm_flat:
            raise ValueError(
                "qk_norm (per-head, Qwen3) and qk_norm_flat (full "
                "width, OLMo-2) are mutually exclusive"
            )
        if not self.pre_norm and not self.post_norms:
            raise ValueError("pre_norm=False requires post_norms=True")

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """A q/k head's width: the nope and rope parts under MLA."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim if self.mla else self.head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.qk_head_dim

    @property
    def o_dim(self) -> int:
        """The attention output's width entering wo (v heads under MLA)."""
        return self.n_heads * (self.v_head_dim if self.mla else self.head_dim)

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rope_dim(self) -> int:
        """The width rope rotates: the shared rope part under MLA, the first
        ``partial_rotary`` share of a head otherwise (GLM, Nemotron)."""
        return self.qk_rope_head_dim if self.mla else int(self.head_dim * self.partial_rotary)

    @property
    def stacked_norms(self) -> bool:
        """Whether each norm leaf is a stacked [..., 2, H] (scale, bias)."""
        return self.norm_type in ("layernorm1p", "layernorm_bias")

    @property
    def attention_scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None else self.qk_head_dim**-0.5

    def _attn_params(self) -> int:
        h = self.hidden_size
        if self.mla:
            q = (h * self.q_lora_rank + self.q_lora_rank + self.q_lora_rank * self.q_dim
                 if self.q_lora_rank else h * self.q_dim)
            kv = (h * (self.kv_lora_rank + self.qk_rope_head_dim) + self.kv_lora_rank
                  + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim))
            return q + kv + self.o_dim * h
        return (
            2 * h * self.q_dim + 2 * h * self.kv_dim
            + (self.q_dim + 2 * self.kv_dim if self.qkv_bias else 0)
            + (h if self.proj_bias else 0)
        )

    def _norm_params(self) -> tuple:
        """(one norm's parameters, a layer's norm parameters): the input
        norms (one under the parallel block, none without pre-norms) and
        the post norms, each 2H when stacked (scale and bias)."""
        nw = 2 * self.hidden_size if self.stacked_norms else self.hidden_size
        pre = (1 if self.parallel_block else 2) if self.pre_norm else 0
        return nw, pre * nw + (2 * nw if self.post_norms else 0)

    def num_params(self) -> int:
        """Parameter count, the JAX ``num_params`` (llama.py:259): attention
        with its biases (or MLA's projections), the norms as the tree holds
        them, the MLP's gated or gateless matrices and StarCoder2's biases,
        every expert's FFN and biases, the router and its selection bias,
        the shared expert, the sinks, DeepSeek's dense prelude (JAX counts
        no q/k norm leaves)."""
        e, h, f = self.vocab_size * self.hidden_size, self.hidden_size, self.intermediate_size
        x = self.n_experts
        nw, extras = self._norm_params()
        mats = 2 if self.mlp_gateless else 3
        attn = self._attn_params() + extras
        mlp_bias = f + h if self.proj_bias and not x else 0
        moe_bias = x * (1 + 2 * f + h) if self.moe_bias else 0
        shared = 3 * h * (self.moe_shared_intermediate or f) if x and self.moe_shared_expert else 0
        per_layer = (
            attn + max(1, x) * mats * h * f + mlp_bias + h * x + moe_bias + shared
            + (x if self.router_bias else 0) + (self.n_heads if self.attn_sinks else 0)
        )
        per_dense = attn + mats * h * (self.dense_intermediate or f)
        return (e + (self.n_layers - self.first_k_dense) * per_layer + self.first_k_dense * per_dense
                + nw + (0 if self.tie_embeddings else e))

    def num_active_params(self) -> int:
        """Parameters a token touches (the JAX ``num_active_params``,
        dstack_tpu/models/llama.py:296): a dense model's are all of them; an
        MoE layer counts only its ``experts_per_token`` routed experts' FFNs,
        the shared expert, the router and its selection bias (no expert
        biases, no sinks). The MFU's FLOPs a token count these."""
        if not self.n_experts:
            return self.num_params()
        e, h, f = self.vocab_size * self.hidden_size, self.hidden_size, self.intermediate_size
        x = self.n_experts
        nw, extras = self._norm_params()
        mats = 2 if self.mlp_gateless else 3
        attn = self._attn_params() + extras
        shared = 3 * h * (self.moe_shared_intermediate or f) if self.moe_shared_expert else 0
        per_moe = (attn + self.experts_per_token * mats * h * f + shared + h * x
                   + (x if self.router_bias else 0))
        per_dense = attn + mats * h * (self.dense_intermediate or f)
        return (e + (self.n_layers - self.first_k_dense) * per_moe + self.first_k_dense * per_dense
                + nw + (0 if self.tie_embeddings else e))


LLAMA_3_8B = LlamaConfig()
LLAMA_3_70B = LlamaConfig(
    hidden_size=8192, n_layers=80, n_heads=64, n_kv_heads=8,
    intermediate_size=28672,
)
LLAMA_32_1B = LlamaConfig(
    hidden_size=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
    intermediate_size=8192, tie_embeddings=True,
)
LLAMA_32_3B = LlamaConfig(
    hidden_size=3072, n_layers=28, n_heads=24, n_kv_heads=8,
    intermediate_size=8192, tie_embeddings=True,
)
LLAMA_TINY = LlamaConfig(  # for tests
    vocab_size=512, hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, intermediate_size=256, max_seq_len=256, dtype=torch.float32,
    remat=False,
)
LLAMA_TINY_64 = LlamaConfig(  # head_dim-64 tiny: kernel-eligible shapes
    vocab_size=512, hidden_size=128, n_layers=2, n_heads=2, n_kv_heads=1,
    head_dim=64, intermediate_size=256, max_seq_len=256, dtype=torch.float32,
    remat=False,
)
MIXTRAL_8X7B = LlamaConfig(  # mistralai/Mixtral-8x7B (46.7B, 12.9B active)
    vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    intermediate_size=14336, rope_theta=1e6, n_experts=8, experts_per_token=2,
)
MOE_TINY = LlamaConfig(  # for tests
    vocab_size=512, hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, intermediate_size=256, max_seq_len=256, dtype=torch.float32,
    remat=False, n_experts=4, experts_per_token=2, capacity_factor=2.0,
)

_GPT_OSS_COMMON = dict(
    vocab_size=201088, hidden_size=2880, n_heads=64, n_kv_heads=8,
    head_dim=64, intermediate_size=2880, rope_theta=150000.0,
    norm_eps=1e-5, max_seq_len=131072,
    rope_scaling=("yarn", 32.0, 32.0, 1.0, 4096.0, 1.3465735902799727, False),
    qkv_bias=True, proj_bias=True, attn_sinks=True,
    sliding_window=128, sliding_pattern=2,
    experts_per_token=4, router_topk_softmax=True, moe_bias=True,
    moe_act="oai_glu",
)
GPT_OSS_20B = LlamaConfig(  # openai/gpt-oss-20b (20.9B, 3.6B active)
    **_GPT_OSS_COMMON, n_layers=24, n_experts=32,
)
GPT_OSS_120B = LlamaConfig(  # openai/gpt-oss-120b (116.8B; does not fit one 80 GB card)
    **_GPT_OSS_COMMON, n_layers=36, n_experts=128,
)

_GEMMA_COMMON = dict(  # Gemma 1/2/3: tied embeddings, tanh GELU, (1 + w) norms
    norm_eps=1e-6, tie_embeddings=True, hidden_act="gelu_tanh", norm_offset=True,
    embed_scale=True,
)
GEMMA_2B = LlamaConfig(  # google/gemma-2b
    **_GEMMA_COMMON, vocab_size=256000, hidden_size=2048, n_layers=18, n_heads=8,
    n_kv_heads=1, head_dim=256, intermediate_size=16384, rope_theta=10000.0,
)
GEMMA2_2B = LlamaConfig(  # google/gemma-2-2b: sandwich norms, softcaps, alternating windows
    **_GEMMA_COMMON, vocab_size=256000, hidden_size=2304, n_layers=26, n_heads=8,
    n_kv_heads=4, head_dim=256, intermediate_size=9216, rope_theta=10000.0,
    post_norms=True, sliding_window=4096, sliding_pattern=2,
    attn_softcap=50.0, logit_softcap=30.0, attn_scale=256.0**-0.5,
)
# Gemma3: 5 sliding layers per global one, dual rope theta (local 10k on
# sliding layers, 1M + linear interpolation on global), qk norms, no
# softcaps (google/gemma-3-*-it config.json)
GEMMA3_1B = LlamaConfig(
    **_GEMMA_COMMON, vocab_size=262144, hidden_size=1152, n_layers=26, n_heads=4,
    n_kv_heads=1, head_dim=256, intermediate_size=6912, rope_theta=1e6,
    max_seq_len=32768, post_norms=True, qk_norm=True, sliding_window=512,
    sliding_pattern=6, rope_local_theta=10000.0, attn_scale=256.0**-0.5,
)
GEMMA3_4B = LlamaConfig(  # text tower of google/gemma-3-4b
    **_GEMMA_COMMON, vocab_size=262208, hidden_size=2560, n_layers=34, n_heads=8,
    n_kv_heads=4, head_dim=256, intermediate_size=10240, rope_theta=1e6,
    max_seq_len=131072, post_norms=True, qk_norm=True, sliding_window=1024,
    sliding_pattern=6, rope_local_theta=10000.0, rope_scaling=("linear", 8.0),
    attn_scale=256.0**-0.5,
)

# the dense families at head_dim 128 (dstack_tpu/models/llama.py:362-461)
QWEN3_8B = LlamaConfig(
    vocab_size=151936, hidden_size=4096, n_layers=36, n_heads=32,
    n_kv_heads=8, head_dim=128, intermediate_size=12288, rope_theta=1e6,
    norm_eps=1e-6, max_seq_len=32768, qk_norm=True,
)
QWEN25_7B = LlamaConfig(
    vocab_size=152064, hidden_size=3584, n_layers=28, n_heads=28,
    n_kv_heads=4, head_dim=128, intermediate_size=18944, rope_theta=1e6,
    norm_eps=1e-6, max_seq_len=32768, qkv_bias=True,
)
QWEN3_30B_A3B = LlamaConfig(  # Qwen/Qwen3-30B-A3B: sparse MoE, 30.5B (3.3B active)
    vocab_size=151936, hidden_size=2048, n_layers=48, n_heads=32,
    n_kv_heads=4, head_dim=128, intermediate_size=768, rope_theta=1e6,
    norm_eps=1e-6, max_seq_len=32768, qk_norm=True,
    n_experts=128, experts_per_token=8, router_renorm=True,
)
MISTRAL_7B = LlamaConfig(
    vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32,
    n_kv_heads=8, head_dim=128, intermediate_size=14336, rope_theta=10000.0,
    sliding_window=4096,
)
STARCODER2_7B = LlamaConfig(  # bigcode/starcoder2-7b
    vocab_size=49152, hidden_size=4608, n_layers=32, n_heads=36,
    n_kv_heads=4, head_dim=128, intermediate_size=18432,
    rope_theta=1000000.0, norm_eps=1e-5, max_seq_len=16384,
    tie_embeddings=True, norm_type="layernorm_bias", mlp_gateless=True,
    qkv_bias=True, proj_bias=True, hidden_act="gelu_tanh",
    sliding_window=4096,
)
MINITRON_4B = LlamaConfig(  # nvidia/Minitron-4B-Base (nemotron)
    vocab_size=256000, hidden_size=3072, n_layers=32, n_heads=24,
    n_kv_heads=8, head_dim=128, intermediate_size=9216,
    rope_theta=10000.0, norm_eps=1e-5, max_seq_len=4096,
    norm_type="layernorm1p", mlp_gateless=True, partial_rotary=0.5,
    hidden_act="relu2",
)
COMMAND_R_35B = LlamaConfig(  # CohereForAI/c4ai-command-r-v01
    vocab_size=256000, hidden_size=8192, n_layers=40, n_heads=64,
    n_kv_heads=64, head_dim=128, intermediate_size=22528,
    rope_theta=8000000.0, norm_eps=1e-5, max_seq_len=131072,
    tie_embeddings=True, norm_type="layernorm", parallel_block=True,
    rope_interleaved=True, logit_scale=0.0625,
)
OLMO2_7B = LlamaConfig(  # allenai/OLMo-2-1124-7B
    vocab_size=100352, hidden_size=4096, n_layers=32, n_heads=32,
    n_kv_heads=32, head_dim=128, intermediate_size=11008,
    rope_theta=500000.0, norm_eps=1e-6, max_seq_len=4096,
    pre_norm=False, post_norms=True, qk_norm_flat=True,
)
GLM_4_9B = LlamaConfig(  # THUDM/GLM-4-9B-0414 (glm4)
    vocab_size=151552, hidden_size=4096, n_layers=40, n_heads=32,
    n_kv_heads=2, head_dim=128, intermediate_size=13696,
    rope_theta=10000.0, norm_eps=1.5625e-7, max_seq_len=131072,
    qkv_bias=True, rope_interleaved=True, partial_rotary=0.5,
    post_norms=True,
)

LLAMA4_SCOUT = LlamaConfig(  # meta-llama/Llama-4-Scout-17B-16E text tower (107.8B, 17.2B active)
    vocab_size=202048, hidden_size=5120, n_layers=48, n_heads=40,
    n_kv_heads=8, head_dim=128, intermediate_size=8192, rope_theta=500000.0,
    norm_eps=1e-5, max_seq_len=262144,
    rope_interleaved=True, nope_pattern=4, attention_chunk_size=8192,
    qk_l2_norm=True, attn_temp_scale=0.1, attn_temp_floor=8192.0,
    n_experts=16, experts_per_token=1, router_sigmoid_input=True,
    moe_shared_expert=True,
)

DEEPSEEK_V2_LITE = LlamaConfig(  # deepseek-ai/DeepSeek-V2-Lite (15.7B, 2.4B active)
    vocab_size=102400, hidden_size=2048, n_layers=27, n_heads=16,
    n_kv_heads=16, head_dim=64, intermediate_size=1408, rope_theta=10000.0,
    norm_eps=1e-6, max_seq_len=163840,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0),
    n_experts=64, experts_per_token=6, moe_shared_expert=True,
    moe_shared_intermediate=2816,  # 2 shared experts x 1408
    first_k_dense=1, dense_intermediate=10944,
)
DEEPSEEK_V3 = LlamaConfig(  # deepseek-ai/DeepSeek-V3 (671B, 37.6B active)
    vocab_size=129280, hidden_size=7168, n_layers=61, n_heads=128,
    n_kv_heads=128, head_dim=64, intermediate_size=2048, rope_theta=10000.0,
    norm_eps=1e-6, max_seq_len=163840,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    rope_scaling=("yarn", 40.0, 32.0, 1.0, 4096.0, 1.0),
    # under yarn V3 multiplies the softmax scale by mscale(factor,
    # mscale_all_dim = 1)^2 (HF DeepseekV3Attention; V2 does not)
    attn_scale=(192.0**-0.5) * (0.1 * math.log(40.0) + 1.0) ** 2,
    n_experts=256, experts_per_token=8, router_renorm=True,
    router_score="sigmoid", router_bias=True, router_groups=(8, 4),
    routed_scale=2.5, moe_shared_expert=True, moe_shared_intermediate=2048,
    first_k_dense=3, dense_intermediate=18432,
)
MLA_TINY = LlamaConfig(  # for tests: V3-style routing, q_lora
    vocab_size=512, hidden_size=128, n_layers=3, n_heads=4, n_kv_heads=4,
    head_dim=16, intermediate_size=128, max_seq_len=256, dtype=torch.float32,
    remat=False,
    q_lora_rank=48, kv_lora_rank=64, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=24,
    n_experts=4, experts_per_token=2, capacity_factor=2.0,
    router_score="sigmoid", router_bias=True, router_groups=(2, 1),
    routed_scale=1.5, router_renorm=True,
    moe_shared_expert=True, moe_shared_intermediate=64,
    first_k_dense=1, dense_intermediate=192,
)

CONFIGS = {  # the JAX package's 27 keys, in its order
    "llama-3-8b": LLAMA_3_8B,
    "llama-3-70b": LLAMA_3_70B,
    "llama-3.2-1b": LLAMA_32_1B,
    "llama-3.2-3b": LLAMA_32_3B,
    "llama-tiny": LLAMA_TINY,
    "llama-tiny-64": LLAMA_TINY_64,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "moe-tiny": MOE_TINY,
    "qwen-2.5-7b": QWEN25_7B,
    "qwen-3-8b": QWEN3_8B,
    "qwen-3-30b-a3b": QWEN3_30B_A3B,
    "mistral-7b": MISTRAL_7B,
    "gemma-2b": GEMMA_2B,
    "gemma-2-2b": GEMMA2_2B,
    "gemma-3-1b": GEMMA3_1B,
    "gemma-3-4b": GEMMA3_4B,
    "llama-4-scout": LLAMA4_SCOUT,
    "deepseek-v2-lite": DEEPSEEK_V2_LITE,
    "deepseek-v3": DEEPSEEK_V3,
    "mla-tiny": MLA_TINY,
    "glm-4-9b": GLM_4_9B,
    "olmo-2-7b": OLMO2_7B,
    "command-r-35b": COMMAND_R_35B,
    "minitron-4b": MINITRON_4B,
    "starcoder2-7b": STARCODER2_7B,
    "gpt-oss-20b": GPT_OSS_20B,
    "gpt-oss-120b": GPT_OSS_120B,
}

# leaves kept in f32 whatever the model dtype (JAX ``init_params`` makes
# them f32: the router's logit bias, DeepSeek's selection bias and the sink
# logits)
F32_LEAVES = ("b_router", "router_bias", "sinks")


def _attn_shapes(c: LlamaConfig, L: int) -> dict:
    """An L-layer stack's attention projections (``_init_attn``,
    dstack_tpu/models/llama.py:662): q/k/v/o, or MLA's latent
    projections and their norms (with ``wq_a``/``q_a_norm``/``wq_b`` where
    the config has a q_lora_rank, else ``wq``)."""
    E = c.hidden_size
    if not c.mla:
        return {"wq": (L, E, c.q_dim), "wk": (L, E, c.kv_dim), "wv": (L, E, c.kv_dim),
                "wo": (L, c.q_dim, E)}
    attn = {
        "wkv_a": (L, E, c.kv_lora_rank + c.qk_rope_head_dim),
        "kv_a_norm": (L, c.kv_lora_rank),
        "wkv_b": (L, c.kv_lora_rank, c.n_heads * (c.qk_nope_head_dim + c.v_head_dim)),
        "wo": (L, c.o_dim, E),
    }
    if c.q_lora_rank:
        attn.update(wq_a=(L, E, c.q_lora_rank), q_a_norm=(L, c.q_lora_rank),
                    wq_b=(L, c.q_lora_rank, c.q_dim))
    else:
        attn["wq"] = (L, E, c.q_dim)
    return attn


def param_shapes(config: LlamaConfig) -> dict:
    """Shape tree of the parameters, matching the JAX package's
    ``init_params`` output key for key (stacked ``[L, ...]`` layers): the
    dense MLP (gated, or gateless with StarCoder2's ``b_up``/``b_down``),
    or with ``n_experts`` the router and the stacked expert FFNs, plus the
    gpt-oss biases and sinks, the q/k norms (per head ``[D]``, Cohere's
    ``[H, D]``, OLMo-2's flat ``[q_dim]``), the input norms (one under the
    parallel block, none without pre-norms) and post norms, each a stacked
    ``[.., 2, H]`` (scale, bias) for the LayerNorm-with-bias flavours,
    MLA's latent projections, DeepSeek's selection bias and shared expert,
    and its ``dense_layers`` prelude (``first_k_dense`` layers of the same
    attention with a dense MLP) when the config has them (llama.py:548-650)."""
    c = config
    L, E, F_ = c.n_layers - c.first_k_dense, c.hidden_size, c.intermediate_size

    def norm(*lead):
        return (*lead, 2, E) if c.stacked_norms else (*lead, E)

    layers = _attn_shapes(c, L)
    if c.pre_norm:
        layers["attn_norm"] = norm(L)
        if not c.parallel_block:  # Cohere's one input norm is attn_norm
            layers["mlp_norm"] = norm(L)
    if c.n_experts:
        X = c.n_experts
        layers.update(w_router=(L, E, X), w_gate=(L, X, E, F_), w_up=(L, X, E, F_),
                      w_down=(L, X, F_, E))
        if c.moe_bias:
            layers.update(b_router=(L, X), b_gate=(L, X, F_), b_up_e=(L, X, F_),
                          b_down_e=(L, X, E))
        if c.router_bias:
            layers["router_bias"] = (L, X)
        if c.moe_shared_expert:
            FS = c.moe_shared_intermediate or F_
            layers.update(w_shared_gate=(L, E, FS), w_shared_up=(L, E, FS), w_shared_down=(L, FS, E))
    else:
        if not c.mlp_gateless:
            layers["w_gate"] = (L, E, F_)
        layers.update(w_up=(L, E, F_), w_down=(L, F_, E))
        if c.proj_bias:  # StarCoder2's dense-MLP biases
            layers.update(b_up=(L, F_), b_down=(L, E))
    if c.qkv_bias:
        layers.update(bq=(L, c.q_dim), bk=(L, c.kv_dim), bv=(L, c.kv_dim))
    if c.proj_bias:
        layers["bo"] = (L, E)
    if c.attn_sinks:
        layers["sinks"] = (L, c.n_heads)
    if c.qk_norm and c.norm_type == "layernorm":  # Cohere: a LayerNorm weight a head
        layers.update(q_norm=(L, c.n_heads, c.head_dim), k_norm=(L, c.n_kv_heads, c.head_dim))
    elif c.qk_norm:
        layers.update(q_norm=(L, c.head_dim), k_norm=(L, c.head_dim))
    if c.qk_norm_flat:  # OLMo-2: the whole projection width
        layers.update(q_norm=(L, c.q_dim), k_norm=(L, c.kv_dim))
    if c.post_norms:
        layers.update(attn_post_norm=norm(L), mlp_post_norm=norm(L))
    shapes = {"embed": (c.vocab_size, E), "layers": layers, "final_norm": norm()}
    if c.first_k_dense:  # DeepSeek's dense prelude (llama.py:643-649,797-815)
        K, FD = c.first_k_dense, c.dense_intermediate or F_
        dense = {"attn_norm": (K, E), **_attn_shapes(c, K), "mlp_norm": (K, E),
                 "w_gate": (K, E, FD), "w_up": (K, E, FD), "w_down": (K, FD, E)}
        if c.post_norms:
            dense.update(attn_post_norm=(K, E), mlp_post_norm=(K, E))
        shapes["dense_layers"] = dense
    if not c.tie_embeddings:
        shapes["lm_head"] = (E, c.vocab_size)
    return shapes


def _leaf_dtype(name: str, config: LlamaConfig, dtype=None):
    return torch.float32 if name in F32_LEAVES else (dtype or config.dtype)


def init_params(
    config: LlamaConfig, generator: torch.Generator, device="cuda"
) -> dict:
    """Random parameters with the JAX ``init_params`` shapes and
    distributions: N(0, 0.02) projections (``wo``/``w_down`` scaled by
    1/sqrt(2L)), identity norms (1, or 0 where the norm scales by 1 + w;
    a stacked (scale, bias) norm's scale row 1, or 0 for LayerNorm1P, and
    its bias row 0; the q/k norms are 1 either way, as JAX makes them),
    zero biases and sinks. Drawn in f32 from
    ``generator`` (which must live on ``device``) and cast to the config
    dtype; the streams differ from JAX's, so parity tests carry weights
    across with :func:`params_from_jax` instead. The stacked expert
    leaves ``[L, E, ...]`` are drawn one layer at a time into a
    preallocated tensor, so the f32 transient is one layer's (1.06 GB
    for gpt-oss-20b's ``w_gate``, not 25.5 GB)."""
    c = config
    std = 0.02
    down = std / math.sqrt(2 * c.n_layers)
    scales = {"wo": down, "w_down": down, "w_shared_down": down}
    shapes = param_shapes(c)

    def normal(shape, scale=std):
        x = torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )
        return (x * scale).to(c.dtype)

    def norm_leaf(name, shape):
        # the offset convention covers the model's norms; q/k and MLA's
        # latent norms start at 1 either way, as JAX makes them
        ones = name in ("q_norm", "k_norm", "q_a_norm", "kv_a_norm")
        if c.stacked_norms and not ones:  # (scale, bias) rows
            w = torch.zeros(shape, device=device, dtype=c.dtype)
            if c.norm_type == "layernorm_bias":  # LayerNorm1P stores scale - 1
                w[..., 0, :] = 1.0
            return w
        fill = torch.zeros if c.norm_offset and not ones else torch.ones
        return fill(shape, device=device, dtype=c.dtype)

    def layer_leaf(name, shape):
        if name.endswith("norm"):
            return norm_leaf(name, shape)
        if name.startswith("b") or name in ("sinks", "router_bias"):
            return torch.zeros(shape, device=device, dtype=_leaf_dtype(name, c))
        if len(shape) == 4:  # [L, E, ...] experts: one layer's draw at a time
            out = torch.empty(shape, device=device, dtype=c.dtype)
            for i in range(shape[0]):
                out[i] = normal(shape[1:], scales.get(name, std))
            return out
        return normal(shape, scales.get(name, std))

    layers = {name: layer_leaf(name, s) for name, s in shapes["layers"].items()}  # drawn first
    params = {
        "embed": normal(shapes["embed"]),
        "layers": layers,
        "final_norm": norm_leaf("final_norm", shapes["final_norm"]),
    }
    if "dense_layers" in shapes:
        params["dense_layers"] = {name: layer_leaf(name, s) for name, s in shapes["dense_layers"].items()}
    if "lm_head" in shapes:
        params["lm_head"] = normal(shapes["lm_head"])
    return params


def params_from_jax(
    tree: dict, config: LlamaConfig, device="cuda", dtype=None
) -> dict:
    """Carry a JAX parameter tree (its leaves as numpy arrays) across:
    same keys, same stacked layout, one tensor per leaf, in ``dtype`` (the
    config's by default) but for the f32 leaves (:data:`F32_LEAVES`).
    Raises on a missing, extra or misshapen leaf rather than guessing."""
    shapes = param_shapes(config)

    def convert(sub_tree, sub_shapes, path):
        if set(sub_tree) != set(sub_shapes):
            raise ValueError(
                f"params{path}: keys {sorted(sub_tree)} != the config's "
                f"keys {sorted(sub_shapes)}"
            )
        out = {}
        for key, shape in sub_shapes.items():
            leaf = sub_tree[key]
            if isinstance(shape, dict):
                out[key] = convert(leaf, shape, f"{path}[{key!r}]")
                continue
            a = np.asarray(leaf)
            if tuple(a.shape) != tuple(shape):
                raise ValueError(
                    f"params{path}[{key!r}]: shape {a.shape} != {shape}"
                )
            if a.dtype not in (np.float16, np.float32, np.float64):
                a = a.astype(np.float32)  # bfloat16 numpy has no torch view
            out[key] = torch.from_numpy(np.require(a, requirements=["C", "W"])).to(
                device=device, dtype=_leaf_dtype(key, config, dtype)
            )
        return out

    return convert(tree, shapes, "")


def load_weights_npz(params: dict, path) -> int:
    """Overlay a fine-tune's ``model_weights.npz`` onto ``params`` in
    place → the number of arrays in the file. Keys are ``/``-joined tree
    paths (``layers/wq``); each array is cast to its leaf's dtype and
    put on its leaf's device; ``step`` is skipped. Reads the port's file
    (bf16 leaves written as f32) and the JAX fine-tune's (bf16 leaves as
    2-byte raw values, which numpy loads as void without ml_dtypes). A
    LoRA adapter file (``layers.wq_lora_a``: no ``/``) is refused with
    the JAX server's message."""
    with np.load(path) as f:
        flat = dict(f)
    if any("/" not in k and "." in k for k in flat if k != "step"):
        raise SystemExit(
            f"{path} looks like a LoRA adapter file (finetune without --full); "
            "the server loads full checkpoints — re-run finetune with --full or "
            "merge the adapters into the base weights first"
        )
    for key, value in flat.items():
        if key == "step":
            continue
        *parents, leaf = key.split("/")
        node = params
        for k in parents:
            node = node[k]
        old = node[leaf]
        if tuple(value.shape) != tuple(old.shape):
            raise ValueError(f"{path}: {key} has shape {value.shape}, the model's is {tuple(old.shape)}")
        if value.dtype.kind == "V" and value.dtype.itemsize == 2:  # bfloat16's bits
            t = torch.from_numpy(np.ascontiguousarray(value).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(value))
        node[leaf] = t.to(device=old.device, dtype=old.dtype)
    return len(flat)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked ``[L, ...]`` leaves."""
    return {name: w[i] for name, w in params["layers"].items()}


def layer_stack(params: dict) -> list:
    """Every layer's views in the order they run: DeepSeek's dense prelude
    (``params["dense_layers"]``, ``first_k_dense`` layers), then the main
    stack (JAX's ``_mla_scan``, dstack_tpu/serve/engine.py:459)."""
    stacks = [params[k] for k in ("dense_layers", "layers") if k in params]
    return [{name: w[i] for name, w in st.items()} for st in stacks
            for i in range(next(iter(st.values())).shape[0])]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, offset: bool = False) -> torch.Tensor:
    """RMSNorm computed in f32, cast back, then scaled in x's dtype
    (dstack_tpu/models/llama.py:821); with ``offset`` (Gemma: the stored
    weight is scale - 1) the (1 + w) scale is applied in f32 before the
    cast."""
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if offset:
        return (x32 * rms * (1.0 + w.float())).to(x.dtype)
    return (x32 * rms).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Mean-centred, weight-only LayerNorm in f32, cast back (Cohere,
    dstack_tpu/models/llama.py:832); ``w`` may carry leading broadcast dims
    (Cohere's per-head q/k norms, [H, D])."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def model_norm(x: torch.Tensor, w: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """The model's norm flavour (llama.py:842): RMSNorm, with Gemma's
    (1 + w) offset where the config sets it; Cohere's weight-only
    LayerNorm; or a LayerNorm with a bias over a stacked ``[..., 2, H]``
    (scale, bias) weight, the scale stored as scale - 1 for Nemotron's
    LayerNorm1P and as itself for StarCoder2's. All in f32, cast once."""
    if config.norm_type == "layernorm":
        return layer_norm(x, w, config.norm_eps)
    if config.stacked_norms:
        x32 = x.float()
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
        scale = w[..., 0, :].float()
        if config.norm_type == "layernorm1p":
            scale = 1.0 + scale
        out = (x32 - mu) * torch.rsqrt(var + config.norm_eps) * scale + w[..., 1, :].float()
        return out.to(x.dtype)
    return rms_norm(x, w, config.norm_eps, offset=config.norm_offset)


def qk_norm_apply(q: torch.Tensor, k: torch.Tensor, layer: dict, config: LlamaConfig) -> tuple:
    """Per-head q/k norm on [B, H, T, D], before rope (llama.py:864):
    RMSNorm with one shared [D] weight each (Gemma3, Qwen3), or Cohere's
    per-head LayerNorm with [H, D] and [Hkv, D] weights."""
    c = config
    if c.norm_type == "layernorm":
        return (layer_norm(q, layer["q_norm"][None, :, None, :], c.norm_eps),
                layer_norm(k, layer["k_norm"][None, :, None, :], c.norm_eps))
    return (
        rms_norm(q, layer["q_norm"], c.norm_eps, offset=c.norm_offset),
        rms_norm(k, layer["k_norm"], c.norm_eps, offset=c.norm_offset),
    )


def act_fn(config: LlamaConfig):
    """The MLP's activation (llama.py:879): SiLU (SwiGLU), Gemma's
    tanh-approximated GELU (GeGLU; StarCoder2's gateless MLP), or
    Nemotron's squared ReLU."""
    if config.hidden_act == "silu":
        return F.silu
    if config.hidden_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if config.hidden_act == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown hidden_act {config.hidden_act!r}")


def layer_windows(config: LlamaConfig) -> list[int]:
    """Per-layer attention window (0 = global), the JAX ``layer_windows``
    (llama.py:937): ``sliding_pattern == p`` makes the last layer of
    every group of ``p`` global and the others sliding (gpt-oss, p = 2:
    even layers slide, odd layers are global); otherwise the window is
    uniform."""
    c = config
    if not c.sliding_window:
        return [0] * c.n_layers
    p = c.sliding_pattern
    if p > 1:
        return [0 if i % p == p - 1 else c.sliding_window for i in range(c.n_layers)]
    return [c.sliding_window] * c.n_layers


def layer_nope(config: LlamaConfig) -> list[bool]:
    """Per-layer NoPE flag, the JAX ``layer_nope`` (llama.py:956): every
    ``nope_pattern``-th layer (Llama4: 4) skips rope and attends
    globally; ``nope_pattern == 1`` makes every layer NoPE, 0 none."""
    c = config
    if not c.nope_pattern:
        return [False] * c.n_layers
    return [(i + 1) % c.nope_pattern == 0 for i in range(c.n_layers)]


def check_layer_layout(config: LlamaConfig) -> None:
    """Refuse a mix of sliding windows and NoPE layers that do not line
    up, as JAX's ``grouped_scan_layout`` refuses it (llama.py:889-912):
    both may vary only when the NoPE layers are the global layers at one
    period (Cohere2)."""
    windows, nopes = layer_windows(config), layer_nope(config)
    if len(set(windows)) > 1 and len(set(nopes)) > 1:
        if config.sliding_pattern != config.nope_pattern or any((w == 0) != n for w, n in zip(windows, nopes)):
            raise ValueError(
                "mixed sliding windows and NoPE layers are only supported when aligned "
                "(Cohere2: the global layers ARE the NoPE layers, same period)"
            )


def l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless RMS normalisation in f32, cast back (Llama4's q/k norm,
    llama.py:967)."""
    x32 = x.float()
    return (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)).to(x.dtype)


def attn_temp_scales(positions: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Llama4's NoPE-layer query temperature for each position, f32 of
    positions' shape (llama.py:974): 1 + attn_temp_scale * log1p(floor((pos
    + 1) / attn_temp_floor)). Device ops only: a CUDA graph replays it at
    the positions of the replay."""
    p = positions.to(torch.float32)
    return torch.log1p(torch.floor((p + 1.0) / config.attn_temp_floor)) * config.attn_temp_scale + 1.0


def rope_freqs(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [T] → (cos, sin) each [T, head_dim//2], f32, with the
    "llama3", "linear" and "yarn" rescalings of the JAX ``rope_freqs``
    (llama.py:1008-1045). Yarn is NTK-by-parts: ``("yarn", factor,
    beta_fast, beta_slow, orig_ctx, attention_factor[, truncate])``;
    gpt-oss passes ``truncate=False`` (the raw correction boundaries) and
    ``attention_factor`` multiplies cos and sin."""
    dev = positions.device
    inv = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    if scaling is not None and scaling[0] == "linear":
        inv = inv / float(scaling[1])
    elif scaling is not None and scaling[0] == "yarn":
        _, factor, beta_fast, beta_slow, orig_ctx, att_f = scaling[:6]
        truncate = scaling[6] if len(scaling) > 6 else True

        def corr_dim(rot):  # dim whose wavelength fits `rot` rotations
            return (head_dim * math.log(orig_ctx / (rot * 2 * math.pi))) / (2 * math.log(theta))

        if truncate:
            low = max(math.floor(corr_dim(beta_fast)), 0)
            high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
        else:
            low = max(corr_dim(beta_fast), 0)
            high = min(corr_dim(beta_slow), head_dim - 1)
        if low == high:
            high += 0.001  # HF's singularity guard
        ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=dev) - low)
                / (high - low)).clamp(0.0, 1.0)
        inv = (inv / factor) * ramp + inv * (1.0 - ramp)
        ang = positions.to(torch.float32)[:, None] * inv[None, :]
        return torch.cos(ang) * att_f, torch.sin(ang) * att_f
    elif scaling is not None:
        if scaling[0] == "llama3":
            scaling = scaling[1:]
        factor, low_f, high_f, orig_ctx = scaling
        wavelen = 2.0 * math.pi / inv
        smooth = ((orig_ctx / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
        inv = (1.0 - smooth) * inv / factor + smooth * inv
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def dual_rope_freqs(config: LlamaConfig, positions: torch.Tensor) -> tuple:
    """→ ((cos, sin), (cos_local, sin_local)) for the config's global and
    sliding-window layers (llama.py:1046). One-rope families get the same
    pair twice; Gemma3's sliding layers rotate at the unscaled
    ``rope_local_theta`` while its global layers take ``rope_theta`` and
    ``rope_scaling``."""
    g = rope_freqs(positions, config.rope_dim, config.rope_theta, config.rope_scaling)
    if not config.rope_local_theta:
        return g, g
    return g, rope_freqs(positions, config.rope_dim, config.rope_local_theta)


def layer_rope(ropes: tuple, config: LlamaConfig, window: int) -> tuple:
    """A layer's (cos, sin) from :func:`dual_rope_freqs` by its window:
    sliding layers take the local pair (llama.py:1062)."""
    return ropes[1] if window else ropes[0]


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor, interleaved: bool = False) -> torch.Tensor:
    """Rope on x's last axis with cos/sin ``c``/``s`` of half the rotated
    width, already broadcastable against it and in x's dtype: rotate-half,
    or with ``interleaved`` the complex rotation of (even, odd) pairs
    (DeepSeek's MLA, Cohere, GLM; ``apply_rope(..., interleaved=True)``,
    dstack_tpu/models/llama.py:1079). The one place that owns the partial
    split (``rope_partial``, llama.py:1068), for every rope applier: where
    cos/sin are narrower than half of x's last axis, only the first
    ``2 * c.shape[-1]`` dims rotate and the rest pass through (GLM
    interleaved, Nemotron rotate-half)."""
    rd = 2 * c.shape[-1]
    if rd < x.shape[-1]:
        return torch.cat([rotate(x[..., :rd], c, s, interleaved), x[..., rd:]], dim=-1)
    if interleaved:
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleaved: bool = False) -> torch.Tensor:
    """x [B, H, T, D]; cos/sin [T, rope_dim/2], cast to x's dtype before
    the multiply (as JAX does); rotate-half, or interleaved pairs."""
    return rotate(x, cos[None, None].to(x.dtype), sin[None, None].to(x.dtype), interleaved)


def _proj(layer: dict, name: str, inp: torch.Tensor) -> torch.Tensor:
    """Base projection plus the LoRA bypass ``x·W + s·(x·A)·B`` when the
    layer carries ``{name}_lora_a``/``_lora_b`` (dstack_tpu/models/
    llama.py:1105-1126). A full-precision base is a plain large product,
    so it stays ``torch.matmul`` as JAX leaves it to XLA; an int8 base
    (``{name}_q`` and its per-output-channel scale ``{name}_s`` in place of
    ``name``, models/quant.py) goes through W8 (``ops/w8_matmul.py``),
    which reads the int8 bytes once. The bypass adds to either."""
    w = layer.get(name)
    y = torch.matmul(inp, w) if w is not None else w8_matmul.w8_proj(inp, layer[f"{name}_q"], layer[f"{name}_s"])
    a, b = layer.get(f"{name}_lora_a"), layer.get(f"{name}_lora_b")
    if a is not None and b is not None:
        y = y + torch.matmul(torch.matmul(inp, a), b) * layer["lora_scale"]
    return y


class _MatmulF32(torch.autograd.Function):
    """bf16 x [N, E] · w [E, V] → f32 [N, V], accumulated and written in
    f32 (``torch.mm(..., out_dtype=float32)``, which has no derivative).
    The backward rounds the f32 cotangent to bf16 once and takes both
    products in bf16 with f32 accumulation, as a TPU's default-precision
    matmul does with an f32 operand."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., E] · w [E, V] → f32 [..., V] with f32 accumulation
    (``einsum(..., preferred_element_type=f32)``), differentiable. No
    bf16 rounding of the result."""
    if x.device.type == "cpu" or x.dtype == torch.float32:
        # exact upcast of both operands: f32 products and sums
        return torch.matmul(x.float(), w.float())
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def lm_head_weight(params: dict, config: LlamaConfig) -> torch.Tensor:
    """The [E, V] output head: the tied embedding's transpose or
    ``lm_head``, in the model dtype. Training reads it; an int8 head
    (``lm_head_q``) serves only and is refused."""
    if "lm_head_q" in params:
        raise ValueError("an int8 weight tree (models/quant.py) serves only: the JAX package trains no int8 tree")
    head = params["embed"].t() if config.tie_embeddings else params["lm_head"]
    return head.to(config.dtype)


# ---------------------------------------------------------------------------
# layer pieces: one copy of every family delta, shared by the whole-sequence
# forward and the serving engine's steps
# ---------------------------------------------------------------------------


def _scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    """x times the scalar ``m`` rounded to x's dtype first, as JAX's
    ``x * jnp.asarray(m, x.dtype)`` rounds it (Granite's multipliers)."""
    return x * float(torch.tensor(m, dtype=x.dtype))


def _attn_input(x: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    """A layer's attention input: x through the layer's input norm, or x
    itself without pre-norms (OLMo-2 norms the sublayer outputs instead;
    ``_attention_block``, llama.py:1192-1195)."""
    return model_norm(x, layer["attn_norm"], c) if c.pre_norm else x


def _mlp_out(x: torch.Tensor, layer: dict, c: LlamaConfig, aux: bool = False):
    """The MLP sublayer's output: the sparse experts (and DeepSeek's
    shared one) when the layer carries a router (routed on x's own [B, T,
    H] shape: each batch row is a routing group), else the dense MLP: gated
    (SwiGLU, or Gemma's GeGLU), or gateless ``down(act(up(x)))`` (Nemotron,
    StarCoder2), with StarCoder2's up and down biases (DeepSeek's dense
    prelude layers carry no router). Its input is x through ``mlp_norm``,
    through ``attn_norm`` under Cohere's parallel block, or x itself
    without pre-norms; Gemma2/3, GLM-4 and OLMo-2 norm the output
    (``mlp_post_norm``) and Granite scales it. With ``aux`` → (output, the
    layer's router aux loss: ``router_balance_coef * balance +
    router_z_coef * z``, f32, 0 for a dense layer), as JAX's ``_mlp_block``
    returns them (llama.py:1281-1346); the serving steps leave it off and
    compute no aux term."""
    m = model_norm(x, layer.get("mlp_norm", layer.get("attn_norm")), c) if c.pre_norm else x
    loss = None
    if "w_router" in layer:
        from dstack_tpu_torch.models import moe  # moe imports this module

        mo = moe.moe_mlp(
            m, layer, c.n_experts, c.experts_per_token, c.capacity_factor,
            renorm=c.router_renorm, sigmoid_input=c.router_sigmoid_input,
            score=c.router_score, groups=c.router_groups,
            routed_scale=c.routed_scale, topk_softmax=c.router_topk_softmax, act=c.moe_act,
            act_limit=c.act_limit, return_aux=aux,
        )
        if aux:
            mo, terms = mo
            loss = c.router_balance_coef * terms["balance"] + c.router_z_coef * terms["z"]
    else:
        u = _proj(layer, "w_up", m)
        if c.proj_bias:
            u = u + layer["b_up"]
        # the config decides, not the leaf (JAX: int8 weights rename w_gate)
        inner = act_fn(c)(u) if c.mlp_gateless else act_fn(c)(_proj(layer, "w_gate", m)) * u
        mo = _proj(layer, "w_down", inner)
        if c.proj_bias:
            mo = mo + layer["b_down"]
    out = model_norm(mo, layer["mlp_post_norm"], c) if c.post_norms else mo
    if c.residual_multiplier:
        out = _scaled(out, c.residual_multiplier)
    if not aux:
        return out
    return out, loss if loss is not None else torch.zeros((), dtype=torch.float32, device=x.device)


def _residual(x: torch.Tensor, ao: torch.Tensor, layer: dict, c: LlamaConfig, aux: bool = False):
    """A layer's output from its input x and its attention output ``ao``
    (:func:`_attn_out`): x + ao, then the MLP sublayer on that sum; under
    Cohere's parallel block the MLP reads x too and both outputs join it at
    once (``forward``, llama.py:1482-1490). With ``aux`` → (output, the MLP's
    router aux loss), as :func:`_mlp_out` gives it."""
    base = x if c.parallel_block else x + ao
    mo = _mlp_out(base, layer, c, aux=aux)
    mo, loss = mo if aux else (mo, None)
    out = x + ao + mo if c.parallel_block else base + mo
    return (out, loss) if aux else out


def _qkv_heads(h: torch.Tensor, layer: dict, c: LlamaConfig) -> tuple:
    """Attention input [B, T, E] → q [B, H, T, D], k and v [B, Hkv, T, D],
    pre-rope: the projections (+ the q/k/v biases), OLMo-2's q/k norms over
    the whole projection width before the head reshape, then the per-head
    q/k norms where the config has them (JAX ``_attention_block``,
    llama.py:1207-1221, and the engine's ``_qkv``, engine.py:379-391)."""
    b, t = h.shape[0], h.shape[1]
    q, k, v = _proj(layer, "wq", h), _proj(layer, "wk", h), _proj(layer, "wv", h)
    if c.qkv_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    if c.qk_norm_flat:
        q, k = rms_norm(q, layer["q_norm"], c.norm_eps), rms_norm(k, layer["k_norm"], c.norm_eps)
    q = q.view(b, t, c.n_heads, c.head_dim).transpose(1, 2)
    k = k.view(b, t, c.n_kv_heads, c.head_dim).transpose(1, 2)
    v = v.view(b, t, c.n_kv_heads, c.head_dim).transpose(1, 2)
    if c.qk_norm:
        q, k = qk_norm_apply(q, k, layer, c)
    return q, k, v


def _position_qk(q, k, c: LlamaConfig, nope: bool, rope, temp_apply) -> tuple:
    """A layer's q and k after position: ``rope(t)`` and then Llama4's L2
    norm on a rope layer; on a NoPE layer (Llama4, Cohere2's global
    layers) no rope, and q scaled by ``temp_apply`` where the config has a
    temperature (``_attention_block``, llama.py:1224-1233, and the engine's
    ``one_layer``, engine.py:775-782)."""
    if not nope:
        q, k = rope(q), rope(k)
        if c.qk_l2_norm:
            q, k = l2_norm(q, c.norm_eps), l2_norm(k, c.norm_eps)
    elif c.attn_temp_scale:
        q = temp_apply(q)
    return q, k


def _mla_q(h: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    """MLA: normed hidden [B, T, E] → q [B, H, T, qk_head_dim], pre-rope:
    ``wq``, or ``wq_a`` → ``q_a_norm`` → ``wq_b`` with a q_lora_rank."""
    b, t, _ = h.shape
    if c.q_lora_rank:
        q = _proj(layer, "wq_b", rms_norm(_proj(layer, "wq_a", h), layer["q_a_norm"], c.norm_eps))
    else:
        q = _proj(layer, "wq", h)
    return q.view(b, t, c.n_heads, c.qk_head_dim).transpose(1, 2)


def _mla_latents(h: torch.Tensor, layer: dict, c: LlamaConfig) -> tuple:
    """MLA: normed hidden [B, T, E] → (ckv [B, T, rank] normed, k_pe [B,
    T, rope] un-roped)."""
    kv_a = _proj(layer, "wkv_a", h)
    return rms_norm(kv_a[..., : c.kv_lora_rank], layer["kv_a_norm"], c.norm_eps), kv_a[..., c.kv_lora_rank :]


def mla_qkv(h: torch.Tensor, layer: dict, c: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor) -> tuple:
    """DeepSeek's MLA projections in the non-absorbed (training) form
    (``mla_qkv``, dstack_tpu/models/llama.py:1129): normed hidden [B, T,
    E] → q and k [B, H, T, qk_head_dim], v [B, H, T, v_head_dim]. The
    latent ``ckv`` decodes through ``wkv_b`` into every head's k_nope and
    v; the interleaved rope turns each head's q_pe and the one k_pe that
    all heads share (broadcast), which joins each head's k_nope. The
    serving engine takes the absorbed form over the same leaves."""
    b, t, _ = h.shape
    nope, rope = c.qk_nope_head_dim, c.qk_rope_head_dim
    q = _mla_q(h, layer, c)
    ckv, k_pe = _mla_latents(h, layer, c)
    kv = _proj(layer, "wkv_b", ckv).view(b, t, c.n_heads, nope + c.v_head_dim).transpose(1, 2)
    q_pe = apply_rope(q[..., nope:], cos, sin, interleaved=True)
    k_pe = apply_rope(k_pe[:, None], cos, sin, interleaved=True)  # [B, 1, T, rope]
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, c.n_heads, t, rope)], dim=-1)
    return q, k, kv[..., nope:]


def _attn_out(o: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    """The o projection of the attention output [..., q_dim] (+ ``bo``),
    normed again on Gemma2/3, GLM-4 and OLMo-2 (``attn_post_norm``) and
    scaled by Granite's residual multiplier."""
    ao = _proj(layer, "wo", o)
    if c.proj_bias:
        ao = ao + layer["bo"]
    if c.post_norms:
        ao = model_norm(ao, layer["attn_post_norm"], c)
    return _scaled(ao, c.residual_multiplier) if c.residual_multiplier else ao


def _embed_lookup(params: dict, tokens: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    """Embedding rows in the model dtype; an id out of range gives zeros
    (JAX ``.at[tokens].get(mode="fill", fill_value=0)``); Gemma scales
    them by sqrt(H) and Granite by its embedding multiplier, each rounded
    to the model dtype (``_embed_tokens``, llama.py:1349-1370)."""
    emb = params["embed"]
    valid = (tokens >= 0) & (tokens < emb.shape[0])
    x = emb[torch.where(valid, tokens, torch.zeros_like(tokens)).long()]
    x = torch.where(valid[..., None], x, torch.zeros_like(x)).to(c.dtype)
    if c.embed_scale:
        x = _scaled(x, c.hidden_size**0.5)
    if c.embed_multiplier:
        x = _scaled(x, c.embed_multiplier)
    return x


def _head_logits(params: dict, x: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    """Post-final-norm hidden [..., E] → f32 logits [..., V] over the tied
    embedding or ``lm_head`` (``head_logits_einsum`` with
    ``preferred_element_type=f32``), times Cohere's and Granite's logit
    scale, then Gemma2's tanh cap (``_lm_head``, llama.py:1376-1396). An
    int8 head (``lm_head_q``, ``lm_head_s``) takes W8's head form: the f32
    product times the f32 scales, before the logit scale and the cap
    (``head_logits_einsum``, llama.py:1400-1420)."""
    if "lm_head_q" in params:
        logits = w8_matmul.w8_head(x, params["lm_head_q"], params["lm_head_s"])
    else:
        logits = matmul_f32(x, lm_head_weight(params, c))
    if c.logit_scale:
        logits = logits * c.logit_scale
    if c.logit_softcap:
        logits = c.logit_softcap * torch.tanh(logits / c.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# whole-sequence forward (training, scoring)
# ---------------------------------------------------------------------------


def _attn_qkv(
    x: torch.Tensor, layer: dict, c: LlamaConfig, ropes: tuple, window: int,
    nope: bool = False, positions: Optional[torch.Tensor] = None,
) -> tuple:
    """The attention sublayer up to the flash call → (q, k, v): the input
    norm (:func:`_attn_input`), q/k/v projections and the q/k norms
    (:func:`_qkv_heads`), the layer's rope by its window
    (:func:`layer_rope`; interleaved or rotate-half, partial where the
    config says). Llama4's deltas (llama.py:1224-1235): a rope layer
    applies rope and then, with ``qk_l2_norm``, the weightless L2 norm; a
    ``nope`` layer skips rope and scales q by the temperature at
    ``positions``. Under MLA the projections are :func:`mla_qkv`'s, and v
    is zero-padded to ``qk_head_dim`` so the flash call sees one head
    width (llama.py:1196-1202): K1-K3 at D = 192 on DeepSeek-V2-Lite, the
    padding a real zero tensor the kernels read."""
    t = x.shape[1]
    h = _attn_input(x, layer, c)
    cos, sin = layer_rope(ropes, c, window)
    if c.mla:
        q, k, v = mla_qkv(h, layer, c, cos, sin)
        return q, k, F.pad(v, (0, c.qk_head_dim - c.v_head_dim))
    q, k, v = _qkv_heads(h, layer, c)
    pos = positions if positions is not None else torch.arange(t, device=x.device)
    q, k = _position_qk(q, k, c, nope, lambda u: apply_rope(u, cos, sin, interleaved=c.rope_interleaved),
                        lambda u: u * attn_temp_scales(pos, c)[None, None, :, None].to(u.dtype))
    return q, k, v


def _attend(q, k, v, layer: dict, c: LlamaConfig, window: int, impl: Optional[str], nope: bool = False):
    """Causal attention with the window, the attention softcap and, on a
    Llama4 rope layer, the ``attention_chunk_size`` blocks: the flash
    call (``FlashAttention``: K1, and K2/K3 in the backward), which keeps
    q, k, v, o and lse for its backward."""
    # gpt-oss's sinks reach here only with autograd off (check_trainable):
    # K1 with the exact σ(lse - sink) rescale, as a serving chunk runs them
    return attention(q, k, v, causal=True, scale=c.attention_scale, window=window,
                     softcap=c.attn_softcap, chunk=0 if nope else c.attention_chunk_size, impl=impl,
                     sinks=layer["sinks"] if c.attn_sinks else None, sinks_forward_only=True)


def _attn_post(o: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    """The flash output o [B, H, T, D] → the sublayer's output [B, T, E]:
    MLA's padded columns dropped (llama.py:1268-1269, so their cotangent,
    and dv's padded columns, are zero), the heads merged, ``wo`` and the
    post-attention norm (:func:`_attn_out`)."""
    b, _, t, _ = o.shape
    if c.mla:
        o = o[..., : c.v_head_dim]
    return _attn_out(o.transpose(1, 2).reshape(b, t, c.o_dim), layer, c)


def check_trainable(config: LlamaConfig) -> None:
    """Raise ``NotImplementedError`` for a config :func:`forward` cannot
    train: the gpt-oss deltas (sinks, expert biases, the clamped GLU, the
    top-k-softmax router, which JAX trains on its masked XLA attention),
    naming ROADMAP A5.7; and the other dense families' deltas (q/k/v and
    output biases, the LayerNorm flavours, the parallel block, post-norm
    only layers and flat q/k norms, the gateless MLP and relu², partial or
    interleaved rope, Granite's multipliers, the logit scale), naming
    A5.8; and Llama4's (the sigmoid-input router, NoPE layers and their
    temperature, the L2 q/k norm, chunk masks), naming A5.9. All run only
    with autograd off (serving, embeddings). The dense Llama and Gemma
    families, Qwen3, Mistral, the softmax-routed MoE (Mixtral, Qwen3-MoE),
    DeepSeek's MLA and its MoE train."""
    c = config
    if c.attn_sinks or c.moe_bias or c.moe_act != "silu" or c.router_topk_softmax:
        raise NotImplementedError(
            "the gpt-oss deltas (sinks, biases, the clamped GLU) are served but not "
            "trained yet: gpt-oss training is ROADMAP A5.7"
        )
    deltas = [name for name, on in (
        ("q/k/v biases", c.qkv_bias), ("output and MLP biases", c.proj_bias),
        (f"{c.norm_type} norms", c.norm_type != "rms"), ("the parallel block", c.parallel_block),
        ("post-norm-only layers", not c.pre_norm), ("flat q/k norms", c.qk_norm_flat),
        ("the gateless MLP", c.mlp_gateless), (f"{c.hidden_act} activation", c.hidden_act == "relu2"),
        ("partial rope", c.partial_rotary != 1.0), ("interleaved rope", c.rope_interleaved and not c.mla),
        ("Granite's multipliers", bool(c.embed_multiplier or c.residual_multiplier)),
        ("the logit scale", bool(c.logit_scale)),
    ) if on]
    llama4 = [name for name, on in (
        ("the sigmoid-input router", c.router_sigmoid_input), ("NoPE layers", bool(c.nope_pattern)),
        ("the NoPE temperature", bool(c.attn_temp_scale)), ("the L2 q/k norm", c.qk_l2_norm),
        ("chunk masks", bool(c.attention_chunk_size)),
    ) if on]
    refusals = []
    if deltas:
        refusals.append(f"the dense-family deltas ({', '.join(deltas)}) are served but not trained yet: "
                        "dense-family training is ROADMAP A5.8")
    if llama4:
        refusals.append(f"the Llama4 deltas ({', '.join(llama4)}) are served but not trained yet: "
                        "Llama4 training is ROADMAP A5.9")
    if refusals:
        raise NotImplementedError("; ".join(refusals))


def _layer(x, layer, c, ropes, window, impl, nope=False, positions=None):
    """One layer → (x, its router aux loss): the attention sublayer (JAX's
    ``_attention_block``, llama.py:1177: :func:`_attn_qkv`, the flash call
    :func:`_attend`, :func:`_attn_post`) and ``_mlp_block``'s pair
    (llama.py:1281), added sequentially or, under Cohere's parallel block,
    jointly (:func:`_residual`)."""
    q, k, v = _attn_qkv(x, layer, c, ropes, window, nope, positions)
    return _layer_out(x, _attend(q, k, v, layer, c, window, impl, nope), layer, c)


def _layer_out(x, o, layer, c):
    """The layer after its flash call: :func:`_attn_post` on o, then
    :func:`_residual` → (x, its router aux loss)."""
    return _residual(x, _attn_post(o, layer, c), layer, c, aux=True)


def _layer_remat(x, layer, c, ropes, window, impl, nope=False, positions=None):
    """:func:`_layer` under remat, differing from it only by the two
    checkpoint calls: the flash residuals are saved, as JAX's
    ``save_only_these_names("flash_residuals")`` keeps them
    (llama.py:1494-1504): the parts before and after the flash call each
    run under ``torch.utils.checkpoint`` and are recomputed in the
    backward, while the flash call between them keeps q, k, v, o and lse.
    So K1 runs once a layer and micro-batch, and the layer keeps its
    input, q, k, v, o and lse for the backward."""
    q, k, v = checkpoint(_attn_qkv, x, layer, c, ropes, window, nope, positions, use_reentrant=False)
    o = _attend(q, k, v, layer, c, window, impl, nope)
    return checkpoint(_layer_out, x, o, layer, c, use_reentrant=False)


def forward(
    params: dict,
    tokens: torch.Tensor,  # [B, T] int
    config: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    return_hidden: bool = False,
    return_aux: bool = False,
    impl: Optional[str] = None,  # attention: None = by device | "plain"
):
    """Token ids → f32 logits [B, T, V] (tanh-capped where the config sets
    ``logit_softcap``), or with ``return_hidden`` the final normed hidden
    states [B, T, E] in the model dtype (the trainer fuses the head, and
    the cap, into its loss). With ``return_aux`` → (that, the router aux
    loss summed over the MoE stack: f32, 0 for a dense model; JAX sums
    the main scan's and drops the dense prelude's, which is 0).

    Every dense family delta runs: Llama, and Gemma's GeGLU, (1 + w)
    norms, sqrt(H) embedding scale, sandwich norms, q/k norms, attention
    and logit caps, with each layer's window and rope from
    :func:`layer_windows` and :func:`layer_rope`, static per layer as
    JAX's grouped scan gives them (llama.py:889). So do DeepSeek's: MLA in
    its non-absorbed form (:func:`mla_qkv`, K1-K3 at D = 192), the MoE
    with its shared expert and router aux losses, and the dense prelude
    (``params["dense_layers"]``, run before the MoE stack as JAX scans it,
    llama.py:1503-1512). A gpt-oss config runs with autograd off (its
    sinks through K1 and ``sink_postscale``, as a serving chunk runs them,
    where JAX takes ``_xla_attention``: the same function) and raises
    under autograd (:func:`check_trainable`).

    ``lora`` is an adapter tree from ``train/lora.py`` (stacked per-layer
    factors beside the base weights). The stacked ``[L, ...]`` leaves are
    unbound once, so each leaf's gradient is stacked once in the
    backward instead of being scattered into a zero ``[L, ...]`` tensor
    per layer. With ``config.remat`` (and autograd on) every layer runs
    as :func:`_layer_remat`: its activations are recomputed in the
    backward, but not its flash call, whose q, k, v, o and logsumexp are
    kept (JAX's ``flash_residuals``), so K1 runs once a layer."""
    c = config
    if torch.is_grad_enabled():
        check_trainable(c)
    x = _embed_lookup(params, tokens, c)
    pos = positions if positions is not None else torch.arange(tokens.shape[1], device=tokens.device)
    ropes = dual_rope_freqs(c, pos)
    remat = c.remat and torch.is_grad_enabled()
    check_layer_layout(c)
    windows, nopes = layer_windows(c), layer_nope(c)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(x, leaves, kinds, extra):
        # the stack's leaves unbound once: each leaf's gradient is stacked
        # once in the backward, not scattered into [L, ...] zeros a layer
        per_layer = {name: w.unbind(0) for name, w in leaves.items()}
        auxs = []
        for i, (window, nope) in enumerate(kinds):
            layer = {**{name: ws[i] for name, ws in per_layer.items()}, **extra}
            if remat:
                x, a = _layer_remat(x, layer, c, ropes, window, impl, nope, pos)
            else:
                x, a = _layer(x, layer, c, ropes, window, impl, nope, pos)
            auxs.append(a)
        return x, auxs

    if "dense_layers" in params:  # DeepSeek's prelude: its aux is 0, dropped as JAX drops it
        x, _ = run(x, params["dense_layers"], [(windows[0], nopes[0])] * c.first_k_dense, {})
    leaves = {**params["layers"], **(lora["layers"] if lora is not None else {})}
    extra = {"lora_scale": lora_scale} if lora is not None else {}
    x, auxs = run(x, leaves, list(zip(windows, nopes))[: c.n_layers - c.first_k_dense], extra)
    for a in auxs:
        aux = aux + a
    x = model_norm(x, params["final_norm"], c)  # _lm_head (llama.py:1376)
    out = x if return_hidden else _head_logits(params, x, c)
    return (out, aux) if return_aux else out


def embed_padded_len(n: int) -> int:
    """The length :func:`embed_vectors` runs an n-token input at: the
    least power of two of at least 16 and n."""
    padded = 16
    while padded < n:
        padded *= 2
    return padded


def embed_vectors(params: dict, config, id_lists: list, impl: Optional[str] = None):
    """Mean-pooled, L2-normalised final hidden states → f32 [N, H] on the
    params' device, one row a prompt (the JAX server's /v1/embeddings):
    ``forward(..., return_hidden=True)`` in the model's dtype, cast to
    f32, averaged over the real tokens, divided by max(norm, 1e-9). Each
    prompt is padded, as JAX pads it, to a power of two of at least 16:
    the padding comes after the real tokens, so under causal attention it
    changes no real row, and the MoE's expert capacity, which depends on
    the sequence length, is JAX's. On the card every layer launches K1
    (its D = 192 form on DeepSeek, with the sink rescale on gpt-oss) over
    the padded length; ``impl="plain"`` takes the plain attention."""
    vecs = []
    with torch.inference_mode():
        for ids in id_lists:
            padded = embed_padded_len(len(ids))
            toks = torch.tensor([ids + [0] * (padded - len(ids))], dtype=torch.long,
                                device=params["embed"].device)
            h = forward(params, toks, config, return_hidden=True, impl=impl).float()[0]
            pooled = h[: len(ids)].sum(dim=0) / max(len(ids), 1)
            vecs.append(pooled / pooled.norm().clamp_min(1e-9))
        return torch.stack(vecs)
