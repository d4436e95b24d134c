"""HuggingFace checkpoint → the port's parameter dict (counterpart of
dstack_tpu.models.convert_hf).

Point :func:`load_checkpoint` at a ``save_pretrained`` directory
(safetensors or ``pytorch_model*.bin`` shards) and get back
``(LlamaConfig, params)`` for the serving engine: the same keys and
stacked ``[L, ...]`` layout as :func:`~dstack_tpu_torch.models.llama.
init_params`, so every leaf is one tensor.

Model types: ``llama``, ``gemma``, ``gemma2``, ``gemma3`` /
``gemma3_text`` (a multimodal Gemma3 checkpoint loads its text tower),
``qwen2``, ``qwen3``, ``mistral``, ``phi3`` (fused q/k/v and gate/up
projections split on load), ``granite``, ``starcoder2``, ``nemotron``,
``cohere``, ``olmo2``, ``glm`` and ``glm4``. Each maps onto the config's
family flags, as the JAX converter maps them (convert_hf.py:55-334):
Gemma's (1 + w) norms, embedding scale and tanh GELU; Gemma2's sandwich
norms, softcaps and alternating windows; Gemma3's q/k norms, periodic
windows and dual rope; Qwen's q/k/v biases and q/k norms; Mistral's
window; Granite's multipliers; StarCoder2's and Nemotron's LayerNorms
with biases (stored stacked ``[2, H]``: :func:`_stack_nemotron_norms`)
and gateless MLPs; Cohere's LayerNorm, parallel block, interleaved rope
and logit scale; OLMo-2's post-norm-only layers and flat q/k norms;
GLM's interleaved partial rope, fused gate/up (:func:`_split_glm`) and
glm4's sandwich norms. The MoE types: ``mixtral`` and ``qwen3_moe``
(per-expert projections stacked into ``[L, E, ...]``, :data:`_MOE_NAMES`),
``gpt_oss`` (fused, pre-stacked experts whose ``gate_up_proj`` interleaves
gate and up columns, biases on every expert matmul, a linear router with an
f32 bias), ``llama4`` / ``llama4_text`` (the text tower, nested under
``text_config`` in a multimodal checkpoint; fused experts with gate then
up halves, a shared expert, periodic NoPE layers, chunked attention, the
L2 q/k norm and the NoPE temperature), ``cohere2`` (Cohere's layout with a
periodic window whose global layers are NoPE layers) and ``deepseek_v2`` /
``deepseek_v3`` (MLA, the dense prelude, the fine-grained MoE with shared
experts, V3's sigmoid scores, selection bias and group limit:
:func:`_deepseek_config`, :func:`_convert_deepseek`). Every type JAX's
converter imports loads; any other type raises as JAX's does, and so do
the layouts JAX refuses.

Safetensors are read by :func:`read_safetensors`, a parser of the file
format (an 8-byte little-endian header length, a JSON header, then the
raw little-endian bytes of each tensor), so the port needs no
``safetensors`` package; ``.bin`` shards go through
``torch.load(weights_only=True)``, as JAX reads them.

The export is the inverse (convert_hf.py:954-1410): :func:`config_to_hf`
and :func:`export_state_dict` give JAX's ``config.json`` and tensor names
for every family HF can express (gpt-oss and an int8 tree are refused, as
JAX refuses them), and :func:`save_checkpoint` writes a ``save_pretrained``
directory with a bf16 ``model.safetensors`` by :func:`write_safetensors`,
the reader's counterpart; ``finetune --export-hf`` calls it.

Layout: an HF ``*_proj.weight`` is ``[out, in]`` (``nn.Linear``), the
port's projections ``[in, out]``: transposed on load. HF llama-family
checkpoints already use the rotate-half rope convention; Cohere's and
GLM's rotate interleaved pairs, which the config's ``rope_interleaved``
says.
"""

import json
import math
from pathlib import Path
from typing import Any, Optional

import torch

from dstack_tpu_torch.models.llama import LlamaConfig

__all__ = ["config_from_hf", "config_to_hf", "convert_state_dict", "export_state_dict", "load_checkpoint",
           "read_safetensors", "save_checkpoint", "write_safetensors"]

SUPPORTED = ("llama", "gemma", "gemma2", "gemma3", "gemma3_text", "qwen2", "qwen3", "qwen3_moe",
             "mixtral", "gpt_oss", "mistral", "phi3", "granite", "starcoder2", "nemotron", "cohere",
             "cohere2", "olmo2", "glm", "glm4", "llama4", "llama4_text", "deepseek_v2", "deepseek_v3")
# the types whose checkpoints may carry q/k/v biases (attention_bias)
ATTENTION_BIAS = ("qwen2", "qwen3", "qwen3_moe", "glm", "glm4", "gpt_oss")
# MoE tensor names a family: (router weight, expert prefix, (gate, up,
# down) per-expert names), JAX's table (convert_hf.py:495-508)
_MOE_NAMES = {
    "qwen3_moe": ("mlp.gate.weight", "mlp.experts", ("gate_proj", "up_proj", "down_proj")),
    "mixtral": ("block_sparse_moe.gate.weight", "block_sparse_moe.experts", ("w1", "w3", "w2")),
}
GEMMA = ("gemma", "gemma2", "gemma3", "gemma3_text")
REQUIRED = ("hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size", "intermediate_size")
# HF hidden_act → the config's activation (Gemma's is always the tanh GELU)
ACTS = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh", "relu2": "relu2"}


def _check_model_type(model_type: str) -> None:
    """Raise for a model type the port does not load, as JAX refuses it."""
    if model_type not in SUPPORTED:
        raise ValueError(f"unsupported HF model_type {model_type!r}")


def config_from_hf(hf: dict, dtype: Any = torch.bfloat16) -> LlamaConfig:
    """HF ``config.json`` dict → :class:`LlamaConfig` (the JAX
    ``config_from_hf``'s branches for the model types in
    :data:`SUPPORTED`, their refusals included)."""
    mt = hf.get("model_type", "llama")
    if mt in ("gemma3", "llama4") and "text_config" in hf:
        # multimodal wrapper: the text tower's config is nested (the vision
        # tower is out of scope; convert_state_dict drops its weights)
        hf = {**hf["text_config"], "model_type": f"{mt}_text"}
        mt = f"{mt}_text"
    _check_model_type(mt)
    if hf.get("attention_bias") and mt not in ATTENTION_BIAS:
        # q/k/v/o biases in the checkpoint that these families never read
        # (StarCoder2 spells its biases use_bias, read in its branch)
        raise ValueError(f"{mt} checkpoint sets attention_bias=true, which the port loads only "
                         "for qwen2/qwen3/glm/glm4")
    missing = [k for k in REQUIRED if k not in hf]
    if missing:
        raise ValueError(f"{mt} config.json lacks {', '.join(missing)}")
    hidden = hf["hidden_size"]
    n_heads = hf["num_attention_heads"]
    act = hf.get("hidden_act") or "silu"
    if mt in GEMMA:
        # Gemma configs say "gelu" or hidden_activation, but the models
        # always use the tanh approximation
        act = "gelu_tanh"
    elif act not in ACTS:
        raise ValueError(f"unsupported hidden_act {act!r} (supported: {sorted(ACTS)})")
    else:
        act = ACTS[act]
    common = dict(
        hidden_act=act,
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        head_dim=hf.get("head_dim") or hidden // n_heads,
        intermediate_size=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        rope_scaling=_rope_scaling_from_hf(hf),
        dtype=dtype,
    )
    if mt == "llama":
        return LlamaConfig(**common)
    if mt == "qwen2":
        if hf.get("use_sliding_window"):
            # HF Qwen2 windows only the layers from max_window_layers on, a
            # layering the periodic sliding_pattern cannot express but
            # uniformly; refused rather than run with full attention
            if hf.get("max_window_layers", 0) not in (0, None):
                raise ValueError("qwen2 use_sliding_window with max_window_layers > 0 is not "
                                 "supported (nor by the JAX converter)")
            common["sliding_window"] = hf.get("sliding_window") or 0
        return LlamaConfig(**common, qkv_bias=True)  # Qwen2 always has q/k/v biases
    if mt == "qwen3":
        if hf.get("use_sliding_window") or "sliding_attention" in (hf.get("layer_types") or []):
            raise ValueError("qwen3 sliding-attention layer_types are not supported (nor by the "
                             "JAX converter)")
        return LlamaConfig(**common, qk_norm=True, qkv_bias=bool(hf.get("attention_bias")))
    if mt == "qwen3_moe":
        # qwen3's attention and a sparse MoE on every layer; a checkpoint
        # mixing dense and sparse layers is refused, as are windows
        if hf.get("mlp_only_layers") or hf.get("decoder_sparse_step", 1) != 1:
            raise ValueError("qwen3_moe with dense layers (mlp_only_layers / decoder_sparse_step "
                             "!= 1) is not supported (nor by the JAX converter)")
        if hf.get("use_sliding_window"):
            raise ValueError("qwen3_moe sliding windows are not supported (nor by the JAX converter)")
        return LlamaConfig(
            **{**common, "intermediate_size": hf["moe_intermediate_size"]},
            qk_norm=True, qkv_bias=bool(hf.get("attention_bias")),
            n_experts=hf["num_experts"], experts_per_token=hf.get("num_experts_per_tok", 8),
            router_renorm=bool(hf.get("norm_topk_prob", True)),
        )
    if mt == "gpt_oss":
        # alternating sliding/full layers with sinks, a linear router (bias,
        # softmax over the top-k logits), fused biased experts with the
        # clamped GLU, yarn with truncate=false
        lt = hf.get("layer_types") or []
        expected = ["sliding_attention" if i % 2 == 0 else "full_attention"
                    for i in range(hf["num_hidden_layers"])]
        if lt and lt != expected:
            raise ValueError("gpt_oss layer_types deviate from the alternating sliding/full pattern; "
                             "not supported (nor by the JAX converter)")
        return LlamaConfig(
            **common, qkv_bias=True, proj_bias=True, attn_sinks=True,
            sliding_window=hf.get("sliding_window") or 0,
            # absent layer_types default to the alternating pattern in HF
            sliding_pattern=2,
            n_experts=hf["num_local_experts"], experts_per_token=hf.get("num_experts_per_tok", 4),
            router_topk_softmax=True, moe_bias=True, moe_act="oai_glu",
            act_limit=float(hf.get("swiglu_limit") or 7.0),
        )
    if mt == "mixtral":
        return LlamaConfig(
            **common, n_experts=hf["num_local_experts"],
            experts_per_token=hf.get("num_experts_per_tok", 2), router_renorm=True,
        )
    if mt in ("llama4", "llama4_text"):
        return _llama4_config(hf, common)
    if mt in ("deepseek_v2", "deepseek_v3"):
        return _deepseek_config(hf, common, mt)
    if mt == "cohere2":
        # Command R7B: Cohere's layout and a periodic window whose global
        # layers carry no rope (the NoPE layers are the global layers)
        if hf.get("use_qk_norm"):
            raise ValueError("cohere2 use_qk_norm is not supported (nor by the JAX converter)")
        # cohere2's default period is 4, not Gemma3's 6
        sw, pattern = _gemma3_pattern({"sliding_window_pattern": 4, **hf}, hf.get("sliding_window") or 0)
        return LlamaConfig(
            **{**common, "norm_eps": float(hf.get("layer_norm_eps", 1e-5)),
               "tie_embeddings": bool(hf.get("tie_word_embeddings", True))},
            norm_type="layernorm", parallel_block=True, rope_interleaved=True,
            logit_scale=float(hf.get("logit_scale", 0.0625)),
            sliding_window=sw, sliding_pattern=pattern, nope_pattern=pattern if sw else 0,
        )
    if mt == "mistral":
        return LlamaConfig(**common, sliding_window=hf.get("sliding_window") or 0)
    if mt == "phi3":
        if float(hf.get("partial_rotary_factor") or 1.0) != 1.0:
            raise ValueError("phi3 partial_rotary_factor != 1 is not supported (nor by the JAX "
                             "converter)")
        return LlamaConfig(**common, sliding_window=hf.get("sliding_window") or 0)
    if mt == "granite":
        # the llama skeleton and four scalars: attention_multiplier is the
        # softmax scale; logits_scaling divides, so it maps onto 1 / logit_scale
        ls = float(hf.get("logits_scaling") or 1.0)
        return LlamaConfig(
            **common,
            attn_scale=float(hf.get("attention_multiplier") or 1.0),
            embed_multiplier=float(hf.get("embedding_multiplier") or 1.0),
            residual_multiplier=float(hf.get("residual_multiplier") or 1.0),
            logit_scale=(1.0 / ls) if ls != 1.0 else 0.0,
        )
    if mt == "starcoder2":
        # LayerNorm with a bias (stored stacked), biases on every
        # projection, a gateless GELU MLP (c_fc/c_proj), tied embeddings
        return LlamaConfig(
            **{**common, "norm_eps": float(hf.get("norm_epsilon", 1e-5)),
               "tie_embeddings": bool(hf.get("tie_word_embeddings", True)),
               "sliding_window": hf.get("sliding_window") or 0},
            norm_type="layernorm_bias", mlp_gateless=True,
            qkv_bias=bool(hf.get("use_bias", True)), proj_bias=bool(hf.get("use_bias", True)),
        )
    if mt == "nemotron":
        # LayerNorm1P ((1 + w) norm + b, stored stacked), a gateless relu²
        # MLP, rotate-half partial rope
        return LlamaConfig(
            **{**common, "norm_eps": float(hf.get("norm_eps", 1e-5))},
            norm_type="layernorm1p", mlp_gateless=True,
            partial_rotary=float(hf.get("partial_rotary_factor") or 0.5),
        )
    if mt == "cohere":
        # weight-only LayerNorm, the parallel block over one input norm,
        # interleaved rope, the logit scale, optional per-head q/k
        # LayerNorms; Cohere ties by default and omits the key when tied
        return LlamaConfig(
            **{**common, "norm_eps": float(hf.get("layer_norm_eps", 1e-5)),
               "tie_embeddings": bool(hf.get("tie_word_embeddings", True))},
            norm_type="layernorm", parallel_block=True, rope_interleaved=True,
            qk_norm=bool(hf.get("use_qk_norm")),
            logit_scale=float(hf.get("logit_scale", 0.0625)),  # HF's default
        )
    if mt == "olmo2":
        # no input norms (the sublayer outputs are normed), q/k RMSNorm over
        # the whole projection width before the head reshape
        return LlamaConfig(**common, pre_norm=False, post_norms=True, qk_norm_flat=True)
    if mt in ("glm", "glm4"):
        # interleaved rope over the first half of a head, q/k/v biases (a
        # real knob, default on), fused gate/up (split on load); glm4 adds
        # sandwich norms
        return LlamaConfig(
            **common,
            qkv_bias=bool(hf.get("attention_bias", True)),
            rope_interleaved=True,
            partial_rotary=float(hf.get("partial_rotary_factor") or 0.5),
            post_norms=(mt == "glm4"),
        )
    attn_scale = (
        float(hf["query_pre_attn_scalar"]) ** -0.5 if hf.get("query_pre_attn_scalar") else None
    )
    gemma = dict(norm_offset=True, embed_scale=True)
    if mt == "gemma":
        return LlamaConfig(**{**common, "tie_embeddings": True}, **gemma)
    if mt == "gemma2":
        return LlamaConfig(
            **{**common, "tie_embeddings": True}, **gemma,
            post_norms=True,
            sliding_window=hf.get("sliding_window") or 0,
            sliding_pattern=2,  # even layers sliding, odd global
            attn_softcap=hf.get("attn_logit_softcapping") or 0.0,
            logit_softcap=hf.get("final_logit_softcapping") or 0.0,
            attn_scale=attn_scale,
        )
    sw, pattern = _gemma3_pattern(hf, hf.get("sliding_window") or 0)
    return LlamaConfig(
        **{**common, "tie_embeddings": hf.get("tie_word_embeddings", True)}, **gemma,
        post_norms=True,
        qk_norm=True,
        sliding_window=sw,
        sliding_pattern=pattern,
        # dual rope: sliding layers rotate at the unscaled local theta,
        # global layers at rope_theta (+ linear scaling)
        rope_local_theta=hf.get("rope_local_base_freq", 10000.0),
        attn_scale=attn_scale,
    )


def _v2_mscale_fix() -> bool:
    """Opt-in (``DTPU_DEEPSEEK_V2_MSCALE_FIX``): scale DeepSeek-V2's
    attention as the released model's own code does (the mscale² factor),
    not as HF's DeepseekV2Attention does; the JAX converter's switch
    (convert_hf.py:337), copied."""
    import os

    return os.environ.get("DTPU_DEEPSEEK_V2_MSCALE_FIX", "").lower() in ("1", "true", "yes")


def _deepseek_config(hf: dict, common: dict, mt: str) -> LlamaConfig:
    """DeepSeek-V2/V3 → the config (the JAX ``_deepseek_config``,
    convert_hf.py:348): MLA's ranks and head widths, the dense prelude and
    the fine-grained MoE with its fused shared experts; V3 adds sigmoid
    scores with a selection-only bias and the group limit, and always the
    yarn mscale² on the softmax scale (V2 only with
    :func:`_v2_mscale_fix`, as HF's native V2 applies none)."""
    if hf.get("attention_bias"):
        raise ValueError(f"{mt} attention_bias=true is not supported (nor by the JAX converter)")
    v3 = mt == "deepseek_v3"
    mla = dict(
        q_lora_rank=hf.get("q_lora_rank") or 0, kv_lora_rank=hf["kv_lora_rank"],
        qk_nope_head_dim=hf["qk_nope_head_dim"], qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"],
    )
    rs = hf.get("rope_scaling")
    if rs and rs.get("mscale_all_dim") and (v3 or _v2_mscale_fix()):
        ms = 0.1 * float(rs["mscale_all_dim"]) * math.log(float(rs["factor"])) + 1.0
        mla["attn_scale"] = (hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]) ** -0.5 * ms * ms
    n_routed = hf.get("n_routed_experts")
    first_k = hf.get("first_k_dense_replace", 0)
    if not n_routed or first_k >= hf["num_hidden_layers"]:
        return LlamaConfig(**common, **mla)  # every layer dense: a plain MLA transformer
    if hf.get("moe_layer_freq", 1) != 1:
        raise ValueError(f"{mt} moe_layer_freq != 1 is not supported (nor by the JAX converter)")
    topk_method = hf.get("topk_method") or ("noaux_tc" if v3 else "greedy")
    if topk_method == "group_limited_greedy" or v3:
        groups = (hf["n_group"], hf["topk_group"])
        if groups == (1, 1):
            groups = ()  # one group of everything limits nothing
    elif topk_method == "greedy":
        groups = ()
    else:
        raise ValueError(f"{mt} topk_method {topk_method!r} is not supported (nor by the JAX converter)")
    shared = hf.get("n_shared_experts") or 0
    moe_inter = hf["moe_intermediate_size"]
    return LlamaConfig(
        **{**common, "intermediate_size": moe_inter}, **mla,
        n_experts=n_routed, experts_per_token=hf["num_experts_per_tok"],
        router_renorm=bool(hf.get("norm_topk_prob", False)),
        router_score="sigmoid" if v3 else "softmax", router_bias=v3, router_groups=groups,
        routed_scale=float(hf.get("routed_scaling_factor", 1.0)),
        moe_shared_expert=shared > 0, moe_shared_intermediate=shared * moe_inter,
        first_k_dense=first_k, dense_intermediate=hf["intermediate_size"],
    )


def _llama4_config(hf: dict, common: dict) -> LlamaConfig:
    """Llama4's text tower → the config (the JAX ``_llama4_config``,
    convert_hf.py:415): interleaved rope, periodic NoPE layers from
    ``no_rope_layers`` (1 = rope; every p-th layer NoPE, else refused),
    chunked attention, the L2 q/k norm, the NoPE temperature, and the
    sigmoid-input MoE with a shared expert on every layer (interleaved
    dense and MoE layers are refused)."""
    n_layers = hf["num_hidden_layers"]
    moe_layers = hf.get("moe_layers")
    if hf.get("interleave_moe_layer_step", 1) != 1 or (moe_layers is not None and len(moe_layers) != n_layers):
        raise ValueError("llama4 with interleaved dense/MoE layers (interleave_moe_layer_step != 1) "
                         "is not supported (nor by the JAX converter)")
    nrl = hf.get("no_rope_layers")
    pattern = 4
    if nrl:
        nope_ix = [i for i, use_rope in enumerate(nrl) if not use_rope]
        pattern = nope_ix[0] + 1 if nope_ix else 0
        if pattern and [1 if r else 0 for r in nrl] != [0 if (i + 1) % pattern == 0 else 1
                                                         for i in range(n_layers)]:
            raise ValueError(f"llama4 no_rope_layers {nrl!r} is not the periodic 1-NoPE-per-{pattern} "
                             "layout this stack expresses")
    return LlamaConfig(
        **common, rope_interleaved=True, nope_pattern=pattern,
        attention_chunk_size=hf.get("attention_chunk_size") or 0,
        qk_l2_norm=bool(hf.get("use_qk_norm", True)),
        attn_temp_scale=float(hf.get("attn_scale", 0.1)) if hf.get("attn_temperature_tuning") else 0.0,
        attn_temp_floor=float(hf.get("floor_scale", 8192.0)),
        n_experts=hf["num_local_experts"], experts_per_token=hf.get("num_experts_per_tok", 1),
        router_sigmoid_input=True, moe_shared_expert=True,
    )


def _gemma3_pattern(hf: dict, sliding_window: int) -> tuple[int, int]:
    """Gemma3 layer layout → (sliding_window, sliding_pattern). Newer HF
    configs spell it as an explicit ``layer_types`` list, older ones as
    ``sliding_window_pattern`` (every p-th layer global). Only periodic
    layouts are accepted: an aperiodic list is an error, not silent full
    attention. With no sliding layer the window is 0 too (a window with
    pattern 0 would mean "every layer slides")."""
    lt = hf.get("layer_types")
    if lt:
        if not sliding_window or "sliding_attention" not in lt:
            return 0, 0
        globals_ix = [i for i, t in enumerate(lt) if t == "full_attention"]
        if not globals_ix:
            return sliding_window, 0  # uniform sliding (n_layers < pattern)
        p = globals_ix[0] + 1
        expect = ["full_attention" if (i + 1) % p == 0 else "sliding_attention" for i in range(len(lt))]
        if lt != expect:
            raise ValueError(f"gemma3 layer_types {lt!r} is not the periodic 1-global-per-{p} layout")
        return sliding_window, p
    return sliding_window, int(hf.get("sliding_window_pattern") or 6)


def _rope_scaling_from_hf(hf: dict) -> Optional[tuple]:
    """HF ``rope_scaling`` → the config's tuple (the JAX
    ``_rope_scaling_from_hf``, convert_hf.py:511): "llama3"
    (Llama-3.1/3.2), "linear" (Gemma3's global layers) or "yarn"
    (NTK-by-parts, its cos/sin attention factor resolved here from
    ``mscale``/``mscale_all_dim``, a seventh element only when
    ``truncate`` is false). Any other type is an error: loading without it
    would generate silently degraded text."""
    rs = hf.get("rope_scaling")
    if not rs:
        return None
    rope_type = rs.get("rope_type") or rs.get("type")
    if rope_type in (None, "default"):
        return None
    if rope_type == "llama3":
        return (
            float(rs["factor"]), float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]),
        )
    if rope_type == "linear":
        return ("linear", float(rs["factor"]))
    if rope_type == "yarn":
        truncate = bool(rs.get("truncate", True))
        factor = float(rs["factor"])

        def get_mscale(scale, ms=1.0):
            return 1.0 if scale <= 1 else 0.1 * ms * math.log(scale) + 1.0

        att = rs.get("attention_factor")
        if att is None:
            mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")
            if mscale and mscale_all:
                att = get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
            else:
                att = get_mscale(factor)
        orig = rs.get("original_max_position_embeddings") or hf.get("max_position_embeddings", 8192)
        return ("yarn", factor, float(rs.get("beta_fast") or 32), float(rs.get("beta_slow") or 1),
                float(orig), float(att)) + ((False,) if not truncate else ())
    raise ValueError(f"unsupported rope_scaling type {rope_type!r}")


def _stack_nemotron_norms(sd: dict, c: LlamaConfig) -> dict:
    """A LayerNorm with a bias (Nemotron's LayerNorm1P, whose weight is
    already scale - 1, and StarCoder2's) → its ``.weight`` as the stacked
    [2, H] (scale, bias) the tree holds (convert_hf.py:860)."""
    names = ["model.norm"]
    for i in range(c.n_layers):
        names += [f"model.layers.{i}.input_layernorm", f"model.layers.{i}.post_attention_layernorm"]
    for n in names:
        sd[n + ".weight"] = torch.stack([sd.pop(n + ".weight"), sd.pop(n + ".bias")])
    return sd


def _split_glm(sd: dict, c: LlamaConfig, model_type: str) -> dict:
    """GLM's fused ``gate_up_proj`` ([2F, H] rows: gate, then up) split;
    glm4's sandwich norms renamed into the Gemma2-style names the generic
    path reads (post_self_attn → post_attention, post_attention →
    pre_feedforward, post_mlp → post_feedforward; convert_hf.py:877)."""
    F_ = c.intermediate_size
    for i in range(c.n_layers):
        P = f"model.layers.{i}."
        gu = sd.pop(P + "mlp.gate_up_proj.weight")
        sd[P + "mlp.gate_proj.weight"], sd[P + "mlp.up_proj.weight"] = gu[:F_], gu[F_:]
        if model_type == "glm4":
            attn_post = sd.pop(P + "post_self_attn_layernorm.weight")
            pre_mlp = sd.pop(P + "post_attention_layernorm.weight")
            sd[P + "post_feedforward_layernorm.weight"] = sd.pop(P + "post_mlp_layernorm.weight")
            sd[P + "post_attention_layernorm.weight"] = attn_post
            sd[P + "pre_feedforward_layernorm.weight"] = pre_mlp
    return sd


def _split_phi3(sd: dict, c: LlamaConfig) -> dict:
    """Phi-3's fused ``qkv_proj`` (rows q, k, v) and ``gate_up_proj``
    (rows gate, up) split into the per-projection names (convert_hf.py:899)."""
    for i in range(c.n_layers):
        P = f"model.layers.{i}."
        q, k, v = torch.split(sd.pop(P + "self_attn.qkv_proj.weight"), [c.q_dim, c.kv_dim, c.kv_dim])
        sd[P + "self_attn.q_proj.weight"], sd[P + "self_attn.k_proj.weight"] = q, k
        sd[P + "self_attn.v_proj.weight"] = v
        gate, up = torch.chunk(sd.pop(P + "mlp.gate_up_proj.weight"), 2)
        sd[P + "mlp.gate_proj.weight"], sd[P + "mlp.up_proj.weight"] = gate, up
    return sd


def convert_state_dict(sd: dict, config: LlamaConfig, model_type: str = "llama") -> dict:
    """Flat HF state dict (name → tensor) → the port's params: stacked
    ``[L, ...]`` layers in ``config.dtype``, on the CPU (the caller moves
    them to the card). The dense branches of the JAX
    ``convert_state_dict`` (convert_hf.py:581-760): DeepSeek's own layout
    (:func:`_convert_deepseek`), the fused projections split (phi3, glm),
    the LayerNorms with biases stacked (nemotron, starcoder2, whose
    ``c_fc``/``c_proj`` take the unified names), a multimodal checkpoint's
    text tower kept (gemma3, llama4), then one path for every type, with
    its MLP: Llama4's fused experts and shared expert, gpt-oss's
    interleaved experts and biased router, the per-expert stacks of
    mixtral and qwen3_moe, or the dense MLP."""
    c, dt = config, config.dtype
    _check_model_type(model_type)
    if model_type in ("deepseek_v2", "deepseek_v3"):
        return _convert_deepseek(sd, c)
    if model_type == "phi3":
        sd = _split_phi3(dict(sd), c)
    if model_type in ("glm", "glm4"):
        sd = _split_glm(dict(sd), c, model_type)
    if model_type == "nemotron":
        sd = _stack_nemotron_norms(dict(sd), c)
    if model_type == "starcoder2":
        sd = dict(sd)
        for i in range(c.n_layers):  # c_fc/c_proj → the unified names
            P = f"model.layers.{i}.mlp."
            for suff in ("weight", "bias"):
                for theirs, ours in (("c_fc", "up_proj"), ("c_proj", "down_proj")):
                    if f"{P}{theirs}.{suff}" in sd:
                        sd[f"{P}{ours}.{suff}"] = sd.pop(f"{P}{theirs}.{suff}")
        sd = _stack_nemotron_norms(sd, c)  # the same stacked-norm layout
    if model_type in ("gemma3", "llama4"):
        # a multimodal checkpoint: keep the text tower. Both layouts
        # normalize to model.*: language_model.model.layers... (older)
        # and model.language_model.layers... (newer)
        stripped = {}
        for k, v in sd.items():
            if "language_model." not in k:
                continue  # the vision tower and its projector
            k = k.replace("model.language_model.", "model.", 1)
            stripped[k.replace("language_model.", "", 1)] = v
        sd = stripped or sd

    def get(name):
        if name not in sd:
            raise KeyError(f"missing weight {name!r} (have e.g. {sorted(sd)[:5]})")
        return sd[name]

    def stack(fmt, transpose=False):
        mats = [get(fmt.format(i=i)) for i in range(c.n_layers)]
        return torch.stack([m.t() if transpose else m for m in mats]).to(dt).contiguous()

    P = "model.layers.{i}."
    # the sandwich-norm layouts (Gemma2/3; _split_glm renames glm4's into
    # them) norm the attention output with post_attention_layernorm and name
    # the pre-MLP norm pre_feedforward_layernorm; elsewhere
    # post_attention_layernorm is the pre-MLP norm
    sandwich = model_type in ("gemma2", "gemma3", "gemma3_text", "glm4")
    layers = {
        "wq": stack(P + "self_attn.q_proj.weight", transpose=True),
        "wk": stack(P + "self_attn.k_proj.weight", transpose=True),
        "wv": stack(P + "self_attn.v_proj.weight", transpose=True),
        "wo": stack(P + "self_attn.o_proj.weight", transpose=True),
    }
    if c.pre_norm:
        layers["attn_norm"] = stack(P + "input_layernorm.weight")
        if not c.parallel_block:  # Cohere's one input norm is attn_norm
            layers["mlp_norm"] = stack(P + ("pre_feedforward_layernorm.weight" if sandwich
                                            else "post_attention_layernorm.weight"))
    if c.n_experts:
        layers.update(_experts(get, stack, c, model_type))
    else:
        if not c.mlp_gateless:
            layers["w_gate"] = stack(P + "mlp.gate_proj.weight", transpose=True)
        layers["w_up"] = stack(P + "mlp.up_proj.weight", transpose=True)
        layers["w_down"] = stack(P + "mlp.down_proj.weight", transpose=True)
    if c.qkv_bias:
        for n in "qkv":
            layers[f"b{n}"] = stack(P + f"self_attn.{n}_proj.bias")
    if c.proj_bias:  # StarCoder2 and gpt-oss: the o projection's bias; StarCoder2's MLP biases
        layers["bo"] = stack(P + "self_attn.o_proj.bias")
        if not c.n_experts:
            layers["b_up"] = stack(P + "mlp.up_proj.bias")
            layers["b_down"] = stack(P + "mlp.down_proj.bias")
    if c.attn_sinks:  # gpt-oss: f32, as the tree keeps them
        layers["sinks"] = torch.stack([get(f"model.layers.{i}.self_attn.sinks") for i in range(c.n_layers)]
                                      ).float().contiguous()
    if c.qk_norm or c.qk_norm_flat:
        layers["q_norm"] = stack(P + "self_attn.q_norm.weight")
        layers["k_norm"] = stack(P + "self_attn.k_norm.weight")
    if c.post_norms:
        layers["attn_post_norm"] = stack(P + "post_attention_layernorm.weight")
        layers["mlp_post_norm"] = stack(P + "post_feedforward_layernorm.weight")
    params = {
        "embed": get("model.embed_tokens.weight").to(dt).contiguous(),
        "layers": layers,
        "final_norm": get("model.norm.weight").to(dt).contiguous(),
    }
    if not c.tie_embeddings:
        params["lm_head"] = get("lm_head.weight").t().to(dt).contiguous()
    return params


def _experts(get, stack, c: LlamaConfig, model_type: str) -> dict:
    """An MoE stack's expert leaves (convert_hf.py:682-745): Llama4's
    fused, pre-stacked ``gate_up_proj`` [E, H, 2F] (gate then up halves,
    no transpose), ``down_proj`` [E, F, H], the router [E, H] and the
    shared expert; gpt-oss's, whose ``gate_up_proj`` and its bias
    interleave gate (even columns) and up (odd), with biases on every
    expert matmul and a linear router whose bias stays f32; or, for
    mixtral and qwen3_moe, every expert's ``nn.Linear`` projections
    stacked into [L, E, ...] by :data:`_MOE_NAMES`."""
    dt, L, F_ = c.dtype, c.n_layers, c.intermediate_size

    def per_layer(fmt, transpose=False):  # [L, ...] of tensors already stacked over experts
        return torch.stack([get(fmt.format(i=i)).transpose(-1, -2) if transpose else get(fmt.format(i=i))
                            for i in range(L)])

    def cast(t, dtype=None):
        return t.to(dtype or dt).contiguous()

    P = "model.layers.{i}."
    if model_type in ("llama4", "llama4_text"):
        F = P + "feed_forward."
        gu = per_layer(F + "experts.gate_up_proj")  # [L, E, H, 2F]
        SE = F + "shared_expert."
        return {
            "w_gate": cast(gu[..., :F_]), "w_up": cast(gu[..., F_:]),
            "w_down": cast(per_layer(F + "experts.down_proj")),
            "w_router": cast(per_layer(F + "router.weight", transpose=True)),
            "w_shared_gate": stack(SE + "gate_proj.weight", transpose=True),
            "w_shared_up": stack(SE + "up_proj.weight", transpose=True),
            "w_shared_down": stack(SE + "down_proj.weight", transpose=True),
        }
    if model_type == "gpt_oss":
        M = P + "mlp."
        gu, gub = per_layer(M + "experts.gate_up_proj"), per_layer(M + "experts.gate_up_proj_bias")
        return {
            "w_gate": cast(gu[..., ::2]), "w_up": cast(gu[..., 1::2]),
            "b_gate": cast(gub[..., ::2]), "b_up_e": cast(gub[..., 1::2]),
            "w_down": cast(per_layer(M + "experts.down_proj")),
            "b_down_e": cast(per_layer(M + "experts.down_proj_bias")),
            "w_router": cast(per_layer(M + "router.weight", transpose=True)),
            "b_router": cast(per_layer(M + "router.bias"), torch.float32),
        }
    router, prefix, names = _MOE_NAMES.get(model_type, _MOE_NAMES["mixtral"])
    out = {"w_router": stack(P + router, transpose=True)}
    for ours, theirs in zip(("w_gate", "w_up", "w_down"), names):
        out[ours] = cast(torch.stack([
            torch.stack([get(f"model.layers.{i}.{prefix}.{e}.{theirs}.weight").t() for e in range(c.n_experts)])
            for i in range(L)]))
    return out


def _convert_deepseek(sd: dict, c: LlamaConfig) -> dict:
    """DeepSeek-V2/V3's state dict → params (the JAX
    ``_convert_deepseek``, convert_hf.py:761): the MLA projections and
    norms, the first ``first_k_dense`` layers' dense MLPs in
    ``dense_layers`` and the rest's routed experts (stacked [L, E, ...]),
    router, V3's f32 selection bias and the fused shared experts in
    ``layers``."""
    dt = c.dtype

    def get(name):
        if name not in sd:
            raise KeyError(f"missing weight {name!r} (have e.g. {sorted(sd)[:5]})")
        return sd[name]

    def stack(fmt, rows, transpose=False, dtype=None):
        return torch.stack([get(fmt.format(i=i)).t() if transpose else get(fmt.format(i=i)) for i in rows]
                           ).to(dtype or dt).contiguous()

    def attn_and_norms(rows):
        A = "model.layers.{i}.self_attn."
        d = {
            "attn_norm": stack("model.layers.{i}.input_layernorm.weight", rows),
            "mlp_norm": stack("model.layers.{i}.post_attention_layernorm.weight", rows),
            "wkv_a": stack(A + "kv_a_proj_with_mqa.weight", rows, transpose=True),
            "kv_a_norm": stack(A + "kv_a_layernorm.weight", rows),
            "wkv_b": stack(A + "kv_b_proj.weight", rows, transpose=True),
            "wo": stack(A + "o_proj.weight", rows, transpose=True),
        }
        if c.q_lora_rank:
            d["wq_a"] = stack(A + "q_a_proj.weight", rows, transpose=True)
            d["q_a_norm"] = stack(A + "q_a_layernorm.weight", rows)
            d["wq_b"] = stack(A + "q_b_proj.weight", rows, transpose=True)
        else:
            d["wq"] = stack(A + "q_proj.weight", rows, transpose=True)
        return d

    def dense_mlp(rows):
        return {ours: stack(f"model.layers.{{i}}.mlp.{theirs}.weight", rows, transpose=True)
                for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj"))}

    K = c.first_k_dense
    main_rows = list(range(K, c.n_layers))
    layers = attn_and_norms(main_rows)
    if c.n_experts:
        layers["w_router"] = stack("model.layers.{i}.mlp.gate.weight", main_rows, transpose=True)
        if c.router_bias:  # the selection bias stays f32 (HF's buffer dtype)
            layers["router_bias"] = stack("model.layers.{i}.mlp.gate.e_score_correction_bias", main_rows,
                                          dtype=torch.float32)
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            layers[ours] = torch.stack([
                torch.stack([get(f"model.layers.{i}.mlp.experts.{e}.{theirs}.weight").t()
                             for e in range(c.n_experts)])
                for i in main_rows]).to(dt).contiguous()
        if c.moe_shared_expert:
            S = "model.layers.{i}.mlp.shared_experts."
            layers["w_shared_gate"] = stack(S + "gate_proj.weight", main_rows, transpose=True)
            layers["w_shared_up"] = stack(S + "up_proj.weight", main_rows, transpose=True)
            layers["w_shared_down"] = stack(S + "down_proj.weight", main_rows, transpose=True)
    else:
        layers.update(dense_mlp(main_rows))
    params = {
        "embed": get("model.embed_tokens.weight").to(dt).contiguous(),
        "layers": layers,
        "final_norm": get("model.norm.weight").to(dt).contiguous(),
    }
    if K:
        rows = list(range(K))
        params["dense_layers"] = {**attn_and_norms(rows), **dense_mlp(rows)}
    if not c.tie_embeddings:
        params["lm_head"] = get("lm_head.weight").t().to(dt).contiguous()
    return params


# safetensors dtype tags → torch dtypes (the tags the format defines that
# torch has)
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def read_safetensors(path) -> dict:
    """Every tensor of one ``.safetensors`` file → {name: CPU tensor}. The
    format: an unsigned 64-bit little-endian header length N, N bytes of
    JSON ({name: {"dtype", "shape", "data_offsets": [begin, end]}} and an
    optional "__metadata__"), then the data, each tensor's bytes at its
    offsets from the data's start, little-endian and C-ordered."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data0 = 8 + n
        out = {}
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            if meta["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']}, which the port does not read")
            dtype, shape = _ST_DTYPES[meta["dtype"]], list(meta["shape"])
            begin, end = meta["data_offsets"]
            if end - begin != math.prod(shape) * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for shape {shape}")
            if end == begin:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            f.seek(data0 + begin)
            buf = bytearray(f.read(end - begin))
            out[name] = torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)
        return out


def _load_raw_state_dict(path: Path) -> dict:
    """Every weight shard of a ``save_pretrained`` directory."""
    safes = sorted(path.glob("*.safetensors"))
    if safes:
        sd = {}
        for f in safes:
            sd.update(read_safetensors(f))
        return sd
    bins = sorted(path.glob("pytorch_model*.bin"))
    if bins:
        sd = {}
        for f in bins:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
        return sd
    raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin in {path}")


def load_checkpoint(path, dtype: Any = torch.bfloat16, device="cpu") -> tuple[LlamaConfig, dict]:
    """Load an HF ``save_pretrained`` directory → (config, params), the
    params on ``device``."""
    p = Path(path)
    hf = json.loads((p / "config.json").read_text())
    config = config_from_hf(hf, dtype=dtype)
    params = convert_state_dict(_load_raw_state_dict(p), config, hf.get("model_type", "llama"))
    if torch.device(device).type != "cpu":
        params = {k: ({n: w.to(device) for n, w in v.items()} if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
    return config, params


# ---------------------------------------------------------------------------
# export: the port's parameter dict → an HF save_pretrained directory
# (dstack_tpu/models/convert_hf.py:954-1410)
# ---------------------------------------------------------------------------


def config_to_hf(config: LlamaConfig) -> dict:
    """:class:`LlamaConfig` → HF ``config.json`` dict, the inverse of
    :func:`config_from_hf` for the families HF can express (JAX's
    ``config_to_hf``, convert_hf.py:954-1209, with its gpt-oss and
    cohere2 refusals)."""
    from dstack_tpu_torch.models.llama import layer_nope, layer_windows

    c = config
    if c.attn_sinks or c.moe_bias or c.router_topk_softmax:
        # the generic MoE branch would tag this "mixtral" and drop the
        # sinks, the expert biases and the router's semantics
        raise ValueError(
            "gpt-oss configs (attention sinks / biased experts / "
            "topk-softmax router) cannot be exported as an HF "
            "checkpoint yet"
        )
    hf = {
        "hidden_act": "gelu_pytorch_tanh" if c.hidden_act == "gelu_tanh" else "silu",
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size,
        "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv_heads,
        "head_dim": c.head_dim,
        "intermediate_size": c.intermediate_size,
        "rope_theta": c.rope_theta,
        "rms_norm_eps": c.norm_eps,
        "max_position_embeddings": c.max_seq_len,
        "tie_word_embeddings": c.tie_embeddings,
        "torch_dtype": "bfloat16",
    }
    if c.rope_scaling is not None and c.rope_scaling[0] == "linear":
        hf["rope_scaling"] = {"rope_type": "linear", "factor": float(c.rope_scaling[1])}
    elif c.rope_scaling is not None and c.rope_scaling[0] == "yarn":
        _, factor, beta_fast, beta_slow, orig, att = c.rope_scaling[:6]
        hf["rope_scaling"] = {
            "rope_type": "yarn",
            "factor": factor,
            "beta_fast": beta_fast,
            "beta_slow": beta_slow,
            "original_max_position_embeddings": int(orig),
            "attention_factor": att,  # resolved; HF reads it directly
        }
        if len(c.rope_scaling) > 6:  # gpt-oss: truncate=false round trip
            hf["rope_scaling"]["truncate"] = bool(c.rope_scaling[6])
    elif c.rope_scaling is not None:
        rs = c.rope_scaling
        factor, low_f, high_f, orig = rs[1:] if rs[0] == "llama3" else rs
        hf["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": factor,
            "low_freq_factor": low_f,
            "high_freq_factor": high_f,
            "original_max_position_embeddings": int(orig),
        }
    if c.mla:
        v3 = c.router_score == "sigmoid"
        hf.update(
            model_type="deepseek_v3" if v3 else "deepseek_v2",
            head_dim=c.qk_rope_head_dim,  # HF's rope width for DeepSeek
            q_lora_rank=c.q_lora_rank or None,
            kv_lora_rank=c.kv_lora_rank,
            qk_nope_head_dim=c.qk_nope_head_dim,
            qk_rope_head_dim=c.qk_rope_head_dim,
            v_head_dim=c.v_head_dim,
        )
        if (v3 or _v2_mscale_fix()) and c.attn_scale is not None and "rope_scaling" in hf:
            # the mscale² softmax-scale correction back into mscale_all_dim,
            # so HF applies it again and the loader derives attn_scale again
            factor = hf["rope_scaling"]["factor"]
            ms = math.sqrt(c.attn_scale * c.qk_head_dim**0.5)
            hf["rope_scaling"]["mscale_all_dim"] = (ms - 1.0) / (0.1 * math.log(factor))
        if c.n_experts:
            shared = c.moe_shared_intermediate // c.intermediate_size if c.moe_shared_expert else None
            hf.update(
                n_routed_experts=c.n_experts,
                num_experts_per_tok=c.experts_per_token,
                moe_intermediate_size=c.intermediate_size,
                intermediate_size=c.dense_intermediate or c.intermediate_size,
                first_k_dense_replace=c.first_k_dense,
                moe_layer_freq=1,
                n_shared_experts=shared,
                norm_topk_prob=c.router_renorm,
                routed_scaling_factor=c.routed_scale,
            )
            if v3:
                hf.update(
                    n_group=c.router_groups[0] if c.router_groups else 1,
                    topk_group=c.router_groups[1] if c.router_groups else 1,
                )
            else:
                hf.update(
                    topk_method="group_limited_greedy" if c.router_groups else "greedy",
                    n_group=c.router_groups[0] if c.router_groups else None,
                    topk_group=c.router_groups[1] if c.router_groups else None,
                )
        else:  # all-dense MLA: no layer reaches the MoE branch
            hf.update(first_k_dense_replace=c.n_layers, n_routed_experts=None)
        return hf
    if not c.pre_norm:
        hf.update(model_type="olmo2")
        return hf
    if c.embed_multiplier or c.residual_multiplier:
        hf.update(
            model_type="granite",
            embedding_multiplier=c.embed_multiplier or 1.0,
            residual_multiplier=c.residual_multiplier or 1.0,
            # None means 1/sqrt(head_dim): the real value keeps the softmax
            # scale through a save and a load
            attention_multiplier=c.attn_scale if c.attn_scale is not None else c.qk_head_dim**-0.5,
            logits_scaling=(1.0 / c.logit_scale) if c.logit_scale else 1.0,
        )
        return hf
    if c.parallel_block:
        if c.sliding_window:
            if c.qk_norm or c.nope_pattern != c.sliding_pattern:
                raise ValueError(
                    "cohere2 export requires nope_pattern == "
                    "sliding_pattern and no qk_norm (the HF config "
                    "cannot express other layouts)"
                )
            hf.update(
                model_type="cohere2",
                layer_norm_eps=c.norm_eps,
                logit_scale=c.logit_scale,
                sliding_window=c.sliding_window,
                sliding_window_pattern=c.sliding_pattern,
                layer_types=["sliding_attention" if w else "full_attention" for w in layer_windows(c)],
            )
        else:
            hf.update(model_type="cohere", layer_norm_eps=c.norm_eps, logit_scale=c.logit_scale,
                      use_qk_norm=c.qk_norm)
        return hf
    if c.norm_type == "layernorm_bias":
        hf.update(model_type="starcoder2", norm_epsilon=c.norm_eps, use_bias=c.proj_bias,
                  sliding_window=c.sliding_window or None)
        return hf
    if c.norm_type == "layernorm1p":
        hf.update(model_type="nemotron", norm_eps=c.norm_eps, partial_rotary_factor=c.partial_rotary)
        hf["hidden_act"] = "relu2"
        return hf
    if c.partial_rotary != 1.0:
        hf.update(model_type="glm4" if c.post_norms else "glm", attention_bias=c.qkv_bias,
                  partial_rotary_factor=c.partial_rotary)
        return hf
    if c.rope_interleaved:
        hf.update(
            model_type="llama4_text",
            no_rope_layers=[0 if n else 1 for n in layer_nope(c)],
            attention_chunk_size=c.attention_chunk_size or None,
            use_qk_norm=c.qk_l2_norm,
            attn_temperature_tuning=bool(c.attn_temp_scale),
            attn_scale=c.attn_temp_scale or 0.1,
            floor_scale=c.attn_temp_floor,
            num_local_experts=c.n_experts,
            num_experts_per_tok=c.experts_per_token,
            interleave_moe_layer_step=1,
            intermediate_size_mlp=c.intermediate_size,
        )
    elif c.n_experts and c.qk_norm:
        hf.update(
            model_type="qwen3_moe",
            num_experts=c.n_experts,
            num_experts_per_tok=c.experts_per_token,
            moe_intermediate_size=c.intermediate_size,
            norm_topk_prob=c.router_renorm,
            attention_bias=c.qkv_bias,
        )
    elif c.n_experts:
        hf.update(model_type="mixtral", num_local_experts=c.n_experts, num_experts_per_tok=c.experts_per_token)
    elif c.rope_local_theta:
        hf.update(
            model_type="gemma3_text",
            sliding_window=c.sliding_window or None,
            sliding_window_pattern=c.sliding_pattern or None,
            layer_types=["sliding_attention" if w else "full_attention" for w in layer_windows(c)],
            rope_local_base_freq=c.rope_local_theta,
            query_pre_attn_scalar=round(c.attn_scale**-2) if c.attn_scale else c.head_dim,
        )
    elif c.post_norms:
        hf.update(
            model_type="gemma2",
            sliding_window=c.sliding_window or None,
            attn_logit_softcapping=c.attn_softcap or None,
            final_logit_softcapping=c.logit_softcap or None,
            query_pre_attn_scalar=round(c.attn_scale**-2) if c.attn_scale else c.head_dim,
        )
    elif c.norm_offset:
        hf.update(model_type="gemma")
    elif c.qk_norm:
        hf.update(model_type="qwen3", attention_bias=c.qkv_bias)
    elif c.qkv_bias:
        hf.update(model_type="qwen2")
        if c.sliding_window:
            hf.update(use_sliding_window=True, sliding_window=c.sliding_window, max_window_layers=0)
    elif c.sliding_window:
        hf.update(model_type="mistral", sliding_window=c.sliding_window)
    else:
        hf.update(model_type="llama")
    return hf


def export_state_dict(params: dict, config: LlamaConfig) -> dict:
    """The port's parameter dict → a flat HF state dict of CPU tensors in
    the leaves' own dtypes, the inverse of :func:`convert_state_dict` (JAX's
    ``export_state_dict``, convert_hf.py:1210-1323), so fine-tuned weights
    serve wherever HF checkpoints do. An int8 tree is refused."""
    from dstack_tpu_torch.models.quant import is_quantized

    if is_quantized(params):
        raise ValueError("export requires full-precision params, not int8")
    c = config
    mt = config_to_hf(c)["model_type"]
    if mt in ("deepseek_v2", "deepseek_v3"):
        return _export_deepseek(params, c)
    gemma2 = mt in ("gemma2", "gemma3_text", "glm4")

    def host(x):
        return x.detach().cpu()

    sd: dict = {"model.embed_tokens.weight": host(params["embed"])}
    L = params["layers"]
    for i in range(c.n_layers):
        P = f"model.layers.{i}."
        sd[P + "self_attn.q_proj.weight"] = host(L["wq"][i]).t()
        sd[P + "self_attn.k_proj.weight"] = host(L["wk"][i]).t()
        sd[P + "self_attn.v_proj.weight"] = host(L["wv"][i]).t()
        sd[P + "self_attn.o_proj.weight"] = host(L["wo"][i]).t()
        if c.pre_norm:
            sd[P + "input_layernorm.weight"] = host(L["attn_norm"][i])
            if not c.parallel_block:  # Cohere's one norm is attn_norm
                mlp_norm_name = "pre_feedforward_layernorm.weight" if gemma2 else "post_attention_layernorm.weight"
                sd[P + mlp_norm_name] = host(L["mlp_norm"][i])
        if c.qkv_bias:
            sd[P + "self_attn.q_proj.bias"] = host(L["bq"][i])
            sd[P + "self_attn.k_proj.bias"] = host(L["bk"][i])
            sd[P + "self_attn.v_proj.bias"] = host(L["bv"][i])
        if c.proj_bias:
            sd[P + "self_attn.o_proj.bias"] = host(L["bo"][i])
            sd[P + "mlp.up_proj.bias"] = host(L["b_up"][i])
            sd[P + "mlp.down_proj.bias"] = host(L["b_down"][i])
        if c.qk_norm or c.qk_norm_flat:
            sd[P + "self_attn.q_norm.weight"] = host(L["q_norm"][i])
            sd[P + "self_attn.k_norm.weight"] = host(L["k_norm"][i])
        if c.post_norms:
            sd[P + "post_attention_layernorm.weight"] = host(L["attn_post_norm"][i])
            sd[P + "post_feedforward_layernorm.weight"] = host(L["mlp_post_norm"][i])
        if c.n_experts and mt == "llama4_text":
            # the fused, pre-stacked layout (convert_state_dict)
            F_ = P + "feed_forward."
            sd[F_ + "router.weight"] = host(L["w_router"][i]).t()
            sd[F_ + "experts.gate_up_proj"] = torch.cat([host(L["w_gate"][i]), host(L["w_up"][i])], dim=-1)
            sd[F_ + "experts.down_proj"] = host(L["w_down"][i])
            SE = F_ + "shared_expert."
            sd[SE + "gate_proj.weight"] = host(L["w_shared_gate"][i]).t()
            sd[SE + "up_proj.weight"] = host(L["w_shared_up"][i]).t()
            sd[SE + "down_proj.weight"] = host(L["w_shared_down"][i]).t()
        elif c.n_experts:
            router, eprefix, (g, u, d) = _MOE_NAMES.get(mt, _MOE_NAMES["mixtral"])
            sd[P + router] = host(L["w_router"][i]).t()
            for e in range(c.n_experts):
                E = P + f"{eprefix}.{e}."
                sd[E + f"{g}.weight"] = host(L["w_gate"][i][e]).t()
                sd[E + f"{u}.weight"] = host(L["w_up"][i][e]).t()
                sd[E + f"{d}.weight"] = host(L["w_down"][i][e]).t()
        else:
            if not c.mlp_gateless:
                sd[P + "mlp.gate_proj.weight"] = host(L["w_gate"][i]).t()
            sd[P + "mlp.up_proj.weight"] = host(L["w_up"][i]).t()
            sd[P + "mlp.down_proj.weight"] = host(L["w_down"][i]).t()
    sd["model.norm.weight"] = host(params["final_norm"])
    if c.norm_type in ("layernorm1p", "layernorm_bias"):
        # the stacked (scale, bias) rows back into HF's two names
        stacked = [n for n in sd if n.endswith("layernorm.weight")]
        for n in stacked + ["model.norm.weight"]:
            wb = sd.pop(n)
            sd[n] = wb[0]
            sd[n[: -len(".weight")] + ".bias"] = wb[1]
    if c.norm_type == "layernorm_bias":
        # back to StarCoder2's c_fc/c_proj MLP names
        for i in range(c.n_layers):
            P = f"model.layers.{i}.mlp."
            for suff in ("weight", "bias"):
                if P + f"up_proj.{suff}" in sd:
                    sd[P + f"c_fc.{suff}"] = sd.pop(P + f"up_proj.{suff}")
                if P + f"down_proj.{suff}" in sd:
                    sd[P + f"c_proj.{suff}"] = sd.pop(P + f"down_proj.{suff}")
    if not c.tie_embeddings:
        sd["lm_head.weight"] = host(params["lm_head"]).t()
    if mt in ("glm", "glm4"):
        # the inverse of _split_glm: gate and up fused again, glm4's norm names
        for i in range(c.n_layers):
            P = f"model.layers.{i}."
            sd[P + "mlp.gate_up_proj.weight"] = torch.cat(
                [sd.pop(P + "mlp.gate_proj.weight"), sd.pop(P + "mlp.up_proj.weight")], dim=0
            )
            if mt == "glm4":
                attn_post = sd.pop(P + "post_attention_layernorm.weight")
                pre_mlp = sd.pop(P + "pre_feedforward_layernorm.weight")
                mlp_post = sd.pop(P + "post_feedforward_layernorm.weight")
                sd[P + "post_self_attn_layernorm.weight"] = attn_post
                sd[P + "post_attention_layernorm.weight"] = pre_mlp
                sd[P + "post_mlp_layernorm.weight"] = mlp_post
    return sd


def _export_deepseek(params: dict, c: LlamaConfig) -> dict:
    """The inverse of :func:`_convert_deepseek` (JAX's ``_export_deepseek``,
    convert_hf.py:1324-1383): flat HF names, CPU tensors."""

    def host(x):
        return x.detach().cpu()

    sd: dict = {"model.embed_tokens.weight": host(params["embed"])}

    def put_layer(row: dict, i: int, moe: bool) -> None:
        P = f"model.layers.{i}."
        A = P + "self_attn."
        sd[P + "input_layernorm.weight"] = host(row["attn_norm"])
        sd[P + "post_attention_layernorm.weight"] = host(row["mlp_norm"])
        sd[A + "kv_a_proj_with_mqa.weight"] = host(row["wkv_a"]).t()
        sd[A + "kv_a_layernorm.weight"] = host(row["kv_a_norm"])
        sd[A + "kv_b_proj.weight"] = host(row["wkv_b"]).t()
        sd[A + "o_proj.weight"] = host(row["wo"]).t()
        if c.q_lora_rank:
            sd[A + "q_a_proj.weight"] = host(row["wq_a"]).t()
            sd[A + "q_a_layernorm.weight"] = host(row["q_a_norm"])
            sd[A + "q_b_proj.weight"] = host(row["wq_b"]).t()
        else:
            sd[A + "q_proj.weight"] = host(row["wq"]).t()
        if moe:
            sd[P + "mlp.gate.weight"] = host(row["w_router"]).t()
            if c.router_bias:
                sd[P + "mlp.gate.e_score_correction_bias"] = host(row["router_bias"])
            for e in range(c.n_experts):
                E = P + f"mlp.experts.{e}."
                sd[E + "gate_proj.weight"] = host(row["w_gate"][e]).t()
                sd[E + "up_proj.weight"] = host(row["w_up"][e]).t()
                sd[E + "down_proj.weight"] = host(row["w_down"][e]).t()
            if c.moe_shared_expert:
                S = P + "mlp.shared_experts."
                sd[S + "gate_proj.weight"] = host(row["w_shared_gate"]).t()
                sd[S + "up_proj.weight"] = host(row["w_shared_up"]).t()
                sd[S + "down_proj.weight"] = host(row["w_shared_down"]).t()
        else:
            sd[P + "mlp.gate_proj.weight"] = host(row["w_gate"]).t()
            sd[P + "mlp.up_proj.weight"] = host(row["w_up"]).t()
            sd[P + "mlp.down_proj.weight"] = host(row["w_down"]).t()

    K = c.first_k_dense
    for j in range(K):
        put_layer({n: w[j] for n, w in params["dense_layers"].items()}, j, False)
    for j in range(c.n_layers - K):
        put_layer({n: w[j] for n, w in params["layers"].items()}, K + j, bool(c.n_experts))
    sd["model.norm.weight"] = host(params["final_norm"])
    if not c.tie_embeddings:
        sd["lm_head.weight"] = host(params["lm_head"]).t()
    return sd


def write_safetensors(tensors: dict, path, metadata: Optional[dict] = None) -> None:
    """Write ``{name: tensor}`` as one ``.safetensors`` file, the format
    :func:`read_safetensors` reads: the header's JSON padded with spaces to
    a multiple of 8 bytes, then each tensor's C-ordered little-endian bytes
    back to back, in name order. The port needs no ``safetensors``
    package."""
    inv = {dtype: tag for tag, dtype in _ST_DTYPES.items()}
    names = sorted(tensors)
    header: dict = {"__metadata__": metadata} if metadata else {}
    offset = 0
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": inv[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().cpu().contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def save_checkpoint(config: LlamaConfig, params: dict, path) -> None:
    """Write an HF ``save_pretrained``-compatible directory: ``config.json``
    and a bf16 ``model.safetensors`` (JAX's ``save_checkpoint``,
    convert_hf.py:1384-1410; every tensor in bf16, as there)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    (p / "config.json").write_text(json.dumps(config_to_hf(config), indent=2))
    sd = export_state_dict(params, config)
    write_safetensors({k: v.to(torch.bfloat16) for k, v in sd.items()}, p / "model.safetensors",
                      metadata={"format": "pt"})
