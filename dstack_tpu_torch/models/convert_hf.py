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
glm4's sandwich norms. The MoE types (``mixtral``, ``qwen3_moe``,
``gpt_oss``), ``cohere2`` and ``llama4``, and ``deepseek_v2``/``_v3``
raise ``ValueError`` naming the ROADMAP item that brings them (A3.2, A3.3,
A3.4); any other type raises as JAX's does.

Safetensors are read by :func:`read_safetensors`, a parser of the file
format (an 8-byte little-endian header length, a JSON header, then the
raw little-endian bytes of each tensor), so the port needs no
``safetensors`` package; ``.bin`` shards go through
``torch.load(weights_only=True)``, as JAX reads them.

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

__all__ = ["config_from_hf", "convert_state_dict", "load_checkpoint", "read_safetensors"]

SUPPORTED = ("llama", "gemma", "gemma2", "gemma3", "gemma3_text", "qwen2", "qwen3", "mistral",
             "phi3", "granite", "starcoder2", "nemotron", "cohere", "olmo2", "glm", "glm4")
# model types the JAX converter loads and the port not yet → the ROADMAP
# item that brings them
LATER = {
    "mixtral": "A3.2 (softmax-routed MoE)",
    "qwen3_moe": "A3.2 (softmax-routed MoE)",
    "gpt_oss": "A3.2 (softmax-routed MoE: gpt-oss's converter branch)",
    "cohere2": "A3.3 (with Llama4: its global layers are NoPE layers)",
    "llama4": "A3.3 (Llama4)",
    "llama4_text": "A3.3 (Llama4)",
    "deepseek_v2": "A3.4 (DeepSeek's converter branches)",
    "deepseek_v3": "A3.4 (DeepSeek's converter branches)",
}
GEMMA = ("gemma", "gemma2", "gemma3", "gemma3_text")
REQUIRED = ("hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size", "intermediate_size")
# HF hidden_act → the config's activation (Gemma's is always the tanh GELU)
ACTS = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh", "relu2": "relu2"}


def _check_model_type(model_type: str) -> None:
    """Raise for a model type the port does not load: one of :data:`LATER`
    names its ROADMAP item, any other is refused as JAX refuses it."""
    if model_type in LATER:
        raise ValueError(f"HF model_type {model_type!r} is not loaded by the port yet: it comes "
                         f"with ROADMAP {LATER[model_type]}")
    if model_type not in SUPPORTED:
        raise ValueError(f"unsupported HF model_type {model_type!r}")


def config_from_hf(hf: dict, dtype: Any = torch.bfloat16) -> LlamaConfig:
    """HF ``config.json`` dict → :class:`LlamaConfig` (the JAX
    ``config_from_hf``'s branches for the model types in
    :data:`SUPPORTED`, their refusals included)."""
    mt = hf.get("model_type", "llama")
    if mt == "gemma3" and "text_config" in hf:
        # multimodal wrapper: the text tower's config is nested (the vision
        # tower is out of scope; convert_state_dict drops its weights)
        hf = {**hf["text_config"], "model_type": "gemma3_text"}
        mt = "gemma3_text"
    _check_model_type(mt)
    if hf.get("attention_bias") and mt not in ("qwen2", "qwen3", "glm", "glm4"):
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
    ``convert_state_dict`` (convert_hf.py:581-760): the fused projections
    split (phi3, glm), the LayerNorms with biases stacked (nemotron,
    starcoder2, whose ``c_fc``/``c_proj`` take the unified names), then
    one path for every type."""
    c, dt = config, config.dtype
    _check_model_type(model_type)
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
    if model_type == "gemma3":
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
    if not c.mlp_gateless:
        layers["w_gate"] = stack(P + "mlp.gate_proj.weight", transpose=True)
    layers["w_up"] = stack(P + "mlp.up_proj.weight", transpose=True)
    layers["w_down"] = stack(P + "mlp.down_proj.weight", transpose=True)
    if c.qkv_bias:
        for n in "qkv":
            layers[f"b{n}"] = stack(P + f"self_attn.{n}_proj.bias")
    if c.proj_bias:  # StarCoder2: the o projection's and the MLP's biases
        layers["bo"] = stack(P + "self_attn.o_proj.bias")
        layers["b_up"] = stack(P + "mlp.up_proj.bias")
        layers["b_down"] = stack(P + "mlp.down_proj.bias")
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
