"""HuggingFace checkpoint → the port's parameter dict (counterpart of
dstack_tpu.models.convert_hf).

Point :func:`load_checkpoint` at a ``save_pretrained`` directory
(safetensors or ``pytorch_model*.bin`` shards) and get back
``(LlamaConfig, params)`` for the serving engine: the same keys and
stacked ``[L, ...]`` layout as :func:`~dstack_tpu_torch.models.llama.
init_params`, so every leaf is one tensor.

Model types: ``llama``, ``gemma``, ``gemma2`` and ``gemma3`` /
``gemma3_text`` (a multimodal Gemma3 checkpoint loads its text tower).
Every other type raises ``ValueError`` naming the ROADMAP item that
brings it (A3: the other families' branches, and export). Each maps onto
the config's family flags, as the JAX converter maps them
(convert_hf.py:55-260): Gemma's (1 + w) norms, embedding scale and tanh
GELU; Gemma2's sandwich norms, softcaps and alternating windows; Gemma3's
q/k norms, periodic windows and dual rope.

Safetensors are read by :func:`read_safetensors`, a parser of the file
format (an 8-byte little-endian header length, a JSON header, then the
raw little-endian bytes of each tensor), so the port needs no
``safetensors`` package; ``.bin`` shards go through
``torch.load(weights_only=True)``, as JAX reads them.

Layout: an HF ``*_proj.weight`` is ``[out, in]`` (``nn.Linear``), the
port's projections ``[in, out]``: transposed on load. HF llama-family
checkpoints already use the rotate-half rope convention.
"""

import json
import math
from pathlib import Path
from typing import Any, Optional

import torch

from dstack_tpu_torch.models.llama import LlamaConfig

__all__ = ["config_from_hf", "convert_state_dict", "load_checkpoint", "read_safetensors"]

SUPPORTED = ("llama", "gemma", "gemma2", "gemma3", "gemma3_text")
GEMMA = ("gemma", "gemma2", "gemma3", "gemma3_text")


def _unsupported(model_type: str) -> ValueError:
    return ValueError(
        f"HF model_type {model_type!r} is not loaded by the port yet: it loads "
        f"{', '.join(SUPPORTED)}; the other families' branches come with ROADMAP A3"
    )


def config_from_hf(hf: dict, dtype: Any = torch.bfloat16) -> LlamaConfig:
    """HF ``config.json`` dict → :class:`LlamaConfig` (the llama, gemma,
    gemma2 and gemma3 branches of the JAX ``config_from_hf``)."""
    mt = hf.get("model_type", "llama")
    if mt == "gemma3" and "text_config" in hf:
        # multimodal wrapper: the text tower's config is nested (the vision
        # tower is out of scope; convert_state_dict drops its weights)
        hf = {**hf["text_config"], "model_type": "gemma3_text"}
        mt = "gemma3_text"
    if mt not in SUPPORTED:
        raise _unsupported(mt)
    if hf.get("attention_bias"):
        # q/k/v/o biases in the checkpoint that these families never read
        raise ValueError(f"{mt} checkpoint sets attention_bias=true, which the port does not load")
    hidden = hf["hidden_size"]
    n_heads = hf["num_attention_heads"]
    act = hf.get("hidden_act") or "silu"
    if mt in GEMMA:
        # Gemma configs say "gelu" or hidden_activation, but the models
        # always use the tanh approximation
        act = "gelu_tanh"
    elif act != "silu":
        raise ValueError(f"unsupported hidden_act {act!r} for {mt}")
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
    """HF ``rope_scaling`` → the config's tuple: "llama3" (Llama-3.1/3.2)
    or "linear" (Gemma3's global layers). Any other type is an error:
    loading without it would generate silently degraded text (yarn comes
    with the families that use it, ROADMAP A3)."""
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
    raise ValueError(f"unsupported rope_scaling type {rope_type!r}")


def convert_state_dict(sd: dict, config: LlamaConfig, model_type: str = "llama") -> dict:
    """Flat HF state dict (name → tensor) → the port's params: stacked
    ``[L, ...]`` layers in ``config.dtype``, on the CPU (the caller moves
    them to the card). The llama and Gemma branches of the JAX
    ``convert_state_dict`` (convert_hf.py:581-760)."""
    c, dt = config, config.dtype
    if model_type not in SUPPORTED:
        raise _unsupported(model_type)
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
    # Gemma2/3 norm the attention output with post_attention_layernorm and
    # name the pre-MLP norm pre_feedforward_layernorm; elsewhere
    # post_attention_layernorm is the pre-MLP norm
    sandwich = model_type in ("gemma2", "gemma3", "gemma3_text")
    layers = {
        "wq": stack(P + "self_attn.q_proj.weight", transpose=True),
        "wk": stack(P + "self_attn.k_proj.weight", transpose=True),
        "wv": stack(P + "self_attn.v_proj.weight", transpose=True),
        "wo": stack(P + "self_attn.o_proj.weight", transpose=True),
        "attn_norm": stack(P + "input_layernorm.weight"),
        "mlp_norm": stack(P + ("pre_feedforward_layernorm.weight" if sandwich
                               else "post_attention_layernorm.weight")),
        "w_gate": stack(P + "mlp.gate_proj.weight", transpose=True),
        "w_up": stack(P + "mlp.up_proj.weight", transpose=True),
        "w_down": stack(P + "mlp.down_proj.weight", transpose=True),
    }
    if c.qk_norm:
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
