"""Dense Llama for the PyTorch port (counterpart of dstack_tpu.models.llama).

Parameters are a plain dict of tensors in the JAX package's layout:
layers stacked on a leading ``[L, ...]`` dim (``param_specs`` at
dstack_tpu/models/llama.py:548), so one JAX leaf maps to exactly one
tensor and :func:`params_from_jax` is a key-for-key copy. The serving
engine loops over layers in Python where JAX runs ``lax.scan``.

Only the dense Llama path is here: the JAX config's model-family deltas
(MoE, MLA, sliding windows, softcaps, qk norms, ...) arrive with the
serving-breadth slice, so the port's config has no fields for them.

:func:`forward` is the whole-sequence forward the trainer differentiates
(counterpart of ``forward``, dstack_tpu/models/llama.py:1431): attention
through ``FlashAttention`` (K1 forward, K2/K3 backward on the card), the
LoRA bypass in every projection, and, with ``config.remat``, one
``torch.utils.checkpoint`` per layer. JAX saves the flash residuals
across its remat boundary (llama.py:1494-1504); the port recomputes
them, so under remat K1 runs twice per layer and step.
"""

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads "
                f"{self.n_kv_heads}"
            )

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rope_dim(self) -> int:
        return self.head_dim

    @property
    def attention_scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None else self.head_dim**-0.5

    def num_params(self) -> int:
        """Parameter count of the dense model (the JAX ``num_params`` with
        every family delta off)."""
        e, h = self.vocab_size * self.hidden_size, self.hidden_size
        attn = 2 * h * self.q_dim + 2 * h * self.kv_dim
        per_layer = attn + 2 * h + 3 * h * self.intermediate_size
        return e + self.n_layers * per_layer + h + (0 if self.tie_embeddings else e)


LLAMA_3_8B = LlamaConfig()
LLAMA_32_1B = LlamaConfig(
    hidden_size=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
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

CONFIGS = {
    "llama-3-8b": LLAMA_3_8B,
    "llama-3.2-1b": LLAMA_32_1B,
    "llama-tiny": LLAMA_TINY,
    "llama-tiny-64": LLAMA_TINY_64,
}


def param_shapes(config: LlamaConfig) -> dict:
    """Shape tree of the dense parameters, matching the JAX package's
    ``init_params`` output key for key (stacked ``[L, ...]`` layers)."""
    c = config
    L, E, F_ = c.n_layers, c.hidden_size, c.intermediate_size
    shapes = {
        "embed": (c.vocab_size, E),
        "layers": {
            "wq": (L, E, c.q_dim),
            "wk": (L, E, c.kv_dim),
            "wv": (L, E, c.kv_dim),
            "wo": (L, c.q_dim, E),
            "w_gate": (L, E, F_),
            "w_up": (L, E, F_),
            "w_down": (L, F_, E),
            "attn_norm": (L, E),
            "mlp_norm": (L, E),
        },
        "final_norm": (E,),
    }
    if not c.tie_embeddings:
        shapes["lm_head"] = (E, c.vocab_size)
    return shapes


def init_params(
    config: LlamaConfig, generator: torch.Generator, device="cuda"
) -> dict:
    """Random dense parameters with the JAX ``init_params`` shapes and
    distributions: N(0, 0.02) projections (``wo``/``w_down`` scaled by
    1/sqrt(2L)), unit norms. Drawn in f32 from ``generator`` (which must
    live on ``device``) and cast to the config dtype; the streams differ
    from JAX's, so parity tests carry weights across with
    :func:`params_from_jax` instead."""
    c = config
    std = 0.02
    down = std / math.sqrt(2 * c.n_layers)
    scales = {"wo": down, "w_down": down}
    shapes = param_shapes(c)

    def normal(shape, scale=std):
        x = torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )
        return (x * scale).to(c.dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    layers = {
        name: ones(s) if name.endswith("norm") else normal(s, scales.get(name, std))
        for name, s in shapes["layers"].items()
    }
    params = {
        "embed": normal(shapes["embed"]),
        "layers": layers,
        "final_norm": ones(shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = normal(shapes["lm_head"])
    return params


def params_from_jax(
    tree: dict, config: LlamaConfig, device="cuda", dtype=None
) -> dict:
    """Carry a JAX parameter tree (its leaves as numpy arrays) across:
    same keys, same stacked layout, one tensor per leaf. Raises on a
    missing, extra or misshapen leaf rather than guessing."""
    dtype = dtype or config.dtype
    shapes = param_shapes(config)

    def convert(sub_tree, sub_shapes, path):
        if set(sub_tree) != set(sub_shapes):
            raise ValueError(
                f"params{path}: keys {sorted(sub_tree)} != dense Llama "
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
                device=device, dtype=dtype
            )
        return out

    return convert(tree, shapes, "")


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked ``[L, ...]`` leaves."""
    return {name: w[i] for name, w in params["layers"].items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in f32, cast back, then scaled in x's dtype
    (dstack_tpu/models/llama.py:821)."""
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def model_norm(x: torch.Tensor, w: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """The model's norm flavor; dense Llama's is RMSNorm."""
    return rms_norm(x, w, config.norm_eps)


def act_fn(config: LlamaConfig):
    """Dense Llama's MLP activation: SiLU (the gated SwiGLU form)."""
    return F.silu


def rope_freqs(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [T] → (cos, sin) each [T, head_dim//2], f32, with the
    "llama3" / "linear" rescalings of the JAX ``rope_freqs``."""
    dev = positions.device
    inv = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    if scaling is not None and scaling[0] == "linear":
        inv = inv / float(scaling[1])
    elif scaling is not None and scaling[0] == "yarn":
        raise NotImplementedError("yarn rope scaling comes with the families slice")
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
    """→ ((cos, sin), (cos_local, sin_local)); dense Llama has one rope,
    so both pairs are the same tensors."""
    g = rope_freqs(positions, config.rope_dim, config.rope_theta, config.rope_scaling)
    return g, g


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, D]; cos/sin [T, D/2]: rotate-half convention, with
    cos/sin cast to x's dtype before the multiply (as JAX does)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, None].to(x.dtype)
    s = sin[None, None].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _proj(layer: dict, name: str, inp: torch.Tensor) -> torch.Tensor:
    """Base projection plus the LoRA bypass ``x·W + s·(x·A)·B`` when the
    layer carries ``{name}_lora_a``/``_lora_b`` (dstack_tpu/models/
    llama.py:1105-1126; the int8 weights are not ported yet). Plain large
    products, so they stay ``torch.matmul`` as JAX leaves them to XLA."""
    y = torch.matmul(inp, layer[name])
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
    ``lm_head``, in the model dtype."""
    head = params["embed"].t() if config.tie_embeddings else params["lm_head"]
    return head.to(config.dtype)


def head_matmul(params: dict, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Output head over the tied embedding or ``lm_head`` → f32 logits
    (counterpart of ``head_logits_einsum`` with
    ``preferred_element_type=f32``): x [..., E] → [..., V]."""
    return matmul_f32(x, lm_head_weight(params, config))


def embed_tokens(params: dict, tokens: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Embedding rows in the model dtype; an id out of range gives zeros
    (JAX ``.at[tokens].get(mode="fill", fill_value=0)``)."""
    emb = params["embed"]
    valid = (tokens >= 0) & (tokens < emb.shape[0])
    x = emb[torch.where(valid, tokens, torch.zeros_like(tokens)).long()]
    return torch.where(valid[..., None], x, torch.zeros_like(x)).to(config.dtype)


# ---------------------------------------------------------------------------
# whole-sequence forward (training, scoring)
# ---------------------------------------------------------------------------


def _attention_block(
    x: torch.Tensor, layer: dict, c: LlamaConfig, cos, sin, impl: Optional[str]
) -> torch.Tensor:
    """Dense attention sublayer (``_attention_block``, llama.py:1177):
    pre-norm, q/k/v projections, rope, causal attention, ``wo``."""
    b, t, _ = x.shape
    h = model_norm(x, layer["attn_norm"], c)
    q = _proj(layer, "wq", h).view(b, t, c.n_heads, c.head_dim).transpose(1, 2)
    k = _proj(layer, "wk", h).view(b, t, c.n_kv_heads, c.head_dim).transpose(1, 2)
    v = _proj(layer, "wv", h).view(b, t, c.n_kv_heads, c.head_dim).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attention(q, k, v, causal=True, scale=c.attention_scale, impl=impl)
    o = o.transpose(1, 2).reshape(b, t, c.q_dim)
    return _proj(layer, "wo", o)


def _mlp_block(x: torch.Tensor, layer: dict, c: LlamaConfig) -> torch.Tensor:
    """Dense SwiGLU sublayer (``_mlp_block``, llama.py:1281)."""
    h = model_norm(x, layer["mlp_norm"], c)
    u = _proj(layer, "w_up", h)
    g = _proj(layer, "w_gate", h)
    return _proj(layer, "w_down", act_fn(c)(g) * u)


def _layer(x, layer, c, cos, sin, impl):
    x = x + _attention_block(x, layer, c, cos, sin, impl)
    return x + _mlp_block(x, layer, c)


def forward(
    params: dict,
    tokens: torch.Tensor,  # [B, T] int
    config: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    return_hidden: bool = False,
    impl: Optional[str] = None,  # attention: None = by device | "plain"
) -> torch.Tensor:
    """Token ids → f32 logits [B, T, V], or with ``return_hidden`` the
    final normed hidden states [B, T, E] in the model dtype (the trainer
    fuses the head into its loss).

    ``lora`` is an adapter tree from ``train/lora.py`` (stacked per-layer
    factors beside the base weights). The stacked ``[L, ...]`` leaves are
    unbound once, so each leaf's gradient is stacked once in the
    backward instead of being scattered into a zero ``[L, ...]`` tensor
    per layer. With ``config.remat`` (and autograd on) every layer runs
    under ``torch.utils.checkpoint``: its activations, flash output and
    logsumexp included, are recomputed in the backward."""
    c = config
    x = embed_tokens(params, tokens, c)
    pos = positions if positions is not None else torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_freqs(pos, c.rope_dim, c.rope_theta, c.rope_scaling)
    leaves = {**params["layers"], **(lora["layers"] if lora is not None else {})}
    per_layer = {name: w.unbind(0) for name, w in leaves.items()}
    remat = c.remat and torch.is_grad_enabled()
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        if lora is not None:
            layer["lora_scale"] = lora_scale
        if remat:
            x = checkpoint(_layer, x, layer, c, cos, sin, impl, use_reentrant=False)
        else:
            x = _layer(x, layer, c, cos, sin, impl)
    x = model_norm(x, params["final_norm"], c)  # _lm_head (llama.py:1376)
    return x if return_hidden else head_matmul(params, x, c)
