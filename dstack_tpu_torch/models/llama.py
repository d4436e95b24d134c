"""Dense Llama for the PyTorch port (counterpart of dstack_tpu.models.llama).

Parameters are a plain dict of tensors in the JAX package's layout:
layers stacked on a leading ``[L, ...]`` dim (``param_specs`` at
dstack_tpu/models/llama.py:548), so one JAX leaf maps to exactly one
tensor and :func:`params_from_jax` is a key-for-key copy. The serving
engine loops over layers in Python where JAX runs ``lax.scan``.

Only the dense Llama path is here: the JAX config's model-family deltas
(MoE, MLA, sliding windows, softcaps, qk norms, ...) arrive with the
serving-breadth slice, so the port's config has no fields for them.
"""

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


LLAMA_3_8B = LlamaConfig()
LLAMA_32_1B = LlamaConfig(
    hidden_size=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
    intermediate_size=8192, tie_embeddings=True,
)
LLAMA_TINY = LlamaConfig(  # for tests
    vocab_size=512, hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, intermediate_size=256, max_seq_len=256, dtype=torch.float32,
)
LLAMA_TINY_64 = LlamaConfig(  # head_dim-64 tiny: kernel-eligible shapes
    vocab_size=512, hidden_size=128, n_layers=2, n_heads=2, n_kv_heads=1,
    head_dim=64, intermediate_size=256, max_seq_len=256, dtype=torch.float32,
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
    """Base projection matmul (the JAX ``_proj`` without LoRA or int8:
    neither is ported yet). A plain large product, so it stays
    ``torch.matmul`` as JAX leaves it to XLA."""
    return torch.matmul(inp, layer[name])


def head_matmul(params: dict, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Output head over the tied embedding or ``lm_head`` → f32 logits
    (counterpart of ``head_logits_einsum`` with
    ``preferred_element_type=f32``): x [..., E] → [..., V]."""
    head = params["embed"].t() if config.tie_embeddings else params["lm_head"]
    head = head.to(config.dtype)
    if x.device.type == "cpu" or x.dtype == torch.float32:
        # exact upcast of both operands: f32 products and sums
        return torch.matmul(x.float(), head.float())
    # bf16 operands, f32 accumulation written out in f32 (no bf16
    # rounding of the logits)
    flat = x.reshape(-1, x.shape[-1])
    out = torch.mm(flat, head, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], out.shape[-1])
