"""Weight-only int8 quantization for serving (counterpart of
dstack_tpu.models.quant).

Decode reads every weight once a token, so storing the projections (the
attention, dense, expert and shared-expert FFN stacks of
:data:`LAYER_TARGETS`, and an untied head) as int8 with per-output-channel
scales halves the bytes a step reads. Per-output-channel absmax scaling
is exact under the contraction: for W[:, o] quantized as q[:, o] s[o],
x·W ≈ (x·q) s column-wise, so the scale multiplies the output. No input
statistics, no calibration data.

:func:`quantize_tree` rewrites a parameter dict: every target leaf
``name`` becomes ``name_q`` (int8, same shape) and ``name_s`` (f32, one
scale an output channel). ``models/llama.py``'s ``_proj`` and
``_head_logits`` and ``models/moe.py``'s expert products take either
form; on the card every int8 product goes through W8
(``ops/w8_matmul.py``), which reads the int8 bytes once. Norms, biases,
routers and the embedding stay in the model dtype. MLA models keep their
latent attention projections in full precision (:func:`quant_targets`).

Quantization runs on the host, as JAX's does (quant.py:48-56): with
``--quantize`` the server builds or loads its tree on the CPU and moves
only the int8 tree to the card. :func:`random_quantized_params_on_device`
draws a benchmark's int8 tree straight into int8 tensors on the card, so
a tree larger than the card in bf16 (llama-3-70b) never meets a bf16
copy. ``quant_param_specs`` only shards a tree over a mesh and comes
with the parallel slice (ROADMAP A6).
"""

import numpy as np
import torch

from dstack_tpu_torch.models.llama import LlamaConfig, _leaf_dtype, param_shapes

# projection leaves quantized inside each layer ([L, in, out] stacks; the
# expert stacks [L, E, in, out] and the shared experts take the same
# rank-generic per-output-channel quantization)
LAYER_TARGETS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "w_shared_gate", "w_shared_up", "w_shared_down",
)


def quantize_weight(w) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] → (int8 [..., in, out], f32 scale [..., out]) on the
    CPU: per-output-channel absmax, ``s = absmax / 127`` (1.0 for a zero
    column), ``q = clip(round(w / s), -127, 127)`` in f32. ``torch.round``
    rounds half to even as ``np.round`` does, so both are JAX's bit for
    bit. A stack of rank > 2 is quantized one leading index at a time (the
    same result: every column is its own), so the f32 transient is one
    matrix's."""
    w = torch.as_tensor(w).detach()
    if w.dim() > 2:
        parts = [quantize_weight(w[i]) for i in range(w.shape[0])]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    w32 = w.to(device="cpu", dtype=torch.float32)
    absmax = w32.abs().amax(dim=-2)  # [out]
    s = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(w32 / s[None, :]), -127, 127).to(torch.int8)
    return q, s


def dequantize_weight(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """q times its scales in f32, rounded once to ``dtype``."""
    return (q.float() * s.float()[..., None, :]).to(dtype)


def quant_targets(config: LlamaConfig) -> tuple:
    """The projection leaves int8 covers for this config. MLA models
    (DeepSeek) keep their latent attention projections (``wq_a``,
    ``wq_b``, ``wkv_a``, ``wkv_b``, and ``wq``) in full precision: raw
    products and the absorbed steps' reshape read them, and the latent
    path is already the compression. ``wo`` and the FFN and expert stacks,
    nearly all of a DeepSeek checkpoint's bytes, are quantized."""
    if config.mla:
        return tuple(t for t in LAYER_TARGETS if t not in ("wq", "wk", "wv"))
    return LAYER_TARGETS


def _quantize_stack(stack: dict, targets: tuple) -> dict:
    out = {}
    for name, leaf in stack.items():
        if name in targets:
            out[name + "_q"], out[name + "_s"] = quantize_weight(leaf)
        else:
            out[name] = leaf
    return out


def quantize_tree(params: dict, config: LlamaConfig) -> dict:
    """Parameter dict → serving dict with int8 projection weights (on the
    CPU): the per-layer projections, DeepSeek's ``dense_layers`` prelude
    alike, and the head when untied (``lm_head_q``, ``lm_head_s``); the
    embedding, norms, biases, routers and LoRA adapters pass through as
    they are."""
    targets = quant_targets(config)
    out = {k: v for k, v in params.items() if k not in ("layers", "dense_layers", "lm_head")}
    out["layers"] = _quantize_stack(params["layers"], targets)
    if "dense_layers" in params:
        out["dense_layers"] = _quantize_stack(params["dense_layers"], targets)
    if "lm_head" in params:
        out["lm_head_q"], out["lm_head_s"] = quantize_weight(params["lm_head"])
    return out


def is_quantized(params: dict) -> bool:
    return any(k.endswith("_q") for k in params.get("layers", {}))


def tree_to(params: dict, device) -> dict:
    """Every leaf moved to ``device`` (nested dicts kept)."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in params.items()}


def _random_tree_shapes(config: LlamaConfig) -> dict:
    """The random trees' leaf shapes, from the port's ``init_params``
    shapes, with JAX's two refusals (quant.py:201-225)."""
    if config.mla:
        raise ValueError(
            "the bench's random int8 tree generator does not cover MLA "
            "configs (real checkpoints DO quantize via quantize_tree; "
            "the bench targets the llama family)"
        )
    shapes = param_shapes(config)
    if "dense_layers" in shapes:
        raise ValueError(
            "the bench's random int8 tree generator does not cover "
            "dense-prelude stacks (real checkpoints DO quantize via "
            "quantize_tree)"
        )
    return shapes


def _assemble_random_tree(config: LlamaConfig, shapes: dict, dense, q_and_s) -> dict:
    """Walk the shape tree into the quantized layout, each leaf from the
    callbacks: ``dense(shape, dtype)`` and ``q_and_s(shape)``. Keys are
    walked sorted, as JAX walks its ``eval_shape`` tree, so the numpy
    path draws its stream in JAX's order."""
    out: dict = {}
    for key in sorted(shapes):
        if key == "layers":
            layers: dict = {}
            for name in sorted(shapes["layers"]):
                shape = shapes["layers"][name]
                if name in LAYER_TARGETS:
                    layers[name + "_q"], layers[name + "_s"] = q_and_s(shape)
                else:
                    layers[name] = dense(shape, _leaf_dtype(name, config))
            out["layers"] = layers
        elif key == "lm_head":
            out["lm_head_q"], out["lm_head_s"] = q_and_s(shapes[key])
        else:
            out[key] = dense(shapes[key], _leaf_dtype(key, config))
    return out


def random_quantized_params(config: LlamaConfig, seed: int = 0) -> dict:
    """Benchmark-only: the int8 serving tree with random values, drawn in
    numpy on the host as JAX's ``random_quantized_params`` draws it
    (quant.py:162-198; the same stream in the same order): random int8
    projections in [-127, 127], per-channel scales uniform in 0.8-1.2 x
    0.02 / 127, N(0, 0.02) for everything else, in each leaf's dtype
    (CPU tensors)."""
    shapes = _random_tree_shapes(config)
    rng = np.random.default_rng(seed)

    def dense(shape, dtype):
        x = rng.standard_normal(shape, np.float32) * 0.02
        return torch.from_numpy(x).to(dtype)

    def q_and_s(shape):
        q = rng.integers(-127, 128, size=shape, dtype=np.int8)
        s = (rng.uniform(0.8, 1.2, shape[:-2] + shape[-1:]) * (0.02 / 127.0)).astype(np.float32)
        return torch.from_numpy(q), torch.from_numpy(s)

    return _assemble_random_tree(config, shapes, dense, q_and_s)


def random_quantized_params_on_device(config: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Benchmark-only: :func:`random_quantized_params`'s structure and
    value ranges, every leaf drawn on ``device`` from one
    ``torch.Generator`` seeded with ``seed`` (the values are not numpy's
    or JAX's threefry's): each int8 leaf straight into an int8 tensor,
    each f32 scale uniform in 0.8-1.2 x 0.02 / 127, each other leaf
    N(0, 0.02) drawn in f32 and cast to its dtype."""
    shapes = _random_tree_shapes(config)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, dtype):
        return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02).to(dtype)

    def q_and_s(shape):
        q = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
        u = torch.rand(shape[:-2] + shape[-1:], generator=gen, device=device, dtype=torch.float32)
        return q, (0.8 + 0.4 * u) * (0.02 / 127.0)

    return _assemble_random_tree(config, shapes, dense, q_and_s)
