"""LoRA fine-tuning for the PyTorch port (counterpart of
dstack_tpu.train.lora).

Adapters are stacked per-layer factors shaped like the base model's
stacked weights (``{name}_lora_a`` [L, d_in, r], ``{name}_lora_b``
[L, r, d_out]); ``llama.forward`` adds the bypass ``s·(x·A)·B`` to each
adapted projection. Only the adapters get gradients and optimizer state;
the base weights are constants of the step.

On a mesh (:func:`sharded_lora_init`, ``make_lora_train_step(mesh=...)``)
the base weights are sharded as the full step shards them and gathered
for each step; the adapters and their moments are whole on every rank,
and their gradients are summed over the data ranks.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from dstack_tpu_torch.models import llama
from dstack_tpu_torch.train.step import (
    DATA_AXES,
    AdamW,
    accumulate_grads,
    check_mesh,
    cross_entropy_loss,
    gather_params,
    global_norm,
    mask_total,
    param_layout,
    shard_tree,
    tree_map,
)


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    target_modules: tuple = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _module_dims(c: llama.LlamaConfig, name: str) -> tuple[int, int]:
    dims = {
        "wq": (c.hidden_size, c.q_dim),
        "wk": (c.hidden_size, c.kv_dim),
        "wv": (c.hidden_size, c.kv_dim),
        "wo": (c.q_dim, c.hidden_size),
        "w_gate": (c.hidden_size, c.intermediate_size),
        "w_up": (c.hidden_size, c.intermediate_size),
        "w_down": (c.intermediate_size, c.hidden_size),
    }
    if name not in dims:
        raise ValueError(f"unknown LoRA target module {name!r}")
    return dims[name]


def check_lora(config: llama.LlamaConfig) -> None:
    """Raise ``ValueError`` for a config JAX takes no adapters on
    (lora.py:73-81): MLA's projections (wq_a/wq_b/wkv_a/wkv_b) and
    DeepSeek's dense prelude do not map onto the wq/wk/wv adapters over
    one uniform ``[n_layers, ...]`` stack; those train in full."""
    if config.mla or config.first_k_dense:
        raise ValueError(
            "LoRA adapters are not supported for MLA/DeepSeek configs; "
            "use a full fine-tune (--full)"
        )


def lora_shapes(config: llama.LlamaConfig, lora_config: LoRAConfig) -> dict:
    check_lora(config)
    L, r = config.n_layers, lora_config.rank
    layers = {}
    for name in lora_config.target_modules:
        d_in, d_out = _module_dims(config, name)
        layers[f"{name}_lora_a"] = (L, d_in, r)
        layers[f"{name}_lora_b"] = (L, r, d_out)
    return {"layers": layers}


def init_lora_params(
    config: llama.LlamaConfig,
    lora_config: LoRAConfig,
    generator: torch.Generator,
    device="cuda",
) -> dict:
    """A = N(0, 1)/r and B = 0 (lora.py:69), so training starts at the
    base model. The draws differ from JAX's; parity tests carry adapters
    across with :func:`lora_from_jax`."""
    r = lora_config.rank
    layers = {}
    for key, shape in lora_shapes(config, lora_config)["layers"].items():
        if key.endswith("_lora_a"):
            a = torch.randn(shape, generator=generator, device=device, dtype=torch.float32) / r
            layers[key] = a.to(config.dtype)
        else:
            layers[key] = torch.zeros(shape, device=device, dtype=config.dtype)
    return {"layers": layers}


def lora_from_jax(
    tree: dict, config: llama.LlamaConfig, lora_config: LoRAConfig, device="cuda", dtype=None
) -> dict:
    """Carry a JAX adapter tree (leaves as numpy arrays) across key for
    key; raises on a missing, extra or misshapen leaf."""
    dtype = dtype or config.dtype
    shapes = lora_shapes(config, lora_config)["layers"]
    layers = tree["layers"]
    if set(layers) != set(shapes):
        raise ValueError(f"lora keys {sorted(layers)} != {sorted(shapes)}")
    out = {}
    for key, shape in shapes.items():
        a = np.asarray(layers[key])
        if tuple(a.shape) != shape:
            raise ValueError(f"lora[{key!r}]: shape {a.shape} != {shape}")
        if a.dtype not in (np.float16, np.float32, np.float64):
            a = a.astype(np.float32)  # bfloat16 numpy has no torch view
        out[key] = torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device=device, dtype=dtype)
    return {"layers": out}


def merge_lora_params(params: dict, lora: dict, lora_config: LoRAConfig) -> dict:
    """Fold the adapters into the base weights, W + s·A·B in f32, cast to
    W's dtype (lora.py:107)."""
    layers = dict(params["layers"])
    for key, a in lora["layers"].items():
        if not key.endswith("_lora_a"):
            continue
        name = key[: -len("_lora_a")]
        b = lora["layers"][f"{name}_lora_b"]
        delta = torch.matmul(a.float(), b.float()) * lora_config.scale
        layers[name] = (params["layers"][name].float() + delta).to(params["layers"][name].dtype)
    return {**params, "layers": layers}


def init_lora_state(lora: dict, optimizer: AdamW) -> dict:
    """{lora, opt_state, step}: optimizer state for the adapters only."""
    return {"lora": lora, "opt_state": optimizer.init(lora), "step": 0}


def lora_loss(
    lora: dict,
    batch: dict,
    params: dict,
    config: llama.LlamaConfig,
    lora_config: LoRAConfig,
    impl: Optional[str] = None,
    mesh=None,
) -> torch.Tensor:
    """The f32 cross-entropy over the full logits, as the JAX LoRA step
    takes it (lora.py:210); ``forward`` applies the config's final-logit
    cap to them (Gemma2). On a ``mesh``, this rank's share (its tokens over
    the global mask count)."""
    logits = llama.forward(
        params, batch["tokens"], config, lora=lora, lora_scale=lora_config.scale, impl=impl, mesh=mesh
    )
    total = mask_total(batch, mesh) if mesh is not None else None
    return cross_entropy_loss(logits, batch["targets"], batch.get("mask"), total=total)[0]


def sharded_lora_init(config: llama.LlamaConfig, lora_config: LoRAConfig, optimizer: AdamW, mesh,
                      generator: torch.Generator, params: Optional[dict] = None) -> tuple:
    """→ (this rank's base shards, the adapters' state, the base layout)
    (JAX's ``sharded_lora_init``, lora.py:150): the base drawn from
    ``generator`` (the same draws on every rank) or ``params``, then
    cut to shards; the adapters drawn next from the same generator, whole
    on every rank."""
    check_mesh(mesh)
    check_lora(config)
    if params is None:
        params = llama.init_params(config, generator, device=mesh.device)
    layout = param_layout(config, mesh)
    base = shard_tree(params, layout, mesh)
    del params
    lora = init_lora_params(config, lora_config, generator, device=mesh.device)
    return base, init_lora_state(lora, optimizer), layout


def make_lora_train_step(
    config: llama.LlamaConfig,
    lora_config: LoRAConfig,
    optimizer: AdamW,
    grad_accum: int = 1,
    impl: Optional[str] = None,
    mesh=None,
) -> Callable:
    """(base_params, state, batch) → (state, metrics): gradients of the
    adapters only, mask-weighted over ``grad_accum`` microbatches, then
    one optimizer update in place. With ``mesh``: the base is this rank's
    shards (:func:`sharded_lora_init`), ``batch`` its part
    (``step.local_batch``), the metrics global."""

    def step(params: dict, state: dict, batch: dict) -> tuple[dict, dict]:
        loss, grads = accumulate_grads(
            lora_loss, state["lora"], batch, grad_accum, params, config, lora_config, impl
        )
        gnorm = global_norm(grads)
        optimizer.update(grads, state["opt_state"], state["lora"])
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    if mesh is None:
        return step
    check_mesh(mesh)
    layout = param_layout(config, mesh)

    def mesh_step(params: dict, state: dict, batch: dict) -> tuple[dict, dict]:
        base = gather_params(params, layout, mesh)
        loss, grads = accumulate_grads(
            lora_loss, state["lora"], batch, grad_accum, base, config, lora_config, impl, mesh, mesh=mesh
        )
        del base
        grads = tree_map(lambda g, a: mesh.all_reduce(g.float(), DATA_AXES).to(a.dtype), grads, state["lora"])
        gnorm = global_norm(grads)
        optimizer.update(grads, state["opt_state"], state["lora"], norm=gnorm)
        state["step"] += 1
        return state, {"loss": mesh.all_reduce(loss, DATA_AXES), "grad_norm": gnorm}

    return mesh_step
