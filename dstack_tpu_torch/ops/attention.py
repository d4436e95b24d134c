"""Attention entry point used by the model code (counterpart of
dstack_tpu.ops.attention).

The JAX dispatcher picks the Pallas flash kernel on a TPU and the
masked-einsum ``_xla_attention`` elsewhere. Here the choice follows the
tensors: on a CUDA device the hand-written flash kernels run (or the
call raises — the plain version is never the path taken on the card),
on the CPU the plain versions run. ``impl="plain"`` asks for the plain
versions on any device, for reference checks on the card. Both paths
are differentiable through ``FlashAttention``: K1 forward with K2/K3
backward, or the plain forward with ``flash_bwd_plain``.

The serving path passes an int ``q_offset`` (a serial prefill chunk) or
a ``[B]`` tensor of per-row offsets (packed prefill: concurrent prompt
chunks at unequal starts). A vector offset takes the masked attention
``flash_attention_plain`` on every device, as JAX takes ``_xla_attention``
for it on every backend: no flash kernel tiles per-row offsets. Causal
masking, a sliding window, a softcap, attention sinks and Llama4's
chunk masks are served. A chunk mask is a plain causal mask where every
query lies in the first chunk (``q_offset + Tq <= chunk``, whatever the
key buffer's length: a serving chunk passes the whole cache row), so K1
runs there; beyond the first chunk the masked attention runs, as JAX
takes ``_xla_attention`` there (attention.py:161-172): no kernel of
either package tiles a chunk mask.

Sinks (gpt-oss) join the softmax denominator only, so a sink-less flash
pass rescaled by σ(lse - sink) is exact (:func:`sink_postscale`). The
logsumexp has no derivative here, so only callers that never
differentiate (``sinks_forward_only``: serving prefill, the forward with
autograd off) ride K1 with an int offset, and such a call raises where a
tensor needs a gradient (K1's entry is no autograd function: q, k and v
would get none); every other sinks call takes the masked plain attention
with :func:`sink_softmax`, on every device, as JAX takes
``_xla_attention`` (training included).
"""

from typing import Optional

import torch

from dstack_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_plain,
    flash_attention_with_lse,
    sink_postscale,
    sink_softmax,
)

__all__ = [
    "attention",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_with_lse",
    "sink_postscale",
    "sink_softmax",
]


def attention(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset=0,  # int, or [B] int tensor of per-row offsets (packed prefill)
    window: int = 0,  # 0 = full attention; else sliding window size
    softcap: float = 0.0,  # 0 = off; else tanh soft-cap on scores
    chunk: int = 0,  # 0 = off; else Llama4's blockwise-chunk size
    sinks: Optional[torch.Tensor] = None,  # [H] per-head sink logits (f32)
    impl: Optional[str] = None,  # None = by device | "plain"
    sinks_forward_only: bool = False,  # the caller never differentiates
) -> torch.Tensor:
    if impl not in (None, "plain"):
        raise ValueError(f"attention: impl={impl!r}: expected None or 'plain'")
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, window=window, softcap=softcap)
    vector_offset = isinstance(q_offset, torch.Tensor) and q_offset.dim() > 0
    if chunk and causal and not vector_offset and int(q_offset) + q.shape[2] <= chunk:
        chunk = 0  # every query in the first chunk: the causal mask alone
    if chunk:
        return flash_attention_plain(q, k, v, sinks=sinks, chunk=chunk, **kw)[0]
    if sinks is not None and sinks_forward_only and not vector_offset:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, sinks)):
            raise ValueError("attention: sinks_forward_only under autograd: K1 with the sink "
                             "rescale has no backward; pass sinks_forward_only=False to train")
        fwd = flash_attention_plain if impl == "plain" else flash_attention_with_lse
        o, lse = fwd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        return sink_postscale(o, lse, sinks)
    if vector_offset or sinks is not None:
        return flash_attention_plain(q, k, v, sinks=sinks, **kw)[0]
    return flash_attention(q, k, v, plain=impl == "plain", **kw)
