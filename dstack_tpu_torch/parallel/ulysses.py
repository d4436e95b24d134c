"""Ulysses attention: all-to-all sequence parallelism over ``sp``
(counterpart of dstack_tpu.parallel.ulysses).

Instead of rotating KV blocks round a ring, one all-to-all reshards each
of q, k and v from sequence-sharded [B, H, T/sp, D] to head-sharded
[B, H/sp, T, D], every rank runs the whole sequence's attention over its
heads (``ops.attention.attention``: K1 forward, K2/K3 backward on the
card, with any window or softcap the kernels take), and a second
all-to-all reshards the output back. Both are
:class:`~parallel.mesh.AllToAll`, whose backward is the all-to-all the
other way, so the gradient needs no sweep of its own.

``H % sp`` must be 0 (JAX's refusal); GQA KV heads are repeated the
fewest times that make them split by sp and keep each rank's group whole
(:func:`_expand_kv`).
"""

import math
from typing import Optional

import torch

from dstack_tpu_torch.ops.attention import attention
from dstack_tpu_torch.parallel.mesh import AllToAll, Mesh


def _expand_kv(k: torch.Tensor, h: int, sp: int) -> torch.Tensor:
    """Repeat KV heads so the head dim splits by ``sp``: the smallest r
    with ``sp | hkv*r`` and ``hkv*r | h``, or full query width where no
    such r keeps the group whole (ulysses.py:47)."""
    hkv = k.shape[1]
    if hkv % sp == 0:
        return k
    assert h % hkv == 0
    r = sp // math.gcd(hkv, sp)
    if h % (hkv * r) != 0:
        r = h // hkv
    return k.repeat_interleave(r, dim=1)


def ulysses_attention(
    q: torch.Tensor,  # [B, H, T/sp, D]: this rank's sequence shard
    k: torch.Tensor,  # [B, Hkv, T/sp, D]
    v: torch.Tensor,
    *,
    mesh: Mesh,
    causal: bool = True,
    scale: Optional[float] = None,
    axis_name: str = "sp",
    window: int = 0,
    softcap: float = 0.0,
    impl: Optional[str] = None,  # forwarded to ops.attention
) -> torch.Tensor:
    """Exact attention by head-sequence all-to-alls → o [B, H, T/sp, D]
    (the same contract as :func:`ring_attention`)."""
    sp = mesh.size(axis_name)
    if sp == 1:
        return attention(q, k, v, causal=causal, scale=scale, window=window, softcap=softcap, impl=impl)
    h, d = q.shape[1], q.shape[3]
    if h % sp != 0:
        raise ValueError(
            f"ulysses needs n_heads {h} divisible by sp={sp} (use ring "
            "attention otherwise)"
        )
    scale = float(scale) if scale is not None else d**-0.5
    k = _expand_kv(k, h, sp)
    v = _expand_kv(v, h, sp)

    def seq_to_heads(x):  # scatter heads, gather the sequence
        return AllToAll.apply(x.contiguous(), mesh, axis_name, 1, 2)

    oh = attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal, scale=scale,
                   window=window, softcap=softcap, impl=impl)
    return AllToAll.apply(oh.contiguous(), mesh, axis_name, 2, 1)
