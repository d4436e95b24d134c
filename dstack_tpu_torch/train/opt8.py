"""8-bit Adam for the PyTorch port (counterpart of dstack_tpu.train.opt8):
blockwise log-quantized first and second moments.

The optimizer update is bandwidth-bound: bf16 moments of an 8B model are
32 GB read and written a step at almost no FLOPs. Storing both moments
as int8 with an f32 scale a 256-element block cuts them to 16 GB and
frees the memory that lets llama-3-8b train on one 80 GB card.

Scheme (as JAX's, dstack_tpu/train/opt8.py:1-24): per block of 256 along
the last axis, scale = absmax; magnitudes are coded on a log grid over
1e-6..1 of the block scale (127 levels and a sign), a uniform ~5 %
relative decode error across six decades. Leaves whose last dim is not a
multiple of the block, or with fewer than 16384 elements, keep f32
moments.

JAX writes the update as plain ``jnp`` code and XLA fuses the decode,
the update and the encode into one pass over a leaf. Eager PyTorch would
make some thirty passes over f32 temporaries of each leaf, losing the
traffic saving and holding several f32 copies of the largest leaf, so on
the card each quantized leaf takes one launch of A8, the hand-written
kernel (``csrc/adam8.cu`` behind ``ops/adam8.py``). This module holds the
plain side: the codes, :func:`adam8_update_plain` (what the CPU tests run
and what the card holds A8 against) and :class:`AdamW8`, the optimizer
``default_optimizer(opt_bits=8)`` returns.
"""

import math
from dataclasses import dataclass
from typing import Callable

import torch

from dstack_tpu_torch.train.step import global_norm, tree_leaves, tree_map

BLOCK = 256
_LN_RANGE = -math.log(1e-6)  # the magnitude grid spans [1e-6, 1] of the block max
_MIN_QUANT_SIZE = 16384
N_SCALARS = 5  # the device scalars of an update: clip divisor, clip factor, c1, c2, step size


def _is_quantized(shape) -> bool:
    """Whether a leaf of ``shape`` keeps int8 moments (opt8.py:38)."""
    return len(shape) >= 1 and shape[-1] % BLOCK == 0 and math.prod(shape) >= _MIN_QUANT_SIZE


def q8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [..., D] → (int8 [..., D], f32 scales [..., D/BLOCK]): JAX's
    ``q8_encode`` (round half to even, sign(0) = 0)."""
    shape = x.shape
    xb = x.reshape(*shape[:-1], shape[-1] // BLOCK, BLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    n = xb / scale
    mag = n.abs().clamp(1e-6, 1.0)
    code = torch.round((1.0 + torch.log(mag) / _LN_RANGE) * 127.0)
    q = (torch.sign(n) * code).to(torch.int8).reshape(shape)
    return q, scale[..., 0]


def q8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 [..., D], f32 [..., D/BLOCK]) → f32 [..., D]: JAX's
    ``q8_decode``; a zero code decodes to exactly 0."""
    shape = q.shape
    qf = q.float().reshape(*shape[:-1], shape[-1] // BLOCK, BLOCK)
    mag = torch.exp((qf.abs() / 127.0 - 1.0) * _LN_RANGE)
    return (torch.sign(qf) * mag * scale[..., None]).reshape(shape)


def adam8_scalars(norm: torch.Tensor, max_norm: float, count: int, b1: float, b2: float,
                  step_size: float) -> torch.Tensor:
    """The update's device scalars, f32 [N_SCALARS] on ``norm``'s device:
    the clip's divisor and factor (``norm`` and ``max_norm`` where the
    global norm reaches ``max_norm``, else 1 and 1: optax's
    ``clip_by_global_norm``, whose ``t / norm * max_norm`` is the identity
    then), the bias corrections ``1 - b ** count`` of the incremented
    count, in f32 as JAX takes them, and the step size (``-lr``)."""
    clip = norm >= max_norm
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    f32 = torch.float32
    host = torch.stack([1 - torch.tensor(b1, dtype=f32) ** count, 1 - torch.tensor(b2, dtype=f32) ** count,
                        torch.tensor(step_size, dtype=f32)])
    return torch.cat([torch.where(clip, norm.float(), one)[None],
                      torch.where(clip, one * max_norm, one)[None], host.to(norm.device)])


def _clipped(g: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """optax's clip in the gradient's dtype: ``(g / norm) * max_norm``
    with both scalars rounded to it, then f32."""
    return ((g / scalars[0].to(g.dtype)) * scalars[1].to(g.dtype)).float()


def _step(p, g, mu, nu, scalars, b1, b2, eps, weight_decay) -> tuple:
    """The f32 moments' update and the new parameter, JAX's arithmetic in
    its order: ``scale_by_adam8``'s per-leaf update (opt8.py:96-107), then
    ``add_decayed_weights`` (``wd * p`` in p's dtype), the learning rate
    (``scale_by_learning_rate``) and ``apply_updates`` (p + u in f32, cast
    to p's dtype) → (p, mu, nu)."""
    g = _clipped(g, scalars)
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    upd = (mu / scalars[2]) / (torch.sqrt(nu / scalars[3]) + eps)
    upd = upd + p * torch.tensor(weight_decay, dtype=p.dtype)
    upd = scalars[4] * upd
    return (p.float() + upd).to(p.dtype), mu, nu


def adam8_update_plain(
    p: torch.Tensor, g: torch.Tensor, mu_q: torch.Tensor, mu_s: torch.Tensor, nu_q: torch.Tensor,
    nu_s: torch.Tensor, scalars: torch.Tensor, *, b1: float, b2: float, eps: float, weight_decay: float,
) -> tuple:
    """One AdamW step of a quantized leaf in plain tensor ops: both
    moments decoded, JAX's update (:func:`_step`), both re-encoded →
    new (p, mu_q, mu_s, nu_q, nu_s); the inputs are not written.
    ``scalars`` is :func:`adam8_scalars`'s."""
    p, mu, nu = _step(p, g, q8_decode(mu_q, mu_s), q8_decode(nu_q, nu_s), scalars, b1, b2, eps, weight_decay)
    return (p, *q8_encode(mu), *q8_encode(nu))


@dataclass(frozen=True)
class AdamW8:
    """``optax.chain(clip_by_global_norm(max_norm), adamw8(schedule, b1,
    b2, eps, weight_decay))`` (dstack_tpu/train/opt8.py:131,
    step.py:154-160) on tensor trees. The state mirrors JAX's
    ``ScaleByAdam8State``: ``mu``/``nu`` hold each quantized leaf's int8
    codes (an f32 moment for a small leaf) and ``mu_scale``/``nu_scale``
    its f32 [..., D/256] scales (an f32 scalar placeholder for a small
    leaf); ``count`` is the step count. :meth:`update` writes the
    parameters, codes, scales and small moments in place: a quantized
    leaf through ``ops.adam8.adam8_update`` (A8 on the card), a small one
    in plain tensor ops."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_norm: float = 1.0

    def init(self, params: dict) -> dict:
        def codes(p):
            if _is_quantized(p.shape):
                return torch.zeros(p.shape, dtype=torch.int8, device=p.device)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        def scales(p):
            if _is_quantized(p.shape):  # q8_encode of zeros: the 1e-30 floor
                return torch.full((*p.shape[:-1], p.shape[-1] // BLOCK), 1e-30, device=p.device)
            return torch.zeros((), dtype=torch.float32, device=p.device)

        return {"count": 0, "mu": tree_map(codes, params), "mu_scale": tree_map(scales, params),
                "nu": tree_map(codes, params), "nu_scale": tree_map(scales, params)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, norm=None) -> dict:
        """One step in place (``grads`` are not written); returns
        ``state`` with its count advanced. The schedule reads the count
        before the increment, the bias corrections the count after it.
        ``norm``: the clip's global norm where the leaves are ``fsdp``
        shards (``step.global_norm`` on a mesh). A leaf is quantized when
        :meth:`init` gave it int8 codes, so a shard keeps its whole leaf's
        choice, and A8 runs on the shard: its chunk holds whole blocks
        (``step.state_layout`` checks it) and its block scales are its own."""
        from dstack_tpu_torch.ops import adam8

        count = state["count"] + 1
        scalars = adam8_scalars(global_norm(grads) if norm is None else norm, self.max_norm, count, self.b1,
                                self.b2, -self.schedule(state["count"]))
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.weight_decay)
        for p, g, mu, mu_s, nu, nu_s in zip(*(tree_leaves(t) for t in (
                params, grads, state["mu"], state["mu_scale"], state["nu"], state["nu_scale"]))):
            if mu.dtype == torch.int8:
                # a tied embedding's gradient can come back transposed
                adam8.adam8_update(p, g.contiguous(), mu, mu_s, nu, nu_s, scalars, **kw)
            else:
                new_p, new_mu, new_nu = _step(p, g, mu, nu, scalars, **kw)
                p.copy_(new_p)
                mu.copy_(new_mu)
                nu.copy_(new_nu)
        state["count"] = count
        return state
