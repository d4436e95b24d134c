"""Ring attention: exact sequence-parallel attention over the ``sp`` axis
(counterpart of dstack_tpu.parallel.ring_attention).

Each rank holds its shard of the sequence: q [B, H, T/sp, D] and k, v
[B, Hkv, T/sp, D]. Every ring step a rank attends its queries to the
key/value block it holds, merges the partial by its log-sum-exp, and sends
the block to the next rank of the ring (``batch_isend_irecv`` to the
neighbours, :meth:`Mesh.shift`), as JAX rotates it with ``ppermute``.

Two per-step forms, dispatched as JAX's ``ring_attention`` dispatches them:

- **kernel** (JAX's ``pallas``): the flash kernels of ``ops/flash.py``.
  :class:`_Ring` is the custom VJP: its forward calls K1
  (``flash_attention_with_lse``), causal on the diagonal block, non-causal
  on the blocks of earlier ranks, and launches nothing for the later ranks'
  blocks; its backward makes a second sweep with K2/K3 (``flash_bwd``) on
  the merged o and lse, the dK/dV f32 accumulators travelling with their
  blocks and arriving home after sp hops. :class:`_RingWindow` is the causal
  sliding window: the ring unrolled with a static ``q_offset = r * T/sp``
  a step (the kernels' window needs it static), the steps wholly past the
  window elided (:func:`_ring_live_steps`), and the accumulators
  fast-forwarded home in one hop. On the CPU the kernels' wrappers take
  their plain versions, so the tests run this form too (``impl="kernel"``).
- **einsum** (JAX's ``xla``): blockwise softmax in plain tensor ops,
  differentiated by autograd through :class:`~parallel.mesh.Shift`. JAX's
  dispatch sends non-causal windows (per-rank offsets are signed) and
  shapes that do not tile to it; the port sends the same cases, and
  nothing else.

Within a rank the function runs between a layer's two remat checkpoints,
as the flash call does, and keeps q, k, v, o and lse: no collective is
ever recomputed.
"""

from typing import Optional

import torch

from dstack_tpu_torch.ops import flash
from dstack_tpu_torch.ops.attention import attention
from dstack_tpu_torch.parallel.mesh import Mesh, Shift

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# einsum ring
# ---------------------------------------------------------------------------


def _block_attention(q, k, v, bias, scale: float, softcap: float = 0.0) -> tuple:
    """One KV block of attention → (unnormalised out, running max, denom),
    f32 (ring_attention.py:51)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)  # cap raw scores, then mask
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    return o.float(), m_safe, l


def _merge(o1, m1, l1, o2, m2, l2) -> tuple:
    """Merge two blockwise-softmax partials (log-sum-exp combine)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def _mask_bias(tq: int, tk: int, q_offset: int, k_offset: int, causal: bool, window: int,
               device=None) -> torch.Tensor:
    """The causal/sliding-window bias [1, 1, Tq, Tk] of query rows
    [q_offset, q_offset + Tq) against key columns [k_offset, k_offset + Tk)
    in global positions."""
    qi = q_offset + torch.arange(tq, device=device)[:, None]
    kj = k_offset + torch.arange(tk, device=device)[None, :]
    keep = qi >= kj if causal else torch.ones(tq, tk, dtype=torch.bool, device=device)
    if window:
        keep = keep & (qi - kj < window)
    return torch.where(keep, 0.0, NEG_INF).float()[None, None]


def _ring_einsum(q, k, v, mesh: Mesh, axis: str, causal: bool, scale: float, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """The per-rank ring in einsum blocks (``_ring_xla_local``), KV at the
    queries' head count."""
    sp, idx = mesh.size(axis), mesh.index(axis)
    tl = q.shape[2]
    o = torch.zeros(*q.shape[:3], v.shape[-1], dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    q32 = q.float()
    kb, vb = k, v
    for r in range(sp):
        src = (idx - r) % sp  # the block held came from this ring position
        bias = _mask_bias(tl, tl, idx * tl, src * tl, causal, window, q.device) if causal or window else None
        o, m, l = _merge(o, m, l, *_block_attention(q32, kb, vb, bias, scale, softcap))
        if r < sp - 1:
            kb, vb = Shift.apply(mesh, axis, 1, kb, vb)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel ring: K1 forward, K2/K3 backward per step
# ---------------------------------------------------------------------------


def _merge_lse(o, lse, o2, lse2) -> tuple:
    """Merge normalised partials by their log-sum-exp weights
    (ring_attention.py:136): o [B, H, T, D] f32, o2 in any dtype, lse and
    lse2 [B, H, T] f32 (NEG_INF: no live key)."""
    m = torch.maximum(lse, lse2)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    w1 = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), torch.exp(lse - m_safe))
    w2 = torch.where(lse2 <= NEG_INF / 2, torch.zeros_like(lse2), torch.exp(lse2 - m_safe))
    denom = w1 + w2
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o_new = (o * w1[..., None] + o2.float() * w2[..., None]) / denom[..., None]
    lse_new = m_safe + torch.log(denom)
    lse_new = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), lse_new)
    return o_new, lse_new


def _step_form(causal: bool, src: int, idx: int) -> Optional[bool]:
    """The kernel form of the block from ring position ``src`` on rank
    ``idx``: causal (the diagonal), non-causal (an earlier rank's, or every
    block when not causal) or None (a later rank's: no launch)."""
    if not causal or src < idx:
        return False
    return True if src == idx else None


def _step_fns(plain: bool) -> tuple:
    """The per-step (forward, backward): the kernels' wrappers, or with
    ``plain`` their plain versions on any device (the reference ring)."""
    if plain:
        return flash.flash_attention_plain, flash.flash_bwd_plain
    return flash.flash_attention_with_lse, flash.flash_bwd


class _Ring(torch.autograd.Function):
    """The kernel ring without a window (``_make_ring_pallas``)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale, softcap, plain):
        sp, idx = mesh.size(axis), mesh.index(axis)
        fwd = _step_fns(plain)[0]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = lse = None
        kb, vb = k, v
        for r in range(sp):
            form = _step_form(causal, (idx - r) % sp, idx)
            if form is not None:
                ob, lseb = fwd(q, kb, vb, causal=form, scale=scale, softcap=softcap)
                # the first live step (the diagonal, or step 0 when not
                # causal) seeds the merge: merging it into the empty
                # partial (lse NEG_INF) is the identity
                o, lse = (ob.float(), lseb) if o is None else _merge_lse(o, lse, ob, lseb)
            if r < sp - 1:
                kb, vb = mesh.shift([kb, vb], axis, 1)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, causal, scale, softcap, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, scale, softcap, plain = ctx.args
        sp, idx = mesh.size(axis), mesh.index(axis)
        bwd = _step_fns(plain)[1]
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb = k, v
        for r in range(sp):
            form = _step_form(causal, (idx - r) % sp, idx)
            if form is not None:
                dq_p, dk_p, dv_p = bwd(q, kb, vb, o, lse, do, causal=form, scale=scale, softcap=softcap)
                dq.add_(dq_p.float())
                dkb.add_(dk_p.float())
                dvb.add_(dv_p.float())
            # the accumulators travel with their blocks: after sp hops
            # they are home
            if r < sp - 1:
                kb, vb, dkb, dvb = mesh.shift([kb, vb, dkb, dvb], axis, 1)
            else:
                dkb, dvb = mesh.shift([dkb, dvb], axis, 1)
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None, None, None, None, None


def _ring_live_steps(sp: int, t_local: int, window: int) -> int:
    """Ring steps that can hold in-window pairs (ring_attention.py:257):
    step r's nearest (q, k) distance is ``r * t_local - (t_local - 1)``;
    once it reaches the window, that step and every later one are all
    masked."""
    if not window:
        return sp
    return min(sp, max(1, -(-(window - 1) // t_local) + 1))


class _RingWindow(torch.autograd.Function):
    """The causal sliding-window kernel ring
    (``_make_ring_pallas_window``): step r's block lies a static
    ``r * t_local`` behind the queries, so each live step calls the
    kernels non-causal at ``q_offset = r * t_local`` with the window; a
    rank whose block wrapped round (``idx < r``) skips it."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, scale, window, softcap, plain):
        sp, idx = mesh.size(axis), mesh.index(axis)
        fwd = _step_fns(plain)[0]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        tl = q.shape[2]
        kw = dict(scale=scale, window=window, softcap=softcap)
        o, lse = fwd(q, k, v, causal=True, q_offset=0, **kw)
        o = o.float()
        kb, vb = k, v
        for r in range(1, _ring_live_steps(sp, tl, window)):
            kb, vb = mesh.shift([kb, vb], axis, 1)
            if idx >= r:
                ob, lseb = fwd(q, kb, vb, causal=False, q_offset=r * tl, **kw)
                o, lse = _merge_lse(o, lse, ob, lseb)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, scale, window, softcap, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, scale, window, softcap, plain = ctx.args
        sp, idx = mesh.size(axis), mesh.index(axis)
        bwd = _step_fns(plain)[1]
        tl = q.shape[2]
        do = do.contiguous()
        kw = dict(scale=scale, window=window, softcap=softcap)
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=True, q_offset=0, **kw)
        dq, dkb, dvb = dq.float(), dk.float(), dv.float()
        kb, vb = k, v
        r_live = _ring_live_steps(sp, tl, window)
        for r in range(1, r_live):
            kb, vb, dkb, dvb = mesh.shift([kb, vb, dkb, dvb], axis, 1)
            if idx >= r:
                dq_p, dk_p, dv_p = bwd(q, kb, vb, o, lse, do, causal=False, q_offset=r * tl, **kw)
                dq.add_(dq_p.float())
                dkb.add_(dk_p.float())
                dvb.add_(dv_p.float())
        # the elided steps would only have rotated the accumulators: one
        # hop takes them the rest of the way home
        dkb, dvb = mesh.shift([dkb, dvb], axis, sp - (r_live - 1))
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None, None, None, None, None


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def kernel_ok(h: int, hkv: int, t_local: int, d: int, device: torch.device, window: int,
              causal: bool = True) -> bool:
    """JAX's ``_pallas_ok`` (ring_attention.py:404-415) with CUDA in
    place of the TPU: the kernel ring on the card where the shapes tile
    (``D % 64``, ``T/sp % 128``, whole GQA groups) and any window is
    causal; the einsum ring otherwise."""
    if device.type != "cuda":
        return False
    if window and not causal:
        return False
    return d % 64 == 0 and t_local % 128 == 0 and h % hkv == 0


def ring_attention(
    q: torch.Tensor,  # [B, H, T/sp, D]: this rank's sequence shard
    k: torch.Tensor,  # [B, Hkv, T/sp, D]
    v: torch.Tensor,
    *,
    mesh: Mesh,
    causal: bool = True,
    scale: Optional[float] = None,
    axis_name: str = "sp",
    impl: Optional[str] = None,  # None = by JAX's rule | "kernel" | "einsum"
    window: int = 0,  # sliding window, in global positions
    softcap: float = 0.0,
    plain: bool = False,  # the kernel ring on the plain versions (a reference on the card)
) -> torch.Tensor:
    """Exact attention of this rank's query shard over the whole sequence,
    KV rotating round the ``sp`` ring → o [B, H, T/sp, D]. ``sp == 1``
    is ``ops.attention.attention``, as in JAX. ``plain`` runs the kernel
    ring's steps on the kernels' plain versions, on any device."""
    sp = mesh.size(axis_name)
    if sp == 1:
        return attention(q, k, v, causal=causal, scale=scale, window=window, softcap=softcap)
    if impl not in (None, "kernel", "einsum"):
        raise ValueError(f"ring_attention: impl={impl!r}: expected None, 'kernel' or 'einsum'")
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    t_local = q.shape[2]
    if impl == "kernel" and window and not causal:
        raise ValueError(
            "ring_attention: non-causal sliding window requires the "
            "einsum path (wrapped offsets are signed per rank)"
        )
    use_kernel = impl == "kernel" or (
        impl is None and kernel_ok(q.shape[1], k.shape[1], t_local, q.shape[3], q.device, window, causal)
    )
    if use_kernel:
        # GQA KV stays at KV-head width: the kernels group natively, and
        # the ring moves the smaller blocks
        if window:
            return _RingWindow.apply(q, k, v, mesh, axis_name, scale, window, softcap, plain)
        return _Ring.apply(q, k, v, mesh, axis_name, causal, scale, softcap, plain)
    if k.shape[1] != q.shape[1]:  # GQA: KV at the queries' head count
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return _ring_einsum(q, k, v, mesh, axis_name, causal, scale, window, softcap)
