"""Flash attention: the hand-written Hopper kernels (K1 forward, K2/K3
backward), their plain PyTorch versions and the autograd Function that
joins them.

Source note. The kernel (``csrc/flash_fwd.cu``) replaces the Pallas
``_fwd_kernel`` driven by ``_flash_fwd`` (dstack_tpu/ops/flash.py:54,149;
``pl.pallas_call`` at :190). At the training shape (T = 2048, D = 64) it
is bound by operations; it is built for Hopper as FlashAttention-3 is:
wgmma for S = Q K^T (both operands in shared memory) and O += P V (P from
registers), a producer warpgroup that feeds Q once and K/V through a TMA
ring with mbarriers, and within each consumer warpgroup the softmax of
one tile overlapping the P V product of the one before. At the serving
shapes (a 16-256-query chunk over a 2048-slot cache row) it is bound by
the bytes of K and V it reads, so it reads only the KV tiles the causal
frontier and the window can see: a chunk at ``start`` reads
``start + C`` keys of the row, never the stale tail. Unlike the TPU
kernel (``flash_supported`` needs ``Tq % 128 == 0``), it takes every
chunk size the engine hands it: TMA zero-fills rows past the ends, and
rows past Tq are dropped at the store.

The backward kernels replace the Pallas ``_dq_kernel`` (K2,
``csrc/flash_bwd_dq.cu``; dstack_tpu/ops/flash.py:248, call at :467) and
``_dkv_kernel`` (K3, ``csrc/flash_bwd_dkv.cu``; flash.py:329, call at
:523), driven by ``_flash_bwd`` (flash.py:429). At the training shapes
(T = 2048, D = 64) both are bound by operations: K2 recomputes S and dP
and forms dQ (3 causal GEMMs), K3 recomputes S^T and dP^T and forms dV
and dK (4). Both are built for Hopper: wgmma for every product (the
stationary tile and the streamed one in shared memory, the re-packed
P or dS from registers), a producer warpgroup that feeds K/V (K2) or
Q/dO with their lse and delta rows (K3) through a two-stage TMA ring with
mbarriers, and the causal/window compare only on the tiles that straddle
the diagonal or the window edge. Neither uses atomics: two launches give
identical bits. delta = rowsum(dO*O) stays one PyTorch expression, as it
is one XLA expression in JAX (flash.py:457). The launchers build the TMA
tensor maps themselves. Like the Pallas backward (any ``D % 64 == 0``,
flash.py:688) they take Gemma's D = 256: K2 streams 32-key tiles there,
and K3's two consumers split dK's and dV's columns over one 64-key tile
(see the sources). They take DeepSeek's MLA training width D = 192 (q/k
heads of 128 + 64 and v padded from 128, ``_attention_block`` at
dstack_tpu/models/llama.py:1196-1202), where K3's two consumers split the
roles over one 64-key tile: one forms dV, the other dK.

K1's absorbed-MLA form (head width 576: DeepSeek's latent row
``[ckv ; k_pe]``, ``_prefill_chunk_mla`` at dstack_tpu/serve/engine.py:482)
has its own entry, :func:`flash_mla_with_lse`, and its own source,
``csrc/flash_fwd_mla.cu``. It takes the latent row once: JAX's value is
the same row with its rope columns zeroed, whose output columns JAX
slices away, so the kernel reads V as the first ``rank`` columns of the K
tile it holds and returns o at width ``rank`` (FlashMLA's design). Its
block packs the query heads that share the row into a tile's rows
(DeepSeek-V2's 16 heads x 4 positions; from 64 heads on, as V3's 128, one
position of 64 heads, a grid axis picking the head group), and
:func:`mla_plan` splits the keys where the grid is short of the SMs.
:func:`flash_attention_with_lse` refuses D = 576 and names the entry; K2
and K3 refuse it too: MLA trains through the non-absorbed form at
D = 192.

Each wrapper takes the plain version only for tensors on the CPU (the
CPU tests); for a CUDA tensor it launches the kernel or raises.
:class:`FlashAttention` is the counterpart of the custom VJP ``_flash``
(flash.py:571-614): forward K1, backward K2 then K3.
"""

import ctypes
from typing import Optional

import torch

from dstack_tpu_torch.ops import cuda_build

NEG_INF = -1e30
# the compiled head widths of K1, K2 and K3 (192: MLA training; 256: Gemma)
HEAD_DIMS = (64, 128, 192, 256)
MLA_HEAD_DIM = 576  # K1's absorbed-MLA form (csrc/flash_fwd_mla.cu): DeepSeek's 512 + 64
MLA_RANK = 512  # its value columns: the latent row's first 512
MLA_ROWS = 64  # rows a block of it: 64 / H query positions x H heads, or 64 of H >= 64 heads
MLA_TILE = 64  # keys a tile of its walk
MLA_MAX_SPLIT = 8  # the most key splits it takes: 16 read 6 % slower than 8 at C 32, q_offset 1792 (PERF.md)

# kernel launches since each count was last set to 0 (the plain versions
# never count): chip_smoke.py reads them to prove a path ran the kernels
LAUNCHES = 0  # K1 flash_fwd
LAUNCHES_MLA = 0  # K1's D = 576 form, flash_fwd_mla
LAUNCHES_DQ = 0  # K2 flash_bwd_dq
LAUNCHES_DKV = 0  # K3 flash_bwd_dkv
# the same launches of K1, K2 and K3 by form ("flash_fwd/causal", and
# "noncausal" or "offset" (non-causal at a q_offset: a ring step's block of
# an earlier shard under a window), as :func:`launch_form` names them)
LAUNCHES_BY_FORM: dict = {}


def launch_form(kernel: str, causal: bool, q_offset) -> str:
    """The form key of a launch in :data:`LAUNCHES_BY_FORM`."""
    return f"{kernel}/{'causal' if causal else 'offset' if int(q_offset) else 'noncausal'}"


def _count_form(kernel: str, kw_or_causal, q_offset=0) -> None:
    if isinstance(kw_or_causal, dict):
        causal, q_offset = kw_or_causal.get("causal", True), kw_or_causal.get("q_offset", 0)
    else:
        causal = kw_or_causal
    key = launch_form(kernel, causal, q_offset)
    LAUNCHES_BY_FORM[key] = LAUNCHES_BY_FORM.get(key, 0) + 1

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


# after the tensor pointers, every launcher takes the same tail:
# B H Hkv Tq Tk D, scale causal q_off kv_off window softcap, stream
_SHAPE_ARGS = [_c_int] * 6 + [_c_float, _c_int, _c_int, _c_int, _c_int, _c_float, _c_void]


def _fn(source: str, name: str, n_ptrs: int):
    """The C launcher ``name`` of ``csrc/<source>.cu`` with its argtypes
    set (pointers as c_void_p: ctypes would cut an int to 32 bits)."""
    fn = getattr(cuda_build.load(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_c_void] * n_ptrs + _SHAPE_ARGS
    return fn


def flash_attention_plain(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset=0,  # int, or [B] int tensor: each batch row's own frontier
    kv_offset: int = 0,
    window: int = 0,
    softcap: float = 0.0,
    sinks: Optional[torch.Tensor] = None,  # [H] per-head sink logits
    chunk: int = 0,  # Llama4: keys only from the query's own chunk-token block
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked-einsum attention → (o [B, H, Tq, D], lse [B, H, Tq] f32):
    the JAX ``_xla_attention`` (dstack_tpu/ops/attention.py:44) with the
    logsumexp beside it. Scores in f32, softmax in f32, probabilities
    cast to v's dtype before the P·V product. A row with no live key
    gives 0 and lse NEG_INF, the flash kernels' convention (JAX's
    averages v there; no serving or training row has no live key).
    With ``sinks`` the softmax is :func:`sink_softmax` (the sink joins
    the denominator only; a row with no live key gives 0 there in JAX
    too); ``lse`` stays the sink-less scores' logsumexp. ``chunk`` keeps
    key j for query i only where both lie in the same ``chunk``-token
    block (Llama4's blockwise-local layers, attention.py:81-85)."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = float(scale) if scale is not None else d**-0.5
    if hkv != h:
        if h % hkv:
            raise ValueError(f"GQA heads {h} not divisible by kv heads {hkv}")
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)  # cap raw scores, then mask
    if causal or window or chunk:
        off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1, 1)
        qi = off + torch.arange(tq, device=q.device)[None, :, None]  # [B|1, Tq, 1]
        kj = kv_offset + torch.arange(tk, device=q.device)[None, None, :]
        keep = qi >= kj if causal else torch.ones_like(qi >= kj)
        if window:
            keep = keep & (qi - kj < window)
        if chunk:
            keep = keep & (qi // chunk == kj // chunk)
        s = torch.where(keep[:, None], s, torch.full_like(s, NEG_INF))  # over heads
    live = s.amax(dim=-1) > NEG_INF / 2  # [B, H, Tq]
    if sinks is not None:
        p = sink_softmax(s, sinks.float().reshape(1, -1, 1, 1))
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    if s.device.type == "cpu":
        # logsumexp's own formula, but exp's underflow path (a score masked
        # to NEG_INF) runs ~15x slower than a normal exp on the CPU: clamped,
        # a masked score adds exp(-87) < 1.7e-38 to a sum >= 1, which leaves
        # it unchanged
        m = s.amax(dim=-1, keepdim=True)
        lse = (m + (s - m).clamp_(min=-87.0).exp_().sum(dim=-1, keepdim=True).log()).squeeze(-1)
    else:
        lse = torch.logsumexp(s, dim=-1)
    o = torch.where(live[..., None], o, torch.zeros_like(o))
    lse = torch.where(live, lse, torch.full_like(lse, NEG_INF))
    return o, lse


def sink_softmax(s: torch.Tensor, sink: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with a learned sink logit joining the
    DENOMINATOR only (gpt-oss attention sinks; the JAX ``sink_softmax``,
    dstack_tpu/ops/attention.py:32). ``s`` is the masked f32 scores;
    ``sink`` broadcasts against it with a trailing singleton key axis."""
    m = torch.maximum(s.amax(dim=-1, keepdim=True), sink)
    e = torch.exp(s - m)
    return e / (e.sum(dim=-1, keepdim=True) + torch.exp(sink - m))


def sink_postscale(o: torch.Tensor, lse: torch.Tensor, sinks: torch.Tensor) -> torch.Tensor:
    """Apply attention sinks AFTER a sink-less softmax (the JAX
    ``sink_postscale``, attention.py:94): the sink joins the denominator
    only, so the sinked output is the exact rescale ``o · σ(lse - sink)``
    of the sink-less one. o [B, H, Tq, D], lse [B, H, Tq] f32 of the same
    call (natural log; NEG_INF for a row with no live key, whose o is 0),
    sinks [H] → o in its dtype."""
    gate = torch.sigmoid(lse - sinks.float().reshape(1, -1, 1))[..., None]
    return (o.float() * gate).to(o.dtype)


def _check_kernel_args(q, k, v, **like_q) -> None:
    """Shapes, device, dtype, layout and alignment the kernels take;
    ``like_q`` names more bf16 tensors shaped like q (dO)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash: want q [B,H,Tq,D], k/v [B,Hkv,Tk,D]; got {q.shape}, {k.shape}, {v.shape}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash: mismatched q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash: head_dim {d} not in the kernel's {HEAD_DIMS}")
    for name, t in like_q.items():
        if t.shape != q.shape:
            raise ValueError(f"flash: {name} {tuple(t.shape)} is not shaped like q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *like_q.items()):
        if t.device != q.device:
            raise ValueError(f"flash: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash: {name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flash: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash: {name} must be 16-byte aligned (vector loads)")


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward → (o, lse [B, H, Tq] f32). GQA-native
    (``H % Hkv == 0``); ``q_offset``/``kv_offset`` place row/column 0 at
    global positions for the causal mask (``q_offset=start`` for a
    prefill chunk over the whole cache row); ``window`` keeps key j for
    query i iff ``0 <= i - j < window``; ``softcap`` caps raw scores.
    D = 576, MLA's absorbed form, is :func:`flash_mla_with_lse`'s."""
    if q.shape[-1] == MLA_HEAD_DIM:
        raise ValueError(
            f"flash: D = {MLA_HEAD_DIM} is MLA's absorbed form: call "
            "flash_mla_with_lse(q_abs, row, rank=..., scale=..., q_offset=...)"
        )
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset, window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash: no kernel for device {q.device}")
    _check_kernel_args(q, k, v)
    b, h, tq, d = q.shape
    scale = float(scale) if scale is not None else d**-0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    err = _fn("flash_fwd", "dtpu_flash_fwd", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_shape_args(q, k, scale, causal, q_offset, kv_offset, window, softcap),
    )
    cuda_build.check(err, "flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    _count_form("flash_fwd", causal, q_offset)
    return o, lse


def _shape_args(q, k, scale, causal, q_offset, kv_offset, window, softcap) -> tuple:
    b, h, tq, d = q.shape
    return (
        b, h, k.shape[1], tq, k.shape[2], d, float(scale), int(bool(causal)),
        int(q_offset), int(kv_offset), int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )


# ---------------------------------------------------------------------------
# MLA's absorbed form (D = 576)
# ---------------------------------------------------------------------------


def mla_value(row: torch.Tensor, rank: int) -> torch.Tensor:
    """The absorbed value: the latent row with its rope columns (those
    past ``rank``) zeroed, as JAX builds it (engine.py:525-529)."""
    return torch.cat([row[..., :rank], torch.zeros_like(row[..., rank:])], dim=-1)


def flash_mla_plain(
    q_abs: torch.Tensor,  # [B, H, C, R]
    row: torch.Tensor,  # [B, 1, T, R] the slot's latent row
    *,
    rank: int,
    scale: float,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's absorbed chunk attention, ``attention(q_abs, row,
    value(row), causal, q_offset)[..., :rank]``, with the f32 logsumexp:
    (o [B, H, C, rank], lse [B, H, C])."""
    o, lse = flash_attention_plain(
        q_abs, row, mla_value(row, rank), causal=True, scale=scale, q_offset=q_offset
    )
    return o[..., :rank], lse


def mla_blocks(b: int, h: int, c: int) -> int:
    """Blocks of the D = 576 kernel's grid before any split: a block's
    MLA_ROWS rows are MLA_ROWS / H positions of all H heads (H <= 64), or
    one position of MLA_ROWS heads (H >= 64: V3's 128 heads take two
    blocks a position), so ceil(C / (MLA_ROWS / H)) x B blocks, or B x C x
    H / MLA_ROWS."""
    if h >= MLA_ROWS:
        return b * c * (h // MLA_ROWS)
    return b * -(-c // (MLA_ROWS // h))


def mla_plan(b: int, h: int, c: int, t: int, q_offset: int, sms: int = 132) -> int:
    """NSPLIT of the D = 576 kernel from the host's shapes: where its grid
    (:func:`mla_blocks`) is short of ``sms`` the keys are split so the grid reaches about one block an SM, but
    into no more than MLA_MAX_SPLIT. A split writes f32 partials of all
    C x H rows for the combine to merge, so it must walk at least one
    key tile of the longest walk (``q_offset + c`` keys) for each
    MLA_TILE positions of the chunk."""
    blocks = mla_blocks(b, h, c)
    reach = min(-(-t // MLA_TILE), (q_offset + c - 1) // MLA_TILE + 1)
    return max(1, min(reach // -(-c // MLA_TILE), sms // blocks, MLA_MAX_SPLIT))


def flash_mla_with_lse(
    q_abs: torch.Tensor,  # [B, H, C, 576] bf16
    row: torch.Tensor,  # [B, 1, T, 576] bf16
    *,
    rank: int,
    scale: float,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MLA's absorbed chunk attention → (o [B, H, C, rank], lse [B, H,
    C] f32): the queries over their slot's latent row, causal at
    ``q_offset``, the value the row's first ``rank`` columns. The plain
    version (:func:`flash_mla_plain`) only for a CPU tensor; a CUDA
    tensor launches ``csrc/flash_fwd_mla.cu`` (and its combine when
    :func:`mla_plan` splits the keys) or raises."""
    if q_abs.device.type == "cpu":
        return flash_mla_plain(q_abs, row, rank=rank, scale=scale, q_offset=q_offset)
    return _flash_mla_launch(q_abs, row, rank=rank, scale=scale, q_offset=q_offset)


def _flash_mla_launch(q_abs, row, *, rank, scale, q_offset, nsplit=None):
    """The D = 576 kernel's launch, with ``nsplit`` splits of the keys
    (None: :func:`mla_plan`'s). Only the kernel's checks and timings
    choose another NSPLIT than the plan's."""
    if q_abs.device.type != "cuda":
        raise ValueError(f"flash_mla: no kernel for device {q_abs.device}")
    if q_abs.dim() != 4 or row.dim() != 4 or row.shape[1] != 1 or row.shape[0] != q_abs.shape[0]:
        raise ValueError(f"flash_mla: want q [B,H,C,D], row [B,1,T,D]; got {tuple(q_abs.shape)}, {tuple(row.shape)}")
    b, h, c, d = q_abs.shape
    t = row.shape[2]
    if d != MLA_HEAD_DIM or row.shape[3] != d or rank != MLA_RANK:
        raise ValueError(f"flash_mla: the kernel takes D = {MLA_HEAD_DIM}, rank {MLA_RANK}; got D {d}, rank {rank}")
    if (h % MLA_ROWS if h >= MLA_ROWS else MLA_ROWS % h) or q_offset < 0:
        raise ValueError(f"flash_mla: H = {h} must divide {MLA_ROWS} or be a multiple of it, "
                         f"q_offset {q_offset} >= 0")
    for name, x in (("q_abs", q_abs), ("row", row)):
        if x.device != q_abs.device:
            raise ValueError(f"flash_mla: {name} on {x.device}, q_abs on {q_abs.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_mla: {name} is {x.dtype}; the kernel takes bfloat16")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_mla: {name} must be contiguous and 16-byte aligned")
    if nsplit is None:
        nsplit = mla_plan(b, h, c, t, int(q_offset),
                          torch.cuda.get_device_properties(q_abs.device).multi_processor_count)
    o = torch.empty((b, h, c, rank), dtype=torch.bfloat16, device=q_abs.device)
    lse = torch.empty((b, h, c), dtype=torch.float32, device=q_abs.device)
    # the f32 partials in one allocation: acc [nsplit, B*H*C, rank], m, l
    # [nsplit, B*H*C]; freed after the enqueue, reused in stream order
    ws = [None, None, None]
    if nsplit > 1:
        n = nsplit * b * h * c
        buf = torch.empty(n * (rank + 2), dtype=torch.float32, device=q_abs.device)
        ws = [buf.data_ptr() + 4 * n * off for off in (0, rank, rank + 1)]
    fn = cuda_build.load("flash_fwd_mla").dtpu_flash_mla
    if fn.argtypes is None:
        fn.restype = _c_int
        fn.argtypes = [_c_void] * 7 + [_c_int] * 6 + [_c_float, _c_int, _c_int, _c_void]
    err = fn(
        q_abs.data_ptr(), row.data_ptr(), o.data_ptr(), lse.data_ptr(), *ws,
        b, h, c, t, d, rank, float(scale), int(q_offset), int(nsplit),
        torch.cuda.current_stream(q_abs.device).cuda_stream,
    )
    cuda_build.check(err, "flash_fwd_mla")
    global LAUNCHES_MLA
    LAUNCHES_MLA += 1
    return o, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def flash_bwd_plain(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    o: torch.Tensor,  # [B, H, Tq, D] the forward's output
    lse: torch.Tensor,  # [B, H, Tq] f32, the forward's logsumexp
    do: torch.Tensor,  # [B, H, Tq, D] cotangent of o
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) with the math of the JAX ``_flash_bwd`` kernels
    (dstack_tpu/ops/flash.py:248-426), over whole rows instead of
    blocks: delta = rowsum(dO*O) in f32; P = exp(S - lse), an lse at or
    below NEG_INF/2 read as 0 and masked P set to 0; P cast to dO's
    dtype before dV, dS cast to q's dtype before dQ and dK; the GQA
    group sum of dK/dV taken in f32; outputs in the inputs' dtypes."""
    return _bwd_plain(
        q, k, v, do, lse, bwd_delta(o, do), causal=causal, scale=scale,
        q_offset=q_offset, kv_offset=kv_offset, window=window, softcap=softcap,
    )


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 → [B, H, Tq] (flash.py:457)."""
    return (do.float() * o.float()).sum(-1)


def _bwd_plain(q, k, v, do, lse, delta, *, causal=True, scale=None, q_offset=0, kv_offset=0,
               window=0, softcap=0.0):
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = float(scale) if scale is not None else d**-0.5
    q32, do32 = q.float(), do.float()
    k32 = k.float().repeat_interleave(group, dim=1)
    v32 = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if causal or window:
        off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1, 1)
        qi = off + torch.arange(tq, device=q.device)[None, :, None]  # [B|1, Tq, 1]
        kj = kv_offset + torch.arange(tk, device=q.device)[None, None, :]
        keep = qi >= kj if causal else torch.ones_like(qi >= kj)
        if window:
            keep = keep & (qi - kj < window)
        s = torch.where(keep[:, None], s, torch.full_like(s, NEG_INF))  # over heads
    lse_safe = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)[..., None]
    p = torch.exp(s - lse_safe)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    if softcap:  # d(softcap*tanh(s/softcap))/ds = 1 - tanh^2
        ds = ds * (1.0 - t * t)
    ds_lo = ds.to(q.dtype).float()
    dq = torch.matmul(ds_lo, k32)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do32)  # per query head
    dk = torch.matmul(ds_lo.transpose(-1, -2), q32)
    dk = dk.view(b, hkv, group, tk, d).sum(2)
    dv = dv.view(b, hkv, group, tk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_bwd(source: str, outs: tuple, q, k, v, do, lse, delta, *, causal=True, scale=None,
                q_offset=0, kv_offset=0, window=0, softcap=0.0) -> None:
    """Launch ``csrc/<source>.cu`` writing ``outs``, or raise: the checks
    of the forward plus contiguous f32 [B, H, Tq] lse and delta."""
    if q.device.type != "cuda":
        raise ValueError(f"flash: no kernel for device {q.device}")
    _check_kernel_args(q, k, v, do=do)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash: {name} must be contiguous f32 [B,H,Tq]; got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash: {name} on {t.device}, q on {q.device}")
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
    err = _fn(source, f"dtpu_{source}", len(ptrs))(
        *ptrs, *_shape_args(q, k, scale, causal, q_offset, kv_offset, window, softcap)
    )
    cuda_build.check(err, source)


def flash_bwd_dq(q, k, v, do, lse, delta, **kw) -> torch.Tensor:
    """K2: dq [B, H, Tq, D] from the forward's lse and ``delta`` =
    :func:`bwd_delta`; ``kw`` as :func:`flash_bwd` takes them. The plain
    version only for CPU tensors."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, **kw)[0]
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, **kw)
    global LAUNCHES_DQ
    LAUNCHES_DQ += 1
    _count_form("flash_bwd_dq", kw)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [B, Hkv, Tk, D], the GQA group summed inside the
    kernel; arguments as :func:`flash_bwd_dq`. The plain version only
    for CPU tensors."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, **kw)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta, **kw)
    global LAUNCHES_DKV
    LAUNCHES_DKV += 1
    _count_form("flash_bwd_dkv", kw)
    return dk, dv


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward → (dq, dk, dv): delta = rowsum(dO*O) in
    PyTorch, then K2 for dq and K3 for dk and dv at KV-head width. The
    plain version only for CPU tensors; a CUDA tensor launches both
    kernels or raises."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_offset=kv_offset,
              window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, **kw)
    if o.shape != q.shape:
        raise ValueError(f"flash: o {tuple(o.shape)} is not shaped like q {tuple(q.shape)}")
    delta = bwd_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX custom
    VJP ``_flash`` (dstack_tpu/ops/flash.py:571-614). Forward saves
    (q, k, v, o, lse); backward runs :func:`flash_bwd` (K2, K3) on them.
    With ``plain`` both directions take the plain versions on any
    device: the reference path on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_offset, window, softcap, plain):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(
            causal=causal, scale=scale, q_offset=q_offset, kv_offset=kv_offset,
            window=window, softcap=softcap,
        )
        fwd = flash_attention_plain if plain else flash_attention_with_lse
        o, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_bwd_plain if ctx.plain else flash_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: int = 0,
    softcap: float = 0.0,
    plain: bool = False,
) -> torch.Tensor:
    """Differentiable flash attention → o: K1 forward and K2/K3 backward
    on the card, the plain versions on the CPU (or anywhere with
    ``plain``)."""
    return FlashAttention.apply(
        q, k, v, causal, scale, q_offset, kv_offset, window, softcap, plain
    )

