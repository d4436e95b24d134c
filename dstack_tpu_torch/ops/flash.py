"""Flash-attention forward: the hand-written Hopper kernel (K1) and its
plain PyTorch version.

Source note. The kernel (``csrc/flash_fwd.cu``) replaces the Pallas
``_fwd_kernel`` driven by ``_flash_fwd`` (dstack_tpu/ops/flash.py:54,149;
``pl.pallas_call`` at :190). At the serving shapes (a 16-256-query
chunk over a 2048-slot cache row) it is bound by the bytes of K and V it
reads, not by FLOPs, so its design reads only the KV tiles the causal
frontier and the window can see: a chunk at ``start`` reads
``start + C`` keys of the row, never the stale tail. Unlike the TPU
kernel (``flash_supported`` needs ``Tq % 128 == 0``), it masks the ragged
edge itself and takes every chunk size the engine hands it.

The wrapper takes the plain version only for tensors on the CPU (the
CPU tests); for a CUDA tensor it launches the kernel or raises. Only the
forward is here: the backward kernels (``_dq_kernel``/``_dkv_kernel``)
come with the training slice.
"""

import ctypes
from typing import Optional

import torch

from dstack_tpu_torch.ops import cuda_build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's compiled head widths

# kernel launches since the count was last set to 0 (the plain version
# never counts): chip_smoke.py reads it to prove the serving path ran K1
LAUNCHES = 0

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_fwd")
    fn = lib.dtpu_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _c_void, _c_void, _c_void, _c_void, _c_void,  # q k v o lse
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # B H Hkv Tq Tk D
            _c_float, _c_int, _c_int, _c_int, _c_int, _c_float,  # scale causal q_off kv_off window softcap
            _c_void,  # stream
        ]
    return lib


def flash_attention_plain(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked-einsum attention → (o [B, H, Tq, D], lse [B, H, Tq] f32):
    the JAX ``_xla_attention`` (dstack_tpu/ops/attention.py:44) with the
    logsumexp beside it. Scores in f32, softmax in f32, probabilities
    cast to v's dtype before the P·V product. A row with no live key
    gives 0 and lse NEG_INF, the flash kernels' convention."""
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
    if causal or window:
        qi = q_offset + torch.arange(tq, device=q.device)[:, None]
        kj = kv_offset + torch.arange(tk, device=q.device)[None, :]
        keep = qi >= kj if causal else torch.ones_like(qi >= kj)
        if window:
            keep = keep & (qi - kj < window)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    live = s.amax(dim=-1) > NEG_INF / 2  # [B, H, Tq]
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.where(live[..., None], o, torch.zeros_like(o))
    lse = torch.where(live, lse, torch.full_like(lse, NEG_INF))
    return o, lse


def _check_kernel_args(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash: want q [B,H,Tq,D], k/v [B,Hkv,Tk,D]; got {q.shape}, {k.shape}, {v.shape}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash: mismatched q {tuple(q.shape)} and k/v {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash: head_dim {d} not in the kernel's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    query i iff ``0 <= i - j < window``; ``softcap`` caps raw scores."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset, window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash: no kernel for device {q.device}")
    _check_kernel_args(q, k, v)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    scale = float(scale) if scale is not None else d**-0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    err = _lib().dtpu_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, hkv, tq, tk, d, scale, int(bool(causal)), int(q_offset),
        int(kv_offset), int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(err, "flash_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return o, lse


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Forward-only flash attention → o (serving never differentiates;
    the training slice adds the backward kernels and an autograd
    Function)."""
    return flash_attention_with_lse(q, k, v, **kw)[0]

