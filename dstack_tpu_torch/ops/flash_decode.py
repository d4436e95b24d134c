"""Ragged flash decode: the hand-written Hopper kernel (K4) and its plain
PyTorch version.

Source note. The kernel (``csrc/flash_decode.cu``) replaces the Pallas
``_decode_kernel`` driven by ``flash_decode``
(dstack_tpu/ops/flash_decode.py:48,161; ``pl.pallas_call`` at :266).
Decode attention is bound by the bytes of the KV cache it reads, so the
kernel reads each slot's row only up to that slot's position (and only
inside the window when one is set), once at KV-head width for the whole
GQA group. One block per (slot, KV head): at batch 8 x 8 KV heads that
is 64 blocks on the H100's 132 SMs — a split-K design is later work.

Not in this slice: the int8 cache with per-token scales, attention
sinks and ``rows_per_slot > 1`` (speculative verify). The wrapper raises
``NotImplementedError`` for each, on every device; it never falls back.
"""

import ctypes
from typing import Optional

import torch

from dstack_tpu_torch.ops import cuda_build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's compiled head widths
MAX_GROUP = 16  # query rows per KV head (one warp each)

# kernel launches since the count was last set to 0 (the plain version
# never counts): chip_smoke.py reads it to prove the serving path ran K4
LAUNCHES = 0

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_decode")
    fn = lib.dtpu_flash_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _c_void, _c_void, _c_void, _c_void, _c_void,  # q k v positions o
            _c_int, _c_int, _c_int, _c_int, _c_int,  # B Hkv G T D
            _c_float, _c_int, _c_float,  # scale window softcap
            _c_void,  # stream
        ]
    return lib


def flash_decode_plain(
    q: torch.Tensor,  # [B, Hkv, G, D]
    k: torch.Tensor,  # [B, Hkv, T, D]
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] int: attend to kj <= positions[b]
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """decode_step's masked-einsum attention (the einsum branch at
    dstack_tpu/serve/engine.py:1196-1224): f32 scores over the whole
    row, ``kj <= pos`` (and the window) masked, softmax, probabilities
    cast to v's dtype before the P·V product → [B, Hkv, G, D]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kj = torch.arange(k.shape[2], device=k.device)[None, None, None, :]
    pos = positions.to(k.device).long()[:, None, None, None]
    mask = kj <= pos
    if window:
        mask = mask & (pos - kj < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def flash_decode(
    q: torch.Tensor,  # [B, Hkv, G, D]
    k: torch.Tensor,  # [B, Hkv, T, D] cache (one layer)
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] int32
    *,
    scale: float,
    window: int = 0,  # 0 = full attention
    softcap: float = 0.0,
    sinks: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    rows_per_slot: int = 1,
) -> torch.Tensor:
    """One-token-per-slot GQA attention over the cache → [B, Hkv, G, D].
    Ragged: slot b reads only keys ``0 .. positions[b]``."""
    if sinks is not None:
        raise NotImplementedError("flash_decode: attention sinks come with the gpt-oss slice")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("flash_decode: the int8 KV cache comes with the kv_quant slice")
    if rows_per_slot != 1:
        raise NotImplementedError(
            "flash_decode: rows_per_slot > 1 comes with the speculative-verify slice"
        )
    window = int(window or 0)
    if q.device.type == "cpu":
        return flash_decode_plain(
            q, k, v, positions, scale=scale, window=window, softcap=softcap
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    b, hkv, g, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (b, hkv) or k.shape[3] != d:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs cache {tuple(k.shape)}/{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} not in the kernel's {HEAD_DIMS}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode: group {g} outside 1..{MAX_GROUP}")
    if positions.shape != (b,) or positions.dtype != torch.int32:
        raise ValueError(f"flash_decode: positions must be int32 [{b}], got {positions.dtype} {tuple(positions.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode: {name} is {t.dtype}; the kernel takes bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")
    o = torch.empty_like(q)
    err = _lib().dtpu_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), o.data_ptr(),
        b, hkv, g, k.shape[2], d, float(scale), window, float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(err, "flash_decode")
    global LAUNCHES
    LAUNCHES += 1
    return o


def flash_decode_supported(config, max_seq: int) -> bool:
    """Whether the engine may route decode attention through the kernel
    for this model (dense configs only reach the port): a compiled head
    width and a GQA group of at most 16 query heads. Any ``max_seq``
    works (the kernel masks a ragged last tile)."""
    return (
        config.head_dim in HEAD_DIMS
        and config.n_heads % config.n_kv_heads == 0
        and config.n_heads // config.n_kv_heads <= MAX_GROUP
        and max_seq > 0
    )
