"""Ragged flash decode: the hand-written Hopper kernel (K4) and its plain
PyTorch version.

Source note. The kernel (``csrc/flash_decode.cu``) replaces the Pallas
``_decode_kernel`` driven by ``flash_decode``
(dstack_tpu/ops/flash_decode.py:48,161; ``pl.pallas_call`` at :266).
Decode attention is bound by the bytes of the KV cache it reads, so the
kernel reads each slot's row only up to that slot's frontier (and only
inside the window when one is set), once at KV-head width for every
query row of the slot. It is flash decoding: the grid is (slot x KV
head, row group, NSPLIT), each block takes an even share of its slot's
live 64-key tiles (computed on the device from ``positions``), and a
second kernel merges each row's NSPLIT f32 partials in split order.
:func:`decode_plan` picks the row groups and NSPLIT on the host from the
shapes alone, never from ``positions`` (a host read would add a sync to
every decode step); the wrapper allocates the partials. S = Q K^T and
O += P V run on the tensor cores (mma.sync), K and V stream through a
cp.async ring.

Variants, as in the TPU kernel: the bf16 cache or the int8 cache with
f32 per-token scales (``k_scale``/``v_scale``), one query row group per
slot (decode) or ``rows_per_slot = S`` rows of it (speculative verify),
each with or without attention sinks (gpt-oss: a learned logit per query
row that joins the softmax denominator only, applied once at each row's
finish as in ``_decode_kernel``, flash_decode.py:147-156). The sinks are
a runtime pointer, not a template parameter.
"""

import ctypes
from typing import Optional

import torch

from dstack_tpu_torch.ops import cuda_build
from dstack_tpu_torch.ops.flash import sink_softmax

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # the kernel's compiled head widths (256: Gemma)
# query rows a block at most, by head width: M-tiles of 16 (max_mtiles in
# csrc/flash_decode.cu), so the accumulators fit without a spill; an int8
# block converts each tile once for all its rows, so on a walk with no
# window (long enough to split) it takes INT8_ROWS
MAX_ROWS = {64: 32, 128: 16, 256: 16}
INT8_ROWS = {64: 48, 128: 16, 256: 16}
BLOCKS_PER_SM = 2  # NSPLIT aims at about this many blocks on every SM ...
TILES_A_SPLIT = 4  # ... and gives each split at least this many reachable tiles

# kernel launches since the counts were last set to 0 (the plain version
# never counts): chip_smoke.py reads them to prove the serving path ran
# K4, in total and by variant (cache dtype x decode / verify x sinks)
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {
    f"{cache}_{kind}{sinks}": 0
    for sinks in ("", "_sinks") for cache in ("bf16", "int8") for kind in ("decode", "verify")
}

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_decode")
    fn = lib.dtpu_flash_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _c_void, _c_void, _c_void, _c_void, _c_void,  # q k v k_scale v_scale
            _c_void, _c_void,  # positions o
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # B Hkv R S T D
            _c_float, _c_int, _c_float,  # scale window softcap
            _c_void,  # sinks (null: none)
            _c_int, _c_int,  # rows_per_block nsplit
            _c_void, _c_void, _c_void,  # acc_ws m_ws l_ws (nsplit > 1)
            _c_void,  # stream
        ]
    return lib


def kv_dequant(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values ``[..., D]`` times their f32 scales ``[...]``: the
    product in f32, only the result rounded to the compute dtype (the
    JAX ``kv_dequant``, dstack_tpu/serve/engine.py:94)."""
    return (q.float() * s[..., None].float()).to(dtype)


def flash_decode_plain(
    q: torch.Tensor,  # [B, Hkv, R, D], R = G * rows_per_slot
    k: torch.Tensor,  # [B, Hkv, T, D] compute dtype, or int8 with k_scale
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] int: row r attends to kj <= positions[b] + r % S
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, T] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    rows_per_slot: int = 1,
    sinks: Optional[torch.Tensor] = None,  # [Hkv, R] f32: row r's sink logit
    chunk: int = 0,  # Llama4's rope layers: keys from the row's own chunk block only
) -> torch.Tensor:
    """The masked-einsum attention of decode_step and verify_step (the
    einsum branches at dstack_tpu/serve/engine.py:1196-1224 and
    :1432-1461): the int8 cache dequantized as ``kv_dequant``, f32 scores
    over the whole row, ``kj <= pos + r % S`` (and the window, and with
    ``chunk`` every key before the query's chunk block: engine.py:1207-1210,
    1443-1445) masked,
    softmax (``sink_softmax`` with sinks), probabilities cast to v's
    dtype before the P·V product → [B, Hkv, R, D]."""
    if k_scale is not None:
        k = kv_dequant(k, k_scale, q.dtype)
        v = kv_dequant(v, v_scale, q.dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kj = torch.arange(k.shape[2], device=k.device)[None, None, None, :]
    step = torch.arange(q.shape[2], device=k.device) % int(rows_per_slot)
    qpos = positions.to(k.device).long()[:, None, None, None] + step[None, None, :, None]
    mask = kj <= qpos
    if window:
        mask = mask & (qpos - kj < window)
    if chunk:
        mask = mask & (kj >= (qpos // chunk) * chunk)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if sinks is not None:
        p = sink_softmax(s, sinks.float()[None, :, :, None])
    else:
        p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def tile_keys(int8: bool, window: int) -> int:
    """Keys a tile of the kernel's walk (4 warps x KPW in
    csrc/flash_decode.cu): 128 of an int8 cache with no window (about the
    16 KB of a 64-key bf16 tile, half the round trips), else 64."""
    return 128 if int8 and window <= 0 else 64


def decode_plan(b: int, hkv: int, r: int, t: int, d: int, window: int = 0, rows_per_slot: int = 1,
                int8: bool = False, sms: int = 132) -> tuple[int, int]:
    """The kernel's grid from shapes alone → (rows_per_block, nsplit):
    the R rows of a (slot, KV head) in as few even row groups as
    ``MAX_ROWS`` allows, then enough splits of the keys that the grid
    has about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, but no
    more than one split per ``TILES_A_SPLIT`` tiles (:func:`tile_keys`)
    that a slot can reach: the whole row, or with a window the tiles that
    ``window + rows_per_slot - 1`` keys can straddle. A split costs a
    partial and its merge; a few tiles a block are cheaper walked than
    merged."""
    groups = -(-r // (INT8_ROWS[d] if int8 and window <= 0 else MAX_ROWS[d]))
    rows_per_block = -(-r // groups)
    base = b * hkv * groups
    tile = tile_keys(int8, window)
    reach = -(-t // tile)
    if window > 0:
        reach = min(reach, -(-(window + rows_per_slot - 1) // tile) + 1)
    nsplit = max(1, min(reach // TILES_A_SPLIT, -(-BLOCKS_PER_SM * sms // base)))
    return rows_per_block, nsplit


def _check(q, k, v, positions, k_scale, v_scale, rows_per_slot, sinks=None) -> None:
    """What the kernel takes: shapes, device, dtype, layout, alignment."""
    b, hkv, r, d = q.shape
    if rows_per_slot < 1 or r % rows_per_slot:
        raise ValueError(f"flash_decode: {r} query rows are not G x rows_per_slot={rows_per_slot}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (b, hkv) or k.shape[3] != d:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs cache {tuple(k.shape)}/{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} not in the kernel's {HEAD_DIMS}")
    if positions.shape != (b,) or positions.dtype != torch.int32:
        raise ValueError(f"flash_decode: positions must be int32 [{b}], got {positions.dtype} {tuple(positions.shape)}")
    cache_dtype = torch.bfloat16 if k_scale is None else torch.int8
    tensors = [("q", q, torch.bfloat16), ("k", k, cache_dtype), ("v", v, cache_dtype),
               ("positions", positions, torch.int32)]
    if k_scale is not None:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != k.shape[:3]:
                raise ValueError(f"flash_decode: {name} {tuple(s.shape)} is not [B, Hkv, T] {tuple(k.shape[:3])}")
            tensors.append((name, s, torch.float32))
    if sinks is not None:
        tensors.append(("sinks", sinks, torch.float32))
    for name, t, dtype in tensors:
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"flash_decode: {name} is {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")


def flash_decode(
    q: torch.Tensor,  # [B, Hkv, R, D], R = G * rows_per_slot
    k: torch.Tensor,  # [B, Hkv, T, D] cache (one layer): bf16, or int8 with k_scale
    v: torch.Tensor,
    positions: torch.Tensor,  # [B] int32
    *,
    scale: float,
    window: int = 0,  # 0 = full attention
    softcap: float = 0.0,
    sinks: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, T] f32
    v_scale: Optional[torch.Tensor] = None,
    rows_per_slot: int = 1,
) -> torch.Tensor:
    """GQA attention of each slot's newest query rows over the cache →
    [B, Hkv, R, D]. Ragged: slot b reads only keys
    ``0 .. positions[b] + rows_per_slot - 1``. With ``rows_per_slot=S``
    (speculative verify) the rows are ``[G, S]`` flattened row-major and
    row ``g*S + s`` attends to keys ``<= positions[b] + s``. ``sinks``
    [Hkv, R] f32 gives each query row its sink logit (the engine expands
    the per-head leaf so that row g*S + s carries group g's sink), as
    the JAX ``flash_decode`` takes it."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: k_scale and v_scale come together")
    if sinks is not None and tuple(sinks.shape) != tuple(q.shape[1:3]):
        raise ValueError(f"flash_decode: sinks {tuple(sinks.shape)} are not [Hkv, R] {tuple(q.shape[1:3])}")
    window = int(window or 0)
    rows_per_slot = int(rows_per_slot)
    kw = dict(scale=scale, window=window, softcap=softcap, k_scale=k_scale, v_scale=v_scale,
              rows_per_slot=rows_per_slot, sinks=sinks)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, positions, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check(q, k, v, positions, k_scale, v_scale, rows_per_slot, sinks)
    b, hkv, r, d = q.shape
    t = k.shape[2]
    rows_per_block, nsplit = decode_plan(
        b, hkv, r, t, d, window, rows_per_slot, k_scale is not None,
        torch.cuda.get_device_properties(q.device).multi_processor_count,
    )
    o = torch.empty_like(q)
    # the f32 partials in one allocation: acc [B, Hkv, nsplit, R, D], m, l
    # [B, Hkv, nsplit, R]; freed after the enqueue, reused in stream order
    ws = [None, None, None]
    if nsplit > 1:
        n = b * hkv * nsplit * r
        buf = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
        ws = [buf.data_ptr() + 4 * n * off for off in (0, d, d + 1)]
    quant = k_scale is not None
    err = _lib().dtpu_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        positions.data_ptr(), o.data_ptr(),
        b, hkv, r, rows_per_slot, t, d, float(scale), window, float(softcap or 0.0),
        sinks.data_ptr() if sinks is not None else None,
        rows_per_block, nsplit, *ws,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(err, "flash_decode")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[
        ("int8" if quant else "bf16") + ("_verify" if rows_per_slot > 1 else "_decode")
        + ("_sinks" if sinks is not None else "")
    ] += 1
    return o


def flash_decode_supported(config, max_seq: int) -> bool:
    """Whether the engine may route decode attention through the kernel
    for this model: not MLA (its decode attends over the latent row, with
    no K4 form in either package), no chunked attention (Llama4: neither
    package's kernel takes a chunk mask; JAX's check at
    dstack_tpu/ops/flash_decode.py:283), a compiled head width and whole
    GQA groups. Any number of query rows a KV head and any ``max_seq``
    work (the kernel masks a ragged last tile)."""
    return (
        not config.mla
        and not config.attention_chunk_size
        and config.head_dim in HEAD_DIMS
        and config.n_heads % config.n_kv_heads == 0
        and max_seq > 0
    )
