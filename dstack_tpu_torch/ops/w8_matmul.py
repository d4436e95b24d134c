"""Weight-only int8 products: the hand-written Hopper kernel (W8) and its
plain PyTorch version.

Source note. The kernel (``csrc/w8_matmul.cu``) replaces no Pallas
kernel. The JAX package takes every product of an int8 weight as
``einsum(x, q.astype(bf16)) * s`` (``_proj``, dstack_tpu/models/
llama.py:1117-1122; ``head_logits_einsum``, :1410-1415; the expert stacks,
dstack_tpu/models/moe.py:209-232), and XLA folds the cast into the dot,
so the device reads each weight byte once. In PyTorch the same code
reads 1 byte a weight, writes a 2-byte bf16 copy and reads it back: 5
bytes against bf16's 2, so int8 weights would decode about 2.5x slower
than bf16 ones. W8 reads the int8 weight once and converts it on the
chip. It is bound by the weight bytes at decode (8 to 40 rows) and by
FLOPs at chunk sizes, and has a form for each: the byte-streaming form
(mma.sync) up to ``STREAM_MAX_M`` rows, the chunk form (wgmma on the
swapped product) above, each fed by a TMA ring. ``w8_plan`` picks
the form and the split over K from the shapes and the SM count alone; the
kernel's note says what each design does.

Three forms, one kernel:

- ``w8_proj``: x [..., K] bf16 times q [K, N] int8, the f32 sum rounded
  to bf16, times bf16(s [N]), rounded to bf16 (``_proj``);
- ``w8_head``: the same sum times the f32 ``lm_head_s``, f32 [..., N]
  with no bf16 rounding (``head_logits_einsum``);
- ``w8_experts``: batched over E, x [E, M, K], q [E, K, N], s [E, N],
  bf16 (the expert stacks; the scale before any expert bias).

Each wrapper takes the plain version only for a CPU tensor. On a CUDA
tensor it launches the kernel or raises: no int8 product on the card
goes through ``torch.matmul``. Under autograd every form raises: the
JAX package trains no int8 tree.
"""

import ctypes
from typing import NamedTuple

import torch

from dstack_tpu_torch.ops import cuda_build

# the grid of each form (csrc/w8_matmul.cu)
BK = 64  # k rows a ring stage
STREAM_MAX_M = 16  # the byte-streaming form takes M up to this, the chunk form above
STREAM_ROWS, STREAM_BN = 16, 256  # rows of x and output columns a block, byte-streaming form
CHUNK_ROWS, CHUNK_BN = 128, 256  # the same, chunk form (CHUNK_BN // 2 with paired k tiles)
# the split over K, where a form's output tiles leave SMs idle: as many
# splits as keep the launch to one block an SM, but at least this many k
# tiles a split (a split's f32 partial is written and read back; the
# chunk form's, 128 x 256, costs more). At the shapes chip_smoke.py times,
# a second block an SM or shorter splits measured slower
# (tools/torch_w8_plans.py times each plan beside its neighbours)
STREAM_MIN_KTILES = 8
CHUNK_MIN_KTILES = 32
ARRIVALS = 4096  # output tiles a launch that splits may have (the kernel's counters)
FORMS = ("proj", "head", "experts")

# kernel launches since the counts were last set to 0 (the plain version
# never counts): chip_smoke.py reads them to prove the int8 paths ran W8,
# in total and by form
LAUNCHES = 0
LAUNCHES_BY_FORM = {form: 0 for form in FORMS}

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("w8_matmul")
    fn = lib.dtpu_w8_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _c_void, _c_void, _c_void, _c_void, _c_void,  # x q s out ws
            _c_int, _c_int, _c_int, _c_int,  # E M K N
            _c_int, _c_int, _c_int, _c_int, _c_int,  # rows cols splits ktiles_per_split epilogue
            _c_void,  # stream
        ]
        lib.dtpu_w8_arrivals.restype = ctypes.c_int
        lib.dtpu_w8_arrivals.argtypes = [_c_void, _c_void]
    return lib


def arrival_counts(device=None) -> torch.Tensor:
    """The kernel's split counters on ``device`` (int32 [ARRIVALS], read
    in stream order): all 0 between launches, since the last split of
    each output tile sets its counter back."""
    out = torch.empty(ARRIVALS, dtype=torch.int32, device=device or "cuda")
    err = _lib().dtpu_w8_arrivals(out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    cuda_build.check(err, "w8_matmul arrivals")
    return out


def _refuse_autograd(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "int8 weights serve only: no gradient flows through an int8 "
            "product (the JAX package trains no int8 tree)"
        )


def w8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, form: str = "proj") -> torch.Tensor:
    """JAX's cast, product and scale in torch: ``x · q.to(x.dtype)`` (f32
    accumulation), then for ``proj``/``experts`` the result in x's dtype
    times ``s`` cast to it, for ``head`` the f32 product (exact upcast on
    the CPU, ``torch.mm(..., out_dtype=f32)`` on the card) times f32
    ``s``. Shapes as the wrapper of each form takes them."""
    if form == "head":
        if x.device.type == "cpu" or x.dtype == torch.float32:
            y = torch.matmul(x.float(), q.float())
        else:
            y = torch.mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype), out_dtype=torch.float32)
            y = y.reshape(*x.shape[:-1], q.shape[-1])
        return y * s.float()
    y = torch.matmul(x, q.to(x.dtype))
    scale = s.to(y.dtype)
    return y * (scale[:, None, :] if form == "experts" else scale)


class W8Plan(NamedTuple):
    """A launch's grid: ``rows`` of x and ``cols`` output columns a block
    (16 x 256: the byte-streaming form; 128 x 256: the chunk form, whose
    two consumer warpgroups own 128 columns each; 128 x 128: the chunk
    form with both warpgroups on one 128-column tile, taking alternate k
    tiles), ``splits`` of the K tiles and ``per`` tiles a split (the last
    split may have fewer, none is empty)."""

    rows: int
    cols: int
    splits: int
    per: int


def w8_plan(e: int, m: int, k: int, n: int, sms: int = 132) -> W8Plan:
    """The kernel's grid from shapes alone: the form by M (the chunk form
    above ``STREAM_MAX_M`` rows); in the chunk form, 128-column tiles
    with paired k tiles where twice its 256-column tiles still fit the
    SMs (a narrow N: llama-3-70b's wk and wv); then, where the output
    tiles number fewer than the ``sms`` SMs, the split over K into as
    many parts as keep every block of the launch on an SM of its own (one
    wave) with at least ``STREAM_MIN_KTILES`` (``CHUNK_MIN_KTILES``) k
    tiles each. No split is empty."""
    chunk = m > STREAM_MAX_M
    rows = CHUNK_ROWS if chunk else STREAM_ROWS
    cols = CHUNK_BN if chunk else STREAM_BN
    tiles = e * -(-m // rows) * -(-n // cols)
    if chunk and 2 * tiles <= sms:
        cols = CHUNK_BN // 2
        tiles = e * -(-m // rows) * -(-n // cols)
    ktiles = -(-k // BK)
    splits = max(1, min(sms // tiles, ktiles // (CHUNK_MIN_KTILES if chunk else STREAM_MIN_KTILES)))
    per = -(-ktiles // splits)
    return W8Plan(rows, cols, -(-ktiles // per), per)


def _check(x, q, s, e: int, k: int, n: int) -> None:
    """What the kernel takes: types, devices, layout, alignment, widths."""
    if k % 8 or n % 16:
        raise ValueError(f"w8_matmul: K={k} must be a multiple of 8 and N={n} of 16 (whole 16-byte copies)")
    for name, t, dtype in (("x", x, torch.bfloat16), ("q", q, torch.int8), ("s", s, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"w8_matmul: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"w8_matmul: {name} is {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"w8_matmul: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"w8_matmul: {name} must be 16-byte aligned")
    if tuple(s.shape) != ((e, n) if q.dim() == 3 else (n,)):
        raise ValueError(f"w8_matmul: scales {tuple(s.shape)} do not match q {tuple(q.shape)}")


def _launch(form: str, x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """One launch of the kernel on x2 [E * M, K] → [E, M, N] (bf16, or f32
    for the head); a split plan's combine runs in the same launch."""
    k, n = q.shape[-2], q.shape[-1]
    _check(x2, q, s, e, k, n)
    rows, cols, splits, per = w8_plan(e, m, k, n, torch.cuda.get_device_properties(x2.device).multi_processor_count)
    head = form == "head"
    out = torch.empty((e, m, n), dtype=torch.float32 if head else torch.bfloat16, device=x2.device)
    # the f32 partials; freed after the enqueue, reused in stream order
    ws = torch.empty(splits * e * m * n, dtype=torch.float32, device=x2.device) if splits > 1 else None
    err = _lib().dtpu_w8_matmul(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        e, m, k, n, rows, cols, splits, per, 1 if head else 0,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    cuda_build.check(err, f"w8_matmul ({form})")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_FORM[form] += 1
    return out


def _dense(form: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _refuse_autograd(x)
    if x.device.type == "cpu":
        return w8_matmul_plain(x, q, s, form)
    if x.device.type != "cuda":
        raise ValueError(f"w8_matmul: no kernel for device {x.device}")
    if q.dim() != 2 or x.shape[-1] != q.shape[0]:
        raise ValueError(f"w8_matmul: x {tuple(x.shape)} vs q {tuple(q.shape)}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _launch(form, x2, q, s, 1, x2.shape[0])
    return out.view(*x.shape[:-1], q.shape[1])


def w8_proj(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [..., K] · int8 q [K, N], scaled by s [N] → [..., N] in x's dtype
    (``_proj``'s int8 branch)."""
    return _dense("proj", x, q, s)


def w8_head(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Hidden [..., E] · int8 ``lm_head_q`` [E, V] times f32 ``lm_head_s``
    → f32 logits [..., V] (``head_logits_einsum``'s int8 branch)."""
    return _dense("head", x, q, s)


def w8_experts(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Expert rows x [E, M, K] · int8 stacks q [E, K, N], each output
    channel scaled by s [E, N] → [E, M, N] in x's dtype (moe.py's
    ``qw`` products)."""
    _refuse_autograd(x)
    if x.device.type == "cpu":
        return w8_matmul_plain(x, q, s, "experts")
    if x.device.type != "cuda":
        raise ValueError(f"w8_matmul: no kernel for device {x.device}")
    if q.dim() != 3 or x.dim() != 3 or x.shape[0] != q.shape[0] or x.shape[2] != q.shape[1]:
        raise ValueError(f"w8_matmul: x {tuple(x.shape)} vs q {tuple(q.shape)}")
    return _launch("experts", x.contiguous(), q, s, x.shape[0], x.shape[1])
