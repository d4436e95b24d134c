"""One AdamW step on int8 log-grid moments: the hand-written Hopper
kernel (A8) and its wrapper.

Source note. The kernel (``csrc/adam8.cu``) replaces no Pallas kernel.
The JAX package writes 8-bit Adam as plain ``jnp`` code
(``scale_by_adam8``'s ``per_leaf``, dstack_tpu/train/opt8.py:96-128) and
XLA fuses the decode, the update and the encode into one pass over each
leaf; that fusion is the point of int8 moments. A8 is that pass: in one
launch over a quantized leaf it reads the gradient, the parameter and
both moments' codes and scales, decodes the moments, applies JAX's
update, writes the parameter, re-encodes both moments (a new absmax a
256-element block) and writes their codes and scales. It is bound by
bytes: 10.06 an element for bf16 parameters (g and p read, p written,
two code bytes read and written, the scales). The clip, the bias
corrections and the step size come in as device scalars
(``train.opt8.adam8_scalars``), so no host value is read around it.

The plain version is ``train.opt8.adam8_update_plain``; the wrapper takes
it only for a tensor on the CPU. On a CUDA tensor it launches the kernel
or raises.
"""

import ctypes

import torch

from dstack_tpu_torch.ops import cuda_build
from dstack_tpu_torch.train.opt8 import BLOCK, N_SCALARS, adam8_update_plain

WARPS = 8  # 256-element blocks a thread block of the kernel: one a warp

# kernel launches since the count was last set to 0 (the plain version
# never counts): chip_smoke.py reads it to prove the opt8 steps ran A8
LAUNCHES = 0

_c_void = ctypes.c_void_p
_c_float = ctypes.c_float


def _lib():
    fn = cuda_build.load("adam8").dtpu_adam8
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_c_void] * 7 + [ctypes.c_longlong, ctypes.c_int] + [_c_float] * 6 + [_c_void]
    return fn


def bytes_moved(p: torch.Tensor) -> int:
    """What one update of a quantized leaf must move: g and p read, p
    written, each moment's codes read and written, each moment's scales
    read and written."""
    n = p.numel()
    return 3 * n * p.element_size() + 4 * n + 4 * 4 * (n // BLOCK)


def _check(p, g, mu_q, mu_s, nu_q, nu_s, scalars) -> None:
    if p.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"adam8: parameter dtype {p.dtype}; the kernel takes bfloat16 or float32")
    if p.dim() < 1 or p.shape[-1] % BLOCK:
        raise ValueError(f"adam8: last dim of {tuple(p.shape)} not a multiple of {BLOCK}")
    blocks = (*p.shape[:-1], p.shape[-1] // BLOCK)
    for name, t, dtype, shape in (("g", g, p.dtype, p.shape), ("mu_q", mu_q, torch.int8, p.shape),
                                  ("nu_q", nu_q, torch.int8, p.shape), ("mu_s", mu_s, torch.float32, blocks),
                                  ("nu_s", nu_s, torch.float32, blocks),
                                  ("scalars", scalars, torch.float32, (N_SCALARS,))):
        if t.device != p.device:
            raise ValueError(f"adam8: {name} on {t.device}, p on {p.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"adam8: {name} is {t.dtype} {tuple(t.shape)}; want {dtype} {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adam8: {name} must be contiguous")
    for name, t in (("p", p), ("g", g), ("mu_q", mu_q), ("nu_q", nu_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"adam8: {name} must be 16-byte aligned (vector loads)")
    if not p.is_contiguous():
        raise ValueError("adam8: p must be contiguous")


def adam8_update(
    p: torch.Tensor, g: torch.Tensor, mu_q: torch.Tensor, mu_s: torch.Tensor, nu_q: torch.Tensor,
    nu_s: torch.Tensor, scalars: torch.Tensor, *, b1: float, b2: float, eps: float, weight_decay: float,
) -> None:
    """One AdamW step of a quantized leaf, in place: ``p`` (bf16 or f32
    [..., D], D a multiple of 256), the int8 codes ``mu_q``/``nu_q`` like
    p, their f32 scales [..., D/256], from the gradient ``g`` (p's dtype)
    and the f32 [5] device ``scalars`` of ``train.opt8.adam8_scalars``.
    A CPU tensor takes the plain version; a CUDA tensor one launch of A8."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p.device.type == "cpu":
        for dst, src in zip((p, mu_q, mu_s, nu_q, nu_s),
                            adam8_update_plain(p, g, mu_q, mu_s, nu_q, nu_s, scalars, **kw)):
            dst.copy_(src)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam8: no kernel for device {p.device}")
    _check(p, g, mu_q, mu_s, nu_q, nu_s, scalars)
    err = _lib()(
        p.data_ptr(), g.data_ptr(), mu_q.data_ptr(), mu_s.data_ptr(), nu_q.data_ptr(), nu_s.data_ptr(),
        scalars.data_ptr(), p.numel() // BLOCK, 1 if p.dtype == torch.bfloat16 else 0,
        b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    cuda_build.check(err, "adam8")
    global LAUNCHES
    LAUNCHES += 1
