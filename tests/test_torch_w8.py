"""W8, the port's int8-weight product (``ops/w8_matmul.py``,
``csrc/w8_matmul.cu``): its split plan and its plain version on the CPU,
and the kernel against the plain version on the card.

The plain version is JAX's cast, product and scale; its parity with the
JAX package's ``_proj``, ``head_logits_einsum`` and expert products is held
in tests/test_torch_quant.py (this file imports no JAX, so that its card
tests run anywhere the port does). The ``cuda``-marked tests hold the
kernel under both of chip_smoke.py's rules (element-wise within atol =
rtol = 2e-2, and within 1e-2 relative RMS over every tile of 32 rows) at
the decode, verify, chunk and packed-wave row counts, at a K and an N that
are not multiples of the tile, in its head and expert forms, bit-identical
from run to run, and replayed from a CUDA graph; they skip where there is
no card.
"""

import math

import pytest
import torch

from dstack_tpu_torch.ops import w8_matmul as w8


def _inputs(e, m, k, n, device="cpu", seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(seed)
    lead = (e,) if e else ()
    x = torch.randn(*lead, m, k, generator=g, device=device).to(dtype)
    q = torch.randint(-127, 128, (*lead, k, n), generator=g, device=device, dtype=torch.int8)
    s = (0.8 + 0.4 * torch.rand(*lead, n, generator=g, device=device)) * (0.02 / 127)
    return x, q, s


# ---------------------------------------------------------------------------
# the plan (host ints only) and the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e, m, k, n", [
    (1, 8, 8192, 1024), (1, 8, 8192, 8192), (1, 8, 8192, 28672), (1, 40, 8192, 1024),
    (1, 256, 8192, 1024), (1, 1024, 8192, 28672), (8, 8, 4096, 14336), (1, 1, 200, 1008),
    (1, 8, 2048, 128256), (64, 8, 2048, 1408),
])
def test_plan_covers_every_k_tile_once(e, m, k, n):
    mtiles, splits, per = w8.w8_plan(e, m, k, n)
    ktiles = -(-k // w8.BK)
    assert mtiles == (1 if m <= 16 else 4)
    assert splits * per >= ktiles and (splits - 1) * per < ktiles  # no empty split
    assert e * splits <= 65535
    blocks = -(-m // (16 * mtiles)) * -(-n // w8.BN) * e
    if blocks >= 132:
        assert splits == 1
    else:
        assert splits == 1 or per >= w8.KTILES_A_SPLIT


def test_plan_splits_a_short_grid():
    # wk of llama-3-70b at decode: 8 column tiles would leave 124 SMs idle
    assert w8.w8_plan(1, 8, 8192, 1024)[1] >= 16
    assert w8.w8_plan(1, 8, 8192, 28672)[1] == 1


@pytest.mark.parametrize("form", ["proj", "experts", "head"])
def test_plain_rounds_as_jax(form):
    """proj/experts: the bf16 product rounded, times bf16(s), rounded; head:
    the f32 product times f32 s, with no bf16 rounding."""
    e = 3 if form == "experts" else 0
    x, q, s = _inputs(e, 5, 64, 48)
    got = w8.w8_matmul_plain(x, q, s, form)
    acc = torch.matmul(x.double(), q.double())
    if form == "head":
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, (acc * s.double()).float(), atol=1e-6, rtol=1e-5)
        return
    scale = s.to(torch.bfloat16).double()
    want = (acc.to(torch.bfloat16).double() * (scale[:, None, :] if e else scale)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # the CPU's bf16 product rounds its f32 sum once: a rare ulp apart
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    x, q, s = _inputs(0, 4, 32, 16)
    before = dict(w8.LAUNCHES_BY_FORM), w8.LAUNCHES
    torch.testing.assert_close(w8.w8_proj(x[None], q, s)[0], w8.w8_matmul_plain(x, q, s), atol=0, rtol=0)
    torch.testing.assert_close(w8.w8_head(x, q, s), w8.w8_matmul_plain(x, q, s, "head"), atol=0, rtol=0)
    xe, qe, se = _inputs(2, 4, 32, 16)
    torch.testing.assert_close(w8.w8_experts(xe, qe, se), w8.w8_matmul_plain(xe, qe, se, "experts"), atol=0, rtol=0)
    assert (dict(w8.LAUNCHES_BY_FORM), w8.LAUNCHES) == before


def test_autograd_is_refused():
    x, q, s = _inputs(0, 4, 32, 16, dtype=torch.float32)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="serve only"):
        w8.w8_proj(x, q, s)
    with torch.no_grad():
        w8.w8_proj(x, q, s)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _close(got, want):
    from chip_smoke import tile_rel_rms

    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    g, w = got.float(), want.float()
    if g.dim() == 2:
        g, w = g[None], w[None]
    assert tile_rel_rms(g[:, None], w[:, None]) <= 1e-2


@pytest.mark.cuda
class TestW8OnTheCard:
    @pytest.mark.parametrize("m", [1, 8, 40, 256, 1024])
    @pytest.mark.parametrize("k, n", [(2048, 2048), (2048, 512), (8192, 1024), (200, 1008)])
    def test_proj_matches_plain(self, cuda, m, k, n):
        x, q, s = _inputs(0, m, k, n, cuda, seed=m + k)
        before = w8.LAUNCHES_BY_FORM["proj"]
        got = w8.w8_proj(x, q, s)
        want = w8.w8_matmul_plain(x, q, s)
        torch.cuda.synchronize()
        assert w8.LAUNCHES_BY_FORM["proj"] == before + 1
        assert got.shape == (m, n) and got.dtype == torch.bfloat16
        _close(got, want)
        torch.testing.assert_close(w8.w8_proj(x, q, s), got, atol=0, rtol=0)  # same bits again

    @pytest.mark.parametrize("m", [8, 40, 256])
    def test_head_matches_plain(self, cuda, m):
        x, q, s = _inputs(0, m, 2048, 128256, cuda, seed=m)
        got = w8.w8_head(x, q, s)
        want = w8.w8_matmul_plain(x, q, s, "head")
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (m, 128256)
        _close(got, want)

    # mixtral-8x7b's decode (M = 8) and prefill (M = 24 and 80: a partial
    # 64-row tile after none or one whole one; 320: a packed wave) stacks
    @pytest.mark.parametrize("e, m, k, n", [(8, 8, 4096, 14336), (8, 8, 14336, 4096), (8, 64, 4096, 1008),
                                            (64, 8, 2048, 1408), (8, 24, 14336, 4096), (8, 80, 4096, 14336),
                                            (8, 80, 14336, 4096), (8, 320, 4096, 14336)])
    def test_experts_match_plain(self, cuda, e, m, k, n):
        x, q, s = _inputs(e, m, k, n, cuda, seed=e + m)
        got = w8.w8_experts(x, q, s)
        want = w8.w8_matmul_plain(x, q, s, "experts")
        torch.cuda.synchronize()
        assert got.shape == (e, m, n)
        _close(got, want)

    def test_a_leading_batch_reshapes(self, cuda):
        x, q, s = _inputs(0, 24, 512, 256, cuda)
        got = w8.w8_proj(x.view(2, 3, 4, 512), q, s)
        _close(got.view(24, 256), w8.w8_matmul_plain(x, q, s))

    def test_replays_from_a_cuda_graph(self, cuda):
        """One decode-shaped launch (split plan) captured and replayed: no
        host sync inside, new inputs read in place, the count bumped by
        the capture only."""
        x, q, s = _inputs(0, 8, 8192, 1024, cuda)
        assert w8.w8_plan(1, 8, 8192, 1024)[1] > 1
        w8.w8_proj(x, q, s)  # builds and loads outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = w8.LAUNCHES
        with torch.cuda.graph(graph):
            out = w8.w8_proj(x, q, s)
        assert w8.LAUNCHES == before + 1
        x.copy_(torch.randn_like(x.float()).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        _close(out, w8.w8_matmul_plain(x, q, s))
        assert w8.LAUNCHES == before + 1

    def test_refuses_what_it_does_not_take(self, cuda):
        x, q, s = _inputs(0, 8, 200, 1008, cuda)
        with pytest.raises(ValueError, match="N=1000 of 16"):
            w8.w8_proj(x[:, :200], q[:, :1000], s[:1000])
        with pytest.raises(TypeError, match="bfloat16"):
            w8.w8_proj(x.float(), q, s)
        assert math.isfinite(float(w8.w8_proj(x, q, s).float().sum()))
