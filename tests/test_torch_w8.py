"""W8, the port's int8-weight product (``ops/w8_matmul.py``,
``csrc/w8_matmul.cu``): its plan (the form, the tile width, the split
over K) and its plain version on the CPU, and the kernel against the
plain version on the card.

The plain version is JAX's cast, product and scale; its parity with the
JAX package's ``_proj``, ``head_logits_einsum`` and expert products is held
in tests/test_torch_quant.py (this file imports no JAX, so that its card
tests run anywhere the port does). The ``cuda``-marked tests hold the
kernel under both of chip_smoke.py's rules (element-wise within atol =
rtol = 2e-2, and within 1e-2 relative RMS over every tile of 32 rows) at
the decode, verify, chunk and packed-wave row counts, at a K and an N that
are not multiples of the tile and on each side of its tiles, in its head
and expert forms, bit-identical from run to run at split and chunk
plans, and replayed from a CUDA graph with its split counters back at 0;
they skip where there is no card.
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


PLAN_SHAPES = [
    (1, 8, 8192, 1024), (1, 8, 8192, 8192), (1, 8, 8192, 28672), (1, 40, 8192, 1024),
    (1, 256, 8192, 1024), (1, 1024, 8192, 28672), (8, 8, 4096, 14336), (1, 1, 200, 1008),
    (1, 8, 2048, 128256), (64, 8, 2048, 1408), (1, 64, 8192, 28672), (1, 65, 8192, 28672),
    (8, 80, 14336, 4096), (8, 320, 4096, 14336), (1, 256, 8200, 1008), (1, 8, 28672, 8192),
]
# the decode and verify shapes of chip_smoke.py (llama-3-70b, its head,
# mixtral-8x7b's experts, the odd K and N) and llama-3.2-1b's
DECODE_SHAPES = [
    (1, 8, 8192, 8192), (1, 8, 8192, 1024), (1, 8, 8192, 28672), (1, 8, 28672, 8192), (1, 1, 8192, 28672),
    (1, 40, 8192, 28672), (1, 8, 8200, 1008), (1, 8, 8192, 128256), (1, 40, 8192, 128256),
    (8, 8, 4096, 14336), (8, 8, 14336, 4096), (8, 40, 4096, 14336), (8, 24, 14336, 4096),
    (64, 8, 2048, 1408), (1, 8, 2048, 2048), (1, 8, 2048, 8192), (1, 8, 8192, 2048),
]


def _tiles(plan, e, m, n):
    return e * -(-m // plan.rows) * -(-n // plan.cols)


def _min_ktiles(plan):
    return w8.CHUNK_MIN_KTILES if plan.rows == w8.CHUNK_ROWS else w8.STREAM_MIN_KTILES


@pytest.mark.parametrize("e, m, k, n", PLAN_SHAPES)
def test_plan_covers_every_k_tile_once(e, m, k, n):
    plan = w8.w8_plan(e, m, k, n)
    rows, cols, splits, per = plan
    ktiles = -(-k // w8.BK)
    assert rows == (w8.STREAM_ROWS if m <= w8.STREAM_MAX_M else w8.CHUNK_ROWS)
    # 128-column paired-k tiles only in the chunk form, where 256-column ones would leave half the SMs idle
    assert cols == w8.CHUNK_BN // 2 if rows == w8.CHUNK_ROWS and 2 * e * -(-m // rows) * -(-n // 256) <= 132 else cols == 256
    assert splits * per >= ktiles and (splits - 1) * per < ktiles  # no empty split
    assert e * splits <= 65535
    if splits > 1:
        assert _tiles(plan, e, m, n) <= w8.ARRIVALS  # one counter an output tile
        assert per >= _min_ktiles(plan)  # splits of at least the minimum (the last may be shorter)


def test_plan_splits_a_short_grid():
    # wk of llama-3-70b at decode: 4 column tiles would leave 128 SMs idle
    assert w8.w8_plan(1, 8, 8192, 1024).splits >= 16
    # w_gate's 112 column tiles and the head's 501 take no split
    assert w8.w8_plan(1, 8, 8192, 28672).splits == 1
    assert w8.w8_plan(1, 8, 8192, 128256).splits == 1


def test_plan_pairs_k_tiles_on_a_narrow_chunk():
    """llama-3-70b's wk at a 256-token chunk has 8 tiles of 256 columns:
    the chunk form takes 128-column tiles with paired k tiles instead;
    w_gate's 224 tiles keep 256 columns."""
    assert w8.w8_plan(1, 256, 8192, 1024).cols == 128
    assert w8.w8_plan(1, 256, 8192, 28672).cols == 256
    assert w8.w8_plan(1, 8, 8192, 1024).cols == 256  # the byte-streaming form has one tile width


@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, 64, 65, 80, 128, 129, 256, 320, 1024, 2048])
def test_plan_picks_the_chunk_form_above_the_threshold(m):
    """The byte-streaming form (16 rows a block, mma.sync) up to
    STREAM_MAX_M rows, the chunk form (128 rows, wgmma) above, whatever
    the rest of the shape: decode (M = 1 and 8) streams, verify (40) and
    every chunk take wgmma."""
    for e, k, n in ((1, 8192, 28672), (1, 8192, 1024), (8, 4096, 14336), (1, 8200, 1008)):
        rows = w8.w8_plan(e, m, k, n).rows
        assert rows == (w8.CHUNK_ROWS if m > w8.STREAM_MAX_M else w8.STREAM_ROWS)
        assert (rows == w8.STREAM_ROWS) == (m <= 16)


@pytest.mark.parametrize("e, m, k, n", DECODE_SHAPES)
def test_plan_fills_whole_waves_at_decode(e, m, k, n):
    """At decode and verify a launch that splits runs in one wave, at most
    one block an SM, and splits as far as that wave and the minimum k
    tiles a split allow; where the weight is large (an even spread is 32
    k tiles an SM or more) the busiest of the 132 SMs streams at most 20 %
    more k tiles than an even spread would give it."""
    plan = w8.w8_plan(e, m, k, n)
    tiles, ktiles = _tiles(plan, e, m, n), -(-k // w8.BK)
    blocks = tiles * plan.splits
    assert plan.splits == 1 or blocks <= 132
    if plan.splits > 1:
        assert plan.per >= _min_ktiles(plan)
    finer = -(-ktiles // (plan.per - 1)) if plan.per > 1 else ktiles + 1  # the next finer split's count
    assert tiles * finer > 132 or ktiles // finer < _min_ktiles(plan)
    busiest, even = -(-blocks // 132) * plan.per, tiles * ktiles / 132
    if even >= 32:
        assert busiest <= 1.2 * even


def test_plan_counts_the_sms():
    """A card with fewer SMs gets a grid of its own: the plan reads the SM
    count and nothing else beside the shapes."""
    assert w8.w8_plan(1, 8, 8192, 8192, sms=132) == w8.w8_plan(1, 8, 8192, 8192)
    assert w8.w8_plan(1, 8, 8192, 8192, sms=66).splits < w8.w8_plan(1, 8, 8192, 8192, sms=132).splits
    assert w8.w8_plan(1, 8, 8192, 28672, sms=264).splits == 2


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

    # each side of the byte-streaming form's 16-row tile and of the chunk
    # form's 128-row tiles, at a K and an N that are whole tiles and
    # at the odd ones (K 8200: a partial k tile; N 1008: a partial 128- and
    # 256-column tile)
    @pytest.mark.parametrize("m", [15, 16, 17, 64, 65, 128, 129, 256, 320, 1024])
    @pytest.mark.parametrize("k, n", [(4096, 2048), (8200, 1008)])
    def test_tile_boundaries_match_plain(self, cuda, m, k, n):
        x, q, s = _inputs(0, m, k, n, cuda, seed=m)
        got = w8.w8_proj(x, q, s)
        torch.cuda.synchronize()
        assert got.shape == (m, n)
        _close(got, w8.w8_matmul_plain(x, q, s))
        _close(w8.w8_head(x, q, s), w8.w8_matmul_plain(x, q, s, "head"))

    # mixtral's expert rows at prefill (24 and 80: a partial 128-row tile;
    # 320: two whole ones and a partial one) at the odd K and N
    @pytest.mark.parametrize("m", [24, 80, 320])
    def test_experts_at_odd_shapes_match_plain(self, cuda, m):
        x, q, s = _inputs(3, m, 8200, 1008, cuda, seed=m)
        got = w8.w8_experts(x, q, s)
        torch.cuda.synchronize()
        _close(got, w8.w8_matmul_plain(x, q, s, "experts"))

    # a byte-streaming split plan, a chunk split plan with paired k tiles,
    # paired k tiles unsplit, an expert split plan, and an unsplit chunk
    # plan of 256-column tiles
    @pytest.mark.parametrize("e, m, k, n", [(1, 8, 8192, 1024), (1, 256, 8192, 1024), (1, 256, 2048, 2048),
                                            (8, 80, 4096, 1024), (1, 256, 2048, 28672)])
    def test_two_launches_are_bit_identical(self, cuda, e, m, k, n):
        x, q, s = _inputs(e if e > 1 else 0, m, k, n, cuda, seed=3)
        plan = w8.w8_plan(e, m, k, n)
        assert (plan.rows == w8.CHUNK_ROWS) == (m > w8.STREAM_MAX_M)
        fn = w8.w8_experts if e > 1 else w8.w8_proj
        a, b = fn(x, q, s), fn(x, q, s)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        _close(a, w8.w8_matmul_plain(x, q, s, "experts" if e > 1 else "proj"))

    @pytest.mark.parametrize("m", [8, 256])
    def test_split_counters_are_0_after_a_launch_and_a_replay(self, cuda, m):
        """The last split of each output tile sets its counter back to 0:
        after eager launches, and after each replay of a captured one (a
        replay has no memset)."""
        x, q, s = _inputs(0, m, 8192, 1024, cuda, seed=m)
        assert w8.w8_plan(1, m, 8192, 1024).splits > 1
        w8.w8_proj(x, q, s)
        assert int(w8.arrival_counts().abs().sum()) == 0
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = w8.w8_proj(x, q, s)
        for _ in range(3):
            x.copy_(torch.randn_like(x.float()).bfloat16())
            graph.replay()
            torch.cuda.synchronize()
            assert int(w8.arrival_counts().abs().sum()) == 0
            _close(out, w8.w8_matmul_plain(x, q, s))

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
