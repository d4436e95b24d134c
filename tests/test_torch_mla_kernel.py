"""K1's absorbed-MLA entry (``flash_mla_with_lse``) on the CPU.

The Hopper kernel (``csrc/flash_fwd_mla.cu``) reads the value as the first
``rank`` columns of the latent row it reads as the key, packs the query
heads that share the row into a block's 64 rows (row r is head r / QP,
position c0 + r % QP, QP = 64 / H; from H = 64 on, as DeepSeek-V3's 128,
one position of 64 heads a block, a grid axis picking the head group:
row r is head g * 64 + r), walks 64-key tiles up to its last
position's causal frontier and, where ``mla_plan`` splits the keys, cuts
each block's walk into NSPLIT even shares whose f32 partials a combine
kernel merges in split order. This file holds:

- the plain version, ``flash_mla_plain``, against the Pallas
  ``_flash_fwd`` in interpret mode given JAX's own ``v_abs`` (the row with
  its rope columns zeroed) and sliced to ``rank``, o and lse at 2e-5 (the
  reference's own f32 tolerance). The Pallas kernel tiles queries by 128,
  so a shorter chunk is padded with further query rows to 128 and the
  first C rows are compared: a query row's output depends on its own q
  and the keys alone;
- an f32 mirror of the kernel's walk (the head-packed row map, the tile
  ranges, the masked tiles, the online softmax in log2 units, the split
  shares and the merge in split order) against the plain version at 2e-5,
  as tests/test_torch_decode_split.py does for K4;
- ``mla_plan``'s choices, and the entry's refusals.

The ``cuda``-marked tests hold the kernel to its plain version on the
card (bf16, atol = rtol = 2e-2 and 1e-2 relative RMS per 32-row tile, both
of ``chip_smoke.py``'s rules) and skip where there is none.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops import flash as jflash
from dstack_tpu_torch.ops import flash as tflash

TOL = 2e-5
RANK = tflash.MLA_RANK
D = tflash.MLA_HEAD_DIM
SCALE = 192**-0.5  # deepseek-v2-lite's attention_scale (qk_nope + qk_rope = 192)
V3_SCALE = 192**-0.5 * (0.1 * math.log(40.0) + 1.0) ** 2  # deepseek-v3's, with yarn's mscale²
NEG_INF = tflash.NEG_INF
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, h, c, t):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, c, D)).astype(np.float32)
    row = rng.standard_normal((b, 1, t, D)).astype(np.float32)
    return q, row


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_offset", [0, 128])
@pytest.mark.parametrize("chunk", [16, 40, 128])
def test_plain_matches_pallas_interpret(chunk, q_offset):
    """q [1,16,C,576] at q_offset over a 256-row latent; JAX's value is
    the row with its 64 rope columns zeroed, its output sliced to 512."""
    rng = np.random.default_rng(chunk + q_offset)
    q = rng.standard_normal((1, 16, 128, D)).astype(np.float32)  # C rows, then padding to 128
    row = rng.standard_normal((1, 1, 256, D)).astype(np.float32)
    v_abs = row.copy()
    v_abs[..., RANK:] = 0.0
    jo, jl = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(row), jnp.asarray(v_abs), True, SCALE, 128, 128,
                               q_offset, 0, True)
    to, tl = tflash.flash_mla_plain(torch.from_numpy(q[:, :, :chunk]), torch.from_numpy(row), rank=RANK,
                                    scale=SCALE, q_offset=q_offset)
    assert to.shape == (1, 16, chunk, RANK) and tl.shape == (1, 16, chunk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[:, :, :chunk, :RANK], atol=TOL, rtol=TOL)
    # the Pallas kernel's lse carries a trailing axis of 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :, :chunk, 0], atol=TOL, rtol=TOL)
    # what the slice drops: the zero value columns gave zero output columns
    assert not np.asarray(jo)[..., RANK:].any()


def test_entry_takes_the_plain_version_on_the_cpu():
    q, row = (torch.from_numpy(x) for x in _inputs(1, 1, 16, 24, 96))
    got = tflash.flash_mla_with_lse(q, row, rank=RANK, scale=SCALE, q_offset=40)
    want = tflash.flash_mla_plain(q, row, rank=RANK, scale=SCALE, q_offset=40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_launcher_refuses_a_cpu_tensor():
    """Only the entry takes the plain version, and only for a CPU tensor:
    the launcher behind it never does."""
    q, row = (torch.from_numpy(x) for x in _inputs(1, 1, 16, 24, 96))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tflash._flash_mla_launch(q, row, rank=RANK, scale=SCALE, q_offset=40, nsplit=2)


def test_mla_value_zeroes_the_rope_columns():
    row = torch.from_numpy(_inputs(2, 1, 1, 1, 8)[1])
    v = tflash.mla_value(row, RANK)
    assert torch.equal(v[..., :RANK], row[..., :RANK]) and not v[..., RANK:].any()


def test_flash_attention_with_lse_refuses_d576_naming_the_entry():
    q, row = (torch.from_numpy(x) for x in _inputs(3, 1, 16, 8, 32))
    with pytest.raises(ValueError, match="flash_mla_with_lse"):
        tflash.flash_attention_with_lse(q, row, tflash.mla_value(row, RANK), scale=SCALE)


# ---------------------------------------------------------------------------
# the kernel's walk in f32
# ---------------------------------------------------------------------------


def _walk_block(qt, row, qpos, lo, hi, t):
    """One block's split over tiles [lo, hi): (m in log2 units, l, acc
    unnormalised) of its 64 rows, tile by tile as the consumer does."""
    m = torch.full((qt.shape[0],), NEG_INF)
    l = torch.zeros(qt.shape[0])
    acc = torch.zeros(qt.shape[0], RANK)
    for kt in range(lo, hi):
        keys = torch.arange(kt * tflash.MLA_TILE, (kt + 1) * tflash.MLA_TILE)
        tile = torch.zeros(len(keys), D)  # rows past T arrive as zeros
        live = keys < t
        tile[live] = row[keys[live]]
        x = (qt @ tile.T) * (SCALE * LOG2E)
        if kt * tflash.MLA_TILE + tflash.MLA_TILE - 1 > int(qpos.min()) or not bool(live.all()):
            x = torch.where(live[None, :] & (qpos[:, None] >= keys[None, :]), x, torch.full_like(x, NEG_INF))
        m_new = torch.maximum(m, x.max(dim=1).values)
        m_safe = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new), m_new)
        alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp2(m - m_safe))
        p = torch.exp2(x - m_safe[:, None])
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + p @ tile[:, :RANK]  # V: the K tile's first RANK columns
        m = m_new
    return m, l, acc


def mla_walk(q, row, *, q_offset, nsplit):
    """The kernel's algorithm in f32 → (o [B, H, C, RANK], lse [B, H, C])."""
    b, h, c, _ = q.shape
    t = row.shape[2]
    hb = min(h, tflash.MLA_ROWS)  # heads a block
    qp = tflash.MLA_ROWS // hb
    r = torch.arange(tflash.MLA_ROWS)
    o = torch.zeros(b, h, c, RANK)
    lse = torch.zeros(b, h, c)
    for bi, g, c0 in ((bi, g, c0) for bi in range(b) for g in range(h // hb) for c0 in range(0, c, qp)):
        heads, local = g * hb + r // qp, r % qp
        cq = c0 + local
        valid = cq < c  # positions past C are padding rows, read as zeros
        qt = torch.zeros(tflash.MLA_ROWS, D)
        qt[valid] = q[bi, heads[valid], cq[valid]]
        qpos = q_offset + cq
        last = min(c0 + qp, c) - 1
        n_all = min(-(-t // tflash.MLA_TILE), (q_offset + last) // tflash.MLA_TILE + 1)
        parts = [_walk_block(qt, row[bi, 0], qpos, s * n_all // nsplit, (s + 1) * n_all // nsplit, t)
                 for s in range(nsplit)]
        if nsplit == 1:  # finished in place
            m, l, acc = parts[0]
        else:  # the combine: the splits merged in order
            m = torch.stack([p[0] for p in parts]).max(dim=0).values
            l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
            for ms, ls, accs in parts:
                alpha = torch.where(ms <= NEG_INF / 2, torch.zeros_like(ms), torch.exp2(ms - m))
                l = l + ls * alpha
                acc = acc + accs * alpha[:, None]
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        o[bi, heads[valid], cq[valid]] = (acc / l_safe[:, None])[valid]
        row_lse = torch.where(l == 0, torch.full_like(l, NEG_INF), (m + torch.log2(l_safe)) * LN2)
        lse[bi, heads[valid], cq[valid]] = row_lse[valid]
    return o, lse


# (b, h, c, t, q_offset, nsplit: None = mla_plan's at 132 SMs)
WALKS = [
    (1, 16, 256, 2048, 512, None),  # deepseek-v2-lite's chunk: 64 blocks, the plan's 2 splits
    (1, 16, 256, 2048, 0, None),  # the first chunk: 1 to 4 tiles a block, unsplit
    (1, 16, 32, 2048, 0, None),  # a short prompt's only chunk: 8 blocks, one tile each
    (1, 16, 40, 2048, 260, None),  # the ragged chunk: 10 blocks over 5 tiles
    (1, 16, 40, 2048, 260, 3),  # ... cut 1 + 2 + 2
    (1, 16, 32, 2048, 1792, None),  # a short turn deep in the row: 29 tiles, the plan's 8 splits
    (1, 16, 40, 300, 260, 2),  # the row's last tile ragged (T = 300)
    (1, 16, 4, 128, 61, 2),  # frontiers 61-64 straddle a tile edge: split 1 sees no key of rows 0-2
    (1, 16, 3, 64, 0, 1),  # C < QP: one block with a padding position
    (2, 8, 20, 256, 100, 2),  # H = 8: QP = 8 positions a block; two batch rows
    (1, 32, 9, 192, 150, 3),  # H = 32: QP = 2
    (1, 128, 16, 256, 100, None),  # H = 128 (DeepSeek-V3): one position of 64 heads a block, two a position
    (2, 128, 5, 200, 150, 2),  # ... two batch rows, a ragged row, split
    (1, 192, 3, 128, 61, 1),  # H = 192: three head groups
]
WALK_IDS = ["c256_off512", "c256_off0", "c32_off0", "c40_off260", "c40_off260_split3", "c32_off1792",
            "ragged_t", "tile_edge_empty_split", "c_below_qp", "h8_b2", "h32", "h128", "h128_b2_split",
            "h192"]


@pytest.mark.parametrize("b,h,c,t,q_offset,nsplit", WALKS, ids=WALK_IDS)
def test_walk_matches_plain(b, h, c, t, q_offset, nsplit):
    q, row = (torch.from_numpy(x) for x in _inputs(c + q_offset + h, b, h, c, t))
    if nsplit is None:
        nsplit = tflash.mla_plan(b, h, c, t, q_offset, sms=132)
    got_o, got_lse = mla_walk(q, row, q_offset=q_offset, nsplit=nsplit)
    want_o, want_lse = tflash.flash_mla_plain(q, row, rank=RANK, scale=SCALE, q_offset=q_offset)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "shape,want",
    [
        ((1, 16, 256, 2048, 512), 2),  # 64 blocks: two splits fill 128 of 132 SMs
        ((1, 16, 256, 2048, 1792), 2),
        ((1, 16, 256, 2048, 0), 1),  # 4 tiles at most: a split would walk 2, not 4
        ((1, 16, 32, 2048, 0), 1),  # one tile
        ((1, 16, 40, 2048, 260), 5),  # 10 blocks over 5 tiles: one tile a split
        ((1, 16, 32, 2048, 1792), 8),  # 8 blocks over 29 tiles: 16 would fill the SMs, the cap is 8
        ((1, 16, 16, 2048, 2000), 8),  # 4 blocks over 32 tiles: the cap
        ((1, 16, 128, 2048, 100), 2),  # C = 128: 4 tiles, two a split
        ((4, 16, 256, 2048, 512), 1),  # 256 blocks fill the card unsplit
        ((2, 16, 256, 2048, 512), 1),  # 128 blocks: about one an SM already
        ((1, 128, 256, 2048, 512), 1),  # DeepSeek-V3's chunk: 512 blocks of one position x 64 heads
        ((1, 128, 64, 2048, 0), 1),  # 128 blocks over one tile
        ((1, 128, 16, 2048, 0), 1),  # one tile: nothing to split
        ((1, 128, 16, 2048, 1792), 4),  # 32 blocks over 29 tiles: 4 splits fill 128 SMs
    ],
)
def test_mla_plan(shape, want):
    got = tflash.mla_plan(*shape, sms=132)
    assert got == want
    b, h, c, t, q_offset = shape
    reach = min(-(-t // tflash.MLA_TILE), math.ceil((q_offset + c) / tflash.MLA_TILE))
    assert 1 <= got <= min(max(1, reach // math.ceil(c / tflash.MLA_TILE)), tflash.MLA_MAX_SPLIT)


def test_plan_takes_host_ints_only():
    # q_offset is the chunk's start, an int on the host: the plan adds no sync
    import inspect

    assert list(inspect.signature(tflash.mla_plan).parameters) == ["b", "h", "c", "t", "q_offset", "sms"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _k1_d576(cuda, c, q_offset, t=2048, seed=0, h=16, b=1):
    """q_abs [b, h, c, 576] and the latent row [b, 1, t, 576]: the value
    is the row itself with its rope columns zeroed (``mla_value``)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, h, c, 576, generator=g, device=cuda).bfloat16()
    row = torch.randn(b, 1, t, 576, generator=g, device=cuda).bfloat16()
    return q, row


def _mla_close(o, lse, po, plse):
    from chip_smoke import tile_rel_rms

    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=2e-2, rtol=2e-2)
    assert tile_rel_rms(o, po) <= 1e-2


@pytest.mark.cuda
class TestFlashMLAOnTheCard:
    """K1's MLA entry (``flash_mla_with_lse``: the D = 576 kernel, V read
    from the latent K tile, heads packed into a block's rows, keys split
    by ``mla_plan``) against its plain version at the MLA chunk's shapes,
    under both of chip_smoke.py's rules: element-wise within atol = rtol
    = 2e-2, and per 32-row tile within 1e-2 relative RMS."""

    @pytest.mark.parametrize("chunk", [256, 128])
    @pytest.mark.parametrize("q_offset", [0, 512, 1792])
    def test_matches_plain(self, cuda, chunk, q_offset):
        q, row = _k1_d576(cuda, chunk, q_offset)
        kw = dict(rank=512, scale=192**-0.5, q_offset=q_offset)
        before = tflash.LAUNCHES_MLA
        o, lse = tflash.flash_mla_with_lse(q, row, **kw)
        po, plse = tflash.flash_mla_plain(q, row, **kw)
        torch.cuda.synchronize()
        assert tflash.LAUNCHES_MLA == before + 1
        assert o.shape == (1, 16, chunk, 512)
        _mla_close(o, lse, po, plse)

    def test_ragged_edges(self, cuda):
        """A chunk of 40 rows over 300 keys at q_offset 260: the last
        block's positions and the last key tile are both ragged."""
        q, row = _k1_d576(cuda, 40, 260, t=300, seed=1)
        kw = dict(rank=512, scale=0.05, q_offset=260)
        _mla_close(*tflash.flash_mla_with_lse(q, row, **kw), *tflash.flash_mla_plain(q, row, **kw))

    @pytest.mark.parametrize("nsplit", [1, 2, 3, 7, 29])
    @pytest.mark.parametrize("chunk,q_offset,t", [(32, 1792, 2048), (40, 260, 300), (4, 61, 128)])
    def test_split_forms(self, cuda, chunk, q_offset, t, nsplit):
        """Every NSPLIT, uneven shares, splits with no live key of a row
        and splits with no tile at all, against the plain version."""
        q, row = _k1_d576(cuda, chunk, q_offset, t=t, seed=nsplit)
        kw = dict(rank=512, scale=192**-0.5, q_offset=q_offset)
        o, lse = tflash._flash_mla_launch(q, row, nsplit=nsplit, **kw)
        _mla_close(o, lse, *tflash.flash_mla_plain(q, row, **kw))

    @pytest.mark.parametrize("h,b", [(8, 2), (32, 1), (64, 1)])
    def test_other_head_counts(self, cuda, h, b):
        """64 / H query positions a block: the row map and the mask at
        QP = 8, 2 and 1."""
        q, row = _k1_d576(cuda, 37, 100, t=256, seed=h, h=h, b=b)
        kw = dict(rank=512, scale=192**-0.5, q_offset=100)
        _mla_close(*tflash.flash_mla_with_lse(q, row, **kw), *tflash.flash_mla_plain(q, row, **kw))

    @pytest.mark.parametrize("nsplit", [None, 1])
    @pytest.mark.parametrize("h", [16, 128])
    def test_reruns_are_bit_identical(self, cuda, nsplit, h):
        q, row = _k1_d576(cuda, 256, 512, seed=2, h=h)
        a = tflash._flash_mla_launch(q, row, rank=512, scale=192**-0.5, q_offset=512, nsplit=nsplit)
        b = tflash._flash_mla_launch(q, row, rank=512, scale=192**-0.5, q_offset=512, nsplit=nsplit)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    @pytest.mark.parametrize("b,h,c,t,q_offset,nsplit", WALKS, ids=WALK_IDS)
    def test_walk_shapes(self, cuda, b, h, c, t, q_offset, nsplit):
        """The f32 mirror's shapes and NSPLITs (the plan's where None)."""
        q, row = (torch.from_numpy(x).to(cuda).bfloat16() for x in _inputs(c + q_offset + h, b, h, c, t))
        kw = dict(rank=RANK, scale=SCALE, q_offset=q_offset)
        _mla_close(*tflash._flash_mla_launch(q, row, nsplit=nsplit, **kw), *tflash.flash_mla_plain(q, row, **kw))

    @pytest.mark.parametrize("nsplit", [None, 1])
    @pytest.mark.parametrize("chunk,q_offset", [(256, 0), (256, 512), (64, 0), (16, 0), (16, 1792)])
    def test_v3_heads(self, cuda, chunk, q_offset, nsplit):
        """DeepSeek-V3's 128 heads at its chunks: a block owns one position
        of 64 heads, two blocks a position, with the plan's NSPLIT and
        with none."""
        q, row = _k1_d576(cuda, chunk, q_offset, seed=chunk + q_offset, h=128)
        kw = dict(rank=512, scale=V3_SCALE, q_offset=q_offset)
        before = tflash.LAUNCHES_MLA
        o, lse = tflash._flash_mla_launch(q, row, nsplit=nsplit, **kw)
        assert tflash.LAUNCHES_MLA == before + 1 and o.shape == (1, 128, chunk, 512)
        _mla_close(o, lse, *tflash.flash_mla_plain(q, row, **kw))

    @pytest.mark.parametrize("h,b,c", [(128, 2, 37), (128, 1, 1), (192, 1, 9)])
    def test_head_groups_at_odd_chunks(self, cuda, h, b, c):
        """Two batch rows and an odd C at 128 heads, a lone position, and
        three head groups (192 heads)."""
        q, row = _k1_d576(cuda, c, 100, t=256, seed=h + c, h=h, b=b)
        kw = dict(rank=512, scale=V3_SCALE, q_offset=100)
        _mla_close(*tflash.flash_mla_with_lse(q, row, **kw), *tflash.flash_mla_plain(q, row, **kw))

    def test_backward_kernels_refuse_d576(self, cuda):
        q, row = _k1_d576(cuda, 128, 0, t=128, seed=3)
        v = tflash.mla_value(row, 512)
        o, lse = tflash.flash_attention_plain(q, row, v)
        with pytest.raises(ValueError, match="head_dim 576"):
            tflash.flash_bwd(q, row, v, o, lse, torch.ones_like(q))
        with pytest.raises(ValueError, match="flash_mla_with_lse"):
            tflash.flash_attention_with_lse(q, row, v)
