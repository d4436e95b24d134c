"""K4's split-K plan and its combine arithmetic, on the CPU.

The Hopper kernel (``csrc/flash_decode.cu``) cuts each slot's live
tiles (``tile_keys``: 64 keys, 128 of an int8 cache with no window) into NSPLIT even
shares (NSPLIT from ``flash_decode.decode_plan``), and within a block each
of 4 warps owns a quarter of every tile. Every (split, warp) keeps its own
running max m, sum l and accumulator; the block merges its warps in
order, and the combine kernel merges a row's splits in order and applies
the sink finish once. This file mirrors that arithmetic in f32 (no bf16
rounding of p, no int8 values: the int8 plan's tiling on f32 inputs) on
the tile ranges the device computes, and holds it to
``flash_decode_plain`` and to the Pallas ``flash_decode`` run in
interpret mode at 2e-5, the reference's own f32 tolerance
(tests/compute/test_flash_decode.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from dstack_tpu_torch.ops import flash_decode as tfd

TOL = 2e-5
NEG_INF = tfd.NEG_INF
NWARPS = 4  # warps a block, each owning a quarter of every tile


def _split_tiles(pos: int, s_rows: int, t: int, window: int, nsplit: int, bk: int) -> list:
    """[first tile, end) of each split: the kernel's share of the slot's
    live tiles (flash_decode_kernel's kt_first / kt_last arithmetic)."""
    num_k = -(-t // bk)
    kt_last = max(0, min((pos + s_rows - 1) // bk, num_k - 1))
    kt_first = 0
    if window > 0:
        f = pos - (window - 1)
        kt_first = min(f // bk, num_k - 1) if f > 0 else 0
    n_live = kt_last - kt_first + 1
    return [(kt_first + s * n_live // nsplit, kt_first + (s + 1) * n_live // nsplit) for s in range(nsplit)]


def _partial(s, v, keys):
    """(m, l, acc) of one unit over the key indices ``keys``: s [R, T]
    masked f32 scores, v [T, D] f32."""
    r, d = s.shape[0], v.shape[1]
    if len(keys) == 0:
        return torch.full((r,), NEG_INF), torch.zeros(r), torch.zeros(r, d)
    x = s[:, keys]
    m = x.max(dim=1).values
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(x - m_safe[:, None])
    return m, p.sum(dim=1), p @ v[keys]


def _merge(parts):
    """Partials merged in order: the warp merge and the combine kernel."""
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        alpha = torch.where(mi <= NEG_INF / 2, torch.zeros_like(mi), torch.exp(mi - m))
        l = l + li * alpha
        acc = acc + ai * alpha[:, None]
    return m, l, acc


def _finish(m, l, acc, sink):
    alpha = torch.ones_like(m)
    if sink is not None:
        m_f = torch.maximum(m, sink)
        alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - m_f))
        l = l * alpha + torch.exp(sink - m_f)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc * alpha[:, None] / l_safe[:, None]


def split_decode(q, k, v, positions, *, scale, window, rows_per_slot, sinks, nsplit, bk):
    """The kernel's algorithm in f32, on tiles of ``bk`` keys → [B, Hkv, R, D]."""
    wk = bk // NWARPS
    b, hkv, r, d = q.shape
    t = k.shape[2]
    kj = torch.arange(t)
    out = torch.zeros(b, hkv, r, d)
    for bi in range(b):
        pos = int(positions[bi])
        qpos = pos + torch.arange(r) % rows_per_slot
        keep = (kj[None, :] <= qpos[:, None]) & (kj[None, :] < t)
        if window:
            keep &= qpos[:, None] - kj[None, :] < window
        for h in range(hkv):
            s = torch.where(keep, (q[bi, h] @ k[bi, h].T) * scale, torch.full((r, t), NEG_INF))
            blocks = []
            for lo, hi in _split_tiles(pos, rows_per_slot, t, window, nsplit, bk):
                warps = []
                for w in range(NWARPS):
                    keys = [kt * bk + wk * w + j for kt in range(lo, hi) for j in range(wk)]
                    warps.append(_partial(s, v[bi, h], [x for x in keys if x < t]))
                blocks.append(_merge(warps))
            out[bi, h] = _finish(*_merge(blocks), None if sinks is None else sinks[h])
    return out


def _inputs(seed, b, hkv, r, t, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, hkv, r, d), (b, hkv, t, d), (b, hkv, t, d)))
    sinks = rng.standard_normal((hkv, r)).astype(np.float32)
    return q, k, v, sinks


# (positions, rows_per_slot, window, sinks, sms): T = 2048 (32 tiles), B = 2
# and Hkv = 2, so decode_plan gives 8 splits (4 tiles each) unless `sms`
# is small or the window shortens the reach
CASES = [
    ([63, 64], 1, 0, False, 132),  # the last key of tile 0, the first of tile 1
    ([639, 640], 1, 0, False, 6),  # 3 uneven splits of 10 and 11 live tiles
    ([0, 2047], 1, 0, False, 132),  # pos 0: seven of eight splits empty
    ([0, 1], 5, 0, True, 132),  # verify rows, every split but one empty, sinks
    ([700, 1800], 1, 600, False, 132),  # a window that crosses a split (2 splits)
    ([1190, 1317], 5, 1000, True, 6),  # verify + window + sinks over 3 uneven splits
    ([319, 320], 1, 0, True, 8),  # sinks, 4 splits of 5 and 6 live tiles
    ([2042, 2043], 5, 0, False, 132),  # the last verify row on the row's last key
]
IDS = ["tile_edge", "share_edge", "pos0_many_splits", "verify_sinks_empty", "window_crosses",
       "verify_window_sinks", "sinks_two_splits", "row_end"]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_tiles", "int8_tiles"])
@pytest.mark.parametrize("positions,rows_per_slot,window,with_sinks,sms", CASES, ids=IDS)
def test_split_merge_matches_plain_and_pallas(positions, rows_per_slot, window, with_sinks, sms, int8):
    b, hkv, t = 2, 2, 2048
    r = 4 * rows_per_slot
    q, k, v, sinks = _inputs(len(positions) + rows_per_slot + window, b, hkv, r, t)
    _, nsplit = tfd.decode_plan(b, hkv, r, t, 64, window, rows_per_slot, int8, sms=sms)
    pos = np.asarray(positions, np.int32)
    kw = dict(scale=0.125, window=window, rows_per_slot=rows_per_slot)
    tsinks = torch.from_numpy(sinks) if with_sinks else None
    got = split_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
                       sinks=tsinks, nsplit=nsplit, bk=tfd.tile_keys(int8, window), **kw)
    want = tfd.flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos), sinks=tsinks, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    j = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), scale=0.125,
        window=jnp.asarray(window, jnp.int32), sinks=jnp.asarray(sinks) if with_sinks else None,
        rows_per_slot=rows_per_slot, block_k=128, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


def test_row_with_no_live_key_gives_zero_with_sinks():
    # a window that ends before the cache row does: no key of any split is
    # live, every partial is empty, and the sink finish gives 0
    b, hkv, r, t = 1, 2, 4, 256
    q, k, v, sinks = _inputs(9, b, hkv, r, t)
    pos = torch.tensor([400], dtype=torch.int32)
    kw = dict(scale=0.125, window=64, rows_per_slot=1, sinks=torch.from_numpy(sinks))
    got = split_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos,
                       nsplit=tfd.decode_plan(b, hkv, r, t, 64, sms=8)[1], bk=tfd.tile_keys(False, 64), **kw)
    want = tfd.flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, **kw)
    assert not got.any() and not want.any()


@pytest.mark.parametrize(
    "shape,want",
    [
        ((8, 8, 4, 2048, 64), (4, 5)),  # llama decode at the server's batch: 320 blocks
        ((8, 8, 20, 2048, 64, 0, 5), (20, 5)),  # llama verify: 2 M-tiles a block
        ((8, 8, 40, 2048, 64, 0, 5), (20, 3)),  # gpt-oss verify: two row groups of 20
        ((8, 8, 40, 2048, 128, 0, 5), (14, 2)),  # three row groups at D = 128
        ((8, 8, 64, 2048, 64), (32, 3)),  # 64 rows: two even groups of 32
        ((1, 8, 4, 2048, 64), (4, 8)),  # one slot: 32 tiles, four a split
        ((2, 2, 4, 100, 64), (4, 1)),  # a short row: two tiles, walked unsplit
        ((64, 8, 4, 2048, 64), (4, 1)),  # a large batch fills the card unsplit
        ((8, 8, 8, 2048, 64, 128), (8, 1)),  # a 128-key window reaches 3 tiles
        ((8, 8, 8, 2048, 64, 1024), (8, 4)),  # a 1024-key window reaches 17
        ((8, 8, 4, 2048, 64, 0, 1, True), (4, 4)),  # int8: 16 tiles of 128 keys
        ((8, 8, 20, 2048, 64, 0, 5, True), (20, 4)),
        ((8, 8, 40, 2048, 64, 0, 5, True), (40, 4)),  # int8 verify: one group of 3 M-tiles
        ((8, 8, 8, 2048, 64, 128, 1, True), (8, 1)),  # int8, a 128-key window
        ((8, 8, 40, 2048, 64, 128, 5, True), (20, 1)),  # int8 verify in a window: two groups
    ],
)
def test_decode_plan(shape, want):
    got = tfd.decode_plan(*shape)
    assert got == want
    b, hkv, r, t, d = shape[:5]
    window, int8 = (shape[5] if len(shape) > 5 else 0), len(shape) > 7 and shape[7]
    assert got[0] <= max(tfd.MAX_ROWS[d], tfd.INT8_ROWS[d])
    assert 1 <= got[1] <= -(-t // tfd.tile_keys(int8, window))


def test_plan_reads_no_positions():
    # the plan is a function of shapes alone: a host read of the device
    # positions would sync every decode step
    import inspect

    params = list(inspect.signature(tfd.decode_plan).parameters)
    assert params == ["b", "hkv", "r", "t", "d", "window", "rows_per_slot", "int8", "sms"]
