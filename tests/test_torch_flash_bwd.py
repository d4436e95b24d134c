"""The port's flash-attention backward against the JAX package's.

On the CPU ``flash_bwd`` takes ``flash_bwd_plain`` (a CPU tensor), which
is held here to the Pallas ``_flash_bwd`` kernels (``_dq_kernel``,
``_dkv_kernel``) run in interpret mode with 128-row blocks, and the
gradients of ``FlashAttention`` to ``jax.vjp`` of ``flash_attention``
and to torch autograd through ``flash_attention_plain``: the same f32
inputs drawn with numpy, tolerance 2e-5 (the reference's own,
tests/compute/test_flash_decode.py): 4 query heads over 2 KV heads at
head_dim 64, at Gemma's 256 over 2 or 1 KV heads (GQA groups 2 and 4)
with its windows, its softcap of 50 and offsets, and at MLA's training
width 192 (DeepSeek: q/k heads of 128 + 64, v padded to 192; 4 KV heads,
as MLA is MHA, and a group of 2) with its scale of 192^-0.5 and offsets.
The ``cuda``-marked tests hold the hand-written K2/K3 kernels to the plain
version on the card (bf16, 2e-2) and skip where there is none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dstack_tpu.ops.flash import _flash_bwd, _flash_fwd
from dstack_tpu.ops.flash import flash_attention as jax_flash_attention
from dstack_tpu_torch.ops import flash as tflash

TOL = 2e-5
BLOCK = 128

# (T, causal, q_offset, kv_offset, window, softcap, head_dim, KV heads):
# 4 query heads in every case
CASES = [
    (128, True, 0, 0, 0, 0.0, 64, 2),
    (256, True, 0, 0, 0, 0.0, 64, 2),
    (128, True, 128, 0, 0, 0.0, 64, 2),  # queries after a 128-key prefix shard
    (256, True, 0, 0, 96, 0.0, 64, 2),  # sliding window
    (256, True, 0, 0, 0, 30.0, 64, 2),  # softcap: the (1 - tanh^2) factor
    (128, False, 0, 0, 0, 0.0, 64, 2),  # non-causal
    (128, True, 0, 64, 0, 0.0, 64, 2),  # rows 0..63 see no key at all
    # Gemma's head_dim of 256: a global layer over GQA groups of 2 and 4
    (256, True, 0, 0, 0, 0.0, 256, 2),
    (256, True, 0, 0, 0, 0.0, 256, 1),
    # gemma-3's window of 1024: queries at 1100..1227 over keys 0..127,
    # where the window's floor cuts through the tile
    (128, True, 1100, 0, 1024, 0.0, 256, 2),
    # gemma-2's softcap of 50, global and under the window
    (256, True, 0, 0, 0, 50.0, 256, 2),
    (128, True, 1100, 0, 1024, 50.0, 256, 1),
    (128, True, 128, 64, 0, 0.0, 256, 2),  # a q and a kv offset
    # gemma-3-1b's window of 512 over a GQA group of 4: queries at 600..727
    (128, True, 600, 0, 512, 0.0, 256, 1),
    # MLA's training width: q/k 128 + 64, MHA (4 KV heads), causal
    (256, True, 0, 0, 0, 0.0, 192, 4),
    (128, True, 0, 0, 0, 0.0, 192, 2),  # a GQA group of 2
    (128, True, 128, 64, 0, 0.0, 192, 4),  # a q and a kv offset
    (256, True, 0, 0, 96, 30.0, 192, 4),  # a window and a softcap at 192
]
IDS = [
    "T128", "T256", "qoff128", "window96", "softcap30", "noncausal", "no_live_key",
    "d256_group2", "d256_group4", "d256_window1024", "d256_softcap50",
    "d256_window1024_softcap50_group4", "d256_qoff_kvoff", "d256_window512_group4",
    "d192_mha", "d192_group2", "d192_qoff_kvoff", "d192_window96_softcap30",
]
ARGS = "t,causal,q_offset,kv_offset,window,softcap,d,hkv"


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(t: int, seed: int = 0, d: int = 64, hkv: int = 2):
    rng = np.random.default_rng(seed)
    q = _rand(rng, 1, 4, t, d)
    k = _rand(rng, 1, hkv, t, d)
    v = _rand(rng, 1, hkv, t, d)
    do = _rand(rng, 1, 4, t, d)
    return q, k, v, do


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


class TestFlashBackwardPlain:
    @pytest.mark.parametrize(ARGS, CASES, ids=IDS)
    def test_matches_pallas_interpret(self, t, causal, q_offset, kv_offset, window, softcap, d, hkv):
        q, k, v, do = _inputs(t, d=d, hkv=hkv)
        scale = d**-0.5
        jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
        # one forward for both backwards: the test is of the backward alone
        jo, jlse = _flash_fwd(
            jq, jk, jv, causal, scale, BLOCK, BLOCK, q_offset, kv_offset, True,
            window, softcap,
        )
        jdq, jdk, jdv = _flash_bwd(
            jq, jk, jv, jo, jlse, jdo, causal, scale, BLOCK, BLOCK, q_offset,
            kv_offset, True, window, softcap,
        )
        tdq, tdk, tdv = tflash.flash_bwd(
            _t(q), _t(k), _t(v), _t(jo), _t(jlse[..., 0]), _t(do),
            causal=causal, scale=scale, q_offset=q_offset, kv_offset=kv_offset,
            window=window, softcap=softcap,
        )
        for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    def test_row_with_no_live_key_gives_zero_gradients(self):
        q, k, v, do = (_t(x) for x in _inputs(128, seed=1))
        o, lse = tflash.flash_attention_with_lse(q, k, v, kv_offset=64)
        dq, dk, dv = tflash.flash_bwd(q, k, v, o, lse, do, kv_offset=64)
        assert not dq[:, :, :64].any()
        # the last 64 keys sit past every query's causal frontier
        assert not dk[:, :, 64:].any() and not dv[:, :, 64:].any()

    def test_kernel_wrapper_refuses_a_non_cpu_tensor(self):
        x = torch.zeros(1, 2, 16, 64, device="meta")
        lse = torch.zeros(1, 2, 16, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tflash.flash_bwd(x, x, x, x, lse, x)


class TestFlashAttentionFunction:
    @pytest.mark.parametrize(ARGS, CASES, ids=IDS)
    def test_grads_match_jax_vjp(self, t, causal, q_offset, kv_offset, window, softcap, d, hkv):
        q, k, v, do = _inputs(t, seed=2, d=d, hkv=hkv)
        kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset, window=window, softcap=softcap)
        jo, vjp = jax.vjp(
            lambda a, b, c: jax_flash_attention(
                a, b, c, block_q=BLOCK, block_k=BLOCK, interpret=True, **kw
            ),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        )
        jgrads = vjp(jnp.asarray(do))
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        to = tflash.flash_attention(tq, tk, tv, **kw)
        tgrads = torch.autograd.grad(to, (tq, tk, tv), _t(do))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
        for got, want in zip(tgrads, jgrads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize(ARGS, CASES, ids=IDS)
    def test_grads_match_autograd_through_the_plain_forward(
        self, t, causal, q_offset, kv_offset, window, softcap, d, hkv
    ):
        q, k, v, do = _inputs(t, seed=3, d=d, hkv=hkv)
        kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset, window=window, softcap=softcap)
        got_in = [_t(x).requires_grad_() for x in (q, k, v)]
        want_in = [_t(x).requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(tflash.flash_attention(*got_in, **kw), got_in, _t(do))
        o_plain = tflash.flash_attention_plain(*want_in, **kw)[0]
        want = torch.autograd.grad(o_plain, want_in, _t(do))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)

    def test_plain_flag_runs_the_plain_backward(self):
        q, k, v, do = (_t(x) for x in _inputs(128, seed=4))
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        before = (tflash.LAUNCHES, tflash.LAUNCHES_DQ, tflash.LAUNCHES_DKV)
        o = tflash.flash_attention(*ins, plain=True)
        torch.autograd.grad(o, ins, do)
        # the plain versions never count a launch
        assert (tflash.LAUNCHES, tflash.LAUNCHES_DQ, tflash.LAUNCHES_DKV) == before


def _card_case(dev, b, h, hkv, tq, tk, d, seed=0, **kw):
    """K2/K3 on the card and flash_bwd_plain on the same bf16 inputs →
    ((dq, dk, dv) of the kernels, of the plain version)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, tq, d, generator=g, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hkv, tk, d, generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
    got = tflash.flash_bwd(q, k, v, o, lse, do, **kw)
    want = tflash.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    return got, want


def _assert_card_close(got, want):
    # each gradient on its own: a wrong descriptor shows in one of them
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=lambda m: f"{name}: {m}")
        # and chip_smoke.py's tile rule: gradients are mostly about 2e-2 in size
        rms = chip_smoke.tile_rel_rms(a, b)
        assert rms <= chip_smoke.GRAD_RMS_TOL, f"{name}: a tile's relative RMS error {rms:.4g}"


@pytest.mark.cuda
class TestBackwardKernelsOnTheCard:
    """bf16 K2/K3 vs flash_bwd_plain at the training shapes and at every
    tile edge, each gradient on its own (atol = rtol = 2e-2)."""

    @pytest.mark.parametrize(
        "d,t,causal,window,softcap",
        [
            (64, 2048, True, 0, 0.0),  # llama-3.2-1b training shape
            (64, 2048, True, 512, 30.0),
            (64, 1000, True, 0, 0.0),  # ragged edge: T not a multiple of 64
            (64, 300, False, 0, 0.0),
            (128, 1024, True, 0, 0.0),  # Llama-3-8B head width
        ],
    )
    def test_flash_backward(self, cuda, d, t, causal, window, softcap):
        _assert_card_close(*_card_case(cuda, 4, 32, 8, t, t, d, causal=causal, window=window, softcap=softcap))

    def test_offsets(self, cuda):
        got, want = _card_case(cuda, 1, 32, 8, 256, 512, 64, seed=1, q_offset=256, kv_offset=0)
        _assert_card_close(got, want)

    @pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 1000])
    def test_tile_edges(self, cuda, t):
        # T around the 32/64-row streamed tiles and the 128-row blocks
        _assert_card_close(*_card_case(cuda, 2, 8, 2, t, t, 64, seed=t))

    @pytest.mark.parametrize("h,hkv", [(8, 8), (64, 8)], ids=["group1", "group8"])
    def test_gqa_groups(self, cuda, h, hkv):
        _assert_card_close(*_card_case(cuda, 2, h, hkv, 384, 384, 64, seed=h))

    @pytest.mark.parametrize("d", [64, 128])
    def test_offsets_with_window(self, cuda, d):
        # queries at positions 320..511 over keys at 64..511, window 128
        got, want = _card_case(cuda, 2, 8, 2, 192, 448, d, seed=2, q_offset=320, kv_offset=64, window=128)
        _assert_card_close(got, want)

    def test_no_live_key(self, cuda):
        # kv_offset 64: query rows 0..63 see no key, and keys 64..127 sit
        # past every query's causal frontier
        got, want = _card_case(cuda, 2, 8, 2, 128, 128, 64, seed=3, kv_offset=64)
        _assert_card_close(got, want)
        dq, dk, dv = got
        assert not dq[:, :, :64].any()
        assert not dk[:, :, 64:].any() and not dv[:, :, 64:].any()

    def test_head_dim_128_window_softcap(self, cuda):
        got, want = _card_case(cuda, 2, 16, 4, 1000, 1000, 128, seed=4, window=256, softcap=30.0)
        _assert_card_close(got, want)

    def test_two_launches_are_bit_identical(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(5)
        q, do = (torch.randn(2, 32, 1000, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
        k, v = (torch.randn(2, 8, 1000, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
        o, lse = tflash.flash_attention_with_lse(q, k, v)
        first = tflash.flash_bwd(q, k, v, o, lse, do)
        second = tflash.flash_bwd(q, k, v, o, lse, do)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
class TestHeadDim256OnTheCard:
    """K2/K3's D = 256 forms (Gemma) vs flash_bwd_plain: K2 streams 32-key
    tiles there and K3's consumers split the columns of one 64-key tile,
    so the edges sit at 32 and 64 keys (atol = rtol = 2e-2, each gradient
    on its own)."""

    @pytest.mark.parametrize("t", [1, 31, 32, 33, 63, 64, 65, 127, 129, 1000])
    def test_tile_edges(self, cuda, t):
        _assert_card_close(*_card_case(cuda, 2, 8, 4, t, t, 256, seed=t))

    @pytest.mark.parametrize("h,hkv", [(8, 8), (8, 4), (4, 1), (8, 1)],
                             ids=["group1", "group2", "group4", "group8"])
    def test_gqa_groups(self, cuda, h, hkv):
        _assert_card_close(*_card_case(cuda, 2, h, hkv, 384, 384, 256, seed=h + hkv))

    @pytest.mark.parametrize("h,hkv,window,softcap", [(8, 4, 1024, 0.0), (8, 4, 4096, 50.0), (8, 4, 0, 50.0),
                                                      (4, 1, 512, 0.0)],
                             ids=["gemma3_sliding", "gemma2_sliding", "gemma2_global", "gemma3_1b_sliding"])
    def test_gemma_layers(self, cuda, h, hkv, window, softcap):
        _assert_card_close(*_card_case(cuda, 2, h, hkv, 2048, 2048, 256, seed=7, window=window,
                                       softcap=softcap))

    def test_offsets_with_window(self, cuda):
        # queries at positions 1100..1291 over keys at 64..1291, window 1024
        got, want = _card_case(cuda, 2, 8, 4, 192, 1228, 256, seed=8, q_offset=1100, kv_offset=64,
                               window=1024)
        _assert_card_close(got, want)

    def test_no_live_key(self, cuda):
        got, want = _card_case(cuda, 2, 8, 4, 128, 128, 256, seed=9, kv_offset=64, softcap=50.0)
        _assert_card_close(got, want)
        dq, dk, dv = got
        assert not dq[:, :, :64].any()
        assert not dk[:, :, 64:].any() and not dv[:, :, 64:].any()

    def test_two_launches_are_bit_identical(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(10)
        q, do = (torch.randn(2, 8, 1000, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
        k, v = (torch.randn(2, 4, 1000, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
        kw = dict(window=512, softcap=50.0)
        o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
        first = tflash.flash_bwd(q, k, v, o, lse, do, **kw)
        second = tflash.flash_bwd(q, k, v, o, lse, do, **kw)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
class TestHeadDim192OnTheCard:
    """K2/K3's D = 192 forms (DeepSeek's MLA in training) vs
    flash_bwd_plain: K2 streams 64-key tiles and K3's two consumers split
    the roles (dV, dK) over one 64-key tile with 64-row query tiles, so the
    edges sit at 64 keys and 64 queries (atol = rtol = 2e-2 and the tile
    rule, each gradient on its own)."""

    @pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 1000])
    def test_tile_edges(self, cuda, t):
        _assert_card_close(*_card_case(cuda, 2, 16, 16, t, t, 192, seed=t, scale=192**-0.5))

    @pytest.mark.parametrize("h,hkv", [(16, 16), (8, 4), (8, 1)], ids=["group1", "group2", "group8"])
    def test_gqa_groups(self, cuda, h, hkv):
        _assert_card_close(*_card_case(cuda, 2, h, hkv, 384, 384, 192, seed=h + hkv))

    def test_training_shape(self, cuda):
        # deepseek-v2-lite's attention in training: 16 heads, T = 2048, causal
        _assert_card_close(*_card_case(cuda, 2, 16, 16, 2048, 2048, 192, seed=11, scale=192**-0.5))

    @pytest.mark.parametrize("window,softcap", [(512, 0.0), (0, 30.0), (512, 30.0)])
    def test_window_and_softcap(self, cuda, window, softcap):
        _assert_card_close(*_card_case(cuda, 2, 8, 8, 1000, 1000, 192, seed=12, window=window, softcap=softcap))

    def test_offsets_with_window(self, cuda):
        got, want = _card_case(cuda, 2, 8, 8, 192, 448, 192, seed=13, q_offset=320, kv_offset=64, window=128)
        _assert_card_close(got, want)

    def test_no_live_key(self, cuda):
        got, want = _card_case(cuda, 2, 8, 8, 128, 128, 192, seed=14, kv_offset=64)
        _assert_card_close(got, want)
        dq, dk, dv = got
        assert not dq[:, :, :64].any()
        assert not dk[:, :, 64:].any() and not dv[:, :, 64:].any()

    def test_zero_padded_value_columns(self, cuda):
        """MLA pads v from 128 to 192 with zeros, and the slice after
        attention gives dO zeros there: o and dv come out zero in those
        columns, and dq, dk match the plain version."""
        g = torch.Generator(device=cuda).manual_seed(15)
        q, k, v, do = (torch.randn(2, 16, 1000, 192, generator=g, device=cuda).bfloat16() for _ in range(4))
        v[..., 128:] = 0
        do[..., 128:] = 0
        kw = dict(scale=192**-0.5)
        o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
        got = tflash.flash_bwd(q, k, v, o, lse, do, **kw)
        _assert_card_close(got, tflash.flash_bwd_plain(q, k, v, o, lse, do, **kw))
        assert not o[..., 128:].any() and not got[2][..., 128:].any()

    def test_two_launches_are_bit_identical(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(16)
        q, do = (torch.randn(2, 16, 1000, 192, generator=g, device=cuda).bfloat16() for _ in range(2))
        k, v = (torch.randn(2, 16, 1000, 192, generator=g, device=cuda).bfloat16() for _ in range(2))
        o, lse = tflash.flash_attention_with_lse(q, k, v)
        first = tflash.flash_bwd(q, k, v, o, lse, do)
        second = tflash.flash_bwd(q, k, v, o, lse, do)
        for a, b in zip(first, second):
            assert torch.equal(a, b)
