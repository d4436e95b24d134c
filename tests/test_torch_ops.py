"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain version (a CPU tensor), which is
held here to the Pallas kernels run in interpret mode, the way the JAX
package's own tests run them, and to ``_xla_attention``: the same f32
inputs drawn with numpy, tolerance 2e-5 (the reference's own,
tests/compute/test_flash_decode.py). The ``cuda``-marked tests hold the
hand-written kernels to the plain versions on the card (bf16, 2e-2) and
skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops.attention import _xla_attention
from dstack_tpu.ops.flash import flash_attention_with_lse as jax_flash_with_lse
from dstack_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from dstack_tpu_torch.ops import attention as tattention
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.ops import flash_decode as tflash_decode

TOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


class TestFlashForwardPlain:
    @pytest.mark.parametrize(
        "causal,q_offset,window,softcap",
        [
            (True, 0, 0, 0.0),
            (True, 128, 0, 0.0),
            (True, 128, 96, 0.0),
            (True, 0, 0, 30.0),
            (False, 0, 0, 0.0),
        ],
    )
    def test_matches_pallas_interpret(self, causal, q_offset, window, softcap):
        rng = np.random.default_rng(0)
        q = _rand(rng, 1, 4, 128, 64)  # GQA: 4 query heads over 2 KV heads
        k = _rand(rng, 1, 2, 256, 64)
        v = _rand(rng, 1, 2, 256, 64)
        kw = dict(causal=causal, q_offset=q_offset, window=window, softcap=softcap)
        jo, jl = jax_flash_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw
        )
        to, tl = tflash.flash_attention_with_lse(_t(q), _t(k), _t(v), **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize(
        "q_offset,window,softcap",
        [(0, 0, 0.0), (128, 96, 0.0), (128, 0, 50.0), (128, 96, 50.0)],
    )
    def test_head_dim_256_matches_pallas_interpret(self, q_offset, window, softcap):
        """Gemma's head width: 8 query heads over 4 KV heads, a chunk at an
        offset with a window the rows cross, and gemma-2's softcap 50."""
        rng = np.random.default_rng(6)
        q = _rand(rng, 1, 8, 128, 256)
        k = _rand(rng, 1, 4, 256, 256)
        v = _rand(rng, 1, 4, 256, 256)
        kw = dict(causal=True, scale=256**-0.5, q_offset=q_offset, window=window, softcap=softcap)
        jo, jl = jax_flash_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw
        )
        to, tl = tflash.flash_attention_with_lse(_t(q), _t(k), _t(v), **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("q_offset,window,softcap", [(0, 0, 0.0), (128, 96, 30.0)])
    def test_head_dim_192_matches_pallas_interpret(self, q_offset, window, softcap):
        """MLA's training width (q/k heads of 128 + 64, v padded from 128
        with zeros): 4 heads, MHA, at DeepSeek's scale 192^-0.5, and a
        chunk at an offset with a window and a softcap."""
        rng = np.random.default_rng(7)
        q = _rand(rng, 1, 4, 128, 192)
        k = _rand(rng, 1, 4, 256, 192)
        v = _rand(rng, 1, 4, 256, 192)
        v[..., 128:] = 0
        kw = dict(causal=True, scale=192**-0.5, q_offset=q_offset, window=window, softcap=softcap)
        jo, jl = jax_flash_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw
        )
        to, tl = tflash.flash_attention_with_lse(_t(q), _t(k), _t(v), **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        assert not to[..., 128:].any()

    @pytest.mark.parametrize("q_offset", [0, 40])
    def test_ragged_chunk_matches_xla_attention(self, q_offset):
        # C = 16 queries at an offset over a longer row: the shape the
        # TPU kernel refused (Tq % 128) and the Hopper kernel takes
        rng = np.random.default_rng(1)
        q = _rand(rng, 1, 4, 16, 64)
        k = _rand(rng, 1, 2, 96, 64)
        v = _rand(rng, 1, 2, 96, 64)
        j = _xla_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            scale=0.125, q_offset=q_offset,
        )
        t = tattention.attention(_t(q), _t(k), _t(v), scale=0.125, q_offset=q_offset)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    def test_row_with_no_live_key_gives_zero_and_neg_inf_lse(self):
        rng = np.random.default_rng(2)
        q, k, v = (_t(_rand(rng, 1, 2, 4, 64)) for _ in range(3))
        o, lse = tflash.flash_attention_with_lse(q, k, v, kv_offset=100)
        assert not o.any() and bool((lse == tflash.NEG_INF).all())

    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
    def test_vector_q_offset_matches_xla_attention(self, window, softcap):
        # packed prefill: each row's chunk at its own start over its own row
        rng = np.random.default_rng(5)
        q = _rand(rng, 3, 4, 16, 64)
        k = _rand(rng, 3, 2, 96, 64)
        v = _rand(rng, 3, 2, 96, 64)
        off = np.array([0, 40, 80], np.int32)
        j = _xla_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, scale=0.125,
            q_offset=jnp.asarray(off), window=window, softcap=softcap,
        )
        t = tattention.attention(
            _t(q), _t(k), _t(v), scale=0.125, q_offset=_t(off).long(), window=window, softcap=softcap
        )
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


class TestFlashDecodePlain:
    @pytest.mark.parametrize(
        "positions,window,softcap",
        [([3, 255], 0, 0.0), ([129, 200], 64, 30.0), ([0, 127], 0, 0.0)],
    )
    def test_matches_pallas_interpret(self, positions, window, softcap):
        rng = np.random.default_rng(3)
        q = _rand(rng, 2, 2, 4, 64)
        k = _rand(rng, 2, 2, 256, 64)
        v = _rand(rng, 2, 2, 256, 64)
        pos = np.asarray(positions, np.int32)
        j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            scale=0.125, window=jnp.asarray(window, jnp.int32), softcap=softcap,
            block_k=128, interpret=True,
        )
        t = tflash_decode.flash_decode(
            _t(q), _t(k), _t(v), _t(pos), scale=0.125, window=window, softcap=softcap
        )
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 50.0), (64, 50.0)])
    def test_head_dim_256_matches_pallas_interpret(self, window, softcap, rows_per_slot, quant):
        """Gemma's head width (G = 2 query rows a KV head, R = 2 or 10),
        both caches, decode and verify, window and softcap."""
        from dstack_tpu.serve import engine as jengine

        rng = np.random.default_rng(7)
        r = 2 * rows_per_slot
        q = _rand(rng, 3, 2, r, 256)
        k, v = _rand(rng, 3, 2, 256, 256), _rand(rng, 3, 2, 256, 256)
        pos = np.array([0, 100, 251 - (rows_per_slot - 1)], np.int32)
        kw = dict(scale=256**-0.5, softcap=softcap, rows_per_slot=rows_per_slot)
        jk, jv, tk, tv, jx, tx = k, v, _t(k), _t(v), {}, {}
        if quant:
            jk, ks = jengine.kv_quantize(jnp.asarray(k))
            jv, vs = jengine.kv_quantize(jnp.asarray(v))
            tk, tv = _t(jk), _t(jv)
            jx = dict(k_scale=ks, v_scale=vs)
            tx = dict(k_scale=_t(ks), v_scale=_t(vs))
        j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(pos),
            window=jnp.asarray(window, jnp.int32), block_k=128, interpret=True, **kw, **jx,
        )
        t = tflash_decode.flash_decode(_t(q), tk, tv, _t(pos), window=window, **kw, **tx)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    @pytest.mark.parametrize("group", [1, 3, 7, 9, 16])
    def test_head_dim_128_groups_match_pallas_interpret(self, group, rows_per_slot, quant):
        """The dense families' head width at their GQA groups (OLMo-2 and
        Command-R 1, Minitron 3, Qwen2.5 7, StarCoder2 9, GLM-4 16), both
        caches, decode and verify (R up to 80 rows a KV head)."""
        from dstack_tpu.serve import engine as jengine

        rng = np.random.default_rng(group * 10 + rows_per_slot)
        r = group * rows_per_slot
        q = _rand(rng, 2, 1, r, 128)
        k, v = _rand(rng, 2, 1, 256, 128), _rand(rng, 2, 1, 256, 128)
        pos = np.array([70, 251 - (rows_per_slot - 1)], np.int32)
        kw = dict(scale=128**-0.5, rows_per_slot=rows_per_slot)
        jk, jv, tk, tv, jx, tx = k, v, _t(k), _t(v), {}, {}
        if quant:
            jk, ks = jengine.kv_quantize(jnp.asarray(k))
            jv, vs = jengine.kv_quantize(jnp.asarray(v))
            tk, tv = _t(jk), _t(jv)
            jx = dict(k_scale=ks, v_scale=vs)
            tx = dict(k_scale=_t(ks), v_scale=_t(vs))
        j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(pos),
            window=jnp.asarray(0, jnp.int32), block_k=128, interpret=True, **kw, **jx,
        )
        t = tflash_decode.flash_decode(_t(q), tk, tv, _t(pos), **kw, **tx)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    # every form of the TPU kernel is served now (sinks included, in
    # test_torch_gpt_oss.py); a form the kernel cannot take still raises:
    # sinks that are not one logit per query row [Hkv, R]
    @pytest.mark.parametrize("kw", [{"sinks": torch.zeros(2, 5)}])
    def test_unported_variants_raise(self, kw):
        x = torch.zeros(2, 2, 4, 64)
        with pytest.raises(ValueError, match="sinks"):
            tflash_decode.flash_decode(
                x, x, x, torch.zeros(2, dtype=torch.int32), scale=0.125, **kw
            )


@pytest.mark.cuda
class TestKernelsOnTheCard:
    """Kernels vs their plain versions at the serving shapes (bf16)."""

    @pytest.mark.parametrize(
        "d,chunk,q_offset,window,softcap",
        [
            (64, 16, 0, 0, 0.0), (64, 16, 512, 0, 0.0),
            (64, 256, 0, 0, 0.0), (64, 256, 512, 0, 0.0),
            (64, 100, 300, 128, 30.0),  # ragged chunk, window, softcap
            (128, 256, 1792, 0, 0.0),  # Llama-3-8B head width, last tiles
        ],
    )
    def test_flash_forward(self, cuda, d, chunk, q_offset, window, softcap):
        g = torch.Generator(device=cuda).manual_seed(0)
        q = torch.randn(1, 32, chunk, d, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(1, 8, 2048, d, generator=g, device=cuda).bfloat16() for _ in range(2))
        kw = dict(q_offset=q_offset, window=window, softcap=softcap)
        o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
        po, plse = tflash.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, plse, atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("d,group,window", [(64, 4, 0), (64, 4, 100), (128, 1, 0)])
    def test_flash_decode(self, cuda, d, group, window):
        g = torch.Generator(device=cuda).manual_seed(1)
        q = torch.randn(8, 8, group, d, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(8, 8, 2048, d, generator=g, device=cuda).bfloat16() for _ in range(2))
        pos = torch.tensor([0, 1, 63, 64, 700, 1500, 2046, 2047], dtype=torch.int32, device=cuda)
        o = tflash_decode.flash_decode(q, k, v, pos, scale=d**-0.5, window=window)
        po = tflash_decode.flash_decode_plain(q, k, v, pos, scale=d**-0.5, window=window)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("group,rows_per_slot", [(1, 3), (4, 5), (8, 8), (4, 1)])
    @pytest.mark.parametrize("d", [64, 128])
    def test_flash_decode_int8_and_verify(self, cuda, quant, group, rows_per_slot, d):
        """R = G x S rows of 3, 20, 64 (and the int8 decode form at 4),
        positions where pos + S - 1 reaches the row's end and crosses
        tiles, the int8 cache quantized as the engine writes it."""
        from dstack_tpu_torch.serve.engine import kv_quantize

        g = torch.Generator(device=cuda).manual_seed(2)
        q = torch.randn(8, 8, group * rows_per_slot, d, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(8, 8, 2048, d, generator=g, device=cuda).bfloat16() for _ in range(2))
        kw = {}
        if quant:
            (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
            kw = dict(k_scale=ks, v_scale=vs)
        last = 2048 - rows_per_slot
        pos = torch.tensor([0, 1, 62, 63, 700, 1500, last - 1, last], dtype=torch.int32, device=cuda)
        kw.update(scale=d**-0.5, rows_per_slot=rows_per_slot)
        o = tflash_decode.flash_decode(q, k, v, pos, **kw)
        po = tflash_decode.flash_decode_plain(q, k, v, pos, **kw)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
class TestHeadDim256OnTheCard:
    """K1 and K4 at Gemma's head width against their plain versions (bf16,
    2e-2): gemma-3-4b's serving shapes (8/4 heads), windows that the rows
    cross, gemma-2's softcap 50, both caches, decode and verify (S = 5),
    the sinks form (it comes with the template), tile edges."""

    @pytest.mark.parametrize(
        "chunk,q_offset,window,softcap",
        [
            (256, 512, 1024, 0.0), (256, 512, 0, 0.0),  # gemma-3-4b, sliding and global
            (256, 1536, 1024, 0.0),  # the window's floor inside the row
            (256, 512, 4096, 50.0),  # gemma-2-2b: sliding layer with the softcap
            (100, 1700, 1024, 50.0), (16, 0, 0, 0.0), (1, 2047, 512, 0.0),
        ],
    )
    def test_flash_forward(self, cuda, chunk, q_offset, window, softcap):
        g = torch.Generator(device=cuda).manual_seed(8)
        q = torch.randn(1, 8, chunk, 256, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(1, 4, 2048, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
        kw = dict(scale=256**-0.5, q_offset=q_offset, window=window, softcap=softcap)
        _assert_fwd_close(tflash.flash_attention_with_lse(q, k, v, **kw),
                          tflash.flash_attention_plain(q, k, v, **kw))

    @pytest.mark.parametrize("t", [64, 65, 129, 1000])
    def test_flash_forward_tile_edges(self, cuda, t):
        _assert_fwd_close(*_fwd_case(cuda, 2, 8, 4, t, t, 256, seed=t, window=512, softcap=50.0))

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (1024, 0.0), (1024, 50.0)])
    def test_flash_decode(self, cuda, window, softcap, rows_per_slot, quant):
        from dstack_tpu_torch.serve.engine import kv_quantize

        g = torch.Generator(device=cuda).manual_seed(9)
        q = torch.randn(8, 4, 2 * rows_per_slot, 256, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(8, 4, 2048, 256, generator=g, device=cuda).bfloat16() for _ in range(2))
        kw = dict(scale=256**-0.5, window=window, softcap=softcap, rows_per_slot=rows_per_slot)
        if quant:
            (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
            kw.update(k_scale=ks, v_scale=vs)
        last = 2048 - rows_per_slot
        pos = torch.tensor([0, 63, 64, 700, 1100, 1500, last - 1, last], dtype=torch.int32, device=cuda)
        _assert_decode_close(tflash_decode.flash_decode(q, k, v, pos, **kw),
                             tflash_decode.flash_decode_plain(q, k, v, pos, **kw))

    @pytest.mark.parametrize("quant", [False, True])
    def test_flash_decode_rows_and_sinks(self, cuda, quant):
        # R = 40 (3 row groups of at most 16), sinks, 8 KV heads
        pos = [0, 40, 200, 300, 700, 1024, 1500, 2043]
        _assert_decode_close(*_decode_case(cuda, 8, 40, 256, pos, seed=10, quant=quant,
                                           rows_per_slot=5, sinks=True, window=1024))


@pytest.mark.cuda
class TestHeadDim128OnTheCard:
    """K1 and K4 at the dense families' head width of 128 against their
    plain versions (bf16, 2e-2) at the GQA groups those families bring:
    K4 at groups 1, 3, 7, 9 and 16 (OLMo-2 and Command-R, Minitron,
    Qwen2.5, StarCoder2, GLM-4), decode and verify (S = 5: up to 80 rows
    a KV head, partial row groups at 35 and 45), both caches, positions
    crossing tiles and reaching the row's end; K1 at a serving chunk of
    256 at q_offset 512 at groups 1, 3, 7, 9 and 16, and at Llama-4-Scout's
    5 (K4 does not run there: its chunk mask takes the einsum)."""

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    @pytest.mark.parametrize("group", [1, 3, 7, 9, 16])
    def test_flash_decode_groups(self, cuda, group, rows_per_slot, quant):
        last = 2048 - rows_per_slot
        pos = [0, 1, 63, 64, 700, 1500, last - 1, last]
        _assert_decode_close(*_decode_case(cuda, 8, group * rows_per_slot, 128, pos, seed=group,
                                           quant=quant, rows_per_slot=rows_per_slot))

    @pytest.mark.parametrize("h,hkv", [(32, 32), (24, 8), (28, 4), (36, 4), (32, 2), (40, 8)],
                             ids=["group1", "group3", "group7", "group9", "group16", "group5"])
    def test_flash_forward_groups(self, cuda, h, hkv):
        g = torch.Generator(device=cuda).manual_seed(h + hkv)
        q = torch.randn(1, h, 256, 128, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(1, hkv, 2048, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
        kw = dict(scale=128**-0.5, q_offset=512)
        _assert_fwd_close(tflash.flash_attention_with_lse(q, k, v, **kw),
                          tflash.flash_attention_plain(q, k, v, **kw))


def _fwd_case(dev, b, h, hkv, tq, tk, d, seed=0, **kw):
    """K1 and flash_attention_plain on the same bf16 inputs → ((o, lse) of
    the kernel, of the plain version)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, tq, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(b, hkv, tk, d, generator=g, device=dev).bfloat16() for _ in range(2))
    return tflash.flash_attention_with_lse(q, k, v, **kw), tflash.flash_attention_plain(q, k, v, **kw)


def _assert_fwd_close(got, want):
    for name, a, b in zip(("o", "lse"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
class TestFlashForwardKernelAtTrainingShapes:
    """K1 (wgmma on a TMA ring) vs flash_attention_plain at the training
    shapes and every tile edge, o and lse each on its own (bf16, 2e-2);
    the cases of the backward kernels' card tests (test_torch_flash_bwd.py)."""

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
    def test_flash_forward(self, cuda, d, t, causal, window, softcap):
        _assert_fwd_close(*_fwd_case(cuda, 4, 32, 8, t, t, d, causal=causal, window=window, softcap=softcap))

    @pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 1000])
    def test_tile_edges(self, cuda, t):
        # T around the 64-key tiles and the 128-row blocks, B > 1
        _assert_fwd_close(*_fwd_case(cuda, 2, 8, 2, t, t, 64, seed=t))

    @pytest.mark.parametrize("h,hkv", [(8, 8), (32, 8), (64, 8)], ids=["group1", "group4", "group8"])
    def test_gqa_groups(self, cuda, h, hkv):
        _assert_fwd_close(*_fwd_case(cuda, 2, h, hkv, 384, 384, 64, seed=h))

    @pytest.mark.parametrize("d", [64, 128])
    def test_offsets_with_window(self, cuda, d):
        # queries at positions 320..511 over keys at 64..511, window 128
        _assert_fwd_close(*_fwd_case(cuda, 2, 8, 2, 192, 448, d, seed=2, q_offset=320, kv_offset=64, window=128))

    def test_head_dim_128_window_softcap(self, cuda):
        _assert_fwd_close(*_fwd_case(cuda, 2, 16, 4, 1000, 1000, 128, seed=4, window=256, softcap=30.0))

    def test_no_live_key(self, cuda):
        # kv_offset 64: query rows 0..63 see no key: o 0, lse NEG_INF
        got, want = _fwd_case(cuda, 2, 8, 2, 128, 128, 64, seed=3, kv_offset=64)
        _assert_fwd_close(got, want)
        o, lse = got
        assert not o[:, :, :64].any() and bool((lse[:, :, :64] == tflash.NEG_INF).all())

    def test_two_launches_are_bit_identical(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(5)
        q = torch.randn(2, 32, 1000, 64, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(2, 8, 1000, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
        first = tflash.flash_attention_with_lse(q, k, v)
        second = tflash.flash_attention_with_lse(q, k, v)
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
class TestHeadDim192OnTheCard:
    """K1's D = 192 form (DeepSeek's MLA in training: 3 column boxes a row,
    a 3-stage ring of 64-key tiles) vs flash_attention_plain, o and lse
    each on its own (bf16, 2e-2)."""

    def test_training_shape(self, cuda):
        _assert_fwd_close(*_fwd_case(cuda, 2, 16, 16, 2048, 2048, 192, seed=1, scale=192**-0.5))

    @pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 1000])
    def test_tile_edges(self, cuda, t):
        _assert_fwd_close(*_fwd_case(cuda, 2, 16, 16, t, t, 192, seed=t))

    @pytest.mark.parametrize("h,hkv", [(8, 4), (8, 1)], ids=["group2", "group8"])
    def test_gqa_groups(self, cuda, h, hkv):
        _assert_fwd_close(*_fwd_case(cuda, 2, h, hkv, 384, 384, 192, seed=h + hkv))

    def test_offsets_with_window_and_softcap(self, cuda):
        _assert_fwd_close(*_fwd_case(cuda, 2, 8, 8, 192, 448, 192, seed=2, q_offset=320, kv_offset=64,
                                     window=128, softcap=30.0))

    def test_no_live_key(self, cuda):
        got, want = _fwd_case(cuda, 2, 8, 8, 128, 128, 192, seed=3, kv_offset=64)
        _assert_fwd_close(got, want)
        o, lse = got
        assert not o[:, :, :64].any() and bool((lse[:, :, :64] == tflash.NEG_INF).all())

    def test_two_launches_are_bit_identical(self, cuda):
        g = torch.Generator(device=cuda).manual_seed(5)
        q, k, v = (torch.randn(2, 16, 1000, 192, generator=g, device=cuda).bfloat16() for _ in range(3))
        first = tflash.flash_attention_with_lse(q, k, v)
        second = tflash.flash_attention_with_lse(q, k, v)
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def _decode_case(dev, b, r, d, pos, seed=0, quant=False, **kw):
    """K4 and flash_decode_plain on the same inputs (cache [b, 8, 2048, d])
    → (kernel, plain) outputs."""
    from dstack_tpu_torch.serve.engine import kv_quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 8, r, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(b, 8, 2048, d, generator=g, device=dev).bfloat16() for _ in range(2))
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn(8, r, generator=g, device=dev)
    if quant:
        (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
        kw.update(k_scale=ks, v_scale=vs)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw.setdefault("scale", d**-0.5)
    return tflash_decode.flash_decode(q, k, v, pos, **kw), tflash_decode.flash_decode_plain(q, k, v, pos, **kw)


def _assert_decode_close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
class TestDecodeSplitOnTheCard:
    """K4's split-K edges (decode_plan gives NSPLIT = 5 at batch 8 x 8 KV
    heads and 8 for one slot on 132 SMs) vs flash_decode_plain (2e-2)."""

    @pytest.mark.parametrize("quant", [False, True])
    def test_positions_at_split_edges(self, cuda, quant):
        # the last key of a tile and the first of the next: with NSPLIT even
        # shares of pos // 64 + 1 live tiles, each is a split's edge
        _assert_decode_close(*_decode_case(cuda, 8, 4, 64, [63, 64, 383, 384, 1215, 1216, 2046, 2047], quant=quant))

    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    def test_pos0_under_many_splits(self, cuda, rows_per_slot):
        # one slot: 8 splits, of which all but one are empty partials
        _assert_decode_close(*_decode_case(cuda, 1, 4 * rows_per_slot, 64, [0], rows_per_slot=rows_per_slot))

    @pytest.mark.parametrize("sinks", [False, True])
    def test_window_crossing_splits(self, cuda, sinks):
        # a 1000-key window reaches 17 tiles: 4 splits
        pos = [100, 130, 700, 701, 1000, 1500, 1999, 2040]
        _assert_decode_close(*_decode_case(cuda, 8, 8, 64, pos, seed=1, window=1000, sinks=sinks))

    def test_sinks_with_every_split_empty(self, cuda):
        # positions past the row with a window that ends before it: no key
        # is live in any split, and the sink finish gives 0
        got, want = _decode_case(cuda, 2, 8, 64, [2300, 500], seed=2, window=128, sinks=True)
        _assert_decode_close(got, want)
        assert not got[0].any()

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("group,rows_per_slot", [(4, 1), (4, 5), (8, 5)], ids=["R4", "R20", "R40"])
    @pytest.mark.parametrize("d", [64, 128])
    def test_rows_and_caches(self, cuda, quant, group, rows_per_slot, d):
        last = 2048 - rows_per_slot
        pos = [0, 1, 62, 63, 700, 1500, last - 1, last]
        _assert_decode_close(*_decode_case(cuda, 8, group * rows_per_slot, d, pos, seed=d + group,
                                           quant=quant, rows_per_slot=rows_per_slot))

    @pytest.mark.parametrize("quant", [False, True])
    def test_two_launches_are_bit_identical(self, cuda, quant):
        pos = [0, 40, 200, 300, 700, 1024, 1500, 2043]
        first, _ = _decode_case(cuda, 8, 40, 64, pos, seed=7, quant=quant, rows_per_slot=5, sinks=True)
        second, _ = _decode_case(cuda, 8, 40, 64, pos, seed=7, quant=quant, rows_per_slot=5, sinks=True)
        assert torch.equal(first, second)
