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

    # sinks are served now (test_torch_gpt_oss.py); a chunk mask is not,
    # with or without them
    @pytest.mark.parametrize("kw", [{"chunk": 64}, {"chunk": 64, "sinks": torch.zeros(2)}])
    def test_unported_attention_options_raise(self, kw):
        x = torch.zeros(1, 2, 4, 64)
        with pytest.raises(NotImplementedError):
            tattention.attention(x, x, x, **kw)


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
