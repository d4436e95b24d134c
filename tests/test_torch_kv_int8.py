"""The port's int8 KV cache and K4's plain int8 and verify forms against
the JAX package on the CPU.

``kv_quantize`` must give the JAX int8 values exactly (the division
``x / s`` and round-half-to-even), with scales and dequantized values
within 1e-7 relative. ``flash_decode`` on a CPU tensor runs its plain
version, held here to the Pallas ``_decode_kernel`` in interpret mode,
as the JAX package's own tests run it: the int8 cache with per-token
scales, ``rows_per_slot`` > 1 (speculative verify), both together, with
and without a window, at positions 0, on a tile edge and where
``pos + S - 1`` crosses a tile; tolerance 2e-5 (f32). The cache helpers
(``_cwrite_at``'s drop rule, ``copy_cache_prefix``) are held to their
JAX counterparts exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.ops import flash_decode as tflash_decode
from dstack_tpu_torch.serve import engine as tengine

TOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


class TestQuantize:
    @pytest.mark.parametrize("seed,shape,scale", [(0, (2, 3, 64), 1.0), (1, (4, 2, 7, 128), 30.0),
                                                  (2, (5, 64), 1e-3)])
    def test_int8_values_exact_scales_close(self, seed, shape, scale):
        rng = np.random.default_rng(seed)
        x = _rand(rng, *shape) * scale
        x.reshape(-1, shape[-1])[0] = 0.0  # an all-zero vector: the 1e-8 floor
        jq, js = jengine.kv_quantize(jnp.asarray(x))
        tq, ts = tengine.kv_quantize(_t(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
        jd = jengine.kv_dequant(jq, js, jnp.float32)
        td = tengine.kv_dequant(tq, ts, torch.float32)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-7, atol=0)

    def test_round_half_to_even(self):
        # absmax 127 gives scale 1: the halves land exactly on .5
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0.0]], np.float32)
        tq, _ = tengine.kv_quantize(_t(x))
        jq, _ = jengine.kv_quantize(jnp.asarray(x))
        assert tq.tolist() == [[127, 0, 2, 2, 0, -2, 4, 0]]
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def _inputs(rng, b, hkv, rows, t, d, quant):
    q = _rand(rng, b, hkv, rows, d)
    k, v = _rand(rng, b, hkv, t, d), _rand(rng, b, hkv, t, d)
    if not quant:
        return (q, k, v), {}, {}
    kq, ks = jengine.kv_quantize(jnp.asarray(k))
    vq, vs = jengine.kv_quantize(jnp.asarray(v))
    jkw = dict(k_scale=ks, v_scale=vs)
    tkw = dict(k_scale=_t(ks), v_scale=_t(vs))
    return (q, np.asarray(kq), np.asarray(vq)), jkw, tkw


class TestFlashDecodeVariants:
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("group,rows_per_slot", [(2, 3), (4, 5), (2, 5), (4, 3)])
    @pytest.mark.parametrize("window", [0, 64])
    def test_matches_pallas_interpret(self, quant, group, rows_per_slot, window):
        rng = np.random.default_rng(10 * group + rows_per_slot)
        # positions: 0, a tile edge, and pos + S - 1 crossing the 128-key tile
        pos = np.array([0, 127, 126, 200], np.int32)
        (q, k, v), jkw, tkw = _inputs(rng, 4, 2, group * rows_per_slot, 256, 64, quant)
        j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), scale=0.125,
            window=jnp.asarray(window, jnp.int32), block_k=128, interpret=True,
            rows_per_slot=rows_per_slot, **jkw,
        )
        t = tflash_decode.flash_decode(
            _t(q), _t(k), _t(v), _t(pos), scale=0.125, window=window,
            rows_per_slot=rows_per_slot, **tkw,
        )
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("softcap", [0.0, 30.0])
    def test_int8_decode_matches_pallas_interpret(self, softcap):
        rng = np.random.default_rng(7)
        pos = np.array([3, 255], np.int32)
        (q, k, v), jkw, tkw = _inputs(rng, 2, 2, 4, 256, 64, True)
        j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), scale=0.125,
            softcap=softcap, block_k=128, interpret=True, **jkw,
        )
        t = tflash_decode.flash_decode(_t(q), _t(k), _t(v), _t(pos), scale=0.125, softcap=softcap, **tkw)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    def test_kernel_argument_checks(self):
        # what the card path checks before a launch: whole [G, S] row
        # groups, and an int8 cache with f32 [B, Hkv, T] scales
        q = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16)
        kb = torch.zeros(1, 1, 128, 64, dtype=torch.bfloat16)
        k8 = torch.zeros(1, 1, 128, 64, dtype=torch.int8)
        pos = torch.zeros(1, dtype=torch.int32)
        sc = torch.ones(1, 1, 128)
        tflash_decode._check(q, kb, kb, pos, None, None, 2)
        tflash_decode._check(q, k8, k8, pos, sc, sc, 4)
        with pytest.raises(ValueError, match="rows_per_slot=3"):
            tflash_decode._check(q, kb, kb, pos, None, None, 3)
        with pytest.raises(TypeError, match="int8"):
            tflash_decode._check(q, kb, kb, pos, sc, sc, 1)
        with pytest.raises(ValueError, match="k_scale"):
            tflash_decode._check(q, k8, k8, pos, sc[..., :64], sc, 1)

    def test_scales_come_together(self):
        x = torch.zeros(1, 1, 4, 64)
        with pytest.raises(ValueError, match="together"):
            tflash_decode.flash_decode(
                x, x, x, torch.zeros(1, dtype=torch.int32), scale=0.125, k_scale=torch.ones(1, 1, 64)
            )


class TestCache:
    def test_init_cache_int8_layout(self):
        c = tengine.init_cache(tllama.LLAMA_TINY_64, 3, 256, device="cpu", kv_quant="int8")
        j = jengine.init_cache(jllama.LLAMA_TINY_64, 3, 256, kv_quant="int8")
        assert set(c) == set(j) == {"k", "v", "k_s", "v_s"}
        for n in c:
            assert tuple(c[n].shape) == j[n].shape
            assert str(c[n].dtype).split(".")[-1] == str(j[n].dtype)

    @pytest.mark.parametrize("kv_quant", ["fp8", "int4"])
    def test_unknown_kv_quant_raises(self, kv_quant):
        with pytest.raises(ValueError, match="unknown kv_quant"):
            tengine.init_cache(tllama.LLAMA_TINY_64, 1, 256, device="cpu", kv_quant=kv_quant)

    @pytest.mark.parametrize("quant", [False, True])
    def test_cwrite_at_rows_match_mode_drop(self, quant):
        # [B, S] entries: rows 1 and 2 hold dropped entries whose
        # redirected index would collide with kept ones in torch indexing
        rng = np.random.default_rng(3)
        b, h, t, d, s = 3, 2, 16, 8, 4
        base = _rand(rng, b, h, t, d)
        new = _rand(rng, b, s, h, d)
        wpos = np.array([[0, 1, 2, 3], [16, 0, 17, 1], [16, 16, 16, 16]], np.int32)
        jc = (jnp.asarray(base), jnp.ones((b, h, t))) if quant else jnp.asarray(base)
        tc = (_t(base), torch.ones(b, h, t)) if quant else _t(base)
        if quant:
            jq, _ = jengine.kv_quantize(jnp.asarray(base))
            jc, tc = (jq, jc[1]), (_t(jq), tc[1])
        jout = jengine._cwrite_at(jc, jnp.arange(b), jnp.asarray(wpos), jnp.asarray(new))
        tengine._cwrite_at(tc, torch.arange(b), _t(wpos), _t(new))
        for got, want in zip(tc if quant else (tc,), jout if quant else (jout,)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("kv_quant", [None, "int8"])
    def test_copy_cache_prefix_matches_jax(self, kv_quant):
        rng = np.random.default_rng(4)
        j = jengine.init_cache(jllama.LLAMA_TINY_64, 3, 256, kv_quant=kv_quant)
        j = {n: jnp.asarray(_rand(rng, *a.shape)).astype(a.dtype) for n, a in j.items()}
        t = {n: _t(np.asarray(a)) for n, a in j.items()}
        j = jengine.copy_cache_prefix(j, jnp.asarray(2), jnp.asarray(0), p=64)
        out = tengine.copy_cache_prefix(t, 2, 0, p=64)
        assert out is t  # in place
        for n in j:
            np.testing.assert_array_equal(t[n].numpy(), np.asarray(j[n]))
