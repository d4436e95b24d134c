"""The PyTorch port's dense Llama and serving steps held against the JAX
package on the CPU in f32: the same weights (carried across with
``params_from_jax``) and the same token ids (drawn with numpy) must give
the same logits within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.serve import engine as tengine

ATOL = 1e-4  # f32 end to end; sums in another order than XLA's


def _params(config_j=jllama.LLAMA_TINY_64, config_t=tllama.LLAMA_TINY_64):
    jp = jllama.init_params(config_j, jax.random.key(0))
    tp = tllama.params_from_jax(jax.tree.map(np.asarray, jp), config_t, device="cpu")
    return jp, tp


def _close(t: torch.Tensor, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=atol)


class TestParams:
    def test_params_from_jax_is_key_for_key(self):
        jp, tp = _params()
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        assert len(flat_j) == len(jax.tree_util.tree_leaves(
            {k: dict(v) if isinstance(v, dict) else v for k, v in tp.items()}
        ))
        for path, leaf in flat_j:
            node = tp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    def test_params_from_jax_refuses_a_missing_leaf(self):
        jp, _ = _params()
        tree = jax.tree.map(np.asarray, jp)
        del tree["layers"]["w_gate"]
        with pytest.raises(ValueError, match="keys"):
            tllama.params_from_jax(tree, tllama.LLAMA_TINY_64, device="cpu")

    def test_init_params_shapes_and_scales(self):
        c = tllama.LLAMA_TINY_64
        p = tllama.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        jp = jllama.init_params(jllama.LLAMA_TINY_64, jax.random.key(0))
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            node = p
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == tuple(leaf.shape), path
            # same distribution: matching std within sampling noise
            js, ts = float(np.std(np.asarray(leaf))), float(node.std())
            if js == 0.0:  # norms start at one
                assert torch.equal(node, torch.ones_like(node)), path
            else:
                assert abs(js - ts) / js < 0.1, (path, js, ts)

    def test_config_refuses_partial_gqa_groups(self):
        with pytest.raises(ValueError, match="not divisible"):
            tllama.LlamaConfig(n_heads=6, n_kv_heads=4)


class TestLayers:
    @pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192), ("linear", 2.0)])
    def test_rope_freqs(self, scaling):
        pos = np.arange(0, 300, 7)
        jc, js = jllama.rope_freqs(jnp.asarray(pos), 64, 500000.0, scaling)
        tc, ts = tllama.rope_freqs(torch.from_numpy(pos), 64, 500000.0, scaling)
        _close(tc, jc, 1e-5)
        _close(ts, js, 1e-5)

    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 128)).astype(np.float32)
        w = rng.standard_normal((128,)).astype(np.float32)
        j = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
        t = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        _close(t, j, 1e-5)

    def test_embed_lookup_fills_out_of_range_with_zeros(self):
        jp, tp = _params()
        ids = np.asarray([[0, 5, 511, 512, 9999]])
        j = jengine._embed_lookup(jp, jnp.asarray(ids), jllama.LLAMA_TINY_64)
        t = tengine._embed_lookup(tp, torch.from_numpy(ids), tllama.LLAMA_TINY_64)
        _close(t, j, 0)
        assert not t[0, 3:].any()


class TestServingSteps:
    def _run(self, prompt_len: int, chunk: int):
        """Chunked prefill of one prompt into slot 1, then 3 batched
        decode steps where slot 0 is masked out (write_mask)."""
        cj, ct = jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64
        jp, tp = _params()
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cj.vocab_size, size=prompt_len)
        jc = jengine.init_cache(cj, 2, 256)
        tc = tengine.init_cache(ct, 2, 256, device="cpu")
        for start in range(0, prompt_len, chunk):
            toks = np.zeros((1, chunk), np.int32)
            part = prompt[start : start + chunk]
            toks[0, : len(part)] = part
            final = start + chunk >= prompt_len
            last_ix = (prompt_len - 1 - start) if final else chunk - 1
            jl, jc = jengine.prefill_chunk_step(
                jp, jc, jnp.asarray(toks), jnp.asarray(1, jnp.int32),
                jnp.asarray(last_ix, jnp.int32), cj, start=start,
            )
            tl, tc = tengine.prefill_chunk_step(
                tp, tc, torch.from_numpy(toks).long(), 1, last_ix, ct, start=start,
            )
            _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        pos = np.asarray([0, prompt_len], np.int32)
        mask = np.asarray([False, True])
        for step in range(3):
            toks = rng.integers(0, cj.vocab_size, size=2).astype(np.int32)
            for kern in ("einsum", "flash"):
                jl, jc2 = jengine.decode_step(
                    jp, jc, jnp.asarray(toks), jnp.asarray(pos), cj,
                    write_mask=jnp.asarray(mask), decode_kernel=kern,
                )
                tl, tc2 = tengine.decode_step(
                    tp, {k: v.clone() for k, v in tc.items()},
                    torch.from_numpy(toks).long(), torch.from_numpy(pos), ct,
                    write_mask=torch.from_numpy(mask), decode_kernel=kern,
                )
                _close(tl, jl)
            jc, tc = jc2, tc2
            _close(tc["k"], jc["k"])
            pos = pos + mask.astype(np.int32)

    def test_single_chunk_prompt(self):
        self._run(prompt_len=40, chunk=64)

    def test_multi_chunk_prompt(self):
        # start > 0: the chunk's queries attend at q_offset = start
        self._run(prompt_len=100, chunk=32)
