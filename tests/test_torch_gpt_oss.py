"""The port's gpt-oss slice against the JAX package on the CPU in f32.

A tiny gpt-oss (every gpt-oss flag, yarn rope, windows of 32 on even
layers, 4 experts with 2 a token at capacity factor 1.25, so 64-token
chunks drop tokens; q_dim 512 against hidden 256) is built with
``dataclasses.replace`` in both packages. The JAX ``init_params`` leaves
its sinks and biases at 0, so they are overwritten with seeded numpy
values before both packages get the tree.

Held to JAX: the config's counts and windows (exactly), yarn rope (1e-6),
K4's plain version with sinks against the Pallas ``_decode_kernel`` in
interpret mode (2e-5, bf16-layout and int8 caches, S = 1 and 5, window 0
and 32, a row with no live key), ``attention`` with sinks on the K1 +
``sink_postscale`` route and on the masked route (2e-5), the five engine
step functions (logits 1e-4, caches as test_torch_serve_breadth.py holds
them), and the default and serial engines' greedy tokens on both caches.
The ``cuda``-marked tests hold K4's four sinks forms and K1 with the
sink rescale to their plain versions on the card (bf16, 2e-2) and skip
where there is none."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.models import moe as jmoe
from dstack_tpu.ops.attention import attention as jax_attention
from dstack_tpu.ops.attention import sink_postscale as jax_sink_postscale
from dstack_tpu.ops.flash import flash_attention_with_lse as jax_flash_with_lse
from dstack_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.models import moe as tmoe
from dstack_tpu_torch.ops import attention as tattention
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.ops import flash_decode as tflash_decode
from dstack_tpu_torch.serve import engine as tengine

TOL = 2e-5  # one op in f32
ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
# of the int8 cache entries, each off by one step at most: the two
# frameworks' f32 K/V differ by about 1e-6 relative after a few MoE layers
# (and rope's angles by position x 1 ulp), and a value that close to a
# half step rounds to the neighbouring integer (seen: up to 1.4e-4)
INT8_FLIP_SHARE = 1e-3
MAX_SEQ = 256
CHUNK = 64
TINY = dict(
    vocab_size=512, hidden_size=256, n_layers=4, n_heads=8, n_kv_heads=2, head_dim=64,
    intermediate_size=256, n_experts=4, experts_per_token=2, sliding_window=32,
    max_seq_len=MAX_SEQ, remat=False,
)
JC = dataclasses.replace(jllama.GPT_OSS_20B, dtype=jnp.float32, **TINY)
TC = dataclasses.replace(tllama.GPT_OSS_20B, dtype=torch.float32, **TINY)
NONZERO = {  # leaf → std of the seeded values written over JAX's zeros
    "sinks": 1.0, "b_router": 0.5, "bq": 0.05, "bk": 0.05, "bv": 0.05, "bo": 0.02,
    "b_gate": 0.05, "b_up_e": 0.05, "b_down_e": 0.02,
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    """The JAX tiny gpt-oss tree as numpy, sinks and biases nonzero."""
    tr = jax.tree.map(np.asarray, jllama.init_params(JC, jax.random.key(0)))
    rng = np.random.default_rng(7)
    for name, std in NONZERO.items():
        leaf = tr["layers"][name]
        tr["layers"][name] = (rng.standard_normal(leaf.shape) * std).astype(leaf.dtype)
    return tr


@pytest.fixture(scope="module")
def weights(tree):
    return jax.tree.map(jnp.asarray, tree), tllama.params_from_jax(tree, TC, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


class TestConfig:
    def test_fields_match_jax(self):
        for f in dataclasses.fields(TC):
            if f.name != "dtype":
                assert getattr(TC, f.name) == getattr(JC, f.name), f.name
        assert TC.q_dim == 512 != TC.hidden_size

    @pytest.mark.parametrize("name", ["gpt-oss-20b", "gpt-oss-120b"])
    def test_full_configs_match_jax(self, name):
        t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.num_params() == j.num_params()

    def test_num_params_and_windows(self):
        assert TC.num_params() == JC.num_params()
        assert tllama.layer_windows(TC) == jllama.layer_windows(JC) == [32, 0, 32, 0]
        assert tllama.layer_windows(tllama.GPT_OSS_20B) == jllama.layer_windows(jllama.GPT_OSS_20B)
        assert tllama.layer_windows(tllama.LLAMA_TINY_64) == [0, 0]

    @pytest.mark.parametrize("truncate", [False, True])
    def test_yarn_rope_matches_jax(self, truncate):
        """Within 1e-6 at positions 0-15, where every frequency of the
        ramp shows. The two frameworks' f32 ``theta ** x`` differ in the
        last bit for 2 of the 32 frequencies, so the angle's error grows
        with the position: up to 2047 (a serving row) it stays in 5e-5."""
        scaling = tllama.GPT_OSS_20B.rope_scaling[:6] + (truncate,)
        for pos, tol in ((np.arange(16, dtype=np.int32), 1e-6), (np.arange(2048, dtype=np.int32), 5e-5)):
            jc, js = jllama.rope_freqs(jnp.asarray(pos), 64, 150000.0, scaling)
            tc, ts = tllama.rope_freqs(_t(pos), 64, 150000.0, scaling)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=tol, rtol=tol)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=tol, rtol=tol)
        plain, _ = tllama.rope_freqs(_t(np.arange(16, dtype=np.int32)), 64, 150000.0)
        assert not torch.allclose(plain * scaling[5], tc[:16], atol=1e-3)  # the ramp shows


class TestParams:
    def test_params_from_jax_is_key_for_key(self, tree):
        tp = tllama.params_from_jax(tree, TC, device="cpu")
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in flat:
            node = tp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), leaf)

    def test_f32_leaves_stay_f32(self, tree):
        tp = tllama.params_from_jax(tree, TC, device="cpu", dtype=torch.bfloat16)
        layers = tp["layers"]
        assert layers["sinks"].dtype == layers["b_router"].dtype == torch.float32
        np.testing.assert_array_equal(layers["sinks"].numpy(), tree["layers"]["sinks"])
        assert layers["w_gate"].dtype == layers["b_gate"].dtype == torch.bfloat16

    @pytest.mark.parametrize("change", ["missing", "extra"])
    def test_params_from_jax_refuses_a_missing_or_extra_leaf(self, tree, change):
        bad = {**tree, "layers": dict(tree["layers"])}
        if change == "missing":
            del bad["layers"]["sinks"]
        else:
            bad["layers"]["w_shared_gate"] = np.zeros((4, 256, 256), np.float32)
        with pytest.raises(ValueError, match="keys"):
            tllama.params_from_jax(bad, TC, device="cpu")

    def test_init_params_shapes_and_dtypes(self, tree):
        c = dataclasses.replace(TC, dtype=torch.bfloat16)
        p = tllama.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            node = p
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            want = torch.float32 if path[-1].key in tllama.F32_LEAVES else torch.bfloat16
            assert node.dtype == want, path
        assert not p["layers"]["sinks"].any() and not p["layers"]["b_gate"].any()
        assert 0.015 < float(p["layers"]["w_gate"].float().std()) < 0.025

    def test_the_training_forward_refuses_gpt_oss(self, weights):
        with pytest.raises(NotImplementedError, match="gpt-oss"):
            tllama.forward(weights[1], torch.zeros(1, 4, dtype=torch.long), TC)


# ---------------------------------------------------------------------------
# attention with sinks
# ---------------------------------------------------------------------------


class TestSinks:
    @pytest.mark.parametrize("window", [0, 32])
    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    @pytest.mark.parametrize("quant", [False, True])
    def test_flash_decode_plain_matches_pallas_interpret(self, quant, rows_per_slot, window):
        rng = np.random.default_rng(3)
        b, hkv, g, d, t = 4, 2, 4, 64, 256
        r = g * rows_per_slot
        q = _rand(rng, b, hkv, r, d)
        k, v = _rand(rng, b, hkv, t, d), _rand(rng, b, hkv, t, d)
        sinks = _rand(rng, hkv, r) * 2.0
        # slot 3 with a window sits past the row: no key is live for it
        pos = np.array([0, 127, 251 - (rows_per_slot - 1), 300 if window else 200], np.int32)
        kw = dict(scale=0.125, rows_per_slot=rows_per_slot)
        jk, jv, tk, tv, jx, tx = k, v, _t(k), _t(v), {}, {}
        if quant:
            jk, ks = jengine.kv_quantize(jnp.asarray(k))
            jv, vs = jengine.kv_quantize(jnp.asarray(v))
            tk, tv = _t(jk), _t(jv)
            jx = dict(k_scale=ks, v_scale=vs)
            tx = dict(k_scale=_t(ks), v_scale=_t(vs))
        j = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(pos),
            window=jnp.asarray(window, jnp.int32), sinks=jnp.asarray(sinks), block_k=128,
            interpret=True, **kw, **jx,
        )
        o = tflash_decode.flash_decode(
            _t(q), tk, tv, _t(pos), window=window, sinks=_t(sinks), **kw, **tx
        )
        np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=TOL, rtol=TOL)
        if window:
            assert not o[3].any()

    @pytest.mark.parametrize("window", [0, 32])
    @pytest.mark.parametrize("q_offset", [0, 128])
    def test_k1_route_with_postscale_matches_jax(self, q_offset, window):
        """An int offset with ``sinks_forward_only``: the port's K1 route
        (here its plain version with the logsumexp) and ``sink_postscale``,
        against JAX's masked sink softmax and its own Pallas K1 + postscale."""
        rng = np.random.default_rng(4)
        q, k, v = _rand(rng, 1, 8, 128, 64), _rand(rng, 1, 2, 256, 64), _rand(rng, 1, 2, 256, 64)
        sinks = _rand(rng, 8) * 2.0
        kw = dict(causal=True, scale=0.125, q_offset=q_offset, window=window)
        jq, jk, jv, js = (jnp.asarray(a) for a in (q, k, v, sinks))
        j = jax_attention(jq, jk, jv, sinks=js, sinks_forward_only=True, **kw)
        jo, jl = jax_flash_with_lse(jq, jk, jv, interpret=True, block_q=128, block_k=128, **kw)
        jpost = jax_sink_postscale(jo, jl, js)
        t = tattention.attention(_t(q), _t(k), _t(v), sinks=_t(sinks), sinks_forward_only=True, **kw)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(jpost), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("forward_only", [False, True])
    def test_masked_route_matches_jax(self, forward_only):
        """A vector offset (packed prefill), or sinks on a call that may be
        differentiated: the masked attention with ``sink_softmax``."""
        rng = np.random.default_rng(5)
        q, k, v = _rand(rng, 3, 8, 16, 64), _rand(rng, 3, 2, 96, 64), _rand(rng, 3, 2, 96, 64)
        sinks = _rand(rng, 8)
        off = np.array([0, 40, 80], np.int32)
        offset = (jnp.asarray(off), _t(off).long()) if forward_only else (24, 24)
        kw = dict(causal=True, scale=0.125, window=24, sinks_forward_only=forward_only)
        j = jax_attention(*(jnp.asarray(a) for a in (q, k, v)), q_offset=offset[0],
                          sinks=jnp.asarray(sinks), **kw)
        tq = _t(q).requires_grad_()
        t = tattention.attention(tq, _t(k), _t(v), q_offset=offset[1], sinks=_t(sinks), **kw)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL, rtol=TOL)
        t.sum().backward()  # the masked route is differentiable
        assert tq.grad is not None and bool(torch.isfinite(tq.grad).all())


# ---------------------------------------------------------------------------
# the engine's step functions and the engines
# ---------------------------------------------------------------------------


def _assert_caches(tc: dict, jc: dict) -> None:
    """f32 values and int8 scales within 1e-4; int8 values equal but for
    at most INT8_FLIP_SHARE of them one step apart (the frameworks' f32
    inputs to the quantizer differ in their last bits)."""
    assert set(tc) == set(jc)
    for n in jc:
        got, want = tc[n].numpy(), np.asarray(jc[n])
        if want.dtype == np.int8:
            flips = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert flips.max() <= 1 and (flips != 0).mean() <= INT8_FLIP_SHARE, (n, flips.sum())
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=n)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


def _prefilled(weights, kv_quant, prompts):
    """Both caches after the same serial prefill of ``prompts`` into slots
    0, 1, ... (each one chunk at start 0)."""
    jp, tp = weights
    jc = jengine.init_cache(JC, 4, MAX_SEQ, kv_quant=kv_quant)
    tc = tengine.init_cache(TC, 4, MAX_SEQ, device="cpu", kv_quant=kv_quant)
    for slot, p in enumerate(prompts):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, : len(p)] = p
        jl, jc = jengine.prefill_chunk_step(
            jp, jc, jnp.asarray(toks), jnp.asarray(slot), jnp.asarray(len(p) - 1), JC, start=0
        )
        tl, tc = tengine.prefill_chunk_step(
            tp, tc, torch.from_numpy(toks).long(), slot, len(p) - 1, TC, start=0
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    _assert_caches(tc, jc)
    return jc, tc


@pytest.fixture
def drops(monkeypatch):
    """Counts the MoE choices dropped at capacity in the port's calls."""
    seen = {"dropped": 0}
    real = tmoe.router

    def router(*a, **kw):
        out = real(*a, **kw)
        seen["dropped"] += int((out[1] >= a[4]).sum())
        return out

    monkeypatch.setattr(tmoe, "router", router)
    return seen


@pytest.mark.parametrize("kv_quant", [None, "int8"])
class TestStepFunctions:
    def test_prefill_chunk_step(self, weights, kv_quant, drops):
        """Two chunks of one prompt (the second at start 64, so windowed
        layers reach back into the first): K1's route with the sink
        rescale, the MoE on [1, 64, H] chunks (which drop tokens)."""
        jp, tp = weights
        jc = jengine.init_cache(JC, 2, MAX_SEQ, kv_quant=kv_quant)
        tc = tengine.init_cache(TC, 2, MAX_SEQ, device="cpu", kv_quant=kv_quant)
        prompt = _prompts(0, [100])[0]
        for start in (0, CHUNK):
            part = prompt[start : start + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, : len(part)] = part
            jl, jc = jengine.prefill_chunk_step(
                jp, jc, jnp.asarray(toks), jnp.asarray(1), jnp.asarray(len(part) - 1), JC,
                start=start,
            )
            tl, tc = tengine.prefill_chunk_step(
                tp, tc, torch.from_numpy(toks).long(), 1, len(part) - 1, TC, start=start
            )
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)
        assert drops["dropped"] > 0

    def test_prefill_packed_step(self, weights, kv_quant):
        jp, tp = weights
        jc, tc = _prefilled(weights, kv_quant, _prompts(1, [64, 40]))
        rng = np.random.default_rng(2)
        tokens = rng.integers(0, 256, size=(4, CHUNK)).astype(np.int32)
        slots = np.array([2, 0, 1, 0], np.int32)
        starts = np.array([0, 64, 40, 0], np.int32)
        last_ix = np.array([29, 63, 10, -1], np.int32)  # the last row is a pad row
        jl, jc = jengine.prefill_packed_step(
            jp, jc, *(jnp.asarray(a) for a in (tokens, slots, starts, last_ix)), JC
        )
        tl, tc = tengine.prefill_packed_step(
            tp, tc, *(torch.from_numpy(a).long() for a in (tokens, slots, starts, last_ix)), TC
        )
        np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_decode_step(self, weights, kv_quant):
        jp, tp = weights
        prompts = _prompts(3, [20, 63, 5, 40])
        jc, tc = _prefilled(weights, kv_quant, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = jengine.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), JC,
                                     write_mask=jnp.asarray(mask), decode_kernel="flash")
        tl, tc = tengine.decode_step(tp, tc, _t(tok).long(), _t(pos), TC,
                                     write_mask=_t(mask), decode_kernel="flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_verify_step(self, weights, kv_quant):
        jp, tp = weights
        prompts = _prompts(4, [20, 63, 5, 33])
        jc, tc = _prefilled(weights, kv_quant, prompts)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, 256, size=(4, 5)).astype(np.int32)
        positions = np.array([len(p) for p in prompts], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = jengine.verify_step(jp, jc, jnp.asarray(tokens), jnp.asarray(positions), JC,
                                     jnp.asarray(mask), decode_kernel="flash")
        tl, tc = tengine.verify_step(tp, tc, _t(tokens).long(), _t(positions), TC, _t(mask),
                                     decode_kernel="flash")
        assert tl.shape == (4, 5, TC.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_decode_loop(self, weights, kv_quant):
        jp, tp = weights
        prompts = _prompts(6, [9, 30, 64, 17])
        jc, tc = _prefilled(weights, kv_quant, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        rem = np.array([8, 2, 8, 8], np.int32)
        act = np.array([True, True, False, True])
        eos = np.array([-1, -1, -1, -1], np.int32)
        jout = jengine.decode_loop(
            jp, jc, *(jnp.asarray(a) for a in (tok, pos, rem, act, eos)), JC,
            steps=4, max_seq=MAX_SEQ, decode_kernel="flash",
        )
        tout = tengine.decode_loop(
            tp, tc, _t(tok).long(), _t(pos), _t(rem), _t(act), _t(eos).long(), TC,
            steps=4, max_seq=MAX_SEQ, decode_kernel="flash",
        )
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        for got, want in zip(tout[2:], jout[2:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_caches(tout[1], jout[1])

    def test_einsum_matches_flash(self, weights, kv_quant):
        """decode_kernel="einsum" (the plain masked attention with
        ``sink_softmax`` over the whole row) and "flash" (K4's wrapper)."""
        _, tp = weights
        prompts = _prompts(7, [12, 50, 3, 3])
        _, tc = _prefilled(weights, kv_quant, prompts)
        tokens = torch.tensor([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]] + [[0] * 5] * 2)
        positions = torch.tensor([12, 50, 3, 3], dtype=torch.int32)
        mask = torch.tensor([True, True, False, False])
        copy = {n: a.clone() for n, a in tc.items()}
        fl, _ = tengine.verify_step(tp, tc, tokens, positions, TC, mask, decode_kernel="flash")
        el, _ = tengine.verify_step(tp, copy, tokens, positions, TC, mask, decode_kernel="einsum")
        np.testing.assert_allclose(fl.numpy(), el.numpy(), atol=ATOL, rtol=ATOL)


def _drive(eng, gen_cls, waves) -> list:
    """The scheduler's call sequence, wave by wave: admit every prompt,
    ``prefill_wave`` until none is pending, then ``step`` until the
    wave's slots are done, recording each call's output and kind."""
    records = []
    for prompts in waves:
        slots = [eng.start_request(list(p), gen_cls(max_new_tokens=16)) for p in prompts]
        while eng._prefilling:
            records.append(("prefill", eng.prefill_wave()))
        while any(eng.active[s] for s in slots):
            out = eng.step()
            records.append((eng._last_step_phase, out))
        for s in slots:
            eng.release(s)
    return records


SERIAL = dict(prefill_pack=1, spec_draft=0, turbo_steps=0, prefix_cache=False)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("mode", ["default", "serial"])
def test_engines_emit_identical_greedy_tokens(weights, kv_quant, mode):
    jp, tp = weights
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9,
              kv_quant=kv_quant, decode_kernel="flash", **(SERIAL if mode == "serial" else {}))
    je = jengine.InferenceEngine(JC, jp, **kw)
    te = tengine.InferenceEngine(TC, tp, device="cpu", **kw)
    phrase = [5, 9, 13, 17]
    shared = _prompts(8, [140])[0]
    waves = [
        [(phrase * 12)[:40]],
        _prompts(9, [20, 70, 100]),  # a concurrent burst: a packed wave by default
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],  # reuses 128 cached positions by default
    ]
    jrec = _drive(je, jengine.GenParams, waves)
    trec = _drive(te, tengine.GenParams, waves)
    assert trec == jrec
    st = te.stats
    if mode == "default":
        assert st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1
        assert st["prefix_hits"] == je.prefix_hits == 1
    else:
        assert st["decode_steps"] and not (st["packed_dispatches"] or st["turbo_dispatches"])
    _assert_caches(te.cache, je.cache)


def test_every_cache_attention_carries_the_sinks(weights, monkeypatch):
    """The identities chip_smoke.py checks on the card, counted through
    the plain versions' calls: K4's wrapper n_layers times per plain,
    verify and turbo device step, every call with sinks and with the
    layer's window; the prefill attention with sinks and forward-only."""
    _, tp = weights
    calls = {"decode": 0, "prefill": 0, "windows": []}
    eng = tengine.InferenceEngine(TC, tp, max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                  turbo_quiet_s=1e9, device="cpu")
    real_fd, real_fa = tengine.flash_decode, tengine.attention

    def fd(*a, **kw):
        assert kw["sinks"] is not None and kw["sinks"].shape == (2, 4 * kw["rows_per_slot"])
        calls["decode"] += 1
        calls["windows"].append(kw["window"])
        return real_fd(*a, **kw)

    def fa(*a, **kw):
        assert kw["sinks"] is not None and kw["sinks_forward_only"]
        calls["prefill"] += isinstance(kw["q_offset"], int)
        return real_fa(*a, **kw)

    monkeypatch.setattr(tengine, "flash_decode", fd)
    monkeypatch.setattr(tengine, "attention", fa)
    _drive(eng, tengine.GenParams, [[[7] * 40], _prompts(10, [30, 90, 150]), [[3] * 5]])
    st = eng.stats
    steps = st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
    assert calls["decode"] == TC.n_layers * steps and steps
    assert calls["windows"][: TC.n_layers] == tllama.layer_windows(TC)
    assert calls["prefill"] == TC.n_layers * (st["prefill_dispatches"] - st["packed_dispatches"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestKernelsOnTheCard:
    """K4's sinks forms and K1 with the sink rescale against their plain
    versions at gpt-oss's shapes (G = 8, bf16)."""

    @pytest.mark.parametrize("window", [0, 128])
    @pytest.mark.parametrize("rows_per_slot", [1, 5])
    @pytest.mark.parametrize("quant", [False, True])
    def test_flash_decode_sinks(self, cuda, quant, rows_per_slot, window):
        g = torch.Generator(device=cuda).manual_seed(3)
        r = 8 * rows_per_slot
        q = torch.randn(8, 8, r, 64, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(8, 8, 2048, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
        sinks = torch.randn(8, r, generator=g, device=cuda)
        pos = torch.tensor([0, 1, 63, 64, 700, 1500, 2000, 2048 - rows_per_slot],
                           dtype=torch.int32, device=cuda)
        kw = dict(scale=0.125, window=window, rows_per_slot=rows_per_slot, sinks=sinks)
        if quant:
            (k, ks), (v, vs) = tengine.kv_quantize(k), tengine.kv_quantize(v)
            kw.update(k_scale=ks, v_scale=vs)
        before = dict(tflash_decode.LAUNCHES_BY_VARIANT)
        o = tflash_decode.flash_decode(q, k, v, pos, **kw)
        po = tflash_decode.flash_decode_plain(q, k, v, pos, **kw)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        form = f"{'int8' if quant else 'bf16'}_{'verify' if rows_per_slot > 1 else 'decode'}_sinks"
        assert tflash_decode.LAUNCHES_BY_VARIANT[form] == before[form] + 1

    @pytest.mark.parametrize("window", [0, 128])
    def test_flash_forward_with_sink_rescale(self, cuda, window):
        g = torch.Generator(device=cuda).manual_seed(4)
        q = torch.randn(1, 64, 256, 64, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(1, 8, 2048, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
        sinks = torch.randn(64, generator=g, device=cuda)
        kw = dict(q_offset=512, window=window, scale=0.125)
        o = tattention.attention(q, k, v, sinks=sinks, sinks_forward_only=True, **kw)
        po = tflash.flash_attention_plain(q, k, v, sinks=sinks, **kw)[0]
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
