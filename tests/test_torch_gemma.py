"""The port's Gemma slice against the JAX package on the CPU in f32.

Two tiny configs at Gemma's head width of 256 are built with
``dataclasses.replace`` in both packages: a gemma-2-style one (sandwich
norms, windows of 24 on even layers, an attention softcap and a logit
cap small enough to bite at these widths) and a gemma-3-style one (q/k
norms, windows of 24 on two of every three layers, so the fourth layer is
a tail past the JAX engine's grouped scan; dual rope with linear
interpolation on the global layer). JAX's ``init_params`` leaves the
offset norms at 0 (identity) and the q/k norms at 1, so every norm is
overwritten with seeded numpy values, and wq/wk are drawn wider so the
softcap sees scores of a few units, before both packages get the tree.

Held to JAX: the four full configs and their windows (exactly), each
Gemma delta function (the offset RMSNorm, the tanh GELU, the q/k norms,
the dual rope with linear scaling, 1e-6), the five engine step functions
(logits 1e-4, caches as test_torch_gpt_oss.py holds them), and the serial
and default engines' greedy tokens on both caches. K1 and K4 at head_dim
256 are held to the Pallas kernels in tests/test_torch_ops.py (their
plain versions) and on the card there.

The int8 cache: a prefill chunk quantizes its own tokens' K/V and attends
over them in the same layer, so a value that rounds one int8 step apart
(the two frameworks' f32 K/V differ in their last bits) moves the next
layer's inputs, whose K/V then round apart more often. Through 4 layers
whose q/k norms or wide projections give scores of a few units, up to
1.1 % of the int8 values land one step apart and the prefill logits move
by up to 1.6e-3 (measured); the JAX engine against itself, with weights
1e-6 apart, moves as far (1.1e-3 and 1.8e-3). So an int8 prefill is held
to INT8_PREFILL_ATOL and INT8_PREFILL_FLIP_SHARE, as is a verify step,
which quantizes S = 5 tokens of its own a row (seen: 1.7e-4); a decode
step and a turbo macro-step start from JAX's own int8 cache and are held
to 1e-4. Where no cascade runs, the int8 forms are held tighter: each
layer's output from JAX's own cache and the same input within 1e-4
(test_int8_prefill_layer_by_layer), and the engine's int8 prefill,
packed and verify steps on a one-layer model within INT8_ONE_LAYER_ATOL
and INT8_FLIP_SHARE. One int8 value of a chunk one step apart moves that
model's logits by up to 1.34e-4 (measured), so 3e-4; a chunk attending
over its unquantized K/V moves them 1.3e-2, and its scales written one
step off 2.9e-3 or more (measured on copies of the engine so broken:
both fail here, and the four-layer tests above catch both through the
int8 values, though the scale fault's logits stay within 4e-3 on the
gemma-2-style model)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.serve import engine as tengine

TOL = 1e-6  # one op in f32
ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
INT8_FLIP_SHARE = 1e-3  # int8 cache entries one step apart (see test_torch_gpt_oss.py)
INT8_PREFILL_ATOL = 4e-3  # int8 prefill logits (see the module note)
INT8_PREFILL_FLIP_SHARE = 3e-2  # ... and its int8 values one step apart
INT8_ONE_LAYER_ATOL = 3e-4  # int8 prefill logits of one layer (the module note)
MAX_SEQ = 128
CHUNK = 32
TINY = dict(
    vocab_size=512, hidden_size=128, n_heads=4, n_kv_heads=2, head_dim=256,
    intermediate_size=256, n_layers=4, sliding_window=24, max_seq_len=MAX_SEQ, remat=False,
)
MODELS = {
    "gemma2": ("gemma-2-2b", dict(attn_softcap=2.0, logit_softcap=0.5)),
    "gemma3": ("gemma-3-4b", dict(sliding_pattern=3)),
}
NORMS = ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm", "q_norm", "k_norm")


def _configs(model: str) -> tuple:
    name, extra = MODELS[model]
    return (dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32, **TINY, **extra),
            dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32, **TINY, **extra))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TREES: dict = {}


def _tree(model: str) -> dict:
    """The JAX tiny tree as numpy: norms seeded, wq/wk drawn wider."""
    if model not in _TREES:
        jc, _ = _configs(model)
        tr = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
        rng = np.random.default_rng(11)
        layers = tr["layers"]
        for name in NORMS:
            if name in layers:
                layers[name] = (rng.standard_normal(layers[name].shape) * 0.5).astype(np.float32)
        for name in ("wq", "wk"):
            layers[name] = (rng.standard_normal(layers[name].shape) * 0.1).astype(np.float32)
        tr["final_norm"] = (rng.standard_normal(tr["final_norm"].shape) * 0.5).astype(np.float32)
        _TREES[model] = tr
    return _TREES[model]


@pytest.fixture(params=sorted(MODELS), scope="module")
def model(request):
    return request.param


@pytest.fixture(scope="module")
def setup(model):
    """(JAX config, port config, JAX params, port params) of ``model``."""
    jc, tc = _configs(model)
    tr = _tree(model)
    return jc, tc, jax.tree.map(jnp.asarray, tr), tllama.params_from_jax(tr, tc, device="cpu")


# ---------------------------------------------------------------------------
# configs, delta functions, parameters
# ---------------------------------------------------------------------------


class TestConfigs:
    @pytest.mark.parametrize("name", ["gemma-2b", "gemma-2-2b", "gemma-3-1b", "gemma-3-4b"])
    def test_full_configs_match_jax(self, name):
        t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.head_dim == 256
        assert t.num_params() == j.num_params()
        assert tllama.layer_windows(t) == jllama.layer_windows(j)

    def test_tiny_windows(self):
        assert tllama.layer_windows(_configs("gemma2")[1]) == [24, 0, 24, 0]
        assert tllama.layer_windows(_configs("gemma3")[1]) == [24, 24, 0, 24]


class TestDeltas:
    @pytest.mark.parametrize("offset", [False, True])
    def test_rms_norm(self, offset):
        rng = np.random.default_rng(0)
        x, w = rng.standard_normal((3, 5, 64)).astype(np.float32), rng.standard_normal(64).astype(np.float32)
        j = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset=offset)
        t = tllama.rms_norm(_t(x), _t(w), 1e-6, offset=offset)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    def test_model_norm_offset_in_bf16(self):
        """The (1 + w) scale is applied in f32 and rounded once."""
        rng = np.random.default_rng(1)
        x, w = rng.standard_normal((4, 256)).astype(np.float32), rng.standard_normal(256).astype(np.float32)
        jc, tc = jllama.GEMMA3_4B, tllama.GEMMA3_4B
        j = jllama.model_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jc)
        t = tllama.model_norm(_t(x).bfloat16(), _t(w).bfloat16(), tc)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))

    @pytest.mark.parametrize("name", ["llama-3.2-1b", "gemma-2-2b"])
    def test_act_fn(self, name):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        j = jllama.act_fn(jllama.CONFIGS[name])(jnp.asarray(x))
        t = tllama.act_fn(tllama.CONFIGS[name])(_t(x))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    def test_act_fn_refuses_an_unknown_activation(self):
        with pytest.raises(ValueError, match="hidden_act"):
            tllama.act_fn(dataclasses.replace(tllama.GEMMA_2B, hidden_act="gelu_exact"))

    def test_qk_norm_apply(self):
        rng = np.random.default_rng(2)
        q, k = rng.standard_normal((2, 4, 3, 256)).astype(np.float32), rng.standard_normal((2, 2, 3, 256)).astype(np.float32)
        layer = {n: rng.standard_normal(256).astype(np.float32) for n in ("q_norm", "k_norm")}
        jc, tc = _configs("gemma3")
        jq, jk = jllama.qk_norm_apply(jnp.asarray(q), jnp.asarray(k), {n: jnp.asarray(w) for n, w in layer.items()}, jc)
        tq, tk = tllama.qk_norm_apply(_t(q), _t(k), {n: _t(w) for n, w in layer.items()}, tc)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("name", ["gemma-3-4b", "gemma-3-1b", "gemma-2-2b"])
    def test_dual_rope_and_layer_rope(self, name):
        """Global layers at rope_theta with the linear scaling, sliding
        layers at the unscaled local theta (Gemma3); one pair twice
        elsewhere. Within 1e-6 at positions 0-15; to 2047 within 5e-5
        (f32 angles grow with the position, as the yarn test notes)."""
        jc, tc = jllama.CONFIGS[name], tllama.CONFIGS[name]
        for pos, tol in ((np.arange(16, dtype=np.int32), TOL), (np.arange(2048, dtype=np.int32), 5e-5)):
            jr = jllama.dual_rope_freqs(jc, jnp.asarray(pos))
            tr = tllama.dual_rope_freqs(tc, _t(pos))
            for jp, tp in zip(jr, tr):
                for a, b in zip(jp, tp):
                    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=tol)
            for window in (0, tc.sliding_window):
                for a, b in zip(jllama.layer_rope(jr, jc, window), tllama.layer_rope(tr, tc, window)):
                    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=tol)
        assert (tr[0] is tr[1]) == (not tc.rope_local_theta)
        if tc.rope_local_theta:
            assert not torch.allclose(tr[0][0], tr[1][0])


class TestParams:
    def test_params_from_jax_is_key_for_key(self, model):
        tree = _tree(model)
        tp = tllama.params_from_jax(tree, _configs(model)[1], device="cpu")
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in flat:
            node = tp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), leaf)

    def test_init_params_matches_jax_shapes_and_identity_norms(self, model):
        jc, tc = _configs(model)
        jt = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
        tp = tllama.init_params(dataclasses.replace(tc, dtype=torch.bfloat16),
                                torch.Generator().manual_seed(0), device="cpu")
        flat = jax.tree_util.tree_leaves_with_path(jt)
        assert len(flat) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in flat:
            node = tp
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape and node.dtype == torch.bfloat16, path
            if path[-1].key.endswith("norm"):  # the offset norms 0, the q/k norms 1
                np.testing.assert_array_equal(node.float().numpy(), leaf)


# ---------------------------------------------------------------------------
# the engine's step functions and the engines
# ---------------------------------------------------------------------------


def _assert_caches(tc: dict, jc: dict, flip_share: float = INT8_FLIP_SHARE) -> None:
    """f32 values and int8 scales within 1e-4; int8 values equal but for
    at most ``flip_share`` of them one step apart."""
    assert set(tc) == set(jc)
    for n in jc:
        got, want = tc[n].numpy(), np.asarray(jc[n])
        if want.dtype == np.int8:
            flips = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert flips.max() <= 1 and (flips != 0).mean() <= flip_share, (n, flips.sum())
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=n)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


def _jax_copy(jc: dict) -> dict:
    return {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}


def _int8_tol(setup) -> tuple:
    """(logit atol, int8 flip share) of an int8 prefill or verify: the
    cascade's allowance through several layers, the decode step's within
    one (the module note)."""
    return (INT8_PREFILL_ATOL, INT8_PREFILL_FLIP_SHARE) if setup[1].n_layers > 1 else (
        INT8_ONE_LAYER_ATOL, INT8_FLIP_SHARE)


def _prefilled(setup, kv_quant, prompts):
    """Both caches after the same serial prefill of ``prompts`` into slots
    0, 1, ... (chunk by chunk, so later chunks reach back past the
    window), checked chunk by chunk. On the int8 cache the port's comes
    back as a copy of JAX's, so the step after starts from equal caches
    (the module note)."""
    jcfg, tcfg, jp, tp = setup
    atol, flip_share = _int8_tol(setup) if kv_quant else (ATOL, INT8_FLIP_SHARE)
    jc = jengine.init_cache(jcfg, 4, MAX_SEQ, kv_quant=kv_quant)
    tc = tengine.init_cache(tcfg, 4, MAX_SEQ, device="cpu", kv_quant=kv_quant)
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), CHUNK):
            part = p[start : start + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, : len(part)] = part
            jl, jc = jengine.prefill_chunk_step(jp, jc, jnp.asarray(toks), jnp.asarray(slot),
                                                jnp.asarray(len(part) - 1), jcfg, start=start)
            tl, tc = tengine.prefill_chunk_step(tp, tc, torch.from_numpy(toks).long(), slot,
                                                len(part) - 1, tcfg, start=start)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=ATOL)
    _assert_caches(tc, jc, flip_share)
    return jc, (_jax_copy(jc) if kv_quant else tc)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
class TestStepFunctions:
    def test_prefill_chunk_step(self, setup, kv_quant):
        """Three chunks of a 90-token prompt: windowed layers reach back
        into the chunks before (K1's plain version with window and
        softcap, the local rope on sliding layers)."""
        _prefilled(setup, kv_quant, _prompts(0, [90]))

    def test_prefill_packed_step(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        jc, tc = _prefilled(setup, kv_quant, _prompts(1, [64, 40]))
        rng = np.random.default_rng(2)
        tokens = rng.integers(0, 256, size=(4, CHUNK)).astype(np.int32)
        slots = np.array([2, 0, 1, 0], np.int32)
        starts = np.array([0, 64, 40, 0], np.int32)
        last_ix = np.array([29, 31, 10, -1], np.int32)  # the last row is a pad row
        jl, jc = jengine.prefill_packed_step(jp, jc, *(jnp.asarray(a) for a in (tokens, slots, starts, last_ix)), jcfg)
        tl, tc = tengine.prefill_packed_step(tp, tc, *(torch.from_numpy(a).long() for a in (tokens, slots, starts, last_ix)), tcfg)
        np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], rtol=ATOL,
                                   atol=_int8_tol(setup)[0] if kv_quant else ATOL)
        _assert_caches(tc, jc, _int8_tol(setup)[1])

    def test_decode_step(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        prompts = _prompts(3, [20, 63, 5, 40])
        jc, tc = _prefilled(setup, kv_quant, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = jengine.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg,
                                     write_mask=jnp.asarray(mask), decode_kernel="flash")
        tl, tc = tengine.decode_step(tp, tc, _t(tok).long(), _t(pos), tcfg,
                                     write_mask=_t(mask), decode_kernel="flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_verify_step(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        prompts = _prompts(4, [20, 63, 5, 33])
        jc, tc = _prefilled(setup, kv_quant, prompts)
        tokens = np.random.default_rng(5).integers(0, 256, size=(4, 5)).astype(np.int32)
        positions = np.array([len(p) for p in prompts], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = jengine.verify_step(jp, jc, jnp.asarray(tokens), jnp.asarray(positions), jcfg,
                                     jnp.asarray(mask), decode_kernel="flash")
        tl, tc = tengine.verify_step(tp, tc, _t(tokens).long(), _t(positions), tcfg, _t(mask),
                                     decode_kernel="flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=ATOL,
                                   atol=_int8_tol(setup)[0] if kv_quant else ATOL)
        _assert_caches(tc, jc, _int8_tol(setup)[1])

    def test_decode_loop(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        prompts = _prompts(6, [9, 30, 64, 17])
        jc, tc = _prefilled(setup, kv_quant, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        rem = np.array([8, 2, 8, 8], np.int32)
        act = np.array([True, True, False, True])
        eos = np.array([-1, -1, -1, -1], np.int32)
        jout = jengine.decode_loop(jp, jc, *(jnp.asarray(a) for a in (tok, pos, rem, act, eos)), jcfg,
                                   steps=4, max_seq=MAX_SEQ, decode_kernel="flash")
        tout = tengine.decode_loop(tp, tc, _t(tok).long(), _t(pos), _t(rem), _t(act), _t(eos).long(),
                                   tcfg, steps=4, max_seq=MAX_SEQ, decode_kernel="flash")
        for got, want in zip((tout[0], *tout[2:]), (jout[0], *jout[2:])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_caches(tout[1], jout[1])


@pytest.mark.parametrize("kv_quant", ["int8"])
class TestInt8OneLayer:
    """The engine's int8 prefill, packed and verify steps on the first
    layer of each tiny model (a sliding one: window, softcap, local rope),
    where no cascade runs, held to INT8_ONE_LAYER_ATOL and the decode
    step's INT8_FLIP_SHARE (the module note)."""

    @pytest.fixture(scope="class")
    def setup(self, model):
        tree = dict(_tree(model))
        tree["layers"] = {n: a[:1] for n, a in tree["layers"].items()}
        jc, tc = (dataclasses.replace(c, n_layers=1) for c in _configs(model))
        return jc, tc, jax.tree.map(jnp.asarray, tree), tllama.params_from_jax(tree, tc, device="cpu")

    test_prefill_chunk_step = TestStepFunctions.test_prefill_chunk_step
    test_prefill_packed_step = TestStepFunctions.test_prefill_packed_step
    test_verify_step = TestStepFunctions.test_verify_step


def test_int8_prefill_layer_by_layer(setup):
    """The int8 prefill layer without the cascade: every layer of a chunk
    at position 64 gets the same hidden input and JAX's own int8 cache
    (two chunks of the prompt already written), in both packages. Its
    output is held to 1e-4 and the chunk's int8 values and scales as the
    decode step's are (the module note)."""
    jcfg, tcfg, jp, tp = setup
    prompt = _prompts(13, [3 * CHUNK])[0]
    jc = jengine.init_cache(jcfg, 2, MAX_SEQ, kv_quant="int8")
    for start in (0, CHUNK):
        toks = jnp.asarray([prompt[start : start + CHUNK]], jnp.int32)
        _, jc = jengine.prefill_chunk_step(jp, jc, toks, jnp.asarray(1), jnp.asarray(CHUNK - 1),
                                           jcfg, start=start)
    start, slot = 2 * CHUNK, 1
    pos = start + np.arange(CHUNK, dtype=np.int32)

    def jkv(ck, cv, k, v):
        ck, cv = (jengine._cwrite_chunk(a, t, jnp.asarray(slot), start) for a, t in ((ck, k), (cv, v)))
        return ck, cv, jengine._cread_row(ck, slot, k.dtype), jengine._cread_row(cv, slot, v.dtype)

    def tkv(ck, cv, k, v):
        for a, t in ((ck, k), (cv, v)):
            tengine._cwrite_chunk(a, t, slot, start)
        return tengine._cread_row(ck, slot, k.dtype), tengine._cread_row(cv, slot, v.dtype)

    j_layer = jengine._prefill_one_layer(
        jcfg, jllama.dual_rope_freqs(jcfg, jnp.asarray(pos)), rope_apply=jllama.apply_rope,
        temp_apply=None, kv_update=jkv, q_offset=start)
    t_layer = tengine._prefill_one_layer(
        tcfg, tllama.dual_rope_freqs(tcfg, _t(pos)), rope_apply=tllama.apply_rope, kv_update=tkv,
        q_offset=start)
    x = np.random.default_rng(14).standard_normal((1, CHUNK, tcfg.hidden_size)).astype(np.float32)
    cols = slice(start, start + CHUNK)
    for i, window in enumerate(tllama.layer_windows(tcfg)):
        jl = {n: a[i] for n, a in jp["layers"].items()}
        jx, jck, jcv = j_layer(jnp.asarray(x), jl, (jc["k"][i], jc["k_s"][i]),
                               (jc["v"][i], jc["v_s"][i]), window, False)
        tck, tcv = ((_t(jc[n][i]), _t(jc[n + "_s"][i])) for n in ("k", "v"))
        tx = t_layer(_t(x), tllama.layer_params(tp, i), tck, tcv, window)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=ATOL, err_msg=f"layer {i}")
        _assert_caches({"k": tck[0][slot, :, cols], "k_s": tck[1][slot, :, cols],
                        "v": tcv[0][slot, :, cols], "v_s": tcv[1][slot, :, cols]},
                       {"k": jck[0][slot, :, cols], "k_s": jck[1][slot, :, cols],
                        "v": jcv[0][slot, :, cols], "v_s": jcv[1][slot, :, cols]})


def test_the_caps_and_the_local_rope_matter(setup, model):
    """Without the softcaps (gemma-2-style) or the local theta
    (gemma-3-style) the port's prefill logits move far past 1e-4: the
    tests above would see a dropped delta."""
    _, tcfg, _, tp = setup
    toks = torch.tensor([_prompts(12, [CHUNK])[0]])
    off = (dict(attn_softcap=0.0, logit_softcap=0.0) if model == "gemma2" else dict(rope_local_theta=0.0))
    logits = []
    for cfg in (tcfg, dataclasses.replace(tcfg, **off)):
        cache = tengine.init_cache(cfg, 1, MAX_SEQ, device="cpu")
        logits.append(tengine.prefill_chunk_step(tp, cache, toks, 0, CHUNK - 1, cfg, start=0)[0])
    assert (logits[0] - logits[1]).abs().max() > 100 * ATOL


def _drive(eng, gen_cls, waves) -> list:
    """The scheduler's call sequence, wave by wave (test_torch_gpt_oss.py)."""
    records = []
    for prompts in waves:
        slots = [eng.start_request(list(p), gen_cls(max_new_tokens=12)) for p in prompts]
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
def test_engines_emit_identical_greedy_tokens(setup, kv_quant, mode):
    jcfg, tcfg, jp, tp = setup
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9,
              kv_quant=kv_quant, decode_kernel="flash", **(SERIAL if mode == "serial" else {}))
    je = jengine.InferenceEngine(jcfg, jp, **kw)
    te = tengine.InferenceEngine(tcfg, tp, device="cpu", **kw)
    phrase = [5, 9, 13, 17]
    shared = _prompts(8, [70])[0]
    waves = [
        [(phrase * 10)[:36]],
        _prompts(9, [20, 45, 70]),  # a concurrent burst: a packed wave by default
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],  # reuses 64 cached positions by default
    ]
    assert _drive(te, tengine.GenParams, waves) == _drive(je, jengine.GenParams, waves)
    st = te.stats
    if mode == "default":
        assert st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1
        assert st["prefix_hits"] == je.prefix_hits == 1
    else:
        assert st["decode_steps"] and not (st["packed_dispatches"] or st["turbo_dispatches"])
    _assert_caches(te.cache, je.cache, INT8_PREFILL_FLIP_SHARE)
