"""The port's dense families against the JAX package on the CPU in f32.

One tiny config a family, made from ``LLAMA_TINY`` (vocab 512, width 128,
two layers, head_dim 32) with ``dataclasses.replace`` of the family's
full config in both packages, so it keeps every family flag, at the
family's own GQA group where the full model's is unusual: Qwen2.5
(q/k/v biases, G 7), Qwen3 (per-head q/k norms, G 4), Mistral (a window of
24, G 4), StarCoder2 (LayerNorm with a bias, gateless GELU MLP, biases on
every projection, a window of 24, G 9), Nemotron/Minitron (LayerNorm1P,
gateless relu² MLP, rotate-half partial rope, G 3), Command-R (LayerNorm,
the parallel block, interleaved rope, the logit scale, with the per-head
q/k LayerNorms switched on, G 1), OLMo-2 (post-norm-only layers, flat q/k
norms, G 1), GLM-4 (interleaved partial rope, q/k/v biases, sandwich
norms, G 16) and Granite (Llama-3.2-3b with Granite's four multipliers,
as ``config_from_hf`` makes it). JAX's ``init_params`` leaves the norms
at identity and the biases at zero, which would hide a wrong LayerNorm,
a wrong flat q/k norm or a missing bias, so every norm and bias is drawn
from a seed, and wq/wk wider so that attention has scores of a few units,
before both packages get the tree.

Held to JAX: the ten full configs field for field with their parameter
counts; each delta alone (the three LayerNorm flavours, Cohere's per-head
q/k norm, relu², partial rope in both conventions at each rope applier's
shapes) within 1e-6; per family the parameter tree key for key, the
whole-sequence forward within 1e-4, the engine's chunk, packed, decode and
verify steps within 1e-4 on the bf16 cache (caches too) and on the int8
cache at the allowances tests/test_torch_gemma.py sets out, and the
default engines' greedy tokens. The decode and verify steps run K4's
route (its plain version here) against JAX's masked einsum: head_dim 32
keeps JAX's Pallas decode kernel out, which tests/test_torch_ops.py holds
at D = 128 instead."""

import dataclasses
import math

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
ATOL = 1e-4  # f32 end to end
INT8_FLIP_SHARE = 1e-3  # int8 cache entries one step apart (test_torch_gemma.py)
INT8_PREFILL_ATOL = 4e-3  # int8 prefill and verify logits (test_torch_gemma.py's module note)
INT8_PREFILL_FLIP_SHARE = 3e-2
MAX_SEQ = 128
CHUNK = 32
NEW = ("llama-3-70b", "llama-3.2-3b", "qwen-2.5-7b", "qwen-3-8b", "mistral-7b", "starcoder2-7b",
       "minitron-4b", "command-r-35b", "olmo-2-7b", "glm-4-9b")
TINY = {f: getattr(tllama.LLAMA_TINY, f) for f in ("vocab_size", "hidden_size", "n_layers", "head_dim",
                                                   "intermediate_size", "remat")}
TINY["max_seq_len"] = MAX_SEQ
# family → (the full config both packages name, its tiny overrides)
FAMILIES = {
    "qwen2": ("qwen-2.5-7b", dict(n_heads=7, n_kv_heads=1)),
    "qwen3": ("qwen-3-8b", dict(n_heads=4, n_kv_heads=1)),
    "mistral": ("mistral-7b", dict(n_heads=8, n_kv_heads=2, sliding_window=24)),
    "starcoder2": ("starcoder2-7b", dict(n_heads=9, n_kv_heads=1, sliding_window=24)),
    "nemotron": ("minitron-4b", dict(n_heads=6, n_kv_heads=2)),
    "cohere": ("command-r-35b", dict(n_heads=4, n_kv_heads=4, qk_norm=True)),
    "olmo2": ("olmo-2-7b", dict(n_heads=4, n_kv_heads=4)),
    "glm4": ("glm-4-9b", dict(n_heads=16, n_kv_heads=1)),
    "granite": ("llama-3.2-3b", dict(n_heads=6, n_kv_heads=2, attn_scale=0.015625, embed_multiplier=12.0,
                                     residual_multiplier=0.22, logit_scale=0.125)),
}


def _configs(family: str) -> tuple:
    name, extra = FAMILIES[family]
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


def _tree(family: str) -> dict:
    """The JAX tiny tree as numpy: every norm and bias drawn from a seed
    around its identity, wq/wk drawn wider."""
    if family not in _TREES:
        jc, _ = _configs(family)
        tr = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
        rng = np.random.default_rng(11)

        def draw(name, a):
            if name.endswith("norm"):
                return (a + rng.standard_normal(a.shape) * 0.3).astype(np.float32)
            if name.startswith("b"):
                return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            if name in ("wq", "wk"):
                return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            return a

        tr["layers"] = {n: draw(n, a) for n, a in tr["layers"].items()}
        tr["final_norm"] = draw("final_norm", tr["final_norm"])
        _TREES[family] = tr
    return _TREES[family]


@pytest.fixture(params=sorted(FAMILIES), scope="module")
def family(request):
    return request.param


@pytest.fixture(scope="module")
def setup(family):
    """(JAX config, port config, JAX params, port params) of ``family``."""
    jc, tc = _configs(family)
    tr = _tree(family)
    return jc, tc, jax.tree.map(jnp.asarray, tr), tllama.params_from_jax(tr, tc, device="cpu")


# ---------------------------------------------------------------------------
# configs, delta functions, parameters
# ---------------------------------------------------------------------------


class TestConfigs:
    @pytest.mark.parametrize("name", NEW)
    def test_full_configs_match_jax(self, name):
        t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.head_dim == 128 and t.rope_dim == j.rope_dim
        assert t.num_params() == j.num_params() and t.num_active_params() == j.num_active_params()
        assert tllama.layer_windows(t) == jllama.layer_windows(j)

    def test_tiny_params_are_counted_as_jax_counts_them(self, family):
        """num_params of each tiny config is JAX's, and the tree holds as
        many values (JAX counts no q/k norm leaves)."""
        jc, tc = _configs(family)
        assert tc.num_params() == jc.num_params()
        qk = sum(a.size for n, a in _tree(family)["layers"].items() if n in ("q_norm", "k_norm"))
        shapes = jax.tree_util.tree_leaves(tllama.param_shapes(tc), is_leaf=lambda s: isinstance(s, tuple))
        assert sum(math.prod(s) for s in shapes) == tc.num_params() + qk

    @pytest.mark.parametrize("fields", [dict(qk_norm=True, qk_norm_flat=True),
                                        dict(pre_norm=False, post_norms=False)])
    def test_post_init_refuses_what_jax_refuses(self, fields):
        with pytest.raises(ValueError) as t:
            dataclasses.replace(tllama.LLAMA_TINY, **fields)
        with pytest.raises(ValueError) as j:
            dataclasses.replace(jllama.LLAMA_TINY, **fields)
        assert str(t.value) == str(j.value)


def _norm_weight(flavour: str, rng, lead=()) -> np.ndarray:
    shape = (*lead, 2, 64) if flavour in ("layernorm1p", "layernorm_bias") else (*lead, 64)
    return rng.standard_normal(shape).astype(np.float32)


class TestDeltas:
    @pytest.mark.parametrize("flavour", ["layernorm", "layernorm1p", "layernorm_bias", "rms"])
    def test_model_norm(self, flavour):
        rng = np.random.default_rng(0)
        x, w = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1, _norm_weight(flavour, rng)
        jc = dataclasses.replace(jllama.LLAMA_TINY, norm_type=flavour)
        tc = dataclasses.replace(tllama.LLAMA_TINY, norm_type=flavour)
        j = jllama.model_norm(jnp.asarray(x), jnp.asarray(w), jc)
        t = tllama.model_norm(_t(x), _t(w), tc)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("flavour", ["layernorm", "layernorm1p", "layernorm_bias"])
    def test_model_norm_in_bf16(self, flavour):
        """Computed in f32 and rounded once, as JAX rounds it."""
        rng = np.random.default_rng(1)
        x, w = rng.standard_normal((4, 64)).astype(np.float32), _norm_weight(flavour, rng)
        jc = dataclasses.replace(jllama.LLAMA_TINY, norm_type=flavour)
        tc = dataclasses.replace(tllama.LLAMA_TINY, norm_type=flavour)
        j = jllama.model_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jc)
        t = tllama.model_norm(_t(x).bfloat16(), _t(w).bfloat16(), tc)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))

    def test_cohere_per_head_qk_norm(self):
        rng = np.random.default_rng(2)
        q, k = rng.standard_normal((2, 4, 3, 32)).astype(np.float32), rng.standard_normal((2, 2, 3, 32)).astype(np.float32)
        layer = {"q_norm": rng.standard_normal((4, 32)).astype(np.float32),
                 "k_norm": rng.standard_normal((2, 32)).astype(np.float32)}
        jc = dataclasses.replace(jllama.COMMAND_R_35B, qk_norm=True)
        tc = dataclasses.replace(tllama.COMMAND_R_35B, qk_norm=True)
        jq, jk = jllama.qk_norm_apply(jnp.asarray(q), jnp.asarray(k), {n: jnp.asarray(w) for n, w in layer.items()}, jc)
        tq, tk = tllama.qk_norm_apply(_t(q), _t(k), {n: _t(w) for n, w in layer.items()}, tc)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)

    def test_relu2(self):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        j = jllama.act_fn(jllama.MINITRON_4B)(jnp.asarray(x))
        t = tllama.act_fn(tllama.MINITRON_4B)(_t(x))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("name", ["glm-4-9b", "minitron-4b", "command-r-35b"])
    def test_partial_and_interleaved_rope(self, name):
        """GLM rotates the first half of a head interleaved, Nemotron the
        first half rotate-half, Command-R the whole head interleaved, at
        the shapes of the forward (:func:`apply_rope`), decode and verify;
        the tail of a partial rope passes through unchanged."""
        jc, tc = jllama.CONFIGS[name], tllama.CONFIGS[name]
        rng = np.random.default_rng(3)
        pos = np.arange(40, dtype=np.int32)
        (jcos, jsin), _ = jllama.dual_rope_freqs(jc, jnp.asarray(pos))
        (tcos, tsin), _ = tllama.dual_rope_freqs(tc, _t(pos))
        assert tuple(tcos.shape) == (40, tc.rope_dim // 2)
        x = rng.standard_normal((2, 3, 40, 128)).astype(np.float32)
        j = jllama.apply_rope(jnp.asarray(x), jcos, jsin, interleaved=jc.rope_interleaved)
        t = tllama.apply_rope(_t(x), tcos, tsin, interleaved=tc.rope_interleaved)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)
        if tc.partial_rotary < 1:
            np.testing.assert_array_equal(t.numpy()[..., tc.rope_dim:], x[..., tc.rope_dim:])
        # decode: [B, H, 1, D] at per-slot angles [B, rope_dim / 2]
        xd = x[:, :, :1]
        j = jengine._apply_rope_batch(jnp.asarray(xd), jcos[:2], jsin[:2], interleaved=jc.rope_interleaved)
        t = tengine._apply_rope_batch(_t(xd), tcos[:2], tsin[:2], tc.rope_interleaved)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)
        # verify and packed prefill: [B, H, S, D] at [B, S, rope_dim / 2]
        xs, jc3, js3 = x[:, :, :5], jcos[:10].reshape(2, 5, -1), jsin[:10].reshape(2, 5, -1)
        j = jengine._rope_rows(jnp.asarray(xs), jc3, js3, interleaved=jc.rope_interleaved)
        t = tengine._rope_rows(_t(xs), tcos[:10].reshape(2, 5, -1), tsin[:10].reshape(2, 5, -1), tc.rope_interleaved)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


class TestParams:
    def test_params_from_jax_is_key_for_key(self, family):
        tree = _tree(family)
        tp = tllama.params_from_jax(tree, _configs(family)[1], device="cpu")
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in flat:
            node = tp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), leaf)

    def test_init_params_matches_jax_shapes_and_identity_norms(self, family):
        jc, tc = _configs(family)
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
            if path[-1].key.endswith("norm") or path[-1].key.startswith("b"):
                np.testing.assert_array_equal(node.float().numpy(), leaf)


def test_forward_matches_jax(setup):
    """The whole-sequence forward (as /v1/embeddings runs it, autograd
    off) within 1e-4 at every position."""
    jcfg, tcfg, jp, tp = setup
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40))
    want = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = tllama.forward(tp, torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_training_refuses_the_new_deltas(setup):
    """Every family trains (the name is from before the dense-family
    deltas trained): under remat, the trainer's default, the full
    fine-tune's loss and every gradient within 1e-4 of JAX's remat step
    (tests/test_torch_family_train.py holds them without remat, and the
    LoRA gradients)."""
    from dstack_tpu_torch.train import step as tstep
    from tests.test_torch_family_train import _batch, _close_tree, _jb, _tb, jax_full_loss

    jcfg, tcfg, jp, tp = setup
    jcfg, tcfg = dataclasses.replace(jcfg, remat=True), dataclasses.replace(tcfg, remat=True)
    batch = _batch(tcfg.vocab_size, t=40)
    jl, jg = jax.jit(jax.value_and_grad(jax_full_loss(jcfg)))(jp, _jb(batch))
    tl, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=ATOL)
    _close_tree(tg, jg)


# ---------------------------------------------------------------------------
# the engine's step functions and the engines
# ---------------------------------------------------------------------------

# the JAX engine's step functions jitted once a config and static key
_J_CHUNK = jax.jit(jengine.prefill_chunk_step, static_argnames=("config", "start"))
_J_PACKED = jax.jit(jengine.prefill_packed_step, static_argnames=("config",))
_J_DECODE = jax.jit(jengine.decode_step, static_argnames=("config", "decode_kernel"))
_J_VERIFY = jax.jit(jengine.verify_step, static_argnames=("config", "decode_kernel"))


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


PROMPTS = _prompts(3, [20, 63, 5, 40])  # two of them past one chunk
_PREFILLED: dict = {}


def _prefilled(setup, kv_quant) -> tuple:
    """Both caches after the serial prefill of PROMPTS into slots 0-3,
    chunk by chunk (later chunks reach back past the windows), each
    chunk's logits checked; → copies of (JAX cache, port cache). On the
    int8 cache the port's is a copy of JAX's, so each step after starts
    from equal caches (tests/test_torch_gemma.py's module note)."""
    jcfg, tcfg, jp, tp = setup
    key = (tcfg, kv_quant)
    if key not in _PREFILLED:
        atol, flips = (INT8_PREFILL_ATOL, INT8_PREFILL_FLIP_SHARE) if kv_quant else (ATOL, INT8_FLIP_SHARE)
        jc = jengine.init_cache(jcfg, 4, MAX_SEQ, kv_quant=kv_quant)
        tc = tengine.init_cache(tcfg, 4, MAX_SEQ, device="cpu", kv_quant=kv_quant)
        for slot, p in enumerate(PROMPTS):
            for start in range(0, len(p), CHUNK):
                part = p[start : start + CHUNK]
                toks = np.zeros((1, CHUNK), np.int32)
                toks[0, : len(part)] = part
                jl, jc = _J_CHUNK(jp, jc, jnp.asarray(toks), jnp.asarray(slot), jnp.asarray(len(part) - 1),
                                  config=jcfg, start=start)
                tl, tc = tengine.prefill_chunk_step(tp, tc, torch.from_numpy(toks).long(), slot,
                                                    len(part) - 1, tcfg, start=start)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=ATOL)
        _assert_caches(tc, jc, flips)
        _PREFILLED[key] = (jc, tc)
    jc, tc = _PREFILLED[key]
    copy = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()} if kv_quant else tc
    return jc, {n: a.clone() for n, a in copy.items()}


@pytest.mark.parametrize("kv_quant", [None, "int8"])
class TestStepFunctions:
    def test_prefill_chunk_step(self, setup, kv_quant):
        """Six chunks at starts 0 and 32 (K1's plain version with the
        family's window, q/k norms and rope)."""
        _prefilled(setup, kv_quant)

    def test_prefill_packed_step(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        jc, tc = _prefilled(setup, kv_quant)
        tokens = np.random.default_rng(2).integers(0, 256, size=(4, CHUNK)).astype(np.int32)
        slots = np.array([2, 0, 3, 0], np.int32)
        starts = np.array([5, 20, 40, 0], np.int32)
        last_ix = np.array([29, 31, 10, -1], np.int32)  # the last row is a pad row
        jl, jc = _J_PACKED(jp, jc, *(jnp.asarray(a) for a in (tokens, slots, starts, last_ix)), config=jcfg)
        tl, tc = tengine.prefill_packed_step(tp, tc, *(torch.from_numpy(a).long() for a in (tokens, slots, starts, last_ix)), tcfg)
        np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], rtol=ATOL,
                                   atol=INT8_PREFILL_ATOL if kv_quant else ATOL)
        _assert_caches(tc, jc, INT8_PREFILL_FLIP_SHARE if kv_quant else INT8_FLIP_SHARE)

    def test_decode_step(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        jc, tc = _prefilled(setup, kv_quant)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in PROMPTS], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = _J_DECODE(jp, jc, jnp.asarray(tok), jnp.asarray(pos), write_mask=jnp.asarray(mask),
                           config=jcfg, decode_kernel="einsum")
        tl, tc = tengine.decode_step(tp, tc, _t(tok).long(), _t(pos), tcfg, write_mask=_t(mask),
                                     decode_kernel="flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_caches(tc, jc)

    def test_verify_step(self, setup, kv_quant):
        jcfg, tcfg, jp, tp = setup
        jc, tc = _prefilled(setup, kv_quant)
        tokens = np.random.default_rng(5).integers(0, 256, size=(4, 5)).astype(np.int32)
        positions = np.array([len(p) for p in PROMPTS], np.int32)
        mask = np.array([True, True, False, True])
        jl, jc = _J_VERIFY(jp, jc, jnp.asarray(tokens), jnp.asarray(positions), write_mask=jnp.asarray(mask),
                           config=jcfg, decode_kernel="einsum")
        tl, tc = tengine.verify_step(tp, tc, _t(tokens).long(), _t(positions), tcfg, _t(mask),
                                     decode_kernel="flash")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=ATOL,
                                   atol=INT8_PREFILL_ATOL if kv_quant else ATOL)
        _assert_caches(tc, jc, INT8_PREFILL_FLIP_SHARE if kv_quant else INT8_FLIP_SHARE)


def _drive(eng, gen_cls, waves) -> list:
    """The scheduler's call sequence, wave by wave (test_torch_gpt_oss.py)."""
    records = []
    for prompts in waves:
        slots = [eng.start_request(list(p), gen_cls(max_new_tokens=10)) for p in prompts]
        while eng._prefilling:
            records.append(("prefill", eng.prefill_wave()))
        while any(eng.active[s] for s in slots):
            out = eng.step()
            records.append((eng._last_step_phase, out))
        for s in slots:
            eng.release(s)
    return records


def test_engines_emit_identical_greedy_tokens(setup):
    """The default engines (packed prefill, speculative verify, turbo, the
    prefix cache) on the bf16 cache: the same records wave by wave."""
    jcfg, tcfg, jp, tp = setup
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9, decode_kernel="einsum")
    je = jengine.InferenceEngine(jcfg, jp, **kw)
    te = tengine.InferenceEngine(tcfg, tp, device="cpu", **kw)
    phrase = [5, 9, 13, 17]
    shared = _prompts(8, [70])[0]
    waves = [
        [(phrase * 10)[:36]],
        _prompts(9, [20, 45, 70]),  # a concurrent burst: a packed wave
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],  # reuses 64 cached positions
    ]
    assert _drive(te, tengine.GenParams, waves) == _drive(je, jengine.GenParams, waves)
    st = te.stats
    assert st["packed_dispatches"] >= 1 and st["turbo_dispatches"] >= 1
    assert st["prefix_hits"] == je.prefix_hits == 1
    _assert_caches(te.cache, je.cache)
