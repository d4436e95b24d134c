"""The port's weight-only int8 quantization (``models/quant.py``) and its
int8 products against the JAX package on the CPU.

Held to JAX bit for bit: ``quantize_weight`` at ranks 2, 3 and 4 (a zero
column, values that land on .5 after the division), ``quant_targets`` on
all 27 configs, ``quantize_tree`` on seven tiny configs (llama tied and
untied, moe-tiny, a shared expert, mla-tiny with its dense prelude,
gpt-oss's expert biases, Nemotron's gateless MLP, Qwen2.5's biases), and
the host random tree (``random_quantized_params``: the same numpy stream
in the same order). The on-device random tree (drawn here on the CPU
device) is held to JAX's structure, dtypes and value ranges, and both
keep JAX's refusals with JAX's messages. In f32, within 1e-4: W8's plain
version against JAX's ``_proj`` int8 branch, ``head_logits_einsum`` and
the expert products; the whole-sequence forward of every tiny config's
int8 tree; ``_proj`` with a LoRA bypass on an int8 base. The engine's
steps and engines on int8 trees are in tests/test_torch_quant_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.models import moe as jmoe
from dstack_tpu.models import quant as jquant
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.models import moe as tmoe
from dstack_tpu_torch.models import quant as tquant
from dstack_tpu_torch.ops import w8_matmul as w8

ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
SMALL = dict(vocab_size=512, hidden_size=128, n_layers=2, head_dim=32, intermediate_size=128,
             max_seq_len=128, remat=False)
# name → (JAX config, port config) in f32
TINY = {
    "llama_tied": ("llama-tiny", dict(tie_embeddings=True)),
    "llama_untied": ("llama-tiny", dict(tie_embeddings=False)),
    "moe": ("moe-tiny", {}),
    "shared_expert": ("moe-tiny", dict(moe_shared_expert=True, moe_shared_intermediate=64)),
    "mla": ("mla-tiny", {}),
    "gpt_oss": ("gpt-oss-20b", dict(SMALL, n_heads=4, n_kv_heads=2, head_dim=64, n_experts=4,
                                    experts_per_token=2, sliding_window=16)),
    "gateless": ("minitron-4b", dict(SMALL, n_heads=6, n_kv_heads=2)),
    "biased": ("qwen-2.5-7b", dict(SMALL, n_heads=4, n_kv_heads=1)),
}
# leaves drawn nonzero (JAX makes them zero or identity) so that a wrong
# bias or norm shows: name prefix → std
DRAWN = {"b": 0.05, "sinks": 1.0}


def configs(name: str) -> tuple:
    base, extra = TINY[name]
    return (dataclasses.replace(jllama.CONFIGS[base], dtype=jnp.float32, **extra),
            dataclasses.replace(tllama.CONFIGS[base], dtype=torch.float32, **extra))


_TREES: dict = {}


def jax_tree(name: str) -> dict:
    """The JAX tiny tree as numpy, biases and sinks drawn from a seed."""
    if name not in _TREES:
        jc, _ = configs(name)
        tree = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
        rng = np.random.default_rng(7)
        for stack in ("layers", "dense_layers"):
            for leaf, a in tree.get(stack, {}).items():
                std = DRAWN["sinks"] if leaf == "sinks" else DRAWN["b"] if leaf.startswith("b") else 0
                if std:
                    tree[stack][leaf] = (rng.standard_normal(a.shape) * std).astype(np.float32)
        _TREES[name] = tree
    return _TREES[name]


def trees(name: str) -> tuple:
    """(JAX int8 tree, port int8 tree): each package quantizes its own
    copy of the same f32 tree."""
    jc, tc = configs(name)
    tree = jax_tree(name)
    return (jax.tree.map(jnp.asarray, jquant.quantize_tree(tree, jc)),
            tquant.quantize_tree(tllama.params_from_jax(tree, tc, device="cpu"), tc))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def assert_trees_equal(jt: dict, tt: dict) -> None:
    """Key for key, dtype for dtype, bit for bit."""
    flat = jax.tree_util.tree_leaves_with_path(jt)
    assert len(flat) == len(jax.tree_util.tree_leaves(tt))
    for path, leaf in flat:
        node = tt
        for key in path:
            node = node[key.key]
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            assert node.dtype == torch.bfloat16, path
            a = a.astype(np.float32)
        else:
            assert str(node.dtype).removeprefix("torch.") == str(a.dtype), path
        np.testing.assert_array_equal(_np(node), a, err_msg=str(path))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# quantization, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(40, 24), (3, 40, 24), (2, 3, 40, 24)])
def test_quantize_weight_is_jax_bitwise(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # a zero column: scale 1, values 0
    # a column whose absmax is 127 x 0.5: every other k lands on .5 exactly
    w[..., 5] = (np.arange(shape[-2]) - 20) * 0.5
    w[..., 5][..., 0] = 63.5
    jq, js = jquant.quantize_weight(w)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == shape[:-2] + shape[-1:]
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert (tq.numpy()[..., 3] == 0).all() and (ts.numpy()[..., 3] == 1.0).all()
    # the .5 ties round to even, as np.round does
    assert set(np.abs(tq.numpy()[..., 5]).ravel() % 2) <= {0, 1}
    np.testing.assert_array_equal(tq.numpy()[..., 1, 5], np.round(w[..., 1, 5] / js[..., 5]).astype(np.int8))


def test_quantize_weight_of_bf16_leaves_is_jax_bitwise():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32) * 0.02).bfloat16()
    jq, js = jquant.quantize_weight(w.float().numpy())
    tq, ts = tquant.quantize_weight(w)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    torch.testing.assert_close(tquant.dequantize_weight(tq, ts, torch.float32),
                               torch.from_numpy(np.asarray(jquant.dequantize_weight(jq, js, jnp.float32))),
                               atol=0, rtol=0)


@pytest.mark.parametrize("name", sorted(tllama.CONFIGS))
def test_quant_targets_match_jax(name):
    assert tquant.quant_targets(tllama.CONFIGS[name]) == jquant.quant_targets(jllama.CONFIGS[name])


@pytest.mark.parametrize("name", sorted(TINY))
def test_quantize_tree_is_jax_bitwise(name):
    jt, tt = trees(name)
    assert_trees_equal(jt, tt)
    assert tquant.is_quantized(tt) and not tquant.is_quantized(tllama.params_from_jax(jax_tree(name), configs(name)[1],
                                                                                   device="cpu"))
    _, tc = configs(name)
    assert ("lm_head_q" in tt) == (not tc.tie_embeddings)
    if tc.mla:  # the latent projections stay f32; wo, the FFNs and the experts go int8
        assert {"wq_a", "wq_b", "wkv_a", "wkv_b", "wo_q", "w_gate_q", "w_shared_gate_q"} <= set(tt["layers"])
        assert {"wq_a", "wkv_b", "wo_q", "w_gate_q", "w_up_q", "w_down_q"} <= set(tt["dense_layers"])


def test_a_quantized_gated_tree_stays_gated():
    """JAX renames w_gate to w_gate_q: the config, not the leaf, says the
    MLP is gated, so the int8 forward equals the dequantized tree's."""
    _, tc = configs("llama_untied")
    _, tt = trees("llama_untied")
    assert "w_gate" not in tt["layers"] and not tc.mlp_gateless
    deq = dict(tt)
    deq["layers"] = {n: v for n, v in tt["layers"].items() if not n.endswith(("_q", "_s"))}
    for n in [n[:-2] for n in tt["layers"] if n.endswith("_q")]:
        deq["layers"][n] = tquant.dequantize_weight(tt["layers"][n + "_q"], tt["layers"][n + "_s"], torch.float32)
    deq["lm_head"] = tquant.dequantize_weight(tt["lm_head_q"], tt["lm_head_s"], torch.float32)
    del deq["lm_head_q"], deq["lm_head_s"]
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (1, 12)))
    with torch.no_grad():
        a, b = tllama.forward(tt, tokens, tc), tllama.forward(deq, tokens, tc)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the random trees
# ---------------------------------------------------------------------------


def bf16_configs(name: str) -> tuple:
    """A tiny config in the model dtype, bf16 (the random trees' leaves
    take each leaf's dtype: f32 sinks and router biases beside bf16)."""
    jc, tc = configs(name)
    return dataclasses.replace(jc, dtype=jnp.bfloat16), dataclasses.replace(tc, dtype=torch.bfloat16)


@pytest.mark.parametrize("name", ["llama_untied", "moe", "gpt_oss", "biased", "gateless"])
def test_random_tree_is_jax_bitwise(name):
    jc, tc = bf16_configs(name)
    assert_trees_equal(jquant.random_quantized_params(jc, seed=3), tquant.random_quantized_params(tc, seed=3))


@pytest.mark.parametrize("name", ["llama_tied", "moe", "gpt_oss", "biased"])
def test_on_device_random_tree_matches_jax_structure(name):
    """Keys, shapes, dtypes and value ranges of JAX's on-device tree; the
    values are the generator's own."""
    jc, tc = bf16_configs(name)
    jt = jquant.random_quantized_params_on_device(jc, seed=0)
    tt = tquant.random_quantized_params_on_device(tc, seed=0, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(jt)
    assert len(flat) == len(jax.tree_util.tree_leaves(tt))
    for path, leaf in flat:
        node = tt
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype), path
        k = path[-1].key
        if k.endswith("_q"):
            assert int(node.min()) >= -127 and int(node.max()) <= 127 and int(node.max()) - int(node.min()) > 200
        elif k.endswith("_s"):
            lo, hi = 0.8 * 0.02 / 127, 1.2 * 0.02 / 127
            assert float(node.min()) >= lo * (1 - 1e-6) and float(node.max()) <= hi * (1 + 1e-6)
        elif node.numel() >= 1000:  # N(0, 0.02)
            std = float(node.float().std())
            assert 0.015 < std < 0.025, (path, std)
    # the same seed gives the same tree; another seed another
    again = tquant.random_quantized_params_on_device(tc, seed=0, device="cpu")
    assert torch.equal(again["layers"]["wq_q"], tt["layers"]["wq_q"])
    other = tquant.random_quantized_params_on_device(tc, seed=1, device="cpu")
    assert not torch.equal(other["layers"]["wq_q"], tt["layers"]["wq_q"])


@pytest.mark.parametrize("fn", ["random_quantized_params", "random_quantized_params_on_device"])
@pytest.mark.parametrize("name", ["mla-tiny", "deepseek-v3"])
def test_random_trees_refuse_mla_as_jax_does(fn, name):
    with pytest.raises(ValueError) as want:
        getattr(jquant, fn)(jllama.CONFIGS[name])
    kw = {"device": "cpu"} if fn.endswith("device") else {}
    with pytest.raises(ValueError) as got:
        getattr(tquant, fn)(tllama.CONFIGS[name], **kw)
    assert str(got.value) == str(want.value)


def test_random_trees_refuse_a_dense_prelude_as_jax_does(monkeypatch):
    """JAX's second refusal: a tree with a ``dense_layers`` prelude (only
    DeepSeek has one, and MLA is refused first, so the prelude is forced
    into each package's shape tree)."""
    import dstack_tpu_torch.models.quant as tq_mod

    j_init = jllama.init_params
    monkeypatch.setattr(jllama, "init_params", lambda c, key: {**j_init(c, key), "dense_layers": {"x": jnp.zeros(1)}})
    monkeypatch.setattr(tq_mod, "param_shapes", lambda c: {**tllama.param_shapes(c), "dense_layers": {"x": (1,)}})
    for fn in ("random_quantized_params", "random_quantized_params_on_device"):
        with pytest.raises(ValueError) as want:
            getattr(jquant, fn)(jllama.LLAMA_TINY)
        with pytest.raises(ValueError) as got:
            getattr(tquant, fn)(tllama.LLAMA_TINY, **({"device": "cpu"} if fn.endswith("device") else {}))
        assert str(got.value) == str(want.value) and "dense-prelude" in str(got.value)


# ---------------------------------------------------------------------------
# the int8 products: W8's plain version against JAX's
# ---------------------------------------------------------------------------


def _int8_inputs(rng, lead, k, n):
    q = rng.integers(-127, 128, size=(*lead, k, n), dtype=np.int8)
    s = (rng.uniform(0.8, 1.2, (*lead, n)) * 0.02 / 127).astype(np.float32)
    return q, s


def test_plain_proj_matches_jax_proj():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 96)).astype(np.float32)
    q, s = _int8_inputs(rng, (), 96, 40)
    want = jllama._proj({"w_q": jnp.asarray(q), "w_s": jnp.asarray(s)}, "w", jnp.asarray(x),
                        "bte,ef->btf", "bte,er->btr", "btr,rf->btf")
    got = tllama._proj({"w_q": torch.from_numpy(q), "w_s": torch.from_numpy(s)}, "w", torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    plain = w8.w8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_proj_with_a_lora_bypass_on_an_int8_base():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    q, s = _int8_inputs(rng, (), 64, 32)
    a = rng.standard_normal((64, 4)).astype(np.float32) * 0.1
    b = rng.standard_normal((4, 32)).astype(np.float32) * 0.1
    layer = {"w_q": q, "w_s": s, "w_lora_a": a, "w_lora_b": b, "lora_scale": np.float32(2.0)}
    want = jllama._proj({k: jnp.asarray(v) for k, v in layer.items()}, "w", jnp.asarray(x),
                        "bte,ef->btf", "bte,er->btr", "btr,rf->btf")
    tl = {k: torch.from_numpy(np.asarray(v)) for k, v in layer.items()}
    tl["lora_scale"] = 2.0
    got = tllama._proj(tl, "w", torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["llama_untied", "biased"])
def test_int8_head_matches_jax(name):
    """f32 logits times the f32 scales, then the logit scale, as JAX's
    ``head_logits_einsum`` then ``_lm_head``."""
    jc, tc = configs(name)
    jt, tt = trees(name)
    x = np.random.default_rng(3).standard_normal((3, 4, 128)).astype(np.float32)
    want = jllama.head_logits_einsum(jt, jnp.asarray(x), jc, "bte,ev->btv")
    got = tllama._head_logits(tt, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    got2 = w8.w8_matmul_plain(torch.from_numpy(x), tt["lm_head_q"], tt["lm_head_s"], "head")
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["moe", "shared_expert", "gpt_oss"])
def test_int8_experts_match_jax_moe(name):
    """The expert stacks' scales applied to each product's output before
    gpt-oss's expert biases, as JAX's ``qw`` products."""
    jc, tc = configs(name)
    jt, tt = trees(name)
    layer_j = {n: v[0] for n, v in jt["layers"].items()}
    layer_t = {n: v[0] for n, v in tt["layers"].items()}
    x = np.random.default_rng(4).standard_normal((2, 9, 128)).astype(np.float32)
    kw = dict(renorm=jc.router_renorm, topk_softmax=jc.router_topk_softmax, act=jc.moe_act,
              act_limit=jc.act_limit)
    want, _ = jmoe.moe_mlp(jnp.asarray(x), layer_j, jc.n_experts, jc.experts_per_token, jc.capacity_factor,
                           None, None, **kw)
    got = tmoe.moe_mlp(torch.from_numpy(x), layer_t, tc.n_experts, tc.experts_per_token, tc.capacity_factor, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the whole-sequence forward, and the training refusal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TINY))
def test_int8_forward_matches_jax(name):
    jc, tc = configs(name)
    jt, tt = trees(name)
    tokens = np.random.default_rng(5).integers(0, 512, (2, 24))
    want = np.asarray(jllama.forward(jt, jnp.asarray(tokens), jc))
    with torch.no_grad():
        got = tllama.forward(tt, torch.from_numpy(tokens), tc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_training_refuses_an_int8_tree():
    _, tc = configs("llama_untied")
    _, tt = trees("llama_untied")
    with pytest.raises(ValueError, match="serves only"):
        tllama.lm_head_weight(tt, tc)
    x = torch.randn(1, 3, 128, requires_grad=True)
    with pytest.raises(RuntimeError, match="serve only"):
        tllama._proj({n: v[0] for n, v in tt["layers"].items()}, "wq", x)
