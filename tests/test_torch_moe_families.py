"""The port's remaining model families against the JAX package on the CPU
in f32: the softmax-routed MoE (Mixtral, ``moe-tiny``, Qwen3-MoE),
Llama4, Cohere2 and DeepSeek-V3.

One tiny config a family, made with ``dataclasses.replace`` of the
family's full config in both packages (``moe-tiny`` as it is), so it
keeps every family flag: Mixtral at G 4 (8 experts, top 2), Qwen3-MoE at
G 8 (16 experts, top 4, renormalised gates, q/k norms), Llama4 at G 5
with ``nope_pattern`` 2 (layer 1 is NoPE), ``attention_chunk_size`` 16
and an ``attn_temp_floor`` of 8, so that over 40 tokens the chunk mask
bites and the NoPE temperature moves (top-1 sigmoid-input routing with
its shared expert), Cohere2 as Command-R with a window of 24 on layer 0
and its global layer 1 NoPE, and a V3-like MLA config with 8 heads,
sigmoid scores, the selection bias, the group limit (4, 2), the routed
scale and one dense prelude layer. The router weights are drawn wider
than JAX's init, so choices are decisive, and every norm, bias and
selection bias is drawn from a seed, so a misplaced one shows; the
default capacity factor of 1.25 drops choices.

Held to JAX: the five new full configs field for field (with the 27 keys
of ``CONFIGS``), their parameter counts, the layer helpers
(``layer_nope``, ``l2_norm``, ``attn_temp_scales``) and the layout
refusal; the Llama4 router (sigmoid gates, the gate on the expert's
input) and ``attention(chunk=...)`` at 2e-5; per family the whole-sequence
forward, the engine's chunk, packed, decode, verify and turbo steps (on
both caches where the config takes one; the int8 allowances are
tests/test_torch_families.py's) within 1e-4, and the default engines'
greedy tokens. Llama4 decodes on the einsum path by default, as JAX's
engine does."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.models import moe as jmoe
from dstack_tpu.ops import attention as jattention
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.models import moe as tmoe
from dstack_tpu_torch.ops import attention as tattention
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.serve import engine as tengine

OP_TOL = 2e-5  # one op in f32
ATOL = 1e-4  # f32 end to end
INT8_FLIP_SHARE = 1e-3  # int8 cache entries one step apart (test_torch_gemma.py)
INT8_PREFILL_ATOL = 4e-3  # int8 prefill and verify logits (test_torch_gemma.py's module note)
INT8_PREFILL_FLIP_SHARE = 3e-2
MAX_SEQ = 128
CHUNK = 32
NEW = ("mixtral-8x7b", "moe-tiny", "qwen-3-30b-a3b", "llama-4-scout", "deepseek-v3")
TINY = dict(vocab_size=512, hidden_size=128, n_layers=2, head_dim=64, intermediate_size=64,
            max_seq_len=MAX_SEQ, remat=False)
V3_TINY = dict(  # DeepSeek-V3's deltas at narrow widths, V3's mscale² on its own head width
    vocab_size=512, hidden_size=128, n_layers=3, n_heads=8, n_kv_heads=8, head_dim=16,
    intermediate_size=64, max_seq_len=MAX_SEQ, remat=False, q_lora_rank=48, kv_lora_rank=64,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=24, n_experts=16, experts_per_token=4,
    router_groups=(4, 2), moe_shared_intermediate=64, first_k_dense=1, dense_intermediate=192,
    attn_scale=48**-0.5 * (0.1 * math.log(40.0) + 1.0) ** 2,
)
# family → (the full config both packages name, its tiny overrides)
FAMILIES = {
    "mixtral": ("mixtral-8x7b", dict(TINY, n_heads=8, n_kv_heads=2)),
    "moe_tiny": ("moe-tiny", dict(max_seq_len=MAX_SEQ, head_dim=64)),
    "qwen3_moe": ("qwen-3-30b-a3b", dict(TINY, n_heads=8, n_kv_heads=1, n_experts=16, experts_per_token=4)),
    "llama4": ("llama-4-scout", dict(TINY, n_heads=5, n_kv_heads=1, n_experts=4, nope_pattern=2,
                                     attention_chunk_size=16, attn_temp_floor=8.0)),
    "cohere2": ("command-r-35b", dict(TINY, n_heads=4, n_kv_heads=2, sliding_window=24, sliding_pattern=2,
                                      nope_pattern=2)),
    "v3": ("deepseek-v3", V3_TINY),
}


def _configs(family: str) -> tuple:
    name, extra = FAMILIES[family]
    return (dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32, **extra),
            dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32, **extra))


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
    """The JAX tiny tree as numpy: norms, biases and the selection bias
    drawn from a seed around JAX's init, wq/wk and the router wider."""
    if family not in _TREES:
        jc, _ = _configs(family)
        tr = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
        rng = np.random.default_rng(11)

        def draw(name, a):
            if name.endswith("norm"):
                return (a + rng.standard_normal(a.shape) * 0.3).astype(np.float32)
            if name == "router_bias":
                return (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
            if name.startswith("b"):
                return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            if name in ("wq", "wk"):
                return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
            if name == "w_router":
                return (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
            return a

        for stack in ("layers", "dense_layers"):
            if stack in tr:
                tr[stack] = {n: draw(n, a) for n, a in tr[stack].items()}
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
# configs, helpers, router, chunk masks
# ---------------------------------------------------------------------------


class TestConfigs:
    def test_configs_have_jax_keys(self):
        assert list(tllama.CONFIGS) == list(jllama.CONFIGS)

    @pytest.mark.parametrize("name", NEW)
    def test_full_configs_match_jax(self, name):
        t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.num_params() == j.num_params() and t.num_active_params() == j.num_active_params()
        assert tllama.layer_windows(t) == jllama.layer_windows(j)
        assert tllama.layer_nope(t) == jllama.layer_nope(j)

    def test_tiny_params_match_jax(self, family):
        jc, tc = _configs(family)
        assert tc.num_params() == jc.num_params() and tc.num_active_params() == jc.num_active_params()
        tp = tllama.params_from_jax(_tree(family), tc, device="cpu")
        flat = jax.tree_util.tree_leaves_with_path(_tree(family))
        assert len(flat) == len(jax.tree_util.tree_leaves(tp))


class TestHelpers:
    @pytest.mark.parametrize("pattern", [0, 1, 2, 4])
    def test_layer_nope(self, pattern):
        jc = dataclasses.replace(jllama.LLAMA_TINY, n_layers=9, nope_pattern=pattern)
        tc = dataclasses.replace(tllama.LLAMA_TINY, n_layers=9, nope_pattern=pattern)
        assert tllama.layer_nope(tc) == jllama.layer_nope(jc)

    def test_l2_norm_and_temperature(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 3, 40, 32)).astype(np.float32) * 3
        np.testing.assert_allclose(tllama.l2_norm(_t(x), 1e-5).numpy(),
                                   np.asarray(jllama.l2_norm(jnp.asarray(x), 1e-5)), atol=1e-6, rtol=1e-6)
        pos = np.array([0, 6, 7, 8, 15, 100, 8191, 8192, 70000], np.int32)
        for floor in (8.0, 8192.0):
            jc = dataclasses.replace(jllama.LLAMA4_SCOUT, attn_temp_floor=floor)
            tc = dataclasses.replace(tllama.LLAMA4_SCOUT, attn_temp_floor=floor)
            np.testing.assert_allclose(tllama.attn_temp_scales(_t(pos), tc).numpy(),
                                       np.asarray(jllama.attn_temp_scales(jnp.asarray(pos), jc)), rtol=1e-7)

    @pytest.mark.parametrize("fields", [dict(sliding_window=8, sliding_pattern=2, nope_pattern=3),
                                        dict(sliding_window=8, sliding_pattern=2, nope_pattern=2)])
    def test_layer_layout(self, fields):
        """Windows and NoPE layers mix only aligned (Cohere2), as JAX's
        grouped scan allows them."""
        tc = dataclasses.replace(tllama.LLAMA_TINY, n_layers=6, **fields)
        jc = dataclasses.replace(jllama.LLAMA_TINY, n_layers=6, **fields)
        aligned = fields["nope_pattern"] == fields["sliding_pattern"]
        if aligned:
            tllama.check_layer_layout(tc)
            jllama.grouped_scan_layout(jc, {"x": jnp.zeros((6,))})
            return
        with pytest.raises(ValueError, match="aligned") as t:
            tllama.check_layer_layout(tc)
        with pytest.raises(ValueError, match="aligned") as j:
            jllama.grouped_scan_layout(jc, {"x": jnp.zeros((6,))})
        assert str(t.value) == str(j.value)


H, E = 64, 8


def _moe_layer(rng, e: int, shared: bool) -> dict:
    layer = {"w_router": rng.normal(0, 0.3, (H, e)), "w_gate": rng.normal(0, 0.1, (e, H, 96)),
             "w_up": rng.normal(0, 0.1, (e, H, 96)), "w_down": rng.normal(0, 0.1, (e, 96, H))}
    if shared:
        layer.update(w_shared_gate=rng.normal(0, 0.1, (H, 48)), w_shared_up=rng.normal(0, 0.1, (H, 48)),
                     w_shared_down=rng.normal(0, 0.1, (48, H)))
    return {k: v.astype(np.float32) for k, v in layer.items()}


def _crowded_x(rng, b: int, t: int, layer: dict) -> np.ndarray:
    """[B, T, H] hidden states that lean towards expert 0, so that its
    capacity overflows."""
    x = rng.normal(0, 1.0, (b, t, H)).astype(np.float32)
    return x + layer["w_router"][:, 0] * 2.0


def _dense(expert, slot, combine, cap: int, e: int) -> tuple:
    """The port's (expert, slot, combine) as JAX's [B, T, E, C] dispatch and combine."""
    b, t, k = expert.shape
    dispatch = np.zeros((b, t, e, cap), np.float32)
    comb = np.zeros((b, t, e, cap), np.float32)
    for bi, ti, j in np.ndindex(b, t, k):
        if slot[bi, ti, j] < cap:
            dispatch[bi, ti, expert[bi, ti, j], slot[bi, ti, j]] = 1.0
            comb[bi, ti, expert[bi, ti, j], slot[bi, ti, j]] = combine[bi, ti, j]
    return dispatch, comb


class TestSigmoidRouter:
    @pytest.mark.parametrize("t,e,k", [(16, 4, 1), (16, 16, 2), (12, 8, 1)])
    def test_router_matches_jax(self, t, e, k):
        rng = np.random.default_rng(t * e + k)
        layer = _moe_layer(rng, e, shared=False)
        x = _crowded_x(rng, 2, t, layer)
        cap = jmoe.expert_capacity(t, e, k, 1.25)
        jd, jcomb, _ = jmoe.router(jnp.asarray(x), jnp.asarray(layer["w_router"]), e, k, cap, sigmoid=True)
        expert, slot, combine = tmoe.router(_t(x), _t(layer["w_router"]), e, k, cap, sigmoid=True)
        assert bool((slot >= cap).any()), "the case must drop choices"
        dispatch, comb = _dense(expert.numpy(), slot.numpy(), combine.numpy(), cap, e)
        np.testing.assert_array_equal(dispatch, np.asarray(jd))
        np.testing.assert_allclose(comb, np.asarray(jcomb), atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("t,e,k,shared", [(8, 4, 1, True), (16, 16, 2, False), (16, 8, 1, True),
                                              (1, 4, 1, True)])
    def test_moe_mlp_sigmoid_input_matches_jax(self, t, e, k, shared):
        """The gate scales the expert input and the combine is unweighted
        (JAX swaps dispatch and combine), capacity drops kept."""
        rng = np.random.default_rng(100 + t * e + k)
        layer = _moe_layer(rng, e, shared)
        x = _crowded_x(rng, 2, t, layer)
        jo, _ = jmoe.moe_mlp(jnp.asarray(x), {n: jnp.asarray(w) for n, w in layer.items()}, e, k, 1.25,
                             None, None, sigmoid_input=True)
        to = tmoe.moe_mlp(_t(x), {n: _t(w) for n, w in layer.items()}, e, k, 1.25, sigmoid_input=True)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OP_TOL, rtol=OP_TOL)
        if t > 1:  # (a lone crowded token's gate saturates near 1)
            # the gate really sits on the input: the weighted combine differs
            other = tmoe.moe_mlp(_t(x), {n: _t(w) for n, w in layer.items()}, e, k, 1.25)
            assert not torch.allclose(to, other, atol=1e-3)


def _qkv(rng, b, h, hkv, tq, tk, d=32):
    return (rng.standard_normal((b, h, tq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32))


class TestChunkMask:
    @pytest.mark.parametrize("q_offset,tq,tk,window", [(0, 40, 40, 0), (20, 16, 64, 0), (48, 8, 64, 0),
                                                       (8, 40, 64, 12), (0, 12, 64, 0)])
    def test_attention_matches_jax(self, q_offset, tq, tk, window):
        rng = np.random.default_rng(q_offset + tq)
        q, k, v = _qkv(rng, 2, 4, 2, tq, tk)
        kw = dict(causal=True, scale=0.2, q_offset=q_offset, window=window, chunk=16)
        want = jattention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        got = tattention.attention(_t(q), _t(k), _t(v), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL, rtol=OP_TOL)

    def test_vector_offsets_match_jax(self):
        rng = np.random.default_rng(7)
        q, k, v = _qkv(rng, 3, 4, 1, 16, 64)
        off = np.array([0, 10, 40], np.int32)
        kw = dict(causal=True, scale=0.2, chunk=16)
        want = jattention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(off), **kw)
        got = tattention.attention(_t(q), _t(k), _t(v), q_offset=_t(off), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL, rtol=OP_TOL)

    @pytest.mark.parametrize("q_offset,tq,flash", [(0, 16, True), (4, 12, True), (8, 16, False), (0, 17, False)])
    def test_first_chunk_takes_the_flash_route(self, q_offset, tq, flash, monkeypatch):
        """Every query in the first chunk: the causal call, which is K1 on
        the card (its plain version here); past it the masked attention."""
        calls = []
        real = tattention.flash_attention

        def spy(*a, **kw):
            calls.append(kw)
            return real(*a, **kw)

        monkeypatch.setattr(tattention, "flash_attention", spy)
        q, k, v = _qkv(np.random.default_rng(0), 1, 4, 2, tq, 64)
        tattention.attention(_t(q), _t(k), _t(v), q_offset=q_offset, chunk=16)
        assert bool(calls) == flash


# ---------------------------------------------------------------------------
# the whole-sequence forward and training
# ---------------------------------------------------------------------------


def test_forward_matches_jax(setup):
    """The forward (autograd off) within 1e-4 at every position of 40
    tokens: Llama4's chunk mask bites (16-token chunks), and its NoPE
    temperature moves every 8 positions."""
    jcfg, tcfg, jp, tp = setup
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40))
    want = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = tllama.forward(tp, torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_llama4_deltas_change_the_logits():
    """The chunk mask and the temperature each move Llama4's logits (so
    the parity above holds them)."""
    _, tc = _configs("llama4")
    tp = tllama.params_from_jax(_tree("llama4"), tc, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab_size, (1, 40)))
    with torch.no_grad():
        base = tllama.forward(tp, tokens, tc)
        for change in (dict(attention_chunk_size=0), dict(attn_temp_scale=0.0)):
            assert not torch.allclose(base, tllama.forward(tp, tokens, dataclasses.replace(tc, **change)), atol=1e-3)


def _grads_match_jax(jc, tc, jp, tp, t: int = 40) -> None:
    """The full fine-tune's loss and every gradient under remat (the
    trainer's default) within 1e-4 of JAX's."""
    from dstack_tpu_torch.train import step as tstep
    from tests.test_torch_family_train import _batch, _close_tree, _jb, _tb, jax_full_loss

    jc, tc = dataclasses.replace(jc, remat=True), dataclasses.replace(tc, remat=True)
    batch = _batch(tc.vocab_size, t=t)
    jl, jg = jax.jit(jax.value_and_grad(jax_full_loss(jc)))(jp, _jb(batch))
    tl, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=ATOL)
    _close_tree(tg, jg)


# each case keeps the id it had when the trainer refused Llama4 (False)
@pytest.mark.parametrize("family", ["mixtral", "moe_tiny", "qwen3_moe", "v3", "llama4"],
                         ids=["mixtral-8x7b-True", "moe-tiny-True", "qwen-3-30b-a3b-True", "deepseek-v3-True",
                              "llama-4-scout-False"])
def test_check_trainable(family):
    """Every MoE family trains: each tiny config's loss (CE + the router
    aux loss) and gradients against JAX's, Llama4's chunk mask past the
    first chunk (16 of 40 tokens) on the masked attention."""
    jc, tc = _configs(family)
    tr = _tree(family)
    _grads_match_jax(jc, tc, jax.tree.map(jnp.asarray, tr), tllama.params_from_jax(tr, tc, device="cpu"))


@pytest.mark.parametrize("change", [dict(router_sigmoid_input=True), dict(nope_pattern=2),
                                    dict(qk_l2_norm=True), dict(attention_chunk_size=16)])
def test_each_llama4_delta_is_refused_alone(change):
    """Each Llama4 delta trains alone (the name is from before they
    trained): on the tiny Llama (the router on moe-tiny), the loss and
    every gradient against JAX's, the chunk of 16 over 40 tokens."""
    base = "moe-tiny" if "router_sigmoid_input" in change else "llama-tiny"
    kw = dict(change, attn_temp_scale=0.1, attn_temp_floor=8.0) if "nope_pattern" in change else change
    jc = dataclasses.replace(jllama.CONFIGS[base], **kw)
    tc = dataclasses.replace(tllama.CONFIGS[base], **kw)
    rng = np.random.default_rng(3)
    tr = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
    tr["layers"] = {n: (rng.standard_normal(a.shape) * 0.3).astype(np.float32) if n == "w_router" else a
                    for n, a in tr["layers"].items()}
    _grads_match_jax(jc, tc, jax.tree.map(jnp.asarray, tr), tllama.params_from_jax(tr, tc, device="cpu"))


# ---------------------------------------------------------------------------
# the engine's step functions and the engines
# ---------------------------------------------------------------------------

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


def _caches(tcfg) -> list:
    return [None] if tcfg.mla else [None, "int8"]


def _prefilled(setup, kv_quant) -> tuple:
    """Both caches after the serial prefill of PROMPTS into slots 0-3,
    chunk by chunk, each chunk's logits checked; → copies of (JAX cache,
    port cache); on the int8 cache the port's is a copy of JAX's."""
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
    @pytest.fixture(autouse=True)
    def _cache_the_config_takes(self, setup, kv_quant):
        if kv_quant not in _caches(setup[1]):
            pytest.skip("MLA has no int8 cache, in either package")

    def test_prefill_chunk_step(self, setup, kv_quant):
        """Six chunks at starts 0 and 32: Llama4's rope layer past its
        first 16-token chunk takes the masked attention."""
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
                                     decode_kernel=_decode_kernel(tcfg))
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
                                     decode_kernel=_decode_kernel(tcfg))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=ATOL,
                                   atol=INT8_PREFILL_ATOL if kv_quant else ATOL)
        _assert_caches(tc, jc, INT8_PREFILL_FLIP_SHARE if kv_quant else INT8_FLIP_SHARE)

    def test_decode_loop(self, setup, kv_quant):
        """Turbo: four device steps, tokens and state exact."""
        jcfg, tcfg, jp, tp = setup
        jc, tc = _prefilled(setup, kv_quant)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in PROMPTS], np.int32)
        rem = np.array([8, 2, 8, 8], np.int32)
        act = np.array([True, True, False, True])
        eos = np.array([-1, -1, -1, -1], np.int32)
        jout = jengine.decode_loop(jp, jc, *(jnp.asarray(a) for a in (tok, pos, rem, act, eos)), jcfg,
                                   steps=4, max_seq=MAX_SEQ, decode_kernel="einsum")
        tout = tengine.decode_loop(tp, tc, _t(tok).long(), _t(pos), _t(rem), _t(act), _t(eos).long(),
                                   tcfg, steps=4, max_seq=MAX_SEQ, decode_kernel=_decode_kernel(tcfg))
        for got, want in zip((tout[0], *tout[2:]), (jout[0], *jout[2:])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_caches(tout[1], jout[1], INT8_PREFILL_FLIP_SHARE if kv_quant else INT8_FLIP_SHARE)


def _decode_kernel(tcfg) -> str:
    """The route the port's engine takes by default: K4 (its plain version
    on the CPU), the einsum for a chunked config."""
    return "einsum" if tcfg.attention_chunk_size else "flash"


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
    prefix cache): the same records wave by wave; the port's default decode
    route is JAX's default einsum for Llama4, K4's plain version else."""
    jcfg, tcfg, jp, tp = setup
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9)
    je = jengine.InferenceEngine(jcfg, jp, decode_kernel="einsum", **kw)
    te = tengine.InferenceEngine(tcfg, tp, device="cpu", **kw)
    assert te.decode_kernel == _decode_kernel(tcfg)
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


def test_an_explicit_flash_decode_is_refused_for_llama4():
    """JAX's engine refuses ``decode_kernel="flash"`` for a chunked config
    (no kernel takes the chunk mask); so does the port's."""
    _, tc = _configs("llama4")
    tp = tllama.params_from_jax(_tree("llama4"), tc, device="cpu")
    with pytest.raises(ValueError, match="chunked attention"):
        tengine.InferenceEngine(tc, tp, max_batch=2, max_seq=MAX_SEQ, decode_kernel="flash", device="cpu")
    jc, _ = _configs("llama4")
    with pytest.raises(ValueError, match="chunked attention"):
        jengine.InferenceEngine(jc, jax.tree.map(jnp.asarray, _tree("llama4")), max_batch=2, max_seq=MAX_SEQ,
                                decode_kernel="flash")


def test_the_mla_kernel_plan_takes_128_heads():
    """K1's MLA form at V3's 128 heads: a block owns one position of 64
    heads, so the plan counts B * C * H / 64 blocks (it divided by zero)."""
    assert tflash.mla_plan(1, 128, 256, 2048, 512) == 1  # 512 blocks: no split
    assert tflash.mla_plan(1, 128, 16, 2048, 0) == 1  # 32 blocks, one key tile
    assert tflash.mla_plan(1, 128, 16, 2048, 1792) == 4  # 32 blocks: 132 // 32
    assert tflash.mla_plan(1, 16, 256, 2048, 512) == tflash.mla_plan(1, 16, 256, 2048, 512, sms=132)
