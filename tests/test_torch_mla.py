"""The port's MLA serving slice (DeepSeek) against the JAX package on the
CPU in f32.

Two tiny MLA configs, built in both packages the same way: ``mla-tiny``
itself (V3-style routing: sigmoid scores, a selection bias, the group
limit, a routed scale of 1.5, renormalized gates; q_lora; a shared
expert; one dense prelude layer) and a DeepSeek-V2-Lite-shaped one from
``dataclasses.replace`` on ``deepseek-v2-lite`` (softmax scores, no
q_lora, shared experts, ``first_k_dense`` 1, yarn rope), both at f32
with narrow widths. The JAX ``init_params`` leaves the selection bias at
0 and the norms at 1, which hides them, so seeded numpy values go over
them before both packages get the tree.

Held to JAX: the configs' fields and parameter counts (exactly), the
parameter tree key for key, interleaved rope in its three forms (1e-6)
and V2-Lite's yarn angles up to position 2047 (5e-5), K1's plain version
at D = 576 against the Pallas ``_flash_fwd`` in interpret mode (2e-5, the
reference's own f32 tolerance), the four MLA step functions (logits and
the latent cache within 1e-4), the turbo loop, and the serial and
default engines' greedy tokens, a prefix-cache hit included. Both
packages refuse the int8 cache for MLA. MLA training is held to JAX in
tests/test_torch_mla_train.py; K1's MLA entry (``flash_mla_with_lse``),
on the CPU and on the card, in tests/test_torch_mla_kernel.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.ops import flash as jflash
from dstack_tpu.serve import engine as jengine
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.serve import engine as tengine

TOL = 2e-5  # one op in f32
ATOL = 1e-4  # f32 end to end
MAX_SEQ = 128
CHUNK = 32
V2_TINY = dict(  # DeepSeek-V2-Lite's deltas at narrow widths
    vocab_size=512, hidden_size=128, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=16,
    intermediate_size=64, max_seq_len=256, remat=False, kv_lora_rank=64,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=24, n_experts=8,
    experts_per_token=3, moe_shared_intermediate=128, dense_intermediate=192,
)
CONFIGS = {
    "mla_tiny": (jllama.MLA_TINY, tllama.MLA_TINY),
    "v2_lite_tiny": (
        dataclasses.replace(jllama.DEEPSEEK_V2_LITE, dtype=jnp.float32, **V2_TINY),
        dataclasses.replace(tllama.DEEPSEEK_V2_LITE, dtype=torch.float32, **V2_TINY),
    ),
}
# leaf → std of the seeded values written over JAX's init (0 for the bias,
# 1 + N(0, std) for the norms)
PERTURB = {"router_bias": 0.05, "attn_norm": 0.1, "kv_a_norm": 0.1, "q_a_norm": 0.1, "mlp_norm": 0.1}


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


def _tree(jc, seed=0):
    tr = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 7)
    for stack in ("layers", "dense_layers"):
        for name, std in PERTURB.items():
            if name in tr[stack]:
                leaf = tr[stack][name]
                base = 0.0 if name == "router_bias" else 1.0
                tr[stack][name] = (base + rng.standard_normal(leaf.shape) * std).astype(leaf.dtype)
    return tr


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(name, JAX config, port config, JAX params, port params)."""
    jc, tc = CONFIGS[request.param]
    tree = _tree(jc)
    return (request.param, jc, tc, jax.tree.map(jnp.asarray, tree),
            tllama.params_from_jax(tree, tc, device="cpu"))


# ---------------------------------------------------------------------------
# config, parameters, rope
# ---------------------------------------------------------------------------


class TestConfig:
    @pytest.mark.parametrize("name", ["deepseek-v2-lite", "mla-tiny"])
    def test_configs_match_jax(self, name):
        t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        for prop in ("mla", "qk_head_dim", "q_dim", "o_dim", "rope_dim", "attention_scale"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.num_params() == j.num_params()

    def test_v2_lite_widths(self):
        c = tllama.DEEPSEEK_V2_LITE
        assert (c.mla, c.qk_head_dim, c.o_dim, c.rope_dim) == (True, 192, 2048, 64)
        assert c.kv_lora_rank + c.qk_rope_head_dim == tflash.MLA_HEAD_DIM
        # JAX's scale, kept as it is: 192 ** -0.5 (no yarn mscale for V2)
        assert c.attention_scale == 192**-0.5
        assert abs(c.num_params() / 1e9 - 15.706) < 1e-3

    def test_tiny_configs_match_jax(self, model):
        _, jc, tc, _, _ = model
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.num_params() == jc.num_params()


class TestParams:
    def test_params_from_jax_is_key_for_key(self, model):
        _, jc, tc, jp, tp = model
        flat = jax.tree_util.tree_leaves_with_path(jp)
        assert len(flat) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in flat:
            node = tp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    @pytest.mark.parametrize("change", ["missing", "extra"])
    def test_a_missing_or_extra_leaf_raises(self, change):
        jc, tc = CONFIGS["mla_tiny"]
        tree = _tree(jc)
        bad = {**tree, "dense_layers": dict(tree["dense_layers"])}
        if change == "missing":
            del bad["dense_layers"]["wkv_b"]
        else:
            bad["dense_layers"]["w_router"] = np.zeros((1, 128, 4), np.float32)
        with pytest.raises(ValueError, match="keys"):
            tllama.params_from_jax(bad, tc, device="cpu")

    def test_init_params_shapes_and_dtypes(self, model):
        _, jc, tc, jp, _ = model
        p = tllama.init_params(dataclasses.replace(tc, dtype=torch.bfloat16),
                               torch.Generator().manual_seed(0), device="cpu")
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            node = p
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            want = torch.float32 if path[-1].key in tllama.F32_LEAVES else torch.bfloat16
            assert node.dtype == want, path
        assert bool((p["layers"]["kv_a_norm"] == 1).all())
        assert 0.015 < float(p["layers"]["w_shared_gate"].float().std()) < 0.025


class TestRope:
    def test_interleaved_forms_match_jax(self):
        rng = np.random.default_rng(1)
        x = _rand(rng, 3, 4, 5, 16)
        pos = np.array([0, 7, 300], np.int32)
        jcs = jllama.rope_freqs(jnp.asarray(np.arange(5, dtype=np.int32)), 16, 10000.0)
        tcs = tllama.rope_freqs(_t(np.arange(5, dtype=np.int32)), 16, 10000.0)
        j = jllama.apply_rope(jnp.asarray(x), *jcs, interleaved=True)
        t = tllama.apply_rope(_t(x), *tcs, interleaved=True)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
        # per-slot angles (decode) and per-(row, step) angles (verify, packed)
        jb = jllama.rope_freqs(jnp.asarray(pos), 16, 10000.0)
        tb = tllama.rope_freqs(_t(pos), 16, 10000.0)
        j = jengine._apply_rope_batch(jnp.asarray(x[:, :, :1]), *jb, interleaved=True)
        t = tengine._apply_rope_batch(_t(x[:, :, :1]), *tb, interleaved=True)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
        grid = (pos[:, None] + np.arange(5)[None, :]).reshape(-1)
        jg = [a.reshape(3, 5, 8) for a in jllama.rope_freqs(jnp.asarray(grid), 16, 10000.0)]
        tg = [a.reshape(3, 5, 8) for a in tllama.rope_freqs(_t(grid), 16, 10000.0)]
        j = jengine._rope_rows(jnp.asarray(x), *jg, interleaved=True)
        t = tengine._rope_rows(_t(x), *tg, interleaved=True)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
        assert not np.allclose(t.numpy(), tengine._rope_rows(_t(x), *tg).numpy(), atol=1e-3)

    def test_v2_lite_yarn_matches_jax(self):
        """DeepSeek-V2-Lite's yarn over its 64-wide rope part, within 5e-5
        at positions 0-2047 (ROADMAP C: the two frameworks' f32 angles
        drift by position x 1 ulp)."""
        jc, tc = jllama.DEEPSEEK_V2_LITE, tllama.DEEPSEEK_V2_LITE
        pos = np.arange(2048, dtype=np.int32)
        (jcos, jsin), _ = jllama.dual_rope_freqs(jc, jnp.asarray(pos))
        (tcos, tsin), _ = tllama.dual_rope_freqs(tc, _t(pos))
        assert tcos.shape == (2048, 32)
        np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# K1 at D = 576: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def test_flash_plain_d576_matches_pallas_interpret():
    """The MLA chunk's form: q [1,16,128,576] at q_offset 128 over one KV
    head [1,1,256,576] whose last 64 value columns are zero."""
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 1, 16, 128, 576), _rand(rng, 1, 1, 256, 576), _rand(rng, 1, 1, 256, 576)
    v[..., 512:] = 0.0
    scale = 192**-0.5
    jo, jl = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, scale, 128, 128,
                               128, 0, True)
    to, tl = tflash.flash_attention_plain(_t(q), _t(k), _t(v), scale=scale, q_offset=128)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    # the Pallas kernel's lse carries a trailing axis of 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl).reshape(tl.shape), atol=TOL, rtol=TOL)
    assert not to[..., 512:].any()


# ---------------------------------------------------------------------------
# the engine's step functions and the engines
# ---------------------------------------------------------------------------


def _assert_cache(tc: dict, jc: dict) -> None:
    assert set(tc) == set(jc) == {"ckv"}
    np.testing.assert_allclose(tc["ckv"].numpy(), np.asarray(jc["ckv"]), atol=ATOL, rtol=ATOL)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


def _prefilled(model, prompts):
    """Both caches after the same serial prefill of ``prompts`` into slots
    0, 1, ... (each one chunk at start 0)."""
    _, jc, tc, jp, tp = model
    jcache = jengine.init_cache(jc, 4, MAX_SEQ)
    tcache = tengine.init_cache(tc, 4, MAX_SEQ, device="cpu")
    for slot, p in enumerate(prompts):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, : len(p)] = p
        jl, jcache = jengine.prefill_chunk_step(
            jp, jcache, jnp.asarray(toks), jnp.asarray(slot), jnp.asarray(len(p) - 1), jc, start=0
        )
        tl, tcache = tengine.prefill_chunk_step(
            tp, tcache, torch.from_numpy(toks).long(), slot, len(p) - 1, tc, start=0
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    _assert_cache(tcache, jcache)
    return jcache, tcache


class TestStepFunctions:
    def test_cache_is_the_latent_row(self, model):
        _, jc, tc, _, _ = model
        cache = tengine.init_cache(tc, 2, 32, device="cpu")
        assert cache["ckv"].shape == tuple(jengine.init_cache(jc, 2, 32)["ckv"].shape) == (3, 2, 32, 80)

    def test_prefill_chunk_step(self, model):
        """Three chunks of one prompt into slot 1: the second and third at
        q_offset 32 and 64 attend over the row's earlier chunks."""
        _, jc, tc, jp, tp = model
        jcache = jengine.init_cache(jc, 2, MAX_SEQ)
        tcache = tengine.init_cache(tc, 2, MAX_SEQ, device="cpu")
        prompt = _prompts(0, [80])[0]
        for start in range(0, len(prompt), CHUNK):
            part = prompt[start : start + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, : len(part)] = part
            jl, jcache = jengine.prefill_chunk_step(
                jp, jcache, jnp.asarray(toks), jnp.asarray(1), jnp.asarray(len(part) - 1), jc, start=start
            )
            tl, tcache = tengine.prefill_chunk_step(
                tp, tcache, torch.from_numpy(toks).long(), 1, len(part) - 1, tc, start=start
            )
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_cache(tcache, jcache)
        assert tcache["ckv"][:, 1, :80].abs().sum(-1).min() > 0  # every prompt row written
        assert not tcache["ckv"][:, 0].any() and not tcache["ckv"][:, 1, 96:].any()

    @pytest.mark.parametrize("impl", ["plain", "flash"])
    def test_prefill_chunk_step_impl(self, model, impl):
        """``impl="plain"`` takes the plain version (on the CPU the same
        as the default); any other value raises, as the GQA path's does."""
        _, _, tc, _, tp = model
        toks = torch.tensor(_prompts(3, [CHUNK]))
        args = (tp, tengine.init_cache(tc, 1, MAX_SEQ, device="cpu"), toks, 0, CHUNK - 1, tc)
        if impl != "plain":
            with pytest.raises(ValueError, match="impl="):
                tengine.prefill_chunk_step(*args, start=0, impl=impl)
            return
        want, _ = tengine.prefill_chunk_step(*args, start=0)
        args = (tp, tengine.init_cache(tc, 1, MAX_SEQ, device="cpu"), *args[2:])
        got, _ = tengine.prefill_chunk_step(*args, start=0, impl=impl)
        assert torch.equal(got, want)

    def test_prefill_packed_step(self, model):
        _, jc, tc, jp, tp = model
        jcache, tcache = _prefilled(model, _prompts(1, [32, 20]))
        rng = np.random.default_rng(2)
        tokens = rng.integers(0, 256, size=(4, CHUNK)).astype(np.int32)
        slots = np.array([2, 0, 1, 0], np.int32)
        starts = np.array([0, 32, 20, 0], np.int32)
        last_ix = np.array([29, 31, 10, -1], np.int32)  # the last row is a pad row
        jl, jcache = jengine.prefill_packed_step(
            jp, jcache, *(jnp.asarray(a) for a in (tokens, slots, starts, last_ix)), jc
        )
        tl, tcache = tengine.prefill_packed_step(
            tp, tcache, *(torch.from_numpy(a).long() for a in (tokens, slots, starts, last_ix)), tc
        )
        np.testing.assert_allclose(tl[:3].numpy(), np.asarray(jl)[:3], atol=ATOL, rtol=ATOL)
        _assert_cache(tcache, jcache)

    def test_decode_step(self, model):
        _, jc, tc, jp, tp = model
        prompts = _prompts(3, [20, 31, 5, 17])
        jcache, tcache = _prefilled(model, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        mask = np.array([True, True, False, True])
        jl, jcache = jengine.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos), jc,
                                         write_mask=jnp.asarray(mask))
        tl, tcache = tengine.decode_step(tp, tcache, _t(tok).long(), _t(pos), tc, write_mask=_t(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_cache(tcache, jcache)

    def test_verify_step(self, model):
        _, jc, tc, jp, tp = model
        prompts = _prompts(4, [20, 31, 5, 27])
        jcache, tcache = _prefilled(model, prompts)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, 256, size=(4, 5)).astype(np.int32)
        positions = np.array([len(p) for p in prompts], np.int32)
        mask = np.array([True, True, False, True])
        jl, jcache = jengine.verify_step(jp, jcache, jnp.asarray(tokens), jnp.asarray(positions), jc,
                                         jnp.asarray(mask))
        tl, tcache = tengine.verify_step(tp, tcache, _t(tokens).long(), _t(positions), tc, _t(mask))
        assert tl.shape == (4, 5, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
        _assert_cache(tcache, jcache)

    def test_decode_loop(self, model):
        _, jc, tc, jp, tp = model
        prompts = _prompts(6, [9, 30, 32, 17])
        jcache, tcache = _prefilled(model, prompts)
        tok = np.array([11, 22, 33, 44], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
        rem = np.array([8, 2, 8, 8], np.int32)
        act = np.array([True, True, False, True])
        eos = np.array([-1, -1, -1, -1], np.int32)
        jout = jengine.decode_loop(jp, jcache, *(jnp.asarray(a) for a in (tok, pos, rem, act, eos)), jc,
                                   steps=4, max_seq=MAX_SEQ)
        tout = tengine.decode_loop(tp, tcache, _t(tok).long(), _t(pos), _t(rem), _t(act), _t(eos).long(),
                                   tc, steps=4, max_seq=MAX_SEQ)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        for got, want in zip(tout[2:], jout[2:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_cache(tout[1], jout[1])


def test_copy_cache_prefix_copies_latent_rows():
    rng = np.random.default_rng(9)
    ckv = _rand(rng, 3, 3, 32, 80)
    jout = jengine.copy_cache_prefix({"ckv": jnp.asarray(ckv)}, jnp.asarray(0), jnp.asarray(2), p=16)
    tout = tengine.copy_cache_prefix({"ckv": _t(ckv)}, 0, 2, p=16)
    np.testing.assert_array_equal(tout["ckv"].numpy(), np.asarray(jout["ckv"]))


def test_int8_cache_refused_for_mla():
    jc, tc = CONFIGS["mla_tiny"]
    with pytest.raises(ValueError, match="MLA"):
        jengine.init_cache(jc, 2, 32, kv_quant="int8")
    with pytest.raises(ValueError, match="MLA"):
        tengine.init_cache(tc, 2, 32, device="cpu", kv_quant="int8")


def _drive(eng, gen_cls, waves) -> list:
    """The scheduler's call sequence, wave by wave: admit every prompt,
    ``prefill_wave`` until none is pending, then ``step`` until the
    wave's slots are done, recording each call's output and kind."""
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


@pytest.mark.parametrize("mode", ["default", "serial"])
def test_engines_emit_identical_greedy_tokens(model, mode):
    """The port's engine (K4 never consulted, ``decode_kernel`` left at
    the server's "flash") against the JAX engine (its einsum decode: JAX
    refuses "flash" for MLA)."""
    _, jc, tc, jp, tp = model
    kw = dict(max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK, turbo_quiet_s=1e9,
              **(SERIAL if mode == "serial" else {}))
    je = jengine.InferenceEngine(jc, jp, **kw)
    te = tengine.InferenceEngine(tc, tp, device="cpu", decode_kernel="flash", **kw)
    phrase = [5, 9, 13, 17]
    shared = _prompts(8, [70])[0]
    waves = [
        [(phrase * 12)[:40]],
        _prompts(9, [20, 45, 60]),  # a concurrent burst: a packed wave by default
        [shared + [1, 2, 3]],
        [shared + [4, 5, 6, 7]],  # reuses 64 cached positions by default
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
    _assert_cache(te.cache, je.cache)


def test_the_mla_path_runs_k1_per_serial_chunk_and_never_k4(model, monkeypatch):
    """The identities chip_smoke.py checks on the card, counted through
    the wrappers' calls: K1's MLA entry ``flash_mla_with_lse`` n_layers
    times a serial chunk, over the latent row alone (no value tensor),
    the masked attention only with a packed wave's vector offset, and no
    call of K4's wrapper on any step."""
    _, _, tc, _, tp = model
    calls = {"k1": 0}
    real_mla, real_attention = tengine.flash_mla_with_lse, tengine.attention

    def fm(q_abs, row, **kw):
        assert q_abs.shape[-1] == row.shape[-1] == tc.kv_lora_rank + tc.qk_rope_head_dim
        assert row.shape[1] == 1 and kw["rank"] == tc.kv_lora_rank
        calls["k1"] += 1
        return real_mla(q_abs, row, **kw)

    def fa(q, k, v, **kw):
        assert isinstance(kw["q_offset"], torch.Tensor), "a serial MLA chunk took the GQA attention"
        return real_attention(q, k, v, **kw)

    def no_k4(*a, **kw):
        raise AssertionError("an MLA step reached K4")

    monkeypatch.setattr(tengine, "flash_mla_with_lse", fm)
    monkeypatch.setattr(tengine, "attention", fa)
    monkeypatch.setattr(tengine, "flash_decode", no_k4)
    monkeypatch.setattr(tengine, "flash_decode_plain", no_k4)
    eng = tengine.InferenceEngine(tc, tp, max_batch=4, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                  turbo_quiet_s=1e9, device="cpu")
    _drive(eng, tengine.GenParams, [[[7] * 40], _prompts(10, [30, 50, 70]), [[3] * 5]])
    st = eng.stats
    assert st["decode_steps"] + st["spec_steps"] + st["turbo_device_steps"]
    assert calls["k1"] == tc.n_layers * (st["prefill_dispatches"] - st["packed_dispatches"]) > 0
