"""The port's MLA training path (DeepSeek) against the JAX package's on the
CPU, in f32.

Two tiny MLA configs, built in both packages the same way: ``mla-tiny``
itself (V3-style routing: sigmoid scores, a selection bias, the group
limit, a routed scale, renormalized gates; q_lora; a shared expert; one
dense prelude layer) and a DeepSeek-V2-Lite-shaped one from
``dataclasses.replace`` on ``deepseek-v2-lite`` at V2-Lite's own head
widths (q/k heads of 128 + 64, v heads of 128: the non-absorbed attention
runs at head_dim 192, v padded from 128) with narrow hidden and expert
widths, softmax routing at V2-Lite's capacity factor (choices drop at
capacity), shared experts and yarn rope. JAX's ``init_params`` leaves
the selection bias at 0 and the norms at 1, which hides them, so seeded
numpy values go over them, and the router is drawn wider so routing is
not near-uniform, before both packages get the tree. Batches are drawn
with numpy, with a ragged mask.

Held to JAX within 1e-4: ``mla_qkv`` on the same rope tables, the
whole-sequence forward's logits, hidden states and summed router aux loss
(``forward(..., return_aux=True)``), the router's Switch aux terms
(1e-6), the loss (CE + aux) and every leaf's gradient of it
(``jax.value_and_grad`` of the JAX step's ``loss_fn``), and two whole
steps of the full trainer, in one micro-batch and in two
(``--grad-accum 2``): CE and aux metrics, then every updated leaf (the
selection bias has a zero gradient but is still decayed, as optax decays
every leaf). Then ``finetune --full`` on mla-tiny runs to its summary,
LoRA refuses MLA with JAX's message, gpt-oss is still refused, and the
FLOPs a token count active parameters as JAX's do (a dense model's count
is unchanged).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.models import moe as jmoe
from dstack_tpu.parallel.mesh import MeshConfig, make_mesh
from dstack_tpu.train import lora as jlora
from dstack_tpu.train import step as jstep
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.models import moe as tmoe
from dstack_tpu_torch.train import lora as tlora
from dstack_tpu_torch.train import step as tstep

ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
V2_TINY = dict(  # DeepSeek-V2-Lite's head widths at narrow hidden and expert widths
    vocab_size=256, hidden_size=64, n_layers=3, n_heads=2, n_kv_heads=2, head_dim=16,
    intermediate_size=32, max_seq_len=256, remat=False, kv_lora_rank=32, n_experts=8,
    experts_per_token=3, moe_shared_intermediate=64, dense_intermediate=96,
)
CONFIGS = {
    "mla_tiny": (jllama.MLA_TINY, tllama.MLA_TINY),
    "v2_lite_tiny": (
        dataclasses.replace(jllama.DEEPSEEK_V2_LITE, dtype=jnp.float32, **V2_TINY),
        dataclasses.replace(tllama.DEEPSEEK_V2_LITE, dtype=torch.float32, **V2_TINY),
    ),
}
# leaf → std of the seeded values written over JAX's init (0 for the bias,
# 1 + N(0, std) for the norms, N(0, std) for the router)
PERTURB = {"router_bias": 0.05, "attn_norm": 0.1, "kv_a_norm": 0.1, "q_a_norm": 0.1, "mlp_norm": 0.1,
           "w_router": 0.3}


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
                base = 1.0 if name.endswith("norm") else 0.0
                tr[stack][name] = (base + rng.standard_normal(leaf.shape) * std).astype(leaf.dtype)
    return tr


_SETUPS: dict = {}


def _setup(name: str) -> tuple:
    """(JAX config, port config, JAX params, port params) of one config."""
    if name not in _SETUPS:
        jc, tc = CONFIGS[name]
        tr = _tree(jc)
        _SETUPS[name] = (jc, tc, jax.tree.map(jnp.asarray, tr), tllama.params_from_jax(tr, tc, device="cpu"))
    return _SETUPS[name]


@pytest.fixture(params=sorted(CONFIGS), scope="module")
def setup(request):
    return _setup(request.param)


def _batch(vocab: int, b: int = 4, t: int = 40, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[:, -1] = 0  # the roll wraps the last target
    mask[b // 2 :, t // 2 :] = 0
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1), "mask": mask}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _close_tree(t_tree, j_tree, atol=ATOL):
    flat_j = jax.tree_util.tree_leaves_with_path(j_tree)
    assert len(flat_j) == len(tstep.tree_leaves(t_tree))
    for path, leaf in flat_j:
        node = t_tree
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(
            node.detach().numpy(), np.asarray(leaf), atol=atol, rtol=atol, err_msg=str(path)
        )


def _jax_loss(jc):
    """The JAX train step's ``loss_fn`` (step.py:308-331): CE + aux."""
    def loss_fn(p, batch):
        x, aux = jllama.forward(p, batch["tokens"], jc, return_hidden=True, return_aux=True)
        head = (p["embed"].T if jc.tie_embeddings else p["lm_head"]).astype(jc.dtype)
        ce = jstep.fused_cross_entropy(x, head, batch["targets"], batch["mask"],
                                       softcap=jc.logit_softcap)[0]
        return ce + aux

    return loss_fn


class TestProjections:
    def test_mla_qkv_matches_jax(self, setup):
        jc, tc, jp, tp = setup
        rng = np.random.default_rng(2)
        h = rng.standard_normal((2, 24, jc.hidden_size)).astype(np.float32)
        cos, sin = tllama.dual_rope_freqs(tc, torch.arange(24))[0]
        jlayer = jax.tree.map(lambda a: a[0], jp["layers"])
        want = jllama.mla_qkv(jnp.asarray(h), jlayer, jc, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
        got = tllama.mla_qkv(torch.from_numpy(h), tllama.layer_params(tp, 0), tc, cos, sin)
        assert got[0].shape[-1] == got[1].shape[-1] == tc.qk_head_dim
        assert got[2].shape[-1] == tc.v_head_dim
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)

    def test_v2_lite_tiny_trains_at_head_dim_192(self):
        _, tc, _, _ = _setup("v2_lite_tiny")
        assert tc.qk_head_dim == 192 and tc.v_head_dim == 128
        assert tc.qk_head_dim == tllama.DEEPSEEK_V2_LITE.qk_head_dim


class TestForward:
    @pytest.mark.parametrize("return_hidden", [False, True], ids=["logits", "hidden"])
    def test_matches_jax_forward_and_aux(self, setup, return_hidden):
        jc, tc, jp, tp = setup
        tokens = _batch(jc.vocab_size, b=2)["tokens"]
        fwd = jax.jit(lambda p, t: jllama.forward(p, t, jc, return_hidden=return_hidden, return_aux=True))
        want, want_aux = fwd(jp, jnp.asarray(tokens))
        with torch.no_grad():
            got, aux = tllama.forward(tp, torch.from_numpy(tokens).long(), tc, return_hidden=return_hidden,
                                      return_aux=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
        assert aux.dtype == torch.float32 and float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL, rtol=ATOL)

    def test_a_dense_model_has_zero_aux(self):
        c = tllama.LLAMA_TINY
        p = tllama.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            logits, aux = tllama.forward(p, torch.zeros(1, 8, dtype=torch.long), c, return_aux=True)
        assert logits.shape == (1, 8, c.vocab_size) and float(aux) == 0.0

    def test_remat_gives_the_same_gradients(self, setup):
        _, tc, _, tp = setup
        batch = _tb(_batch(tc.vocab_size, b=2, t=24))
        loss_a, ga = tstep.value_and_grad(tstep.full_loss, tp, batch, tc)
        loss_b, gb = tstep.value_and_grad(tstep.full_loss, tp, batch, dataclasses.replace(tc, remat=True))
        assert float(loss_a) == float(loss_b)
        for a, b in zip(tstep.tree_leaves(ga), tstep.tree_leaves(gb)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


class TestRouterAux:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_router_aux_matches_jax(self, name):
        jc, tc, jp, tp = _setup(name)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, 40, jc.hidden_size)).astype(np.float32)
        layer = {k: np.asarray(v)[0] for k, v in jp["layers"].items()}
        cap = tmoe.expert_capacity(40, jc.n_experts, jc.experts_per_token, jc.capacity_factor)
        kw = dict(renorm=jc.router_renorm, score=jc.router_score, groups=jc.router_groups,
                  routed_scale=jc.routed_scale)
        bias = layer.get("router_bias")
        _, _, jaux = jmoe.router(jnp.asarray(x), jnp.asarray(layer["w_router"]), jc.n_experts,
                                 jc.experts_per_token, cap, bias=None if bias is None else jnp.asarray(bias),
                                 **kw)
        *_, aux = tmoe.router(torch.from_numpy(x), torch.from_numpy(layer["w_router"]), tc.n_experts,
                              tc.experts_per_token, cap,
                              bias=None if bias is None else torch.from_numpy(bias), with_aux=True, **kw)
        for term in ("balance", "z"):
            np.testing.assert_allclose(float(aux[term]), float(jaux[term]), atol=1e-6, rtol=1e-6)

    def test_serving_calls_compute_no_aux(self):
        _, tc, _, tp = _setup("v2_lite_tiny")
        layer = tllama.layer_params(tp, 0)
        x = torch.randn(2, 5, tc.hidden_size)
        assert isinstance(tllama._mlp_out(x, layer, tc), torch.Tensor)
        assert len(tmoe.router(x, layer["w_router"], tc.n_experts, tc.experts_per_token, 8)) == 3


class TestGradients:
    def test_loss_and_grads_match_jax(self, setup):
        jc, tc, jp, tp = setup
        batch = _batch(jc.vocab_size)
        jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jc)))(jp, _jb(batch))
        tl, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tc)
        np.testing.assert_allclose(float(tl), float(jl), rtol=ATOL)
        _close_tree(tg, jg)

    def test_gradients_reach_the_router_and_every_expert(self, setup):
        """Through the gates and the aux terms to the router, through the
        dispatch to the experts and the shared expert; the selection bias
        selects only, so its gradient is zero."""
        _, tc, _, tp = setup
        batch = _tb(_batch(tc.vocab_size))
        _, g = tstep.value_and_grad(tstep.full_loss, tp, batch, tc)
        layers = g["layers"]
        for name in ("w_router", "w_gate", "w_up", "w_down", "w_shared_gate", "w_shared_up",
                     "w_shared_down", "wkv_a", "wkv_b", "wo"):
            assert bool(layers[name].abs().gt(0).any()), name
        if "router_bias" in layers:
            assert not layers["router_bias"].any()

        def aux_only(p, b, c):
            return tllama.forward(p, b["tokens"], c, return_hidden=True, return_aux=True)[1]

        _, ga = tstep.value_and_grad(aux_only, tp, batch, tc)
        assert bool(ga["layers"]["w_router"].abs().gt(0).any())
        # the aux reads the routers' inputs: the last layer's experts feed none
        assert not ga["layers"]["w_gate"][-1].any() and bool(ga["layers"]["w_gate"][0].abs().gt(0).any())


def _mesh():
    return make_mesh(MeshConfig(dp=1, fsdp=1, tp=1), devices=jax.devices()[:1])


class TestWholeSteps:
    @pytest.mark.parametrize("grad_accum", [1, 2], ids=["one_micro_batch", "grad_accum2"])
    def test_steps_match_jax(self, setup, grad_accum):
        jc, tc, jp, tp = setup
        jopt = jstep.default_optimizer(lr=1e-3, warmup=1, decay_steps=100)
        topt = tstep.default_optimizer(lr=1e-3, warmup=1, decay_steps=100)
        mesh = _mesh()
        jstate, _ = jstep.sharded_init(jc, jopt, mesh, params=jax.tree.map(jnp.copy, jp))  # donated
        jfn = jstep.make_train_step(jc, jopt, mesh, grad_accum=grad_accum)
        # both trainers update their state in place: copies of the shared trees
        tstate = tstep.init_train_state(tc, topt, params=tstep.tree_map(torch.clone, tp))
        tfn = tstep.make_train_step(tc, topt, grad_accum=grad_accum)
        for i in range(2):
            batch = _batch(jc.vocab_size, seed=10 + i)
            jstate, jm = jfn(jstate, _jb(batch))
            tstate, tm = tfn(tstate, _tb(batch))
            for key in ("loss", "aux_loss", "grad_norm"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=ATOL, err_msg=key)
        assert float(tm["aux_loss"]) > 0
        _close_tree(tstate["params"], jstate["params"])
        if "router_bias" in tp["layers"]:  # zero gradient, decayed all the same
            moved = tstate["params"]["layers"]["router_bias"] - tp["layers"]["router_bias"]
            assert bool(moved.abs().gt(0).any())


def test_finetune_full_runs_mla_tiny(tmp_path, capsys):
    from dstack_tpu_torch.train import finetune

    rc = finetune.main(["--device", "cpu", "--model", "mla-tiny", "--full", "--steps", "2", "--seq-len", "32",
                        "--batch", "2", "--log-every", "1", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["event"] == "summary" and summary["mode"] == "full"
    assert math.isfinite(summary["first_loss"]) and math.isfinite(summary["last_loss"])
    assert abs(summary["first_loss"] - math.log(tllama.MLA_TINY.vocab_size)) < 1.0
    assert summary["aux_loss"] > 0
    assert (tmp_path / "model_weights.npz").exists()


class TestRefusals:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_lora_refuses_mla_as_jax_does(self, name):
        jc, tc = CONFIGS[name]
        with pytest.raises(ValueError) as want:
            jlora.init_lora_params(jc, jlora.LoRAConfig(), jax.random.key(0))
        with pytest.raises(ValueError) as got:
            tlora.init_lora_params(tc, tlora.LoRAConfig(), torch.Generator().manual_seed(0), device="cpu")
        assert str(got.value) == str(want.value)

    def test_finetune_lora_on_mla_exits_before_its_weights_are_made(self, capsys):
        from dstack_tpu_torch.train import finetune

        with pytest.raises(SystemExit) as e:
            finetune.main(["--device", "cpu", "--model", "deepseek-v2-lite"])
        assert e.value.code != 0
        assert "--full" in capsys.readouterr().err

    def test_gpt_oss_is_still_refused(self):
        with pytest.raises(NotImplementedError, match="A5.7"):
            tllama.check_trainable(tllama.GPT_OSS_20B)
        tllama.check_trainable(tllama.DEEPSEEK_V2_LITE)
        tllama.check_trainable(tllama.MLA_TINY)


@pytest.mark.parametrize("name", ["deepseek-v2-lite", "mla-tiny", "gpt-oss-20b", "llama-3.2-1b", "gemma-3-4b"])
def test_active_params_and_flops_match_jax(name):
    t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
    assert t.num_active_params() == j.num_active_params()
    assert tstep.flops_per_token(t, 2048) == jstep.flops_per_token(j, 2048)
    if not t.n_experts:  # a dense model's count is every parameter, as before
        attn = 12 * t.n_layers * t.hidden_size * 2048
        assert tstep.flops_per_token(t, 2048) == 6.0 * t.num_params() + attn
