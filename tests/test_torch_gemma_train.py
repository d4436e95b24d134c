"""The port's Gemma training path against the JAX package's on the CPU, in f32.

Three tiny configs at Gemma's head width of 256, built with
``dataclasses.replace`` in both packages from the full ones: a gemma-2b
one (multi-query attention, no windows), a gemma-2 one (sandwich norms,
windows of 16 on even layers, an attention softcap and a final-logit cap
small enough to bite at these widths) and a gemma-3 one (q/k norms,
windows of 16 on two of every three layers, so the fourth layer is the
tail past JAX's grouped scan, and the dual rope with linear scaling on
the global layer). JAX's ``init_params`` leaves the offset norms at 0
(identity) and the q/k norms at 1, so every norm is overwritten with
seeded numpy values, and wq/wk are drawn wider so the attention cap sees
scores of a few units, before both packages get the tree
(``params_from_jax``). Batches are drawn with numpy, with a ragged mask.

Held to JAX within 1e-4: the whole-sequence forward (logits and hidden
states), the gradients of the full loss (the JAX step's ``loss_fn``:
``fused_cross_entropy`` with the logit cap) and of the LoRA loss, leaf by
leaf, and two whole steps of the full trainer on gemma-3 and of the LoRA
trainer on gemma-2: the losses, then every updated leaf (the schedule's
first count has lr 0, so the second step is the first that moves the
weights; Adam's first move is about lr times the sign of each gradient
element, so a wrong gradient shows at lr = 1e-3). Then each config
memorises one batch over 20 steps of the port's trainer, as
tests/compute/test_family_training.py asks of the JAX package, and
``num_params`` (hence the MFU's FLOPs) counts the full Gemma configs as
JAX does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.parallel.mesh import MeshConfig, make_mesh
from dstack_tpu.train import lora as jlora
from dstack_tpu.train import step as jstep
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.train import lora as tlora
from dstack_tpu_torch.train import step as tstep

ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
TINY = dict(
    vocab_size=256, hidden_size=64, n_heads=4, n_kv_heads=2, head_dim=256,
    intermediate_size=128, sliding_window=16, max_seq_len=64, remat=False,
)
MODELS = {  # name → (full config, its tiny deltas)
    "gemma2b": ("gemma-2b", dict(n_kv_heads=1, sliding_window=0, n_layers=2)),
    "gemma2": ("gemma-2-2b", dict(n_layers=3, attn_softcap=2.0, logit_softcap=1.0)),
    "gemma3": ("gemma-3-4b", dict(n_layers=4, sliding_pattern=3)),
}
NORMS = ("attn_norm", "mlp_norm", "attn_post_norm", "mlp_post_norm", "q_norm", "k_norm")
LORA = (jlora.LoRAConfig(rank=4, alpha=8.0), tlora.LoRAConfig(rank=4, alpha=8.0))


def _configs(model: str) -> tuple:
    name, extra = MODELS[model]
    kw = {**TINY, **extra}
    return (dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32, **kw),
            dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32, **kw))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(model: str) -> dict:
    """The JAX tiny tree as numpy: norms seeded, wq/wk drawn wider."""
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
    return tr


_SETUPS: dict = {}


def _setup(model: str) -> tuple:
    """(JAX config, port config, JAX params, port params) of one model."""
    if model not in _SETUPS:
        jc, tc = _configs(model)
        tr = _tree(model)
        _SETUPS[model] = (jc, tc, jax.tree.map(jnp.asarray, tr),
                          tllama.params_from_jax(tr, tc, device="cpu"))
    return _SETUPS[model]


@pytest.fixture(params=sorted(MODELS), scope="module")
def setup(request):
    return _setup(request.param)


def _lora(jc, tc):
    """Adapters with B != 0, so every factor gets a gradient."""
    jl = jax.tree.map(np.asarray, jlora.init_lora_params(jc, LORA[0], jax.random.key(1)))
    rng = np.random.default_rng(1)
    jl = {"layers": {
        k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32) if k.endswith("_b") else v
        for k, v in jl["layers"].items()
    }}
    return jl, tlora.lora_from_jax(jl, tc, LORA[1], device="cpu")


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


def _jax_full_loss(jc):
    """The JAX train step's ``loss_fn`` (step.py:308-330) for a dense model."""
    def loss_fn(p, batch):
        x = jllama.forward(p, batch["tokens"], jc, return_hidden=True)
        head = (p["embed"].T if jc.tie_embeddings else p["lm_head"]).astype(jc.dtype)
        return jstep.fused_cross_entropy(x, head, batch["targets"], batch["mask"],
                                         softcap=jc.logit_softcap)[0]

    return loss_fn


def _jax_lora_loss(jc):
    """The JAX LoRA step's ``loss_fn`` (lora.py:210)."""
    def loss_fn(lora, p, batch):
        logits = jllama.forward(p, batch["tokens"], jc, lora=lora, lora_scale=LORA[0].scale)
        return jstep.cross_entropy_loss(logits, batch["targets"], batch["mask"])[0]

    return loss_fn


def _mesh():
    return make_mesh(MeshConfig(dp=1, fsdp=1, tp=1), devices=jax.devices()[:1])


def _optimizers():
    return (jstep.default_optimizer(lr=1e-3, warmup=1, decay_steps=100),
            tstep.default_optimizer(lr=1e-3, warmup=1, decay_steps=100))


class TestForward:
    @pytest.mark.parametrize("return_hidden", [False, True], ids=["logits", "hidden"])
    def test_matches_jax_forward(self, setup, return_hidden):
        jc, tc, jp, tp = setup
        tokens = _batch(jc.vocab_size, b=2)["tokens"]
        fwd = jax.jit(lambda p, t: jllama.forward(p, t, jc, return_hidden=return_hidden))
        want = fwd(jp, jnp.asarray(tokens))
        with torch.no_grad():
            got = tllama.forward(tp, torch.from_numpy(tokens).long(), tc, return_hidden=return_hidden)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)

    def test_remat_gives_the_same_gradients(self, setup):
        _, tc, _, tp = setup
        batch = _tb(_batch(tc.vocab_size, b=2, t=24))
        loss_a, ga = tstep.value_and_grad(tstep.full_loss, tp, batch, tc)
        loss_b, gb = tstep.value_and_grad(tstep.full_loss, tp, batch, dataclasses.replace(tc, remat=True))
        assert float(loss_a) == float(loss_b)
        for a, b in zip(tstep.tree_leaves(ga), tstep.tree_leaves(gb)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


class TestGradients:
    def test_full_loss_grads_match_jax(self, setup):
        jc, tc, jp, tp = setup
        batch = _batch(jc.vocab_size)
        jl, jg = jax.jit(jax.value_and_grad(_jax_full_loss(jc)))(jp, _jb(batch))
        tl, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tc)
        np.testing.assert_allclose(float(tl), float(jl), rtol=ATOL)
        _close_tree(tg, jg)

    def test_lora_grads_match_jax(self, setup):
        jc, tc, jp, tp = setup
        jl, tl = _lora(jc, tc)
        batch = _batch(jc.vocab_size)
        jloss, jg = jax.jit(jax.value_and_grad(_jax_lora_loss(jc)))(jl, jp, _jb(batch))
        tloss, tg = tstep.value_and_grad(tlora.lora_loss, tl, _tb(batch), tp, tc, LORA[1])
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL)
        _close_tree(tg, jg)


class TestWholeSteps:
    # the full step on gemma-3 (the optimizer over its q/k and sandwich
    # norms), the LoRA step on gemma-2 (both caps)
    def test_full_steps_match_jax(self):
        jc, tc, jp, tp = _setup("gemma3")
        jopt, topt = _optimizers()
        mesh = _mesh()
        jstate, _ = jstep.sharded_init(jc, jopt, mesh, params=jax.tree.map(jnp.copy, jp))  # donated
        jfn = jstep.make_train_step(jc, jopt, mesh)
        # both trainers update their state in place: copies of the shared trees
        tstate = tstep.init_train_state(tc, topt, params=tstep.tree_map(torch.clone, tp))
        tfn = tstep.make_train_step(tc, topt)
        for i in range(2):
            batch = _batch(jc.vocab_size, seed=10 + i)
            jstate, jm = jfn(jstate, _jb(batch))
            tstate, tm = tfn(tstate, _tb(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL)
        _close_tree(tstate["params"], jstate["params"])

    def test_lora_steps_match_jax(self):
        jc, tc, jp, tp = _setup("gemma2")
        jopt, topt = _optimizers()
        mesh = _mesh()
        jbase, jstate, _ = jlora.sharded_lora_init(jc, LORA[0], jopt, mesh,
                                                   params=jax.tree.map(jnp.copy, jp))
        tl = tlora.lora_from_jax(jax.tree.map(np.asarray, jstate["lora"]), tc, LORA[1], device="cpu")
        jfn = jlora.make_lora_train_step(jc, LORA[0], jopt, mesh)
        tstate = tlora.init_lora_state(tl, topt)
        tfn = tlora.make_lora_train_step(tc, LORA[1], topt)
        for i in range(2):
            batch = _batch(jc.vocab_size, seed=20 + i)
            jstate, jm = jfn(jbase, jstate, _jb(batch))
            tstate, tm = tfn(tp, tstate, _tb(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL)
        _close_tree(tstate["lora"], jstate["lora"])

    def test_memorises_a_batch(self, setup):
        _, tc, _, tp = setup
        opt = tstep.default_optimizer(lr=3e-3)
        state = tstep.init_train_state(tc, opt, params=tstep.tree_map(torch.clone, tp))
        step = tstep.make_train_step(tc, opt)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, tc.vocab_size, (4, 32))).long()
        data = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1),
                "mask": torch.ones_like(tokens)}
        losses = []
        for _ in range(20):
            state, m = step(state, data)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses)), losses
        # through the default warmup the loss must clearly move down
        assert losses[-1] < losses[0] * 0.95, losses


@pytest.mark.parametrize("name", ["gemma-2b", "gemma-2-2b", "gemma-3-1b", "gemma-3-4b"])
def test_num_params_and_flops_match_jax(name):
    """The tied embedding counted once, four norms a layer on Gemma2/3
    (two on gemma-2b), no q/k norm leaves: JAX's count, so the MFU's
    FLOPs a token are JAX's."""
    t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
    assert t.num_params() == j.num_params()
    assert tstep.flops_per_token(t, 2048) == jstep.flops_per_token(j, 2048)
    shapes = tllama.param_shapes(t)
    counted = sum(int(np.prod(s)) for s in (shapes["embed"], shapes["final_norm"]))
    counted += sum(int(np.prod(s)) for k, s in shapes["layers"].items() if k not in ("q_norm", "k_norm"))
    assert counted == t.num_params()
