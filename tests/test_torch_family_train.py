"""The port's training of every served family against the JAX package on
the CPU, in f32: the dense families' deltas, gpt-oss and Llama4.

The tiny configs are the serving tests' own, built with
``dataclasses.replace`` of the full configs in both packages, with their
trees' norms and biases drawn from a seed away from JAX's identity init:
each family of ``tests/test_torch_families.py`` (Qwen2.5's biases,
Qwen3, Mistral's window, StarCoder2's LayerNorm with a bias, gateless GELU
MLP and biases, Nemotron's LayerNorm1P, relu² and rotate-half partial
rope, Command-R's LayerNorm, parallel block, interleaved rope, per-head
q/k LayerNorms and logit scale, OLMo-2's post-norm-only layers and flat
q/k norms, GLM-4's interleaved partial rope, Granite's multipliers),
Llama4 and Cohere2 of ``tests/test_torch_moe_families.py`` (Llama4's
chunk of 16 at T = 64, so its rope layer attends past the first chunk on
the masked attention while its NoPE layer takes the flash call, with the
temperature, the L2 q/k norm and the sigmoid-input router), and a tiny
gpt-oss of two layers (window 16 on layer 0, sinks, q/k/v/o and expert
biases, the top-k-softmax router, the clamped GLU; sinks and biases drawn
as ``tests/test_torch_gpt_oss.py`` draws them).

Held to JAX within 1e-4 (f32 end to end): the loss and every gradient of
the full fine-tune's objective (the JAX step's ``loss_fn``: the fused
cross-entropy without Cohere's and Granite's logit scale, plus the router
aux loss) and of the LoRA loss (the logits' CE, logit scale included,
as JAX's LoRA step takes it), LoRA on a gateless MLP with every target
(w_gate's adapters get no gradient in either package), the clamped GLU's
gradient at values planted exactly at ±``act_limit`` (JAX's min and max
split it in halves there; ``torch.clamp`` passes all of it, which the
test shows failing), three whole steps of the tiny gpt-oss's full
trainer against JAX's, and ``finetune --hf-model`` on tiny
``save_pretrained`` gpt_oss, qwen2 and llama4_text checkpoints against the
JAX finetune's first loss (rtol 1e-4; a subprocess, as
tests/test_torch_convert_hf.py runs it). Under remat the sinks and the
chunk mask give the remat-free gradients, and a
``saved_tensors_hooks`` count shows that no [B, H, T, T] tensor is kept
across the forward, while K1's entry still runs once a flash layer. A
bf16 gpt-oss keeps its f32 sinks and router bias (and their moments)
through a step, and its checkpoint restores byte for byte; the new
families' parameter and FLOP counts are JAX's.

The ``cuda``-marked tests (they skip where there is no card) hold sinks
under autograd on a CUDA tensor to the masked path (no K1 launch, q/k/v
gradients equal to the plain path's) and K1-K3 at the GQA groups of 9
(starcoder2-7b) and 16 (glm-4-9b) to their plain versions.
"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

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
from dstack_tpu_torch.models import moe as tmoe
from dstack_tpu_torch.ops import attention as tattention
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.train import finetune as tfinetune
from dstack_tpu_torch.train import lora as tlora
from dstack_tpu_torch.train import step as tstep
from tests import test_torch_families as dense
from tests import test_torch_gpt_oss as gpt_oss
from tests import test_torch_moe_families as moefam

ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
T = 64  # Llama4's chunk of 16 four times over
LORA = (jlora.LoRAConfig(rank=4, alpha=8.0), tlora.LoRAConfig(rank=4, alpha=8.0))
GPT_OSS_TINY = dict(
    vocab_size=512, hidden_size=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
    intermediate_size=64, n_experts=4, experts_per_token=2, sliding_window=16, max_seq_len=128,
    remat=False,
)
MODELS = sorted(dense.FAMILIES) + ["gpt_oss", "llama4", "cohere2"]
MASKED = ("gpt_oss", "llama4")  # the models whose layers attend on the masked attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(model: str) -> tuple:
    if model == "gpt_oss":
        return (dataclasses.replace(jllama.GPT_OSS_20B, dtype=jnp.float32, **GPT_OSS_TINY),
                dataclasses.replace(tllama.GPT_OSS_20B, dtype=torch.float32, **GPT_OSS_TINY))
    if model in moefam.FAMILIES:
        return moefam._configs(model)
    return dense._configs(model)


_TREES: dict = {}


def _tree(model: str) -> dict:
    """The JAX tiny tree as numpy, its norms and biases drawn from a seed."""
    if model not in _TREES:
        if model == "gpt_oss":
            jc, _ = _configs(model)
            tr = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(0)))
            rng = np.random.default_rng(7)
            for name, std in gpt_oss.NONZERO.items():
                leaf = tr["layers"][name]
                tr["layers"][name] = (rng.standard_normal(leaf.shape) * std).astype(leaf.dtype)
            tr["layers"]["w_router"] = (rng.standard_normal(tr["layers"]["w_router"].shape) * 0.3).astype(np.float32)
            _TREES[model] = tr
        else:
            _TREES[model] = (moefam if model in moefam.FAMILIES else dense)._tree(model)
    return _TREES[model]


def _setup(model: str, tree=None) -> tuple:
    """(JAX config, port config, JAX params, port params)."""
    jc, tc = _configs(model)
    tr = _tree(model) if tree is None else tree
    return jc, tc, jax.tree.map(jnp.asarray, tr), tllama.params_from_jax(tr, tc, device="cpu")


@pytest.fixture(params=MODELS, scope="module")
def setup(request):
    return (request.param, *_setup(request.param))


def _batch(vocab: int, b: int = 4, t: int = T, seed: int = 1) -> dict:
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
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf), atol=atol, rtol=atol,
                                   err_msg=str(path))


def jax_full_loss(jc):
    """The JAX train step's ``loss_fn`` (step.py:308-330): the fused CE over
    the un-scaled head, plus the router aux loss."""
    def loss_fn(p, batch):
        x, aux = jllama.forward(p, batch["tokens"], jc, return_hidden=True, return_aux=True)
        head = (p["embed"].T if jc.tie_embeddings else p["lm_head"]).astype(jc.dtype)
        ce = jstep.fused_cross_entropy(x, head, batch["targets"], batch["mask"], softcap=jc.logit_softcap)[0]
        return ce + aux

    return loss_fn


def _jax_lora_loss(jc, lora_config):
    """The JAX LoRA step's ``loss_fn`` (lora.py:210)."""
    def loss_fn(lora, p, batch):
        logits = jllama.forward(p, batch["tokens"], jc, lora=lora, lora_scale=lora_config.scale)
        return jstep.cross_entropy_loss(logits, batch["targets"], batch["mask"])[0]

    return loss_fn


def _lora(jc, tc, configs=LORA):
    """Adapters with B != 0, so every factor gets a gradient."""
    jl = jax.tree.map(np.asarray, jlora.init_lora_params(jc, configs[0], jax.random.key(1)))
    rng = np.random.default_rng(1)
    jl = {"layers": {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32) if k.endswith("_b") else v
                     for k, v in jl["layers"].items()}}
    return jl, tlora.lora_from_jax(jl, tc, configs[1], device="cpu")


def _grads_match(jc, tc, jp, tp, batch, rtol=ATOL):
    jl, jg = jax.jit(jax.value_and_grad(jax_full_loss(jc)))(jp, _jb(batch))
    tl, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    _close_tree(tg, jg)
    return tg


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


class TestGradients:
    def test_full_loss_grads_match_jax(self, setup):
        model, jc, tc, jp, tp = setup
        grads = _grads_match(jc, tc, jp, tp, _batch(jc.vocab_size))
        for name, g in grads["layers"].items():  # every leaf reached (no selection bias here)
            assert g.abs().sum() > 0, name

    def test_lora_grads_match_jax(self, setup):
        model, jc, tc, jp, tp = setup
        jl, tl = _lora(jc, tc)
        batch = _batch(jc.vocab_size)
        jloss, jg = jax.jit(jax.value_and_grad(_jax_lora_loss(jc, LORA[0])))(jl, jp, _jb(batch))
        tloss, tg = tstep.value_and_grad(tlora.lora_loss, tl, _tb(batch), tp, tc, LORA[1])
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL)
        _close_tree(tg, jg)

    @pytest.mark.parametrize("model", ["starcoder2", "nemotron"])
    def test_lora_on_a_gateless_mlp_matches_jax(self, model):
        """Every target on the gateless MLP: w_up's and w_down's adapters
        act through ``_proj`` as JAX's ``_mlp_block`` applies them, and
        w_gate's receive no gradient in either package."""
        jc, tc, jp, tp = _setup(model)
        every = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
        configs = (jlora.LoRAConfig(rank=4, alpha=8.0, target_modules=every),
                   tlora.LoRAConfig(rank=4, alpha=8.0, target_modules=every))
        jl, tl = _lora(jc, tc, configs)
        batch = _batch(jc.vocab_size)
        jloss, jg = jax.jit(jax.value_and_grad(_jax_lora_loss(jc, configs[0])))(jl, jp, _jb(batch))
        tloss, tg = tstep.value_and_grad(tlora.lora_loss, tl, _tb(batch), tp, tc, configs[1])
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL)
        _close_tree(tg, jg)
        for name in ("w_gate_lora_a", "w_gate_lora_b"):
            assert not tg["layers"][name].any() and not np.asarray(jg["layers"][name]).any()
        for name in ("w_up_lora_a", "w_down_lora_b"):
            assert tg["layers"][name].abs().sum() > 0

    @pytest.mark.parametrize("model", ["cohere", "granite"])
    def test_the_full_loss_leaves_the_logit_scale_out(self, model):
        """JAX's training loss feeds the un-scaled head to the CE; only
        the logits (serving, the LoRA loss) carry the scale. The port's
        objective is JAX's, and the scale would move it."""
        jc, tc, jp, tp = _setup(model)
        batch = _batch(jc.vocab_size)
        want = float(jax.jit(jax_full_loss(jc))(jp, _jb(batch)))
        with torch.no_grad():
            got = float(tstep.full_loss(tp, _tb(batch), tc))
            tb = _tb(batch)
            scaled = float(tstep.cross_entropy_loss(tllama.forward(tp, tb["tokens"], tc), tb["targets"],
                                                    tb["mask"])[0])
        np.testing.assert_allclose(got, want, rtol=ATOL)
        assert abs(scaled - got) > 1e-3


class TestGptOss:
    def test_sinks_and_windows_train_as_jax(self):
        """Layer 0 slides over 16 keys, layer 1 is global; each layer's
        sinks get their own nonzero gradient, JAX's within 1e-4."""
        jc, tc, jp, tp = _setup("gpt_oss")
        assert tllama.layer_windows(tc) == [16, 0]
        grads = _grads_match(jc, tc, jp, tp, _batch(jc.vocab_size, seed=3))
        assert grads["layers"]["sinks"].dtype == torch.float32
        assert (grads["layers"]["sinks"].abs() > 0).all()

    @staticmethod
    def _planted_tree() -> dict:
        """Layer 0's experts with gate column 0 and up columns 1 and 2
        zeroed and their biases at +limit, +limit and -limit: g and u sit
        exactly at the clamps for every token an expert takes."""
        tr = jax.tree.map(np.copy, _tree("gpt_oss"))
        lim = np.float32(jllama.GPT_OSS_20B.act_limit)
        lay = tr["layers"]
        lay["w_gate"][0, :, :, 0] = 0.0
        lay["b_gate"][0, :, 0] = lim
        lay["w_up"][0, :, :, 1:3] = 0.0
        lay["b_up_e"][0, :, 1] = lim
        lay["b_up_e"][0, :, 2] = -lim
        return tr

    def test_clamped_glu_ties_follow_jax(self, monkeypatch):
        """At a gate or up value exactly at ±limit half the gradient
        passes, as JAX's ``jnp.minimum``/``jnp.clip`` give it; the clamp's
        rule (all of it) misses JAX's bias gradients there."""
        jc, tc, jp, tp = _setup("gpt_oss", self._planted_tree())
        batch = _batch(jc.vocab_size, seed=5)
        _, jg = jax.jit(jax.value_and_grad(jax_full_loss(jc)))(jp, _jb(batch))
        _, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tc)
        _close_tree(tg, jg)
        planted = [(tg["layers"]["b_gate"][0, :, 0], jg["layers"]["b_gate"][0, :, 0]),
                   (tg["layers"]["b_up_e"][0, :, 1:3], jg["layers"]["b_up_e"][0, :, 1:3])]
        for got, want in planted:
            assert np.abs(np.asarray(want)).min() > 1e-6  # every expert took tokens
            # these gradients are 1e-5 to 2e-4: relative, so the tie rule shows
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=ATOL)

        def clamp_glu(g, u, limit):
            g, u = g.clamp(max=limit), u.clamp(-limit, limit)
            return (u + 1.0) * (g * torch.sigmoid(1.702 * g))

        monkeypatch.setattr(tmoe, "_oai_glu", clamp_glu)
        _, cg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), tc)
        for name, cols in (("b_gate", slice(0, 1)), ("b_up_e", slice(1, 3))):
            got, want = cg["layers"][name][0, :, cols].numpy(), np.asarray(jg["layers"][name][0, :, cols])
            # the clamp passes twice JAX's share at the ties
            assert np.abs(got - want).max() > 0.4 * np.abs(want).max(), name

    def test_three_whole_steps_match_jax(self):
        """The full trainer (CE + aux, clip, AdamW) three steps over the
        sinks, biases, f32 router bias and experts, JAX's step's losses and
        updated leaves within 1e-4."""
        jc, tc, jp, tp = _setup("gpt_oss")
        jopt = jstep.default_optimizer(lr=1e-3, warmup=1, decay_steps=100)
        topt = tstep.default_optimizer(lr=1e-3, warmup=1, decay_steps=100)
        mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1), devices=jax.devices()[:1])
        jstate, _ = jstep.sharded_init(jc, jopt, mesh, params=jax.tree.map(jnp.copy, jp))  # donated
        jfn = jstep.make_train_step(jc, jopt, mesh)
        tstate = tstep.init_train_state(tc, topt, params=tstep.tree_map(torch.clone, tp))
        tfn = tstep.make_train_step(tc, topt)
        for i in range(3):
            batch = _batch(jc.vocab_size, seed=10 + i)
            jstate, jm = jfn(jstate, _jb(batch))
            tstate, tm = tfn(tstate, _tb(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL)
            np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]), rtol=ATOL)
        _close_tree(tstate["params"], jstate["params"])


# ---------------------------------------------------------------------------
# remat: the masked attention is recomputed, the flash residuals kept
# ---------------------------------------------------------------------------

REMAT_T = 48  # three chunks of 16; neither head width (32, 64) is 48


def _saved_shapes(tc, tp, batch) -> list:
    """Shapes of the tensors autograd keeps across the forward of the full
    loss (``saved_tensors_hooks`` outside any checkpoint: a checkpoint's
    own hooks take the tensors it recomputes)."""
    shapes = []
    live = tstep.tree_map(lambda t: t.detach().requires_grad_(True), tp)

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tstep.full_loss(live, batch, tc)
    return shapes


@pytest.mark.parametrize("model", MASKED)
class TestRemat:
    def test_remat_gives_the_same_gradients(self, model):
        _, tc, _, tp = _setup(model)
        batch = _tb(_batch(tc.vocab_size, t=REMAT_T))
        loss_a, ga = tstep.value_and_grad(tstep.full_loss, tp, batch, tc)
        loss_b, gb = tstep.value_and_grad(tstep.full_loss, tp, batch, dataclasses.replace(tc, remat=True))
        assert float(loss_a) == float(loss_b)
        for a, b in zip(tstep.tree_leaves(ga), tstep.tree_leaves(gb)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    def test_no_scores_are_kept_across_the_forward(self, model, monkeypatch):
        """Without remat the masked attention keeps [B, H, T, T] tensors
        for its backward; under remat none is kept (the attention runs
        inside the layer's second checkpoint), and the flash layers still
        call K1's entry once each."""
        _, tc, _, tp = _setup(model)
        batch = _tb(_batch(tc.vocab_size, b=2, t=REMAT_T))

        def scores(shapes):
            return [s for s in shapes if len(s) == 4 and s[-2:] == (REMAT_T, REMAT_T)]

        assert scores(_saved_shapes(tc, tp, batch))
        calls = []
        real = tflash.flash_attention_with_lse

        def counted(*a, **kw):
            calls.append(a[0].shape)
            return real(*a, **kw)

        monkeypatch.setattr(tflash, "flash_attention_with_lse", counted)
        rc = dataclasses.replace(tc, remat=True)
        assert not scores(_saved_shapes(rc, tp, batch))
        flash_layers = sum(not tllama.masked_attention(rc, REMAT_T, nope) for nope in tllama.layer_nope(rc))
        assert flash_layers == (0 if model == "gpt_oss" else 1)
        # the plain flash forward on the CPU: FlashAttention(plain=False) calls K1's entry
        assert len(calls) == flash_layers


# ---------------------------------------------------------------------------
# the new leaves through the optimizer, the checkpoint and the MFU's counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_bits", [32, 8])
def test_a_bf16_gpt_oss_state_keeps_its_f32_leaves_through_a_step_and_a_checkpoint(tmp_path, opt_bits):
    """A bf16 gpt-oss's sinks and router bias stay f32 (as JAX's
    ``init_params`` makes them) through a full step, their moments too,
    and a checkpoint of the state restores every leaf byte for byte."""
    from dstack_tpu_torch.train import checkpoint as ck

    _, tc = _configs("gpt_oss")
    tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    opt = tstep.default_optimizer(lr=1e-3, warmup=1, opt_bits=opt_bits)
    state = tstep.init_train_state(tc, opt, seed=0, device="cpu")
    state, m = tstep.make_train_step(tc, opt)(state, _tb(_batch(tc.vocab_size, b=2, t=32)))
    assert np.isfinite(float(m["loss"])) and float(m["aux_loss"]) > 0
    for name in ("b_router", "sinks"):
        assert state["params"]["layers"][name].dtype == torch.float32, name
    if opt_bits == 32:
        assert state["opt_state"]["mu"]["layers"]["sinks"].dtype == torch.float32
    ck.save_checkpoint(str(tmp_path), 1, state)
    fresh = tstep.init_train_state(tc, opt, seed=1, device="cpu")
    restored, step = ck.restore_checkpoint(str(tmp_path), fresh)
    assert step == 1
    want, got = ck._flatten(state), ck._flatten(restored)
    assert set(got) == set(want)
    for path, leaf in want.items():
        if isinstance(leaf, int):
            assert got[path] == leaf, path
        else:
            assert got[path].dtype == leaf.dtype and torch.equal(got[path], leaf), path


@pytest.mark.parametrize("name", ["gpt-oss-20b", "starcoder2-7b", "qwen-2.5-7b", "glm-4-9b", "olmo-2-7b",
                                  "command-r-35b", "minitron-4b", "llama-4-scout"])
def test_active_params_and_flops_match_jax(name):
    t, j = tllama.CONFIGS[name], jllama.CONFIGS[name]
    assert t.num_params() == j.num_params() and t.num_active_params() == j.num_active_params()
    assert tstep.flops_per_token(t, 2048) == jstep.flops_per_token(j, 2048)


# ---------------------------------------------------------------------------
# finetune --hf-model against the JAX finetune
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,mode", [("gpt_oss", "lora"), ("qwen2", "full"), ("llama4_text", "full")])
def test_finetune_from_a_checkpoint_matches_the_jax_finetune(tmp_path, capsys, case, mode):
    """``finetune --hf-model DIR`` on a tiny transformers checkpoint (built
    here, no download; norms, biases and sinks drawn away from HF's init):
    its first loss is the JAX finetune's on the same batch within 1e-4
    (relative), both in bf16 as both load by default. llama4_text's chunk
    of 8 sits inside the 16-token rows, so its rope layers attend past
    the first chunk."""
    if case == "qwen2":
        from tests.test_torch_convert_hf import _save_tiny
    else:
        from tests.test_torch_convert_hf_moe import _save_tiny
    ckpt = tmp_path / f"tiny-{case}"
    _save_tiny(ckpt, case)
    corpus = tmp_path / "c.npy"
    # batch 8: the JAX finetune shards it over the tests' 8 CPU devices
    np.save(corpus, np.random.default_rng(1).integers(0, 128, (10, 17)).astype(np.int32))
    common = ["--hf-model", str(ckpt), "--data", str(corpus), "--batch", "8", "--seq-len", "16",
              "--log-every", "1", "--steps", "2"] + (["--full"] if mode == "full" else [])
    assert tfinetune.main(["--device", "cpu", "--out", str(tmp_path / "w"), *common]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["model"] == ckpt.name and summary["mode"] == mode
    assert np.isfinite([summary["first_loss"], summary["last_loss"]]).all()
    proc = subprocess.run(
        [sys.executable, "-m", "dstack_tpu.train.finetune", "--platform", "cpu",
         "--out", str(tmp_path / "wj"), *common],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:]
    jax_loss = float(re.search(r"step 1/2 loss=([0-9.]+)", proc.stdout).group(1))
    np.testing.assert_allclose(summary["first_loss"], jax_loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_sinks_under_autograd_take_the_masked_path(self, cuda):
        """gpt-oss's attention under autograd on bf16 CUDA tensors: no K1
        launch, and q, k, v and the sinks get the plain path's gradients
        (the same masked function, so bitwise); the K1 route with the sink
        rescale refuses tensors that need a gradient."""
        g = torch.Generator(device=cuda).manual_seed(0)
        q = torch.randn(2, 8, 512, 64, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(2, 2, 512, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
        sinks = torch.randn(8, generator=g, device=cuda)
        do = torch.randn(2, 8, 512, 64, generator=g, device=cuda).bfloat16()

        def grads(impl):
            ins = [t.clone().requires_grad_() for t in (q, k, v, sinks)]
            o = tattention.attention(*ins[:3], scale=0.125, window=128, sinks=ins[3], impl=impl)
            return torch.autograd.grad(o, ins, do)

        before = tflash.LAUNCHES
        got = grads(None)
        assert tflash.LAUNCHES == before
        for a, b in zip(got, grads("plain")):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="sinks_forward_only"):
            tattention.attention(q.requires_grad_(), k, v, sinks=sinks, sinks_forward_only=True)

    @pytest.mark.parametrize("h,hkv", [(36, 4), (32, 2)], ids=["starcoder2_g9", "glm4_g16"])
    def test_flash_forward_and_backward_groups(self, cuda, h, hkv):
        """K1 and K2/K3 at D = 128 and the new training GQA groups against
        their plain versions: K1 at 2e-2, each gradient by
        tests/test_torch_flash_bwd.py's rules (2e-2, and chip_smoke.py's
        per-tile relative RMS)."""
        from tests.test_torch_flash_bwd import _assert_card_close, _card_case

        g = torch.Generator(device=cuda).manual_seed(h)
        q = torch.randn(2, h, 1024, 128, generator=g, device=cuda).bfloat16()
        k, v = (torch.randn(2, hkv, 1024, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
        o, lse = tflash.flash_attention_with_lse(q, k, v)
        po, plse = tflash.flash_attention_plain(q, k, v)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, plse, atol=2e-2, rtol=2e-2)
        _assert_card_close(*_card_case(cuda, 2, h, hkv, 1024, 1024, 128, seed=h))
