"""The port's training path against the JAX package's on the CPU, in f32.

The same weights (carried across with ``params_from_jax`` and
``lora_from_jax``) and the same batches (drawn with numpy) go through
both: the whole-sequence forward (1e-4), the loss gradients before any
update (1e-4, with a ragged mask and with grad_accum=2), the optimizer
alone on identical gradients (1e-6: Adam turns a 1e-7 difference in a
gradient near zero into a full +-lr step, so it is checked apart from
the model), and three whole steps (losses within 1e-4 relative), for the
full fine-tune and for LoRA. The JAX steps run on a 1-device mesh, as
tests/compute/test_llama.py does.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.parallel.mesh import MeshConfig, make_mesh
from dstack_tpu.train import data as jdata
from dstack_tpu.train import lora as jlora
from dstack_tpu.train import step as jstep
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.ops import flash as tflash
from dstack_tpu_torch.train import data as tdata
from dstack_tpu_torch.train import finetune
from dstack_tpu_torch.train import lora as tlora
from dstack_tpu_torch.train import step as tstep

ATOL = 1e-4  # f32 end to end; sums in another order than XLA's
OPT_TOL = 1e-6

CONFIGS = {
    "tiny64": (jllama.LLAMA_TINY_64, tllama.LLAMA_TINY_64),
    "tiny": (jllama.LLAMA_TINY, tllama.LLAMA_TINY),
    # the tied head of llama-3.2-1b: the embedding gets gradients from
    # the lookup and from the head
    "tiny64-tied": (
        dataclasses.replace(jllama.LLAMA_TINY_64, tie_embeddings=True),
        dataclasses.replace(tllama.LLAMA_TINY_64, tie_embeddings=True),
    ),
}
LORA = (jlora.LoRAConfig(rank=4, alpha=8.0), tlora.LoRAConfig(rank=4, alpha=8.0))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(cj, ct, seed=0):
    jp = jllama.init_params(cj, jax.random.key(seed))
    return jp, tllama.params_from_jax(_np_tree(jp), ct, device="cpu")


def _lora(cj, ct, seed=1):
    """Adapters with B != 0, so every factor gets a gradient."""
    jl = _np_tree(jlora.init_lora_params(cj, LORA[0], jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    jl = {"layers": {
        k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32) if k.endswith("_b") else v
        for k, v in jl["layers"].items()
    }}
    return jl, tlora.lora_from_jax(jl, ct, LORA[1], device="cpu")


def _batch(vocab, b=4, t=64, seed=1, ragged=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[:, -1] = 0  # the roll wraps the last target
    if ragged:
        mask[b // 2 :, t // 2 :] = 0
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1), "mask": mask}


WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta", "iota", "kappa", "lambda", "mu"]
EOS_ID = len(WORDS) + 1  # after [UNK]


def _local_tokenizer(path):
    """A word-level HF tokenizer built locally with ``tokenizers`` (no
    download), its eos ``</s>``, saved with ``save_pretrained``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[UNK]": 0, **{w: i + 1 for i, w in enumerate(WORDS)}, "</s>": EOS_ID}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="</s>", unk_token="[UNK]").save_pretrained(str(path))
    return path


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _close_tree(t_tree, j_tree, atol, rtol=None):
    rtol = atol if rtol is None else rtol
    flat_j = jax.tree_util.tree_leaves_with_path(j_tree)
    assert len(flat_j) == len(tstep.tree_leaves(t_tree))
    for path, leaf in flat_j:
        node = t_tree
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(
            node.detach().numpy(), np.asarray(leaf), atol=atol, rtol=rtol, err_msg=str(path)
        )


def _mesh():
    return make_mesh(MeshConfig(dp=1, fsdp=1, tp=1), devices=jax.devices()[:1])


def _jax_full_loss(cj):
    def loss_fn(p, batch):
        x = jllama.forward(p, batch["tokens"], cj, return_hidden=True)
        head = (p["embed"].T if cj.tie_embeddings else p["lm_head"]).astype(cj.dtype)
        return jstep.fused_cross_entropy(x, head, batch["targets"], batch["mask"])[0]

    return loss_fn


def _jax_lora_loss(cj):
    def loss_fn(lora, p, batch):
        logits = jllama.forward(p, batch["tokens"], cj, lora=lora, lora_scale=LORA[0].scale)
        return jstep.cross_entropy_loss(logits, batch["targets"], batch["mask"])[0]

    return loss_fn


def _jax_accum(value_and_grad, batch, n):
    """The JAX step's mask-weighted microbatch average (step.py:336),
    written out over numpy batches."""
    g_acc, loss_acc, w_acc = None, 0.0, 0.0
    size = batch["tokens"].shape[0] // n
    for i in range(n):
        mb = {k: v[i * size : (i + 1) * size] for k, v in batch.items()}
        loss, g = value_and_grad(_jb(mb))
        w = max(float(mb["mask"].sum()), 1.0)
        g = jax.tree.map(lambda a: np.asarray(a, np.float32) * w, g)
        g_acc = g if g_acc is None else jax.tree.map(np.add, g_acc, g)
        loss_acc += float(loss) * w
        w_acc += w
    return loss_acc / w_acc, jax.tree.map(lambda a: a / w_acc, g_acc)


class TestForward:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    @pytest.mark.parametrize("return_hidden", [False, True])
    def test_matches_jax_forward(self, name, return_hidden):
        cj, ct = CONFIGS[name]
        jp, tp = _params(cj, ct)
        tokens = _batch(cj.vocab_size, b=2, t=48)["tokens"]
        j = jllama.forward(jp, jnp.asarray(tokens), cj, return_hidden=return_hidden)
        with torch.no_grad():
            t = tllama.forward(tp, torch.from_numpy(tokens).long(), ct, return_hidden=return_hidden)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=ATOL)

    def test_lora_forward_matches_jax(self):
        cj, ct = CONFIGS["tiny"]
        jp, tp = _params(cj, ct)
        jl, tl = _lora(cj, ct)
        tokens = _batch(cj.vocab_size, b=2, t=32)["tokens"]
        j = jllama.forward(jp, jnp.asarray(tokens), cj, lora=jl, lora_scale=LORA[0].scale)
        with torch.no_grad():
            t = tllama.forward(tp, torch.from_numpy(tokens).long(), ct, lora=tl, lora_scale=LORA[1].scale)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=ATOL)

    def test_remat_gives_the_same_gradients(self):
        cj, ct = CONFIGS["tiny64"]
        _, tp = _params(cj, ct)
        batch = _tb(_batch(ct.vocab_size, b=2, t=32))
        remat = dataclasses.replace(ct, remat=True)
        loss_a, ga = tstep.value_and_grad(tstep.full_loss, tp, batch, ct)
        loss_b, gb = tstep.value_and_grad(tstep.full_loss, tp, batch, remat)
        assert float(loss_a) == float(loss_b)
        for a, b in zip(tstep.tree_leaves(ga), tstep.tree_leaves(gb)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("name", ["llama-3.2-1b", "llama-3-8b", "llama-tiny", "llama-tiny-64"])
    def test_num_params_and_remat_match_jax(self, name):
        assert tllama.CONFIGS[name].num_params() == jllama.CONFIGS[name].num_params()
        assert tllama.CONFIGS[name].remat == jllama.CONFIGS[name].remat

    def test_flops_per_token_matches_jax(self):
        for name in ("llama-3.2-1b", "llama-tiny"):
            assert tstep.flops_per_token(tllama.CONFIGS[name], 2048) == jstep.flops_per_token(
                jllama.CONFIGS[name], 2048
            )


class TestLosses:
    def test_cross_entropy_matches_jax(self):
        rng = np.random.default_rng(0)
        logits = rng.standard_normal((2, 5, 17)).astype(np.float32) * 3
        targets = rng.integers(0, 17, size=(2, 5)).astype(np.int32)
        mask = (rng.random((2, 5)) > 0.3).astype(np.int32)
        jl, jw = jstep.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
        tl, tw = tstep.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask)
        )
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        assert float(tw) == float(jw)

    def test_fused_cross_entropy_matches_jax(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 5, 16)).astype(np.float32)
        head = rng.standard_normal((16, 33)).astype(np.float32)
        targets = rng.integers(0, 33, size=(2, 5)).astype(np.int32)
        j, _ = jstep.fused_cross_entropy(jnp.asarray(x), jnp.asarray(head), jnp.asarray(targets), None)
        t, _ = tstep.fused_cross_entropy(
            torch.from_numpy(x), torch.from_numpy(head), torch.from_numpy(targets), None
        )
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


class TestGradients:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_full_loss_grads_match_jax(self, name):
        cj, ct = CONFIGS[name]
        jp, tp = _params(cj, ct)
        batch = _batch(cj.vocab_size)
        jl, jg = jax.value_and_grad(_jax_full_loss(cj))(jp, _jb(batch))
        tl, tg = tstep.value_and_grad(tstep.full_loss, tp, _tb(batch), ct)
        np.testing.assert_allclose(float(tl), float(jl), rtol=ATOL)
        _close_tree(tg, jg, ATOL)

    def test_grad_accum_matches_the_weighted_jax_average(self):
        cj, ct = CONFIGS["tiny64"]
        jp, tp = _params(cj, ct)
        batch = _batch(cj.vocab_size)  # ragged: the halves weigh 126 and 62
        vg = jax.jit(jax.value_and_grad(_jax_full_loss(cj)))
        jl, jg = _jax_accum(lambda mb: vg(jp, mb), batch, 2)
        tl, tg = tstep.accumulate_grads(tstep.full_loss, tp, _tb(batch), 2, ct)
        np.testing.assert_allclose(float(tl), jl, rtol=ATOL)
        _close_tree(tg, jg, ATOL)

    def test_lora_grads_match_jax(self):
        cj, ct = CONFIGS["tiny"]
        jp, tp = _params(cj, ct)
        jl, tl = _lora(cj, ct)
        batch = _batch(cj.vocab_size)
        jloss, jg = jax.value_and_grad(_jax_lora_loss(cj))(jl, jp, _jb(batch))
        tloss, tg = tstep.value_and_grad(tlora.lora_loss, tl, _tb(batch), tp, ct, LORA[1])
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL)
        _close_tree(tg, jg, ATOL)

    def test_lora_grad_accum_matches_the_weighted_jax_average(self):
        cj, ct = CONFIGS["tiny"]
        jp, tp = _params(cj, ct)
        jl, tl = _lora(cj, ct)
        batch = _batch(cj.vocab_size)
        vg = jax.jit(jax.value_and_grad(_jax_lora_loss(cj)))
        jloss, jg = _jax_accum(lambda mb: vg(jl, jp, mb), batch, 2)
        tloss, tg = tstep.accumulate_grads(tlora.lora_loss, tl, _tb(batch), 2, tp, ct, LORA[1])
        np.testing.assert_allclose(float(tloss), jloss, rtol=ATOL)
        _close_tree(tg, jg, ATOL)

    def test_base_weights_get_no_gradient_under_lora(self):
        cj, ct = CONFIGS["tiny"]
        _, tp = _params(cj, ct)
        _, tl = _lora(cj, ct)
        tstep.value_and_grad(tlora.lora_loss, tl, _tb(_batch(ct.vocab_size)), tp, ct, LORA[1])
        assert all(not w.requires_grad and w.grad is None for w in tstep.tree_leaves(tp))


class TestOptimizer:
    @pytest.mark.parametrize("tree", ["params", "lora"])
    def test_matches_optax_on_identical_gradients(self, tree):
        cj, ct = CONFIGS["tiny"]
        jp, tp = _params(cj, ct)
        if tree == "lora":
            jp, tp = _lora(cj, ct)
        jp = _np_tree(jp)
        jopt = jstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        topt = tstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        jst, tst = jopt.init(jp), topt.init(tp)
        rng = np.random.default_rng(7)
        # global norms well under, far over and near the clip at 1.0
        leaves = jax.tree.leaves(jp)
        n = sum(x.size for x in leaves)
        for step, norm in enumerate((0.05, 40.0, 1.5)):
            g = jax.tree.map(
                lambda x: (rng.standard_normal(x.shape) * norm / np.sqrt(n)).astype(np.float32), jp
            )
            before = jax.tree.map(np.copy, jp)
            upd, jst = jopt.update(g, jst, jp)
            jp = _np_tree(optax.apply_updates(jp, upd))
            tgrads = tstep.tree_map(torch.from_numpy, g)
            topt.update(tgrads, tst, tp)
            _close_tree(tp, jp, OPT_TOL)
            _close_tree(tst["mu"], jst[1][0].mu, OPT_TOL)
            if step == 0:  # the schedule reads count 0 first: lr = 0, no move
                _close_tree(tp, before, 0.0)
        assert tst["count"] == 3

    def test_schedule_matches_optax(self):
        for warmup, decay in ((1, 100), (10, 50), (100, 101)):
            j = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=warmup, decay_steps=decay)
            t = tstep.warmup_cosine_decay(3e-4, warmup, decay)
            for c in (0, 1, warmup - 1, warmup, warmup + 1, decay // 2, decay, decay + 5):
                # optax evaluates in f32, the port in Python floats
                np.testing.assert_allclose(t(c), float(j(c)), rtol=1e-5, atol=1e-12)

    def test_decay_steps_floor_is_warmup_plus_one(self):
        opt = tstep.default_optimizer(lr=1.0, warmup=100, decay_steps=6)
        assert opt.schedule(100) == 1.0 and opt.schedule(101) == 0.0


class TestWholeSteps:
    @pytest.mark.parametrize("grad_accum", [1, 2])
    def test_three_full_steps_match_jax(self, grad_accum):
        cj, ct = CONFIGS["tiny64"]
        jp, tp = _params(cj, ct)
        jopt = jstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        topt = tstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        mesh = _mesh()
        jstate, _ = jstep.sharded_init(cj, jopt, mesh, params=jp)
        jfn = jstep.make_train_step(cj, jopt, mesh, grad_accum=grad_accum)
        tstate = tstep.init_train_state(ct, topt, params=tp)
        tfn = tstep.make_train_step(ct, topt, grad_accum=grad_accum)
        for i in range(3):
            batch = _batch(cj.vocab_size, seed=10 + i)
            jstate, jm = jfn(jstate, _jb(batch))
            tstate, tm = tfn(tstate, _tb(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL)
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=ATOL)
        assert tstate["step"] == int(jstate["step"]) == 3

    def test_three_lora_steps_match_jax_and_merge(self):
        cj, ct = CONFIGS["tiny"]
        jp, tp = _params(cj, ct)
        jopt = jstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        topt = tstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        mesh = _mesh()
        jbase, jstate, _ = jlora.sharded_lora_init(cj, LORA[0], jopt, mesh, params=jp)
        tl = tlora.lora_from_jax(_np_tree(jstate["lora"]), ct, LORA[1], device="cpu")
        jfn = jlora.make_lora_train_step(cj, LORA[0], jopt, mesh)
        tstate = tlora.init_lora_state(tl, topt)
        tfn = tlora.make_lora_train_step(ct, LORA[1], topt)
        for i in range(3):
            batch = _batch(cj.vocab_size, seed=20 + i)
            jstate, jm = jfn(jbase, jstate, _jb(batch))
            tstate, tm = tfn(tp, tstate, _tb(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL)
        # the trained adapters fold into the base weights as JAX folds them
        jmerged = jlora.merge_lora_params(jbase, jstate["lora"], LORA[0])
        tmerged = tlora.merge_lora_params(tp, tstate["lora"], LORA[1])
        _close_tree(tmerged, jmerged, ATOL)

    def test_merged_weights_reproduce_the_bypass(self):
        cj, ct = CONFIGS["tiny"]
        _, tp = _params(cj, ct)
        _, tl = _lora(cj, ct)
        tokens = torch.from_numpy(_batch(ct.vocab_size, b=2, t=16)["tokens"]).long()
        with torch.no_grad():
            bypass = tllama.forward(tp, tokens, ct, lora=tl, lora_scale=LORA[1].scale)
            merged = tllama.forward(tlora.merge_lora_params(tp, tl, LORA[1]), tokens, ct)
        torch.testing.assert_close(merged, bypass, atol=1e-4, rtol=1e-4)


class TestData:
    def test_npy_and_bin_corpora_pack_as_jax_packs_them(self, tmp_path):
        rng = np.random.default_rng(0)
        stream = rng.integers(0, 60000, size=1000).astype(np.uint16)
        stream.tofile(tmp_path / "c.bin")
        np.save(tmp_path / "rows.npy", rng.integers(0, 500, size=(7, 50)).astype(np.int32))
        np.save(tmp_path / "flat.npy", stream.astype(np.int32))
        for name in ("c.bin", "rows.npy", "flat.npy"):
            path = str(tmp_path / name)
            np.testing.assert_array_equal(tdata.load_tokens(path, 32), jdata.load_tokens(path, 32))

    def test_pack_documents_and_batches_match_jax(self):
        docs = [np.arange(1, n + 1) for n in (5, 17, 3, 40, 9)]
        t = tdata.pack_documents(docs, 15, eos_id=0)
        np.testing.assert_array_equal(t, jdata.pack_documents(docs, 15, eos_id=0))
        tb = tdata.batches(t, 2, seed=3, epochs=1)
        jb = jdata.batches(t, 2, seed=3, epochs=1)
        for a, b in zip(tb, jb, strict=True):
            for k in ("tokens", "targets", "mask"):
                np.testing.assert_array_equal(a[k], b[k])

    @pytest.mark.parametrize("suffix", [".jsonl", ".txt"])
    def test_text_corpora_tokenize_and_pack_as_jax(self, tmp_path, monkeypatch, suffix):
        monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        tok_dir = _local_tokenizer(tmp_path / "tok")
        path = tmp_path / f"c{suffix}"
        docs = [" ".join(WORDS[(i * 7 + j) % len(WORDS)] for j in range(3 + i % 11)) for i in range(40)]
        if suffix == ".jsonl":
            path.write_text("".join(json.dumps({"text": d}) + "\n" + ("\n" if i % 9 == 0 else "")
                                    for i, d in enumerate(docs)))
        else:
            path.write_text("\n".join(d + ("\n" if i % 9 == 0 else "") for i, d in enumerate(docs)) + "\n")
        got = tdata.load_tokens(str(path), 15, tokenizer=str(tok_dir))
        want = jdata.load_tokens(str(path), 15, tokenizer=str(tok_dir))
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] > 4 and (got == EOS_ID).any()  # the tokenizer's eos ends each document

    def test_a_text_corpus_without_a_tokenizer_raises(self, tmp_path):
        (tmp_path / "c.txt").write_text("hi\n")
        with pytest.raises(ValueError, match="tokenizer"):
            tdata.load_tokens(str(tmp_path / "c.txt"), 8)

    def test_prefetch_yields_every_batch_in_order(self):
        rows = np.arange(5 * 9).reshape(5, 9).astype(np.int32)
        host = list(tdata.batches(rows, 2, seed=0, epochs=1))
        dev = list(tdata.prefetch_to_device(iter(host), "cpu"))
        assert len(dev) == len(host) == 2
        for h, d in zip(host, dev):
            assert torch.equal(d["tokens"], torch.from_numpy(h["tokens"]).long())


class TestFinetuneMain:
    @pytest.mark.parametrize("full", [True, False])
    def test_cpu_run_ends_with_its_summary_and_writes_weights(self, tmp_path, capsys, full):
        argv = [
            "--device", "cpu", "--model", "llama-tiny-64", "--steps", "3", "--batch", "2",
            "--seq-len", "32", "--log-every", "1", "--out", str(tmp_path),
        ] + (["--full"] if full else [])
        assert finetune.main(argv) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        summary = json.loads(lines[-1])
        assert summary["event"] == "summary" and summary["steps"] == 3
        assert summary["mode"] == ("full" if full else "lora")
        assert summary["loss_impl"] == ("fused" if full else None)  # [2, 32, 256] f32 logits fit
        assert np.isfinite(summary["first_loss"]) and np.isfinite(summary["last_loss"])
        # a CPU run names no device metric
        assert summary["mfu"] is None and summary["peak_memory_bytes"] is None
        assert any('"first_train_step"' in ln for ln in lines)
        assert sum(ln.startswith("step ") for ln in lines) == 3
        saved = np.load(tmp_path / ("model_weights.npz" if full else "lora_adapters.npz"))
        if full:
            assert {"embed", "layers/wq", "final_norm", "step"} <= set(saved.files)
            assert int(saved["step"]) == 3
        else:
            assert set(saved.files) == {
                f"layers.{m}_lora_{ab}" for m in ("wq", "wk", "wv", "wo") for ab in "ab"
            }

    def test_reads_a_npy_corpus(self, tmp_path, capsys):
        np.save(tmp_path / "c.npy", np.arange(4 * 33).reshape(4, 33).astype(np.int32) % 500)
        argv = [
            "--device", "cpu", "--model", "llama-tiny", "--steps", "2", "--batch", "2",
            "--seq-len", "32", "--log-every", "1", "--out", str(tmp_path), "--full",
            "--data", str(tmp_path / "c.npy"),
        ]
        assert finetune.main(argv) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 2

    @pytest.mark.parametrize(
        "extra",
        [
            ["--tp", "2"], ["--fsdp", "4"], ["--seq-parallel", "ring"], ["--sp", "2"],
            ["--batch", "3", "--grad-accum", "2"],
        ],
        # each case keeps the id of its position in the list it was added to
        ids=[f"extra{i}" for i in (0, 1, 2, 9, 10)],
    )
    def test_flags_without_a_counterpart_exit_non_zero(self, extra, capsys):
        # (--hf-model and --export-hf have their counterparts:
        # tests/test_torch_convert_hf.py, tests/test_torch_export_hf.py)
        with pytest.raises(SystemExit) as e:
            finetune.main(["--device", "cpu", "--model", "llama-tiny"] + extra)
        assert e.value.code != 0
        assert "not ported yet" in capsys.readouterr().err or "--grad-accum" in " ".join(extra)

    def test_gpt_oss_is_refused_before_its_weights_are_made(self, capsys):
        with pytest.raises(SystemExit) as e:
            finetune.main(["--device", "cpu", "--model", "gpt-oss-20b"])
        assert e.value.code != 0
        assert "A5.7" in capsys.readouterr().err


class TestChunkedLoss:
    @pytest.mark.parametrize("softcap", [0.0, 30.0])
    @pytest.mark.parametrize("budget", [256 * 1024 * 1024, 4 * 16 * 512 * 4])
    def test_matches_jax_and_the_fused_loss_with_gradients(self, softcap, budget):
        """``chunked_cross_entropy`` against JAX's (rtol 1e-5), in one chunk
        and in 4 (the budget fits [4, 16, 512] f32 logits), and against the
        fused loss, values and gradients of the hidden states and the head."""
        rng = np.random.default_rng(0)
        b, t, e, v = 4, 64, 32, 512
        x = (rng.standard_normal((b, t, e)) * 0.5).astype(np.float32)
        head = (rng.standard_normal((e, v)) * 0.2).astype(np.float32)
        batch = _batch(v, b=b, t=t)

        def jloss(x, head):
            return jstep.chunked_cross_entropy(x, head, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]),
                                               max_chunk_bytes=budget, softcap=softcap)[0]

        jl, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
        tx, th = torch.from_numpy(x).requires_grad_(), torch.from_numpy(head).requires_grad_()
        tb = _tb(batch)
        tl, total = tstep.chunked_cross_entropy(tx, th, tb["targets"], tb["mask"], max_chunk_bytes=budget,
                                                softcap=softcap)
        tgx, tgh = torch.autograd.grad(tl, (tx, th))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-7)
        assert float(total) == float(batch["mask"].sum())
        fx, fh = torch.from_numpy(x).requires_grad_(), torch.from_numpy(head).requires_grad_()
        fl = tstep.fused_cross_entropy(fx, fh, tb["targets"], tb["mask"], softcap=softcap)[0]
        fgx, fgh = torch.autograd.grad(fl, (fx, fh))
        np.testing.assert_allclose(float(tl), float(fl), rtol=1e-5)
        torch.testing.assert_close(tgx, fgx, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(tgh, fgh, rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("b, t, v, budget, want", [
        (8, 2048, 128256, 256 * 1024 * 1024, 32),  # llama-3-8b's step: [8, 64, V] f32 a chunk
        (8, 2048, 128256, 1 << 40, 1), (4, 64, 512, 4 * 16 * 512 * 4, 4), (2, 6, 10, 1, 6),
    ])
    def test_chunk_count_is_the_smallest_divisor_that_fits(self, b, t, v, budget, want):
        assert tstep.chunk_count(b, t, v, budget) == want

    def test_three_chunked_steps_match_jax(self):
        cj, ct = CONFIGS["tiny64"]
        jp, tp = _params(cj, ct)
        jopt = jstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        topt = tstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100)
        mesh = _mesh()
        jstate, _ = jstep.sharded_init(cj, jopt, mesh, params=jp)
        jfn = jstep.make_train_step(cj, jopt, mesh, loss_impl="chunked")
        tstate = tstep.init_train_state(ct, topt, params=tp)
        tfn = tstep.make_train_step(ct, topt, loss_impl="chunked")
        for i in range(3):
            batch = _batch(cj.vocab_size, seed=30 + i)
            jstate, jm = jfn(jstate, _jb(batch))
            tstate, tm = tfn(tstate, _tb(batch))
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL)
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=ATOL)

    @pytest.mark.parametrize("b, t, v, want", [
        (8, 2048, 128256, "chunked"),  # llama-3-8b's step: 8.4 GB of f32 logits
        (1, 2048, 128256, "chunked"),
        (1, 512, 131072, "fused"),  # exactly MAX_LOGITS_BYTES
        (2, 32, 256, "fused"),
    ])
    def test_the_default_loss_is_picked_by_the_logits_size(self, b, t, v, want):
        assert tstep.loss_impl_for(b, t, v) == want

    @pytest.mark.parametrize("budget, want", [(1 << 40, "fused"), (64, "chunked")])
    def test_the_default_step_takes_the_picked_loss(self, monkeypatch, budget, want):
        """``make_train_step``'s default (None) runs the loss
        ``loss_impl_for`` names for each micro-batch, and its gradients and
        loss are bitwise those of a step that names that loss."""
        cj, ct = CONFIGS["tiny64"]
        _, tp = _params(cj, ct)
        monkeypatch.setattr(tstep, "MAX_LOGITS_BYTES", budget)
        calls = {"fused": 0, "chunked": 0}
        for name in calls:
            real = getattr(tstep, f"{name}_cross_entropy")

            def spy(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(tstep, f"{name}_cross_entropy", spy)
        batch = _tb(_batch(cj.vocab_size, seed=40))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the CPU's threaded reductions are not bitwise repeatable
        try:
            got = tstep.value_and_grad(tstep.full_loss, tp, batch, ct)
            assert calls == {"fused": int(want == "fused"), "chunked": int(want == "chunked")}
            named = tstep.value_and_grad(lambda *a: tstep.full_loss(*a, loss_impl=want), tp, batch, ct)
        finally:
            torch.set_num_threads(threads)
        assert torch.equal(got[0], named[0])
        for a, b in zip(tstep.tree_leaves(got[1]), tstep.tree_leaves(named[1]), strict=True):
            assert torch.equal(a, b)

    def test_an_unknown_loss_impl_raises(self):
        with pytest.raises(ValueError, match="loss_impl"):
            tstep.make_train_step(CONFIGS["tiny64"][1], tstep.default_optimizer(), loss_impl="blocked")


class TestFlashResiduals:
    @pytest.mark.parametrize("grad_accum", [1, 2])
    def test_remat_keeps_the_residuals_bitwise_and_runs_k1_once_a_layer(self, monkeypatch, grad_accum):
        """Under remat the layer's flash call keeps q, k, v, o and lse (JAX's
        ``flash_residuals``): the gradients equal remat off bit for bit, and
        K1's entry runs n_layers times a micro-batch, as with remat off."""
        torch.set_num_threads(1)
        _, ct = CONFIGS["tiny"]
        _, tp = _params(*CONFIGS["tiny"])
        calls = []
        real = tflash.flash_attention_with_lse

        def counted(*args, **kw):
            calls.append(1)
            return real(*args, **kw)

        monkeypatch.setattr(tflash, "flash_attention_with_lse", counted)
        batch = _tb(_batch(ct.vocab_size, b=4, t=32))
        out = {}
        for remat in (False, True):
            calls.clear()
            cfg = dataclasses.replace(ct, remat=remat)
            out[remat] = tstep.accumulate_grads(tstep.objective, tp, batch, grad_accum, cfg, has_aux=True)
            assert len(calls) == ct.n_layers * grad_accum
        (la, _), ga = out[False]
        (lb, _), gb = out[True]
        assert float(la) == float(lb)
        for a, b in zip(tstep.tree_leaves(ga), tstep.tree_leaves(gb), strict=True):
            assert torch.equal(a, b)


class TestEval:
    @pytest.mark.parametrize("lora", [False, True])
    def test_eval_loss_matches_the_jax_finetunes_eval_forward(self, lora):
        """The port's ``eval_loss`` against JAX's ``_eval_fwd``
        (finetune.py:237-245: the forward's logits, ``cross_entropy_loss``)
        on the same weights and corpus batch, within 1e-4."""
        cj, ct = CONFIGS["tiny"]
        jp, tp = _params(cj, ct)
        jl, tl = _lora(cj, ct) if lora else (None, None)
        rows = np.random.default_rng(4).integers(0, cj.vocab_size, size=(6, 33)).astype(np.int32)
        for b in tdata.batches(rows, 2, seed=0, epochs=1):
            logits = jllama.forward(jp, jnp.asarray(b["tokens"]), cj, lora=jl, lora_scale=LORA[0].scale)
            jloss, jw = jstep.cross_entropy_loss(logits, jnp.asarray(b["targets"]), jnp.asarray(b["mask"]))
            tloss, tw = tstep.eval_loss(tp, _tb(b), ct, lora=tl, lora_scale=LORA[1].scale)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=ATOL, atol=ATOL)
            assert float(tw) == float(jw) and not tloss.requires_grad

    def test_make_eval_step_matches_jax(self):
        cj, ct = CONFIGS["tiny64-tied"]
        jp, tp = _params(cj, ct)
        batch = _batch(cj.vocab_size, b=2, t=32)
        j = jstep.make_eval_step(cj, _mesh())(jp, _jb(batch))
        t = tstep.make_eval_step(ct)(tp, _tb(batch))
        np.testing.assert_allclose(float(t["loss"]), float(j["loss"]), rtol=ATOL)


class TestFinetuneFeatures:
    def test_opt8_run_evaluates_and_reports(self, tmp_path, capsys):
        np.save(tmp_path / "ev.npy", np.random.default_rng(2).integers(0, 256, size=(5, 33)).astype(np.int32))
        argv = ["--device", "cpu", "--model", "llama-tiny-64", "--steps", "4", "--batch", "2", "--seq-len", "32",
                "--log-every", "1", "--out", str(tmp_path), "--full", "--opt-bits", "8",
                "--eval-data", str(tmp_path / "ev.npy"), "--eval-every", "2", "--eval-batches", "1"]
        assert finetune.main(argv) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        summary = json.loads(lines[-1])
        assert summary["opt_bits"] == 8 and summary["start_step"] == 0
        assert [e["tag"] for e in summary["eval"]] == ["step 2", "step 4", "final"]
        evals = [ln for ln in lines if ln.startswith("eval[")]
        assert len(evals) == 3 and all(" loss=" in ln and " ppl=" in ln for ln in evals)
        assert summary["eval"][-1]["ppl"] == pytest.approx(np.exp(min(summary["eval"][-1]["loss"], 30)))

    def test_a_text_corpus_trains_through_data_tokenizer(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        tok = _local_tokenizer(tmp_path / "tok")
        (tmp_path / "c.txt").write_text("\n".join(" ".join(WORDS[(i + j) % len(WORDS)] for j in range(9))
                                                  for i in range(60)) + "\n")
        argv = ["--device", "cpu", "--model", "llama-tiny-64", "--steps", "2", "--batch", "2", "--seq-len", "16",
                "--log-every", "1", "--out", str(tmp_path), "--full", "--data", str(tmp_path / "c.txt"),
                "--data-tokenizer", str(tok)]
        assert finetune.main(argv) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 2
