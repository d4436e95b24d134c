"""The port's HF loader (``dstack_tpu_torch.models.convert_hf``) on tiny
checkpoints that transformers builds and saves here (no download), as
tests/compute/test_hf_parity.py builds them for the JAX loader.

For llama (untied, and tied with Llama-3.1 rope scaling), gemma, gemma2,
gemma3 and gemma3 with linear rope scaling, and the dense families' types
(qwen2, qwen3, mistral with a window, phi3's fused projections, granite's
multipliers, starcoder2, nemotron, cohere with and without its per-head
q/k norms, olmo2, glm and glm4; their norms and biases drawn away from
HF's identity init, so a misplaced one shows): the
port's ``load_checkpoint`` gives the JAX ``load_checkpoint``'s config
field for field and its parameters leaf for leaf (exactly, in f32), and
the port's engine prefill gives HF's own forward logits within 1e-4 at
every position (f32 on the CPU). The safetensors parser is held to the
``safetensors`` package, the ``.bin`` route and the multimodal Gemma3
key layouts to the plain ones; the layouts JAX refuses
(qwen2's layered windows, qwen3's sliding layer types, phi3's partial
rope) raise as JAX's converter raises. The server's ``--hf-model`` serves a checkpoint named
after its directory, on the CPU here, and the fine-tune entry point's
``--hf-model`` trains one: it loads the JAX loader's parameters, and its
first step's loss on a ``.npy`` corpus is the JAX finetune's on the same
batch (both in bf16, as both load by default; the JAX finetune runs in a
subprocess, as tests/compute/test_checkpoint.py runs it, and prints its
loss to 4 decimals)."""

import dataclasses
import json
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from dstack_tpu.models import convert_hf as jconvert  # noqa: E402
from dstack_tpu_torch.models import convert_hf as tconvert  # noqa: E402
from dstack_tpu_torch.models import llama as tllama  # noqa: E402
from dstack_tpu_torch.serve import engine as tengine  # noqa: E402
from dstack_tpu_torch.train import finetune as tfinetune  # noqa: E402

B, T = 2, 16
ATOL = 1e-4

# family → (HF config class, model class, extra config fields): the cases
# of tests/compute/test_hf_parity.py
CASES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(rope_theta=10000.0, tie_word_embeddings=False)),
    "llama31_rope_scaling": ("LlamaConfig", "LlamaForCausalLM", dict(
        rope_theta=10000.0, tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8})),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(head_dim=16)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        head_dim=16, sliding_window=8, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=16)),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        head_dim=16, sliding_window=8, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        query_pre_attn_scalar=16,
        layer_types=["sliding_attention", "full_attention", "sliding_attention", "full_attention"])),
    "gemma3_linear_rope": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        head_dim=16, sliding_window=8, rope_theta=1000000.0, rope_local_base_freq=10000.0,
        query_pre_attn_scalar=16, rope_scaling={"rope_type": "linear", "factor": 8.0},
        layer_types=["sliding_attention", "full_attention", "sliding_attention", "full_attention"])),
    # the dense families (ROADMAP A3.1)
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", {}),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(head_dim=16)),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(sliding_window=8)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(pad_token_id=0)),
    "granite": ("GraniteConfig", "GraniteForCausalLM", dict(
        embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=0.015625,
        logits_scaling=8.0)),
    "starcoder2": ("Starcoder2Config", "Starcoder2ForCausalLM", dict(sliding_window=None, use_bias=True)),
    "nemotron": ("NemotronConfig", "NemotronForCausalLM", dict(partial_rotary_factor=0.5, head_dim=16)),
    "cohere": ("CohereConfig", "CohereForCausalLM", dict(logit_scale=0.0625, use_qk_norm=False, pad_token_id=0)),
    "cohere_qk_norm": ("CohereConfig", "CohereForCausalLM", dict(logit_scale=0.0625, use_qk_norm=True,
                                                                 pad_token_id=0)),
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM", {}),
    "glm": ("GlmConfig", "GlmForCausalLM", dict(head_dim=16, partial_rotary_factor=0.5, pad_token_id=0)),
    "glm4": ("Glm4Config", "Glm4ForCausalLM", dict(head_dim=16, partial_rotary_factor=0.5, pad_token_id=0)),
}
# the cases whose norms and biases are drawn away from HF's init (ones and
# zeros), so that a norm or bias loaded into the wrong leaf shows
PERTURBED = {"qwen2", "qwen3", "mistral", "phi3", "granite", "starcoder2", "nemotron", "cohere",
             "cohere_qk_norm", "olmo2", "glm", "glm4"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_tiny(path, case: str, fields=None, **save_kw):
    config_cls, model_cls, extra = CASES[case]
    torch.manual_seed(0)
    cfg = getattr(transformers, config_cls)(**{
        "vocab_size": 128, "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 4,
        "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 64,
        **extra, **(fields or {}),
    })
    model = getattr(transformers, model_cls)(cfg)
    model.eval()
    if case in PERTURBED:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, w in model.named_parameters():
                if "norm" in name or name.endswith(".bias"):
                    w.add_(torch.randn(w.shape, generator=g) * 0.3)
    model.save_pretrained(path, **save_kw)
    return model


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _leaves(tree: dict) -> dict:
    """{path: f32 numpy} of a torch or numpy parameter tree."""
    return {n: np.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v, np.float32)
            for n, v in _flat(tree).items()}


def _prefill_logits(config, params, tokens: np.ndarray) -> np.ndarray:
    """The port's serial prefill of each row as one chunk, read at every
    position (the chunk's causal mask makes position t's logits those of
    the prompt's first t + 1 tokens) → [B, T, V]."""
    out = np.zeros((*tokens.shape, config.vocab_size), np.float32)
    for b, row in enumerate(tokens):
        toks = torch.from_numpy(row[None]).long()
        for t in range(tokens.shape[1]):
            cache = tengine.init_cache(config, 1, 64, device="cpu")
            logits, _ = tengine.prefill_chunk_step(params, cache, toks, 0, t, config, start=0)
            out[b, t] = logits[0].numpy()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_loader_and_hf_forward(tmp_path, case):
    hf = _save_tiny(tmp_path, case)
    tc, tp = tconvert.load_checkpoint(tmp_path, dtype=torch.float32)
    jc, jp = jconvert.load_checkpoint(str(tmp_path), dtype=jnp.float32)
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tllama.layer_windows(tc) == jconvert._layer_windows(jc)
    tl, jl = _leaves(tp), _leaves(jax.tree.map(np.asarray, jp))
    assert sorted(tl) == sorted(jl)
    for name in jl:
        np.testing.assert_array_equal(tl[name], jl[name], err_msg=name)
    # the port's parameter tree is the one its engine and init_params use
    shapes = {n: tuple(w.shape) for n, w in _flat(tp).items()}
    assert shapes == {n: tuple(s) for n, s in _flat(tllama.param_shapes(tc)).items()}
    tokens = np.random.default_rng(0).integers(0, tc.vocab_size, (B, T))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(_prefill_logits(tc, tp, tokens), ref, atol=ATOL, rtol=ATOL)


def test_bin_shards_load_like_safetensors(tmp_path):
    _save_tiny(tmp_path / "st", "gemma2")
    _save_tiny(tmp_path / "bin", "gemma2", safe_serialization=False)
    assert list((tmp_path / "bin").glob("pytorch_model*.bin"))
    a = _leaves(tconvert.load_checkpoint(tmp_path / "st", dtype=torch.float32)[1])
    b = _leaves(tconvert.load_checkpoint(tmp_path / "bin", dtype=torch.float32)[1])
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("layout", ["language_model.model.", "model.language_model."])
def test_gemma3_multimodal_layouts_load_the_text_tower(tmp_path, layout):
    _save_tiny(tmp_path, "gemma3")
    hf = json.loads((tmp_path / "config.json").read_text())
    config = tconvert.config_from_hf({"model_type": "gemma3", "text_config": hf}, dtype=torch.float32)
    sd = tconvert._load_raw_state_dict(tmp_path)
    wrapped = {k.replace("model.", layout, 1): v for k, v in sd.items()}
    wrapped["vision_tower.vision_model.embeddings.patch_embedding.weight"] = torch.zeros(4, 3)
    got = _leaves(tconvert.convert_state_dict(wrapped, config, "gemma3"))
    want = _leaves(tconvert.convert_state_dict(sd, config, "gemma3_text"))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_server_serves_an_hf_checkpoint(tmp_path):
    """``python -m dstack_tpu_torch.serve.openai_server --hf-model DIR``:
    the model is named after the directory and answers a completion
    (head_dim 256: the decode kernel's width, which the server asks for)."""
    ckpt = tmp_path / "tiny-gemma3"
    _save_tiny(ckpt, "gemma3", fields=dict(head_dim=256, query_pre_attn_scalar=256))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.serve.openai_server", "--hf-model", str(ckpt),
         "--device", "cpu", "--port", str(port), "--max-batch", "2", "--max-seq", "64",
         "--prefill-chunk", "32"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/v1/models", timeout=5) as r:
                    models = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()[0]
                time.sleep(0.2)
        assert [m["id"] for m in models["data"]] == ["tiny-gemma3"]
        req = urllib.request.Request(
            base + "/v1/completions", headers={"Content-Type": "application/json"},
            data=json.dumps({"prompt": "hello", "max_tokens": 4, "temperature": 0}).encode(),
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["model"] == "tiny-gemma3" and body["usage"]["prompt_tokens"] == 5
        assert 1 <= body["usage"]["completion_tokens"] <= 4
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0].decode()
    assert "loaded HF checkpoint" in out and "tokenizer: byte" in out


@pytest.mark.parametrize("case,mode", [("gemma2", "lora"), ("gemma3", "full")])
def test_finetune_from_a_checkpoint_matches_the_jax_finetune(tmp_path, capsys, case, mode):
    """``python -m dstack_tpu_torch.train.finetune --hf-model DIR`` at
    head_dim 256 (the backward kernels' Gemma width): named after the
    directory; with no step its saved weights are the JAX loader's leaves;
    its first loss is the JAX finetune's on the same batch within 1e-4
    (relative)."""
    ckpt = tmp_path / f"tiny-{case}"
    _save_tiny(ckpt, case, fields=dict(head_dim=256, query_pre_attn_scalar=256))
    corpus = tmp_path / "c.npy"
    # batch 8: the JAX finetune shards it over the tests' 8 CPU devices
    np.save(corpus, np.random.default_rng(1).integers(0, 128, (10, 17)).astype(np.int32))
    common = ["--hf-model", str(ckpt), "--data", str(corpus), "--batch", "8", "--seq-len", "16",
              "--log-every", "1"] + (["--full"] if mode == "full" else [])

    assert tfinetune.main(["--device", "cpu", "--steps", "0", "--full", "--out", str(tmp_path / "w0"),
                           *[a for a in common if a != "--full"]]) == 0
    saved = np.load(tmp_path / "w0" / "model_weights.npz")
    _, jp = jconvert.load_checkpoint(str(ckpt))  # bf16, as both finetunes load
    want = {n: np.asarray(v, np.float32) for n, v in _flat(jax.tree.map(np.asarray, jp)).items()}
    assert sorted(set(saved.files) - {"step"}) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(saved[name], w, err_msg=name)
    capsys.readouterr()

    assert tfinetune.main(["--device", "cpu", "--steps", "1", "--out", str(tmp_path / "w1"), *common]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["model"] == ckpt.name and summary["mode"] == mode
    proc = subprocess.run(
        [sys.executable, "-m", "dstack_tpu.train.finetune", "--platform", "cpu", "--steps", "1",
         "--out", str(tmp_path / "wj"), *common],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:]
    jax_loss = float(re.search(r"step 1/1 loss=([0-9.]+)", proc.stdout).group(1))
    # relative, as tests/test_torch_train.py holds whole-step losses; the
    # JAX finetune's 4 decimals round by at most 5e-5 of the ~5e-4 allowed
    np.testing.assert_allclose(summary["first_loss"], jax_loss, rtol=1e-4)


@pytest.mark.parametrize("what", ["missing", "qwen2"])
def test_finetune_refuses_a_checkpoint_it_cannot_load(tmp_path, capsys, what):
    if what == "qwen2":
        (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen2"}))
    with pytest.raises(SystemExit) as e:
        tfinetune.main(["--device", "cpu", "--hf-model", str(tmp_path / "none" if what == "missing" else tmp_path)])
    assert e.value.code != 0
    assert "--hf-model" in capsys.readouterr().err


def test_bf16_load_and_the_engine_dtype(tmp_path):
    _save_tiny(tmp_path, "gemma3")
    config, params = tconvert.load_checkpoint(tmp_path)
    assert config.dtype == torch.bfloat16
    assert {w.dtype for w in _flat(params).values()} == {torch.bfloat16}


@pytest.mark.parametrize("model_type,fields,match", [
    ("qwen2", dict(use_sliding_window=True, sliding_window=8, max_window_layers=2), "max_window_layers"),
    ("qwen3", dict(layer_types=["full_attention", "sliding_attention"]), "sliding-attention"),
    ("phi3", dict(partial_rotary_factor=0.5), "partial_rotary_factor"),
    ("llama", dict(attention_bias=True), "attention_bias"),
    ("nemotron", dict(hidden_act="gelu"), "hidden_act"),
    ("falcon", {}, "unsupported HF model_type"),
])
def test_layouts_jax_refuses_raise(model_type, fields, match):
    """What the JAX converter refuses, the port refuses with its words."""
    hf = {"model_type": model_type, "hidden_size": 64, "num_attention_heads": 4,
          "num_hidden_layers": 2, "vocab_size": 128, "intermediate_size": 96, **fields}
    with pytest.raises(ValueError, match=match):
        tconvert.config_from_hf(hf)
    with pytest.raises(ValueError, match=match):
        jconvert.config_from_hf(hf)


def test_unsupported_rope_scaling_raises():
    hf = {"model_type": "llama", "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
          "vocab_size": 128, "intermediate_size": 96, "rope_scaling": {"rope_type": "longrope", "factor": 4.0}}
    with pytest.raises(ValueError, match="rope_scaling"):
        tconvert.config_from_hf(hf)


class TestSafetensorsParser:
    def test_matches_the_safetensors_package(self, tmp_path):
        st = pytest.importorskip("safetensors.torch")
        g = torch.Generator().manual_seed(0)
        tensors = {
            "f32": torch.randn(3, 5, generator=g),
            "bf16": torch.randn(7, 64, generator=g).bfloat16(),
            "f16": torch.randn(2, 2, 3, generator=g).half(),
            "f64": torch.randn(4, generator=g).double(),
            "i64": torch.randint(-5, 5, (6,), generator=g),
            "i32": torch.randint(-5, 5, (2, 3), generator=g, dtype=torch.int32),
            "i8": torch.randint(-128, 127, (9,), generator=g, dtype=torch.int8),
            "u8": torch.randint(0, 255, (3, 3), generator=g, dtype=torch.uint8),
            "bool": torch.rand(5, generator=g) > 0.5,
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 4),
        }
        path = tmp_path / "t.safetensors"
        st.save_file(tensors, str(path), metadata={"format": "pt"})
        got, want = tconvert.read_safetensors(path), st.load_file(str(path))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
            assert torch.equal(got[name], w), name

    def test_refuses_a_truncated_entry(self, tmp_path):
        header = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
        path = tmp_path / "bad.safetensors"
        path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
        with pytest.raises(ValueError, match="bytes for shape"):
            tconvert.read_safetensors(path)
