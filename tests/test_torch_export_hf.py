"""The port's HF export (``models/convert_hf.py``: ``config_to_hf``,
``export_state_dict``, ``save_checkpoint``, ``write_safetensors``) and
``finetune --export-hf`` against the JAX package on the CPU.

- ``config_to_hf`` equals JAX's on all 27 configs, or both raise the same
  message (gpt-oss).
- ``export_state_dict`` equals JAX's key for key and bit for bit on a tiny
  checkpoint of every model type the loaders read and the export writes
  (the tiny HF checkpoints of tests/test_torch_convert_hf.py and
  tests/test_torch_convert_hf_moe.py, loaded by each package), and refuses
  an int8 tree as JAX does.
- A ``save_checkpoint`` directory: the ``safetensors`` package reads the
  port's file as the port wrote it, both packages' ``load_checkpoint``
  give back the bf16 tree, and transformers' ``from_pretrained`` forward
  agrees with the port's forward within 1e-4 (llama, gemma, qwen2,
  mixtral, deepseek_v3).
- ``finetune --export-hf`` on a tiny llama, ``--full`` and LoRA: the
  directory loads back to the trained tree, or to the base with the
  adapters merged, rounded to bf16.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from dstack_tpu.models import convert_hf as jconvert  # noqa: E402
from dstack_tpu.models import llama as jllama  # noqa: E402
from dstack_tpu_torch.models import convert_hf as tconvert  # noqa: E402
from dstack_tpu_torch.models import llama as tllama  # noqa: E402
from dstack_tpu_torch.models import quant as tquant  # noqa: E402
from dstack_tpu_torch.train import finetune as tfinetune  # noqa: E402
from dstack_tpu_torch.train import lora as tlora  # noqa: E402
from tests import test_torch_convert_hf as dense_hf  # noqa: E402
from tests import test_torch_convert_hf_moe as moe_hf  # noqa: E402

ATOL = 1e-4
# every loadable case whose config the export writes (gpt-oss is refused)
EXPORTED = {**{c: dense_hf for c in dense_hf.CASES}, **{c: moe_hf for c in moe_hf.CASES if c != "gpt_oss"}}
FORWARD = ("llama", "gemma", "qwen2", "mixtral", "deepseek_v3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("name", sorted(tllama.CONFIGS))
def test_config_to_hf_matches_jax(name):
    try:
        want = jconvert.config_to_hf(jllama.CONFIGS[name])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconvert.config_to_hf(tllama.CONFIGS[name])
        assert str(got.value) == str(e)
        return
    got = tconvert.config_to_hf(tllama.CONFIGS[name])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("case", sorted(EXPORTED))
def test_export_state_dict_matches_jax(tmp_path, case):
    EXPORTED[case]._save_tiny(tmp_path, case)
    tc, tp = tconvert.load_checkpoint(tmp_path, dtype=torch.float32)
    jc, jp = jconvert.load_checkpoint(str(tmp_path), dtype=jnp.float32)
    want = jconvert.export_state_dict(jp, jc)
    got = tconvert.export_state_dict(tp, tc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_array_equal(_np(got[k]), _np(np.asarray(want[k])), err_msg=k)
    if case != "phi3":  # the export is the loader's inverse: the source's names (phi3's fused q/k/v aside)
        assert set(got) <= set(tconvert._load_raw_state_dict(tmp_path)) | {"lm_head.weight"}


def test_export_refuses_an_int8_tree():
    jc, tc = jllama.LLAMA_TINY, tllama.LLAMA_TINY
    params = tllama.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError) as want:
        jconvert.export_state_dict({"layers": {"wq_q": np.zeros((2, 1, 1), np.int8)}}, jc)
    with pytest.raises(ValueError) as got:
        tconvert.export_state_dict(tquant.quantize_tree(params, tc), tc)
    assert str(got.value) == str(want.value)


def _tree_equal(a: dict, b: dict) -> None:
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(_np(fa[k]), _np(fb[k]), err_msg=k)


@pytest.mark.parametrize("case", ["llama", "gemma2", "starcoder2", "glm4", "mixtral", "llama4_text",
                                  "deepseek_v3"])
def test_a_saved_checkpoint_loads_back_in_both_packages(tmp_path, case):
    """The port's tree in bf16 → ``save_checkpoint`` → each package's
    loader gives back that tree, and the ``safetensors`` package reads the
    port's file as the port wrote it."""
    from safetensors.torch import load_file

    EXPORTED[case]._save_tiny(tmp_path / "src", case)
    tc, tp = tconvert.load_checkpoint(tmp_path / "src")  # bf16
    tconvert.save_checkpoint(tc, tp, tmp_path / "out")
    written = load_file(str(tmp_path / "out" / "model.safetensors"))
    ours = tconvert.read_safetensors(tmp_path / "out" / "model.safetensors")
    assert sorted(written) == sorted(ours)
    for k in written:
        assert written[k].dtype == torch.bfloat16 and torch.equal(written[k], ours[k]), k
    # every tensor goes out in bf16, as JAX writes them: the f32 leaves
    # (DeepSeek's selection bias) come back rounded
    want = {k: ({n: w.bfloat16().to(w.dtype) for n, w in v.items()} if isinstance(v, dict) else v)
            for k, v in tp.items()}
    tc2, tp2 = tconvert.load_checkpoint(tmp_path / "out")
    assert tc2 == tc
    _tree_equal(tp2, want)
    jc2, jp2 = jconvert.load_checkpoint(str(tmp_path / "out"))
    _tree_equal(jax.tree.map(np.asarray, jp2), want)


@pytest.mark.parametrize("case", FORWARD)
def test_transformers_reads_the_export(tmp_path, case):
    """transformers' ``from_pretrained`` of the port's export, in f32,
    against the port's own forward of the same directory."""
    EXPORTED[case]._save_tiny(tmp_path / "src", case)
    tc, tp = tconvert.load_checkpoint(tmp_path / "src", dtype=torch.float32)
    tconvert.save_checkpoint(tc, tp, tmp_path / "out")
    hf = transformers.AutoModelForCausalLM.from_pretrained(tmp_path / "out", torch_dtype=torch.float32)
    hf.eval()
    c2, p2 = tconvert.load_checkpoint(tmp_path / "out", dtype=torch.float32)
    if c2.n_experts:  # HF routes with no capacity: no choice dropped
        c2 = dataclasses.replace(c2, capacity_factor=float(c2.n_experts))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, c2.vocab_size, (2, 16)))
    with torch.no_grad():
        want = hf(tokens).logits
        got = tllama.forward(p2, tokens, c2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)


FT = ["--device", "cpu", "--model", "llama-tiny", "--steps", "2", "--batch", "2", "--seq-len", "32",
      "--log-every", "1"]


def test_finetune_full_exports_the_trained_tree(tmp_path, capsys):
    out = tmp_path / "hf"
    assert tfinetune.main(FT + ["--full", "--out", str(tmp_path), "--export-hf", str(out)]) == 0
    assert f"HF checkpoint exported to {out}" in capsys.readouterr().out
    config, params = tconvert.load_checkpoint(out)
    trained = tllama.init_params(tllama.LLAMA_TINY, torch.Generator().manual_seed(0), device="cpu")
    tllama.load_weights_npz(trained, tmp_path / "model_weights.npz")
    assert config.n_layers == tllama.LLAMA_TINY.n_layers
    _tree_equal(params, {k: ({n: w.bfloat16() for n, w in v.items()} if isinstance(v, dict) else v.bfloat16())
                         for k, v in trained.items()})


def test_finetune_lora_exports_the_merged_tree(tmp_path):
    out = tmp_path / "hf"
    assert tfinetune.main(FT + ["--out", str(tmp_path), "--export-hf", str(out)]) == 0
    _, params = tconvert.load_checkpoint(out)
    base = tllama.init_params(tllama.LLAMA_TINY, torch.Generator().manual_seed(0), device="cpu")
    with np.load(tmp_path / "lora_adapters.npz") as f:
        adapters = {k.removeprefix("layers."): torch.from_numpy(f[k]) for k in f.files}
    merged = tlora.merge_lora_params(base, {"layers": adapters}, tlora.LoRAConfig(rank=16, alpha=32.0))
    assert not torch.equal(merged["layers"]["wq"], base["layers"]["wq"])
    _tree_equal(params, {k: ({n: w.bfloat16() for n, w in v.items()} if isinstance(v, dict) else v.bfloat16())
                         for k, v in merged.items()})
