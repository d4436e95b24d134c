"""The port's HF loader on the model types of the remaining families:
``mixtral``, ``qwen3_moe``, ``gpt_oss``, ``cohere2``, ``llama4_text`` and
``llama4`` (its text tower under ``text_config``), ``deepseek_v2`` and
``deepseek_v3``, on tiny checkpoints that transformers builds and saves
here (no download), as tests/compute/test_hf_parity.py builds them for the
JAX loader.

Every norm, bias, sink and DeepSeek's selection bias is drawn away from
HF's init, so a leaf loaded into the wrong place shows. Held to JAX: the
port's ``load_checkpoint`` gives the JAX ``load_checkpoint``'s config field
for field and its parameters leaf for leaf, bitwise in f32 (gpt-oss's
interleaved ``gate_up_proj`` split into even and odd columns, Llama4's
gate-then-up halves with no transpose, the f32 router and selection
biases); the port's forward on those parameters gives the JAX forward's
logits within 1e-4. A multimodal Llama4 checkpoint's two key layouts load
its text tower; the V2 mscale switch and V3's yarn scale give JAX's
softmax scale; and every refusal of the JAX converter is the port's:
qwen3_moe's dense layers and windows, llama4's interleaved MoE and
non-periodic NoPE layers, gpt_oss's deviating layer types, cohere2's q/k
norm, DeepSeek's attention bias, ``moe_layer_freq`` and unknown
``topk_method``."""

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

B, T = 2, 16
ATOL = 1e-4
_MLA = dict(num_key_value_heads=4, q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=24, head_dim=16)
# case → (HF config class, model class, extra config fields)
CASES = {
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(num_local_experts=4, num_experts_per_tok=2)),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", dict(
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96, norm_topk_prob=True,
        decoder_sparse_step=1, mlp_only_layers=[], head_dim=16)),
    "gpt_oss": ("GptOssConfig", "GptOssForCausalLM", dict(
        intermediate_size=64, head_dim=16, num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
        tie_word_embeddings=False)),
    "cohere2": ("Cohere2Config", "Cohere2ForCausalLM", dict(
        logit_scale=0.0625, pad_token_id=0, sliding_window=8, sliding_window_pattern=4,
        layer_types=["sliding_attention", "sliding_attention", "sliding_attention", "full_attention"])),
    "llama4_text": ("Llama4TextConfig", "Llama4ForCausalLM", dict(
        head_dim=16, num_local_experts=4, num_experts_per_tok=1, interleave_moe_layer_step=1,
        no_rope_layers=[1, 1, 1, 0], attention_chunk_size=8, attn_temperature_tuning=True, attn_scale=0.1,
        floor_scale=4.0, use_qk_norm=True, rope_theta=500000.0)),
    "deepseek_v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM", dict(
        _MLA, q_lora_rank=None, first_k_dense_replace=1, n_routed_experts=8, n_shared_experts=2,
        num_experts_per_tok=3, moe_intermediate_size=32, topk_method="group_limited_greedy", n_group=4,
        topk_group=2, norm_topk_prob=False, routed_scaling_factor=1.5)),
    "deepseek_v3": ("DeepseekV3Config", "DeepseekV3ForCausalLM", dict(
        _MLA, first_k_dense_replace=1, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=3,
        moe_intermediate_size=32, n_group=4, topk_group=2, norm_topk_prob=True, routed_scaling_factor=2.5,
        rope_scaling={"rope_type": "yarn", "factor": 40.0, "beta_fast": 32.0, "beta_slow": 1.0,
                      "mscale": 1.0, "mscale_all_dim": 1.0, "original_max_position_embeddings": 8})),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_tiny(path, case: str):
    config_cls, model_cls, extra = CASES[case]
    torch.manual_seed(0)
    cfg = getattr(transformers, config_cls)(**{
        "vocab_size": 128, "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 4,
        "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 64, **extra,
    })
    model = getattr(transformers, model_cls)(cfg)
    model.eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, w in [*model.named_parameters(), *model.named_buffers()]:
            if "norm" in name or name.endswith("bias") or name.endswith("sinks"):
                # DeepSeek's selection bias stays small: a large one can tie
                # whole groups at the masked zeros (test_hf_parity.py's note)
                scale = 0.1 if "e_score_correction_bias" in name else 0.3
                w.add_(torch.randn(w.shape, generator=g) * scale)
    model.save_pretrained(path)
    return model


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _assert_same_params(tp: dict, jp: dict) -> None:
    """Every leaf bitwise equal, in its dtype (the f32 biases included)."""
    tl, jl = _flat(tp), _flat(jax.tree.map(np.asarray, jp))
    assert sorted(tl) == sorted(jl)
    for name, want in jl.items():
        got = tl[name]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _assert_same_config(tc, jc) -> None:
    for f in dataclasses.fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tllama.layer_windows(tc) == jllama.layer_windows(jc)
    assert tllama.layer_nope(tc) == jllama.layer_nope(jc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_jax_loader(tmp_path, case):
    """Config field for field, parameters bitwise, and the forward on them
    within 1e-4 of JAX's."""
    _save_tiny(tmp_path, case)
    tc, tp = tconvert.load_checkpoint(tmp_path, dtype=torch.float32)
    jc, jp = jconvert.load_checkpoint(str(tmp_path), dtype=jnp.float32)
    _assert_same_config(tc, jc)
    _assert_same_params(tp, jp)
    shapes = {n: tuple(w.shape) for n, w in _flat(tp).items()}
    assert shapes == {n: tuple(s) for n, s in _flat(tllama.param_shapes(tc)).items()}
    tokens = np.random.default_rng(0).integers(0, tc.vocab_size, (B, T))
    want = jllama.forward(jax.device_put(jp), jnp.asarray(tokens), dataclasses.replace(jc, remat=False))
    with torch.no_grad():
        got = tllama.forward(tp, torch.from_numpy(tokens), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_the_families_flags(tmp_path):
    """What each case's config carries (as tests/compute/test_hf_parity.py
    reads the JAX loader's)."""
    want = {
        "mixtral": dict(n_experts=4, experts_per_token=2, router_renorm=True),
        "qwen3_moe": dict(qk_norm=True, n_experts=4, router_renorm=True, intermediate_size=96),
        "gpt_oss": dict(attn_sinks=True, moe_bias=True, router_topk_softmax=True, moe_act="oai_glu",
                        sliding_window=8, sliding_pattern=2, qkv_bias=True, proj_bias=True),
        "cohere2": dict(parallel_block=True, norm_type="layernorm", sliding_pattern=4, nope_pattern=4),
        "llama4_text": dict(rope_interleaved=True, qk_l2_norm=True, nope_pattern=4, attention_chunk_size=8,
                            router_sigmoid_input=True, moe_shared_expert=True, attn_temp_scale=0.1,
                            attn_temp_floor=4.0),
        "deepseek_v2": dict(router_score="softmax", router_groups=(4, 2), moe_shared_intermediate=64,
                            first_k_dense=1, q_lora_rank=0),
        "deepseek_v3": dict(router_score="sigmoid", router_bias=True, router_groups=(4, 2),
                            routed_scale=2.5, router_renorm=True, q_lora_rank=48),
    }
    for case, fields in want.items():
        _save_tiny(tmp_path / case, case)
        c = tconvert.config_from_hf(json.loads((tmp_path / case / "config.json").read_text()))
        for f, v in fields.items():
            assert getattr(c, f) == v, (case, f)
    assert c.attn_scale == pytest.approx(48**-0.5 * (0.1 * np.log(40.0) + 1.0) ** 2, rel=1e-12)


@pytest.mark.parametrize("layout", ["language_model.model.", "model.language_model."])
def test_llama4_multimodal_layouts_load_the_text_tower(tmp_path, layout):
    """A ``llama4`` checkpoint nests the text tower's config under
    ``text_config`` and its weights under a language-model prefix beside
    the vision tower's: both loaders keep the text tower, alike."""
    _save_tiny(tmp_path, "llama4_text")
    hf = json.loads((tmp_path / "config.json").read_text())
    wrapper = {"model_type": "llama4", "text_config": hf}
    tc = tconvert.config_from_hf(wrapper, dtype=torch.float32)
    jc = jconvert.config_from_hf(wrapper, dtype=jnp.float32)
    _assert_same_config(tc, jc)
    sd = tconvert._load_raw_state_dict(tmp_path)
    # the head sits beside the text tower's layers, under the language-model prefix
    wrapped = {(k.replace("model.", layout, 1) if k.startswith("model.") else "language_model." + k): v
               for k, v in sd.items()}
    wrapped["vision_model.patch_embedding.linear.weight"] = torch.zeros(4, 3)
    got = tconvert.convert_state_dict(wrapped, tc, "llama4")
    _assert_same_params(got, jconvert.convert_state_dict(wrapped, jc, "llama4"))
    plain = tconvert.convert_state_dict(sd, tc, "llama4_text")
    for name, w in _flat(plain).items():
        assert torch.equal(_flat(got)[name], w), name


@pytest.mark.parametrize("fix", [False, True])
def test_deepseek_v2_mscale_switch(monkeypatch, fix):
    """V2 takes V3's mscale² on its softmax scale only with the switch
    (HF's native V2 applies none); the port's copy of the switch reads the
    same variable as JAX's."""
    if fix:
        monkeypatch.setenv("DTPU_DEEPSEEK_V2_MSCALE_FIX", "1")
    else:
        monkeypatch.delenv("DTPU_DEEPSEEK_V2_MSCALE_FIX", raising=False)
    hf = {"model_type": "deepseek_v2", "hidden_size": 128, "num_attention_heads": 4, "num_hidden_layers": 2,
          "num_key_value_heads": 4, "intermediate_size": 256, "vocab_size": 128, "rope_theta": 10000.0,
          "q_lora_rank": None, "kv_lora_rank": 32, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
          "v_head_dim": 24, "head_dim": 16, "first_k_dense_replace": 2,
          "rope_scaling": {"rope_type": "yarn", "factor": 40.0, "mscale": 0.707, "mscale_all_dim": 0.707,
                           "original_max_position_embeddings": 4096, "beta_fast": 32, "beta_slow": 1}}
    t, j = tconvert.config_from_hf(hf), jconvert.config_from_hf(hf)
    assert t.attn_scale == j.attn_scale
    assert (t.attn_scale is None) == (not fix)


_BASE = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 4, "num_key_value_heads": 2,
         "vocab_size": 128, "intermediate_size": 96}
_DEEPSEEK = {**_BASE, "kv_lora_rank": 32, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 24,
             "n_routed_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
             "first_k_dense_replace": 1}


@pytest.mark.parametrize("hf,match", [
    ({"model_type": "qwen3_moe", "moe_intermediate_size": 96, "num_experts": 4, "mlp_only_layers": [0]},
     "dense layers"),
    ({"model_type": "qwen3_moe", "moe_intermediate_size": 96, "num_experts": 4, "decoder_sparse_step": 2},
     "dense layers"),
    ({"model_type": "qwen3_moe", "moe_intermediate_size": 96, "num_experts": 4, "use_sliding_window": True},
     "sliding windows"),
    ({"model_type": "llama4_text", "num_local_experts": 4, "interleave_moe_layer_step": 2}, "interleave"),
    ({"model_type": "llama4_text", "num_local_experts": 4, "moe_layers": [1, 3]}, "interleave"),
    ({"model_type": "llama4_text", "num_local_experts": 4, "no_rope_layers": [1, 0, 0, 1]}, "periodic"),
    ({"model_type": "gpt_oss", "num_local_experts": 4,
      "layer_types": ["full_attention", "sliding_attention"] * 2}, "layer_types"),
    ({"model_type": "cohere2", "use_qk_norm": True}, "use_qk_norm"),
    ({"model_type": "deepseek_v3", **_DEEPSEEK, "attention_bias": True, "n_group": 1, "topk_group": 1},
     "attention_bias"),
    ({"model_type": "deepseek_v2", **_DEEPSEEK, "moe_layer_freq": 2}, "moe_layer_freq"),
    ({"model_type": "deepseek_v2", **_DEEPSEEK, "topk_method": "sparse"}, "topk_method"),
    ({"model_type": "mixtral", "num_local_experts": 4, "attention_bias": True}, "attention_bias"),
])
def test_refusals_are_jax_refusals(hf, match):
    hf = {**_BASE, **hf}
    with pytest.raises(ValueError, match=match):
        jconvert.config_from_hf(hf)
    with pytest.raises(ValueError, match=match):
        tconvert.config_from_hf(hf)


@pytest.mark.parametrize("nrl,pattern", [([0, 0, 0, 0], 1), ([1, 1, 1, 1], 0), (None, 4), ([1, 0, 1, 0], 2)])
def test_llama4_nope_layouts(nrl, pattern):
    """``no_rope_layers`` (1 = rope): all zeros is every layer NoPE, all
    ones none, absent Llama4's period 4."""
    hf = {**_BASE, "model_type": "llama4_text", "num_local_experts": 4,
          **({"no_rope_layers": nrl} if nrl is not None else {})}
    t, j = tconvert.config_from_hf(hf), jconvert.config_from_hf(hf)
    assert t.nope_pattern == j.nope_pattern == pattern
    assert tllama.layer_nope(t) == jllama.layer_nope(j)
