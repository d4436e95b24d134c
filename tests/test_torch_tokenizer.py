"""The port's HF tokenizer (``dstack_tpu_torch.serve.tokenizer``) against
the JAX package's on tokenizers built locally with ``tokenizers`` and
saved with ``save_pretrained`` (no download).

- A word-level tokenizer with bos and eos, and a byte-level BPE one with
  neither: the same ids for a seeded corpus through JAX's ``HFTokenizer``
  and the port's, the same decodes, the same bos and eos, ``None`` kept
  where the tokenizer defines none; ``load_tokenizer`` gives the byte
  tokenizer for ``None`` and ``byte``, as JAX's.
- Without the ``tokenizers`` package the port's ``HFTokenizer`` raises an
  ImportError that names it.
- The server's ``--tokenizer`` defaults to the ``--hf-model`` directory
  when a tokenizer ships there (a tiny llama checkpoint beside the
  word-level tokenizer, served on the CPU without warmup: the app's
  tokenizer is the directory's), and stays the byte tokenizer when none
  does.
"""

import sys

import numpy as np
import pytest
import torch
import transformers

from dstack_tpu.serve import tokenizer as jtok
from dstack_tpu_torch.serve import openai_server as tserver
from dstack_tpu_torch.serve import tokenizer as ttok

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta", "iota", "kappa"]


def _word_level(path):
    """Word-level, its bos ``<s>`` and eos ``</s>``."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[UNK]": 0, "<s>": 1, "</s>": 2, **{w: i + 3 for i, w in enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="[UNK]",
    ).save_pretrained(str(path))
    return path


def _byte_bpe(path):
    """Byte-level BPE trained on a tiny corpus, with no bos or eos."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator([" ".join(WORDS) * 3, "the quick brown fox"],
                            trainers.BpeTrainer(vocab_size=300, initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok).save_pretrained(str(path))
    return path


def _corpus(seed: int) -> list:
    rng = np.random.default_rng(seed)
    words = WORDS + ["unknownword", "fox", "the", "ünï", "42"]
    return [" ".join(words[int(i)] for i in rng.integers(0, len(words), int(rng.integers(1, 12))))
            for _ in range(20)]


@pytest.mark.parametrize("build,bos,eos", [(_word_level, 1, 2), (_byte_bpe, None, None)],
                         ids=["word_level", "byte_bpe"])
def test_hf_tokenizer_matches_jax(tmp_path, build, bos, eos):
    path = str(build(tmp_path / "tok"))
    j, t = jtok.load_tokenizer(path), ttok.load_tokenizer(path)
    assert isinstance(t, ttok.HFTokenizer)
    assert (t.bos_id, t.eos_id) == (j.bos_id, j.eos_id) == (bos, eos)
    for text in _corpus(0):
        ids = t.encode(text)
        assert ids == j.encode(text) and ids
        assert t.decode(ids) == j.decode(ids)
        assert t.decode(ids + [eos] if eos is not None else ids) == j.decode(ids + [eos] if eos is not None else ids)


def test_byte_tokenizer_is_the_default():
    for spec in (None, "", "byte"):
        t, j = ttok.load_tokenizer(spec), jtok.load_tokenizer(spec)
        assert isinstance(t, ttok.ByteTokenizer) and isinstance(j, jtok.ByteTokenizer)
        assert (t.bos_id, t.eos_id, t.encode("héllo"), t.decode([104, 195, 169, 300])) == (
            j.bos_id, j.eos_id, j.encode("héllo"), j.decode([104, 195, 169, 300]))


def test_missing_tokenizers_package_is_named(tmp_path, monkeypatch):
    path = str(_word_level(tmp_path / "tok"))
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="'tokenizers'"):
        ttok.HFTokenizer(path)


def _serve_app(monkeypatch, argv) -> object:
    """``main(argv)`` up to the listener: the app it would run."""
    apps = []
    monkeypatch.setattr(tserver.web, "run_app", lambda app, **kw: apps.append(app))
    assert tserver.main(argv) == 0
    return apps[0]


@pytest.mark.parametrize("with_tokenizer", [True, False])
def test_tokenizer_defaults_to_the_hf_model_dir(tmp_path, monkeypatch, with_tokenizer):
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
    transformers.LlamaForCausalLM(cfg).save_pretrained(tmp_path)
    if with_tokenizer:
        _word_level(tmp_path)
    app = _serve_app(monkeypatch, ["--hf-model", str(tmp_path), "--device", "cpu", "--no-warmup",
                                   "--max-batch", "2", "--max-seq", "64", "--prefill-chunk", "16", "--decode-kernel", "einsum"])
    tok = app["scheduler"].tokenizer
    if with_tokenizer:
        assert isinstance(tok, ttok.HFTokenizer) and tok.eos_id == 2 and tok.encode("beta gamma") == [4, 5]
    else:
        assert isinstance(tok, ttok.ByteTokenizer)
    # an explicit --tokenizer byte wins over the directory's
    app = _serve_app(monkeypatch, ["--hf-model", str(tmp_path), "--device", "cpu", "--no-warmup",
                                   "--max-batch", "2", "--max-seq", "64", "--prefill-chunk", "16", "--decode-kernel", "einsum",
                                   "--tokenizer", "byte"])
    assert isinstance(app["scheduler"].tokenizer, ttok.ByteTokenizer)
