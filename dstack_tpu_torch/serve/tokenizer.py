"""Tokenizers for the serving engine (own copy of
``dstack_tpu.serve.tokenizer``).

``--tokenizer`` names a HuggingFace tokenizer directory (by default the
``--hf-model`` directory when a tokenizer file ships there), loaded
through ``transformers`` imported lazily, as ``train/data.py`` imports it;
without one the server uses the byte tokenizer (utf-8 bytes + bos/eos),
which fits any vocab >= 258 and needs no files.
"""

from typing import Optional, Protocol

#: the files whose presence in an ``--hf-model`` directory means a
#: tokenizer ships with the checkpoint (JAX's list)
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")


class Tokenizer(Protocol):
    bos_id: Optional[int]
    eos_id: Optional[int]

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """utf-8 bytes as ids 0..255; bos=256, eos=257."""

    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    def __init__(self, path: str):
        try:
            import tokenizers  # noqa: F401  (AutoTokenizer's fast backend)
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"--tokenizer {path} needs the HF 'transformers' package and its 'tokenizers' "
                f"backend, which this environment lacks ({e}); serve with '--tokenizer byte'"
            ) from e
        self._tok = AutoTokenizer.from_pretrained(path)
        # keep None when the tokenizer defines no bos/eos: coercing to 0
        # would turn a real vocab token into an implicit stop token
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(spec: Optional[str]) -> Tokenizer:
    if not spec or spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
