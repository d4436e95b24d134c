"""Byte tokenizer for the serving engine (own copy of
dstack_tpu.serve.tokenizer.ByteTokenizer): utf-8 bytes + bos/eos, which
fits any vocab >= 258 and needs no files."""


class ByteTokenizer:
    """utf-8 bytes as ids 0..255; bos=256, eos=257."""

    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")
