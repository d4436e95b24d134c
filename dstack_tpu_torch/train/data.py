"""Training data for the PyTorch port (counterpart of
dstack_tpu.train.data): load a corpus, pack it into fixed rows, iterate
shuffled batches, and copy them to the device one batch ahead.

A corpus is pre-tokenized (``.npy``, ``.bin``) or text (``.jsonl`` with a
``text`` field, ``.txt`` a document a line) tokenized by an HF tokenizer
at a local path, imported lazily from ``transformers`` as JAX imports it
(its ``tokenizers`` backend must be installed; the import error names it).
"""

import collections
import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["load_tokens", "pack_documents", "batches", "prefetch_to_device"]


def _tokenize_texts(texts: list, tokenizer_path: str) -> list[np.ndarray]:
    """Each text → its int32 ids with the tokenizer's eos appended (no
    other special tokens): JAX's ``_tokenize_texts`` (data.py:35-46)."""
    try:
        import tokenizers  # noqa: F401  (AutoTokenizer's fast backend)
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "text corpora (.jsonl/.txt) need the HF 'transformers' package and its 'tokenizers' "
            f"backend, which this environment lacks ({e}); pass a pre-tokenized .npy or .bin"
        ) from e
    tok = AutoTokenizer.from_pretrained(tokenizer_path)
    eos = tok.eos_token_id
    docs = []
    for t in texts:
        ids = tok(t, add_special_tokens=False)["input_ids"]
        if eos is not None:
            ids = ids + [eos]
        docs.append(np.asarray(ids, np.int32))
    return docs


def load_tokens(path: str, seq_len: int, tokenizer: Optional[str] = None,
                bin_dtype: str = "uint16") -> np.ndarray:
    """A corpus → packed [N, seq_len+1] int32 rows (data.py:49-97).

    - ``.npy``: [N, seq_len+1] rows as they are; other [N, T] rows are
      repacked (they carry their own separators), a flat [M] stream is
      reshaped.
    - ``.bin``: a flat token stream; ``bin_dtype`` names uint16/uint32
      (guessing from content could fuse token pairs).
    - ``.jsonl`` (a ``text`` field a line) and ``.txt`` (a document a
      line; blank lines skipped): tokenized by the HF tokenizer at
      ``tokenizer``, whose eos ends each document, then packed with no
      other separator.
    """
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".npy":
        arr = np.load(p, mmap_mode="r")
        if arr.ndim == 2 and arr.shape[1] == seq_len + 1:
            return np.asarray(arr, np.int32)
        if arr.ndim == 2:
            return pack_documents(list(np.asarray(arr, np.int32)), seq_len, eos_id=None)
        return _reshape_stream(np.asarray(arr, np.int32), seq_len)
    if suffix == ".bin":
        if bin_dtype not in ("uint16", "uint32"):
            raise ValueError(f"bin_dtype must be uint16/uint32, got {bin_dtype!r}")
        raw = np.fromfile(p, dtype=np.dtype(bin_dtype))
        return _reshape_stream(raw.astype(np.int32), seq_len)
    if suffix in (".jsonl", ".txt"):
        if tokenizer is None:
            raise ValueError(f"{suffix} corpus requires a tokenizer path")
        lines = p.read_text().splitlines()
        if suffix == ".jsonl":
            texts = [json.loads(ln)["text"] for ln in lines if ln.strip()]
        else:
            texts = [ln for ln in lines if ln.strip()]
        return pack_documents(_tokenize_texts(texts, tokenizer), seq_len, eos_id=None)
    raise ValueError(f"unsupported corpus format {suffix!r} ({path})")


def _reshape_stream(stream: np.ndarray, seq_len: int) -> np.ndarray:
    """Flat stream → [N, seq_len+1] rows, the ragged tail dropped."""
    row = seq_len + 1
    n = stream.size // row
    if n == 0:
        raise ValueError(f"corpus too small: {stream.size} tokens < one row of {row}")
    return stream[: n * row].reshape(n, row).astype(np.int32)


def pack_documents(docs: list, seq_len: int, eos_id: Optional[int] = 0) -> np.ndarray:
    """Concatenate docs (an ``eos_id`` after each one that lacks it;
    ``None`` inserts nothing) → [N, seq_len+1] int32 rows, the ragged
    tail dropped."""
    joined: list[np.ndarray] = []
    for d in docs:
        d = np.asarray(d, np.int32).reshape(-1)
        joined.append(d)
        if eos_id is not None and (d.size == 0 or d[-1] != eos_id):
            joined.append(np.asarray([eos_id], np.int32))
    stream = np.concatenate(joined) if joined else np.zeros((0,), np.int32)
    return _reshape_stream(stream, seq_len)


def batches(
    rows: np.ndarray,  # [N, seq_len+1]
    batch_size: int,
    seed: int = 0,
    epochs: Optional[int] = None,  # None = loop forever
) -> Iterator[dict]:
    """Shuffled epochs of host batches {tokens, targets, mask} (numpy
    int32): targets are the rows shifted by one, the mask all ones
    (packing leaves no padding), the partial tail batch dropped."""
    n = rows.shape[0]
    if n < batch_size:
        raise ValueError(f"corpus has {n} rows < batch size {batch_size}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            chunk = rows[order[i : i + batch_size]]
            tokens = chunk[:, :-1].astype(np.int32)
            yield {
                "tokens": tokens,
                "targets": chunk[:, 1:].astype(np.int32),
                "mask": np.ones_like(tokens),
            }
        epoch += 1


def prefetch_to_device(it: Iterator[dict], device, size: int = 2) -> Iterator[dict]:
    """Host batches → device batches of int64 tensors, ``size - 1``
    batches ahead: on CUDA each leaf is copied from pinned memory with
    ``non_blocking``, so the copy of batch k+1 overlaps step k."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v)).long()
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    buf = collections.deque()
    for b in it:
        buf.append(put(b))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
