"""The server's ``logit_bias`` handling, held to the JAX server's and the
JAX engine's entry-by-entry loops on the same payloads:

- ``openai_server._bad_sampling_params``: the same verdict and message
  (the first entry whose key or value is not numeric is named);
- ``openai_server._gen_params``: the same {id: bias} dict, clamped to
  [-100, 100], a NaN clamped to 100, a later key of one id winning;
- ``engine.bias_row`` on the int-keyed dicts the server hands it: the JAX
  engine's row (ids outside the vocabulary, past int64 too, skipped).
"""

import math

import numpy as np
import pytest

from dstack_tpu.serve import openai_server as jserver
from dstack_tpu_torch.serve import openai_server as tserver
from dstack_tpu_torch.serve.engine import bias_row
from dstack_tpu_torch.serve.tokenizer import ByteTokenizer

VOCAB = 300


def _random_bias(seed: int) -> dict:
    """JSON-shaped: str keys (some with a sign, leading zeros or spaces,
    so that two keys can name one id), values of every JSON number kind
    and of the out-of-range, infinite and NaN sorts json.loads yields."""
    rng = np.random.default_rng(seed)
    bias = {}
    for _ in range(400):
        t = int(rng.integers(-20, VOCAB + 20))
        key = rng.choice([str(t), f"0{t}" if t >= 0 else str(t), f" {t}", f"+{t}" if t >= 0 else str(t)])
        v = rng.choice(["float", "int", "big", "inf", "nan", "bool"], p=[0.5, 0.2, 0.15, 0.05, 0.05, 0.05])
        bias[str(key)] = {
            "float": lambda: float(rng.uniform(-150, 150)),
            "int": lambda: int(rng.integers(-150, 150)),
            "big": lambda: float(rng.choice([-1e9, 1e9, -100.0, 100.0, -0.0])),
            "inf": lambda: float(rng.choice([-math.inf, math.inf])),
            "nan": lambda: math.nan,
            "bool": lambda: bool(rng.integers(0, 2)),
        }[v]()
    return bias


def _same(a: dict, b: dict) -> bool:
    """Equal dicts, in order, NaN-safe."""
    return list(a) == list(b) and all(
        x == y or (math.isnan(x) and math.isnan(y)) for x, y in zip(a.values(), b.values()))


@pytest.mark.parametrize("seed", range(4))
def test_gen_params_bias_matches_jax(seed):
    payload = {"logit_bias": _random_bias(seed), "max_tokens": 4}
    tok = ByteTokenizer()
    got = tserver._gen_params(payload, tok).logit_bias
    want = jserver._gen_params(payload, tok).logit_bias
    assert _same(got, want)
    assert all(-100.0 <= v <= 100.0 for v in got.values())


@pytest.mark.parametrize("bad", [
    {"5": 1.0, "x": 2.0, "7": "y"},      # a bad key first
    {"5": 1.0, "7": "y", "x": 2.0},      # a bad value first
    {"5": None},                          # a value float() refuses by type
    {"5": [1.0]},
    {"1.5": 1.0},                         # not an int
    {"5": "1e3", "6": "inf", "7": True},  # numeric strings and a bool pass
    {"5": 1.0, "06": -3},
    {},
])
def test_bad_sampling_params_matches_jax(bad):
    payload = {"logit_bias": bad}
    assert tserver._bad_sampling_params(payload) == jserver._bad_sampling_params(payload)


def test_a_huge_value_raises_as_jax_does():
    payload = {"logit_bias": {"5": 1.0, "6": 10 ** 400}}
    with pytest.raises(OverflowError):
        jserver._bad_sampling_params(payload)
    with pytest.raises(OverflowError):
        tserver._bad_sampling_params(payload)


@pytest.mark.parametrize("seed", range(4))
def test_bias_row_of_int_keys_matches_jax_loop(seed):
    """The server's int-keyed dicts (one id a key) through the bulk path,
    with ids below 0, past the vocabulary and past int64."""
    rng = np.random.default_rng(seed)
    bias = {int(k): float(v) for k, v in
            zip(rng.integers(-20, VOCAB + 20, 500), rng.uniform(-100, 100, 500))}
    if seed % 2:
        bias[2 ** 70] = 5.0
        bias[-(2 ** 70)] = 5.0
    want = np.zeros((VOCAB,), np.float32)
    for tid, bv in bias.items():  # dstack_tpu/serve/engine.py's loop
        t = int(tid)
        if 0 <= t < VOCAB:
            want[t] = float(bv)
    assert np.array_equal(bias_row(bias, VOCAB).numpy(), want)


def test_the_soak_bias_round_trip():
    """The soak's ASCII bias at llama-3.2-1b's vocabulary: every id past
    127 at -100, the others 0."""
    vocab = 128_256
    payload = {"logit_bias": {str(i): -100 for i in range(128, vocab)}}
    gen = tserver._gen_params(payload, ByteTokenizer())
    row = bias_row(gen.logit_bias, vocab).numpy()
    assert (row[:128] == 0).all() and (row[128:] == -100).all()
    assert gen.logit_bias == jserver._gen_params(payload, ByteTokenizer()).logit_bias
