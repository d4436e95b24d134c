"""The port's DeepSeek MoE deltas against the JAX package's on the CPU in
f32: the router's sigmoid scores, the selection bias (it selects only:
the gates stay unbiased), the group limit with its group score (best
member for softmax, top-2 sum for sigmoid), the routed scale and the
renormalized gates, and ``moe_mlp``'s dense shared expert.

The router's logits are the inputs themselves (an identity router
matrix, so both frameworks' f32 logits are equal bit for bit) and are
spread apart, so a choice never rests on the last bits of two
frameworks' softmax. The choices must then match JAX's exactly and the
gates within 1e-6, over every combination of the deltas (hypothesis);
a group limit that leaves fewer eligible experts than the top-k makes
the router pick among zeroed experts, where the lower index wins in
both packages. ``moe_mlp`` with a shared expert matches JAX's within
1e-5, with capacity drops, at decode's and verify's shapes too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dstack_tpu.models import moe as jmoe
from dstack_tpu_torch.models import moe as tmoe

E, K = 8, 3
H, F, FS = 32, 48, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(expert, slot, combine, cap: int, e: int) -> tuple[np.ndarray, np.ndarray]:
    """The port's (expert, slot, combine) as JAX's [B, T, E, C] one-hot
    dispatch and combine."""
    b, t, k = expert.shape
    dispatch = np.zeros((b, t, e, cap), np.float32)
    comb = np.zeros((b, t, e, cap), np.float32)
    for bi, ti, j in np.ndindex(b, t, k):
        if slot[bi, ti, j] < cap:
            dispatch[bi, ti, expert[bi, ti, j], slot[bi, ti, j]] = 1.0
            comb[bi, ti, expert[bi, ti, j], slot[bi, ti, j]] = combine[bi, ti, j]
    return dispatch, comb


def _spread_logits(rng, b: int, t: int) -> np.ndarray:
    """[B, T, E] logits: a permutation of E values 0.25 apart, jittered by
    at most 0.02, per token."""
    base = (np.arange(E) - E / 2) * 0.25
    out = np.stack([rng.permutation(base) for _ in range(b * t)]).reshape(b, t, E)
    return (out + rng.uniform(0, 0.02, out.shape)).astype(np.float32)


def _route_both(x, bias, cap, **kw):
    """JAX's router and the port's on ``x`` as the logits (identity router
    matrix) → (JAX dispatch, JAX combine, port expert, slot, combine)."""
    eye = np.eye(E, dtype=np.float32)
    jd, jc, _ = jmoe.router(jnp.asarray(x), jnp.asarray(eye), E, K, cap,
                            bias=None if bias is None else jnp.asarray(bias), **kw)
    te = tmoe.router(torch.from_numpy(x), torch.from_numpy(eye), E, K, cap,
                     bias=None if bias is None else torch.from_numpy(bias), **kw)
    return (np.asarray(jd), np.asarray(jc), *(a.numpy() for a in te))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    score=st.sampled_from(["softmax", "sigmoid"]),
    with_bias=st.booleans(),
    groups=st.sampled_from([(), (2, 1), (4, 2), (4, 1)]),
    routed_scale=st.sampled_from([1.0, 1.5, 2.5]),
    renorm=st.booleans(),
)
def test_router_deltas_match_jax(seed, score, with_bias, groups, routed_scale, renorm):
    rng = np.random.default_rng(seed)
    b, t = 2, 6
    x = _spread_logits(rng, b, t)
    # the bias on its own grid, so biased scores stay apart too
    bias = (rng.permutation(np.arange(E)) * 0.07 - 0.2).astype(np.float32) if with_bias else None
    jd, jc, expert, slot, combine = _route_both(
        x, bias, t, score=score, groups=groups, routed_scale=routed_scale, renorm=renorm)
    assert not (slot >= t).any()  # capacity t: every choice kept, so dispatch shows them all
    dispatch, comb = _dense(expert, slot, combine, t, E)
    np.testing.assert_array_equal(dispatch, jd)
    np.testing.assert_allclose(comb, jc, atol=1e-6, rtol=1e-6)
    if groups and groups[1] * E // groups[0] < K:
        # fewer eligible experts than choices: the rest come from zeroed
        # groups, lowest index first in both packages
        assert dispatch.sum() == b * t * K


def test_group_limit_matches_jax():
    rng = np.random.default_rng(3)
    sel = rng.standard_normal((4, 5, E)).astype(np.float32)
    for score in ("softmax", "sigmoid"):
        for groups in ((2, 1), (4, 2), (4, 3)):
            j = jmoe._group_limit(jnp.asarray(sel), groups, score)
            t = tmoe._group_limit(torch.from_numpy(sel), groups, score)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_topk_orders_ties_as_jax():
    """Equal values by index, and -0.0 (a negative score the group limit
    masked) below +0.0, as ``jax.lax.top_k`` orders them."""
    x = np.array([[-0.0, 1.0, 0.0, 1.0, 0.5, 0.0, -0.0, -0.25]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 7)
    tv, ti = tmoe.topk(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_router_with_drops_matches_jax(score):
    """Capacity 8 over 24 tokens a row, one expert crowded by the bias:
    choices drop in the same slots in both packages."""
    rng = np.random.default_rng(4)
    x = _spread_logits(rng, 3, 24)
    bias = np.zeros(E, np.float32)
    bias[2] = 3.0
    jd, jc, expert, slot, combine = _route_both(
        x, bias, 8, score=score, groups=(4, 2), routed_scale=2.5, renorm=True)
    assert (slot >= 8).any(), "the case must drop choices"
    dispatch, comb = _dense(expert, slot, combine, 8, E)
    np.testing.assert_array_equal(dispatch, jd)
    np.testing.assert_allclose(comb, jc, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_router_with_given_choices_keeps_the_deltas(score):
    """Replaying its own choices reproduces the routing; the gates of given
    choices are the unbiased scores, renormalized and scaled."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_spread_logits(rng, 2, 10))
    eye = torch.eye(E)
    bias = torch.from_numpy(rng.normal(0, 0.3, E).astype(np.float32))
    kw = dict(score=score, groups=(4, 2), bias=bias, routed_scale=1.5, renorm=True)
    own = tmoe.router(x, eye, E, K, 10, **kw)
    again = tmoe.router(x, eye, E, K, 10, expert=own[0], **kw)
    for a, b in zip(own, again):
        assert torch.equal(a, b)
    other = torch.roll(own[0], 1, dims=-1)
    _, _, combine = tmoe.router(x, eye, E, K, 10, expert=other, **kw)
    scores = torch.sigmoid(x) if score == "sigmoid" else torch.softmax(x, -1)
    gates = scores.gather(-1, other)
    gates = gates / (gates.sum(-1, keepdim=True) + (1e-20 if score == "sigmoid" else 0.0)) * 1.5
    np.testing.assert_allclose(combine.numpy(), gates.numpy(), atol=1e-6)


def _layer(rng, bias: bool) -> dict:
    layer = {
        "w_router": rng.normal(0, 0.3, (H, E)),
        "w_gate": rng.normal(0, 0.1, (E, H, F)),
        "w_up": rng.normal(0, 0.1, (E, H, F)),
        "w_down": rng.normal(0, 0.1, (E, F, H)),
        "w_shared_gate": rng.normal(0, 0.1, (H, FS)),
        "w_shared_up": rng.normal(0, 0.1, (H, FS)),
        "w_shared_down": rng.normal(0, 0.1, (FS, H)),
    }
    if bias:
        layer["router_bias"] = rng.normal(0, 0.2, (E,))
    return {k: v.astype(np.float32) for k, v in layer.items()}


@pytest.mark.parametrize(
    "deltas",
    [
        dict(),  # DeepSeek-V2: softmax scores, no bias or groups
        dict(score="sigmoid", groups=(4, 2), routed_scale=2.5, renorm=True),  # V3
    ],
    ids=["v2", "v3"],
)
@pytest.mark.parametrize("b,t", [(2, 64), (4, 5), (8, 1)], ids=["chunk", "verify", "decode"])
def test_moe_mlp_with_shared_expert_matches_jax(deltas, b, t):
    rng = np.random.default_rng(6)
    layer = _layer(rng, bias=bool(deltas))
    x = rng.normal(0, 1.0, (b, t, H)).astype(np.float32)
    jo, _ = jmoe.moe_mlp(jnp.asarray(x), {n: jnp.asarray(w) for n, w in layer.items()}, E, K, 1.25,
                         None, None, **deltas)
    to = tmoe.moe_mlp(torch.from_numpy(x), {n: torch.from_numpy(w) for n, w in layer.items()},
                      E, K, 1.25, **deltas)
    assert to.shape == (b, t, H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    # the shared expert is in the sum: without it the output moves
    routed = {n: torch.from_numpy(w) for n, w in layer.items() if not n.startswith("w_shared")}
    alone = tmoe.moe_mlp(torch.from_numpy(x), routed, E, K, 1.25, **deltas)
    assert not torch.allclose(alone, to, atol=1e-3)
