"""The port's sparse MoE MLP against the JAX package's on the CPU in f32:
the same inputs, drawn with numpy, through ``dstack_tpu.models.moe`` and
``dstack_tpu_torch.models.moe``. The router's choices, capacity slots and
drops must match JAX's one-hot dispatch exactly (the gates within 1e-6),
and the MLP output within 2e-5, in cases that drop tokens: a router bias
that crowds one expert, and rows right-padded with identical pad tokens
that route alike and compete for capacity, as a padded prefill chunk
does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import moe as jmoe
from dstack_tpu_torch.models import moe as tmoe

TOL = 2e-5
H, F, E = 64, 96, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs beside other pytest workers, and
    torch's default of one thread a core only spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(rng, bias: bool, crowd: float = 0.0) -> dict:
    """Expert weights (and gpt-oss biases); ``crowd`` adds to expert 0's
    router bias so it overflows its capacity."""
    layer = {
        "w_router": rng.normal(0, 0.3, (H, E)),
        "w_gate": rng.normal(0, 0.1, (E, H, F)),
        "w_up": rng.normal(0, 0.1, (E, H, F)),
        "w_down": rng.normal(0, 0.1, (E, F, H)),
    }
    if bias:
        b_router = rng.normal(0, 0.5, (E,))
        b_router[0] += crowd
        layer.update(
            b_router=b_router, b_gate=rng.normal(0, 0.1, (E, F)),
            b_up_e=rng.normal(0, 0.1, (E, F)), b_down_e=rng.normal(0, 0.1, (E, H)),
        )
    return {k: v.astype(np.float32) for k, v in layer.items()}


def _x(rng, b: int, t: int, pad_from: int) -> np.ndarray:
    """[B, T, H] hidden states; positions from ``pad_from`` on carry one
    shared pad vector, and the last batch row is pad throughout (a pad
    row of a packed wave)."""
    x = rng.normal(0, 1.0, (b, t, H)).astype(np.float32)
    pad = rng.normal(0, 1.0, (H,)).astype(np.float32)
    x[:, pad_from:] = pad
    x[-1] = pad
    return x


def _dense(expert, slot, combine, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """The port's (expert, slot, combine) as JAX's [B, T, E, C] one-hot
    dispatch and combine."""
    b, t, k = expert.shape
    dispatch = np.zeros((b, t, E, cap), np.float32)
    comb = np.zeros((b, t, E, cap), np.float32)
    for bi, ti, j in np.ndindex(b, t, k):
        if slot[bi, ti, j] < cap:
            dispatch[bi, ti, expert[bi, ti, j], slot[bi, ti, j]] = 1.0
            comb[bi, ti, expert[bi, ti, j], slot[bi, ti, j]] = combine[bi, ti, j]
    return dispatch, comb


@pytest.mark.parametrize("seq_len,n_experts,k,cf", [(1, 32, 4, 1.25), (5, 32, 4, 1.25),
                                                   (64, 4, 2, 1.25), (256, 32, 4, 1.25),
                                                   (100, 8, 2, 2.0)])
def test_expert_capacity_matches_jax(seq_len, n_experts, k, cf):
    assert tmoe.expert_capacity(seq_len, n_experts, k, cf) == jmoe.expert_capacity(
        seq_len, n_experts, k, cf)


@pytest.mark.parametrize("topk_softmax,renorm,crowd", [(True, False, 3.0), (False, False, 0.0),
                                                      (False, True, 2.0)])
def test_router_matches_jax_dispatch(topk_softmax, renorm, crowd):
    rng = np.random.default_rng(0)
    layer = _layer(rng, bias=True, crowd=crowd)
    x = _x(rng, 3, 64, pad_from=48)
    cap = jmoe.expert_capacity(64, E, 2, 1.25)
    jd, jc, _ = jmoe.router(
        jnp.asarray(x), jnp.asarray(layer["w_router"]), E, 2, cap, renorm=renorm,
        pre_bias=jnp.asarray(layer["b_router"]), topk_softmax=topk_softmax,
    )
    expert, slot, combine = tmoe.router(
        torch.from_numpy(x), torch.from_numpy(layer["w_router"]), E, 2, cap, renorm=renorm,
        pre_bias=torch.from_numpy(layer["b_router"]), topk_softmax=topk_softmax,
    )
    assert bool((slot >= cap).any()), "the case must drop choices"
    dispatch, comb = _dense(expert.numpy(), slot.numpy(), combine.numpy(), cap)
    np.testing.assert_array_equal(dispatch, np.asarray(jd))
    np.testing.assert_allclose(comb, np.asarray(jc), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize(
    "act,bias,topk_softmax,b,t",
    [
        ("oai_glu", True, True, 3, 64),  # gpt-oss: a padded chunk group
        ("oai_glu", True, True, 4, 5),  # verify rows: S = 5, no drops possible
        ("oai_glu", True, True, 8, 1),  # decode: one token a row, capacity 1
        ("silu", False, False, 2, 64),  # the default softmax router, SwiGLU
    ],
)
def test_moe_mlp_matches_jax(act, bias, topk_softmax, b, t):
    rng = np.random.default_rng(1)
    layer = _layer(rng, bias=bias, crowd=3.0)
    x = _x(rng, b, t, pad_from=max(1, t - 16))
    kw = dict(topk_softmax=topk_softmax, act=act, act_limit=7.0)
    jo, _ = jmoe.moe_mlp(
        jnp.asarray(x), {n: jnp.asarray(w) for n, w in layer.items()}, E, 2, 1.25, None, None, **kw
    )
    to = tmoe.moe_mlp(torch.from_numpy(x), {n: torch.from_numpy(w) for n, w in layer.items()},
                      E, 2, 1.25, **kw)
    assert to.shape == (b, t, H) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)


def test_pad_tokens_take_capacity_from_real_ones():
    """Routing runs on the [B, T, H] shape it is given: pad tokens after
    the real ones fill capacity, so dropping them before routing would
    change the output of the real tokens that come later in the row's
    choice order. Here a padded row and its unpadded prefix differ."""
    rng = np.random.default_rng(2)
    layer = {n: torch.from_numpy(w) for n, w in _layer(rng, bias=True, crowd=3.0).items()}
    x = torch.from_numpy(_x(rng, 2, 64, pad_from=20))[:1]
    kw = dict(topk_softmax=True, act="oai_glu")
    padded = tmoe.moe_mlp(x, layer, E, 2, 1.25, **kw)[:, :20]
    alone = tmoe.moe_mlp(x[:, :20], layer, E, 2, 1.25, **kw)
    assert not torch.allclose(padded, alone, atol=1e-3)


@pytest.mark.parametrize("topk_softmax", [False, True])
def test_router_with_given_choices(topk_softmax):
    # given its own top-k choices the router reproduces its routing; given
    # another run's choices it keeps them and takes the gates from its own
    # logits, as the teacher-forced comparison on the card replays them
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 12, H)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (H, E)).astype(np.float32))
    own = tmoe.router(x, w, E, 2, 8, topk_softmax=topk_softmax)
    again = tmoe.router(x, w, E, 2, 8, topk_softmax=topk_softmax, expert=own[0])
    for a, b in zip(own, again):
        assert torch.equal(a, b)
    other = torch.roll(own[0], 1, dims=-1)  # the same experts, the other order
    expert, slot, combine = tmoe.router(x, w, E, 2, 8, topk_softmax=topk_softmax, expert=other)
    assert torch.equal(expert, other)
    logits = x @ w
    gates = (logits if topk_softmax else torch.softmax(logits, -1)).gather(-1, other)
    if topk_softmax:
        gates = torch.softmax(gates, -1)
    kept = slot < 8
    np.testing.assert_allclose(combine[kept].numpy(), gates[kept].numpy(), atol=1e-6)
