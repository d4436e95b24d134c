"""8-bit Adam in the port (``train/opt8.py``, A8 in ``ops/adam8.py``)
against the JAX package's ``train/opt8.py`` on the CPU, and A8 against its
plain version on the card.

The same f32 arrays, drawn with numpy, go through both packages. The
codes are a rounding of a logarithm, so a value within an ulp of a
half-step boundary may round to the neighbouring code in one package and
not the other: codes are held within one step everywhere, with the share
that differs at most ``CODE_SHARE`` (none of the encode tests' codes
differed when this was written); the scales within 1e-6 relative; decoded
values by JAX's own rule (99 % of the values within the grid's range
within 6 % relative). The optimizer is
held against optax's chain on identical f32 gradients, one step at a time
from the same state (the port's state is JAX's, carried across by
:func:`_state_from_jax`): parameters within 1e-6, as
tests/test_torch_train.py holds the bf16-moment AdamW. JAX's own
trajectory test (tests/compute/test_llama.py:217-246) runs on the port:
int8 and 32-bit losses within rtol 0.12 over 20 steps.

The ``cuda``-marked tests hold A8 against ``adam8_update_plain`` on the
card by chip_smoke.py's rules (parameters element-wise within 2e-2 and
every 32-row tile within 1e-2 relative RMS; codes within one step in at
most 1e-3 of them; scales within 1e-6 relative) at bf16 and f32
parameters, with and without the clip, and a rerun bitwise the first;
they skip where there is no card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dstack_tpu.models import llama as jllama
from dstack_tpu.parallel.mesh import MeshConfig, make_mesh
from dstack_tpu.train import lora as jlora
from dstack_tpu.train import opt8 as jopt8
from dstack_tpu.train import step as jstep
from dstack_tpu_torch.models import llama as tllama
from dstack_tpu_torch.ops import adam8
from dstack_tpu_torch.train import lora as tlora
from dstack_tpu_torch.train import opt8
from dstack_tpu_torch.train import step as tstep

CODE_SHARE = 1e-3
SCALE_RTOL = 1e-6
OPT_TOL = 1e-6
# a config whose projections keep int8 moments (last dims of 256 and 512),
# as JAX's opt8 tests size it
SIZES = dict(hidden_size=256, intermediate_size=512, n_heads=4, n_kv_heads=2, head_dim=64)
CJ = dataclasses.replace(jllama.LLAMA_TINY, **SIZES)
CT = dataclasses.replace(tllama.LLAMA_TINY, **SIZES)
# adapters wide enough that wq's B factor [L, 32, 256] keeps int8 moments
LORA_RANK = 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _state_from_jax(jst) -> dict:
    """JAX's ``default_optimizer(opt_bits=8)`` state (``chain(clip,
    adamw8)``: its ``ScaleByAdam8State`` is ``jst[1][0]``) as the port's
    ``AdamW8`` state."""
    s = jst[1][0]
    return {"count": int(s.count), "mu": _torch_tree(_np_tree(s.mu)), "mu_scale": _torch_tree(_np_tree(s.mu_scale)),
            "nu": _torch_tree(_np_tree(s.nu)), "nu_scale": _torch_tree(_np_tree(s.nu_scale))}


def _codes_close(got: torch.Tensor, want) -> float:
    """Codes within one step; → the share that differs."""
    step = (got.int() - torch.from_numpy(np.array(want)).int()).abs()
    assert int(step.max()) <= 1
    return float(step.count_nonzero()) / step.numel()


def _moments(rng, shape, scale) -> np.ndarray:
    """Six decades of magnitude, mixed signs (the case linear int8 fails)."""
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 0, shape) * scale).astype(np.float32)


class TestCodes:
    @pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-8])
    def test_encode_matches_jax(self, scale):
        x = _moments(np.random.default_rng(0), (64, 512), scale)
        x[3, :256] = 0.0  # an all-zero block: the 1e-30 floor
        jq, js = jopt8.q8_encode(jnp.asarray(x))
        tq, ts = opt8.q8_encode(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and tuple(ts.shape) == (64, 2)
        assert _codes_close(tq, jq) <= CODE_SHARE
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL, atol=0)

    def test_decode_matches_jax_and_its_error_rule(self):
        x = _moments(np.random.default_rng(1), (64, 512), 1.0)
        q, s = jopt8.q8_encode(jnp.asarray(x))
        q, s = np.asarray(q), np.asarray(s)
        y = opt8.q8_decode(torch.from_numpy(q), torch.from_numpy(s)).numpy()
        np.testing.assert_allclose(y, np.asarray(jopt8.q8_decode(jnp.asarray(q), jnp.asarray(s))), rtol=1e-6, atol=0)
        # JAX's own rule on the port's round trip (test_llama.py:192-212)
        tq, ts = opt8.q8_encode(torch.from_numpy(x))
        rt = opt8.q8_decode(tq, ts).numpy()
        rel = np.abs(rt - x) / np.maximum(np.abs(x), 1e-30)
        within = np.abs(x) >= ts.numpy()[..., None].repeat(256, -1).reshape(64, 512) * 2e-6
        assert np.quantile(rel[within], 0.99) < 0.06

    def test_zeros_stay_exactly_zero(self):
        q, s = opt8.q8_encode(torch.zeros(2, 256))
        assert not q.any() and bool((s == 1e-30).all())
        assert not opt8.q8_decode(q, s).any()

    @pytest.mark.parametrize("shape", [(256,), (16384,), (64, 256), (63, 256), (128, 128), (2, 8, 1024),
                                       (4096,), (32, 4096, 14336)])
    def test_is_quantized_matches_jax(self, shape):
        assert opt8._is_quantized(shape) == jopt8._is_quantized(shape)


def _opts(lr=1e-2):
    return (jstep.default_optimizer(lr=lr, warmup=1, decay_steps=100, opt_bits=8),
            tstep.default_optimizer(lr=lr, warmup=1, decay_steps=100, opt_bits=8))


def _trees(which: str):
    jp = jllama.init_params(CJ, jax.random.key(0))
    if which == "lora":
        jl = _np_tree(jlora.init_lora_params(CJ, jlora.LoRAConfig(rank=LORA_RANK), jax.random.key(1)))
        return jl, tlora.lora_from_jax(jl, CT, tlora.LoRAConfig(rank=LORA_RANK), device="cpu")
    return _np_tree(jp), tllama.params_from_jax(_np_tree(jp), CT, device="cpu")


class TestAdamW8:
    def test_default_optimizer_gives_adamw8_with_jax_hyperparameters(self):
        opt = tstep.default_optimizer(lr=3e-4, opt_bits=8)
        assert isinstance(opt, opt8.AdamW8)
        assert (opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.max_norm) == (0.9, 0.95, 1e-8, 0.1, 1.0)
        with pytest.raises(ValueError):
            tstep.default_optimizer(opt_bits=4)

    @pytest.mark.parametrize("which", ["params", "lora"])
    def test_init_matches_jax(self, which):
        jp, tp = _trees(which)
        jopt, topt = _opts()
        want, got = _state_from_jax(jopt.init(jp)), topt.init(tp)
        assert got["count"] == want["count"] == 0
        quantized = 0
        for key in ("mu", "mu_scale", "nu", "nu_scale"):
            for a, b in zip(tstep.tree_leaves(got[key]), tstep.tree_leaves(want[key]), strict=True):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a, b)
                quantized += a.dtype == torch.int8
        assert quantized  # the config keeps int8 moments

    @pytest.mark.parametrize("which", ["params", "lora"])
    def test_steps_match_optax_on_identical_gradients(self, which):
        """Five steps at global norms under, far over and near the clip:
        each step from JAX's state, the parameters within 1e-6 and the new
        codes within one step of optax's."""
        jp, tp = _trees(which)
        jopt, topt = _opts()
        jst = jopt.init(jp)
        rng = np.random.default_rng(7)
        n = sum(x.size for x in jax.tree.leaves(jp))
        shares = []
        for step, norm in enumerate((0.05, 40.0, 1.5, 0.5, 3.0)):
            g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * norm / np.sqrt(n)).astype(np.float32), jp)
            tst = _state_from_jax(jst)
            tp = _torch_tree(jp)
            upd, jst = jopt.update(g, jst, jp)
            jp = _np_tree(optax.apply_updates(jp, upd))
            topt.update(_torch_tree(g), tst, tp)
            assert tst["count"] == step + 1
            for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jp), tstep.tree_leaves(tp), strict=True):
                np.testing.assert_allclose(got.numpy(), want, atol=OPT_TOL, rtol=OPT_TOL, err_msg=str(path))
            s = jst[1][0]
            for key in ("mu", "nu"):
                for got, want in zip(tstep.tree_leaves(tst[key]), jax.tree.leaves(getattr(s, key)), strict=True):
                    if got.dtype == torch.int8:
                        shares.append(_codes_close(got, want))
                    else:  # a small leaf's f32 moment: XLA contracts b x + c into FMAs
                        want = np.asarray(want)
                        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
                for got, want in zip(tstep.tree_leaves(tst[f"{key}_scale"]),
                                     jax.tree.leaves(getattr(s, f"{key}_scale")), strict=True):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCALE_RTOL, atol=0)
        assert shares and max(shares) <= CODE_SHARE

    def test_bf16_leaves_round_as_jax_rounds_them(self):
        """bf16 parameters and gradients: the clip in bf16, ``wd * p`` in
        bf16, p + u in f32 cast back; the parameters equal optax's but for
        a share of one-ulp flips at most 1e-4."""
        rng = np.random.default_rng(3)
        p32 = {"w": (rng.standard_normal((32, 512)) * 0.02).astype(np.float32),
               "b": (rng.standard_normal((512,)) * 0.02).astype(np.float32)}
        jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p32)
        jopt, topt = _opts(lr=1e-3)
        jst = jopt.init(jp)
        for norm in (0.3, 30.0):
            g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape) * norm / 130.0, jnp.bfloat16), jp)
            tst = _state_from_jax(jst)
            tp = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16() for k, v in jp.items()}
            upd, jst = jopt.update(g, jst, jp)
            jp = optax.apply_updates(jp, upd)
            topt.update({k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16() for k, v in g.items()}, tst, tp)
            for k in tp:
                got, want = tp[k].float().numpy(), np.asarray(jp[k], np.float32)
                assert tp[k].dtype == torch.bfloat16 and jp[k].dtype == jnp.bfloat16
                flips = got != want
                assert flips.mean() <= 1e-4
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)

    def test_int8_tracks_32_bit_adam_over_20_steps(self):
        """JAX's trajectory test (test_llama.py:217-246) on the port: the
        same model and batch under int8 and bf16/f32 moments."""
        torch.set_num_threads(1)
        rng = np.random.default_rng(3)
        tokens = torch.from_numpy(rng.integers(0, CT.vocab_size, size=(4, 32))).long()
        batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1), "mask": torch.ones_like(tokens)}
        params = tllama.params_from_jax(_np_tree(jllama.init_params(CJ, jax.random.key(0))), CT, device="cpu")

        def train(bits):
            opt = tstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100, opt_bits=bits)
            state = tstep.init_train_state(CT, opt, params=tstep.tree_map(torch.clone, params))
            step = tstep.make_train_step(CT, opt)
            losses = []
            for _ in range(20):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            return losses

        l32, l8 = train(32), train(8)
        assert l8[-1] < l8[0] * 0.7, l8
        np.testing.assert_allclose(l8, l32, rtol=0.12)

    def test_lora_state_quantizes_the_wide_factors(self):
        lora = tlora.init_lora_params(CT, tlora.LoRAConfig(rank=LORA_RANK), torch.Generator().manual_seed(0),
                                      device="cpu")
        state = tlora.init_lora_state(lora, tstep.default_optimizer(opt_bits=8))
        kinds = {k: v.dtype for k, v in state["opt_state"]["mu"]["layers"].items()}
        assert kinds["wq_lora_b"] == torch.int8 and kinds["wq_lora_a"] == torch.float32

    def test_scalars_clip_only_at_or_over_the_norm(self):
        for norm, div, mul in ((0.5, 1.0, 1.0), (1.0, 1.0, 1.0), (4.0, 4.0, 1.0)):
            s = opt8.adam8_scalars(torch.tensor(norm), 1.0, 2, 0.9, 0.95, -1e-3)
            want = [div, mul, 1 - np.float32(0.9) ** 2, 1 - np.float32(0.95) ** 2, -1e-3]
            np.testing.assert_allclose(s.numpy(), np.asarray(want, np.float32), rtol=1e-7)


class TestWrapper:
    def _leaf(self, shape=(8, 512), dtype=torch.float32, seed=0):
        g = torch.Generator().manual_seed(seed)
        p = (torch.randn(shape, generator=g) * 0.02).to(dtype)
        grad = (torch.randn(shape, generator=g) * 1e-3).to(dtype)
        mu_q = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        nu_q = torch.randint(0, 128, shape, generator=g, dtype=torch.int8)
        blocks = (*shape[:-1], shape[-1] // 256)
        mu_s = torch.rand(blocks, generator=g) * 1e-3
        nu_s = torch.rand(blocks, generator=g) * 1e-6
        scalars = opt8.adam8_scalars(torch.tensor(2.0), 1.0, 3, 0.9, 0.95, -2e-4)
        return p, grad, mu_q, mu_s, nu_q, nu_s, scalars

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_takes_the_plain_version_in_place(self, dtype):
        p, g, mu_q, mu_s, nu_q, nu_s, sc = self._leaf(dtype=dtype)
        kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
        want = opt8.adam8_update_plain(p, g, mu_q, mu_s, nu_q, nu_s, sc, **kw)
        before = adam8.LAUNCHES
        adam8.adam8_update(p, g, mu_q, mu_s, nu_q, nu_s, sc, **kw)
        assert adam8.LAUNCHES == before  # the plain version never counts
        for got, w in zip((p, mu_q, mu_s, nu_q, nu_s), want, strict=True):
            assert got.dtype == w.dtype and torch.equal(got, w)

    def test_another_device_raises(self):
        leaf = [t.to("meta") for t in self._leaf()]
        with pytest.raises(ValueError, match="no kernel"):
            adam8.adam8_update(*leaf, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("mutant", ["no_weight_decay", "no_eps", "step_x1.05"])
    def test_the_update_rule_sees_each_fault(self, dtype, mutant):
        """chip_smoke's rule on the update p_new - p_old, on its mid-run
        leaf and step size, with the plain version standing in for the
        kernel: a fault's update (weight decay or eps dropped, the step 5 %
        long) lies beyond the limit, the true one at 0, and a 2e-6 relative
        change of the first bias correction (rounding's size) within it."""
        from chip_smoke import ADAM8_HP, ADAM8_LR, ADAM8_UPDATE_TOL, adam8_leaf, adam8_mutant, adam8_update_rms

        leaf = adam8_leaf((512, 4096), dtype, torch.Generator().manual_seed(3))
        sc = opt8.adam8_scalars(torch.tensor(20.0), 1.0, 3, 0.9, 0.95, -ADAM8_LR)
        want = opt8.adam8_update_plain(*leaf, sc, **ADAM8_HP)[0]
        tol = ADAM8_UPDATE_TOL[dtype]
        assert adam8_update_rms(leaf[0], want, want) == 0.0
        near = sc.clone()
        near[2] *= 1 + 2e-6
        assert adam8_update_rms(leaf[0], opt8.adam8_update_plain(*leaf, near, **ADAM8_HP)[0], want) <= tol
        hp, msc = adam8_mutant(mutant, sc)
        assert adam8_update_rms(leaf[0], opt8.adam8_update_plain(*leaf, msc, **hp)[0], want) > tol

    def test_bytes_moved_is_ten_a_bf16_element(self):
        p = torch.empty(4096, 256, dtype=torch.bfloat16)
        assert adam8.bytes_moved(p) == 4096 * 256 * 10 + 16 * 4096


def test_full_step_with_opt8_matches_jax():
    """Three whole steps of the full fine-tune with int8 moments, the port's
    state carried across from JAX's before each: losses and gradient norms
    within 1e-4 relative (the parameters are not compared: Adam turns a
    1e-7 difference in a gradient near zero into a full step, which
    test_steps_match_optax_on_identical_gradients rules out)."""
    jp = jllama.init_params(CJ, jax.random.key(0))
    jopt, topt = _opts()
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1), devices=jax.devices()[:1])
    jstate, _ = jstep.sharded_init(CJ, jopt, mesh, params=jp)
    jfn = jstep.make_train_step(CJ, jopt, mesh)
    tfn = tstep.make_train_step(CT, topt)
    rng = np.random.default_rng(11)
    for i in range(3):
        tokens = rng.integers(0, CJ.vocab_size, size=(4, 32)).astype(np.int32)
        batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1), "mask": np.ones_like(tokens)}
        tstate = {"params": tllama.params_from_jax(_np_tree(jstate["params"]), CT, device="cpu"),
                  "opt_state": _state_from_jax(jstate["opt_state"]), "step": int(jstate["step"])}
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert tstate["opt_state"]["count"] == int(jstate["opt_state"][1][0].count) == i + 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestAdam8OnTheCard:
    @pytest.mark.parametrize("shape", [(1024, 4096), (4, 256, 1536), (64, 256), (3, 8, 14336), (1, 16384)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("norm", [0.5, 20.0])
    def test_matches_the_plain_version(self, cuda, shape, dtype, norm):
        """On chip_smoke's mid-run leaf: the parameters by both rules, the
        update p_new - p_old by chip_smoke's update rule, the codes and
        scales as chip_smoke holds them, and a rerun bitwise."""
        from chip_smoke import ADAM8_HP, ADAM8_LR, ADAM8_UPDATE_TOL, adam8_leaf, adam8_update_rms, tile_rel_rms

        p, g, mu_q, mu_s, nu_q, nu_s = adam8_leaf(shape, dtype, torch.Generator(device=cuda).manual_seed(len(shape)))
        sc = opt8.adam8_scalars(torch.tensor(norm, device=cuda), 1.0, 3, 0.9, 0.95, -ADAM8_LR)
        kw = ADAM8_HP
        want = opt8.adam8_update_plain(p, g, mu_q, mu_s, nu_q, nu_s, sc, **kw)
        runs = []
        for _ in range(2):
            out = [t.clone() for t in (p, mu_q, mu_s, nu_q, nu_s)]
            before = adam8.LAUNCHES
            adam8.adam8_update(out[0], g, *out[1:], sc, **kw)
            assert adam8.LAUNCHES == before + 1
            runs.append(out)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        got = runs[0]
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2, rtol=2e-2)
        d = shape[-1]
        assert tile_rel_rms(got[0].reshape(1, 1, -1, d), want[0].reshape(1, 1, -1, d)) <= 1e-2
        assert adam8_update_rms(p, got[0], want[0]) <= ADAM8_UPDATE_TOL[dtype]
        differ = 0
        for i in (1, 3):
            step = (got[i].int() - want[i].int()).abs()
            assert int(step.max()) <= 1
            differ += int(step.count_nonzero())
            rel = ((got[i + 1] - want[i + 1]).abs() / want[i + 1].abs()).max().item()
            assert rel <= SCALE_RTOL
        assert differ / (2 * p.numel()) <= CODE_SHARE

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("mutant", ["no_weight_decay", "no_eps", "step_x1.05"])
    def test_the_update_rule_fails_a_faulty_launch(self, cuda, dtype, mutant):
        """The kernel launched on a fault's arguments (weight decay or eps
        dropped, the step 5 % long) fails chip_smoke's update rule against
        the plain version of the true update."""
        from chip_smoke import ADAM8_HP, ADAM8_LR, ADAM8_UPDATE_TOL, adam8_leaf, adam8_mutant, adam8_update_rms

        leaf = adam8_leaf((1024, 4096), dtype, torch.Generator(device=cuda).manual_seed(3))
        sc = opt8.adam8_scalars(torch.tensor(20.0, device=cuda), 1.0, 3, 0.9, 0.95, -ADAM8_LR)
        want = opt8.adam8_update_plain(*leaf, sc, **ADAM8_HP)
        hp, msc = adam8_mutant(mutant, sc)
        out = [t.clone() for t in (leaf[0], *leaf[2:])]
        adam8.adam8_update(out[0], leaf[1], *out[1:], msc, **hp)
        assert adam8_update_rms(leaf[0], out[0], want[0]) > ADAM8_UPDATE_TOL[dtype]

    def test_refuses_what_it_does_not_take(self, cuda):
        p, g, mu_q, mu_s, nu_q, nu_s, sc = (t.to(cuda) for t in TestWrapper()._leaf())
        kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
        with pytest.raises(ValueError):
            adam8.adam8_update(p, g[:, :256], mu_q, mu_s, nu_q, nu_s, sc, **kw)
        with pytest.raises(TypeError):
            adam8.adam8_update(p.half(), g.half(), mu_q, mu_s, nu_q, nu_s, sc, **kw)
        with pytest.raises(ValueError):
            adam8.adam8_update(p.t(), g.t(), mu_q, mu_s, nu_q, nu_s, sc, **kw)
