"""The port's ``parallel/`` package against the JAX package's on the CPU:
the mesh shape rules, the sharding rule table and the parameters' logical
axes, and the sequence-parallel attention, ring and Ulysses, forward and
gradients at 2e-5 (f32).

The JAX side runs on the tests' 8 virtual CPU devices (tests/conftest.py)
in shard_map; the port's side runs as explicit SPMD in gloo processes,
one spawn a world size for the whole file (world 2 and world 4), in the
one test that compares them: it writes the inputs, runs every case in the
workers while JAX computes its side, and compares the ranks' shards, put
back in sequence order, with JAX's global arrays. The kernel ring's per-step calls take the flash
kernels' plain versions on the CPU, and JAX's Pallas ring runs in
interpret mode, as its own tests run it.

The workers are this file run as a script (``python
tests/test_torch_parallel.py <world> <rank> <port> <dir>``), so JAX is
imported only inside the tests.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-5
B, H, D = 1, 4, 64
T_LOCAL = 128  # JAX's Pallas ring tiles 128-row blocks
# case → (JAX impl, causal, window, softcap, kv heads); the port's impl is
# JAX's renamed ("pallas" → "kernel", "xla" → "einsum")
RING_CASES = {
    "kernel_causal_gqa": ("pallas", True, 0, 0.0, 2),
    "kernel_noncausal": ("pallas", False, 0, 0.0, 4),
    "kernel_window": ("pallas", True, 150, 0.0, 2),
    "kernel_window_softcap": ("pallas", True, 96, 30.0, 2),
    "einsum_causal_gqa": ("xla", True, 0, 0.0, 2),
    "einsum_noncausal": ("xla", False, 0, 0.0, 4),
    "einsum_noncausal_window": ("xla", False, 90, 0.0, 2),
}
ULYSSES_H = 8
ULYSSES_CASES = {  # case → (kv heads, window, softcap): the repeat cases of _expand_kv
    "ulysses_mha": (8, 0, 0.0),
    "ulysses_gqa2": (2, 0, 0.0),
    "ulysses_mqa_window_softcap": (1, 100, 20.0),
}
WORLDS = (2, 4)


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(world)
    t = T_LOCAL * world
    arrays = {}
    for name, (_, _, _, _, hkv) in RING_CASES.items():
        for part, heads in (("q", H), ("k", hkv), ("v", hkv), ("do", H)):
            arrays[f"{name}/{part}"] = rng.standard_normal((B, heads, t, D)).astype(np.float32)
    for name, (hkv, _, _) in ULYSSES_CASES.items():
        for part, heads in (("q", ULYSSES_H), ("k", hkv), ("v", hkv), ("do", ULYSSES_H)):
            arrays[f"{name}/{part}"] = rng.standard_normal((B, heads, t, D)).astype(np.float32)
    return arrays


# ---------------------------------------------------------------------------
# the workers (this file as a script)
# ---------------------------------------------------------------------------


def _worker(world: int, rank: int, port: int, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from dstack_tpu_torch.parallel import mesh as mesh_mod
    from dstack_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dstack_tpu_torch.parallel.ring_attention import ring_attention
    from dstack_tpu_torch.parallel.ulysses import ulysses_attention

    if world == 4:  # every transfer cut into parts on the stream groups, as the card's large ones are
        mesh_mod.STREAM_MIN_BYTES = 1
    mesh = make_mesh(MeshConfig(fsdp=1, sp=world), device="cpu")
    data = np.load(Path(out_dir) / "in.npz")
    sl = slice(rank * T_LOCAL, (rank + 1) * T_LOCAL)
    out = {}

    def run(name, fn):
        q, k, v, do = (torch.from_numpy(data[f"{name}/{p}"][:, :, sl].copy()) for p in ("q", "k", "v", "do"))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        o = fn(q, k, v)
        o.backward(do)
        for part, x in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{name}/{part}"] = x.detach().numpy()

    for name, (impl, causal, window, cap, _) in RING_CASES.items():
        run(name, lambda q, k, v: ring_attention(q, k, v, mesh=mesh, causal=causal, window=window, softcap=cap,
                                                 impl={"pallas": "kernel", "xla": "einsum"}[impl]))
    for name, (_, window, cap) in ULYSSES_CASES.items():
        run(name, lambda q, k, v: ulysses_attention(q, k, v, mesh=mesh, causal=True, window=window, softcap=cap))
    # the mesh's collectives through the backend's own calls (NCCL's path,
    # here over gloo's CPU collectives) and through the byte transport
    import torch.distributed as dist

    def nccl_rule(fn):  # NCCL refuses a tensor that is not contiguous, where gloo takes it
        def call(*args, **kw):
            if any(isinstance(t, torch.Tensor) and not t.is_contiguous() for t in args):
                raise ValueError("Tensors must be contiguous")
            return fn(*args, **kw)
        return call

    calls = {n: getattr(dist, n) for n in ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
                                           "all_to_all_single")}
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(3, 5, 2, generator=g)
    y = torch.randn(world * 2, 3, generator=g)
    for native in (False, True):
        mesh.native = native
        for name, fn in calls.items():
            setattr(dist, name, nccl_rule(fn) if native else fn)
        # x.transpose: a gradient can come back with the strides of a transposed leaf
        got = [mesh.all_reduce(x, ("sp",)), mesh.all_reduce(x.bfloat16()).float(), mesh.all_reduce(x[0, 0, 0]),
               mesh.all_reduce(x.transpose(0, 2), ("sp",)), mesh.reduce_scatter(x.transpose(0, 1), "sp", 1),
               mesh.reduce_scatter(x, "sp", 1), mesh.all_gather(x, "sp", 1), mesh.all_to_all(y, "sp", 0, 1),
               *mesh.shift([x, y.double()], "sp", 1)]
        for i, t in enumerate(got):
            out[f"collectives/{'native' if native else 'bytes'}/{i}"] = t.numpy()
    mesh.native = False
    for name, fn in calls.items():
        setattr(dist, name, fn)
    # the auto dispatch on the CPU: the einsum ring, as JAX's off the TPU
    out["dispatch_cpu_is_einsum"] = np.asarray(
        __import__("dstack_tpu_torch.parallel.ring_attention", fromlist=["x"]).kernel_ok(
            4, 2, T_LOCAL, D, torch.device("cpu"), 0, True))
    np.savez(Path(out_dir) / f"out_{rank}.npz", **out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Spawn:
    """``world`` worker processes running every case; :meth:`result`
    waits for them and → [each rank's outputs]."""

    def __init__(self, world: int, tmp: Path):
        self.world, self.dir = world, tmp
        np.savez(tmp / "in.npz", **_inputs(world))
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = [subprocess.Popen([sys.executable, __file__, str(world), str(r), str(port), str(tmp)],
                                       cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for r in range(world)]
        self._out = None

    def result(self) -> list:
        if self._out is None:
            logs = [p.communicate(timeout=240)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._out = [dict(np.load(self.dir / f"out_{r}.npz")) for r in range(self.world)]
        return self._out

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def whole(self, key: str) -> np.ndarray:
        """The ranks' shards of ``key`` joined along the sequence."""
        return np.concatenate([o[key] for o in self.result()], axis=2)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_mesh(sp: int):
    from dstack_tpu.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(dp=1, fsdp=1, sp=sp, tp=1))


def _jax_grads(fn, arrays: dict, name: str) -> dict:
    import jax
    import jax.numpy as jnp

    q, k, v, do = (jnp.asarray(arrays[f"{name}/{p}"]) for p in ("q", "k", "v", "do"))

    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o, *vjp(do))

    o, dq, dk, dv = run(q, k, v, do)
    return {"o": np.asarray(o), "dq": np.asarray(dq), "dk": np.asarray(dk), "dv": np.asarray(dv)}


@pytest.mark.parametrize("world", WORLDS)
def test_ring_and_ulysses_match_jax(world, tmp_path):
    """Every ring case (the kernel ring against JAX's Pallas ring in
    interpret mode, the einsum ring against JAX's xla ring) and every
    Ulysses case, o and dq/dk/dv at 2e-5. One spawn of ``world`` ranks
    runs them all, while JAX computes its side; the same spawn runs the
    mesh's collectives through the backend's own calls (the NCCL path's
    code) and through gloo's byte transport, which must agree."""
    from dstack_tpu.parallel.ring_attention import ring_attention
    from dstack_tpu.parallel.ulysses import ulysses_attention

    spawn = _Spawn(world, tmp_path)
    try:
        mesh = _jax_mesh(world)
        arrays = _inputs(world)
        want = {}
        for name, (impl, causal, window, cap, _) in RING_CASES.items():
            kw = dict(block_q=128, block_k=128, interpret=True) if impl == "pallas" else {}
            want[name] = _jax_grads(
                lambda q, k, v, impl=impl, causal=causal, window=window, cap=cap, kw=kw: ring_attention(
                    q, k, v, mesh=mesh, causal=causal, impl=impl, window=window, softcap=cap, **kw),
                arrays, name)
        for name, (_, window, cap) in ULYSSES_CASES.items():
            want[name] = _jax_grads(
                lambda q, k, v, window=window, cap=cap: ulysses_attention(
                    q, k, v, mesh=mesh, causal=True, window=window, softcap=cap),
                arrays, name)
        spawn.result()
    finally:
        spawn.stop()
    bad = []
    for name, parts in want.items():
        for part, ref in parts.items():
            got = spawn.whole(f"{name}/{part}")
            if not np.allclose(got, ref, atol=TOL, rtol=TOL):
                bad.append(f"{name}/{part}: max abs {np.abs(got - ref).max():.3g}")
    assert not bad, bad
    # NCCL's code path (the backend's own collectives, run over gloo here)
    # gives the byte transport's results on every rank
    for r, got in enumerate(spawn.result()):
        for key in sorted(k for k in got if k.startswith("collectives/bytes/")):
            native = got[key.replace("/bytes/", "/native/")]
            assert native.shape == got[key].shape and np.allclose(native, got[key], atol=1e-6, rtol=1e-6), \
                (r, key)
    # off the card the port's rule sends the ring to einsum blocks, as
    # JAX's _pallas_ok does off the TPU without interpret
    assert not bool(spawn.result()[0]["dispatch_cpu_is_einsum"])


# ---------------------------------------------------------------------------
# in-process: rules, shapes, pure helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,hkv,sp", [(8, 8, 2), (8, 2, 4), (8, 1, 4), (8, 4, 8), (12, 4, 8), (6, 3, 2),
                                      (16, 2, 4), (32, 8, 2), (9, 3, 3)])
def test_expand_kv_matches_jax(h, hkv, sp):
    import jax.numpy as jnp
    import torch

    from dstack_tpu.parallel.ulysses import _expand_kv as jexpand
    from dstack_tpu_torch.parallel.ulysses import _expand_kv as texpand

    k = np.arange(2 * hkv * 3 * 4, dtype=np.float32).reshape(2, hkv, 3, 4)
    np.testing.assert_array_equal(texpand(torch.from_numpy(k), h, sp).numpy(), np.asarray(jexpand(jnp.asarray(k), h, sp)))


def test_ulysses_refuses_heads_that_do_not_split():
    import types

    import jax.numpy as jnp
    import torch

    from dstack_tpu.parallel.ulysses import ulysses_attention as jul
    from dstack_tpu_torch.parallel.ulysses import ulysses_attention as tul

    q = np.zeros((1, 6, 8, 64), np.float32)
    with pytest.raises(ValueError) as j:
        jul(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), mesh=_jax_mesh(4))
    with pytest.raises(ValueError) as t:
        x = torch.from_numpy(q)
        tul(x, x, x, mesh=types.SimpleNamespace(size=lambda axis: 4))
    assert str(t.value) == str(j.value)


def test_kernel_ring_refuses_a_noncausal_window_as_jax_does():
    import types

    import jax.numpy as jnp
    import torch

    from dstack_tpu.parallel.ring_attention import ring_attention as jring
    from dstack_tpu_torch.parallel.ring_attention import ring_attention as tring

    q = np.zeros((1, 4, 512, 64), np.float32)
    with pytest.raises(ValueError, match="non-causal sliding window"):
        jring(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), mesh=_jax_mesh(4), causal=False, window=64,
              impl="pallas")
    x = torch.zeros(1, 4, 128, 64)
    with pytest.raises(ValueError, match="non-causal sliding window"):
        tring(x, x, x, mesh=types.SimpleNamespace(size=lambda axis: 4), causal=False, window=64, impl="kernel")


@pytest.mark.parametrize("sp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("t_local", [64, 128, 1024])
def test_live_steps_match_jax(sp, t_local):
    from dstack_tpu.parallel.ring_attention import _ring_live_steps as jlive
    from dstack_tpu_torch.parallel.ring_attention import _ring_live_steps as tlive

    for window in (0, 1, 2, 63, 64, 65, 127, 128, 129, 150, 512, 1024, 4096, 10**6):
        assert tlive(sp, t_local, window) == jlive(sp, t_local, window), window


def test_kernel_rule_is_jaxs_with_cuda_for_the_tpu():
    """``kernel_ok`` on a CUDA device answers as JAX's ``_pallas_ok``
    with ``interpret=True`` (the backend check passed) for every shape."""
    import torch

    from dstack_tpu.parallel.ring_attention import _pallas_ok
    from dstack_tpu_torch.parallel.ring_attention import kernel_ok

    cuda = torch.device("cuda", 0)  # a device object only: nothing runs on it
    for h, hkv, t_local, d, window, causal in [
        (32, 8, 1024, 64, 0, True), (16, 16, 1024, 192, 0, True), (4, 1, 1024, 256, 512, True),
        (8, 4, 1024, 256, 4096, True), (8, 4, 1024, 256, 4096, False), (4, 2, 100, 64, 0, True),
        (4, 2, 128, 32, 0, True), (6, 4, 128, 64, 0, True), (4, 2, 128, 64, 0, False),
    ]:
        assert kernel_ok(h, hkv, t_local, d, cuda, window, causal) == _pallas_ok(
            h, hkv, t_local, d, True, window, causal)
        assert not kernel_ok(h, hkv, t_local, d, torch.device("cpu"), window, causal)


@pytest.mark.parametrize("kw,n", [
    (dict(dp=2, fsdp=2, tp=2), 8), (dict(dp=1, fsdp=-1, tp=2), 8), (dict(), 4), (dict(sp=2), 8),
    (dict(dp=5, fsdp=2, tp=1), 8), (dict(fsdp=4), 1), (dict(sp=2), 1), (dict(pp=2, sp=-1), 4),
    (dict(pp=2, sp=2, fsdp=1), 4), (dict(dp=-1, fsdp=-1), 4), (dict(dp=3, fsdp=-1), 8),
])
def test_mesh_config_resolves_as_jax(kw, n):
    from dstack_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from dstack_tpu_torch.parallel.mesh import MeshConfig as TMeshConfig

    try:
        want = JMeshConfig(**kw).resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TMeshConfig(**kw).resolved(n)
        assert str(got.value) == str(e)
    else:
        assert TMeshConfig(**kw).resolved(n) == want


def test_axes_and_rules_are_jaxs():
    from dstack_tpu.parallel import mesh as jmesh
    from dstack_tpu.parallel import sharding as jsharding
    from dstack_tpu_torch.parallel import mesh as tmesh
    from dstack_tpu_torch.parallel import sharding as tsharding

    assert tmesh.AXES == jmesh.AXES
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    rules_t, rules_j = tsharding.default_rules({"layers": "pp"}), jsharding.default_rules({"layers": "pp"})
    for axes in [("batch", "seq"), ("vocab", "embed_fsdp"), ("layers", "embed_fsdp", "heads"), (None, "mlp")]:
        assert tsharding.default_rules().spec(axes) == tuple(jsharding.default_rules().spec(axes))
        assert rules_t.spec(axes) == tuple(rules_j.spec(axes))


@pytest.mark.parametrize("name", ["llama-3.2-1b", "deepseek-v2-lite", "gemma-3-1b", "gpt-oss-20b", "command-r-35b",
                                  "olmo-2-7b", "mixtral-8x7b", "starcoder2-7b", "llama-4-scout", "glm-4-9b"])
def test_param_specs_are_jaxs(name):
    """The logical axes of every leaf (the dim fsdp shards) are JAX's, and
    the spec tree has the parameter tree's keys."""
    import jax

    from dstack_tpu.models import llama as jllama
    from dstack_tpu.parallel.sharding import default_rules, tree_pspecs
    from dstack_tpu_torch.models import llama as tllama
    from dstack_tpu_torch.parallel import sharding as tsharding

    ct, cj = tllama.CONFIGS[name], jllama.CONFIGS[name]
    assert tllama.param_specs(ct) == jllama.param_specs(cj)
    assert jax.tree.structure(tllama.param_shapes(ct), is_leaf=lambda s: isinstance(s, tuple)) == \
        jax.tree.structure(tllama.param_specs(ct), is_leaf=lambda s: isinstance(s, tuple))
    want = jax.tree.leaves(tree_pspecs(jllama.param_specs(cj), default_rules()),
                           is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
    got = jax.tree.leaves(tsharding.tree_pspecs(tllama.param_specs(ct), tsharding.default_rules()),
                          is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(w) for w in want] == got


def test_placements_name_the_fsdp_dim():
    import types

    from torch.distributed.tensor import Replicate, Shard

    from dstack_tpu_torch.parallel import sharding as tsharding

    shape = dict(dp=2, pp=1, fsdp=2, ep=1, sp=2, tp=1)
    mesh = types.SimpleNamespace(size=lambda a: shape[a])
    rules = tsharding.default_rules()
    spec = rules.spec(("layers", "embed_fsdp", "heads"))
    assert tsharding.placements(spec, mesh) == [Replicate(), Replicate(), Shard(1), Replicate(), Replicate(),
                                                Replicate()]
    assert tsharding.fsdp_dim(rules.spec(("vocab", "embed_fsdp")), mesh) == 1
    assert tsharding.fsdp_dim(rules.spec(("layers", None)), mesh) is None
    assert tsharding.placements(rules.spec(("batch", "seq")), mesh) == [Shard(0), Replicate(), Shard(0),
                                                                        Replicate(), Shard(1), Replicate()]


def test_one_process_keeps_the_card_it_names(monkeypatch):
    """``--device cuda:1`` in a single process trains on cuda:1; a rank
    of a torchrun world may not name a card (each takes LOCAL_RANK's)."""
    import torch

    from dstack_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    env = mesh.init_distributed("cuda:1")
    assert (env.device, env.world, env.backend) == (torch.device("cuda", 1), 1, None)
    assert mesh.init_distributed("cuda").device == torch.device("cuda", 0)
    assert picked == [torch.device("cuda", 1), torch.device("cuda", 0)]
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="names one card"):
        mesh.init_distributed("cuda:1")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
