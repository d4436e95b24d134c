"""The port's training on a mesh of ranks against the JAX package's GSPMD
step on the same mesh shape, on the CPU in f32: the dense step on
``fsdp=2 x sp=2``, ``dp=2 x sp=2`` and ``dp=2 x fsdp=2`` (and with
``--grad-accum 2``), LoRA on ``fsdp=2 x sp=2``, the MoE with capacity drops
on ``sp=2`` and ``dp=2`` (remat on, so the router's collectives meet a
recompute), all at 1e-4 (losses, the aux loss, the global gradient norm,
the parameters after the steps); ``finetune.main`` on 2 ranks with the
ring and with Ulysses against its single-rank run; and checkpoints
written on 2 ranks restored on 1, and the reverse, bitwise.

The JAX steps run on the tests' virtual CPU devices; the port's run in
gloo processes (this file as a script), one spawn a world size for the
file, each in the one test that reads it, while the test computes JAX's
side.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
LR = 1e-3
STEPS = 3
BATCH, SEQ = 8, 64
# world-4 cases: name → (mesh axes, grad_accum, lora)
MESH4 = {
    "fsdp2_sp2": (dict(fsdp=2, sp=2), 1, False),
    "dp2_sp2": (dict(dp=2, fsdp=1, sp=2), 1, False),
    "dp2_fsdp2": (dict(dp=2, fsdp=2), 1, False),
    "dp2_fsdp2_accum2": (dict(dp=2, fsdp=2), 2, False),
    "lora_fsdp2_sp2": (dict(fsdp=2, sp=2), 1, True),
}
# world-2 MoE cases: name → mesh axes
MOE2 = {"moe_sp2": dict(fsdp=1, sp=2), "moe_dp2": dict(dp=2, fsdp=1)}
FINETUNE = ["--device", "cpu", "--model", "llama-tiny", "--steps", "2", "--batch", "2", "--seq-len", "32",
            "--log-every", "1", "--full"]
FINETUNE_SP = {"ring": ["--sp", "2"], "ulysses": ["--sp", "2", "--seq-parallel", "ulysses"]}


def _configs():
    """(jax, port) configs by name: llama-tiny, the MoE with drops and
    remat, and a tiny llama wide enough for int8 moments (checkpoints)."""
    from dstack_tpu.models import llama as jllama
    from dstack_tpu_torch.models import llama as tllama

    out = {"llama": (jllama.LLAMA_TINY, tllama.LLAMA_TINY)}
    moe = dict(capacity_factor=0.5, remat=True)
    out["moe"] = (dataclasses.replace(jllama.MOE_TINY, **moe), dataclasses.replace(tllama.MOE_TINY, **moe))
    wide = dict(hidden_size=512, intermediate_size=512)
    out["wide"] = (dataclasses.replace(jllama.LLAMA_TINY, **wide), dataclasses.replace(tllama.LLAMA_TINY, **wide))
    return out


def _batches(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
        mask = (rng.random((BATCH, SEQ)) > 0.15).astype(np.float32)
        out.append({"tokens": tok, "targets": np.roll(tok, -1, axis=1), "mask": mask})
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# the workers (this file as a script)
# ---------------------------------------------------------------------------


def _torch_batch(b: dict) -> dict:
    import torch

    return {"tokens": torch.from_numpy(b["tokens"]).long(), "targets": torch.from_numpy(b["targets"]).long(),
            "mask": torch.from_numpy(b["mask"])}


def _run_steps(name, cfg, axes, accum, lora, data, out, env) -> None:
    """One case on this rank: the sharded state from JAX's parameters,
    STEPS steps, the global metrics and the gathered parameters."""
    import torch

    from dstack_tpu_torch.models import llama as tllama
    from dstack_tpu_torch.parallel.mesh import Mesh, MeshConfig
    from dstack_tpu_torch.train import lora as tlora
    from dstack_tpu_torch.train import step as tstep

    mesh = Mesh(MeshConfig(**axes), env)
    params = tllama.params_from_jax(_unflat(data, f"{name}/params/"), cfg, device="cpu")
    opt = tstep.default_optimizer(lr=LR, warmup=1, decay_steps=100)
    if lora:
        lconf = tlora.LoRAConfig(rank=4, alpha=8.0)
        base, state, layout = tlora.sharded_lora_init(cfg, lconf, opt, mesh, torch.Generator(), params=params)
        state = tlora.init_lora_state(tlora.lora_from_jax(_unflat(data, f"{name}/lora/"), cfg, lconf,
                                                          device="cpu"), opt)
        fn = tlora.make_lora_train_step(cfg, lconf, opt, grad_accum=accum, mesh=mesh)
    else:
        state, layout = tstep.sharded_init(cfg, opt, mesh, params=params)
        fn = tstep.make_train_step(cfg, opt, grad_accum=accum, mesh=mesh)
    del params
    for i in range(STEPS):
        batch = tstep.local_batch(_torch_batch({k: data[f"{name}/batch{i}/{k}"] for k in
                                                ("tokens", "targets", "mask")}), mesh, accum)
        state, m = (fn(base, state, batch) if lora else fn(state, batch))
        for k, v in m.items():
            out[f"{name}/{k}{i}"] = np.asarray(float(v))
    tree = state["lora"] if lora else state["params"]
    where = None if lora else layout["params"]
    for path, leaf in tstep.gathered_leaves(tree, where, mesh):
        out[f"{name}/final/{path}"] = leaf.detach().numpy()


def _worker(world: int, rank: int, port: int, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from dstack_tpu_torch.parallel import mesh as mesh_mod
    from dstack_tpu_torch.parallel.mesh import Mesh, MeshConfig, init_distributed
    from dstack_tpu_torch.train import checkpoint as tckpt
    from dstack_tpu_torch.train import finetune
    from dstack_tpu_torch.train import step as tstep

    if world == 4:  # every transfer cut into parts on the stream groups, as the card's large ones are
        mesh_mod.STREAM_MIN_BYTES = 1
    env = init_distributed("cpu")
    d = Path(out_dir)
    data = dict(np.load(d / "in.npz"))
    cfgs = {k: v[1] for k, v in _configs().items()}
    out = {}
    if world == 4:
        for name, (axes, accum, lora) in MESH4.items():
            _run_steps(name, cfgs["llama"], axes, accum, lora, data, out, env)
    else:
        for name, axes in MOE2.items():
            _run_steps(name, cfgs["moe"], axes, 1, False, data, out, env)
        for name, extra in FINETUNE_SP.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert finetune.main(FINETUNE + extra + ["--out", str(d / f"ft_{name}")]) == 0
            if rank == 0:
                out[f"finetune/{name}"] = np.asarray(buf.getvalue())
        # checkpoints: 2 ranks write one (fsdp=2, int8 moments), and restore
        # the one a single rank wrote (the test wrote it before the spawn)
        cfg = cfgs["wide"]
        mesh = Mesh(MeshConfig(fsdp=2), env)
        opt = tstep.default_optimizer(lr=LR, warmup=1, decay_steps=100, opt_bits=8)
        state, layout = tstep.sharded_init(cfg, opt, mesh, seed=3)
        fn = tstep.make_train_step(cfg, opt, mesh=mesh)
        for i in range(2):
            state, _ = fn(state, tstep.local_batch(_torch_batch(_batches(cfg.vocab_size, 40)[i]), mesh))
        ck = tckpt.Checkpointer(str(d / "ck2"), layout=layout, mesh=mesh)
        ck.save(2, state)
        ck.close()
        for path, leaf in tstep.gathered_leaves(state, layout, mesh):
            out[f"ck2/{path}"] = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        fresh, _ = tstep.sharded_init(cfg, opt, mesh, seed=99)
        restored, step = tckpt.restore_checkpoint(str(d / "ck1"), fresh, layout, mesh)
        out["ck1_step"] = np.asarray(step)
        for path, leaf in tstep.gathered_leaves(restored, layout, mesh):
            out[f"ck1/{path}"] = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        mesh.barrier()  # rank 0's write is done before the test reads it
    if rank == 0:
        np.savez(d / "out.npz", **out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _spawn(world: int, tmp: Path, data: dict):
    """``world`` workers over ``data``; yields a function that waits for
    them and → rank 0's outputs."""
    np.savez(tmp / "in.npz", **data)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(world), str(r), str(port), str(tmp)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def result() -> dict:
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return dict(np.load(tmp / "out.npz"))

    try:
        yield result
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_inputs(names: dict, cfg_key: str, seed: int) -> tuple[dict, dict]:
    """JAX parameters (and LoRA adapters with B != 0) and batches for each
    case → (the npz entries, the JAX trees by case)."""
    import jax

    from dstack_tpu.models import llama as jllama
    from dstack_tpu.train import lora as jlora

    cj = _configs()[cfg_key][0]
    data, trees = {}, {}
    for i, name in enumerate(names):
        jp = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(seed + i)))
        trees[name] = {"params": jp}
        data.update({f"{name}/params/{k}": v for k, v in _flat(jp).items()})
        if names[name][2] if isinstance(names[name], tuple) else False:
            jl = jax.tree.map(np.asarray, jlora.init_lora_params(cj, jlora.LoRAConfig(rank=4, alpha=8.0),
                                                                 jax.random.key(seed + 50)))
            rng = np.random.default_rng(seed)
            jl = {"layers": {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32) if k.endswith("_b") else v
                             for k, v in jl["layers"].items()}}
            trees[name]["lora"] = jl
            data.update({f"{name}/lora/{k}": v for k, v in _flat(jl).items()})
        for s, b in enumerate(_batches(cj.vocab_size, seed + 10 * i)):
            data.update({f"{name}/batch{s}/{k}": v for k, v in b.items()})
            trees[name].setdefault("batches", []).append(b)
    return data, trees


def _jax_run(cj, axes: dict, accum: int, tree: dict) -> dict:
    """The JAX step on the same mesh shape → metrics by step and the
    final parameters (or adapters)."""
    import jax
    import jax.numpy as jnp

    from dstack_tpu.parallel.mesh import MeshConfig, make_mesh
    from dstack_tpu.train import lora as jlora
    from dstack_tpu.train import step as jstep

    full = dict(dp=1, fsdp=1, sp=1, tp=1)
    full.update(axes)
    mesh = make_mesh(MeshConfig(**full))
    opt = jstep.default_optimizer(lr=LR, warmup=1, decay_steps=100)
    lora = "lora" in tree
    if lora:
        lconf = jlora.LoRAConfig(rank=4, alpha=8.0)
        base, state, _ = jlora.sharded_lora_init(cj, lconf, opt, mesh, params=tree["params"])
        state = {**state, "lora": jax.tree.map(jnp.asarray, tree["lora"])}
        state["opt_state"] = opt.init(state["lora"])
        fn = jlora.make_lora_train_step(cj, lconf, opt, mesh, grad_accum=accum)
    else:
        state, _ = jstep.sharded_init(cj, opt, mesh, params=tree["params"])
        fn = jstep.make_train_step(cj, opt, mesh, grad_accum=accum)
    out = {}
    for i, b in enumerate(tree["batches"]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        state, m = fn(base, state, jb) if lora else fn(state, jb)
        out.update({f"{k}{i}": float(v) for k, v in m.items()})
    out["final"] = _flat(jax.tree.map(np.asarray, state["lora"] if lora else state["params"]))
    return out


def _compare(name: str, got: dict, want: dict) -> list:
    bad = []
    for key, ref in want.items():
        if key == "final":
            for path, leaf in ref.items():
                g = got[f"{name}/final/{path}"]
                if not np.allclose(g, leaf, atol=ATOL, rtol=ATOL):
                    bad.append(f"{name} param {path}: max abs {np.abs(g - leaf).max():.3g}")
        elif not np.isclose(float(got[f"{name}/{key}"]), ref, atol=ATOL, rtol=ATOL):
            bad.append(f"{name} {key}: {float(got[f'{name}/{key}'])} vs JAX {ref}")
    return bad


def test_dense_and_lora_steps_match_jax_on_four_ranks(tmp_path):
    """fsdp=2 x sp=2, dp=2 x sp=2, dp=2 x fsdp=2 (one micro-batch and
    two) and LoRA on fsdp=2 x sp=2: three steps each against JAX's."""
    data, trees = _jax_inputs(MESH4, "llama", seed=0)
    cj = _configs()["llama"][0]
    with _spawn(4, tmp_path, data) as result:
        want = {name: _jax_run(cj, axes, accum, trees[name]) for name, (axes, accum, _) in MESH4.items()}
        got = result()
    bad = [b for name in MESH4 for b in _compare(name, got, want[name])]
    assert not bad, bad
    # the steps moved the parameters by more than the tolerance
    for name in MESH4:
        moved = max(np.abs(want[name]["final"][p] - np.asarray(v)).max() for p, v in
                    _flat(trees[name].get("lora", trees[name]["params"])).items())
        assert moved > 20 * ATOL, (name, moved)


def test_moe_finetune_and_checkpoints_on_two_ranks(tmp_path):
    """The MoE with drops on sp=2 and dp=2 against JAX; ``finetune.main``
    on 2 ranks (ring, Ulysses) against its single-rank run; a checkpoint
    of 2 ranks restored on 1 and one of 1 restored on 2, bitwise."""
    import torch

    from dstack_tpu_torch.train import checkpoint as tckpt
    from dstack_tpu_torch.train import finetune
    from dstack_tpu_torch.train import step as tstep

    data, trees = _jax_inputs({n: (a, 1, False) for n, a in MOE2.items()}, "moe", seed=7)
    # the single rank's checkpoint, before the spawn restores it
    cfg = _configs()["wide"][1]
    opt = tstep.default_optimizer(lr=LR, warmup=1, decay_steps=100, opt_bits=8)
    one = tstep.init_train_state(cfg, opt, params=tstep.llama.init_params(cfg, torch.Generator().manual_seed(5),
                                                                          device="cpu"))
    fn = tstep.make_train_step(cfg, opt)
    for b in _batches(cfg.vocab_size, 41)[:2]:
        one, _ = fn(one, _torch_batch(b))
    tckpt.save_checkpoint(str(tmp_path / "ck1"), 2, one)
    assert any(leaf.dtype == torch.int8 for leaf in tstep.tree_leaves(one["opt_state"]["mu"]))

    cj = _configs()["moe"][0]
    with _spawn(2, tmp_path, data) as result:
        want = {name: _jax_run(cj, axes, 1, trees[name]) for name, axes in MOE2.items()}
        single = {}
        for name in FINETUNE_SP:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert finetune.main(FINETUNE + ["--out", str(tmp_path / f"ft1_{name}")]) == 0
            single[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
        got = result()
    bad = [b for name in MOE2 for b in _compare(name, got, want[name])]
    assert not bad, bad
    assert all(want[n]["aux_loss0"] > 0 for n in MOE2)
    for name in FINETUNE_SP:
        lines = str(got[f"finetune/{name}"]).strip().splitlines()
        assert lines[0].startswith("backend=gloo ranks={0: 'cpu', 1: 'cpu'}"), lines[0]
        assert "mesh={'dp': 1, 'pp': 1, 'fsdp': 1, 'ep': 1, 'sp': 2, 'tp': 1} chips=2" in lines[1]
        summary = json.loads(lines[-1])
        assert summary["ranks"] == 2 and summary["mesh"]["sp"] == 2
        for k in ("first_loss", "last_loss"):
            np.testing.assert_allclose(summary[k], single[name][k], rtol=ATOL, err_msg=f"{name} {k}")
    # 2 ranks → 1: the single rank restores what the 2 ranks held, bitwise
    template = tstep.init_train_state(cfg, opt, params=tstep.llama.init_params(
        cfg, torch.Generator().manual_seed(9), device="cpu"))
    restored, step = tckpt.restore_checkpoint(str(tmp_path / "ck2"), template)
    assert step == 2
    for path, leaf in tckpt._flatten(restored).items():
        want_leaf = got[f"ck2/{path}"]
        np.testing.assert_array_equal(np.asarray(leaf), want_leaf, err_msg=path)
    # 1 → 2 ranks: the ranks' shards put back together are the saved state
    assert int(got["ck1_step"]) == 2
    for path, leaf in tckpt._flatten(one).items():
        np.testing.assert_array_equal(got[f"ck1/{path}"], np.asarray(leaf), err_msg=path)


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------


class _Coords:
    """A mesh's coordinates without a process group (local_batch reads
    only these)."""

    def __init__(self, shape: dict, coords: dict):
        self.shape, self.coords = shape, coords

    def size(self, a):
        return self.shape[a]

    def index(self, a):
        return self.coords[a]

    def batch_index(self):
        s, c = self.shape, self.coords
        return (c["dp"] * s["fsdp"] + c["fsdp"]) * s["ep"] + c["ep"], s["dp"] * s["fsdp"] * s["ep"]


@pytest.mark.parametrize("axes", [dict(dp=2, fsdp=2), dict(fsdp=2, sp=2), dict(dp=2, sp=2), dict(dp=2, fsdp=2, sp=2)])
def test_local_batch_is_jaxs_shard(axes):
    """Each rank's part is the shard JAX's ``batch_sharding`` places on
    the device at the same mesh coordinate."""
    import jax
    import torch

    from dstack_tpu.parallel.mesh import MeshConfig, make_mesh
    from dstack_tpu.train.step import batch_sharding, rules_for_mesh
    from dstack_tpu_torch.parallel.mesh import AXES
    from dstack_tpu_torch.train.step import local_batch

    full = dict(dp=1, fsdp=1, sp=1, tp=1)
    full.update(axes)
    mesh = make_mesh(MeshConfig(**full))
    x = np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
    placed = jax.device_put(x, batch_sharding(mesh, rules_for_mesh(mesh)))
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    for shard in placed.addressable_shards:
        coords = dict(zip(AXES, (int(i[0]) for i in np.nonzero(mesh.devices == shard.device))))
        got = local_batch({"tokens": torch.from_numpy(x)}, _Coords(shape, coords))["tokens"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_int8_blocks_must_not_straddle_shards():
    """fsdp=2 on a leaf whose last dim halves into a part of a block
    raises; a whole number of blocks a shard is fine."""
    from dstack_tpu_torch.models import llama as tllama
    from dstack_tpu_torch.train import step as tstep

    opt = tstep.default_optimizer(opt_bits=8)
    shape = dict(dp=1, pp=1, fsdp=2, ep=1, sp=1, tp=1)
    mesh = _Coords(shape, {a: 0 for a in shape})
    for hidden, ok in ((512, True), (256, False)):
        cfg = dataclasses.replace(tllama.LLAMA_TINY, hidden_size=hidden, intermediate_size=512)
        opt_state = opt.init(tllama.init_params(cfg, __import__("torch").Generator(), device="cpu"))
        if ok:
            layout = tstep.state_layout(cfg, opt_state, mesh)
            assert layout["opt_state"]["mu_scale"]["embed"] == (1, 2)  # embed [512, 512]: 2 blocks a row
        else:
            with pytest.raises(ValueError, match="splitting its 256-element blocks"):
                tstep.state_layout(cfg, opt_state, mesh)


def test_unported_axes_name_their_slice():
    from dstack_tpu_torch.models import llama as tllama
    from dstack_tpu_torch.train import step as tstep

    for axis, item in (("tp", "A6.2"), ("ep", "A6.2"), ("pp", "A6.3")):
        shape = {**dict(dp=1, pp=1, fsdp=1, ep=1, sp=1, tp=1), axis: 2}
        with pytest.raises(NotImplementedError, match=item):
            tstep.make_train_step(tllama.LLAMA_TINY, tstep.default_optimizer(), mesh=_Coords(shape, {}))


def test_sp_refuses_what_jax_refuses():
    """A Llama4 chunk and gpt-oss's sinks under sp raise JAX's errors."""
    import torch

    from dstack_tpu_torch.models import llama as tllama

    shape = dict(dp=1, pp=1, fsdp=1, ep=1, sp=2, tp=1)
    mesh = _Coords(shape, {a: 0 for a in shape})
    q = torch.zeros(1, 2, 8, 32)
    for fields, match in ((dict(attention_chunk_size=4), "chunked attention"),
                          (dict(attn_sinks=True), "attention sinks")):
        c = dataclasses.replace(tllama.LLAMA_TINY, **fields)
        with pytest.raises(NotImplementedError, match=match):
            tllama._attend(q, q, q, {"mesh": mesh, "sinks": torch.zeros(2)}, c, 0, None)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
