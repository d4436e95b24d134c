"""The port's training checkpoints (``train/checkpoint.py``) and the fine-tune
driver's checkpoint, resume and SIGTERM paths, on the CPU.

The format is the port's own (safetensors and a JSON manifest of the
tree; JAX writes orbax), so the tests hold its behaviour to JAX's
(tests/compute/test_checkpoint.py): a round trip restores every leaf byte
for byte (bf16, f32, the int8 codes and the int counts), a mismatched tree
raises, a missing or empty directory is a no-op, the newest 3 steps are
kept, a killed write leaves the last complete step to restore, and a
run interrupted by SIGTERM saves its step and exits 0, then resumes to the
end with weights bitwise those of an uninterrupted run.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dstack_tpu_torch.models import llama
from dstack_tpu_torch.train import checkpoint as ck
from dstack_tpu_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
CONFIG = llama.LLAMA_TINY_64


def _state(seed=0, opt_bits=8, dtype=torch.bfloat16) -> dict:
    """A train state with every leaf kind: bf16 (or f32) parameters, int8
    codes, f32 scales and small moments, and int counts; moments drawn
    nonzero so a restore into zeros would show."""
    gen = torch.Generator().manual_seed(seed)
    params = tstep.tree_map(lambda t: t.to(dtype),
                            llama.init_params(CONFIG, gen, device="cpu"))
    params["layers"]["big"] = torch.randn(2, 64, 256, generator=gen).to(dtype)  # keeps int8 moments
    opt = tstep.default_optimizer(opt_bits=opt_bits)
    state = tstep.init_train_state(CONFIG, opt, params=params)

    def draw(t, low):
        if t.dtype == torch.int8:
            return torch.randint(low, 128, t.shape, generator=gen, dtype=torch.int8)
        return torch.rand(t.shape, generator=gen, dtype=torch.float32) if t.dtype == torch.float32 else t

    for key in ("mu", "mu_scale", "nu", "nu_scale"):  # the second moment's codes are non-negative
        state["opt_state"][key] = tstep.tree_map(lambda t: draw(t, 0 if key == "nu" else -127),
                                                 state["opt_state"][key])
    state["opt_state"]["count"] = 7 + seed
    state["step"] = 7 + seed
    return state


def _leaves(state) -> dict:
    return ck._flatten(state)


def _equal_bytes(a, b) -> bool:
    if isinstance(a, int) or isinstance(b, int):
        return type(a) is type(b) and a == b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(torch.uint8) if a.dim() else a,
                                                                     b.view(torch.uint8) if b.dim() else b)


class TestRoundTrip:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_every_leaf_comes_back_byte_for_byte(self, tmp_path, dtype):
        state = _state(dtype=dtype)
        ck.save_checkpoint(str(tmp_path / "ck"), 7, state)
        assert ck.latest_step(str(tmp_path / "ck")) == 7
        fresh = _state(seed=1, dtype=dtype)  # other values, the same layout
        restored, step = ck.restore_checkpoint(str(tmp_path / "ck"), fresh)
        assert step == 7
        want, got = _leaves(state), _leaves(restored)
        assert set(got) == set(want)
        kinds = {type(v).__name__ if isinstance(v, int) else str(v.dtype) for v in got.values()}
        assert {"int", "torch.int8", "torch.float32", str(dtype)} <= kinds
        for path in want:
            assert _equal_bytes(got[path], want[path]), path
        assert restored["opt_state"]["count"] == 7 and isinstance(restored["step"], int)

    def test_the_int64_count_round_trips_beyond_32_bits(self, tmp_path):
        state = {"step": 2**40 + 3, "w": torch.ones(3)}
        ck.save_checkpoint(str(tmp_path), 1, state)
        assert ck.restore_checkpoint(str(tmp_path), {"step": 0, "w": torch.zeros(3)})[0]["step"] == 2**40 + 3

    def test_a_restored_state_trains_on_as_the_original(self, tmp_path):
        """One more opt8 step from the restored state equals one from the
        original, bitwise."""
        torch.set_num_threads(1)
        state = _state(dtype=torch.float32)
        del state["params"]["layers"]["big"], state["opt_state"]["mu"]["layers"]["big"]
        for key in ("mu_scale", "nu", "nu_scale"):
            del state["opt_state"][key]["layers"]["big"]
        ck.save_checkpoint(str(tmp_path), 7, state)
        restored, _ = ck.restore_checkpoint(str(tmp_path), _state(seed=1, dtype=torch.float32) | {
            "params": tstep.tree_map(torch.zeros_like, state["params"]),
            "opt_state": tstep.tree_map(lambda t: t if isinstance(t, int) else torch.zeros_like(t),
                                        state["opt_state"])})
        opt = tstep.default_optimizer(lr=1e-2, warmup=1, decay_steps=100, opt_bits=8)
        step = tstep.make_train_step(CONFIG, opt)
        tok = torch.randint(0, CONFIG.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
        batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1), "mask": torch.ones_like(tok)}
        a, ma = step(state, batch)
        b, mb = step(restored, batch)
        assert float(ma["loss"]) == float(mb["loss"])
        for x, y in zip(tstep.tree_leaves(a["params"]), tstep.tree_leaves(b["params"])):
            assert torch.equal(x, y)


class TestMismatch:
    @pytest.mark.parametrize("change", ["missing", "extra", "shape", "dtype", "int_for_tensor"])
    def test_a_mismatched_tree_raises(self, tmp_path, change):
        state = {"step": 3, "params": {"w": torch.ones(4, 8), "b": torch.zeros(8)}}
        ck.save_checkpoint(str(tmp_path), 3, state)
        other = {"step": 0, "params": {"w": torch.zeros(4, 8), "b": torch.zeros(8)}}
        if change == "missing":
            del other["params"]["b"]
        elif change == "extra":
            other["params"]["c"] = torch.zeros(2)
        elif change == "shape":
            other["params"]["w"] = torch.zeros(8, 4)
        elif change == "dtype":
            other["params"]["w"] = torch.zeros(4, 8, dtype=torch.bfloat16)
        else:
            other["params"]["b"] = 0
        with pytest.raises(ValueError):
            ck.restore_checkpoint(str(tmp_path), other)

    def test_a_leaf_that_is_neither_tensor_nor_int_is_refused(self, tmp_path):
        with pytest.raises(TypeError):
            ck.save_checkpoint(str(tmp_path), 1, {"lr": 0.5})


class TestDirectory:
    @pytest.mark.parametrize("exists", [True, False])
    def test_nothing_to_restore_is_a_no_op(self, tmp_path, exists):
        d = tmp_path / "ck"
        if exists:
            d.mkdir()
        state = {"step": 0, "w": torch.ones(2)}
        restored, step = ck.restore_checkpoint(str(d), state)
        assert step is None and restored is state
        assert ck.latest_step(str(d)) is None

    def test_only_the_three_newest_are_kept(self, tmp_path):
        c = ck.Checkpointer(str(tmp_path))
        for s in (2, 4, 6, 8, 10):
            c.save(s, {"step": s, "w": torch.full((3,), float(s))})
        c.close()
        assert sorted(int(p.name) for p in tmp_path.iterdir()) == [6, 8, 10]
        restored, step = ck.restore_checkpoint(str(tmp_path), {"step": 0, "w": torch.zeros(3)})
        assert step == 10 and restored["step"] == 10 and restored["w"].tolist() == [10.0] * 3

    def test_a_killed_write_leaves_the_last_complete_step(self, tmp_path):
        ck.save_checkpoint(str(tmp_path), 4, {"step": 4, "w": torch.ones(3)})
        # what a write killed at step 6 leaves: its temporary directory, or
        # a half-made step directory without its manifest
        tmp = tmp_path / ".tmp-6-123-456"
        tmp.mkdir()
        (tmp / ck.STATE_FILE).write_bytes(b"\x00" * 10)
        (tmp_path / "8").mkdir()
        (tmp_path / "8" / ck.STATE_FILE).write_bytes(b"\x00" * 10)
        assert ck.latest_step(str(tmp_path)) == 4
        restored, step = ck.restore_checkpoint(str(tmp_path), {"step": 0, "w": torch.zeros(3)})
        assert step == 4 and restored["w"].tolist() == [1.0, 1.0, 1.0]

    def test_save_returns_before_the_write_and_close_drains(self, tmp_path, monkeypatch):
        started, release = [], []
        real = ck._write

        def slow(*args):
            started.append(True)
            while not release:
                time.sleep(0.01)
            real(*args)

        monkeypatch.setattr(ck, "_write", slow)
        c = ck.Checkpointer(str(tmp_path))
        w = torch.ones(3)
        c.save(1, {"w": w})
        w.add_(1.0)  # the host copy was taken when save returned
        assert ck.latest_step(str(tmp_path)) is None
        release.append(True)
        c.close()
        assert ck.latest_step(str(tmp_path)) == 1
        assert ck.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})[0]["w"].tolist() == [1.0] * 3

    def test_manifest_names_every_leaf_and_its_kind(self, tmp_path):
        ck.save_checkpoint(str(tmp_path), 5, {"step": 5, "opt": {"count": 5, "mu": torch.zeros(2, dtype=torch.int8)}})
        manifest = json.loads((tmp_path / "5" / ck.MANIFEST).read_text())
        assert manifest == {"step": 5, "leaves": {"opt/count": "int", "opt/mu": "tensor", "step": "int"}}


# ---------------------------------------------------------------------------
# the fine-tune driver in a subprocess
# ---------------------------------------------------------------------------


COMMON = ["--device", "cpu", "--model", "llama-tiny-64", "--seq-len", "32", "--batch", "2", "--lr", "1e-3",
          "--log-every", "1", "--full", "--opt-bits", "8"]


def _driver(argv, **kw):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "dstack_tpu_torch.train.finetune", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env, **kw)


def _run(argv) -> str:
    proc = _driver(argv)
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-2000:]
    return out


class TestInterruption:
    def test_sigterm_checkpoints_exits_zero_and_resumes_bitwise(self, tmp_path):
        """The spot-preemption contract (JAX's test_checkpoint.py:81-128):
        SIGTERM during the run saves the step reached and exits 0; the
        resumed run ends with the weights of an uninterrupted one, bit for
        bit."""
        steps = 12
        ref = _run([*COMMON, "--steps", str(steps), "--out", str(tmp_path / "ref")])
        assert "weights saved" in ref
        ckpt = tmp_path / "ck"
        proc = _driver([*COMMON, "--steps", str(steps), "--out", str(tmp_path / "run"), "--ckpt-dir", str(ckpt),
                        "--ckpt-every", "1000"])
        try:
            lines = []
            deadline = time.time() + 240
            while time.time() < deadline:
                line = proc.stdout.readline()
                lines.append(line)
                if line.startswith("step 3/") or not line:
                    break
            assert lines[-1].startswith("step 3/"), "".join(lines)[-2000:]
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
        out = "".join(lines) + rest
        assert proc.returncode == 0, out[-2000:]
        assert "interrupted: checkpoint saved at step" in out
        saved = ck.latest_step(str(ckpt))
        assert saved is not None and 3 <= saved < steps
        assert not (tmp_path / "run" / "model_weights.npz").exists()
        resumed = _run([*COMMON, "--steps", str(steps), "--out", str(tmp_path / "run"), "--ckpt-dir", str(ckpt),
                        "--ckpt-every", "1000", "--resume"])
        assert f"resumed from checkpoint step {saved}" in resumed
        assert f"step {saved + 1}/{steps}" in resumed and f"step {saved}/{steps}" not in resumed
        with np.load(tmp_path / "ref" / "model_weights.npz") as a, \
                np.load(tmp_path / "run" / "model_weights.npz") as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), k

    def test_resume_with_data_restarts_the_stream(self, tmp_path):
        """JAX's quirk, kept: with ``--data`` a resumed run reads its corpus
        from the first batch again (``next_batch`` ignores the step), so
        its step 3 trains on the batch an uninterrupted run's step 1 saw."""
        rows = np.random.default_rng(0).integers(0, 256, size=(8, 33)).astype(np.int32)
        np.save(tmp_path / "c.npy", rows)
        data = ["--data", str(tmp_path / "c.npy"), "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
        _run([*COMMON, *data, "--steps", "2", "--out", str(tmp_path / "a")])
        out = _run([*COMMON, *data, "--steps", "3", "--out", str(tmp_path / "b"), "--resume"])
        assert "resumed from checkpoint step 2" in out and "step 3/3" in out
