"""Training checkpoints for the PyTorch port: periodic save, resume,
retention (counterpart of dstack_tpu.train.checkpoint, whose orbax
format needs JAX).

The API and behaviour are JAX's: a :class:`Checkpointer` whose ``save``
blocks only for the device-to-host copy while the write runs on a
background thread, ``close`` to drain it, the newest ``keep`` steps kept,
:func:`latest_step`, and :func:`restore_checkpoint` into the layout of a
fresh state, ``(state, None)`` when there is nothing to restore. The
format is the port's own, so a JAX checkpoint does not resume here nor
the reverse: a step is a directory ``<dir>/<step>/`` holding
``state.safetensors`` (every tensor leaf under its tree path, written by
``models/convert_hf.write_safetensors``; bf16, f32, int8 and the int64
counts byte for byte) and ``manifest.json`` (the tree: each leaf's path
and whether it is a tensor or a Python int). Each step is written under a
temporary name and renamed into place, so a killed write leaves no step
behind and :func:`latest_step` finds the last complete one.

On a mesh of ranks (``layout`` and ``mesh``: ``step.state_layout``) the
file is the same global tree: a save gathers each sharded leaf in turn
(every rank takes part) and rank 0 alone copies it to the host and
writes, so no rank holds the whole tree on its card at once; a restore
reads the file on every rank and keeps each leaf's own shard. A
checkpoint written on any mesh therefore resumes on any other, as orbax
restores onto any mesh.
"""

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

from dstack_tpu_torch.models.convert_hf import read_safetensors, write_safetensors

STATE_FILE = "state.safetensors"
MANIFEST = "manifest.json"
_TMP_PREFIX = ".tmp-"


def _flatten(tree: Any, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts whose leaves are tensors or ints."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            if not isinstance(k, str) or "/" in k:
                raise ValueError(f"checkpoint: tree key {k!r} must be a string without '/'")
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, bool) or not isinstance(tree, (int, torch.Tensor)):
        raise TypeError(f"checkpoint: leaf {prefix[:-1]!r} is {type(tree).__name__}; want a tensor or an int")
    return {prefix[:-1]: tree}


def _to_host(state: Any, layout: Any = None, mesh=None) -> tuple[dict, dict]:
    """The state's leaves copied to the host → (tensors, manifest).
    Ints go out as int64 0-dim tensors. With ``layout`` on a ``mesh`` each
    sharded leaf is gathered first, one at a time, and only rank 0 keeps
    the copies."""
    leaves = _flatten(state).items()  # (and the tree's checks)
    if mesh is not None:
        from dstack_tpu_torch.train.step import gathered_leaves

        leaves = gathered_leaves(state, layout, mesh)
    keep = mesh is None or mesh.rank == 0
    tensors, kinds = {}, {}
    for path, leaf in leaves:
        if not keep:
            continue
        if isinstance(leaf, torch.Tensor):
            tensors[path] = leaf.detach().to("cpu", copy=True).contiguous()
            kinds[path] = "tensor"
        else:
            tensors[path] = torch.tensor(leaf, dtype=torch.int64)
            kinds[path] = "int"
    return tensors, {"leaves": kinds}


def _steps(ckpt_dir: Path) -> list[int]:
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(d.name) for d in ckpt_dir.iterdir()
                  if d.name.isdigit() and (d / MANIFEST).is_file() and (d / STATE_FILE).is_file())


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(ckpt_dir: Path, step: int, tensors: dict, manifest: dict, keep: int) -> None:
    """Write one step under a temporary name, rename it into place, then
    drop all but the newest ``keep`` steps."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"{_TMP_PREFIX}{step}-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    write_safetensors(tensors, tmp / STATE_FILE)
    (tmp / MANIFEST).write_text(json.dumps({"step": step, **manifest}, sort_keys=True))
    for f in (tmp / STATE_FILE, tmp / MANIFEST, tmp):
        _fsync(f)
    final = ckpt_dir / str(step)
    if final.exists():  # a step saved again (a resumed run's first save)
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync(ckpt_dir)
    for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / str(old), ignore_errors=True)


class Checkpointer:
    """One writer for a whole training run: :meth:`save` blocks only for
    the device-to-host copy; the write continues on a background thread
    while the next steps run (a new save first waits for the one in
    flight); :meth:`close` drains it and raises what a write raised."""

    def __init__(self, ckpt_dir: str, keep: int = 3, layout: Any = None, mesh=None):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.layout, self.mesh = layout, mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.dir} failed") from err

    def save(self, step: int, state: Any) -> None:
        self._join()
        tensors, manifest = _to_host(state, self.layout, self.mesh)
        if self.mesh is not None and self.mesh.rank != 0:
            return  # rank 0 writes

        def write():
            try:
                _write(self.dir, step, tensors, manifest, self.keep)
            except BaseException as e:  # re-raised by the next save or close
                self._error = e

        self._thread = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=False)
        self._thread.start()

    def close(self) -> None:
        self._join()


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> None:
    """One synchronous save (tests and tools; a training loop holds a
    :class:`Checkpointer`)."""
    ck = Checkpointer(ckpt_dir, keep)
    ck.save(step, state)
    ck.close()


def _flatten_layout(layout: Any, want: dict) -> dict:
    """{path: (dim, size) or None} of a state layout (``step.state_layout``)."""
    out = {}
    for path in want:
        node = layout
        for k in path.split("/"):
            node = node.get(k) if isinstance(node, dict) else None
        out[path] = node
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir``, or None."""
    steps = _steps(Path(ckpt_dir))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, state: Any, layout: Any = None, mesh=None) -> tuple[Any, Optional[int]]:
    """The latest checkpoint restored into the layout of ``state`` (the
    same tree, shapes and dtypes; each tensor lands on its leaf's device)
    → (state, step); ``(state, None)`` when the directory is missing or
    holds no complete step. Raises on any mismatch of tree, kind, shape or
    dtype. With ``layout`` on a ``mesh`` the state's leaves are shards:
    each takes its chunk of the saved whole leaf."""
    step = latest_step(ckpt_dir)
    if step is None:
        return state, None
    d = Path(ckpt_dir) / str(step)
    kinds = json.loads((d / MANIFEST).read_text())["leaves"]
    saved = read_safetensors(d / STATE_FILE)
    want = _flatten(state)
    if set(kinds) != set(want) or set(saved) != set(want):
        missing, extra = sorted(set(want) - set(kinds)), sorted(set(kinds) - set(want))
        raise ValueError(f"checkpoint {d}: tree differs from the state's (missing {missing}, extra {extra})")
    wheres = _flatten_layout(layout, want) if mesh is not None else {}
    leaves = {}
    for path, leaf in want.items():
        got = saved[path]
        if wheres.get(path) is not None:
            from dstack_tpu_torch.parallel.sharding import shard

            got = shard(got, wheres[path][0], mesh)
        if isinstance(leaf, torch.Tensor):
            if kinds[path] != "tensor" or got.dtype != leaf.dtype or tuple(got.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {d}: {path} is {kinds[path]} {got.dtype} {tuple(got.shape)}; "
                                 f"the state has {leaf.dtype} {tuple(leaf.shape)}")
            leaves[path] = got.to(leaf.device)
        else:
            if kinds[path] != "int" or got.dtype != torch.int64 or got.dim():
                raise ValueError(f"checkpoint {d}: {path} is {kinds[path]} {got.dtype}; the state has an int")
            leaves[path] = int(got)

    def fill(node, prefix=""):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in node.items()}
        return leaves[prefix[:-1]]

    return fill(state), step
