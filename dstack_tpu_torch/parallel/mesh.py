"""The mesh of ranks and its collectives (counterpart of
dstack_tpu.parallel.mesh).

JAX runs one program over a named ``jax.sharding.Mesh`` of devices and
lets XLA insert the collectives. The port runs one process a rank, started
by ``torchrun`` (or by a test), each holding its shard of the batch, of
the sequence and, under ``fsdp``, of the parameters and moments; the
collectives are explicit calls on :class:`Mesh`. The axis vocabulary and
the mesh-shape rules are JAX's (:data:`AXES`, :class:`MeshConfig`): ranks
are laid out row-major over ``dp, pp, fsdp, ep, sp, tp``, so a rank's
coordinate on each axis is its index in that order, and the groups of each
axis come from ``torch.distributed.device_mesh.init_device_mesh`` over the
six names.

Start-up (:func:`init_distributed`) is the counterpart of
``jax.distributed.initialize`` (dstack_tpu/train/finetune.py:125-129):
torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``.
A world of one starts no process group. The backend:

- ``nccl`` where every local rank has a card of its own;
- ``gloo`` on the CPU, or where the local ranks outnumber the cards (NCCL
  refuses two ranks on one device). Each rank still computes on its card
  (``cuda:(LOCAL_RANK % device_count)``); only the transport is gloo, and
  every collective of a CUDA tensor is staged through host copies
  (:data:`GLOO_STAGED`).

The choice is printed by the entry point (:meth:`Mesh.describe`), never
made silently. Under NCCL each collective is NCCL's own (``all_reduce``,
``reduce_scatter_tensor`` and ``all_gather_into_tensor``, sums in f32,
``all_to_all_single``, ``batch_isend_irecv``). Under gloo, on the card or
on the CPU (where the tests run the same transport), only bytes travel:
a sum (:meth:`Mesh.all_reduce`, :meth:`Mesh.reduce_scatter`) exchanges
the ranks' parts and adds them on the tensor's own device, in f32 and in
rank order, so every rank gets the same bits and the card, not the host,
does the arithmetic; a large transfer is cut into parts that travel at
once on :data:`STREAMS` groups of the same ranks, and an all-gather is an
all-to-all.
"""

import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")

# what a gloo group moves through pinned host copies for a CUDA tensor: every
# transfer (the sums are built from them), so the transport is one rule
GLOO_STAGED = ("all_gather", "all_to_all", "send/recv")
# gloo moves a connection's bytes on one thread: under gloo a transfer of
# STREAM_MIN_BYTES or more is cut into STREAMS parts, each on a group of its
# own over the same ranks, all in flight at once (one connection moved 0.8
# GB/s of host bytes on the card's machine: tools/torch_gloo_probe.py
# --parts bandwidth)
STREAMS = 4
STREAM_MIN_BYTES = 1 << 20


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` on one axis means "absorb the rest"
    (JAX's ``MeshConfig``, dstack_tpu/parallel/mesh.py:35)."""

    dp: int = 1
    pp: int = 1
    fsdp: int = -1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolved(self, n_devices: int) -> dict[str, int]:
        sizes = {
            "dp": self.dp,
            "pp": self.pp,
            "fsdp": self.fsdp,
            "ep": self.ep,
            "sp": self.sp,
            "tp": self.tp,
        }
        fixed = math.prod(v for v in sizes.values() if v != -1)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        if sizes["pp"] > 1 and sizes["sp"] > 1:
            # checked after the wildcard resolves, as JAX checks it: a -1
            # axis could land on pp or sp
            raise ValueError(
                "pp and sp cannot compose (pipeline's shard_map cannot "
                "nest ring attention's); pick one, or use fsdp for the "
                "memory axis alongside pp"
            )
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {n_devices} devices"
            )
        return sizes


@dataclass(frozen=True)
class Distributed:
    """What :func:`init_distributed` found: this process's rank, the
    world, its local rank, its device and the backend (None: no group)."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: Optional[str]


def choose_backend(device_type: str, local_world: int, n_cards: int) -> str:
    """``nccl`` where every local rank has its own card, else ``gloo``
    (the CPU, or more local ranks than cards)."""
    if device_type == "cuda" and local_world <= n_cards:
        return "nccl"
    return "gloo"


def init_distributed(device: str = "cuda") -> Distributed:
    """Join torchrun's process group (a world of 1 joins none) → the
    rank's :class:`Distributed`. ``device="cuda"`` puts the rank on
    ``cuda:(LOCAL_RANK % device_count)`` and raises without CUDA; a
    single process may name its card (``"cuda:1"``), a rank of a larger
    world may not; ``"cpu"`` asks for the CPU and gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU; pass "
                "device='cpu' (or --device cpu) to run its plain versions on "
                "the CPU"
            )
        index = torch.device(device).index
        if index is not None and world > 1:
            raise ValueError(
                f"device {device!r} names one card, but under torchrun each of the {world} ranks takes "
                f"cuda:(LOCAL_RANK % device_count): pass 'cuda'"
            )
        dev = torch.device("cuda", local_rank % torch.cuda.device_count() if index is None else index)
        torch.cuda.set_device(dev)
    elif dev_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device}")
    if world == 1:
        return Distributed(0, 1, 0, dev, None)
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
        backend = choose_backend(dev_type, local_world, n_cards)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return Distributed(rank, world, local_rank, dev, dist.get_backend())


class Mesh:
    """The ranks' mesh: its shape over :data:`AXES`, this rank's coordinate
    on each axis, a process group an axis, and the collectives the port
    calls. Over a world of one every collective is the identity."""

    def __init__(self, config: MeshConfig, env: Distributed):
        self.shape = config.resolved(env.world)
        self.rank, self.world, self.device, self.backend = env.rank, env.world, env.device, env.backend
        sizes = [self.shape[a] for a in AXES]
        self.ranks = torch.arange(self.world).reshape(sizes)  # global rank at each coordinate
        where = (self.ranks == self.rank).nonzero()[0].tolist()
        self.coords = dict(zip(AXES, where))
        # NCCL's own collectives; under gloo only bytes travel (its p2p
        # refuses CUDA tensors, so a CUDA tensor's bytes are staged)
        self.native = self.backend not in (None, "gloo")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.device_mesh = None
        self.groups: dict = {}
        self.streams: dict = {}  # axis (None: every rank) → its groups, the axis's own first
        if self.world > 1:
            from torch.distributed.device_mesh import init_device_mesh

            # gloo keeps its groups on the host, whatever device the ranks compute on
            kind = "cpu" if self.backend == "gloo" else self.device.type
            self.device_mesh = init_device_mesh(kind, tuple(sizes), mesh_dim_names=AXES)
            self.groups = {a: self.device_mesh.get_group(a) for a in AXES}
            self.streams = {None: [None], **{a: [g] for a, g in self.groups.items()}}
            if self.backend == "gloo":
                self._add_streams()

    def _add_streams(self) -> None:
        """STREAMS - 1 more gloo groups over every rank set a collective
        runs on (the world, and each axis of size > 1), made in the same
        order on every rank, as ``new_group`` asks."""
        for axis in (None, *AXES):
            if axis is None:
                sets = [list(range(self.world))]
            elif self.shape[axis] > 1:
                sets = self.ranks.movedim(AXES.index(axis), -1).reshape(-1, self.shape[axis]).tolist()
            else:
                continue
            for _ in range(STREAMS - 1):
                for ranks in sets:
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self.streams[axis].append(group)

    # -- shape --------------------------------------------------------------

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks along ``axis`` through this rank, in axis order."""
        idx = [self.coords[a] if a != axis else slice(None) for a in AXES]
        return self.ranks[tuple(idx)].tolist()

    def batch_index(self) -> tuple[int, int]:
        """(this rank's index, count) over the batch axes ``dp x fsdp x ep``
        (``DEFAULT_RULES["batch"]``), ``dp`` the major one."""
        n = self.shape["dp"] * self.shape["fsdp"] * self.shape["ep"]
        i = (self.coords["dp"] * self.shape["fsdp"] + self.coords["fsdp"]) * self.shape["ep"] + self.coords["ep"]
        return i, n

    def describe(self) -> str:
        """The backend, the rank-to-device map and the mesh, for the run's
        first line."""
        devs = [None] * self.world
        if self.world > 1:
            dist.all_gather_object(devs, str(self.device))
        else:
            devs = [str(self.device)]
        staged = f" (CUDA tensors staged through host: {', '.join(GLOO_STAGED)})" if self.staged else ""
        mesh = {a: self.shape[a] for a in AXES}
        return (f"backend={self.backend or 'none (one rank)'}{staged} "
                f"ranks={dict(enumerate(devs))} mesh={mesh}")

    # -- transport ------------------------------------------------------------

    def _group(self, axis: Optional[str]):
        return None if axis is None else self.groups[axis]

    def _n(self, axis: Optional[str]) -> int:
        return self.world if axis is None else self.shape[axis]

    def _parts(self, nbytes: int, axis: Optional[str], rows: int = 1) -> list:
        """(lo, hi, group) of each part of a row of ``nbytes`` over
        ``axis``: one part a stream group under gloo where the ``rows``
        rows hold STREAM_MIN_BYTES or more, else one part on the axis's own
        group."""
        groups = self.streams[axis] if rows * nbytes >= STREAM_MIN_BYTES else self.streams[axis][:1]
        groups = groups[: max(1, min(len(groups), nbytes))]  # no empty part
        k = len(groups)
        return [(nbytes * j // k, nbytes * (j + 1) // k, g) for j, g in enumerate(groups)]

    def _host(self, n: int, size: int) -> torch.Tensor:
        """A uint8 buffer [n, size] where gloo reads and writes: pinned
        host memory when staged."""
        return torch.empty((n, size), dtype=torch.uint8, pin_memory=self.staged)

    def _exchange(self, src: torch.Tensor, n: int, axis: Optional[str]) -> torch.Tensor:
        """gloo's all-to-all on bytes: ``src`` uint8 [n, B] (row i for the
        axis's rank i) or [B] (the same row for every rank) → [n, B] on
        src's device, row i from rank i. The parts (:meth:`_parts`) go out
        together; staged rows pass through pinned host buffers."""
        b = src.shape[-1]
        parts = self._parts(b, axis, n)
        sends, recvs = [], []
        for lo, hi, _ in parts:
            send = self._host(n, hi - lo)
            for i in range(n):
                send[i].copy_((src[i] if src.dim() == 2 else src)[lo:hi], non_blocking=self.staged)
            sends.append(send)
            recvs.append(self._host(n, hi - lo))
        if self.staged:
            torch.cuda.current_stream(src.device).synchronize()
        works = [dist.all_to_all_single(r, snd, group=g, async_op=True)
                 for r, snd, (_, _, g) in zip(recvs, sends, parts)]
        for w in works:
            w.wait()
        out = torch.empty((n, b), dtype=torch.uint8, device=src.device)
        for r, (lo, hi, _) in zip(recvs, parts):
            out[:, lo:hi].copy_(r, non_blocking=self.staged)
        return out

    def _gathered(self, x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """[n, *x.shape]: every rank's ``x`` along ``axis`` (None: every
        rank), in axis order, on x's device. Under gloo every rank sends
        its ``x`` to each rank by all-to-all: gloo's all-gather moved 0.7x
        the bytes a second of its all-to-all on the card's machine
        (``tools/torch_gloo_probe.py --parts bandwidth``)."""
        n = self._n(axis)
        x = x.contiguous()
        if self.native:
            raw = _bytes(x)
            out = raw.new_empty((n * raw.shape[0], *raw.shape[1:]))
            dist.all_gather_into_tensor(out, raw, group=self._group(axis))
            return _unbytes(out, x.dtype).reshape(n, *x.shape)
        out = self._exchange(x.reshape(-1).view(torch.uint8), n, axis)
        return _unbytes(out, x.dtype).reshape(n, *x.shape)

    def all_reduce(self, x: torch.Tensor, axes: Optional[Sequence[str]] = None) -> torch.Tensor:
        """The sum of ``x`` over ``axes`` (None: every rank) → a new
        tensor of x's dtype, summed in f32 (the same bits on every rank):
        NCCL's all-reduce an axis; under gloo each axis's ranks gather one
        another's bytes and sum them on x's device, in rank order."""
        names = [None] if axes is None else [a for a in axes if self.shape[a] > 1]
        if self.world == 1 or not names:
            return x.clone()
        if self.native:
            # NCCL takes only contiguous tensors (a gradient can carry a
            # transposed leaf's strides)
            acc = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
            for a in names:
                dist.all_reduce(acc, group=self._group(a))
            return acc.to(x.dtype)
        acc = x
        for a in names:
            acc = self._gathered(acc, a).float().sum(dim=0)
        return acc.to(x.dtype)

    def all_gather(self, x: torch.Tensor, axis: Optional[str], dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` (None: every rank), concatenated
        along ``dim`` in axis order."""
        if self.world == 1 or self._n(axis) == 1:
            return x
        return self._gathered(x.movedim(dim, 0), axis).flatten(0, 1).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, of which this rank keeps its
        chunk along ``dim`` (:func:`chunk_bounds`; a dim that does not
        divide is padded for the transport), summed in f32: NCCL's
        reduce-scatter; under gloo each rank sends every other its chunk
        (one all-to-all) and sums what it receives on x's device, in rank
        order."""
        n = self.shape[axis]
        if self.world == 1 or n == 1:
            return x.clone()
        size = x.shape[dim]
        c = -(-size // n)
        src = x.movedim(dim, 0)
        if c * n != size:
            src = torch.cat([src, src.new_zeros((c * n - size, *src.shape[1:]))])
        lo, hi = chunk_bounds(size, n, self.coords[axis])
        if self.native:
            out = src.new_empty((c, *src.shape[1:]), dtype=torch.float32)
            dist.reduce_scatter_tensor(out, src.float().contiguous(), group=self._group(axis))
            return out[: hi - lo].movedim(0, dim).to(x.dtype)
        parts = self.all_to_all(src.reshape(n, c, *src.shape[1:]), axis, 0, 0)  # [n, c, ...]: rank i's chunk
        return parts.float().sum(dim=0)[: hi - lo].movedim(0, dim).to(x.dtype)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
        """JAX's tiled ``all_to_all``: ``x`` split into ``n`` chunks along
        ``split_dim``, chunk j sent to the axis's rank j, the chunks
        received concatenated along ``concat_dim`` in axis order."""
        n = self.shape[axis]
        if self.world == 1 or n == 1:
            return x
        parts = x.shape[split_dim] // n
        # [..., n, parts, ...] with the chunk index moved first
        y = x.unflatten(split_dim, (n, parts)).movedim(split_dim, 0).contiguous()
        if not self.native:
            got = _unbytes(self._exchange(y.reshape(n, -1).view(torch.uint8), n, axis), x.dtype).reshape(y.shape)
        else:
            got = torch.empty_like(y)
            dist.all_to_all_single(got, y, group=self._group(axis))
        # got[i] is rank i's chunk (x's shape, split_dim cut to parts):
        # the chunks join along concat_dim in the order i
        return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)

    def shift(self, tensors: Sequence[torch.Tensor], axis: str, shift: int = 1) -> list[torch.Tensor]:
        """A ring shift along ``axis``: each tensor sent to the axis's rank
        ``index + shift`` and received from ``index - shift`` (JAX's
        ``ppermute`` with ``perm = [(i, (i + shift) % n)]``), by
        ``batch_isend_irecv`` to the neighbours, a batch a stream group
        (:meth:`_parts`)."""
        n = self.shape[axis]
        if self.world == 1 or shift % n == 0:
            return list(tensors)
        ranks = self.axis_ranks(axis)
        i = self.coords[axis]
        to, frm = ranks[(i + shift) % n], ranks[(i - shift) % n]
        batches: dict = {}  # stream index → its ops
        recvs = []  # per tensor: (its bytes, [(lo, hi, receive buffer)])
        for t in tensors:
            tb = t.contiguous().reshape(-1).view(torch.uint8)
            got = []
            for j, (lo, hi, g) in enumerate(self._parts(tb.numel(), axis)):
                send = tb[lo:hi]
                if self.staged:
                    send = self._host(1, hi - lo)[0]
                    send.copy_(tb[lo:hi], non_blocking=True)
                recv = torch.empty_like(tb[lo:hi]) if self.native else self._host(1, hi - lo)[0]
                batches.setdefault(j, []).extend([dist.P2POp(dist.isend, send, to, group=g),
                                                  dist.P2POp(dist.irecv, recv, frm, group=g)])
                got.append((lo, hi, recv))
            recvs.append((tb, got))
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
        works = [w for j in sorted(batches) for w in dist.batch_isend_irecv(batches[j])]
        for w in works:
            w.wait()
        out = []
        for t, (tb, got) in zip(tensors, recvs):
            whole = torch.empty_like(tb)
            for lo, hi, recv in got:
                whole[lo:hi].copy_(recv, non_blocking=self.staged)
            out.append(_unbytes(whole, t.dtype).reshape(t.shape))
        return out

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def make_mesh(config: Optional[MeshConfig] = None, device: str = "cuda") -> Mesh:
    """The mesh over the world: joins torchrun's group (:func:`init_distributed`)
    and resolves ``config`` (default: ``fsdp`` absorbs every rank, JAX's
    default) over its size."""
    return Mesh(config or MeshConfig(), init_distributed(device))


def mesh_shape(mesh: Mesh) -> dict[str, int]:
    """The mesh's size on each axis, in :data:`AXES` order."""
    return {a: mesh.shape[a] for a in AXES}


def chunk_bounds(size: int, n: int, i: int) -> tuple[int, int]:
    """[lo, hi) of chunk i of a dim of ``size`` cut into ``n``: chunks of
    ceil(size / n), the last ones shorter or empty (``torch.chunk``'s
    sizes, as a DTensor ``Shard`` places them)."""
    c = -(-size // n)
    return min(i * c, size), min((i + 1) * c, size)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as uint8, its leading dim kept (gloo
    moves every dtype as bytes)."""
    if t.dtype == torch.uint8:
        return t
    if t.dim() == 0:
        t = t.reshape(1)
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def _unbytes(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint8:
        return raw
    return raw.view(dtype)


# ---------------------------------------------------------------------------
# autograd-aware collectives (where a gradient flows through them)
# ---------------------------------------------------------------------------


class Shift(torch.autograd.Function):
    """:meth:`Mesh.shift` under autograd: the backward shifts the
    gradients back (JAX's transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return tuple(mesh.shift(tensors, axis, shift))

    @staticmethod
    def backward(ctx, *grads):
        back = ctx.mesh.shift([g.contiguous() for g in grads], ctx.axis, -ctx.shift)
        return (None, None, None, *back)


class AllToAll(torch.autograd.Function):
    """:meth:`Mesh.all_to_all` under autograd: the backward is the
    all-to-all with the split and concat dims swapped."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axis, concat_dim, split_dim), None, None, None, None
