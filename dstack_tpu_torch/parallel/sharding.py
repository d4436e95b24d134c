"""Logical-axis sharding rules → placements (counterpart of
dstack_tpu.parallel.sharding).

Model code names every parameter dim by a logical axis (``"embed"``,
``"vocab"``, ``"heads"``, ...); the rule table maps logical names to mesh
axes, letter for letter JAX's :data:`DEFAULT_RULES`. JAX turns the result
into a ``PartitionSpec`` and lets XLA place the shards; here a spec is a
tuple of mesh-axis entries, one a dim, and :func:`placements` gives one
DTensor placement a mesh axis, ``Shard(d)`` or ``Replicate()``. The
train step reads only the dim ``fsdp`` shards (:func:`fsdp_dim`): the
other axes a parameter's rules name (``tp``, ``ep``, ``pp``) are size 1 on
the meshes this slice runs. No DTensor is built: each rank holds its
shard as a plain tensor (:func:`shard`), and :func:`gather_leaf` puts a
leaf back together (:class:`GatherShard` under autograd).
"""

from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
from torch.distributed.tensor import Replicate, Shard

from dstack_tpu_torch.parallel.mesh import AXES, Mesh, chunk_bounds

MeshAxis = Union[str, tuple[str, ...], None]

# logical axis -> mesh axis (or a tuple of them): JAX's table
DEFAULT_RULES: dict[str, MeshAxis] = {
    "batch": ("dp", "fsdp", "ep"),
    "batch_noexp": ("dp", "fsdp"),  # batch dim of ep-sharded MoE tensors
    "seq": "sp",
    "kv_seq": None,  # KV sequence stays replicated outside ring attention
    "embed": None,
    "embed_fsdp": "fsdp",  # param embed dim sharded for ZeRO-3
    "vocab": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "experts": "ep",
    "layers": None,  # stacked (scanned) layer dim
    "stages": "pp",  # pipeline stages (pipeline.py uses its own mesh)
}


@dataclass
class ShardingRules:
    rules: dict[str, MeshAxis]

    def spec(self, logical_axes: tuple[Optional[str], ...]) -> tuple:
        """A logical axis tuple → one mesh-axis entry a dim (JAX's
        ``PartitionSpec`` entries)."""
        return tuple(self.rules.get(a) if a is not None else None for a in logical_axes)


def default_rules(overrides: Optional[dict[str, MeshAxis]] = None) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingRules(rules)


def filter_spec_for_mesh(spec: tuple, mesh: Mesh) -> tuple:
    """Drop the mesh axes the mesh does not define (JAX's rule) and, here,
    those of size 1, which place nothing."""

    def keep(entry: MeshAxis) -> MeshAxis:
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in AXES and mesh.size(entry) > 1 else None
        kept = tuple(a for a in entry if a in AXES and mesh.size(a) > 1)
        return kept if kept else None

    return tuple(keep(e) for e in spec)


def placements(spec: tuple, mesh: Mesh) -> list:
    """One placement a mesh axis, in :data:`AXES` order: ``Shard(d)`` for
    the axis that dim d's entry names, ``Replicate()`` elsewhere."""
    out = [Replicate() for _ in AXES]
    for d, entry in enumerate(filter_spec_for_mesh(spec, mesh)):
        for a in (entry,) if isinstance(entry, str) else entry or ():
            out[AXES.index(a)] = Shard(d)
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def tree_map_axes(fn, spec_tree: Any) -> Any:
    if _is_axes(spec_tree):
        return fn(spec_tree)
    return {k: tree_map_axes(fn, v) for k, v in spec_tree.items()}


def tree_pspecs(spec_tree: Any, rules: ShardingRules) -> Any:
    """A tree of logical-axis tuples → the tree of their specs."""
    return tree_map_axes(rules.spec, spec_tree)


def fsdp_dim(spec: tuple, mesh: Mesh) -> Optional[int]:
    """The dim ``fsdp`` shards under ``spec``, or None (replicated)."""
    p = placements(spec, mesh)[AXES.index("fsdp")]
    return p.dim if isinstance(p, Shard) else None


def shard(x: torch.Tensor, dim: Optional[int], mesh: Mesh, axis: str = "fsdp") -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``axis``, a copy of
    its own (so the full tensor can be freed); ``dim=None`` → ``x``."""
    if dim is None or mesh.size(axis) == 1:
        return x
    lo, hi = chunk_bounds(x.shape[dim], mesh.size(axis), mesh.index(axis))
    return x.narrow(dim, lo, hi - lo).clone()


def gather_leaf(x: torch.Tensor, dim: Optional[int], size: Optional[int], mesh: Mesh,
                axis: str = "fsdp") -> torch.Tensor:
    """The whole leaf from every rank's chunk along ``dim`` (of the full
    ``size``; chunks padded for the transport); ``dim=None`` → ``x``."""
    n = mesh.size(axis)
    if dim is None or n == 1:
        return x
    c = -(-size // n)
    if x.shape[dim] != c:
        pad = list(x.shape)
        pad[dim] = c - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    return mesh.all_gather(x, axis, dim).narrow(dim, 0, size)


class GatherShard(torch.autograd.Function):
    """:func:`gather_leaf` over ``fsdp`` under autograd: the backward
    reduce-scatters the whole leaf's gradient to this rank's chunk (JAX's
    transpose of the all-gather), so a rank keeps only its shard of the
    gradient once the backward has passed the leaf."""

    @staticmethod
    def forward(ctx, x, dim, size, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return gather_leaf(x, dim, size, mesh)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, "fsdp", ctx.dim), None, None, None
