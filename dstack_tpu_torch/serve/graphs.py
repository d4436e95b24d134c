"""Compiled step sites: the port's counterpart of the JAX engine's jit
sites (dstack_tpu/serve/engine.py:1914-1945, 2583-2594).

A :class:`GraphSite` wraps one step function of the engine. On the card
it maps each variant of a call (the shapes and dtypes of its tensor
arguments, under the site's bucket key) to a ``torch.cuda.CUDAGraph``,
captured once and replayed after that; on the CPU, which only the tests
ask for, it runs the same function eagerly. Either way its
``_cache_size()`` grows on a variant's first call, which is what
``obs.flight.watch_jit`` counts as a compile, as JAX's ``JitWatch``
reads ``jax.jit``'s cache.

A variant's first call does the call's work eagerly on the set's side
stream, which also settles what a capture cannot do (``nvcc`` builds a
kernel on first use, K4 sets its shared-memory attribute once, cuBLAS
creates its handles and workspace), and then captures the function on
that stream. A capture records and runs nothing, so nothing the call
does (a K/V write, a count in ``_seen``, a draw counter) happens twice.
A capture that fails raises, naming the site and the key: nothing falls
back to the eager path on the card.

The call's rules, which the engine keeps:

- A site's arguments are the tensors that vary from call to call. The
  engine's fixed buffers (its cache, its device mirrors, its key data)
  are read in place by the function's closure. An argument that is a
  fixed tensor (registered with :meth:`GraphSet.fix`; a site's outputs
  are, unless it was made with ``fixed_outputs=False``) is captured in
  place, so sites chain through those buffers with no copy between them;
  a graph is bound to those addresses, so one variant fed from two sites'
  outputs (``advance_state`` after ``argmax`` or after ``sample``) holds
  a capture for each. Any other argument is copied into the graph's own
  input buffer at each call: the engine's prefill sites, one a key, leave
  their logits unfixed, so that one capture of ``sample`` serves them
  all.
- The outputs are the graph's own tensors: the next replay of the same
  variant overwrites them, so a caller copies out what it keeps.
- All of a set's graphs share one memory pool
  (``torch.cuda.graph_pool_handle()``). Each graph copies its results
  at its end into output buffers allocated outside the pool, so the pool
  holds only temporaries, which are dead between replays: the graphs may
  then replay in any order on the one stream.
- The kernels' launch counters (``LAUNCHES`` in ``ops/flash.py``,
  ``ops/flash_decode.py`` and ``ops/w8_matmul.py``) are bumped in Python
  when a wrapper enqueues its kernel, which a capture does once and a
  replay never. So a capture records each counter's change and puts the
  counters back, and every replay adds that change again: the counts
  read as in eager mode.
"""

import contextlib
import time
from typing import Any, Callable

import torch

from dstack_tpu_torch.ops import flash, flash_decode, w8_matmul

# (label, holder, name): every kernel wrapper's launch counter
_COUNTERS = (
    ("flash_fwd", flash, "LAUNCHES"),
    ("flash_fwd_mla", flash, "LAUNCHES_MLA"),
    ("flash_bwd_dq", flash, "LAUNCHES_DQ"),
    ("flash_bwd_dkv", flash, "LAUNCHES_DKV"),
    ("flash_decode", flash_decode, "LAUNCHES"),
    ("w8_matmul", w8_matmul, "LAUNCHES"),
)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (K4's also by variant, W8's by
    form)."""
    out = {label: getattr(holder, name) for label, holder, name in _COUNTERS}
    out.update({f"flash_decode_{k}": v for k, v in flash_decode.LAUNCHES_BY_VARIANT.items()})
    out.update({f"w8_matmul_{k}": v for k, v in w8_matmul.LAUNCHES_BY_FORM.items()})
    return out


def add_launches(delta: dict) -> None:
    """Add ``delta`` (a :func:`launch_counts` difference) to the counters."""
    for label, holder, name in _COUNTERS:
        if delta.get(label):
            setattr(holder, name, getattr(holder, name) + delta[label])
    for k in flash_decode.LAUNCHES_BY_VARIANT:
        flash_decode.LAUNCHES_BY_VARIANT[k] += delta.get(f"flash_decode_{k}", 0)
    for k in w8_matmul.LAUNCHES_BY_FORM:
        w8_matmul.LAUNCHES_BY_FORM[k] += delta.get(f"w8_matmul_{k}", 0)


def _leaves(out) -> tuple:
    """A site's result (a tensor, or a tuple of them) as a tuple."""
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _like(out, leaves):
    return leaves[0] if isinstance(out, torch.Tensor) else tuple(leaves)


class _Graph:
    """One capture: the graph, its input buffers (the caller's own tensor
    where it is fixed), its outputs, the launch counts it records and its
    capture wall seconds."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "seconds")

    def __init__(self, graph, inputs, outputs, launches, seconds):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.seconds = seconds


class GraphSet:
    """One engine's sites: whether they capture (``capture``: on the card
    unless the engine was built with ``graphs=False``), the fixed tensors
    that graphs read in place, the side stream captures run on and the
    shared memory pool."""

    def __init__(self, device, capture: bool):
        self.device = torch.device(device)
        self.capture = bool(capture)
        self.sites: list = []
        self._fixed: dict = {}  # data_ptr → (shape, stride, dtype)
        self._pool = None
        self._stream = None

    def fix(self, *tensors) -> None:
        """Register tensors that keep their storage for the set's life:
        a graph reads them in place."""
        for t in tensors:
            self._fixed[t.data_ptr()] = (tuple(t.shape), t.stride(), t.dtype)

    def is_fixed(self, t: torch.Tensor) -> bool:
        return self._fixed.get(t.data_ptr()) == (tuple(t.shape), t.stride(), t.dtype)

    def site(self, name: str, fn: Callable, key: Any = None, fixed_outputs: bool = True) -> "GraphSite":
        s = GraphSite(self, name, fn, key, fixed_outputs)
        self.sites.append(s)
        return s

    def report(self) -> dict:
        """Per site name: its variants (``entries``: the compiles), its
        captured graphs and their capture wall seconds. ``/health`` reads
        it on the event loop while the engine's thread may capture: each
        container is copied in one call before it is walked."""
        out: dict = {}
        for s in list(self.sites):
            r = out.setdefault(s.name, {"entries": 0, "captures": 0, "capture_s": 0.0})
            r["entries"] += s._cache_size()
            for bound in list(s.entries.values()):
                for g in list((bound or {}).values()):
                    r["captures"] += 1
                    r["capture_s"] += g.seconds
        return out

    def captures(self) -> list:
        """Every captured graph as [site name, key (``repr``), the
        variant's argument shapes, capture wall seconds]: the key names a
        variant, or for a site without one (``mark_prompt``) its shapes
        do. Copied as :meth:`report` copies."""
        out = []
        for s in list(self.sites):
            for variant, bound in list(s.entries.items()):
                for g in list((bound or {}).values()):
                    out.append([s.name, repr(s.key), [list(shape) for shape, _ in variant], g.seconds])
        return out

    # the capture's mechanics, on the card (the CPU tests replace them)

    @contextlib.contextmanager
    def side(self):
        """Run the block on the set's side stream, ordered after the
        current stream's work and before its later work."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def new_graph(self):
        return torch.cuda.CUDAGraph()

    def recording(self, graph):
        """Capture into ``graph`` on the side stream, into the shared pool.
        ``thread_local``: the server's other threads may call CUDA while
        the engine's thread captures."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                capture_error_mode="thread_local")


class GraphSite:
    """One step function under one bucket key (see the module note)."""

    def __init__(self, graphs: GraphSet, name: str, fn: Callable, key: Any = None,
                 fixed_outputs: bool = True):
        self.graphs = graphs
        self.name = name
        self.fn = fn
        self.key = key
        self.fixed_outputs = fixed_outputs
        # variant → {binding: _Graph}, or None where the site runs eagerly
        self.entries: dict = {}

    def _cache_size(self) -> int:
        """The variants this site has compiled: what ``watch_jit`` counts."""
        return len(self.entries)

    def __call__(self, *args: torch.Tensor):
        variant = tuple((tuple(a.shape), a.dtype) for a in args)
        gs = self.graphs
        if not gs.capture:
            self.entries.setdefault(variant, None)
            return self.fn(*args)
        # a graph is bound to the addresses of the fixed arguments it reads
        # in place: another binding of one variant is another capture (not
        # another compile: the variant is the same, as one jit executable
        # serves any buffers)
        fixed = tuple(gs.is_fixed(a) for a in args)
        binding = tuple(a.data_ptr() if f else None for a, f in zip(args, fixed))
        bound = self.entries.get(variant, {})
        g = bound.get(binding)
        if g is None:
            g = self._capture(args, fixed)
            self.entries[variant] = {**bound, binding: g}
            return g.outputs
        for a, buf, f in zip(args, g.inputs, fixed):
            if not f and a.data_ptr() != buf.data_ptr():
                buf.copy_(a)
        g.graph.replay()
        add_launches(g.launches)
        return g.outputs

    def _capture(self, args: tuple, fixed: tuple) -> _Graph:
        gs = self.graphs
        t0 = time.perf_counter()
        with gs.side():
            inputs = tuple(a if f else a.clone() for a, f in zip(args, fixed))
            eager = self.fn(*inputs)  # this call's work, done once
            outputs = _like(eager, [t.clone() for t in _leaves(eager)])
        graph = gs.new_graph()
        before = launch_counts()
        try:
            with gs.recording(graph):
                for buf, t in zip(_leaves(outputs), _leaves(self.fn(*inputs))):
                    buf.copy_(t)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of site {self.name!r} key {self.key!r} failed "
                f"(no eager fallback): {e}"
            ) from e
        finally:
            after = launch_counts()
            add_launches({k: before[k] - after[k] for k in before})
        if self.fixed_outputs:
            gs.fix(*_leaves(outputs))
        return _Graph(graph, inputs, outputs, {k: after[k] - before[k] for k in before},
                      time.perf_counter() - t0)
