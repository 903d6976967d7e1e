"""Decode steps captured once as CUDA graphs and replayed: the port's
counterpart of ``jax.jit`` for the steps the JAX package jits
(``quest_tpu/engine/engine.py``, ``engine/scheduler.py``,
``parallel/tp.py``), and :func:`eager`, the counterpart of
``jax.disable_jit``.

A :class:`StepGraphs` belongs to one engine (or one sharded model): it
holds the engine's graph memory pool and capture stream, and makes its
:class:`Compiled` steps. A step's static signature is the step function,
the shape and dtype of every tensor argument, the value of every other
argument (a burst's ``n``), the identity and storage of the cache it is
handed, and the storage of the module's buffers (its weights). On a CUDA
device the first call of a signature

  1. copies the tensor arguments into static input buffers;
  2. runs the step once on the capture stream (the warm-up). That call
     is the real step, and its result is the call's result: the kernels
     are built, ``cudaFuncSetAttribute`` and the tensor maps are set up
     and the workspaces sized here, outside the capture;
  3. captures the same body into a ``torch.cuda.CUDAGraph`` on that
     stream, in the engine's pool. Capture runs no kernel, so the step
     is not applied twice.

Every later call copies its tensor arguments into the static buffers and
replays the graph. Its outputs are the graph's static output buffers: the
next call of that signature overwrites them, so a caller that keeps one
across calls clones it. A failed capture raises; nothing falls back to
eager.

Launch counters (each kernel wrapper's ``launches``) move only on the
host, so a replay would not move them: the capture's delta is recorded,
taken back, and added again on every replay, and a replayed run counts
the launches of the eager run. Device generators passed to a step (the
sampled step's) are registered with its graph, so each replay draws
what the eager step draws from the same generator state and advances it
as much.

Buffers the ops cache and replace when they grow (the decode and
``qgemv`` workspaces, the dequant buffer) are held by each graph that
captured them (:func:`quest_tpu_torch.ops.utils.holding`), so a later
growth never frees memory a replay writes.

Each warm-up and capture is a ``capture`` span of the trace recorder
(``utils/trace.py``), so a graph built again while serving shows.

Without capture (a CPU device, or ``capture=False``: a gloo process
group, which cannot be captured) the same static-buffer body runs on
every call with no graph. Under :func:`eager` every step runs as the
plain function call, with no static buffers: A/B timing, the profiler's
trace ranges (they open on the host, so a replay has none) and kernel
taps that wrap the kernels in Python.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

from quest_tpu_torch.ops.utils import holding
from quest_tpu_torch.utils.trace import RECORDER

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every compiled step as its plain call while inside (nests)."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    return _eager_depth > 0


def launch_counters() -> tuple:
    """Every kernel wrapper that counts its launches."""
    from quest_tpu_torch.kv.paged_kv import (append_decode_at,
                                             append_prefill_at,
                                             rope_append_decode_at)
    from quest_tpu_torch.ops.copy_probe import copy_probe
    from quest_tpu_torch.ops.dense_decode import dense_decode_attention
    from quest_tpu_torch.ops.estimate import (page_scores_kernel,
                                              page_scores_physical)
    from quest_tpu_torch.ops.fused_decode import (exact_topk_select,
                                                  fused_sparse_decode)
    from quest_tpu_torch.ops.head_gemv import head_gemv
    from quest_tpu_torch.ops.moe import moe_experts, moe_route
    from quest_tpu_torch.ops.prefill import prefill_attention
    from quest_tpu_torch.ops.qdot import dequant, qgemv
    from quest_tpu_torch.ops.rms_norm import rms_norm
    from quest_tpu_torch.ops.rope import rotate_qk
    from quest_tpu_torch.ops.select_pieces import select_pieces
    from quest_tpu_torch.ops.silu_mul import silu_mul
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    return (sparse_decode_attention, dense_decode_attention,
            fused_sparse_decode, prefill_attention, page_scores_kernel,
            page_scores_physical, exact_topk_select, qgemv, dequant,
            copy_probe, select_pieces, append_decode_at, rotate_qk,
            rope_append_decode_at, rms_norm, head_gemv, append_prefill_at,
            silu_mul, moe_route, moe_experts)


class CudaGraph:
    """One captured step: ``capture(body, generators)`` records ``body()``
    on the engine's capture stream into its pool and returns its outputs;
    ``replay()`` launches the graph on the current stream."""

    def __init__(self, graphs: "StepGraphs"):
        self.pool, self.stream = graphs.pool, graphs.stream
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, body: Callable, generators) -> object:
        for gen in generators:
            self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream):
            return body()

    def replay(self) -> None:
        self.graph.replay()


def _storage_key(obj) -> tuple:
    """Identity and tensor storage of an object a step reads in place
    (the cache)."""
    if dataclasses.is_dataclass(obj):
        return (id(obj),) + tuple(
            getattr(obj, f.name).data_ptr() for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor))
    return (id(obj),)


def _arg_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, torch.Generator):
        return ("generator", id(x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return ("object",) + _storage_key(x)


@dataclasses.dataclass
class _Entry:
    args: list                        # static buffers and passed-through args
    kwargs: dict
    outputs: object = None
    graph: object = None
    delta: Dict[Callable, int] = dataclasses.field(default_factory=dict)
    held: list = dataclasses.field(default_factory=list)
    capture_s: float = 0.0
    pool_bytes: int = 0


def _static_copy(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, copy=True)
    return x


def _copy_in(static, x) -> None:
    if isinstance(static, torch.Tensor) and static.data_ptr() != x.data_ptr():
        static.copy_(x)


class Compiled:
    """A step function compiled per static signature (module docstring).
    ``calls`` counts the calls made (eager, plain or replayed)."""

    def __init__(self, graphs: "StepGraphs", fn: Callable, module=None):
        self.graphs = graphs
        self.fn = fn
        self.module = (module if module is not None
                       else getattr(fn, "__self__", None))
        self.entries: Dict[tuple, _Entry] = {}
        self.calls = 0

    def _key(self, args, kwargs) -> tuple:
        key = tuple(_arg_key(a) for a in args) + tuple(
            (k, _arg_key(v)) for k, v in sorted(kwargs.items()))
        if isinstance(self.module, torch.nn.Module):
            key += tuple(b.data_ptr() for b in self.module.buffers())
        return key

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if is_eager():
            return self.fn(*args, **kwargs)
        key = self._key(args, kwargs)
        entry = self.entries.get(key)
        if entry is None:
            dev = self.graphs.device
            entry = _Entry([_static_copy(a, dev) for a in args],
                           {k: _static_copy(v, dev)
                            for k, v in kwargs.items()})
            if self.graphs.new_graph is not None:
                with RECORDER.span("capture",
                                   fn=getattr(self.fn, "__name__", "")):
                    out = self._warm_up_and_capture(entry)
                self.entries[key] = entry
                return out
            self.entries[key] = entry
        else:
            for s, a in zip(entry.args, args):
                _copy_in(s, a)
            for k, v in kwargs.items():
                _copy_in(entry.kwargs[k], v)
        if entry.graph is None:
            entry.outputs = self.fn(*entry.args, **entry.kwargs)
            return entry.outputs
        entry.graph.replay()
        for counter, n in entry.delta.items():
            counter.launches += n
        return entry.outputs

    def _body(self, entry: _Entry):
        return self.fn(*entry.args, **entry.kwargs)

    def _warm_up_and_capture(self, entry: _Entry):
        g = self.graphs
        out = g.warm_up(lambda: self._body(entry))
        counters = launch_counters()
        before = {c: c.launches for c in counters}
        gens = [a for a in list(entry.args) + list(entry.kwargs.values())
                if isinstance(a, torch.Generator)]
        graph = g.new_graph(g)
        reserved = g.reserved_bytes()
        t = time.perf_counter()
        # A graph that Python's cycle collector destroys during a capture
        # invalidates it (global capture mode): collect first, then hold
        # the collector off until the capture ends.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with holding() as held:
                entry.outputs = graph.capture(lambda: self._body(entry), gens)
        finally:
            if gc_was_on:
                gc.enable()
            entry.delta = {c: c.launches - before[c] for c in counters
                           if c.launches != before[c]}
            for c in counters:
                c.launches = before[c]
        entry.capture_s = time.perf_counter() - t
        entry.pool_bytes = g.reserved_bytes() - reserved
        entry.graph, entry.held = graph, held
        return out

    def stats(self) -> List[dict]:
        """Each captured signature's capture (and instantiate) seconds and
        the bytes its capture added to the pool."""
        return [dict(capture_s=e.capture_s, pool_bytes=e.pool_bytes)
                for e in self.entries.values() if e.graph is not None]


class StepGraphs:
    """The compiled steps of one engine on ``device``, sharing one graph
    memory pool and capture stream (created at the first capture; freed
    with the engine). ``capture`` defaults to True on a CUDA device;
    pass False where the steps cannot be captured (a gloo group).
    ``new_graph(graphs)`` makes a graph object with ``capture(body,
    generators)`` and ``replay()`` (default :class:`CudaGraph` when
    capturing)."""

    def __init__(self, device, capture: Optional[bool] = None,
                 new_graph: Optional[Callable] = None):
        self.device = torch.device(device)
        if capture is None:
            capture = self.device.type == "cuda"
        self.new_graph = new_graph or (CudaGraph if capture else None)
        self._pool = None
        self._stream = None
        # Weak, so that no cycle keeps an engine's graphs for the cycle
        # collector (see _warm_up_and_capture).
        self.compiled = weakref.WeakSet()

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @property
    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def compile(self, fn: Callable, module=None) -> Compiled:
        """``fn`` compiled per static signature; ``module`` (default: a
        bound method's owner) is the ``nn.Module`` whose buffers (the
        weights) the step reads."""
        c = Compiled(self, fn, module)
        self.compiled.add(c)
        return c

    def warm_up(self, body: Callable):
        """``body()`` on the capture stream, ordered after and before the
        current stream's work; its result."""
        if self.device.type != "cuda":
            return body()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = body()
        main.wait_stream(self.stream)
        return out

    def reserved_bytes(self) -> int:
        """The device memory the caching allocator holds, after releasing
        its unused blocks (what a capture adds to it is its pool)."""
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def summary(self) -> dict:
        """Graphs captured, their capture seconds and pool bytes."""
        stats = [s for c in self.compiled for s in c.stats()]
        return dict(graphs=len(stats),
                    capture_s=sum(s["capture_s"] for s in stats),
                    pool_bytes=sum(s["pool_bytes"] for s in stats))
