"""CUDA-graph capture of a training step: the port's counterpart of
``jax.jit`` with donated params.

:class:`CapturedStep` records one call of a step function as a
``torch.cuda.CUDAGraph`` over static device buffers (the batch's tensors
and the step counter) and replays it for every later call with the same
shapes: each call copies its batch into the buffers, fills in the step,
and replays. The params are updated in place by the graph, which is
bound to their storage (the counterpart of donation): a call with other
params tensors captures anew, so no replay ever writes stale storage.

Capture needs a step with no read of a device value on the host, no
shape that depends on the data, and no copy from the host (the step's
code keeps to that; ``tests/test_torch_capture.py`` holds every
capturable form to it on the CPU). Before the capture the function runs
once on clones of the params (a warm-up: it builds every kernel, sets
the kernels' shared-memory opt-ins and warms the allocator; on the real
params it would apply the step twice), then the capture records the
call on the real tensors. A capture that fails raises: nothing falls
back to the eager step.

The kernel wrappers count the launches of the warm-up; a call that the
capture records is no launch, and the replays launch the recorded
kernels past the wrappers, so no counter sees them: the card's profiler
does (``chip_smoke.py`` counts them by kernel symbol).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["CapturedStep", "capture_underway", "capturing"]

_capture_lock = threading.Lock()
_captures = 0


@contextlib.contextmanager
def capturing():
    """Marks a CUDA graph capture for :func:`capture_underway` (the
    introspection engine begins no profiler trace during one)."""
    global _captures
    with _capture_lock:
        _captures += 1
    try:
        yield
    finally:
        with _capture_lock:
            _captures -= 1


def capture_underway() -> bool:
    """Whether some thread of this process is capturing a CUDA graph."""
    return _captures > 0


def _leaves(tree):
    """The tensors of a params pytree (dicts, lists and tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _clone(tree, device=None):
    """A copy of a tree of tensors (dicts, lists, tuples), on ``device``
    when one is given."""
    if isinstance(tree, torch.Tensor):
        return tree.clone() if device is None else tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _clone(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(x, device) for x in tree)
    return tree


def _binding(params):
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in _leaves(params))


def _layout(inputs):
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in inputs)


class _Graph:
    """One captured call over static buffers shaped like ``inputs``."""

    def __init__(self, fn, params, inputs, device, pool):
        self.binding = _binding(params)
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.inputs = [None if t is None else torch.empty_like(
            t, device=device, memory_format=torch.contiguous_format)
            for t in inputs]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._fill(0, inputs)
            fn(_clone(params), self.step, *self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the prefetcher's thread goes on pinning and copying
        # batches on its own stream while this thread captures.
        with capturing(), torch.cuda.graph(
                self.graph, pool=pool, capture_error_mode="thread_local"):
            self.loss = fn(params, self.step, *self.inputs)
        self.capture_s = time.perf_counter() - t0

    def _fill(self, step, inputs):
        if isinstance(step, torch.Tensor):
            self.step.copy_(step)
        else:
            self.step.fill_(int(step))
        for buf, t in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t)

    def replay(self, step, inputs):
        self._fill(step, inputs)
        self.graph.replay()
        return self.loss.clone()


class CapturedStep:
    """``fn(params, step, *inputs) → loss`` captured once per input layout
    and replayed, with the params updated in place by the graph.

    ``step`` is an int or a 0-dim integer tensor, ``inputs`` tensors on
    the params' device (None where the layout has no tensor). Graphs of
    one object share one memory pool (they replay one at a time on one
    stream). ``capture_s`` lists each capture's seconds (warm-up
    included); :meth:`reset` frees the graphs and their memory.
    """

    def __init__(self, fn):
        self._fn = fn
        self._graphs: dict = {}
        self._pool = None
        self._lock = threading.Lock()
        self.capture_s: list[float] = []

    def __call__(self, params, step, *inputs):
        leaves = _leaves(params)
        device = leaves[0].device
        key = _layout(inputs)
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None and graph.binding != _binding(params):
                # Other params tensors: the graph would write the old ones.
                self.reset()
                graph = None
            if graph is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = _Graph(self._fn, params, inputs, device, self._pool)
                self._graphs[key] = graph
                self.capture_s.append(graph.capture_s)
            return graph.replay(step, inputs)

    def reset(self) -> None:
        """Drop every graph (and with the last one its memory pool)."""
        self._graphs.clear()
        self._pool = None
