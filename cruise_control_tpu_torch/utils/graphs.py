"""CUDA graphs of solver rounds: capture, replay, and the pinned host
reads between replays.

The round loop (``analyzer/chain.py``) captures a block of rounds once per
goal, phase and shape and replays it over static buffers. This module
holds what that needs beyond the rounds themselves:

- :func:`capture` records a function into a graph under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host sync left in the
  captured code is named where it happens; any failure raises. The kernel
  wrappers' calls during capture are the graph's launches
  (:class:`Graph`), counted into ``kernels.LAUNCHES`` once per replay and
  not at capture.
- Every graph draws its temporaries from one memory pool per device
  (:func:`shared_pool`). A graph's inputs and outputs are static buffers
  allocated outside the pool, and nothing allocated inside a capture
  outlives it, so at every graph boundary the pool holds no live value:
  whatever order graphs replay in, none can overwrite a tensor another
  still needs, and the pool's size is that of the largest graph, not
  their sum.
- :class:`HostRead` copies device scalars into pinned host memory behind
  an event: reading them waits for that event alone, not for the work
  enqueued after it, so the host can keep the next replay in flight.
"""

from __future__ import annotations

import collections

import torch

from .. import kernels

_POOLS: dict = {}


def shared_pool(device: torch.device):
    """The memory pool that every solver graph on ``device`` shares."""
    key = torch.device(device).index
    if key not in _POOLS:
        _POOLS[key] = torch.cuda.graph_pool_handle()
    return _POOLS[key]


class Graph:
    """A captured CUDA graph and the kernel launches (wrapper calls, by
    kernel name) one replay makes."""

    def __init__(self, graph, launches: collections.Counter):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.LAUNCHES.update(self.launches)


def capture(fn, device: torch.device) -> Graph:
    """Capture ``fn()`` into a CUDA graph on ``device`` (its pool shared
    with every other solver graph there). A host sync inside ``fn``
    raises, as does any capture failure."""
    before = collections.Counter(kernels.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=shared_pool(device)):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
    finally:
        launches = collections.Counter(kernels.LAUNCHES)
        launches.subtract(before)
        kernels.LAUNCHES.clear()
        kernels.LAUNCHES.update(before)
    return Graph(graph, +launches)


class HostRead:
    """Integer (or bool) scalars of one device, read on the host. On a
    CUDA device they are copied into pinned memory behind an event when
    the read is made; :meth:`values` waits for that event only. On the
    CPU they are read at once."""

    def __init__(self, *scalars: torch.Tensor):
        dev = scalars[0].device
        self._event = None
        if dev.type == "cpu":
            self._values = [int(x) for x in scalars]
            return
        vals = torch.stack([x.to(torch.int64) for x in scalars])
        self._host = torch.empty(vals.shape, dtype=torch.int64,
                                 pin_memory=True)
        self._host.copy_(vals, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        self._values = None

    def values(self) -> list[int]:
        if self._values is None:
            self._event.synchronize()
            self._values = self._host.tolist()
        return self._values
