"""CUDA-graph replay of a function on state containers: the port's
counterpart of the JAX package's compiled ``lax.scan`` over the physics
substeps.

The ten 1 kHz substeps of an MPC period are a few hundred small kernels
with no host decision among them, so launching them one by one from Python
costs far more host time than the card spends running them. A
:class:`GraphedFn` captures ``fn(state, inputs) -> state`` once per input
shape into a CUDA graph and replays it: one launch for the whole region.
``inputs`` is the desired forces, or a tree of them and whatever else
varies from call to call (the fault-aware substeps' thrust scale): every
tensor the region reads per call enters as an input, never as a tensor the
graph closes over.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_aerial_transport_torch.tree import leaves, tree_map

# Calls of ``fn`` on a side stream before a capture: the first call of a
# library routine on a stream allocates its handle and workspace, which
# must not happen inside the capture.
WARMUP_CALLS = 2


class GraphedFn:
    """``fn(state, inputs) -> state`` (``state`` and ``inputs`` trees of
    tensors, :mod:`tpu_aerial_transport_torch.tree`), replayed from a CUDA graph
    for inputs on the card and called as it is for inputs on the CPU,
    where no graph exists. The graph is captured at the first call of each
    input shape (a bucketed step's ``B / n_buckets`` lanes and the whole
    batch are two captures) and closes over whatever tensors ``fn`` reads
    besides its arguments, the parameters among them: one instance serves
    one parameter set. The inputs are copied into the graph's static
    buffers before each replay, and the outputs cloned after it, so a
    result the caller holds is never overwritten by the next replay. A
    capture that fails raises; nothing falls back to eager calls on the
    card. ``captures`` and ``replays`` count both on this instance."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.captures = 0
        self.replays = 0
        self._graphs: dict = {}

    def __call__(self, state, inputs):
        ts = leaves(state) + leaves(inputs)
        dev = ts[0].device
        if dev.type == "cpu":
            return self.fn(state, inputs)
        if dev.type != "cuda":
            raise ValueError(f"GraphedFn: unsupported device {dev}")
        key = tuple((t.shape, t.dtype, t.device) for t in ts)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(state, inputs)
        graph, static_state, static_in, static_out = entry
        tree_map(lambda dst, src: dst.copy_(src), static_state, state)
        tree_map(lambda dst, src: dst.copy_(src), static_in, inputs)
        graph.replay()
        self.replays += 1
        return tree_map(torch.clone, static_out)

    def _capture(self, state, inputs):
        static_state = tree_map(torch.clone, state)
        static_in = tree_map(torch.clone, inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(static_state, static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self.fn(static_state, static_in)
        self.captures += 1
        return graph, static_state, static_in, static_out
