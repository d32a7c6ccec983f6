"""Captured step programs: the port's counterpart of ``jax.jit`` on the
serving engine's prefill and decode.

A :class:`StepProgram` is one function over static input buffers on the
device.  :meth:`StepProgram.run` copies the step's inputs into those
buffers and, on the card, replays one ``torch.cuda.CUDAGraph`` that was
captured from the function once, at engine build: no Python runs inside
a replayed step.  The graph keeps every address it was captured with, so
the buffers, the outputs and whatever the function reads (weights, the
KV pool, the block table) are never rebound, only written in place.
The captured ``cudaGraph_t`` is kept beside its instantiation
(``keep_graph``), so that a caller can list the kernel nodes that every
replay launches (``chip_smoke.py`` counts the port's kernels there).

On the CPU, or with ``graphs=False`` on the card (the counterpart of
``jax.disable_jit()``), the same function runs eagerly over the same
buffers: the caller asked for it.  A capture that fails on the card
raises; nothing falls back to the eager step.

The RNS op tallies of one run (``ops``) are taken when the program is
built, as the JAX engine traces its ``OpCounts`` once: a replay makes no
wrapper calls for ``dispatch.count_ops`` to see.
"""

from __future__ import annotations

import gc

import torch

from repro_torch.core import dispatch

__all__ = ["StepProgram", "build_programs"]


class StepProgram:
    """``fn(**inputs)`` over the static ``inputs`` buffers; ``outputs``
    are what its last run (or the capture) returned.  ``captures``
    counts the graphs captured (the counterpart of ``_cache_size()``)."""

    def __init__(self, name: str, fn, inputs: dict[str, torch.Tensor]):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.outputs = None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.ops: dispatch.OpCounts | None = None
        self.captures = 0

    def _call(self):
        with dispatch.count_ops() as ops:
            self.outputs = self.fn(**self.inputs)
        return ops

    def warm(self):
        """One eager run: builds the kernels it launches, sizes their
        workspaces on the current stream and takes the op tallies."""
        self.ops = self._call()

    def capture(self, stream: torch.cuda.Stream, pool):
        """Capture ``fn`` on ``stream`` into the shared memory ``pool``.

        Dead reference cycles are collected first and the collector is
        off during the capture: a cycle collected mid-capture, in any
        thread, could free a CUDA graph or tensor of an earlier program,
        a call the capture does not permit (it invalidates the capture)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                ops = self._call()
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        if ops.as_dict() != self.ops.as_dict():
            raise RuntimeError(f"{self.name}: the captured run tallied "
                               f"{ops.as_dict()}, the warm-up "
                               f"{self.ops.as_dict()}")
        self.graph = graph
        self.captures += 1

    def run(self, **inputs):
        """Copy ``inputs`` into the static buffers, then replay the graph
        (or run ``fn`` eagerly); returns the static outputs."""
        for name, value in inputs.items():
            self.inputs[name].copy_(value, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
        else:
            self.outputs = self.fn(**self.inputs)
        return self.outputs


def build_programs(programs, device: torch.device, *, graphs: bool):
    """Warm every program, then (on the card, with ``graphs``) capture
    each once on one capture stream into one shared memory pool.  Every
    warm-up runs on the capture stream before any capture, so that the
    kernel libraries load and the split workspaces of that stream
    (``kernels/workspace.py``) reach their final size outside a capture.
    Returns the capture stream, or None when nothing is captured."""
    if not (graphs and device.type == "cuda"):
        for prog in programs:
            prog.warm()
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for prog in programs:
            prog.warm()
    torch.cuda.current_stream(device).wait_stream(stream)
    pool = torch.cuda.graph_pool_handle()
    for prog in programs:
        prog.capture(stream, pool)
    return stream
