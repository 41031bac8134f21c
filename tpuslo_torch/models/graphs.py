"""CUDA graphs over buffers of fixed storage: the port's counterpart of a
jitted program.

A graph bakes in the addresses it was captured with, so whatever runs
as a graph reads and writes only buffers whose storage never changes:
:class:`StagedInput` for what the host hands in before each replay, a
staged cache for what a replay writes.  :class:`GraphedDispatch` runs a
body eagerly on the CPU and captures it on a card, where each call is
one replay.  The speculative dispatches
(:mod:`tpuslo_torch.models.speculative`) and the front door's admission
prefills (:class:`tpuslo_torch.models.serve.AdmissionGraphs`) are built
from these.
"""

from __future__ import annotations

import gc
import inspect
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

from tpuslo_torch.models.kv_cache import kv_leaf_pairs
from tpuslo_torch.ops import launch_counts
from tpuslo_torch.otel.xla_spans import capture_range, dispatch_range, program_fingerprint


class StagedInput:
    """A device buffer of fixed storage that the host refills before each
    replay.  On a card each :meth:`write` copies from a fresh pinned host
    tensor with a copy that does not make the host wait; PyTorch's
    pinned-memory cache keeps that host block until the copy has run, so
    the host may write again before the card has read the last value
    (an admission refills one chunk's tokens several times before its
    one read)."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)

    def write(self, values) -> None:
        host = torch.as_tensor(np.asarray(values)).to(self.tensor.dtype)
        if self.tensor.device.type == "cuda":
            host = host.pin_memory()
        self.tensor.copy_(host.reshape(self.tensor.shape), non_blocking=True)


class GraphedDispatch:
    """One dispatch over buffers of fixed storage.

    ``body()`` queues the dispatch's work, reads and writes only buffers
    whose storage never changes, and returns its outputs.  On the CPU
    each call runs ``body`` eagerly.  On a card the constructor runs
    ``body`` once on a side stream (the warm-up), captures a second run
    in a CUDA graph inside ``pool`` (the owner's graphs share one) and
    records the capture as a compile event in ``compile_events``; each
    call then replays the graph inside one dispatch range named as the
    eager round names its own, and returns the captured outputs, whose
    storage is the graph's.  A capture that fails raises: nothing falls
    back to the eager body on a card.  The warm-up changes the buffers,
    so the owner resets them after construction.

    The kernels' launch counters (:mod:`tpuslo_torch.ops.launch_counts`)
    count what ran on the card: the capture's own increments are taken
    back (recording is not launching) and each replay adds them.

    A bound-method ``body`` is held weakly, so that an engine and its
    graph form no reference cycle: a dropped engine (and its graph) is
    freed at once, never by the cyclic collector in the middle of another
    engine's capture, where freeing a graph or pinned memory invalidates
    the capture.  The collector is also off while a capture runs.
    """

    #: ``on_capture(owner, key, ms)`` after every capture, when set
    #: (:mod:`tpuslo_torch.analysis.jitaudit` sets it).
    on_capture: Callable[[Any, str, float], None] | None = None

    def __init__(
        self,
        body: Callable[[], Any],
        module: str,
        inputs: tuple,
        device: torch.device,
        key: str,
        owner: Any = None,
        pool=None,
        compile_events: list | None = None,
    ):
        self._body_ref = (
            weakref.WeakMethod(body) if inspect.ismethod(body) else (lambda: body)
        )
        self.module = module
        self._inputs = inputs
        self.key = key
        self.graph = None
        self.outputs = None
        self._launches: list = []
        self.capture_ms: float | None = None
        if device.type == "cuda":
            self._capture(device, owner, pool, compile_events)

    def _body(self):
        """Run the dispatch's eager body once."""
        return self._body_ref()()

    def _capture(self, device, owner, pool, compile_events) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capture_range(self.module, *self._inputs):
                with torch.cuda.stream(side):
                    self._body()
                current.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                counted = launch_counts.snapshot()
                with torch.cuda.graph(graph, pool=pool):
                    self.outputs = self._body()
                # What the capture recorded is launched by each replay.
                self._launches = launch_counts.since(counted)
                launch_counts.add(self._launches, -1)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1000.0
        if compile_events is not None:
            compile_events.append({
                "bucket": self.key,
                "compile_ms": self.capture_ms,
                "program_id": program_fingerprint(self.module, *self._inputs),
                "module_name": self.module,
                "duration_ms": self.capture_ms,
            })
        if GraphedDispatch.on_capture is not None:
            GraphedDispatch.on_capture(owner, self.key, self.capture_ms)

    def __call__(self):
        if self.graph is None:
            return self._body()
        with dispatch_range(self.module, *self._inputs):
            self.graph.replay()
        launch_counts.add(self._launches)
        return self.outputs


def copy_cache(dst: dict, src: dict) -> None:
    """Copy ``src``'s K/V into ``dst``'s storage (same shape and
    representation), leaving ``dst``'s ``length`` alone."""
    for side in ("k", "v"):
        for d, s in kv_leaf_pairs(dst[side], src[side]):
            d.copy_(s)


