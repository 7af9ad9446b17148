"""Captured CUDA graphs of a loop of steps over static buffers: what the
stream's fast path replays for each window's LM solve (the counterpart of
the JAX package's jitted per-window program and its jit cache;
estimation/window.py, `_fast_window_full`).

A `LoopProgram` holds static input buffers, a carry of buffers, and one
CUDA graph per distinct step signature: a step's kernels may depend on
its index only through host values that the signature names (for the LM
iteration: the robust α, the dynamics weight Σ, the vision-only flag, the
best-iterate reset and the early stop's frozen phase), so two steps of
one signature replay one graph.  A run copies its inputs into the
buffers, resets the carry, and replays the steps' graphs in order: the
whole loop is enqueued without a host read.  All graphs of a program
share one private memory pool; their steps read and write only the
program's buffers, so replaying them in any order is safe.

`program(key, build)` keeps programs by key, as JAX's jit keys its
compiled programs (the caller's key names shapes, static arguments,
dtype, device and torch's kernel-selection flags): a second run of the
same shapes replays and captures nothing.  Unlike a jit cache, a program
holds device memory (its pool and buffers), so at most `MAX_PROGRAMS`
are kept: the least recently used one goes first, and its pool is
returned to the card (`torch.cuda.empty_cache`, on the cold path of a
capture only).  A program's graphs are
captured after one eager run of its first step on the program's side
stream (torch's rule: constants made at first use, library handles, K1's
library and its scratch query exist before the capture); that warm-up is
real and its K1 launches count.  A capture that fails raises; a card
never falls back to eager steps.  The K1 solves a graph holds are counted
at each replay (`tridiag_pcr.launched`); `stats` counts captures and
replays.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, List, Sequence

import torch

from vinsat_tpu_torch.kernels import tridiag_pcr

stats = collections.Counter()  # "captures", "replays", "evictions"
# the most programs kept: a stream keeps one a window (its padded shapes
# grow), and the bench arc's stream takes 7
MAX_PROGRAMS = 16
_programs: "collections.OrderedDict[Hashable, LoopProgram]" = \
    collections.OrderedDict()


def kernel_flags() -> tuple:
    """torch's settings that choose the kernels a capture records (a graph
    captured under one set must not serve another)."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def program(key: Hashable, build: Callable[[], "LoopProgram"]):
    """The program kept under `key`, built (and captured) at first use;
    the least recently used programs beyond MAX_PROGRAMS are dropped."""
    p = _programs.get(key)
    if p is not None:
        _programs.move_to_end(key)
        return p
    if len(_programs) >= MAX_PROGRAMS:
        while len(_programs) >= MAX_PROGRAMS:
            _programs.popitem(last=False)
            stats["evictions"] += 1
        # a dropped program's graphs released its pool: hand it back
        torch.cuda.empty_cache()
    p = _programs[key] = build()
    return p


def kept() -> int:
    """The number of programs kept."""
    return len(_programs)


def clear() -> None:
    """Forget every kept program (their graphs and memory pools)."""
    _programs.clear()


class LoopProgram:
    """steps[k] = step(index, inputs, carry) -> new carry, captured once per
    distinct signature(index) over the buffers of `inputs` (example
    tensors: shapes and dtypes) and of start(inputs) -> carry."""

    def __init__(self, inputs: Sequence[torch.Tensor],
                 start: Callable, step: Callable, indices: Sequence[int],
                 signature: Callable[[int], Hashable]):
        dev = inputs[0].device
        self.inputs = [torch.empty_like(t) for t in inputs]
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.start = start
        self.carry = [torch.empty_like(t) for t in start(self.inputs)]
        self.order = [signature(i) for i in indices]
        self.graphs: Dict[Hashable, tuple] = {}
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the warm-up: one eager step on the stream that captures
            self._reset()
            self._body(indices[0], step)
            for i, sig in zip(indices, self.order):
                if sig not in self.graphs:
                    self.graphs[sig] = self._capture(i, step, pool)
        torch.cuda.current_stream(dev).wait_stream(side)

    def _body(self, i: int, step: Callable) -> None:
        new = step(i, self.inputs, tuple(self.carry))
        for buf, t in zip(self.carry, new):
            if t is not buf:
                buf.copy_(t)

    def _capture(self, i: int, step: Callable, pool):
        """Step i's graph, captured on the current (side) stream: (graph,
        the K1 solves it holds)."""
        graph = torch.cuda.CUDAGraph()
        shapes: List[tuple] = []
        graph.capture_begin(pool=pool)
        try:
            with tridiag_pcr.capturing(shapes):
                self._body(i, step)
        except BaseException as err:
            try:
                graph.capture_end()
            except RuntimeError:
                pass
            raise RuntimeError(f"CUDA graph capture of step {i} failed") \
                from err
        graph.capture_end()
        stats["captures"] += 1
        return graph, shapes

    def _reset(self) -> None:
        for buf, t in zip(self.carry, self.start(self.inputs)):
            buf.copy_(t)

    def run(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Copy `inputs` in, reset the carry, replay every step; returns the
        carry buffers (overwritten by the program's next run)."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t, non_blocking=True)
        self._reset()
        for sig in self.order:
            graph, shapes = self.graphs[sig]
            graph.replay()
            stats["replays"] += 1
            tridiag_pcr.launched(shapes)
        return self.carry
