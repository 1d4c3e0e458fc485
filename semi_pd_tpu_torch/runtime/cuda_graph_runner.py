"""Decode steps replayed from CUDA graphs, one per decode shape key: the
card's counterpart of the JAX runner's compiled bucket programs
(semi_pd_tpu/runtime/model_runner.py ``_step_packed_jit`` and
``_step_packed_chained_jit``, one XLA program per static (T, B, maxP,
NQB), compiled at first use).

``DecodeGraphs.step`` takes a decode step (T == B) of
``ModelRunner.step_packed_raw``. Its key is ``(B, maxP, NQB, all_greedy)``:
the shapes of the packed step, and whether every live row samples
greedily, which the eager step knows on the host and uses to skip the
sampler's sort (``ops/sampling.py``), so a graph holds the same launches as
the eager step of its batch. Each key owns static device buffers for the
two packed vectors of ``HostBatch.pack()``; a step copies the host vectors
into them (the same two host->device copies as the eager step) and, when
chained, copies the previous step's device tokens over the input ids at
the head of the int vector, so one graph serves the plain and the chained
dispatch. The captured body is the runner's eager ``_step`` over
``_unpack_fb``'s views of those buffers, the KV pool and the KV scales
being the tensors the eager step uses.

At a key's first use the step runs once eagerly on the capture stream
(building the kernels, setting their shared-memory attributes,
initialising cuBLAS; its launches are recorded and dropped), then is
captured, then replayed; the runner's generator is registered with every
graph and its state restored around the warm-up, so a replay draws what
the eager step would and advances the generator as it does. A replay
overwrites its graph's output tensors, while the scheduler's ring holds up
to ``max_overlap_depth`` steps' tokens and chains step N's tokens into step
N + 1, so every replay's tokens and log-probs are copied into fresh
tensors. All graphs share one memory pool, which is safe because they run
one at a time on one stream and nothing returned lives in it.

The capture and the replay are an injected ``backend``: ``CudaGraphBackend``
on the card; the CPU tests inject an object that runs the body eagerly
over the same static buffers. A failed capture or replay raises: nothing
runs the eager step in its place.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from semi_pd_tpu_torch.kernels import add_launches, record_launches

Key = Tuple[int, int, int, bool]


def decode_key(shapes: Tuple[int, int, int, int], all_greedy: bool) -> Key:
    """The graph key of a decode step's packed shapes (T, B, maxP, NQB)."""
    T, B, maxP, NQB = shapes
    if T != B:
        raise ValueError(f"a decode graph takes T == B, got T {T}, B {B}")
    return B, maxP, NQB, bool(all_greedy)


class CudaGraphBackend:
    """Capture and replay on the card: ``torch.cuda.CUDAGraph``s captured
    on one side stream into one shared memory pool, each with the runner's
    generator registered."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device = device
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def pool_bytes(self) -> int:
        """Bytes the shared pool holds now: its segments in the caching
        allocator's snapshot (the pool is freed when its last graph goes)."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def warmup(self, body: Callable) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            body()
        current.wait_stream(self.stream)

    def capture(self, body: Callable):
        """Capture ``body``. A dropped runner's graphs live in a reference
        cycle (the runner holds its ``DecodeGraphs``, which hold the
        runner) until the collector frees them, and freeing a graph's
        memory inside another capture invalidates that capture: collect
        first, and hold the collector off until the capture ends."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = body()
        finally:
            if enabled:
                gc.enable()
        return graph, outputs

    def replay(self, graph) -> None:
        graph.replay()


@dataclasses.dataclass
class _Graph:
    ints: torch.Tensor  # static packed int vector
    floats: torch.Tensor  # static packed float vector
    handle: object = None  # the backend's graph
    outputs: Tuple[torch.Tensor, torch.Tensor] = None  # overwritten by each replay
    tally: Dict[str, int] = None  # kernel launches one replay runs


class DecodeGraphs:
    """The runner's decode graphs, by key; ``stats``: captures, capture
    seconds (warm-up included), replays."""

    def __init__(self, runner, backend):
        self.runner = runner
        self.backend = backend
        self.graphs: Dict[Key, _Graph] = {}
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0}

    def pool_bytes(self) -> int:
        """Bytes the graphs' memory pool holds."""
        return self.backend.pool_bytes()

    def clear(self) -> None:
        """Drop every graph (their memory returns to the shared pool): the
        runner's attention changed, and the graphs hold the old one's
        launches."""
        self.graphs.clear()

    def step(self, ints_np: np.ndarray, floats_np: np.ndarray, shapes, all_greedy: bool,
             prev_tokens: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step through its key's graph (captured first if the
        key is new). ``prev_tokens``: the chained input ids. Returns fresh
        device (tokens [B] i32, logprobs [B] f32)."""
        key = decode_key(shapes, all_greedy)
        B = key[0]
        with torch.inference_mode():
            g = self.graphs.get(key)
            new = g is None
            if new:
                dev = self.runner.device
                g = _Graph(ints=torch.empty(len(ints_np), dtype=torch.int32, device=dev),
                           floats=torch.empty(len(floats_np), dtype=torch.float32,
                                              device=dev))
            g.ints.copy_(torch.from_numpy(ints_np), non_blocking=True)
            g.floats.copy_(torch.from_numpy(floats_np), non_blocking=True)
            if prev_tokens is not None:
                g.ints[:B].copy_(prev_tokens)
            if new:
                self._capture(g, shapes, all_greedy)
                self.graphs[key] = g
            self.backend.replay(g.handle)
            add_launches(g.tally)
            self.stats["replays"] += 1
            tokens, logprobs = g.outputs
            return tokens.clone(), logprobs.clone()

    def _capture(self, g: _Graph, shapes, all_greedy: bool) -> None:
        T, B, maxP, NQB = shapes
        runner = self.runner

        def body():
            fb = runner._unpack_fb(g.ints, g.floats, T, B, maxP, NQB, B, all_greedy)
            return runner._step(fb)

        t0 = time.monotonic()
        state = runner.generator.get_state()
        with record_launches():  # the warm-up's launches are not a served step's
            self.backend.warmup(body)
        runner.generator.set_state(state)
        with record_launches() as tally:
            g.handle, g.outputs = self.backend.capture(body)
        runner.generator.set_state(state)
        g.tally = dict(tally)
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.monotonic() - t0
