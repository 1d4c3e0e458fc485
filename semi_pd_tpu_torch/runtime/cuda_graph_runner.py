"""Decode steps and speculating rounds replayed from CUDA graphs, one per
shape key: the card's counterpart of the JAX runner's compiled programs
(semi_pd_tpu/runtime/model_runner.py ``_step_packed_jit`` and
``_step_packed_chained_jit``, one XLA program per static (T, B, maxP,
NQB); ``_eagle_jit``, ``_eagle_tree_jit`` and ``_spec_step_jit``, one per
round shape; each compiled at first use).

``DecodeGraphs.step`` takes a decode step (T == B) of
``ModelRunner.step_packed_raw``, and of ``step_host`` / ``step_topk_host``
(the decode steps that carry a grammar mask, a logit bias, penalties or
top-k log-probs, as the JAX runner compiles ``_step_masked_jit`` and
``_step_topk_jit``). Its key is ``(B, maxP, NQB, all_greedy)``: the
shapes of the packed step, and whether every live row samples greedily,
which the eager step knows on the host and uses to skip the sampler's sort
(``ops/sampling.py``), so a graph holds the same launches as the eager step
of its batch; a step with a ``StepVariant`` other than ``PLAIN`` adds it
to the key. Each key owns static device buffers for the two packed vectors
of ``HostBatch.pack()``; a step copies the host vectors into them (the
same two host->device copies as the eager step) and, when chained, copies
the previous step's device tokens over the input ids at the head of the
int vector, so one graph serves the plain and the chained dispatch. A
variant's host arrays (the [B, V] bool mask or float32 bias, the [B, H]
penalty histogram) go to static buffers shared by every key of their shape
and type, one copy each. The captured body is the runner's eager ``_step``
over ``_unpack_fb``'s views of those buffers, the KV pool and the KV scales
being the tensors the eager step uses.

``RoundGraphs.round`` takes a speculating round of the runner
(``eagle_step``, ``eagle_tree_step``, ``spec_step`` and their ``_host``
forms): a chain or a tree round of the EAGLE or the NextN draft, or
NGRAM's verify. Its key, ``RoundShape``, holds what the round's launches
depend on: the round kind, the verify batch's packed shapes, all_greedy,
gamma or the tree's branching, the draft refresh and the FR-Spec hot
vocabulary (the hot head is a captured tensor). A key's static buffers are
the round's packed int vector (``HostBatch.pack()``'s, a tree's slot-order
positions and window starts included, then NGRAM's drafts and their
lengths) and float vector (the sampling parameters, then the float32
hidden states seeding the draft): two host->device copies a round, where
``to_device`` makes one per array. A round given on the device copies
each of its arrays into the views of those buffers instead. The captured
body is the runner's eager round (``ModelRunner._round_body``) over those
views. A round graph's outputs are (accept_len, next_tok, tokens,
next_hidden), NGRAM's the first two: the verify's float32 logits and the
round's window are freed at the capture's end, so the memory pool keeps
them for no key (at B 64 a tree verify's logits alone are 0.95 GB at a
128256-token vocabulary).

At a key's first use the body runs once eagerly on the capture stream
(building the kernels, setting their shared-memory attributes,
initialising cuBLAS; its launches are recorded and dropped), then is
captured, then replayed; the runner's generator is registered with every
graph and its state restored around the warm-up, so a replay draws what
the eager body would and advances the generator as it does. A replay
overwrites its graph's output tensors, while the scheduler's ring holds up
to ``max_overlap_depth`` steps' tokens and chains step N's tokens into step
N + 1, so every replay's outputs are copied into fresh tensors. The decode
and the round graphs share one backend and so one memory pool, which is
safe because they run one at a time on one stream and nothing returned
lives in it. A round's warm-up runs the round on the live pools, and the
replay runs it again: a round is idempotent over its pools (every window
slot it reads was written earlier in the same round; the prefix is only
read).

The capture and the replay are an injected ``backend``: ``CudaGraphBackend``
on the card; the CPU tests inject an object that runs the body eagerly
over the same static buffers. A failed capture or replay raises: nothing
runs the eager step or round in its place.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Hashable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from semi_pd_tpu_torch.kernels import add_launches, record_launches
from semi_pd_tpu_torch.ops.sampling import PenaltyArrays
from semi_pd_tpu_torch.runtime.batch import pack_len

Key = Tuple


class StepVariant(NamedTuple):
    """What a decode step carries besides its packed batch: ``mask``, None,
    "bool" (a grammar mask [B, V]) or "bias" (a float32 logit bias [B, V]);
    ``penalties``, a penalty histogram (three [B, H] arrays); ``top_k``, the
    k of its top-k log-probs (0: none)."""

    mask: Optional[str] = None
    penalties: bool = False
    top_k: int = 0


PLAIN = StepVariant()


def decode_key(shapes: Tuple[int, int, int, int], all_greedy: bool,
               variant: StepVariant = PLAIN) -> Key:
    """The graph key of a decode step's packed shapes (T, B, maxP, NQB):
    ``(B, maxP, NQB, all_greedy)``, and the variant after it when it is not
    ``PLAIN``."""
    T, B, maxP, NQB = shapes
    if T != B:
        raise ValueError(f"a decode graph takes T == B, got T {T}, B {B}")
    key = (B, maxP, NQB, bool(all_greedy))
    return key if variant == PLAIN else key + (variant,)


@dataclasses.dataclass(frozen=True)
class RoundShape:
    """The key of a round graph. ``kind``: "chain" (EAGLE or NextN chain),
    "tree" (their tree) or "ngram" (NGRAM's verify); the verify batch's
    packed shapes (T = B x rows a request); whether every live row samples
    greedily; ``spec``: gamma, or the tree's branching; the draft refresh,
    the FR-Spec hot vocabulary, and ``hidden``, the width of the states
    seeding the draft (0 for NGRAM)."""

    kind: str
    T: int
    B: int
    maxP: int
    NQB: int
    all_greedy: bool
    spec: Hashable
    refresh: bool = False
    hot: bool = False
    hidden: int = 0

    def n_ints(self) -> int:
        """The packed int vector: ``HostBatch.pack()``'s, a logits row per
        verify row, then NGRAM's drafts [B, gamma] and lengths [B]."""
        n = pack_len(self.T, self.B, self.maxP, self.NQB, n_logits=self.T,
                     tree=self.kind == "tree")
        return n + (self.B * (self.spec + 1) if self.kind == "ngram" else 0)

    def n_floats(self) -> int:
        """The six sampling arrays [B], then the hidden states [B, hidden]."""
        return self.B * (6 + self.hidden)


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
    extras: Tuple[torch.Tensor, ...] = ()  # a variant's static [B, ...] inputs
    handle: object = None  # the backend's graph
    outputs: Tuple[torch.Tensor, ...] = None  # overwritten by each replay
    tally: Dict[str, int] = None  # kernel launches one replay runs


class GraphCache:
    """Graphs by key over one backend; ``stats``: captures, capture
    seconds (warm-up included), replays."""

    def __init__(self, runner, backend):
        self.runner = runner
        self.backend = backend
        self.graphs: Dict[Hashable, _Graph] = {}
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        # static input buffers shared by every key, by (name, shape, dtype)
        self._shared: Dict[Tuple[str, Tuple[int, ...], torch.dtype], torch.Tensor] = {}

    def pool_bytes(self) -> int:
        """Bytes the graphs' memory pool holds (shared by every cache on
        the backend)."""
        return self.backend.pool_bytes()

    def clear(self) -> None:
        """Drop every graph (their memory returns to the shared pool): a
        tensor they captured, or a routing whose launches they hold, has
        changed."""
        self.graphs.clear()
        self._shared.clear()

    def run(self, key: Hashable, n_ints: int, n_floats: int,
            fill: Callable[..., None], body: Callable[..., tuple],
            extras: Sequence[Tuple[str, Tuple[int, ...], torch.dtype]] = ()) -> tuple:
        """``fill(ints, floats, *extra)`` writes the inputs into the key's
        static buffers (``extras``: the names, shapes and types of more
        inputs, buffers shared by every key), then the key's graph of ``body(ints,
        floats, *extra)`` (captured first if the key is new) replays.
        Returns fresh copies of its outputs."""
        with torch.inference_mode():
            g = self.graphs.get(key)
            new = g is None
            if new:
                dev = self.runner.device
                g = _Graph(ints=torch.empty(n_ints, dtype=torch.int32, device=dev),
                           floats=torch.empty(n_floats, dtype=torch.float32, device=dev),
                           extras=tuple(self._buffer(*e) for e in extras))
            fill(g.ints, g.floats, *g.extras)
            if new:
                self._capture(g, lambda: body(g.ints, g.floats, *g.extras))
                self.graphs[key] = g
            self.backend.replay(g.handle)
            add_launches(g.tally)
            self.stats["replays"] += 1
            return tuple(t.clone() for t in g.outputs)

    def _buffer(self, name: str, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """The static input buffer ``name`` of ``shape`` and ``dtype`` that
        every key shares: graphs replay one at a time on one stream, each
        right after its own fill (the name keeps two inputs of one graph
        apart)."""
        key = (name, shape, dtype)
        buf = self._shared.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, device=self.runner.device)
            self._shared[key] = buf
        return buf

    def _capture(self, g: _Graph, body: Callable) -> None:
        runner = self.runner
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


class DecodeGraphs(GraphCache):
    """The runner's decode graphs, by ``decode_key``."""

    def step(self, ints_np: np.ndarray, floats_np: np.ndarray, shapes, all_greedy: bool,
             prev_tokens: Optional[torch.Tensor] = None, vocab_mask: Optional[np.ndarray] = None,
             penalties: Optional[PenaltyArrays] = None, top_k: int = 0) -> tuple:
        """One decode step through its key's graph (captured first if the
        key is new). ``prev_tokens``: the chained input ids; ``vocab_mask``
        (a bool grammar mask or a float32 bias [B, V]), ``penalties`` (the
        numpy histogram [B, H]) and ``top_k`` make the step's variant.
        Returns fresh device (tokens [B] i32, logprobs [B] f32), and with a
        top-k (values [B, k] f32, ids [B, k] i32)."""
        variant = StepVariant(
            mask=None if vocab_mask is None else ("bool" if vocab_mask.dtype == bool else "bias"),
            penalties=penalties is not None, top_k=top_k)
        key = decode_key(shapes, all_greedy, variant)
        T, B, maxP, NQB = shapes
        runner = self.runner
        named = ([] if vocab_mask is None else [("mask", vocab_mask)]) + (
            [] if penalties is None else list(zip(PenaltyArrays._fields, penalties)))
        host_extras = [np.ascontiguousarray(a) for _, a in named]

        def fill(ints, floats, *extra):
            ints.copy_(torch.from_numpy(ints_np), non_blocking=True)
            floats.copy_(torch.from_numpy(floats_np), non_blocking=True)
            if prev_tokens is not None:
                ints[:B].copy_(prev_tokens)
            for dst, src in zip(extra, host_extras):
                dst.copy_(torch.from_numpy(src), non_blocking=True)

        def body(ints, floats, *extra):
            fb = runner._unpack_fb(ints, floats, T, B, maxP, NQB, B, all_greedy)
            if variant == PLAIN:
                return runner._step(fb)
            mask = extra[0] if variant.mask else None
            pen = PenaltyArrays(*extra[-3:]) if variant.penalties else None
            return runner._step(fb, vocab_mask=mask, penalties=pen, top_k=top_k)

        extras = [(n, a.shape, torch.from_numpy(a[:0]).dtype)
                  for (n, _), a in zip(named, host_extras)]
        return self.run(key, len(ints_np), len(floats_np), fill, body, extras)


class RoundGraphs(GraphCache):
    """The runner's speculating rounds, by ``RoundShape``: ``run(shape,
    fill, body)`` with the shape's buffer sizes."""

    def round(self, shape: RoundShape, fill, body) -> tuple:
        return self.run(shape, shape.n_ints(), shape.n_floats(), fill, body)
