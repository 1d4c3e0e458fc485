"""Named warmup registry (port of semi_pd_tpu/utils/warmup.py).

A ``@warmup("name")`` decorator registry plus ``execute_warmups(names,
engine)``, run against the in-process Engine. On the card a warmup's job
is to capture the graphs before traffic arrives: the first decode step at
a new (B, maxP) key, and the first speculating round at a new round key,
runs a warm-up and a capture (runtime/cuda_graph_runner.py), as the first
JAX step or round at a new bucket pays its XLA compile. ``all_buckets``
serves every prefill token bucket and every decode batch bucket up to
``max_running_requests``, so each decode bucket is captured at the
smallest maxP bucket; on a speculating runner the decode batches
speculate (two greedy tokens: the prefill's and one round), so each
bucket's greedy round is captured instead (the tree round where the
runner has a tree). Other maxP buckets, and sampling rounds, are captured
at first use. On the CPU the same requests run eagerly.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List

from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

logger = logging.getLogger(__name__)

_warmup_registry: Dict[str, Callable] = {}


def warmup(name: str) -> Callable:
    def decorator(fn: Callable) -> Callable:
        _warmup_registry[name] = fn
        return fn

    return decorator


def execute_warmups(names: List[str], engine) -> None:
    for name in names:
        fn = _warmup_registry.get(name)
        if fn is None:
            logger.warning("Could not find custom warmup %r (known: %s)",
                           name, sorted(_warmup_registry))
            continue
        t0 = time.monotonic()
        logger.info("Running warmup %s", name)
        fn(engine)
        logger.info("warmup %s done in %.1fs", name, time.monotonic() - t0)


@warmup("all_buckets")
def all_buckets(engine) -> None:
    """Serve every prefill token bucket and every decode batch bucket (the
    sweep of decode-graph captures over batch sizes; a speculating
    runner's round graphs)."""
    args = engine.server_args
    for t in args.prefill_token_buckets:
        prompt = [[1] * max(1, min(t, engine.runner.model_config.context_length - 8))]
        engine.generate(
            input_ids=prompt,
            sampling_params=SamplingParams(
                max_new_tokens=1, temperature=0.0, ignore_eos=True),
        )
    for b in args.decode_bs_buckets:
        if b > (args.max_running_requests or b):
            break
        engine.generate(
            input_ids=[[1, 2, 3, 4]] * b,
            sampling_params=SamplingParams(
                max_new_tokens=2, temperature=0.0, ignore_eos=True),
        )


@warmup("voice_chat")
def voice_chat(engine) -> None:
    """Short-prompt latency shape: the small prefill buckets with sampled
    decoding (the sampling decode graphs of batch bucket 1)."""
    for size in (8, 32, 128):
        engine.generate(
            input_ids=[list(range(1, size + 1))],
            sampling_params=SamplingParams(
                max_new_tokens=8, temperature=0.8, top_p=0.9, ignore_eos=True),
        )
