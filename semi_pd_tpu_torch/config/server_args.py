"""Server configuration (trimmed copy of semi_pd_tpu/config/server_args.py).

Keeps the ServerArgs fields the main serving path reads (memory sizing,
bucket tables, the colocated and semi-PD scheduling knobs, the overlap
ring, the KV dtype and its fp8 scales, speculative decoding: NGRAM, and
EAGLE and NEXTN chain and tree; constrained decoding, custom logit
processors and embedding mode) with the JAX package's defaults and
comments' meaning, and adds ``device`` and ``decode_stream`` (the JAX
package's RPA_DECODE_STREAM environment switch as an argument). A draft
checkpoint is refused by the runner (ROADMAP A13). The CLI,
HTTP, LoRA, parallelism and weight quantization flags belong to later
slices of the port (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

KV_CACHE_DTYPES = ("auto", "bfloat16", "float32", "fp8_e4m3", "fp8_e5m2")
SPECULATIVE_ALGORITHMS = (None, "EAGLE", "NEXTN", "NGRAM")


@dataclasses.dataclass
class ServerArgs:
    model_path: str = ""
    context_length: Optional[int] = None
    allow_auto_truncate: bool = False
    kv_cache_dtype: str = "auto"  # auto (model dtype) | bfloat16 | float32 | fp8_e4m3 | fp8_e5m2
    # Calibrated per-layer fp8-KV scales (JSON; runtime/model_runner.py
    # _load_kv_cache_scales), applied outside the kernels by linearity
    quantization_param_path: Optional[str] = None
    random_weights: bool = False  # random-init from ``seed`` (tests/bench)
    seed: int = 0
    # Where the model, the KV pool and every step run: "cuda" unless the
    # caller asks for "cpu" (the CPU tests). Never chosen by fallback.
    device: str = "cuda"

    # Memory / KV cache
    mem_fraction_static: Optional[float] = None
    max_total_tokens: Optional[int] = None  # KV pool size in tokens
    page_size: int = 16
    max_running_requests: Optional[int] = None

    # Scheduling
    schedule_policy: str = "lpm"  # lpm | fcfs | lof | random | dfs-weight
    enable_mixed_chunk: bool = False
    num_continuous_decode_steps: Optional[int] = None
    # Serve pooling / encode only; the generation entry points refuse
    is_embedding: bool = False
    disable_overlap_schedule: bool = False
    # In-flight step ring: results are read back in one fused device->host
    # copy every ``overlap_depth`` steps (see Scheduler._ring)
    overlap_depth: int = 4
    adaptive_overlap_depth: bool = True
    max_overlap_depth: int = 256
    max_stall_ms: Optional[float] = None
    chunked_prefill_size: int = 2048
    disable_radix_cache: bool = False
    retract_decode_steps: int = 20

    # Semi-PD (phase-disaggregated computation, unified storage); the
    # meaning of each knob is documented on the JAX package's ServerArgs
    enable_semi_pd: bool = False
    decode_slo_ms: float = 50.0
    prefill_chunk_budget_tokens: Optional[int] = None
    semi_pd_prefill_share: float = 0.8
    semi_pd_max_cycle_stretch: float = 1.35
    semi_pd_stretch_grace_ms: float = 1.0
    semi_pd_queue_relief_ms: float = 500.0
    semi_pd_min_chunk_duty: float = 3.0

    # Decode batches take the pool's cross-request streaming decode
    # (ops/attention/rpa_stream.py; the JAX package's RPA_DECODE_STREAM=1,
    # with its default ring depth of 4 built in). A sliding window and the
    # 5D pool below head_dim 128 keep their own decode, as in JAX.
    decode_stream: bool = False

    # Static shape buckets: bound the set of (T, B, maxP) shapes per step
    decode_bs_buckets: Optional[List[int]] = None
    prefill_token_buckets: Optional[List[int]] = None

    decode_log_interval: float = 10.0  # seconds between decode-stats lines

    # Constrained decoding and custom logit processors
    # Grammar jump-forward: emit forced tokens without model forwards
    # (their KV back-filled by an extend). Disable to force one-step decoding.
    disable_jump_forward: bool = False
    # Disable the on-disk compiled-DFA cache (~/.cache/semi_pd_tpu_torch/grammar):
    # regex / schema -> DFA compilation for deep schemas costs seconds
    disable_outlines_disk_cache: bool = False
    # Override the bounded-whitespace regex inside JSON-schema grammars
    # (default [ \n\t]{0,4})
    constrained_json_whitespace_pattern: Optional[str] = None

    # Speculative decoding
    speculative_algorithm: Optional[str] = None  # EAGLE | NEXTN | NGRAM
    # drafts a round verifies: the chain's gamma, the tree's depth
    speculative_num_draft_tokens: int = 4
    # EAGLE tree drafting: >1 enables top-k tree speculation (greedy
    # requests; sampled requests fall back to chain drafts). The tree shape
    # is static: see speculative/tree.py default_tree_template.
    speculative_eagle_topk: int = 1
    # Skip the post-verify draft-extend refresh; outputs stay exact either
    # way, acceptance drops
    speculative_disable_draft_refresh: bool = False
    speculative_draft_model_path: Optional[str] = None
    # FR-Spec hot-token map (.pt/.json/.npy list of token ids): the EAGLE
    # draft head is sliced to this subset
    speculative_token_map: Optional[str] = None
    # Relaxed acceptance for sampled requests: a draft is also accepted
    # outright when its target probability exceeds threshold_single, and
    # the rejection-sampling accept probability is raised from p to
    # min(1, p / threshold_acc). Defaults (1.0) keep exact rejection
    # sampling; < 1.0 trades unbiasedness for speed.
    speculative_accept_threshold_single: float = 1.0
    speculative_accept_threshold_acc: float = 1.0

    def __post_init__(self):
        if self.device not in ("cuda", "cpu") and not self.device.startswith("cuda:"):
            raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', got {self.device!r}")
        if self.speculative_algorithm not in SPECULATIVE_ALGORITHMS:
            raise ValueError(f"speculative_algorithm {self.speculative_algorithm!r}: one of "
                             f"{SPECULATIVE_ALGORITHMS}")
        if not (0.0 < self.speculative_accept_threshold_single <= 1.0):
            raise ValueError("speculative_accept_threshold_single in (0, 1]")
        if not (0.0 < self.speculative_accept_threshold_acc <= 1.0):
            raise ValueError("speculative_accept_threshold_acc in (0, 1]")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}: one of "
                             f"{KV_CACHE_DTYPES}")
        if self.num_continuous_decode_steps is not None:
            self.overlap_depth = max(1, int(self.num_continuous_decode_steps))
            self.adaptive_overlap_depth = False  # user pinned the depth
        if self.decode_bs_buckets is None:
            self.decode_bs_buckets = [1, 2, 4, 8, 16, 32, 64, 128, 256]
        if self.prefill_token_buckets is None:
            buckets, b = [], 256
            while b < self.chunked_prefill_size:
                buckets.append(b)
                b *= 2
            buckets.append(self.chunked_prefill_size)
            self.prefill_token_buckets = buckets
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.chunked_prefill_size % self.page_size != 0:
            self.chunked_prefill_size = (
                (self.chunked_prefill_size + self.page_size - 1)
                // self.page_size * self.page_size
            )
