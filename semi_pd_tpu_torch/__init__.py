"""semi_pd_tpu_torch — the PyTorch + CUDA port of semi_pd_tpu.

Same system (phase-disaggregated serving over one paged KV pool and one
copy of the weights, decode-owned admission) for a single NVIDIA H100. The
JAX package ``semi_pd_tpu`` is the reference this package is tested
against; nothing here imports it (or JAX). Host-side modules are trimmed
copies of their JAX-package counterparts; the Pallas attention kernels of
the ported paths (the chunked pool at head_dim 64, the aligned pool at
head_dim 128 with bf16, float32 or fp8 KV) are hand-written CUDA C++ under
``csrc/``.

Entry points (``runtime.engine.Engine``, ``runtime.model_runner.
ModelRunner``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a GPU and without that argument they raise.
"""

__version__ = "0.1.0"
