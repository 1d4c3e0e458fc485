"""Weight quantization: the fp8 and AWQ int4 formats (ports of
semi_pd_tpu/ops/quant) and the weight-only dequant GEMM's wrappers
(wo_gemm.py)."""
