"""The split plan of the GQA decode builds' tensor-core kernel
(csrc/rpa_decode.cu rpa_decode_mma_kernel), on the CPU: every build of that
file (``rpa_decode``, the chunked pool at head_dim 64; ``rpa_decode_aligned``,
the 5D pool at head_dim 128; ``rpa_decode_aligned_256``, the 5D pool at
Gemma-2's head_dim 256; ``rpa_decode_merged``, the 5D pool at head_dim
64) takes the same entry point and a plan computed from the shapes, the
build and the SM count alone. The shapes are the 1B-class and 8B paths'
(Hkv 8) decode buckets 8/32/64 and the long-KV b16 x kv8192 case, and
TinyLlama's (Hkv 4). The plan's constants are stated twice, in Python
(``rpa_packed.DECODE_SPLIT``) and in the CUDA source (its ``constexpr``
lines); a test here evaluates the source's lines for each build's head_dim
and holds the two equal. This file imports no JAX.
"""

import re

import pytest

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import rpa_packed

# the GQA builds (the latent build's plan: tests/test_torch_mla_decode_split.py)
BUILDS = sorted(b for b in rpa_packed.DECODE_SPLIT if KERNELS[b].source.name == "rpa_decode.cu")

# (B, Hkv, maxP * page_size, SMs): the decode buckets 8/32/64 of the 1B-class
# and 8B paths at their 8192-token context on an H100's 132 SMs, b16 x
# kv8192 and the kernel phase's b64 x kv1024 and b128 x kv2048, TinyLlama's
# b16 x kv8192, a page table of one page, none, and a small card
SPLIT_SHAPES = [(8, 8, 8192, 132), (32, 8, 8192, 132), (64, 8, 8192, 132),
                (16, 8, 8192, 132), (64, 8, 1024, 132), (128, 8, 2048, 132),
                (16, 4, 8192, 132), (1, 8, 16, 132), (1, 8, 0, 132), (5, 1, 1000, 7)]


def _head_dim(kernel) -> int:
    """The head_dim a build instantiates (rpa_common.cuh): RPA_HEAD_DIM where
    the build sets it, else 128 on the 5D pool (-DRPA_ALIGNED), 64 on the
    chunked pool."""
    for d in kernel.defines:
        if d.startswith("RPA_HEAD_DIM="):
            return int(d.split("=")[1])
    return 128 if "RPA_ALIGNED" in kernel.defines else 64


def _source_constants(kernel) -> dict:
    """The ``constexpr int NAME = expr;`` lines of the kernel's source,
    evaluated in order for the build's head_dim (C's integer division)."""
    env = {"RPA_HEAD_DIM": _head_dim(kernel)}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 kernel.source.read_text(), re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


@pytest.mark.parametrize("B,Hkv,max_kv,sms", SPLIT_SHAPES,
                         ids=[f"b{b}-h{h}-kv{k}-sm{s}" for b, h, k, s in SPLIT_SHAPES])
@pytest.mark.parametrize("build", BUILDS)
def test_decode_split_plan_covers_every_position_once(build, B, Hkv, max_kv, sms):
    """Each build's plan cuts [0, maxP * page_size) into ranges that cover
    every position exactly once and in order, in whole rounds of the build's
    block (its step), with no empty split; with more than one split the
    blocks (B * Hkv * n_split) fill the card at most once over at the
    build's blocks per SM, and each split holds at least SPLIT_MIN
    positions."""
    step, blocks_per_sm = rpa_packed.DECODE_SPLIT[build]
    n, length = rpa_packed.decode_split_plan(build, B, Hkv, max_kv, sms)
    assert n >= 1 and length > 0 and length % step == 0
    ranges = [(s * length, min((s + 1) * length, max_kv)) for s in range(n)]
    assert [p for a, b in ranges for p in range(a, b)] == list(range(max_kv))
    assert max_kv == 0 or all(b > a for a, b in ranges)
    if n > 1:
        assert B * Hkv * n <= blocks_per_sm * sms
        assert length >= rpa_packed.SPLIT_MIN


@pytest.mark.parametrize("build,B,max_kv,plan", [
    ("rpa_decode", 16, 8192, (2, 4096)),
    ("rpa_decode", 8, 8192, (4, 2048)),
    ("rpa_decode", 64, 1024, (1, 1024)),
    ("rpa_decode_aligned", 16, 8192, (2, 4096)),
    ("rpa_decode_aligned", 8, 8192, (4, 2048)),
    ("rpa_decode_aligned", 64, 1024, (1, 1024)),
    ("rpa_decode_aligned", 128, 2048, (1, 2048)),
    ("rpa_decode_aligned_256", 16, 8192, (2, 4096)),
    ("rpa_decode_aligned_256", 64, 1024, (1, 1024)),
    ("rpa_decode_aligned_256", 64, 6016, (1, 6016)),
])
def test_decode_split_plan_at_the_8_kv_head_paths(build, B, max_kv, plan):
    """With Hkv 8 (the 1B-class, 8B and Gemma-2-9B paths): b16 x kv8192 is 128
    (request, KV head) pairs, so two splits each fill the card's 264 block
    slots (2 per SM on 132 SMs) once; b8 takes four; at b64 and b128 the
    pairs fill the card already and take one split."""
    assert rpa_packed.decode_split_plan(build, B, 8, max_kv, 132) == plan


def test_gqa_decode_builds_share_one_entry_and_the_source_constants():
    """The GQA decode builds of csrc/rpa_decode.cu, and the aligned build's
    ALiBi instantiation, are bound with one argtypes list (the split plan,
    a scratch pointer and ALiBi's slopes before the stream), and each
    build's (SD_STEP, SD_BLOCKS_PER_SM), as the source states them for its
    head_dim, equal rpa_packed.DECODE_SPLIT's; the step is 4 warps of SD_TK
    = 2048 / head_dim positions."""
    kernels = [KERNELS[b] for b in BUILDS]
    assert {k.source.name for k in kernels} == {"rpa_decode.cu"}
    assert all(k.argtypes == rpa_packed.SPLIT_DECODE_ARGTYPES for k in kernels)
    assert "rpa_decode_aligned_alibi" in BUILDS
    assert rpa_packed.SPLIT_DECODE_ARGTYPES[:-5] == rpa_packed.DECODE_ARGTYPES[:-1]
    for k in kernels:
        c = _source_constants(k)
        assert c["SD_TK"] == 2048 // _head_dim(k) and c["SD_WARPS"] == 4
        assert (c["SD_STEP"], c["SD_BLOCKS_PER_SM"]) == rpa_packed.DECODE_SPLIT[k.name], k.name
