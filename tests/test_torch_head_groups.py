"""The head groups of the tensor-core GQA decodes and streams at G > 16
query heads per KV head (StarCoder's multi-query 48 at head_dim 128,
Falcon-7B's 71 at 64), on the CPU:

- the grid: ``rpa_packed.head_groups`` and the cut of each KV head's G
  heads into groups of at most 16 (csrc/rpa_decode_mma.cuh
  ``mma_head_group``, whose lines are evaluated here, with GROUPS past 16
  heads a KV head and without at or below), with
  ``decode_split_plan`` over those groups, cover every (request, query
  head, position) exactly once at G 1, 16, 17, 48 and 71; the streaming
  decode's scratch holds every group's rows (``group_rows``);
- the plain decode, stream and extend at G 48 on the 5D pool at head_dim
  128 and at G 71 with one KV head at 64 (Falcon-7B's 64-element slot
  row, the merged builds' pool) against the TPU kernels' GQA branches in
  interpret mode (_rpa_kernel_packed, _rpa_kernel_stream with
  RPA_DECODE_STREAM=1 on the JAX call only, _rpa_kernel; interpret mode
  runs them at head_dim 64 without the merged reroute) and against the JAX
  reference attention, which is what the JAX layer serves Falcon-7B's
  geometry with.

Tolerances: float32 2e-5 (an online softmax against a full one, the same
float32 arithmetic otherwise); bf16 1e-2 (both sides compute in float32
from the same bf16 inputs and round the output to bf16).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_pd_tpu.ops.attention.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa,
)
from semi_pd_tpu.ops.attention.reference import (
    ragged_paged_attention_reference as jax_reference,
)
from semi_pd_tpu.ops.attention.rpa_packed import (
    ragged_paged_attention_packed as jax_packed,
)
from semi_pd_tpu.runtime.forward_batch import build_attn_meta as jax_meta

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream
from semi_pd_tpu_torch.runtime.forward_batch import build_attn_meta

PS = 16
TYPES = {"float32": (np.float32, torch.float32, 2e-5),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ the grid
def _head_group_fn():
    """mma_head_group of csrc/rpa_decode_mma.cuh as a Python function: its
    four statements, C's integer division and conditional translated."""
    src = KERNELS["rpa_decode"].source.parent.joinpath("rpa_decode_mma.cuh").read_text()
    body = re.search(r"void mma_head_group\([^)]*\) \{\n(.*?)\n\}", src, re.S).group(1)
    lines = []
    for ln in body.strip().splitlines():
        ln = ln.strip().rstrip(";")
        parts = ln[len("const int "):].split(", ") if ln.startswith("const int ") else [ln]
        for part in parts:
            part = re.sub(r"= (\w+) \? (.+) : (.+)$", r"= (\2 if \1 else \3)", part)
            lines.append(part.replace("/", "//"))
    code = "def group(Hq, Hkv, hg, GROUPS):\n" + "".join(f"    {x}\n" for x in lines) + \
        "    return h, hq0, GB\n"
    env = {}
    exec(code, {"min": min}, env)  # noqa: S102
    return env["group"]


GROUP_FN = _head_group_fn()


def GROUP(hq, hkv, hg):  # noqa: N802
    """The group as the kernels cut it: their GROUPS instantiation past 16
    query heads a KV head, the one without at and below."""
    return GROUP_FN(hq, hkv, hg, hq // hkv > 16)
GEOMETRIES = [(8, 8), (16, 1), (17, 1), (32, 2), (48, 1), (96, 2), (71, 1), (142, 2)]


@pytest.mark.parametrize("hq,hkv", GEOMETRIES, ids=[f"{q}x{k}" for q, k in GEOMETRIES])
def test_head_groups_cut_each_kv_head_in_m16_tiles(hq, hkv):
    """Each KV head's G query heads are cut in order into groups of at most
    16 (all but the last whole), every query head in one group of its own
    KV head: one group a KV head at G <= 16, three at StarCoder's 48, five
    (16 x 4 + 7) at Falcon-7B's 71; ``head_groups`` counts them for every
    GQA decode and stream build."""
    G = hq // hkv
    n = rpa_packed.head_groups(KERNELS["rpa_decode_aligned"], hq, hkv)
    assert n == hkv * -(-G // 16)
    for name in ("rpa_decode", "rpa_decode_merged", "rpa_decode_aligned_256",
                 "rpa_decode_stream", "rpa_decode_stream_aligned"):
        assert rpa_packed.head_groups(KERNELS[name], hq, hkv) == n
    seen = []
    for hg in range(n):
        h, hq0, gb = GROUP(hq, hkv, hg)
        assert 0 < gb <= 16 and h * G <= hq0 and hq0 + gb <= (h + 1) * G
        seen += list(range(hq0, hq0 + gb))
        if hq0 + gb < (h + 1) * G:
            assert gb == 16
    assert seen == list(range(hq))
    if G <= 16:
        assert [GROUP(hq, hkv, hg) for hg in range(n)] == [(h, h * G, G) for h in range(hkv)]
        # the GROUPS arithmetic gives the same cut there
        assert [GROUP_FN(hq, hkv, hg, True) for hg in range(n)] == [
            GROUP(hq, hkv, hg) for hg in range(n)]
    if (hq, hkv) == (71, 1):
        assert [GROUP(hq, hkv, hg)[2] for hg in range(n)] == [16, 16, 16, 16, 7]
    assert rpa_packed.group_rows(hq, hkv) == min(G, 16)


SPLITS = [(64, 1024, 132), (8, 8192, 132), (1, 4096, 132), (32, 2048, 7)]


@pytest.mark.parametrize("B,max_kv,sms", SPLITS, ids=[f"b{b}-kv{k}-sm{s}" for b, k, s in SPLITS])
@pytest.mark.parametrize("hq,hkv,build", [(48, 1, "rpa_decode_aligned"),
                                          (71, 1, "rpa_decode_merged"),
                                          (17, 1, "rpa_decode_aligned"),
                                          (16, 1, "rpa_decode_aligned"),
                                          (8, 8, "rpa_decode")])
def test_decode_grid_covers_every_head_and_position_once(hq, hkv, build, B, max_kv, sms):
    """The packed decode's grid (n_split, head groups, B) with the plan the
    wrapper computes over the head groups: every (request, query head,
    position) under kv_len is computed by exactly one block, and each
    block's output rows (its split's scratch rows, or the output) are its
    group's alone. At G > 16 the plan counts the groups: more blocks a
    request, so fewer splits fill the card."""
    n_hg = rpa_packed.head_groups(KERNELS[build], hq, hkv)
    n_split, split_len = rpa_packed.decode_split_plan(build, B, n_hg, max_kv, sms)
    assert n_split * split_len >= max_kv
    if max_kv >= 2 * rpa_packed.SPLIT_MIN and n_hg > hkv:
        assert n_split <= rpa_packed.decode_split_plan(build, B, hkv, max_kv, sms)[0]
    rng = np.random.default_rng(B + hq)
    kv_lens = rng.integers(0, max_kv + 1, size=B)
    spans = {}  # (request, query head) -> the position ranges of its blocks
    rows = set()
    for split in range(n_split):
        for hg in range(n_hg):
            h, hq0, gb = GROUP(hq, hkv, hg)
            for b in range(B):
                s0, s1 = split * split_len, min(split * split_len + split_len, kv_lens[b])
                for r in range(gb):
                    row = (split * B + b) * hq + hq0 + r
                    assert row not in rows
                    rows.add(row)
                    if s1 > s0:
                        spans.setdefault((b, hq0 + r), []).append((s0, s1))
    for b in range(B):
        for head in range(hq):
            got = sorted(spans.get((b, head), []))
            ends = [0] + [e for _, e in got]
            assert [s for s, _ in got] == ends[:-1] and ends[-1] == kv_lens[b]


@pytest.mark.parametrize("hq,hkv", [(48, 1), (32, 8), (71, 1), (17, 1)])
def test_stream_scratch_holds_every_group(hq, hkv):
    """The streaming decode's scratch over the head groups: the CUDA layout
    (StreamScratch: per group, GS = min(G, 16) rows of every warp's slot 0
    and of two slots per block, then a descriptor per block) fits the
    wrapper's tensor exactly, and its largest row index a group writes
    (GB <= GS rows) stays inside it; at G <= 16 it is the earlier Hq-row
    scratch."""
    D, P, NW = 128, 66, rpa_stream.STREAM_WARPS
    hg_n = rpa_packed.head_groups(KERNELS["rpa_decode_stream_aligned"], hq, hkv)
    gs = rpa_packed.group_rows(hq, hkv)
    floats = rpa_stream.stream_scratch_floats(P, hg_n * gs, hg_n, D)
    nw, nb = hg_n * NW * P * gs, hg_n * P * 2 * gs
    assert floats == (nw + nb) * (D + 2) + 4 * hg_n * P
    for hg in range(hg_n):
        _, _, gb = GROUP(hq, hkv, hg)
        assert gb <= gs
        last_w = ((hg * NW * P + NW * (P - 1) + NW - 1) * gs + gb - 1)
        last_b = (((hg * P + P - 1) * 2 + 1) * gs + gb - 1)
        assert last_w < nw and last_b < nb
    if hq // hkv <= 16:
        assert floats == P * (6 * hq * (D + 2) + 4 * hkv)


# ------------------------------------------------- the plain attention
def _setup(seed, q_lens, kv_lens, hq, hkv, D, dtype, pad_T=0):
    """A one-layer 5D pool [1, 2, S, hkv, D] and queries [T, hq, D] in
    ``dtype`` (both sides rounded from the same float32 numbers), a shuffled
    page table and the lengths."""
    np_t, torch_t, _ = TYPES[dtype]
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    n_pages = [-(-k // PS) for k in kv_lens]
    total = sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((B, max(max(n_pages), 1) + 1), np.int32)
    used = 0
    for b, n in enumerate(n_pages):
        pt[b, :n] = perm[used:used + n]
        used += n
    pool = rng.normal(size=(1, 2, total * PS, hkv, D)).astype(np.float32)
    T = sum(q_lens) + pad_T
    q = rng.normal(size=(T, hq, D)).astype(np.float32)
    ql = np.asarray(q_lens, np.int64)
    kl = np.asarray(kv_lens, np.int64)
    return dict(jq=jnp.asarray(q, np_t), tq=_t(q).to(torch_t), jpool=jnp.asarray(pool, np_t),
                tpool=_t(pool).to(torch_t), pt=pt, q_lens=ql, kv_lens=kl, T=T)


def _close(out, ref, rows, tol):
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(jnp.asarray(ref, jnp.float32))[rows],
                               rtol=tol, atol=tol)


def _reference(d, scale):
    """The JAX reference attention over the same pool (each query row's
    request and position from the lengths)."""
    q_req, q_pos = [], []
    for b, (ql, kl) in enumerate(zip(d["q_lens"], d["kv_lens"])):
        q_req += [b] * int(ql)
        q_pos += list(range(int(kl) - int(ql), int(kl)))
    pad = d["T"] - len(q_req)
    return jax_reference(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]),
                         jnp.asarray(q_req + [0] * pad, jnp.int32),
                         jnp.asarray(q_pos + [0] * pad, jnp.int32),
                         jnp.asarray(d["kv_lens"], jnp.int32), page_size=PS, scale=scale)


# (query heads, KV heads, head_dim): StarCoder's multi-query 48 at 128;
# Falcon-7B's 71 over one KV head at 64
CASES = [(48, 1, 128, kind, dt) for kind in ("decode", "stream", "extend")
         for dt in TYPES] + [(71, 1, 64, kind, dt) for kind in ("decode", "extend")
                             for dt in TYPES]


@pytest.mark.parametrize("hq,hkv,D,kind,dtype", CASES,
                         ids=[f"G{q // k}-D{d}-{kd}-{t}" for q, k, d, kd, t in CASES])
def test_plain_attention_past_sixteen_heads_a_kv_head(hq, hkv, D, kind, dtype, monkeypatch):
    """The port's plain decode, stream and extend at G = 48 and 71 against
    the TPU kernels in interpret mode and the JAX reference attention; a
    row with kv_len 0 gives zeros, as do the extend's padding rows; at 71 /
    1 / 64 the routing takes the merged family (the 5D pool below head_dim
    128), which decodes packed under ``stream`` too, as the JAX routing."""
    scale = D ** -0.5
    tol = TYPES[dtype][2]
    if kind == "extend":
        q_lens, kv_lens = [9, 1, 4], [40, 17, 4]
        d = _setup(21, q_lens, kv_lens, hq, hkv, D, dtype, pad_T=3)
    else:
        q_lens, kv_lens = [1] * 3, [33, 0, 50]
        d = _setup(22, q_lens, kv_lens, hq, hkv, D, dtype)
    T, kvl = d["T"], d["kv_lens"].astype(np.int32)
    jmeta = jax_meta(d["q_lens"], d["kv_lens"], T)
    meta = build_attn_meta(d["q_lens"], d["kv_lens"], T)
    if kind == "decode":
        ref = jax_packed(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                         page_size=PS, scale=scale, rpb=2, kv_block=32, interpret=True)
        out = rpa_packed.ragged_paged_attention_packed(
            d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), page_size=PS, scale=scale)
    elif kind == "stream":
        with monkeypatch.context() as m:
            m.setenv("RPA_DECODE_STREAM", "1")
            m.setenv("RPA_STREAM_NBUF", "3")
            ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                          jmeta, page_size=PS, scale=scale, kv_block=16, interpret=True)
        out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                         page_size=PS, scale=scale, stream=True)
    else:
        ref = jax_rpa(d["jq"], d["jpool"], 0, jnp.asarray(d["pt"]), jnp.asarray(kvl),
                      jmeta, page_size=PS, scale=scale, interpret=True)
        out = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                         page_size=PS, scale=scale)
    assert out.shape == (T, hq, D) and out.dtype == d["tq"].dtype
    n = sum(q_lens)
    rows = slice(0, n) if kind == "extend" else kvl > 0
    _close(out, ref, rows, tol)
    _close(out, _reference(d, scale), rows, tol)
    if kind == "extend":
        assert not out[n:].any(), "bucket-padding rows must stay zero"
    else:
        assert not out[1].any(), "rows with kv_len == 0 must be zeros"
    if D == 64 and kind == "decode":  # the merged family decodes packed, stream or not
        again = rpa.ragged_paged_attention(d["tq"], d["tpool"], 0, _t(d["pt"]), _t(kvl), meta,
                                           page_size=PS, scale=scale, stream=True)
        assert torch.equal(again, out)
