"""The schedule of the GQA streaming decodes' tensor-core kernel
(csrc/rpa_stream.cu rpa_stream_mma_kernel), on the CPU: its constants, which
Python (``rpa_stream.STREAM_TILE``, ``STREAM_NBUF``, ``STREAM_WARPS``,
``STREAM_BLOCKS_PER_SM`` per build, with bf16 and with fp8 KV) and the CUDA
source (its ``constexpr`` lines, for each build's head_dim: 64, 128 and
Gemma-2's 256) both state, and a plain Python statement of what each warp and block of the
persistent grid computes: the batch's KV tiles in one request-major
sequence, cut into equal contiguous shares, one per warp; segments of a
request written whole, merged between the warps of a block in warp order,
or left as float32 partials in the scratch and merged by the combine pass
in block order.

The statement is checked at the shapes of the card tests and of
chip_smoke.py's decode phase, with the block counts the wrapper computes
(``stream_blocks``, 132 SMs, bf16 and fp8 KV on both pools): every tile falls in exactly one share, shares
differ by at most one tile, each warp and block uses each of its two
partial slots at most once, and the wrapper's scratch holds every slot.
Then its merges, replayed in float64 on random scores, give each request's
full softmax (1e-12). This file imports no JAX.
"""

import math
import re

import numpy as np
import pytest

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import rpa_stream

# the GQA builds (the latent builds' schedule: tests/test_torch_mla_decode_split.py)
BUILDS = sorted(b for b in rpa_stream.STREAM_TILE if b not in rpa_stream.STREAM_MLA_DECODE)
# (build, fp8 KV): both pools take bf16 and fp8 KV
PLANS = [("rpa_decode_stream", False), ("rpa_decode_stream", True),
         ("rpa_decode_stream_aligned", False), ("rpa_decode_stream_aligned", True),
         ("rpa_decode_stream_aligned_256", False), ("rpa_decode_stream_aligned_256", True)]
WARPS = rpa_stream.STREAM_WARPS


def _head_dim(kernel) -> int:
    """The head_dim a GQA stream build instantiates (rpa_common.cuh):
    RPA_HEAD_DIM where the build sets it (256), else 128 on the 5D pool
    (-DRPA_ALIGNED), 64 on the chunked pool."""
    for d in kernel.defines:
        if d.startswith("RPA_HEAD_DIM="):
            return int(d.split("=")[1])
    return 128 if "RPA_ALIGNED" in kernel.defines else 64


def _source_constants(kernel) -> dict:
    """The ``constexpr int NAME = expr;`` lines of the kernel's source,
    evaluated in order for the build's head_dim (C's integer division),
    after the latent geometry's (rpa_mla.cuh, which the source includes)."""
    env = {**kernel.constants("rpa_mla.cuh"), "RPA_HEAD_DIM": _head_dim(kernel)}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 kernel.source.read_text(), re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def _stream_smem(head_dim: int, fp8: bool) -> int:
    """StreamLayout's shared memory of one block: 4 warps' rings (bf16 KV:
    4 stages of a padded bf16 K and V tile; fp8: 4 raw stages and two bf16
    tiles) and, at head_dim 256, each warp's padded 16-row Q tile."""
    tk = max(8, 1024 // head_dim)
    bf = 2 * tk * (head_dim + 8) * 2
    ring = 4 * (2 * tk * head_dim) + 2 * bf if fp8 else 4 * bf
    q_tile = 16 * (head_dim + 8) * 2 if head_dim > 128 else 0
    return WARPS * (ring + q_tile)


def test_stream_schedule_constants_match_the_source():
    """Each GQA stream build's warp tile (1024 / head_dim positions, and 8
    at 256, the least mma takes), ring depth, warps per block and blocks
    per SM with bf16 and with fp8 KV, as csrc/rpa_stream.cu states them for
    its head_dim, equal rpa_stream's; the blocks an SM holds fit its
    shared memory and one more would not (two and three below 256, one at
    256, where a warp's ring of 8-position tiles is 33 KB and still holds
    its two partials); the builds and the latent one share one entry
    signature (the decode's, then the plan)."""
    assert BUILDS == ["rpa_decode_stream", "rpa_decode_stream_aligned",
                      "rpa_decode_stream_aligned_256"]
    for build in BUILDS:
        c, hd = _source_constants(KERNELS[build]), _head_dim(KERNELS[build])
        assert c["STREAM_TK"] == rpa_stream.STREAM_TILE[build] == max(8, 1024 // hd), build
        assert c["STREAM_NBUF"] == rpa_stream.STREAM_NBUF == 4
        assert c["STREAM_WARPS"] == WARPS == c["STREAM_NT"] // 32
        per_sm = (c["STREAM_BLOCKS_PER_SM"], c["STREAM_BLOCKS_PER_SM_FP8"])
        assert per_sm == rpa_stream.STREAM_BLOCKS_PER_SM[build] == (
            (1, 1) if hd == 256 else (2, 3)), build
        for fp8, n in zip((False, True), per_sm):
            need = _stream_smem(hd, fp8) + 1024 + 128
            assert n * need <= 233472
            if hd == 256 or fp8:
                assert (n + 1) * need > 233472, (build, fp8)
            ring = need - 1152 - (WARPS * 16 * (hd + 8) * 2 if hd > 128 else 0)
            assert 2 * 16 * (hd + 2) * 4 <= ring // WARPS  # the two partials
    assert {KERNELS[n].argtypes == rpa_stream.STREAM_ARGTYPES
            for n in ("rpa_decode_stream", "rpa_decode_stream_aligned",
                      "rpa_decode_stream_aligned_256", "rpa_decode_stream_mla")} == {True}


def _tiles(kv_lens, max_kv, tk):
    return [-(-min(n, max_kv) // tk) if min(n, max_kv) > 0 else 0 for n in kv_lens]


def schedule(kv_lens, max_kv, tk, P):
    """The plain statement of one KV head's column of P blocks x 4 warps.

    Returns (bounds, warps, blocks, combines): bounds[v] = floor(v T / (4 P))
    for the 4 P + 1 share boundaries of the T-tile sequence; warps[v] the
    segments of warp v, each (request, first tile, end tile, destination)
    with destination "out" (the request whole in the warp), 0 (cut at the
    warp's first tile: slot 0, kept in the scratch until the warp's ring is
    idle) or 1 (cut at its last tile only: slot 1);
    blocks[p] its merges, each (request, [(warp, slot), ...], destination)
    with destination "out" or the block's scratch slot 0 or 1; combines the
    combine pass's merges, each (request, [(block, slot), ...])."""
    n = _tiles(kv_lens, max_kv, tk)
    first = np.concatenate([[0], np.cumsum(n)]).astype(int)
    T = int(first[-1])
    W = WARPS * P
    bounds = [v * T // W for v in range(W + 1)]

    def holder(s):  # (request holding tile s, its first tile), or None
        if s >= T:
            return None
        r = int(np.searchsorted(first, s, side="right") - 1)
        return r, int(first[r])

    warps = []
    for v in range(W):
        segs, s = [], bounds[v]
        while s < bounds[v + 1]:
            r, f = holder(s)
            end = min(f + n[r], bounds[v + 1])
            a, b = s - f, end - f
            dest = "out" if a == 0 and b == n[r] else (0 if a > 0 else 1)
            segs.append((r, a, b, dest))
            s = end
        warps.append(segs)

    blocks = []
    for p in range(P):
        sb = bounds[WARPS * p: WARPS * p + WARPS + 1]
        hold = [holder(s) for s in sb]
        cut = [h is not None and h[1] < s for h, s in zip(hold, sb)]
        merges, k = [], 0
        while k <= WARPS:
            if not cut[k]:
                k += 1
                continue
            r = hold[k][0]
            hi = k
            while hi < WARPS and cut[hi + 1] and hold[hi + 1][0] == r:
                hi += 1
            parts = [(WARPS * p + k - 1, 1)] if k >= 1 else []
            parts += [(WARPS * p + j, 0) for j in range(k, min(hi, WARPS - 1) + 1)
                      if sb[j] < sb[j + 1]]
            dest = "out" if k >= 1 and hi < WARPS else (0 if k == 0 else 1)
            if parts:  # none in a block without a tile
                merges.append((r, parts, dest))
            k = hi + 1
        blocks.append(merges)

    combines = []
    start = [WARPS * p for p in range(P + 1)]
    for p in range(P):
        A, Bp = bounds[start[p]], bounds[start[p + 1]]
        h = holder(A)
        if h is None or not h[1] < A or h[1] + n[h[0]] > Bp:
            continue
        r, f = h
        pf = f * P // T
        while pf + 1 < P and (pf + 1) * T // P <= f:
            pf += 1
        parts = [(pf, 1)] + [(b, 0) for b in range(pf + 1, p + 1)
                             if b * T // P < (b + 1) * T // P]
        combines.append((r, parts))
    return bounds, warps, blocks, combines


def _lens(rng, b, kv, zero_every=0):
    lens = rng.integers(kv // 2, kv + 1, size=b)
    lens[0] = kv
    if zero_every:
        lens[::zero_every] = 0
    return lens.tolist()


_rng = np.random.default_rng(0)
# (name, kv_lens, page-table positions, Hkv): the card tests' cases, a few
# odd ones, and chip_smoke.py's decode shapes with its ragged kv_lens
SHAPES = [
    ("b1_kv16384", [16384], 16384, 8),
    ("b3_1_9000_17", [1, 9000, 17], 9008, 8),
    ("b6_card", [33, 0, 260, 9, 77, 1], 272, 2),
    ("zero_rows_at_boundaries", [0, 64, 0, 0, 200, 0, 7, 0], 208, 2),
    ("all_zero", [0, 0, 0], 16, 8),
    ("one_tile", [3], 16, 8),
    ("fewer_tiles_than_warps", [5, 9, 2, 1, 15, 4], 16, 8),
    ("b200_card", [int(x) for x in _rng.integers(0, 301, size=200)], 304, 2),
    ("b16_kv8192", _lens(_rng, 16, 8192), 8192, 8),
    ("b64_kv1024", _lens(_rng, 64, 1024), 1024, 8),
    ("b128_kv2048", _lens(_rng, 128, 2048), 2048, 8),
    ("b64_kv1024_zero_rows", _lens(_rng, 64, 1024, zero_every=5), 1024, 8),
    ("past_the_page_table", [5000, 40, 3000], 2048, 8),
]


@pytest.mark.parametrize("build,fp8", PLANS, ids=[f"{b}-{'fp8' if f else 'bf16'}" for b, f in PLANS])
@pytest.mark.parametrize("name,kv_lens,max_kv,hkv", SHAPES, ids=[s[0] for s in SHAPES])
def test_stream_shares_cover_every_tile_once(build, fp8, name, kv_lens, max_kv, hkv):
    """With the wrapper's block count: the shares cut the tile sequence in
    order into 4 P contiguous ranges that differ by at most one tile; every
    tile of every request lies in exactly one warp's segments; a warp has
    at most one segment in each partial slot (0 first, 1 last), a block
    writes each scratch slot at most once, and the wrapper's scratch holds
    every warp's slot 0 and two slots of every block, with their
    descriptors, for every KV head."""
    tk = rpa_stream.STREAM_TILE[build]
    G, D = 4, _head_dim(KERNELS[build])
    B = len(kv_lens)
    P = rpa_stream.stream_blocks(build, B, hkv, max_kv, 132, fp8)
    bounds, warps, blocks, combines = schedule(kv_lens, max_kv, tk, P)
    n = _tiles(kv_lens, max_kv, tk)
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == sum(n) and (sizes >= 0).all()
    assert sizes.max() - sizes.min() <= 1
    seen = [[0] * k for k in n]
    for segs in warps:
        dests = [d for *_, d in segs]
        assert dests.count(0) <= 1 and dests.count(1) <= 1
        if 0 in dests:
            assert dests[0] == 0
        if 1 in dests:
            assert dests[-1] == 1
        for r, a, b, _ in segs:
            for t in range(a, b):
                seen[r][t] += 1
    assert all(c == 1 for row in seen for c in row)
    for merges in blocks:
        slots = [d for *_, d in merges if d != "out"]
        assert len(slots) == len(set(slots)) <= 2
    if P == 1:
        assert not combines and all(d == "out" for m in blocks for *_, d in m)
    # G rows of O, m and l: one slot per warp, two per block, and a
    # descriptor per block, for each KV head
    floats = rpa_stream.stream_scratch_floats(P, G * hkv, hkv, D)
    assert floats == hkv * (WARPS * P + 2 * P) * G * (D + 2) + 4 * P * hkv


def _segment(s, v, a, b):
    """(m, l, O) of scores s and values v over positions [a, b)."""
    m = s[a:b].max()
    p = np.exp(s[a:b] - m)
    return m, p.sum(), p @ v[a:b]


def _merge(parts):
    m = max(x[0] for x in parts)
    f = [math.exp(x[0] - m) for x in parts]
    return m, sum(fi * x[1] for fi, x in zip(f, parts)), sum(fi * x[2] for fi, x in zip(f, parts))


@pytest.mark.parametrize("build,fp8", PLANS, ids=[f"{b}-{'fp8' if f else 'bf16'}" for b, f in PLANS])
@pytest.mark.parametrize("name,kv_lens,max_kv,hkv", SHAPES, ids=[s[0] for s in SHAPES])
def test_stream_merges_give_the_full_softmax(build, fp8, name, kv_lens, max_kv, hkv):
    """The statement's merges replayed in float64, one output row per
    request: each warp's segments, the block merges in warp order (into the
    output or a scratch slot), then the combine pass in block order, give
    every request with a position its full softmax over [0, min(kv_len,
    max_kv)); each is written exactly once, and rows without a position are
    written by no merge (the kernel zero-fills them)."""
    tk = rpa_stream.STREAM_TILE[build]
    P = rpa_stream.stream_blocks(build, len(kv_lens), hkv, max_kv, 132, fp8)
    _, warps, blocks, combines = schedule(kv_lens, max_kv, tk, P)
    rng = np.random.default_rng(1)
    lim = [max(min(k, max_kv), 0) for k in kv_lens]
    s = [rng.normal(size=n) * 3 for n in lim]
    v = [rng.normal(size=(n, 3)) for n in lim]
    out, slot = {}, {}
    for w, segs in enumerate(warps):
        for r, a, b, dest in segs:
            part = _segment(s[r], v[r], a * tk, min(b * tk, lim[r]))
            if dest == "out":
                assert r not in out
                out[r] = part
            else:
                slot[("warp", w, dest)] = (r, part)
    for p, merges in enumerate(blocks):
        for r, parts, dest in merges:
            got = [slot.pop(("warp", w, k)) for w, k in parts]
            assert all(x[0] == r for x in got)
            merged = _merge([x[1] for x in got])
            if dest == "out":
                assert r not in out
                out[r] = merged
            else:
                slot[("block", p, dest)] = (r, merged)
    for r, parts in combines:
        got = [slot.pop(("block", b, k)) for b, k in parts]
        assert all(x[0] == r for x in got) and r not in out
        out[r] = _merge([x[1] for x in got])
    assert not slot, f"partials no merge read: {sorted(slot)}"
    assert sorted(out) == [r for r, n in enumerate(lim) if n > 0]
    for r, (m, l, o) in out.items():
        p = np.exp(s[r] - s[r].max())
        np.testing.assert_allclose(o / l, p @ v[r] / p.sum(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("build,fp8,B,hkv,max_kv,P", [
    ("rpa_decode_stream", False, 64, 8, 1024, 33),
    ("rpa_decode_stream", False, 16, 8, 8192, 33),
    ("rpa_decode_stream_aligned", False, 128, 8, 2048, 33),
    ("rpa_decode_stream_aligned", True, 128, 8, 2048, 49),
    ("rpa_decode_stream_aligned", True, 1, 8, 16384, 49),
    ("rpa_decode_stream_aligned", False, 6, 2, 272, 51),
    ("rpa_decode_stream", False, 1, 8, 16, 1),
    ("rpa_decode_stream_aligned", True, 3, 8, 16, 2),
    ("rpa_decode_stream", True, 64, 8, 1024, 49),
    ("rpa_decode_stream", True, 1, 8, 16, 1),
    ("rpa_decode_stream_aligned_256", False, 64, 8, 1024, 16),
    ("rpa_decode_stream_aligned_256", True, 64, 8, 1024, 16),
    ("rpa_decode_stream_aligned_256", False, 1, 8, 16, 1),
])
def test_stream_blocks_at_the_paths_shapes(build, fp8, B, hkv, max_kv, P):
    """With 8 KV heads on 132 SMs the grid is 33 x 8 blocks with bf16 KV
    (two per SM) and 49 x 8 with fp8 KV (three per SM), on either pool,
    whatever the batch; at head_dim 256 (Gemma-2-9B's 8 KV heads) 16 x 8,
    one per SM, either KV type;
    a batch whose page tables hold fewer tiles than 4 P warps takes fewer
    blocks."""
    assert rpa_stream.stream_blocks(build, B, hkv, max_kv, 132, fp8) == P
