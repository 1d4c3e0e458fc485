"""The schedule of the latent pool's tensor-core decodes, on the CPU:
csrc/rpa_mla_mma.cuh's block tile, shared by rpa_decode_mla.cu's
rpa_decode_mla_mma_kernel (the packed decode, split over blocks by
``rpa_packed.decode_split_plan``) and rpa_stream.cu's
rpa_stream_mla_mma_kernel (the streaming decode, each block an equal share
of the batch's tiles, ``rpa_stream.stream_blocks``).

The tile's constants are stated twice, in the header (its ``constexpr``
lines, evaluated here) and in Python; the tests hold them equal, then check
what the kernels compute from them: the warps' cuts of S's 576 dims and of
V's 512 columns, the copy of a tile by the block's threads, the banks of
every ldmatrix, the shared-memory budget, the split plan at DeepSeek-V2-
Lite's decode buckets and chip_smoke.py's latent shapes (fixed chunks of
256 positions, whatever the batch), the stream's block shares of whole
chunks, and, replayed in numpy, the fixed-order sum of the warps' partial
scores and the two decodes' merges, which give the full softmax and, in
float32, the same floats for a request in either decode. This file
imports no JAX.
"""

import math
import re

import numpy as np
import pytest

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream

DECODE = "rpa_decode_mla"
STREAM = "rpa_decode_stream_mla"
SMS = 132  # an H100's SMs


def _constants() -> dict:
    """The ``constexpr int NAME = expr;`` lines of rpa_mla.cuh, then of
    rpa_mla_mma.cuh, evaluated in order (C's integer division)."""
    env = {}
    csrc = KERNELS[DECODE].source.parent
    for header in ("rpa_mla.cuh", "rpa_mla_mma.cuh"):
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     (csrc / header).read_text(), re.M):
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


C = _constants()
TK, WARPS, LD = C["MLA_MMA_TK"], C["MLA_MMA_WARPS"], C["MLA_MMA_LD"]
DL, DV, ROWS = C["MLA_DL"], C["MLA_DV"], C["MLA_MMA_ROWS"]


def test_constants_match_the_source():
    """The latent builds plan with the tile the header states: the packed
    decode's (step, blocks per SM) are (MLA_MMA_CHUNK, MLA_MMA_BLOCKS_PER_SM),
    the stream's share unit (a chunk) and blocks per SM the same, MLA_ROWS
    the m16 tile's rows; both latent builds include the header, and the
    packed one takes the GQA decodes' entry (the split plan and a
    scratch)."""
    assert (DL, DV, ROWS, WARPS, C["MLA_MMA_NT"]) == (576, 512, 16, 4, 128)
    assert (TK, C["MLA_MMA_CHUNK"]) == (16, 256)
    assert rpa_packed.DECODE_SPLIT[DECODE] == (C["MLA_MMA_CHUNK"], C["MLA_MMA_BLOCKS_PER_SM"])
    assert rpa_stream.STREAM_TILE[STREAM] == C["MLA_MMA_CHUNK"]
    assert rpa_packed.MLA_ROWS == ROWS
    assert KERNELS[DECODE].argtypes == rpa_packed.SPLIT_DECODE_ARGTYPES
    assert KERNELS[STREAM].argtypes == rpa_stream.STREAM_ARGTYPES
    for name in (DECODE, STREAM):
        assert '#include "rpa_mla_mma.cuh"' in KERNELS[name].source.read_text()
        assert "RPA_P_F32" in KERNELS[name].defines


@pytest.mark.parametrize("hq,groups", [(16, 1), (8, 1), (1, 1), (17, 2), (32, 2), (128, 8)])
def test_head_groups(hq, groups):
    """At most 16 query heads a block (one m16 tile): DeepSeek-V2-Lite's 16
    make one group, DeepSeek-V2's 128 eight; the GQA builds keep their KV
    heads."""
    for name in (DECODE, STREAM):
        assert rpa_packed.head_groups(KERNELS[name], hq, 1) == groups
    assert rpa_packed.head_groups(KERNELS["rpa_decode_aligned"], 32, 8) == 8


def test_warps_cut_s_dims_and_v_columns_once():
    """Each warp's Q fragments (rows gid, gid + 8; dims (w KS + ks) 16 +
    8 (e >> 1) + 2 tig + {0, 1}) and K ldmatrix rows (positions l7 + l16,
    dims + l8) cover the 16 x 576 of Q and the 16 x 576 of a K tile once
    over the four warps; each warp's O fragments (columns 128 w + 8 d + 2
    tig + {0, 1}) and V ldmatrix.trans rows (positions l7 + l8, dims 128 w
    + 16 dp + l16) cover the 16 x 512 of O and of V once, and no V read
    reaches the rope dims."""
    KS, DW = C["MLA_MMA_KS"], C["MLA_MMA_DW"]
    q = np.zeros((16, DL), int)
    k = np.zeros((TK, DL), int)
    o = np.zeros((16, DV), int)
    v = np.zeros((TK, DL), int)
    for w in range(WARPS):
        for lane in range(32):
            gid, tig, l7 = lane >> 2, lane & 3, lane & 7
            l8, l16 = ((lane >> 3) & 1) * 8, ((lane >> 4) & 1) * 8
            for ks in range(KS):
                for e in range(4):
                    c = (w * KS + ks) * 16 + 8 * (e >> 1) + 2 * tig
                    q[gid + 8 * (e & 1), c:c + 2] += 1
                d0 = (w * KS + ks) * 16 + l8  # this lane's row of an ldmatrix.x4
                k[l7 + l16, d0:d0 + 8] += 1
            for d in range(DW // 8):
                for e in range(4):
                    o[gid + 8 * (e >> 1), w * DW + 8 * d + 2 * tig + (e & 1)] += 1
            for dp in range(DW // 16):
                d0 = w * DW + dp * 16 + l16
                v[l7 + l8, d0:d0 + 8] += 1
    assert (q == 1).all() and (k == 1).all() and (o == 1).all()
    assert (v[:, :DV] == 1).all() and (v[:, DV:] == 0).all()


def test_block_copies_each_vector_of_a_tile_once():
    """Vector v = tid + 128 k of a tile (tid < 128, k < MLA_MMA_NV) is chunk
    v % 72 of row v / 72: every 16-byte chunk of the 16 latent rows is
    copied once, to a 16-byte aligned place inside its stage."""
    vpr, nv, nt = C["MLA_MMA_VPR"], C["MLA_MMA_NV"], C["MLA_MMA_NT"]
    assert vpr * 16 == DL * 2
    seen = np.zeros((TK, vpr), int)
    dst = set()
    for tid in range(nt):
        for kk in range(nv):
            vec = tid + kk * nt
            row, chunk = divmod(vec, vpr)
            seen[row, chunk] += 1
            off = row * LD * 2 + chunk * 16
            assert off % 16 == 0 and off + 16 <= C["MLA_MMA_STAGE"]
            dst.add(off)
    assert (seen == 1).all() and len(dst) == TK * vpr


def _conflicts(ld: int) -> int:
    """The largest number of rows of one 8x8 matrix (ldmatrix, K and V
    reads of every warp) that share a 16-byte group of banks, rows ld bf16
    elements apart."""
    worst = 1
    for w in range(WARPS):
        for lane0 in range(0, 32, 8):
            rows = []
            for lane in range(lane0, lane0 + 8):
                l7, l8, l16 = lane & 7, ((lane >> 3) & 1) * 8, ((lane >> 4) & 1) * 8
                for ks in range(C["MLA_MMA_KS"]):  # K: position l7 + l16, dims + l8
                    rows.append(("k", ks, ((l7 + l16) * ld + (w * C["MLA_MMA_KS"] + ks) * 16
                                           + l8) * 2))
                for dp in range(8):  # V: position l7 + l8, dims + l16
                    rows.append(("v", dp, ((l7 + l8) * ld + w * 128 + dp * 16 + l16) * 2))
            for kind in ("k", "v"):
                for step in range(9):
                    addrs = [a for kd, s, a in rows if kd == kind and s == step]
                    if not addrs:
                        continue
                    assert len(addrs) == 8
                    groups = [(a // 16) % 8 for a in addrs]
                    worst = max(worst, max(groups.count(g) for g in set(groups)))
    return worst


def test_padded_rows_are_free_of_ldmatrix_bank_conflicts():
    """With rows of MLA_MMA_LD = 584 elements (1168 bytes, 16 mod 128) the 8
    rows of every K and V matrix fall on 8 different 16-byte groups of
    banks; unpadded rows (1152 bytes, 0 mod 128) would put all 8 on one."""
    assert LD == DL + 8 and (LD * 2) % 128 == 16
    assert _conflicts(LD) == 1
    assert _conflicts(DL) == 8


def test_fp8_rows_take_the_bf16_copy_map_in_8_byte_vectors():
    """fp8 latent rows (576 bytes) are 36 16-byte vectors, 576 a tile: 4.5
    for each of the 128 threads, no whole map. In 8-byte vectors a row is
    72, the bf16 map's count, so MlaCopy runs the bf16 map (vector v = tid +
    128 k, k < MLA_MMA_NV, is chunk v % 72 of row v / 72): it reads every 8
    bytes of the 16 fp8 rows once, at 8-byte aligned addresses, and writes
    each widened 16-byte bf16 chunk to the place the bf16 copy puts it, 18
    registers of loads a thread; the source holds that map (8-byte __ldg
    loads, widen8_bf16) beside the bf16 one (cp.async)."""
    vpr, nv, nt = C["MLA_MMA_VPR"], C["MLA_MMA_NV"], C["MLA_MMA_NT"]
    assert (TK * DL // 16) % nt and (TK * DL // 16) / nt == 4.5
    assert DL // 8 == vpr and nv * nt == TK * vpr
    read = np.zeros((TK, DL), int)
    dst = set()
    for tid in range(nt):
        for kk in range(nv):
            row, chunk = divmod(tid + kk * nt, vpr)
            src = row * DL + chunk * 8  # bytes of the tile's fp8 rows
            assert src % 8 == 0
            read[row, chunk * 8:chunk * 8 + 8] += 1
            dst.add(row * LD * 2 + chunk * 16)
    assert (read == 1).all()
    assert dst == {r * LD * 2 + c * 16 for r in range(TK) for c in range(vpr)}
    # the loads take registers, not shared memory: the block keeps the bf16
    # budget (test_shared_memory_budget), and with the 255 registers a thread
    # may take at MLA_MMA_BLOCKS_PER_SM blocks of 128 threads (the launch
    # bounds) two blocks still fit an SM's 65536
    assert nv * 8 // 4 == 18  # registers of a thread's loads
    assert C["MLA_MMA_BLOCKS_PER_SM"] * nt * 255 <= 65536
    src = (KERNELS[DECODE].source.parent / "rpa_mla_mma.cuh").read_text()
    assert "uint2 raw[WIDEN ? MLA_MMA_NV : 1]" in src
    assert "__ldg(reinterpret_cast<const uint2*>(src))" in src
    assert "widen8_bf16<TKV>(raw[k])" in src and "cp_async16_zfill(stage" in src


def test_shared_memory_budget():
    """A block's 4 stages of 16 padded rows and its two buffers of S partials
    (a float4 per lane, n8 tile and warp) fit MLA_MMA_BLOCKS_PER_SM = 2
    blocks in an SM's 228 KB (1 KB reserved per block, and the stream's
    few static bytes), and a third would not."""
    smem = C["MLA_MMA_SMEM"]
    assert C["MLA_MMA_STAGE"] == TK * LD * 2 == 18688
    assert C["MLA_MMA_XCHG"] == 2 * WARPS * (TK // 8) * 32 * 16 == 8192
    assert smem == C["MLA_MMA_NST"] * 18688 + 8192 == 82944
    blocks = C["MLA_MMA_BLOCKS_PER_SM"]
    assert smem <= 227 * 1024
    assert blocks * (smem + 1024 + 128) <= 228 * 1024
    assert (blocks + 1) * (smem + 1024) > 228 * 1024


# (B, max_kv): DeepSeek-V2-Lite's decode buckets 8/32/64 at its serving
# page tables (the smoke run's prompts reach 3136 positions) and at 8192,
# chip_smoke.py's latent decode shapes b64 x kv1024, b16 x kv4096, b128 x
# kv2048 and its mask cases' b16 x kv2048, the card tests' b16 x kv4112, a
# page table of one page and none
PLAN_SHAPES = [(8, 3136), (32, 3136), (64, 3136), (8, 8192), (32, 8192), (64, 8192),
               (64, 1024), (16, 4096), (128, 2048), (16, 2048), (16, 4112), (1, 16), (1, 0)]
CHUNK = C["MLA_MMA_CHUNK"]


@pytest.mark.parametrize("hq", [16, 128])
@pytest.mark.parametrize("B,max_kv", PLAN_SHAPES, ids=[f"b{b}-kv{k}" for b, k in PLAN_SHAPES])
def test_split_plan_covers_every_position_once_at_fixed_chunks(B, max_kv, hq):
    """The latent plan cuts [0, maxP * page_size) in order into ranges that
    cover every position once, none empty, each one of the tile's fixed
    chunks of 256 positions, whatever the batch, the head groups (1 at 16
    heads) or the card: a request's chunks are the same in every batch."""
    groups = rpa_packed.head_groups(KERNELS[DECODE], hq, 1)
    n, length = rpa_packed.decode_split_plan(DECODE, B, groups, max_kv, SMS)
    assert length == CHUNK == 256 and n == max(1, -(-max_kv // CHUNK))
    ranges = [(s * length, min((s + 1) * length, max_kv)) for s in range(n)]
    assert [p for a, b in ranges for p in range(a, b)] == list(range(max_kv))
    assert max_kv == 0 or all(b > a for a, b in ranges)
    assert all(a % CHUNK == 0 for a, _ in ranges)
    assert rpa_packed.decode_split_plan(DECODE, 1, 1, max_kv, 7) == (n, length)


@pytest.mark.parametrize("B,max_kv,plan", [(64, 1024, (4, 256)), (16, 4096, (16, 256)),
                                           (128, 2048, (8, 256)), (8, 3136, (13, 256))])
def test_split_plan_at_the_latent_shapes(B, max_kv, plan):
    """b64 x kv1024 and b16 x kv4096 take 256 blocks, about the card's 264
    block slots (two an SM on 132 SMs); b128 x kv2048 1024, 3.9 rounds of
    them; bucket 8 at 3136 positions 104."""
    assert rpa_packed.decode_split_plan(DECODE, B, 1, max_kv, SMS) == plan


def _chunks(kv_lens, max_kv):
    return [-(-min(n, max_kv) // CHUNK) if min(n, max_kv) > 0 else 0 for n in kv_lens]


def stream_schedule(kv_lens, max_kv, P):
    """The plain statement of one head group's column of P blocks: the
    batch's chunks, request-major, form C chunks; block p walks chunks [c_p,
    c_p+1), c_p = floor(p C / P). Returns (bounds, work): work[p] the
    block's chunks in order, each (request, chunk index, destination), the
    destination "out" for a request of one chunk, else "slot" (its partial
    in the scratch at that index, for the merge)."""
    n = _chunks(kv_lens, max_kv)
    seq = [(r, c) for r, k in enumerate(n) for c in range(k)]
    bounds = [p * len(seq) // P for p in range(P + 1)]
    work = [[(r, c, "out" if n[r] == 1 else "slot") for r, c in seq[bounds[p]:bounds[p + 1]]]
            for p in range(P)]
    return bounds, work


_rng = np.random.default_rng(0)


def _lens(b, kv, zero_every=0):
    lens = _rng.integers(kv // 2, kv + 1, size=b)
    lens[0] = kv
    lens[-1] = 0
    if zero_every:
        lens[::zero_every] = 0
    return lens.tolist()


# (name, kv_lens, page-table positions): the card tests' batches and
# chip_smoke.py's latent decode shapes with its ragged kv_lens
STREAM_SHAPES = [
    ("b1_kv16384", [16384], 16384),
    ("b3_1_9000_17", [1, 9000, 17], 9008),
    ("b6_card", [33, 0, 260, 9, 77, 1], 272),
    ("zero_rows_at_boundaries", [0, 64, 0, 0, 200, 0, 7, 0, 0, 48, 0, 16, 0], 208),
    ("fewer_chunks_than_blocks", [5, 9, 2, 1, 15, 4], 16),
    ("all_zero", [0, 0, 0], 16),
    ("b200_card", [int(x) for x in _rng.integers(0, 301, size=200)], 304),
    ("b64_kv1024", _lens(64, 1024), 1024),
    ("b16_kv4096", _lens(16, 4096), 4096),
    ("b128_kv2048", _lens(128, 2048), 2048),
    ("b64_kv1024_zero_rows", _lens(64, 1024, zero_every=5), 1024),
    ("past_the_page_table", [5000, 40, 3000], 2048),
]


@pytest.mark.parametrize("name,kv_lens,max_kv", STREAM_SHAPES, ids=[s[0] for s in STREAM_SHAPES])
def test_stream_block_shares_cover_every_chunk_once(name, kv_lens, max_kv):
    """With the wrapper's block count: the shares cut the chunk sequence in
    order into P contiguous ranges that differ by at most one chunk; every
    chunk of every request lies in exactly one block's share; a request of
    one chunk is written by its block, every chunk of a longer one fills its
    own slot of the scratch, which the wrapper sizes as the packed decode's
    split scratch (a partial per chunk of the page table and row)."""
    P = rpa_stream.stream_blocks(STREAM, len(kv_lens), 1, max_kv, SMS)
    bounds, work = stream_schedule(kv_lens, max_kv, P)
    n = _chunks(kv_lens, max_kv)
    sizes = np.diff(bounds)
    assert bounds[-1] == sum(n) and sizes.max() - sizes.min() <= 1
    done = [(r, c) for share in work for r, c, _ in share]
    assert sorted(done) == [(r, c) for r, k in enumerate(n) for c in range(k)]
    assert len(set(done)) == len(done)
    n_chunk, _ = rpa_packed.decode_split_plan(DECODE, len(kv_lens), 1, max_kv, SMS)
    assert all(c < n_chunk for r, c in done)


@pytest.mark.parametrize("B,max_kv,P", [(64, 1024, 256), (16, 4096, 256), (128, 2048, 264),
                                        (16, 2048, 128), (1, 16, 1), (3, 16, 3)])
def test_stream_blocks_at_the_latent_shapes(B, max_kv, P):
    """Two blocks an SM on 132 SMs (264), but no more than the batch's page
    tables hold chunks (B ceil(max_kv / 256)): 256 at b64 x kv1024 and b16 x
    kv4096, 264 at b128 x kv2048, 128 at the mask cases' b16 x kv2048."""
    assert rpa_stream.stream_blocks(STREAM, B, 1, max_kv, SMS) == P


def _partial_scores(q, k):
    """Each warp's float32 partial S over its 144 dims, then their sum in
    warp order 0..3, as every warp adds them (mla_combine_pv)."""
    w = DL // WARPS
    parts = [q[:, i * w:(i + 1) * w] @ k[:, i * w:(i + 1) * w].T for i in range(WARPS)]
    s = parts[0].copy()
    for part in parts[1:]:
        s = (s + part).astype(np.float32)
    return s


def test_warp_order_sum_of_partial_scores():
    """bf16 q and latent rows: the four warps' float32 partials added in warp
    order give the same floats to every warp (one order), within float32
    rounding of the float64 dot over all 576 dims."""
    rng = np.random.default_rng(2)
    bf = lambda x: (x.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)
    q = bf(rng.normal(size=(16, DL)) * 0.3)
    k = bf(rng.normal(size=(TK, DL)) * 0.3)
    s1, s2 = _partial_scores(q, k), _partial_scores(q, k)
    assert s1.dtype == np.float32 and np.array_equal(s1, s2)
    exact = q.astype(np.float64) @ k.astype(np.float64).T
    np.testing.assert_allclose(s1, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


def _online(s, v, lo, hi, first, end=None, dt=np.float64):
    """One block's walk in the log2 domain (p = 2^(s c - m c), c = log2 e
    with the scale folded into s), in dtype dt: tiles of TK from ``first``
    up to ``end`` (default hi), positions outside [lo, hi) masked; returns
    (m c, l, O) as the kernel stages it."""
    c = dt(math.log2(math.e))
    m, l, o = None, dt(0), np.zeros(v.shape[1], dt)
    for st in range(first, hi if end is None else end, TK):
        pos = np.arange(st, min(st + TK, len(s)))
        ok = (pos >= lo) & (pos < hi)
        if not ok.any():
            continue
        x = s[pos[ok]].astype(dt)
        m_new = x.max() if m is None else max(m, x.max())
        corr = dt(0) if m is None else np.exp2((m - m_new) * c).astype(dt)
        p = np.exp2((x - m_new) * c).astype(dt)
        l = (l * corr + p.sum(dtype=dt)).astype(dt)
        o = (o * corr + (p[:, None] * v[pos[ok]].astype(dt)).sum(0, dtype=dt)).astype(dt)
        m = m_new
    return (-math.inf if m is None else m * c), l, o


def _merge(parts, dt=np.float64):
    """rpa_mla_combine_kernel on one row: the max (m c) over the partials
    with l > 0, then l and O summed in chunk order (the factor exactly 1 at
    the max); O / l, or None where no partial saw a position."""
    live = [x for x in parts if x[1] > 0]
    if not live:
        return None
    m = max(x[0] for x in live)
    l, acc = dt(0), np.zeros_like(live[0][2])
    for mc, lc, oc in live:
        f = dt(1) if mc == m else np.exp2(dt(mc - m)).astype(dt)
        l = (l + lc * f).astype(dt)
        acc = (acc + oc * f).astype(dt)
    return acc / l


def _decode_row(s, v, kv_len, max_kv, window=None, dt=np.float64):
    """The packed decode of one row: a block per chunk of the page table
    over [max(s0, lo), s1) in tiles from the multiple of 16 at or below,
    then the merge (one chunk of the page table: O / l directly)."""
    n_split, split_len = rpa_packed.decode_split_plan(DECODE, 1, 1, max_kv, SMS)
    lo = max(kv_len - window, 0) if window else 0
    parts = []
    for sp in range(n_split):
        s0 = sp * split_len
        s1 = min(s0 + split_len, kv_len)
        first = max(s0, lo // TK * TK)
        parts.append(_online(s, v, lo, s1, first, dt=dt) if s1 > first else (-math.inf, 0, 0))
    return _merge(parts, dt)


def _stream_row(s, v, kv_len, max_kv, dt=np.float64):
    """The streaming decode of one row: each chunk walked by whichever block
    holds it, from the chunk's start against kv_len; one chunk written as
    O / l, more merged in chunk order."""
    n = min(kv_len, max_kv)
    parts = [_online(s, v, 0, n, c * CHUNK, min(c * CHUNK + CHUNK, n), dt)
             for c in range(_chunks([n], max_kv)[0])]
    if len(parts) == 1:
        return parts[0][2] / parts[0][1]
    return _merge(parts, dt)


@pytest.mark.parametrize("B,max_kv,window", [(16, 4096, None), (64, 1024, None),
                                             (16, 4096, 1000), (8, 3136, 700)])
def test_split_merges_give_the_full_softmax(B, max_kv, window):
    """The packed decode's chunk partials, merged in chunk order, give every
    row the full softmax over [lo, kv_len) (float64, 1e-12); the window's
    low edge falls inside a chunk; chunks past kv_len or below lo add
    nothing; a row with kv_len 0 has no partial with l > 0 (the kernel
    writes zeros)."""
    rng = np.random.default_rng(3)
    for kv_len in rng.integers(1, max_kv + 1, size=B).tolist() + [0]:
        s = rng.normal(size=max_kv) * 3
        v = rng.normal(size=(max_kv, 4))
        out = _decode_row(s, v, kv_len, max_kv, window)
        if kv_len == 0:
            assert out is None
            continue
        lo = max(kv_len - window, 0) if window else 0
        p = np.exp(s[lo:kv_len] - s[lo:kv_len].max())
        np.testing.assert_allclose(out, p @ v[lo:kv_len] / p.sum(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,kv_lens,max_kv", STREAM_SHAPES, ids=[s[0] for s in STREAM_SHAPES])
def test_stream_and_packed_decode_agree_bit_for_bit(name, kv_lens, max_kv):
    """Replayed in float32, as the kernels compute: for every request, the
    stream's chunk walk and merge and the packed decode's splits and merge
    give the same floats, whatever the batch and the block count (a
    request's chunks are fixed), and both hold the full softmax (float64
    replay, 1e-12)."""
    rng = np.random.default_rng(4)
    for kv_len in kv_lens:
        n = min(kv_len, max_kv)
        if n == 0:
            continue
        s = (rng.normal(size=max_kv) * 3).astype(np.float32)
        v = rng.normal(size=(max_kv, 3)).astype(np.float32)
        packed = _decode_row(s, v, n, max_kv, dt=np.float32)
        stream = _stream_row(s, v, n, max_kv, dt=np.float32)
        assert packed.dtype == stream.dtype == np.float32
        assert np.array_equal(packed, stream), (kv_len, packed, stream)
        full = _stream_row(s.astype(np.float64), v.astype(np.float64), n, max_kv)
        p = np.exp(s[:n].astype(np.float64) - s[:n].max())
        np.testing.assert_allclose(full, p @ v[:n] / p.sum(), rtol=1e-12, atol=1e-12)
