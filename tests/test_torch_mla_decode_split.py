"""The schedule of the latent pool's tensor-core decodes, on the CPU:
csrc/rpa_mla_mma.cuh's block tile, shared by rpa_decode_mla.cu's
rpa_decode_mla_mma_kernel (the packed decode, split over blocks by
``rpa_packed.decode_split_plan``) and rpa_stream.cu's
rpa_stream_mla_mma_kernel (the streaming decode, each block an equal share
of the batch's tiles, ``rpa_stream.stream_blocks``), in both latent builds:
DeepSeek-V2's 576 / 512 and MiniCPM3's 288 / 256 (-DRPA_MLA_DL=288
-DRPA_MLA_DV=256, the _288 builds).

The tile's constants are stated twice, in the header (its ``constexpr``
lines, evaluated here with each build's defines) and in Python; the tests
hold them equal, then check what the kernels compute from them: the warps'
cuts of S's dims (9 k-steps each at 576; 4, 5, 4 and 5 at 288) and of V's
columns, the copy of a tile by the block's threads (a last round half idle
at 288), the banks of every ldmatrix, the shared-memory budget, the head
groups of at most 16 (16 / 16 / 8 at MiniCPM3's 40 heads), the split plan
at the decode buckets and chip_smoke.py's latent shapes (fixed chunks of
256 positions, whatever the batch), the stream's block shares of whole
chunks, the coverage of every (request, head, position) by the two grids,
and, replayed in numpy, the fixed-order sum of the warps' partial scores
and the two decodes' merges, which give the full softmax and, in float32,
the same floats for a request in either decode. This file imports no JAX.
"""

import math

import numpy as np
import pytest

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import rpa_packed, rpa_stream

# latent width -> (packed decode, stream) builds
BUILDS = {576: ("rpa_decode_mla", "rpa_decode_stream_mla"),
          288: ("rpa_decode_mla_288", "rpa_decode_stream_mla_288")}
WIDTHS = sorted(BUILDS, reverse=True)
SMS = 132  # an H100's SMs


def _constants(width: int) -> dict:
    """The ``constexpr int NAME = expr;`` lines of rpa_mla.cuh, then of
    rpa_mla_mma.cuh, evaluated in order with the packed build's defines
    (C's integer division); the stream build's give the same."""
    c, s = (KERNELS[n].constants("rpa_mla.cuh", "rpa_mla_mma.cuh") for n in BUILDS[width])
    assert {k: v for k, v in s.items() if k.startswith("MLA_")} == {
        k: v for k, v in c.items() if k.startswith("MLA_")}
    return c


C = {w: _constants(w) for w in WIDTHS}
CHUNK = C[576]["MLA_MMA_CHUNK"]
TK = C[576]["MLA_MMA_TK"]


def _ks_ranges(c: dict):
    """Each warp's k-steps of S, [ks0(w), ks0(w + 1)) (mla_ks0): MLA_MMA_KS
    each where the warps divide the row's k-steps, else in order with C's
    division."""
    warps, steps, ks = c["MLA_MMA_WARPS"], c["MLA_MMA_KSTEPS"], c["MLA_MMA_KS"]
    even = steps % warps == 0
    ks0 = [w * ks if even else w * steps // warps for w in range(warps + 1)]
    return [range(ks0[w], ks0[w + 1]) for w in range(warps)]


def test_constants_match_the_source():
    """The latent builds plan with the tile the header states: each packed
    decode's (step, blocks per SM) are (MLA_MMA_CHUNK,
    MLA_MMA_BLOCKS_PER_SM), its stream's share unit (a chunk) and blocks per
    SM the same, MLA_ROWS the m16 tile's rows; every latent build includes
    the header, the packed ones take the GQA decodes' entry (the split plan
    and a scratch), and the _288 builds name their geometry."""
    geometry = {576: (576, 512), 288: (288, 256)}
    for width in WIDTHS:
        c = C[width]
        decode, stream = BUILDS[width]
        assert (c["MLA_DL"], c["MLA_DV"]) == geometry[width]
        assert (c["MLA_MMA_ROWS"], c["MLA_MMA_WARPS"], c["MLA_MMA_NT"]) == (16, 4, 128)
        assert (c["MLA_MMA_TK"], c["MLA_MMA_CHUNK"]) == (TK, CHUNK) == (16, 256)
        assert rpa_packed.DECODE_SPLIT[decode] == (CHUNK, c["MLA_MMA_BLOCKS_PER_SM"])
        assert rpa_stream.STREAM_TILE[stream] == CHUNK
        assert rpa_stream.STREAM_MLA_DECODE[stream] == decode
        assert rpa_packed.MLA_ROWS == c["MLA_MMA_ROWS"]
        assert KERNELS[decode].argtypes == rpa_packed.SPLIT_DECODE_ARGTYPES
        assert KERNELS[stream].argtypes == rpa_stream.STREAM_ARGTYPES
        for name in (decode, stream):
            assert '#include "rpa_mla_mma.cuh"' in KERNELS[name].source.read_text()
            assert "RPA_P_F32" in KERNELS[name].defines
            assert (f"RPA_MLA_DL={width}" in KERNELS[name].defines) == (width != 576)
    assert rpa_packed.DECODE_MLA_KERNELS == {w: KERNELS[BUILDS[w][0]] for w in WIDTHS}
    assert rpa_stream.STREAM_MLA_KERNELS == {w: KERNELS[BUILDS[w][1]] for w in WIDTHS}
    assert (C[576]["MLA_MMA_BLOCKS_PER_SM"], C[288]["MLA_MMA_BLOCKS_PER_SM"]) == (2, 4)


@pytest.mark.parametrize("hq,groups", [(16, 1), (8, 1), (1, 1), (17, 2), (32, 2), (40, 3),
                                       (128, 8)])
def test_head_groups(hq, groups):
    """At most 16 query heads a block (one m16 tile): DeepSeek-V2-Lite's 16
    make one group, MiniCPM3's 40 three, DeepSeek-V2's 128 eight, in every
    latent build; the GQA builds keep their KV heads."""
    for names in BUILDS.values():
        for name in names:
            assert rpa_packed.head_groups(KERNELS[name], hq, 1) == groups
    assert rpa_packed.head_groups(KERNELS["rpa_decode_aligned"], 32, 8) == 8


def _group_heads(hq: int):
    """The heads of each group as the kernels take them: group h is [16 h,
    16 h + G), G = min(16, Hq - 16 h) (row0 = b Hq + 16 h)."""
    rows = rpa_packed.MLA_ROWS
    return [range(h * rows, h * rows + min(rows, hq - h * rows))
            for h in range(-(-hq // rows))]


@pytest.mark.parametrize("hq", [16, 17, 40, 48, 128])
def test_head_groups_cover_every_head_once_in_whole_tiles(hq):
    """The groups cover the Hq heads once, in order, each group at most one
    m16 tile and every group but the last a whole one (MiniCPM3's 40:
    16 / 16 / 8)."""
    groups = _group_heads(hq)
    assert [h for g in groups for h in g] == list(range(hq))
    assert all(len(g) == 16 for g in groups[:-1]) and 0 < len(groups[-1]) <= 16
    if hq == 40:
        assert [len(g) for g in groups] == [16, 16, 8]


@pytest.mark.parametrize("width", WIDTHS)
def test_warps_cut_s_dims_and_v_columns_once(width):
    """Each warp's Q fragments (rows gid, gid + 8; dims (ks0(w) + ks) 16 +
    8 (e >> 1) + 2 tig + {0, 1}) and K ldmatrix rows (positions l7 + l16,
    dims + l8) cover the 16 x MLA_DL of Q and of a K tile once over the
    four warps (9 k-steps each at 576; 4, 5, 4, 5 at 288, no warp past
    MLA_MMA_KS); each warp's O fragments (columns DW w + 8 d + 2 tig +
    {0, 1}) and V ldmatrix.trans rows (positions l7 + l8, dims DW w + 16 dp
    + l16) cover the 16 x MLA_DV of O and of V once, and no V read reaches
    the rope dims."""
    c = C[width]
    DL, DV, WARPS, DW = c["MLA_DL"], c["MLA_DV"], c["MLA_MMA_WARPS"], c["MLA_MMA_DW"]
    ranges = _ks_ranges(c)
    assert [len(r) for r in ranges] == {576: [9] * 4, 288: [4, 5, 4, 5]}[width]
    assert max(len(r) for r in ranges) == c["MLA_MMA_KS"]
    q = np.zeros((16, DL), int)
    k = np.zeros((TK, DL), int)
    o = np.zeros((16, DV), int)
    v = np.zeros((TK, DL), int)
    for w in range(WARPS):
        for lane in range(32):
            gid, tig, l7 = lane >> 2, lane & 3, lane & 7
            l8, l16 = ((lane >> 3) & 1) * 8, ((lane >> 4) & 1) * 8
            for ks in ranges[w]:
                for e in range(4):
                    col = ks * 16 + 8 * (e >> 1) + 2 * tig
                    q[gid + 8 * (e & 1), col:col + 2] += 1
                d0 = ks * 16 + l8  # this lane's row of an ldmatrix.x4
                k[l7 + l16, d0:d0 + 8] += 1
            for d in range(DW // 8):
                for e in range(4):
                    o[gid + 8 * (e >> 1), w * DW + 8 * d + 2 * tig + (e & 1)] += 1
            for dp in range(DW // 16):
                d0 = w * DW + dp * 16 + l16
                v[l7 + l8, d0:d0 + 8] += 1
    assert (q == 1).all() and (k == 1).all() and (o == 1).all()
    assert (v[:, :DV] == 1).all() and (v[:, DV:] == 0).all()


def _copy_map(c: dict):
    """(thread, round, row, chunk) of every vector MlaCopy moves: v = tid +
    128 k for k < MLA_MMA_NV, skipped at or past MLA_MMA_NVEC."""
    vpr, nv, nt = c["MLA_MMA_VPR"], c["MLA_MMA_NV"], c["MLA_MMA_NT"]
    for tid in range(nt):
        for kk in range(nv):
            vec = tid + kk * nt
            if vec < c["MLA_MMA_NVEC"]:
                yield (tid, kk) + divmod(vec, vpr)


@pytest.mark.parametrize("width", WIDTHS)
def test_block_copies_each_vector_of_a_tile_once(width):
    """Vector v = tid + 128 k of a tile (tid < 128, k < MLA_MMA_NV, v <
    MLA_MMA_NVEC) is chunk v % VPR of row v / VPR: every 16-byte chunk of
    the 16 latent rows is copied once, to a 16-byte aligned place inside its
    stage; 9 whole rounds at 576, 4.5 at 288 (the fifth round's threads
    64-127 idle)."""
    c = C[width]
    vpr, LD = c["MLA_MMA_VPR"], c["MLA_MMA_LD"]
    assert vpr * 16 == c["MLA_DL"] * 2 and c["MLA_MMA_NVEC"] == TK * vpr
    assert c["MLA_MMA_NVEC"] / c["MLA_MMA_NT"] == {576: 9, 288: 4.5}[width]
    seen = np.zeros((TK, vpr), int)
    dst = set()
    for _, _, row, chunk in _copy_map(c):
        seen[row, chunk] += 1
        off = row * LD * 2 + chunk * 16
        assert off % 16 == 0 and off + 16 <= c["MLA_MMA_STAGE"]
        dst.add(off)
    assert (seen == 1).all() and len(dst) == TK * vpr
    last = {t for t, kk, _, _ in _copy_map(c) if kk == c["MLA_MMA_NV"] - 1}
    assert set(range(c["MLA_MMA_NT"])) - last == (set() if width == 576 else set(range(64, 128)))


def _conflicts(c: dict, ld: int) -> int:
    """The largest number of rows of one 8x8 matrix (ldmatrix, K and V
    reads of every warp) that share a 16-byte group of banks, rows ld bf16
    elements apart."""
    worst = 1
    ranges, DW = _ks_ranges(c), c["MLA_MMA_DW"]
    for w in range(c["MLA_MMA_WARPS"]):
        for lane0 in range(0, 32, 8):
            rows = []
            for lane in range(lane0, lane0 + 8):
                l7, l8, l16 = lane & 7, ((lane >> 3) & 1) * 8, ((lane >> 4) & 1) * 8
                for ks in ranges[w]:  # K: position l7 + l16, dims + l8
                    rows.append(("k", ks, ((l7 + l16) * ld + ks * 16 + l8) * 2))
                for dp in range(DW // 16):  # V: position l7 + l8, dims + l16
                    rows.append(("v", dp, ((l7 + l8) * ld + w * DW + dp * 16 + l16) * 2))
            for kind in ("k", "v"):
                for step in {s for kd, s, _ in rows if kd == kind}:
                    addrs = [a for kd, s, a in rows if kd == kind and s == step]
                    assert len(addrs) == 8
                    groups = [(a // 16) % 8 for a in addrs]
                    worst = max(worst, max(groups.count(g) for g in set(groups)))
    return worst


@pytest.mark.parametrize("width", WIDTHS)
def test_padded_rows_are_free_of_ldmatrix_bank_conflicts(width):
    """With rows of MLA_MMA_LD = MLA_DL + 8 elements (1168 bytes at 576, 16
    mod 128; 592 at 288, 80 mod 128) the 8 rows of every K and V matrix
    fall on 8 different 16-byte groups of banks; unpadded rows (1152 bytes,
    0 mod 128, or 576, 64 mod 128) would put 8 or 4 on one."""
    c = C[width]
    LD, DL = c["MLA_MMA_LD"], c["MLA_DL"]
    assert LD == DL + 8 and (LD * 2) % 128 == {576: 16, 288: 80}[width]
    assert _conflicts(c, LD) == 1
    assert _conflicts(c, DL) == {576: 8, 288: 4}[width]


@pytest.mark.parametrize("width", WIDTHS)
def test_fp8_rows_take_the_bf16_copy_map_in_8_byte_vectors(width):
    """fp8 latent rows (MLA_DL bytes) in 16-byte vectors do not make a whole
    map (4.5 a thread at 576, 2.25 at 288). In 8-byte vectors a row is
    MLA_DL / 8, the bf16 map's count, so MlaCopy runs the bf16 map (vector
    v = tid + 128 k, k < MLA_MMA_NV, v < MLA_MMA_NVEC, is chunk v % VPR of
    row v / VPR): it reads every 8 bytes of the 16 fp8 rows once, at 8-byte
    aligned addresses, and writes each widened 16-byte bf16 chunk to the
    place the bf16 copy puts it, 18 registers of loads a thread at 576 and
    10 at 288; the source holds that map (8-byte __ldg loads, widen8_bf16)
    beside the bf16 one (cp.async)."""
    c = C[width]
    DL, LD, vpr, nv, nt = (c["MLA_DL"], c["MLA_MMA_LD"], c["MLA_MMA_VPR"], c["MLA_MMA_NV"],
                           c["MLA_MMA_NT"])
    assert (TK * DL // 16) % nt and (TK * DL // 16) / nt == {576: 4.5, 288: 2.25}[width]
    assert DL // 8 == vpr and (nv - 1) * nt < TK * vpr <= nv * nt
    read = np.zeros((TK, DL), int)
    dst = set()
    for _, _, row, chunk in _copy_map(c):
        src = row * DL + chunk * 8  # bytes of the tile's fp8 rows
        assert src % 8 == 0
        read[row, chunk * 8:chunk * 8 + 8] += 1
        dst.add(row * LD * 2 + chunk * 16)
    assert (read == 1).all()
    assert dst == {r * LD * 2 + ch * 16 for r in range(TK) for ch in range(vpr)}
    # the loads take registers, not shared memory: the block keeps the bf16
    # budget (test_shared_memory_budget); the launch bounds (128 threads,
    # MLA_MMA_BLOCKS_PER_SM blocks) leave a thread 255 registers at 576 and
    # 128 at 288, where Q and O take 20 and 32 (36 and 64 at 576)
    regs = nv * 8 // 4  # registers of a thread's loads
    assert regs == {576: 18, 288: 10}[width]
    cap = min(255, 65536 // (c["MLA_MMA_BLOCKS_PER_SM"] * nt))
    assert cap == {576: 255, 288: 128}[width]
    assert c["MLA_MMA_KS"] * 4 + c["MLA_MMA_DW"] // 2 + regs < cap
    src = (KERNELS[BUILDS[width][0]].source.parent / "rpa_mla_mma.cuh").read_text()
    assert "uint2 raw[WIDEN ? MLA_MMA_NV : 1]" in src
    assert "__ldg(reinterpret_cast<const uint2*>(src))" in src
    assert "widen8_bf16<TKV>(raw[k])" in src and "cp_async16_zfill(stage" in src


@pytest.mark.parametrize("width", WIDTHS)
def test_shared_memory_budget(width):
    """A block's 4 stages of 16 padded rows and its two buffers of S partials
    (a float4 per lane, n8 tile and warp) fit MLA_MMA_BLOCKS_PER_SM blocks
    in an SM's 228 KB (1 KB reserved per block, and the stream's few static
    bytes), and one more would not: 2 blocks of 82,944 bytes at 576, 4 of
    46,080 at 288."""
    c = C[width]
    smem, LD, WARPS = c["MLA_MMA_SMEM"], c["MLA_MMA_LD"], c["MLA_MMA_WARPS"]
    stage = {576: 18688, 288: 9472}[width]
    assert c["MLA_MMA_STAGE"] == TK * LD * 2 == stage
    assert c["MLA_MMA_XCHG"] == 2 * WARPS * (TK // 8) * 32 * 16 == 8192
    assert smem == c["MLA_MMA_NST"] * stage + 8192 == {576: 82944, 288: 46080}[width]
    blocks = c["MLA_MMA_BLOCKS_PER_SM"]
    assert blocks == {576: 2, 288: 4}[width]
    assert smem <= 227 * 1024
    assert blocks * (smem + 1024 + 128) <= 228 * 1024
    assert (blocks + 1) * (smem + 1024) > 228 * 1024


# (B, max_kv): DeepSeek-V2-Lite's and MiniCPM3's decode buckets 8/32/64 at
# their serving page tables (the smoke run's prompts reach 3136 positions)
# and at 8192, chip_smoke.py's latent decode shapes b64 x kv1024, b16 x
# kv4096, b128 x kv2048 and its mask cases' b16 x kv2048, the card tests'
# b16 x kv4112, a page table of one page and none
PLAN_SHAPES = [(8, 3136), (32, 3136), (64, 3136), (8, 8192), (32, 8192), (64, 8192),
               (64, 1024), (16, 4096), (128, 2048), (16, 2048), (16, 4112), (1, 16), (1, 0)]
# (latent width, Hq): DeepSeek-V2-Lite's 16 and DeepSeek-V2's 128 heads at
# 576, MiniCPM3's 40 at 288
GEOMETRIES = [(576, 16), (576, 128), (288, 40)]
GEO_IDS = [f"w{w}-hq{h}" for w, h in GEOMETRIES]


@pytest.mark.parametrize("width,hq", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("B,max_kv", PLAN_SHAPES, ids=[f"b{b}-kv{k}" for b, k in PLAN_SHAPES])
def test_split_plan_covers_every_position_once_at_fixed_chunks(B, max_kv, width, hq):
    """The latent plan cuts [0, maxP * page_size) in order into ranges that
    cover every position once, none empty, each one of the tile's fixed
    chunks of 256 positions, whatever the batch, the head groups (1 at 16
    heads, 3 at 40) or the card: a request's chunks are the same in every
    batch."""
    decode = BUILDS[width][0]
    groups = rpa_packed.head_groups(KERNELS[decode], hq, 1)
    n, length = rpa_packed.decode_split_plan(decode, B, groups, max_kv, SMS)
    assert length == CHUNK == 256 and n == max(1, -(-max_kv // CHUNK))
    ranges = [(s * length, min((s + 1) * length, max_kv)) for s in range(n)]
    assert [p for a, b in ranges for p in range(a, b)] == list(range(max_kv))
    assert max_kv == 0 or all(b > a for a, b in ranges)
    assert all(a % CHUNK == 0 for a, _ in ranges)
    assert rpa_packed.decode_split_plan(decode, 1, 1, max_kv, 7) == (n, length)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("B,max_kv,plan", [(64, 1024, (4, 256)), (16, 4096, (16, 256)),
                                           (128, 2048, (8, 256)), (8, 3136, (13, 256))])
def test_split_plan_at_the_latent_shapes(B, max_kv, plan, width):
    """b64 x kv1024 and b16 x kv4096 take 256 blocks a head group, about
    the card's 264 block slots at 576 (two an SM on 132 SMs; MiniCPM3's
    three groups take 768 of 528 at four an SM); b128 x kv2048 1024, 3.9
    rounds of them; bucket 8 at 3136 positions 104."""
    assert rpa_packed.decode_split_plan(BUILDS[width][0], B, 1, max_kv, SMS) == plan


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


@pytest.mark.parametrize("width,hq", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("name,kv_lens,max_kv", STREAM_SHAPES, ids=[s[0] for s in STREAM_SHAPES])
def test_stream_block_shares_cover_every_chunk_once(name, kv_lens, max_kv, width, hq):
    """With the wrapper's block count for the build and the head groups:
    the shares cut the chunk sequence in order into P contiguous ranges that
    differ by at most one chunk; every chunk of every request lies in
    exactly one block's share; a request of one chunk is written by its
    block, every chunk of a longer one fills its own slot of the scratch,
    which the wrapper sizes as the packed decode's split scratch (a partial
    per chunk of the page table and row)."""
    decode, stream = BUILDS[width]
    groups = rpa_packed.head_groups(KERNELS[stream], hq, 1)
    P = rpa_stream.stream_blocks(stream, len(kv_lens), groups, max_kv, SMS)
    bounds, work = stream_schedule(kv_lens, max_kv, P)
    n = _chunks(kv_lens, max_kv)
    sizes = np.diff(bounds)
    assert bounds[-1] == sum(n) and sizes.max() - sizes.min() <= 1
    done = [(r, c) for share in work for r, c, _ in share]
    assert sorted(done) == [(r, c) for r, k in enumerate(n) for c in range(k)]
    assert len(set(done)) == len(done)
    n_chunk, _ = rpa_packed.decode_split_plan(decode, len(kv_lens), groups, max_kv, SMS)
    assert all(c < n_chunk for r, c in done)


@pytest.mark.parametrize("B,max_kv,P", [(64, 1024, 256), (16, 4096, 256), (128, 2048, 264),
                                        (16, 2048, 128), (1, 16, 1), (3, 16, 3)])
def test_stream_blocks_at_the_latent_shapes(B, max_kv, P):
    """576, one head group: two blocks an SM on 132 SMs (264), but no more
    than the batch's page tables hold chunks (B ceil(max_kv / 256)): 256 at
    b64 x kv1024 and b16 x kv4096, 264 at b128 x kv2048, 128 at the mask
    cases' b16 x kv2048."""
    assert rpa_stream.stream_blocks(BUILDS[576][1], B, 1, max_kv, SMS) == P


@pytest.mark.parametrize("B,max_kv,P", [(64, 1024, 176), (16, 4096, 176), (128, 2048, 176),
                                        (16, 2048, 128), (1, 16, 1), (3, 16, 3)])
def test_stream_blocks_at_the_latent_shapes_288(B, max_kv, P):
    """288 with MiniCPM3's three head groups: four blocks an SM on 132 SMs
    shared by the groups (176 each, 528 in all), no more than the batch's
    chunks."""
    assert rpa_stream.stream_blocks(BUILDS[288][1], B, 3, max_kv, SMS) == P


# (B, page-table positions, Hq) of the grid coverage: the latent shapes at
# both head counts, a batch with padded and page-table-overrunning rows
COVER_SHAPES = [(64, 1024, 16), (64, 1024, 40), (16, 4096, 40), (13, 208, 40), (3, 2048, 40)]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("B,max_kv,hq", COVER_SHAPES,
                         ids=[f"b{b}-kv{k}-hq{h}" for b, k, h in COVER_SHAPES])
def test_grids_cover_every_request_head_and_position_once(B, max_kv, hq, width):
    """Both decodes' grids, as the kernels index them, at the wrapper's plan
    and block count: the packed decode's block (split s, group h, request
    b) takes the heads [16 h, 16 h + G) over the positions [s 256, min(s
    256 + 256, kv_len)); the stream's block p of group h takes its share's
    chunks for the same heads. Each covers every (request, head, position
    < min(kv_len, max_kv)) exactly once and nothing else, 16 / 16 / 8 heads
    a group at Hq 40."""
    rng = np.random.default_rng(B + hq)
    kv_lens = rng.integers(0, max_kv + 300, size=B).tolist()
    kv_lens[0] = 0
    decode, stream = BUILDS[width]
    groups = rpa_packed.head_groups(KERNELS[decode], hq, 1)
    heads = _group_heads(hq)
    assert len(heads) == groups
    want = np.zeros((B, hq, max_kv), np.int8)
    for b, n in enumerate(kv_lens):
        want[b, :, :min(n, max_kv)] = 1
    n_split, split_len = rpa_packed.decode_split_plan(decode, B, groups, max_kv, SMS)
    packed = np.zeros_like(want)
    for s in range(n_split):
        for h in range(groups):
            for b, n in enumerate(kv_lens):
                lo, hi = s * split_len, min(s * split_len + split_len, n, max_kv)
                if hi > lo:
                    packed[b, heads[h].start:heads[h].stop, lo:hi] += 1
    assert np.array_equal(packed, want)
    P = rpa_stream.stream_blocks(stream, B, groups, max_kv, SMS)
    _, work = stream_schedule(kv_lens, max_kv, P)
    streamed = np.zeros_like(want)
    for h in range(groups):
        for share in work:
            for r, c, _ in share:
                lo, hi = c * CHUNK, min(c * CHUNK + CHUNK, kv_lens[r], max_kv)
                streamed[r, heads[h].start:heads[h].stop, lo:hi] += 1
    assert np.array_equal(streamed, want)


def _partial_scores(c, q, k):
    """Each warp's float32 partial S over its k-steps' dims (144 each at
    576; 64, 80, 64, 80 at 288), then their sum in warp order 0..3, as
    every warp adds them (mla_combine_pv)."""
    parts = [q[:, r.start * 16:r.stop * 16] @ k[:, r.start * 16:r.stop * 16].T
             for r in _ks_ranges(c)]
    s = parts[0].copy()
    for part in parts[1:]:
        s = (s + part).astype(np.float32)
    return s


@pytest.mark.parametrize("width", WIDTHS)
def test_warp_order_sum_of_partial_scores(width):
    """bf16 q and latent rows: the four warps' float32 partials added in warp
    order give the same floats to every warp (one order), within float32
    rounding of the float64 dot over all MLA_DL dims."""
    c = C[width]
    DL = c["MLA_DL"]
    rng = np.random.default_rng(2)
    bf = lambda x: (x.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)
    q = bf(rng.normal(size=(16, DL)) * 0.3)
    k = bf(rng.normal(size=(TK, DL)) * 0.3)
    s1, s2 = _partial_scores(c, q, k), _partial_scores(c, q, k)
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


def _decode_row(s, v, kv_len, max_kv, window=None, dt=np.float64, decode=BUILDS[576][0]):
    """The packed decode of one row: a block per chunk of the page table
    over [max(s0, lo), s1) in tiles from the multiple of 16 at or below,
    then the merge (one chunk of the page table: O / l directly)."""
    n_split, split_len = rpa_packed.decode_split_plan(decode, 1, 1, max_kv, SMS)
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


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("B,max_kv,window", [(16, 4096, None), (64, 1024, None),
                                             (16, 4096, 1000), (8, 3136, 700)])
def test_split_merges_give_the_full_softmax(B, max_kv, window, width):
    """The packed decode's chunk partials, merged in chunk order, give every
    row the full softmax over [lo, kv_len) (float64, 1e-12); the window's
    low edge falls inside a chunk; chunks past kv_len or below lo add
    nothing; a row with kv_len 0 has no partial with l > 0 (the kernel
    writes zeros)."""
    rng = np.random.default_rng(3)
    for kv_len in rng.integers(1, max_kv + 1, size=B).tolist() + [0]:
        s = rng.normal(size=max_kv) * 3
        v = rng.normal(size=(max_kv, 4))
        out = _decode_row(s, v, kv_len, max_kv, window, decode=BUILDS[width][0])
        if kv_len == 0:
            assert out is None
            continue
        lo = max(kv_len - window, 0) if window else 0
        p = np.exp(s[lo:kv_len] - s[lo:kv_len].max())
        np.testing.assert_allclose(out, p @ v[lo:kv_len] / p.sum(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name,kv_lens,max_kv", STREAM_SHAPES, ids=[s[0] for s in STREAM_SHAPES])
def test_stream_and_packed_decode_agree_bit_for_bit(name, kv_lens, max_kv, width):
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
        packed = _decode_row(s, v, n, max_kv, dt=np.float32, decode=BUILDS[width][0])
        stream = _stream_row(s, v, n, max_kv, dt=np.float32)
        assert packed.dtype == stream.dtype == np.float32
        assert np.array_equal(packed, stream), (kv_len, packed, stream)
        full = _stream_row(s.astype(np.float64), v.astype(np.float64), n, max_kv)
        p = np.exp(s[:n].astype(np.float64) - s[:n].max())
        np.testing.assert_allclose(full, p @ v[:n] / p.sum(), rtol=1e-12, atol=1e-12)
