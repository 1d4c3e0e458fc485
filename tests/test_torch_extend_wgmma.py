"""The schedules of the two warpgroup (wgmma) extend kernels, on the CPU:
``rpa_extend_wgmma_kernel`` (csrc/rpa_extend.cu: every bf16-q pair of the
GQA builds, the aligned builds at head_dim 128 and 256 (Gemma-2's, Q read
by descriptor) and the chunked and merged builds at head_dim 64, each
head_dim with its own block shape) and
``rpa_extend_mla_wgmma_kernel`` (csrc/rpa_extend_mla.cu, the latent pool).
Each schedule is stated here in Python: which packed rows a block and each
of its consumer warpgroups own, which KV positions a block walks, how the
MLA kernel splits the 576 score dims and V's 512 columns between its two
warpgroups, the producer/consumer ring of the GQA kernel (its stages, the
lag of the fp8 widening, the barriers' phases), and the fp8 producer's
thread map. The tests then hold that, at shapes with q_len 1 to
2048, padding entries, windows and 1, 2, 4 or 8 query heads per KV head,
every (token, head) a work-list entry owns is written exactly once and
nothing else is, that every position a row may see is walked, that the
ring neither deadlocks nor refills a stage still being read. They also pin the
128-byte swizzle of the shared-memory tiles (csrc/rpa_wgmma.cuh) against
the rule the hardware applies, and the constants Python and the sources
share, by parsing the sources (as tests/test_torch_decode_split.py does).
This file imports no JAX.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest

from semi_pd_tpu_torch.kernels import KERNELS
from semi_pd_tpu_torch.ops.attention import ragged_paged_attention as rpa
from semi_pd_tpu_torch.runtime.forward_batch import make_attn_meta_host

CSRC = Path(rpa.__file__).resolve().parents[2] / "csrc"
SMEM_PER_BLOCK = 232448  # an H100 block's most shared memory (227 KB)


def _constants(*files, **env) -> dict:
    """The ``constexpr int NAME = expr;`` lines of the given sources, in
    order, evaluated with C's integer division (``env`` seeds the build's
    defines)."""
    for f in files:
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     (CSRC / f).read_text(), re.M):
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


GQA = _constants("rpa_extend.cu", EXTEND_QBLK=rpa.EXTEND_Q_BLOCK)
# the latent builds' constants by latent width, as each build compiles them
# (DeepSeek-V2's 576 / 512, MiniCPM3's 288 / 256: -DRPA_MLA_DL=288)
MLA_C = {w: k.constants("rpa_mla.cuh", "rpa_extend_mla.cu")
         for w, k in rpa.EXTEND_MLA_KERNELS.items()}
MLA = MLA_C[576]


def _layout(head_dim: int) -> dict:
    """rpa_extend.cu's WgLayout<TKV, head_dim> block shape: the WG_*
    constants at head_dim 128, the WG64_* ones at head_dim 64, the WG256_*
    ones at head_dim 256."""
    pre = {128: "WG_", 64: "WG64_", 256: "WG256_"}[head_dim]
    keys = ("NCW", "NT", "ROWS", "TK", "STAGES", "LAG", "PRODUCER_REGS", "CONSUMER_REGS")
    return {k: GQA[pre + k] for k in keys}


def _wgmma_fn(name: str, args: str):
    """A ``constexpr int name(args) { return expr; }`` of rpa_wgmma.cuh,
    read from the source as a Python function of the same arguments."""
    src = (CSRC / "rpa_wgmma.cuh").read_text()
    sig = r",\s*".join(rf"int {a}" for a in args.split())
    expr = re.search(rf"constexpr int {name}\({sig}\) \{{\s*return ([^;]+);", src).group(1)
    return lambda *v: eval(expr, {}, dict(zip(args.split(), v)))  # noqa: S307


SW128 = _wgmma_fn("sw128", "rows r c")
FP8_LANE = _wgmma_fn("fp8_lane", "p vpr")


# ---------------------------------------------------------------- swizzle
@pytest.mark.parametrize("rows,width", [(64, 128), (48, 576), (64, 576), (128, 128), (64, 64),
                                        (128, 64), (48, 320), (64, 320), (32, 256),
                                        (128, 256)],
                         ids=["gqa-kv-tile", "mla-latent-tile", "mla-q-tile", "gqa-128-rows",
                              "gqa-d64-kv-tile", "gqa-d64-128-rows", "mla288-latent-tile",
                              "mla288-q-tile", "gqa-d256-kv-tile", "gqa-d256-q-tile"])
def test_sw128_is_the_hardware_swizzle_and_a_bijection(rows, width):
    """Every 16-byte chunk c of row r lands where 128-byte swizzling puts it:
    column block c // 8 (rows x 128 bytes each, so each block starts on a
    1024-byte atom), row r at 128 r in it, and address bits 4-6 equal to
    the chunk's bits XOR address bits 7-9 (the rule of a TMA map with
    SWIZZLE_128B and of a wgmma descriptor in swizzle mode 1). The chunks
    of the tile fill its rows * width * 2 bytes exactly once (the 288-wide
    latent rows are staged in tiles of 5 whole column blocks, 320 wide)."""
    assert rows % 8 == 0
    seen = set()
    for r in range(rows):
        for c in range(width // 8):
            off = SW128(rows, r, c)
            block, inner = divmod(off, rows * 128)
            assert block == c // 8 and inner // 128 == r and off % 16 == 0
            assert (off >> 4) & 7 == (c & 7) ^ ((off >> 7) & 7)
            seen.add(off)
    assert seen == set(range(0, rows * width * 2, 16))


@pytest.mark.parametrize("width", [576, 288])
@pytest.mark.parametrize("rows", [48, 64])
def test_descriptor_steps_address_the_swizzled_chunks(rows, width):
    """The descriptors' arithmetic (desc_k, desc_mn) reaches the chunks the
    copies wrote, in both latent builds. K-major: k-step ks starts 32 ks
    bytes into its column block's row (32 (ks % 4) past block ks // 4), and
    the hardware, XORing the address of row r's chunk j (start + 128 r + 16
    j) by (r % 8), lands on sw128(rows, r, 2 ks + j). MN-major (V through
    the transpose bit): k-step kk starts 2048 kk bytes on, 8-row groups 1024
    bytes apart (SBO), 64-column blocks rows * 128 apart (LBO)."""
    def hw(start, r, j):  # the address the hardware reads, in a 1024-aligned tile
        a = start + 128 * r + 16 * j
        return a ^ (((a >> 7) & 7) << 4)

    c = MLA_C[width]
    for ks in range(c["MLA_DL"] // 16):
        start = (ks >> 2) * rows * 128 + (ks & 3) * 32
        for r in range(rows):
            for j in range(2):
                assert hw(start, r, j) == SW128(rows, r, 2 * ks + j)
    sbo, lbo = 1024, rows * 128
    for kk in range(rows // 16):
        for p in range(16):  # positions of the k-step
            for n in range(0, c["MLA_DV"], 8):  # chunks of V's columns
                start = kk * 2048 + (n // 64) * lbo + (p // 8) * sbo
                assert hw(start, p % 8, (n % 64) // 8) == SW128(rows, 16 * kk + p, n // 8)


@pytest.mark.parametrize("rows", [48, 64])
def test_288_rows_take_five_column_blocks_half_of_the_last_unused(rows):
    """MiniCPM3's 288-wide latent row is 4.5 of the swizzle's 64-element
    column blocks. The Q tile (64 rows) and a latent tile (48) are laid out
    in MLA_WG_CB = 5 whole blocks (rows x 640 bytes): the copies write
    chunks 0-35 of each row, once; S's 18 k-steps (9 a warpgroup, the
    second's starting at k-step 9, 32 bytes into block 2's atom) read
    exactly those chunks, k-steps 16 and 17 the fifth block's logical
    chunks 0-3; V (columns 0-255) reads blocks 0-3 only; the chunks the
    copies leave unwritten (logical 4-7 of the fifth block) are read by
    nothing."""
    def hw(start, r, j):
        a = start + 128 * r + 16 * j
        return a ^ (((a >> 7) & 7) << 4)

    c = MLA_C[288]
    assert (c["MLA_DL"], c["MLA_DV"], c["MLA_WG_CB"], c["MLA_WG_KS"]) == (288, 256, 5, 9)
    tile = rows * c["MLA_WG_CB"] * 128
    assert tile == {64: c["MLA_WG_Q"], 48: c["MLA_WG_TILE"]}[rows] and tile % 1024 == 0
    written = {SW128(rows, r, ch) for r in range(rows) for ch in range(c["MLA_DL"] // 8)}
    unwritten = {SW128(rows, r, ch) for r in range(rows) for ch in range(36, 40)}
    assert len(written) == rows * 36 and not written & unwritten
    assert max(written | unwritten) + 16 == tile
    read_s = set()
    for w in range(2):
        for k in range(c["MLA_WG_KS"]):
            ks = w * c["MLA_WG_KS"] + k
            start = (ks >> 2) * rows * 128 + (ks & 3) * 32
            for r in range(rows):
                for j in range(2):
                    read_s.add(hw(start, r, j))
    assert read_s == written
    read_v = set()
    for kk in range(rows // 16):
        for p in range(16):
            for n in range(0, c["MLA_DV"], 8):
                read_v.add(hw(kk * 2048 + (n // 64) * rows * 128 + (p // 8) * 1024, p % 8,
                              (n % 64) // 8))
    assert read_v < written and not read_v & unwritten
    assert max(read_v) < 4 * rows * 128


@pytest.mark.parametrize("rows", [64, 128])
def test_head_dim_64_descriptors_stay_in_one_column_block(rows):
    """At head_dim 64 a bf16 K or V row is 128 bytes, exactly one swizzle
    column block: the 4 k-steps of S = Q K^T (desc_k) start 32 ks bytes into
    the block's first row and every chunk they read lies in that block, and
    O += P V (desc_mn, N = 64) reads a single N block, so the descriptors'
    LBO, the step to the next column block, is never used. Each k-step of
    P V reads 16 whole rows, chunk n of row 16 kk + p where the copies
    wrote it."""
    def hw(start, r, j):
        a = start + 128 * r + 16 * j
        return a ^ (((a >> 7) & 7) << 4)

    block = rows * 128  # bytes of a column block = of the whole tile
    for ks in range(64 // 16):
        start = (ks >> 2) * rows * 128 + (ks & 3) * 32
        assert start == 32 * ks
        for r in range(rows):
            for j in range(2):
                assert hw(start, r, j) < block
                assert hw(start, r, j) == SW128(rows, r, 2 * ks + j)
    for kk in range(rows // 16):
        for p in range(16):
            for n in range(64 // 8):
                start = kk * 2048 + (p // 8) * 1024
                assert hw(start, p % 8, n) < block
                assert hw(start, p % 8, n) == SW128(rows, 16 * kk + p, n)


@pytest.mark.parametrize("wg", [0, 1])
def test_head_dim_256_descriptors_cross_the_four_column_blocks(wg):
    """At head_dim 256 a bf16 row is four swizzle column blocks. S = Q K^T's
    16 k-steps (desc_k) start 32 (ks % 4) bytes into column block ks // 4,
    for K (a tile of TK rows) and for Q, which the kernel reads by
    descriptor from its swizzled ROWS-row tile at warpgroup wg's first row
    (64 wg rows, 8192 wg bytes, on): the hardware's address of each chunk
    is where the copies wrote it. O += P V (desc_mn, N = 256) reads V's
    four column blocks LBO = TK 128 bytes apart, a k-step 16 rows on."""
    lay = _layout(256)
    tk, rows = lay["TK"], lay["ROWS"]

    def hw(start, r, j):
        a = start + 128 * r + 16 * j
        return a ^ (((a >> 7) & 7) << 4)

    for ks in range(256 // 16):
        k_start = (ks >> 2) * tk * 128 + (ks & 3) * 32
        for r in range(tk):
            for j in range(2):
                assert hw(k_start, r, j) == SW128(tk, r, 2 * ks + j)
        q_start = wg * 64 * 128 + (ks >> 2) * rows * 128 + (ks & 3) * 32
        for r in range(64):
            for j in range(2):
                assert hw(q_start, r, j) == SW128(rows, 64 * wg + r, 2 * ks + j)
    for kk in range(tk // 16):
        for p in range(16):
            for n in range(0, 256, 8):
                start = kk * 2048 + (n // 64) * tk * 128 + (p // 8) * 1024
                assert hw(start, p % 8, (n % 64) // 8) == SW128(tk, 16 * kk + p, n // 8)


# ---------------------------------------------------------------- shapes
# (q_lens, kv_lens, Hq, Hkv or None for the latent pool, window, head_dim):
# q_len 1, 100, 140, 200 and 2048, prefixes, a padded batch row (kv_len 0),
# windows, G = 1, 2, 4, 8; at head_dim 128 (the aligned build's block), 64
# (the chunked build's G 4 over Hkv 8 and the merged build's G 8 over Hkv 4,
# TinyLlama's, share the head_dim-64 block) and the latent width
SHAPES = [
    ([1], [1], 8, 8, 0, 128),
    ([100], [100], 8, 4, 0, 128),
    ([140, 20, 1, 7], [140, 60, 9, 300], 8, 2, 0, 128),
    ([200], [712], 8, 1, 0, 128),
    ([2048], [2048], 32, 8, 0, 128),
    ([140, 20, 1, 7, 0], [140, 60, 9, 300, 0], 8, 2, 24, 128),
    ([200, 1], [1000, 1], 32, 4, 512, 128),
    ([256] * 8, [2048] * 8, 32, 8, 0, 128),
    ([2048, 2048], [2048, 2048], 32, 8, 0, 128),
    ([37, 300], [37, 365], 16, 8, 64, 128),
    ([1], [1], 8, 8, 0, 64),
    ([100], [100], 8, 4, 0, 64),
    ([140, 20, 1, 7], [140, 60, 9, 300], 32, 8, 0, 64),
    ([200], [712], 32, 4, 0, 64),
    ([2048], [2048], 32, 4, 0, 64),
    ([140, 20, 1, 7, 0], [140, 60, 9, 300, 0], 16, 8, 24, 64),
    ([200, 1], [1000, 1], 32, 4, 512, 64),
    ([256] * 8, [2048] * 8, 32, 8, 0, 64),
    ([256] * 8, [2048] * 8, 32, 4, 0, 64),
    ([2048, 2048], [2048, 2048], 32, 8, 0, 64),
    ([37, 300], [37, 365], 32, 8, 64, 64),
    ([1], [1], 16, 8, 0, 256),
    ([140, 20, 1, 7], [140, 60, 9, 300], 16, 8, 0, 256),
    ([256] * 8, [2048] * 8, 16, 8, 0, 256),
    ([2048, 2048], [2048, 2048], 16, 8, 0, 256),
    ([2048, 1], [6000, 4500], 16, 8, 4096, 256),
    ([200, 1], [1000, 1], 8, 8, 512, 256),
    ([100], [100], 16, 4, 24, 256),
    ([140, 20, 1, 7], [140, 60, 9, 300], 16, None, 0, 576),
    ([2048], [2048], 16, None, 0, 576),
    ([256] * 8, [2048] * 8, 16, None, 0, 576),
    ([200, 1], [1000, 1], 16, None, 100, 576),
    ([140, 20, 1, 7], [140, 60, 9, 300], 40, None, 0, 288),
    ([2048], [2048], 40, None, 0, 288),
    ([256] * 8, [2048] * 8, 40, None, 0, 288),
    ([200, 1], [1000, 1], 40, None, 100, 288),
    ([3, 5, 1], [3, 70, 1], 40, None, 0, 288),
]
IDS = [f"{'d64-' if d == 64 else ''}{'d256-' if d == 256 else ''}{'mla288-' if d == 288 else ''}"
       f"{'mla' if h is None else f'g{hq // h}'}"
       f"-q{'_'.join(map(str, q))}-w{w}" for q, _, hq, h, w, d in SHAPES]
GQA_SHAPES = [(sh, i) for sh, i in zip(SHAPES, IDS) if sh[3] is not None]


def _work_list(q_lens, kv_lens):
    T = int(sum(q_lens)) + 9  # bucket padding rows after the real ones
    bs, br, bq = make_attn_meta_host(np.asarray(q_lens), T)
    q_start = [k - q for q, k in zip(q_lens, kv_lens)]
    return T, list(zip(bs.tolist(), br.tolist(), bq.tolist())), q_start


def _walk(q_lens, kv_lens, q_start, b, qofs, r_lo, r_hi, window, tk, cap):
    """A block's walk as the kernels compute it: [lo, limit) for the rows
    r_lo .. r_hi of an entry (0 tiles: the block returns early)."""
    n_rows = min(q_lens[b] - qofs, rpa.EXTEND_Q_BLOCK)
    q_abs_lo = q_start[b] + qofs
    limit = min(kv_lens[b], q_abs_lo + min(r_hi, n_rows - 1) + 1, cap)
    lo = max(q_abs_lo + r_lo - window + 1, 0) if window > 0 else 0
    return lo, limit, (limit - lo + tk - 1) // tk if limit > lo else 0


def _gqa_blocks(q_lens, kv_lens, Hq, Hkv, window, head_dim):
    """rpa_extend_wgmma_kernel's blocks at head_dim's block shape: grid
    (ceil(EXTEND_QBLK G / ROWS), Hkv, entries); packed row m = r G + g is
    query row r of head h G + g; consumer warpgroup w owns the block's
    packed rows 64 w .. 64 w + 63, warp v of it 16 of them. Yields (entry,
    rows written as (token, head), walk, rows' positions)."""
    G = Hq // Hkv
    T, entries, q_start = _work_list(q_lens, kv_lens)
    lay = _layout(head_dim)
    rows, consumers = lay["ROWS"], (lay["NT"] - 128) // 128
    assert rows == 64 * consumers == 64 * lay["NCW"]
    cap = 10 ** 9
    for i, (b, row0, qofs) in enumerate(entries):
        for slice_ in range(-(-GQA["EXTEND_QBLK"] * G // rows)):
            for h in range(Hkv):
                if b < 0:
                    continue
                n_rows = min(q_lens[b] - qofs, rpa.EXTEND_Q_BLOCK)
                m_lo = slice_ * rows
                if m_lo // G >= n_rows:
                    continue
                lo, limit, ntiles = _walk(q_lens, kv_lens, q_start, b, qofs, m_lo // G,
                                          (m_lo + rows - 1) // G, window, lay["TK"], cap)
                if ntiles == 0:
                    continue
                written = []
                for w in range(consumers):
                    for pm in range(m_lo + 64 * w, m_lo + 64 * w + 64):
                        r, g = divmod(pm, G)
                        if r < n_rows:
                            written.append((row0 + r, h * G + g, q_start[b] + qofs + r))
                yield b, written, (lo, limit, ntiles)


def _mla_blocks(q_lens, kv_lens, Hq, window, MLA=MLA):
    """rpa_extend_mla_wgmma_kernel's blocks (``MLA``: the build's
    constants): grid (ceil(EXTEND_QBLK Hq / 64), entries); packed row m = r
    Hq + g (consecutive in q and out; at Hq 40 a block's 64 rows start and
    end inside tokens); both warpgroups hold all 64 rows, warpgroup w scores
    dims DL/2 w .. DL/2 (w + 1) - 1 and writes V columns DV/2 w .. DV/2 (w
    + 1) - 1."""
    T, entries, q_start = _work_list(q_lens, kv_lens)
    rows = MLA["MLA_WG_ROWS"]
    for i, (b, row0, qofs) in enumerate(entries):
        for slice_ in range(-(-MLA["EXTEND_QBLK"] * Hq // rows)):
            if b < 0:
                continue
            n_rows = min(q_lens[b] - qofs, rpa.EXTEND_Q_BLOCK)
            m_lo = slice_ * rows
            if m_lo // Hq >= n_rows:
                continue
            lo, limit, ntiles = _walk(q_lens, kv_lens, q_start, b, qofs, m_lo // Hq,
                                      (m_lo + rows - 1) // Hq, window, MLA["MLA_WG_TK"], 10 ** 9)
            written = []
            for w in range(MLA["MLA_WG_NT"] // 128):
                cols = range(MLA["MLA_WG_DV"] * w, MLA["MLA_WG_DV"] * (w + 1))
                for pm in range(m_lo, m_lo + rows):
                    r, g = divmod(pm, Hq)
                    if r < n_rows:
                        written.append((row0 + r, g, q_start[b] + qofs + r, cols))
            yield b, written, (lo, limit, ntiles)


@pytest.mark.parametrize("q_lens,kv_lens,Hq,Hkv,window,head_dim", SHAPES, ids=IDS)
def test_every_owned_row_is_written_once_and_sees_its_positions(q_lens, kv_lens, Hq, Hkv,
                                                                window, head_dim):
    """Every (token, head) of every request is written by exactly one block
    (with the MLA kernels, each of its 512 or 256 columns by exactly one
    warpgroup, MiniCPM3's 40 heads packed 1.6 tokens a block), nothing in the bucket padding rows is, and the block's walk
    [lo, limit) holds every position the row may see (causal, kv_len,
    window): tiles above the block's last row or below its first row's
    window are never walked."""
    T = int(sum(q_lens)) + 9
    q_start = [k - q for q, k in zip(q_lens, kv_lens)]
    if Hkv is None:
        mla = MLA_C[head_dim]
        count = np.zeros((T, Hq, mla["MLA_DV"]), np.int64)
        blocks = _mla_blocks(q_lens, kv_lens, Hq, window, mla)
    else:
        count = np.zeros((T, Hq, 1), np.int64)
        blocks = _gqa_blocks(q_lens, kv_lens, Hq, Hkv, window, head_dim)
    tk = MLA["MLA_WG_TK"] if Hkv is None else _layout(head_dim)["TK"]
    for b, written, (lo, limit, ntiles) in blocks:
        for item in written:
            t, hq, pos = item[:3]
            cols = item[3] if Hkv is None else [0]
            count[t, hq, list(cols)] += 1
            first = max(pos - window + 1, 0) if window > 0 else 0
            last = min(pos + 1, kv_lens[b])
            if last > first:
                assert lo <= first and last <= limit <= lo + ntiles * tk
    real = int(sum(q_lens))
    assert (count[:real] == 1).all()
    assert not count[real:].any()


@pytest.mark.parametrize("q_lens,kv_lens,Hq,Hkv,window,head_dim", [s for s, _ in GQA_SHAPES],
                         ids=[i for _, i in GQA_SHAPES])
def test_gqa_warps_mask_the_tiles_their_rows_cannot_see(q_lens, kv_lens, Hq, Hkv, window,
                                                        head_dim):
    """A warp's 16 packed rows span query positions wq_lo .. wq_hi; a tile
    of the walk at st is left unmasked only if every one of those rows sees
    all of it (st + TK <= limit, st + TK - 1 <= wq_lo, st > wq_hi - window),
    and a tile none of them sees is masked whole (its scores are NEG_INF)."""
    G, TK = Hq // Hkv, _layout(head_dim)["TK"]
    for b, written, (lo, limit, ntiles) in _gqa_blocks(q_lens, kv_lens, Hq, Hkv, window,
                                                       head_dim):
        positions = sorted({pos for _, _, pos in written})
        for t in range(ntiles):
            st = lo + t * TK
            for w0 in range(0, len(positions), max(16 // G, 1)):
                wq = positions[w0:w0 + max(16 // G, 1)]
                wq_lo, wq_hi = wq[0], wq[-1]
                masked = (st + TK > limit or st + TK - 1 > wq_lo
                          or (window > 0 and st <= wq_hi - window))
                sees = [[lo_p <= p < hi_p for p in range(st, st + TK)]
                        for q in wq
                        for lo_p, hi_p in [((max(q - window + 1, 0) if window else 0),
                                            min(q + 1, limit))]]
                if not masked:
                    assert all(all(s) for s in sees)


@pytest.mark.parametrize("width", [576, 288])
def test_mla_warpgroups_split_the_dims_and_the_columns(width):
    """The two warpgroups of the MLA kernel score disjoint halves of the 576
    dims (18 k-steps of 16 each; 9 each of 288) whose sum is S, and write
    disjoint halves of V's 512 columns (a 64 x 256 float32 accumulator, 128
    registers a thread; 64 x 128, 64 registers, of 256); the tile of 48
    positions is 3 k-steps of P V."""
    MLA = MLA_C[width]
    assert (MLA["MLA_DL"], MLA["MLA_DV"]) == {576: (576, 512), 288: (288, 256)}[width]
    ks = [set(range(w * MLA["MLA_WG_KS"], (w + 1) * MLA["MLA_WG_KS"])) for w in range(2)]
    assert ks[0] | ks[1] == set(range(MLA["MLA_DL"] // 16)) and not ks[0] & ks[1]
    assert 2 * MLA["MLA_WG_DV"] == MLA["MLA_DV"] and MLA["MLA_WG_DV"] % 64 == 0
    # accumulators a thread
    assert MLA["MLA_WG_ROWS"] * MLA["MLA_WG_DV"] // 128 == {576: 128, 288: 64}[width]
    assert MLA["MLA_WG_TK"] % 16 == 0 and MLA["MLA_WG_TK"] % 8 == 0
    assert MLA["MLA_WG_NT"] == 256 and rpa.EXTEND_Q_BLOCK * 16 % MLA["MLA_WG_ROWS"] == 0


@pytest.mark.parametrize("width", [576, 288])
def test_mla_fp8_rows_cover_the_tile_once(width):
    """fp8 latent rows reach the MLA extend's swizzled bf16 stage through
    registers: at 576 a raw fp8 stage (48 x 576 bytes) beside the two bf16
    stages would exceed a block's shared memory (the 288 build keeps the
    same code). A tile's 1728 16-byte vectors are 6.75 for each of the 256
    threads (864, 3.375, at 288), so thread tid takes vectors tid + 256 k,
    k < MLA_WG_NRV = 7 (4), the last round only below the tile's count;
    each widens to the two bf16 chunks 2 c and 2 c + 1 of its row, and
    together they write every 16-byte chunk of the 48-row bf16 tile once,
    inside the stage."""
    MLA = MLA_C[width]
    tk, nt, rv, nrv = MLA["MLA_WG_TK"], MLA["MLA_WG_NT"], MLA["MLA_WG_RV"], MLA["MLA_WG_NRV"]
    assert rv == MLA["MLA_DL"] // 16 == {576: 36, 288: 18}[width]
    assert nrv == {576: 7, 288: 4}[width]
    assert SMEM_PER_BLOCK >= MLA["MLA_WG_SMEM"]
    if width == 576:
        assert MLA["MLA_WG_SMEM"] + tk * MLA["MLA_DL"] > SMEM_PER_BLOCK
    seen, idle = {}, 0
    for tid in range(nt):
        for k in range(nrv):
            v = tid + k * nt
            if v >= tk * rv:
                idle += 1
                continue
            p, c = divmod(v, rv)
            for chunk in (2 * c, 2 * c + 1):
                off = SW128(tk, p, chunk)
                assert off % 16 == 0 and off + 16 <= MLA["MLA_WG_TILE"]
                seen[off] = seen.get(off, 0) + 1
    assert idle == nrv * nt - tk * rv == {576: 64, 288: 160}[width]
    assert sorted(seen) == sorted(SW128(tk, p, c) for p in range(tk)
                                  for c in range(MLA["MLA_DL"] // 8))
    assert set(seen.values()) == {1}


# ---------------------------------------------------------------- the ring
def _ring(ntiles, widen, stages, lag, seed, ncw=2):
    """rpa_extend_wgmma_kernel's producer and its ncw consumer warpgroups as
    programs of barrier operations, run in a random interleaving. Stage s
    holds tile t = s (mod stages); consumers wait for full[s] in phase t //
    stages, read K_t in iteration t and V_t in iteration t + 1, then each
    warp (4 a warpgroup) arrives on empty; the producer waits for empty's
    phase t // stages - 1 before refilling. bf16 KV: the arrival on full
    follows the copy; fp8: tile u is widened (and arrives) lag rounds after
    its raw copy. Returns the number of steps, or raises on a deadlock or a
    stage written while a consumer may still read it."""
    rng = random.Random(seed)
    full = [[0, 0] for _ in range(stages)]  # [completed phases, arrivals]
    empty = [[0, 0] for _ in range(stages)]

    def done(bar, s, parity):  # try_wait.parity: that phase has completed
        return bar[s][0] > 0 and (bar[s][0] - 1) & 1 == parity

    def arrive(bar, s, count):
        bar[s][1] += 1
        if bar[s][1] == count:
            bar[s][0], bar[s][1] = bar[s][0] + 1, 0

    prod = []
    for t in range(ntiles + (lag if widen else 0)):
        if not widen:
            if t >= stages:
                prod.append(("wait", empty, t % stages, (t // stages - 1) & 1))
            prod += [("write", t % stages, t), ("arrive", full, t % stages, 1)]
            continue
        u = t - lag
        if u >= 0:
            if u >= stages:
                prod.append(("wait", empty, u % stages, (u // stages - 1) & 1))
            prod += [("write", u % stages, u), ("arrive", full, u % stages, 1)]
    programs = [prod]
    cons = []
    for t in range(ntiles):
        cons += [("wait", full, t % stages, (t // stages) & 1), ("read", t % stages, t)]
        if t > 0:
            cons += [("read", (t - 1) % stages, t - 1), ("release", (t - 1) % stages)]
    programs, pcs = [prod] + [list(cons) for _ in range(ncw)], [0] * (ncw + 1)
    holds, reading = [None] * stages, [set() for _ in range(stages)]
    steps = 0
    while any(pc < len(p) for pc, p in zip(pcs, programs)):
        ready = [a for a, p in enumerate(programs) if pcs[a] < len(p) and not (
            p[pcs[a]][0] == "wait" and not done(*p[pcs[a]][1:]))]
        assert ready, f"deadlock at {pcs}"
        a = rng.choice(ready)
        op = programs[a][pcs[a]]
        if op[0] == "write":
            assert not reading[op[1]], f"stage {op[1]} refilled while read"
            holds[op[1]] = op[2]
        elif op[0] == "arrive":
            arrive(op[1], op[2], op[3])
        elif op[0] == "read":
            assert holds[op[1]] == op[2], "a consumer read another tile"
            reading[op[1]].add(a)
        elif op[0] == "release":
            reading[op[1]].discard(a)
            for _ in range(4):
                arrive(empty, op[1], 4 * ncw)
        pcs[a] += 1
        steps += 1
    return steps


@pytest.mark.parametrize("ntiles", [1, 2, 3, 4, 5, 9, 33])
@pytest.mark.parametrize("widen", [False, True], ids=["bf16", "fp8"])
def test_ring_neither_deadlocks_nor_refills_a_stage_in_use(ntiles, widen):
    """The ring of the GQA kernel with its source's stage count and lag, in
    200 random interleavings of the producer and the two consumers."""
    for seed in range(200):
        assert _ring(ntiles, widen, GQA["WG_STAGES"], GQA["WG_LAG"], seed, GQA["WG_NCW"]) > 0


@pytest.mark.parametrize("ntiles", [1, 2, 3, 4, 5, 7, 9, 33])
@pytest.mark.parametrize("widen", [False, True], ids=["bf16", "fp8"])
def test_head_dim_64_ring_neither_deadlocks_nor_refills_a_stage_in_use(ntiles, widen):
    """The ring of the head_dim-64 block, with its stage count, lag and
    consumer warpgroups, in 200 random interleavings."""
    lay = _layout(64)
    for seed in range(200):
        assert _ring(ntiles, widen, lay["STAGES"], lay["LAG"], seed, lay["NCW"]) > 0


def _budget(head_dim: int, fp8: bool) -> dict:
    """Registers and shared memory of the block at head_dim (WgLayout): the
    Q staging in padded rows, or at head_dim 256 swizzled (QSS)."""
    lay = _layout(head_dim)
    launch = 65536 // lay["NT"] // 8 * 8  # a thread's registers at one block per SM
    tk, d = lay["TK"], head_dim
    ring = lay["STAGES"] * 2 * tk * d * 2
    raw = (lay["LAG"] + 1) * tk * d * 2 if fp8 else 0
    q = lay["ROWS"] * (d if d == 256 else d + 8) * 2
    smem = ring + raw + q + 2 * lay["STAGES"] * 8 + 1024
    return dict(lay, launch=launch, smem=smem, per_sm=65536 // (lay["NT"] * launch))


def test_gqa_kernel_constants_and_budgets():
    """The GQA kernel's constants as the sources state them: two consumer
    warpgroups of 64 packed rows and a producer warpgroup; setmaxnreg moves
    no more registers to the consumers than the producer gives back from the
    launch's 65536 / 384 (rounded down to 8); each layout's shared memory
    (bf16 KV: the ring and the Q staging; fp8 adds the raw tiles) and the
    MLA kernel's fit one block."""
    launch = 65536 // GQA["WG_NT"] // 8 * 8
    assert GQA["WG_NT"] == 384 and GQA["WG_ROWS"] == 128 and launch == 168
    assert 2 * (GQA["WG_CONSUMER_REGS"] - launch) <= launch - GQA["WG_PRODUCER_REGS"]
    assert GQA["WG_CONSUMER_REGS"] % 8 == 0 and GQA["WG_PRODUCER_REGS"] % 8 == 0
    for fp8 in (False, True):
        assert _budget(128, fp8)["smem"] <= SMEM_PER_BLOCK, fp8
    for mla in MLA_C.values():
        assert mla["MLA_WG_SMEM"] <= SMEM_PER_BLOCK
    assert (MLA_C[576]["MLA_WG_SMEM"], MLA_C[288]["MLA_WG_SMEM"]) == (209920, 128000)


@pytest.mark.parametrize("ntiles", [1, 2, 3, 4, 5, 7, 9, 33])
@pytest.mark.parametrize("widen", [False, True], ids=["bf16", "fp8"])
def test_head_dim_256_ring_neither_deadlocks_nor_refills_a_stage_in_use(ntiles, widen):
    """The ring of the head_dim-256 block (3 stages), with its lag and
    consumer warpgroups, in 200 random interleavings."""
    lay = _layout(256)
    for seed in range(200):
        assert _ring(ntiles, widen, lay["STAGES"], lay["LAG"], seed, lay["NCW"]) > 0


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
def test_head_dim_256_constants_and_budgets(fp8):
    """The head_dim-256 block (the aligned _256 build): two consumer
    warpgroups of 64 packed rows and a producer warpgroup, setmaxnreg as at
    128 (224 / 56 of 168); a consumer's accumulators, O (64 x 256 float32:
    128 a thread) and S (64 x TK: TK / 2) with P's fragments (TK / 8), leave
    room in its 224 registers with Q read by descriptor; shared memory (3
    stages of 32-position K and V tiles, fp8's LAG + 1 raw tiles, the
    swizzled 64 KB Q tile, barriers, alignment) fits one block, and a
    fourth stage would not with fp8 KV; Gemma-2's G = 2 fills whole 64-row
    warpgroups (an entry's 256 packed rows are two blocks)."""
    b = _budget(256, fp8)
    assert (b["NCW"], b["NT"], b["ROWS"], b["TK"]) == (2, 384, 128, 32)
    assert b["launch"] == 168 and b["per_sm"] == 1
    assert b["NCW"] * (b["CONSUMER_REGS"] - b["launch"]) <= b["launch"] - b["PRODUCER_REGS"]
    assert (b["CONSUMER_REGS"], b["PRODUCER_REGS"]) == (224, 56)
    assert 256 // 2 + b["TK"] // 2 + b["TK"] // 8 <= b["CONSUMER_REGS"] - 48
    assert b["smem"] <= SMEM_PER_BLOCK, b
    assert b["TK"] % 16 == 0 and b["LAG"] + 1 <= b["STAGES"] == 3
    if fp8:
        assert b["smem"] + 2 * b["TK"] * 256 * 2 > SMEM_PER_BLOCK
    assert rpa.EXTEND_Q_BLOCK * 2 % b["ROWS"] == 0


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
def test_head_dim_64_constants_and_budgets(fp8):
    """The head_dim-64 block (the chunked and the merged build): NCW
    consumer warpgroups of 64 packed rows and a producer warpgroup, one
    block per SM; setmaxnreg moves no more registers to the consumers than
    the producer gives back from the launch's 65536 / NT (rounded down to
    8), and the producer keeps at least setmaxnreg's floor of 24; shared
    memory (the ring, the fp8 raw tiles, the Q staging, the barriers, the
    atoms' alignment) times blocks per SM within one SM's 227 KB; a tile
    is whole 16-position k-steps, and the packed rows of an entry (128 G)
    at G 4 and 8 fill whole 64-row warpgroups."""
    b = _budget(64, fp8)
    assert b["NT"] == 128 * (b["NCW"] + 1) and b["ROWS"] == 64 * b["NCW"]
    assert b["per_sm"] == 1 and b["NT"] * b["launch"] <= 65536
    assert b["NCW"] * (b["CONSUMER_REGS"] - b["launch"]) <= b["launch"] - b["PRODUCER_REGS"]
    assert b["PRODUCER_REGS"] >= 24 and b["CONSUMER_REGS"] <= 256
    assert b["CONSUMER_REGS"] % 8 == 0 and b["PRODUCER_REGS"] % 8 == 0
    assert b["smem"] * b["per_sm"] <= SMEM_PER_BLOCK, b
    assert b["TK"] % 16 == 0 and b["TK"] in (64, 128) and b["STAGES"] >= 2
    assert b["LAG"] + 1 <= b["STAGES"]
    for G in (4, 8):
        assert rpa.EXTEND_Q_BLOCK * G % 64 == 0


@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
def test_producer_thread_map_covers_the_tile_once(head_dim, fp8):
    """The producer's 128 threads copy every 16-byte vector of a K (and a V)
    tile exactly once: thread p the vector l % VPR of the rows l / VPR + k
    VSTEP, k < NV (l = fp8_lane(p, VPR) with fp8 KV, else p; VPR vectors a
    row, 8 with bf16 KV at head_dim 64, 4 with fp8 there, 16 and 8 at 128,
    32 and 16 at 256, where a bf16 row takes a whole warp and its rows are
    4 apart). With fp8, the widening stores of each quarter warp (8 lanes, one
    128-byte wavefront) land in 8 different 16-byte bank groups after the
    swizzle, both of a thread's two stores: the map fp8_lane gives is free
    of bank conflicts at VPR 4 and 8, where the plain map p at 8 and the
    bit swap at 4 are not (at 256 it is the identity, with a 2-way
    conflict between a quarter warp's column blocks, not tuned yet)."""
    tk = _layout(head_dim)["TK"]
    vpr = head_dim // (16 if fp8 else 8)
    vstep = 128 // vpr
    nv = tk // vstep
    assert tk % vstep == 0 and (vstep % 8 == 0 or head_dim == 256)

    def chunks(lane_of):
        return [[((lane_of(p) // vpr) + k * vstep, lane_of(p) % vpr) for k in range(nv)]
                for p in range(128)]

    lane = (lambda p: FP8_LANE(p, vpr)) if fp8 else (lambda p: p)
    got = sorted(x for per in chunks(lane) for x in per)
    assert got == sorted((r, c) for r in range(tk) for c in range(vpr))
    if not fp8:
        return

    def conflict_free(lane_of):
        per = chunks(lane_of)
        for k in range(nv):
            for half in (0, 1):  # the stores of bf16 chunks 2 vc and 2 vc + 1
                for q0 in range(0, 128, 8):
                    banks = {(SW128(tk, *(lambda r, v: (r, 2 * v + half))(*per[p][k])) >> 4) & 7
                             for p in range(q0, q0 + 8)}
                    if len(banks) < 8:
                        return False
        return True

    if head_dim == 256:
        assert all(FP8_LANE(p, vpr) == p for p in range(128))
        return
    assert conflict_free(lane)
    swap = lambda p: p ^ (12 * (((p >> 2) ^ (p >> 3)) & 1))  # noqa: E731
    assert not conflict_free(lambda p: p if vpr == 8 else swap(p))


def test_builds_name_their_warpgroup_kernels():
    """Every GQA extend build (the chunked and the merged one at head_dim
    64, the aligned ones at 128 and 256) and the MLA builds launch the warpgroup
    kernels for bf16 q: their sources hold them, the entry passes the
    build's P_F32_BUILD (the merged build's -DRPA_P_F32) as the kernel's
    P_SPLIT (to the instantiation with a speculation tree and the one
    without), the mma.sync extend kernel is gone, and the builds' defines
    are the ones their schedules here assume."""
    aligned, mla = KERNELS["rpa_extend_aligned"], KERNELS["rpa_extend_mla"]
    chunked, merged = KERNELS["rpa_extend"], KERNELS["rpa_extend_merged"]
    assert "RPA_ALIGNED" in aligned.defines and not any(
        d.startswith("RPA_HEAD_DIM") for d in aligned.defines)
    assert "RPA_ALIGNED" not in chunked.defines and "RPA_P_F32" not in chunked.defines
    assert {"RPA_ALIGNED", "RPA_HEAD_DIM=64", "RPA_P_F32"} <= set(merged.defines)
    for k in (aligned, mla, chunked, merged):
        assert f"EXTEND_QBLK={rpa.EXTEND_Q_BLOCK}" in k.defines
    assert "RPA_P_F32" in mla.defines
    mla288 = KERNELS["rpa_extend_mla_288"]
    assert mla288.source == mla.source and rpa.EXTEND_MLA_KERNELS == {576: mla, 288: mla288}
    assert set(mla.defines) < set(mla288.defines)
    assert {"RPA_MLA_DL=288", "RPA_MLA_DV=256"} <= set(mla288.defines)
    assert set(mla288.defines) - set(mla.defines) == {"RPA_MLA_DL=288", "RPA_MLA_DV=256"}
    src = aligned.source.read_text()
    assert chunked.source == merged.source == aligned.source
    assert "rpa_extend_wgmma_kernel" in src and "rpa_extend_mma_kernel" not in src
    assert "MmaLayout" not in src and "launch_extend_mma" not in src
    # both instantiations, with a speculation tree and without (TREE; the
    # one without also as ALiBi's where the build has it, never the tree's)
    assert re.search(r"launch_extend_wgmma<TKV, D, P_F32_BUILD, true, false>", src)
    assert re.search(r"launch_extend_wgmma<TKV, D, P_F32_BUILD, false, ALIBI>", src)
    assert "rpa_extend_mla_wgmma_kernel" in mla.source.read_text()
    # head_dim 256: the same source and kernel, with the tree's
    # instantiations as every extend build (no build leaves them out)
    a256 = KERNELS["rpa_extend_aligned_256"]
    assert a256.source == aligned.source and rpa.EXTEND_KERNELS["aligned"] == {
        128: aligned, 256: a256}
    assert set(aligned.defines) | {"RPA_HEAD_DIM=256"} == set(a256.defines)
    for text in (src, mla.source.read_text(), (mla.source.parent / "rpa_common.cuh").read_text()):
        assert "TREE_BUILT" not in text and "RPA_NO_TREE" not in text
    assert all("RPA_NO_TREE" not in k.defines for k in KERNELS.values())
    assert re.search(r"launch_extend_mla_wgmma<TKV, true>", mla.source.read_text())
