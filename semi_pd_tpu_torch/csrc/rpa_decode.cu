// Paged decode attention over the chunked or the 5D KV pool, for Hopper
// (sm_90a).
//
// Replaces three TPU kernels (branches), one build each (rpa_common.cuh;
// every build takes bf16 and fp8 e4m3 / e5m2 KV under bf16 q, float32 KV
// under float32 q):
//   chunked pool, head_dim 64 (rpa_decode): semi_pd_tpu/ops/attention/
//     rpa_packed.py _rpa_kernel_chunked_packed (called from
//     ragged_paged_attention_chunked_packed);
//   5D pool, head_dim 128 (-DRPA_ALIGNED, rpa_decode_aligned) and 256
//     (-DRPA_ALIGNED -DRPA_HEAD_DIM=256, rpa_decode_aligned_256, Gemma-2's):
//     semi_pd_tpu/ops/attention/rpa_packed.py _rpa_kernel_packed (called from
//     ragged_paged_attention_packed; its GQA branch, the MLA branch is
//     rpa_decode_mla.cu);
//   5D pool, head_dim 64 (-DRPA_ALIGNED -DRPA_HEAD_DIM=64 -DRPA_P_F32,
//     rpa_decode_merged): the decode of semi_pd_tpu/ops/attention/
//     ragged_paged_attention.py _rpa_kernel_merged, which the JAX dispatcher
//     runs for every D % 128 != 0 batch on that pool. It upcasts q, K and V
//     to float32 and keeps P in float32, so this build does not round P.
//     The first two widen K and V to q's dtype and cast p to it for the P.V
//     dot, so their bf16-q pairs round P to bf16 once per position, while
//     the running sum adds the unrounded p.
// One query row per request, GQA with G = Hq / Hkv query heads per KV head,
// float32 online softmax, optional logit softcap and sliding window. fp8 KV
// is widened exactly, as the TPU kernels upcast it to q's dtype.
//
// Bound on this card: bytes. Each call reads every live KV row once,
// B * kv_len * 2 * Hkv * D * sizeof(KV) bytes, and does only 4 * Hq * D
// operations per KV position (about 1 operation per byte in bf16 with
// G = 4, 2 with fp8 KV, far below the ~295 the H100 needs before its
// tensor cores bind).
//
// Two kernels; the entry point picks one by q's type alone, in every build:
// rpa_decode_kernel (below) for the float32 pair, and rpa_decode_mma_kernel
// (after it) for the bf16-q pairs.
//
// rpa_decode_kernel (float32 q): one block of 128 threads per (request, KV
// head). The block stages its G query rows in shared memory once, then
// walks the request's pages through the page table in tiles of 4096 / D
// positions (64 at D 64, 32 at D 128, 16 at D 256, so the float32 K and V
// tiles stay at ~34 KB of shared memory at every width): each thread issues
// the 16-byte loads of its share of the NEXT tile into registers before the
// block computes on the current one (a two-deep pipeline without cp.async), so a KV byte is
// read once and the load latency overlaps the score / softmax / P.V work
// (rpa_decode.cuh). Positions at or past kv_len are never read (the TPU
// kernels gathered whole sections and relied on the dump page being
// finite); rows with kv_len == 0 write zeros.
//
// rpa_decode_mma_kernel (bf16 q over bf16 or fp8 KV): per-position work on
// the tensor cores (the warp tile, shared with the streaming decode, is in
// rpa_decode_mma.cuh), and a split of each request's positions over warps
// and blocks (flash-decoding).
//   - The query heads of a KV head are cut into head groups of at most 16,
//     the rows of one m16 tile each: group j of KV head h is the heads
//     [h G + 16 j, h G + min(16 j + 16, G)), so G <= 16 is one group a KV
//     head and StarCoder's multi-query G = 48 three, Falcon-7B's 71 five
//     (16 x 4 + 7). Rows past the group's end are zero and written nowhere
//     (G is 4 on the 1B-class and 8B paths, and the kernel is bytes-bound,
//     so the empty rows cost no time). Each group's block reads its KV
//     head's tiles itself: at G > 16 a KV tile is read once per group
//     (ROADMAP B7). The cut is the kernel's GROUPS instantiation (G > 16),
//     so the G <= 16 kernels are the code they were before groups (hg = h).
//     S = Q K^T is mma.sync m16n8k16 bf16 -> f32 with K fragments by
//     ldmatrix: exact products, float32 sums. O += P V against V fragments
//     by ldmatrix.trans: the chunked and aligned builds take P rounded to
//     bf16 (to nearest, as astype rounds it), one product, as their TPU
//     kernels do; the merged build (P_F32_BUILD) takes P as its two bf16
//     parts hi + lo (split_bf16, rpa_common.cuh) in two products, so P stays
//     float32 to 2^-18 (one bf16 rounding would leave 2^-9).
//   - Each warp owns its own run of tiles of SD_TK positions (warp w of a
//     block takes tiles w, w + 4, ...) with its own online softmax, and its
//     own ring of bf16 tiles in shared memory: bf16 KV by cp.async, three
//     stages, two tiles in flight while it computes on the third; fp8 KV
//     loaded into registers a tile ahead and widened exactly on its way into
//     one of two bf16 tiles. A warp needs only __syncwarp, never the block.
//     SD_TK is 32 positions at head_dim 64, 16 at 128 and 8 at 256 (P V as
//     m16n8k8), so that a block's rings take about 105 KB at every width
//     and two blocks share an SM. At 256 the block also stages its Q rows
//     once in shared memory (8 KB), and every warp reads its A fragments
//     from there a k-step at a time (rpa_decode_mma.cuh MmaQ): O alone is
//     128 registers a thread there.
//   - Grid (n_split, Hkv * ceil(G / 16), B): the host's split plan (rpa_packed.py
//     decode_split_plan) cuts [0, maxP * page_size) into n_split ranges of
//     split_len positions, from the shapes, the build and the SM count only
//     (no kv_lens on the host), so a small batch still fills the card. A
//     block merges its four warps' (m, l, O) in shared memory in a fixed
//     order; with one split it writes the output, else its float32 partial
//     to the caller's scratch, and rpa_decode_combine_kernel merges the
//     splits in log-sum-exp form, in split order. No atomics: two calls are
//     bitwise equal.
//   Positions outside [lo, kv_len) are zero-filled and never read; a row
//   with no position (kv_len 0) writes zeros.
//
// ALiBi (the ALIBI instantiations of both kernels, in the aligned
// head_dim-128 build only: Baichuan2-13B, whose JAX model runs the XLA
// reference attention with alibi_slopes): each score takes -slopes[hq] *
// (kv_len - 1 - pos) in float32 after the scale and the softcap, before the
// mask and the running max (rpa_common.cuh). The tensor-core kernel then
// scales each dot before the bias (p = 2^(v log2 e - m log2 e)); its lanes
// read their two rows' slopes once. The entry launches them only when
// given slopes; the ALIBI = false kernels hold no line of it, so they keep
// their registers and spills. Bound by bytes as above: the bias is a
// multiply-add a score.
#include <type_traits>

#include "rpa_decode.cuh"
#include "rpa_decode_mma.cuh"

namespace rpa {

template <int D, bool ALIBI>
__global__ void __launch_bounds__(DEC_NT)
rpa_decode_kernel(const float* __restrict__ q,         // [B, Hq, D]
                  const float* __restrict__ k_pool,    // K of this layer at slot 0
                  const float* __restrict__ v_pool,    // V of this layer at slot 0
                  const int* __restrict__ page_table,  // [B, maxP]
                  const int* __restrict__ kv_lens,     // [B]
                  float* __restrict__ out,             // [B, Hq, D]
                  int Hq, int Hkv, int row_stride, int maxP, int page_size,
                  float scale, float cap, int window,
                  const float* __restrict__ alibi) {  // [Hq] slopes (ALIBI)
  constexpr int NT = DEC_NT, TK = dec_tk<D>(), LD = dec_ld<D>();
  using Tile = KVTile<float, D, TK, NT>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const DecodeSmem s = dec_smem<D>(smem, G);

  const int kv_len = kv_lens[b];
  const int limit = min(kv_len, maxP * page_size);
  float* o = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
  if (limit <= 0) {  // padded batch row
    for (int i = tid; i < G * D; i += NT) o[i] = 0.f;
    return;
  }
  // the query sits at kv_len - 1 and sees positions > kv_len - 1 - window
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;

  float acc[DEC_MAXO];
  decode_begin<float, D>(s, q + ((int64_t)b * Hq + (int64_t)h * G) * D, G, acc, tid);

  const int* pt_row = page_table + (int64_t)b * maxP;
  const float* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  Tile tile;
  tile.load(kb, v_off, pt_row, page_size, row_stride, lo, limit, tid);

  for (int start = lo; start < limit; start += TK) {
    __syncthreads();  // the previous tile is fully consumed
    tile.template store<LD>(s.sK, s.sV, tid);
    __syncthreads();
    if (start + TK < limit)
      tile.load(kb, v_off, pt_row, page_size, row_stride, start + TK, limit, tid);
    decode_tile<float, D, ALIBI>(s, acc, G, start, limit, scale, cap, tid,
                                 ALIBI ? alibi + h * G : nullptr, kv_len - 1);
  }
  __syncthreads();
  decode_end<float, D>(s, acc, o, G, tid);
}

// ------------------------------------------------------------------------
// The tensor-core decode (bf16 q).

// The split plan's constants for this build's head_dim; ops/attention/
// rpa_packed.py DECODE_SPLIT states the same per build, and a CPU test
// (tests/test_torch_decode_split.py) evaluates these lines to hold them
// equal.
constexpr int SD_NT = 128;  // 4 warps
constexpr int SD_WARPS = SD_NT / 32;
constexpr int SD_TK = 2048 / RPA_HEAD_DIM;  // KV positions per warp tile (8 at 256)
constexpr int SD_STEP = SD_WARPS * SD_TK;   // split_len must be a multiple of this
constexpr int SD_BLOCKS_PER_SM = 2;         // blocks an SM holds with bf16 KV (SdLayout)

template <typename TKV, int D>
struct SdLayout {
  static constexpr bool WIDEN = sizeof(TKV) == 1;  // fp8 KV: widened on the way in
  static constexpr int LD = D + 8;                 // bf16 row stride: no ldmatrix conflicts
  static constexpr int TILE = SD_TK * LD;          // elements of one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE * 2;  // a K and a V tile in bf16
  static constexpr int NST = WIDEN ? 2 : 3;         // bf16 tiles per warp
  static constexpr int Q0 = SD_WARPS * NST * STAGE_BYTES;  // the Q tile (MmaQ<D>::SMEM)
  static constexpr int SMEM = Q0 + MmaQ<D>::BYTES;
  static constexpr int VE = 16 / (int)sizeof(TKV);  // KV elements per 16-byte vector
  static constexpr int VPR = D / VE;                // vectors per K or V row
  static constexpr int NV = SD_TK * VPR / 32;       // of K (and of V) per lane
  static constexpr int VSTEP = 32 / VPR;            // rows between a lane's vectors
  static_assert(D == RPA_HEAD_DIM && D % 32 == 0 && (SD_TK == 8 || SD_TK % 16 == 0),
                "tile shape");
  static_assert(32 % VPR == 0 && (SD_TK * VPR) % 32 == 0, "tile shape");
  // the block's merge: each warp's 16 rows of O and (m, l)
  static_assert(SD_WARPS * 16 * (D + 2) * 4 <= SMEM, "merge staging");
  // SD_BLOCKS_PER_SM blocks fit in an SM's 228 KB of shared memory (1 KB
  // of it reserved per block); with bf16 KV one more does not (fp8 KV's two
  // bf16 tiles a warp, 68-72 KB a block, leave room for a
  // third block, which the split plan does not count on)
  static_assert(SD_BLOCKS_PER_SM * (SMEM + 1024) <= 233472, "SD_BLOCKS_PER_SM");
  static_assert(WIDEN || (SD_BLOCKS_PER_SM + 1) * (SMEM + 1024) > 233472, "SD_BLOCKS_PER_SM");
};

template <typename TKV, int D, bool ALIBI, bool GROUPS>
__global__ void __launch_bounds__(SD_NT)
rpa_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
                      const TKV* __restrict__ k_pool,       // K of this layer at slot 0
                      const TKV* __restrict__ v_pool,       // V of this layer at slot 0
                      const int* __restrict__ page_table,   // [B, maxP]
                      const int* __restrict__ kv_lens,      // [B]
                      __nv_bfloat16* __restrict__ out,      // [B, Hq, D]
                      float* __restrict__ part,  // n_split > 1: O [n_split, B, Hq, D], ML [..., 2]
                      int Hq, int Hkv, int row_stride, int maxP, int page_size, float scale,
                      float cap, int window, int split_len,
                      const float* __restrict__ alibi) {  // [Hq] slopes (ALIBI)
  using bf16 = __nv_bfloat16;
  using Lay = SdLayout<TKV, D>;
  constexpr int LD = Lay::LD, TK = SD_TK;
  extern __shared__ __align__(16) unsigned char sd_smem[];  // not rpa_decode_kernel's smem
  const int split = blockIdx.x, b = blockIdx.z;
  const int n_split = gridDim.x, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int h, hq0, GB;  // head group blockIdx.y: KV head h's query heads [hq0, hq0 + GB)
  mma_head_group<GROUPS>(Hq, Hkv, blockIdx.y, h, hq0, GB);

  const int kv_len = kv_lens[b];
  const int limit = min(kv_len, maxP * page_size);
  // the query sits at kv_len - 1 and sees positions > kv_len - 1 - window
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, limit);  // this block's positions: [max(s0, lo), s1)
  const int first = max(s0, (lo / TK) * TK);  // tiles start at multiples of TK
  const int ntiles = s1 > first ? (s1 - first + TK - 1) / TK : 0;
  const int nw = ntiles > warp ? (ntiles - warp + SD_WARPS - 1) / SD_WARPS : 0;  // this warp's

  // Q: row g of the m16 tile is query head hq0 + g; this warp's A
  // fragments, or at head_dim 256 the block's tile in shared memory
  const int tig = lane & 3;
  MmaQ<D> qf;
  if constexpr (MmaQ<D>::SMEM) {
    bf16* qt = reinterpret_cast<bf16*>(sd_smem + Lay::Q0);
    mma_store_q<D>(qt, q + ((int64_t)b * Hq + hq0) * D, GB, tid, SD_NT);
    __syncthreads();
    qf.point(qt, lane);
  } else {
    mma_load_q<D>(qf.qa, q + ((int64_t)b * Hq + hq0) * D, GB, lane);
  }

  // this warp's bf16 tiles (stage s: K, then V)
  bf16* wt = reinterpret_cast<bf16*>(sd_smem) + warp * Lay::NST * 2 * Lay::TILE;
  const int* pt_row = page_table + (int64_t)b * maxP;
  const TKV* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  const int vc = lane % Lay::VPR, vt0 = lane / Lay::VPR;
  // the start of this warp's i-th tile, and the source of this lane's k-th
  // vector of it; ok is false outside [lo, s1), where nothing is read
  auto tile_start = [&](int i) { return first + (warp + i * SD_WARPS) * TK; };
  auto source = [&](int st, int k, bool& ok) -> const TKV* {
    const int pos = st + vt0 + k * Lay::VSTEP;
    ok = pos >= lo && pos < s1;
    if (!ok) return kb;
    const int page = pshift >= 0 ? pos >> pshift : pos / page_size;
    return kb + ((int64_t)pt_row[page] * page_size + (pos - page * page_size)) * row_stride +
           vc * Lay::VE;
  };
  // bf16 KV: copies tile i into stage s (zeros outside [lo, s1)) and commits
  // a group either way, so that every wait counts the same groups
  auto issue = [&](int i, int s) {
    if constexpr (!Lay::WIDEN) {
      if (i < nw) {
        const int st = tile_start(i);
#pragma unroll 1  // unrolled, the bf16 build spilled 12 bytes at 128 registers
        for (int k = 0; k < Lay::NV; ++k) {
          bool ok;
          const TKV* src = source(st, k, ok);
          bf16* dk = wt + s * 2 * Lay::TILE + (vt0 + k * Lay::VSTEP) * LD + vc * 8;
          cp_async16_zfill(dk, src, ok);
          cp_async16_zfill(dk + Lay::TILE, src + v_off, ok);
        }
      }
      cp_async_commit();
    }
  };
  // fp8 KV: fetch() loads tile i into registers (zeros outside [lo, s1)),
  // put() widens them to bf16 into stage s
  uint4 rk[Lay::WIDEN ? Lay::NV : 1], rv[Lay::WIDEN ? Lay::NV : 1];
  auto fetch = [&](int i) {
    if constexpr (Lay::WIDEN) {
      const int st = tile_start(i);
#pragma unroll
      for (int k = 0; k < Lay::NV; ++k) {
        bool ok;
        const TKV* src = source(st, k, ok);
        rk[k] = rv[k] = make_uint4(0u, 0u, 0u, 0u);
        if (ok && i < nw) {
          rk[k] = __ldg(reinterpret_cast<const uint4*>(src));
          rv[k] = __ldg(reinterpret_cast<const uint4*>(src + v_off));
        }
      }
    }
  };
  auto put = [&](int s) {
    if constexpr (Lay::WIDEN) {
#pragma unroll
      for (int k = 0; k < Lay::NV; ++k) {
        uint4* dk = reinterpret_cast<uint4*>(wt + s * 2 * Lay::TILE +
                                             (vt0 + k * Lay::VSTEP) * LD + vc * 16);
        uint4* dv = dk + Lay::TILE / 8;
        widen_bf16<TKV>(rk[k], dk[0], dk[1]);
        widen_bf16<TKV>(rv[k], dv[0], dv[1]);
      }
    }
  };

  const uint32_t s_w = static_cast<uint32_t>(__cvta_generic_to_shared(wt));
  uint32_t k_lane, v_lane;
  mma_lanes<LD, TK>(lane, k_lane, v_lane);
  // p = 2^(v c - m c): v the raw dot (c folds in the scale), or the capped
  // or ALiBi-biased score
  const bool capped = cap > 0.f;
  const float c = (capped || ALIBI) ? LOG2E : scale * LOG2E;
  // ALiBi: the slopes of this lane's rows gid and gid + 8 (query heads
  // hq0 + row), the query at kv_len - 1
  MmaAlibi al{};
  if constexpr (ALIBI) {
    const int gid = lane >> 2;
    al.slope[0] = gid < GB ? alibi[hq0 + gid] : 0.f;
    al.slope[1] = gid + 8 < GB ? alibi[hq0 + gid + 8] : 0.f;
    al.qpos = kv_len - 1;
  }

  MmaState<D> ms;
  ms.reset();

  if constexpr (Lay::WIDEN) {
    fetch(0);
    put(0);
    fetch(1);
  } else {
    issue(0, 0);
    issue(1, 1);
  }
  // One __syncwarp per tile: it makes tile i visible to the warp and tells
  // every lane that the warp is done with tile i - 1, whose stage bf16 KV
  // then refills with tile i + 2; fp8 KV widens tile i + 1 into it after
  // computing.
  for (int i = 0, s = 0; i < nw; ++i, s = s + 1 == Lay::NST ? 0 : s + 1) {
    if constexpr (!Lay::WIDEN) cp_async_wait<1>();  // tile i has landed (this lane's copies)
    __syncwarp();
    issue(i + 2, s == 0 ? Lay::NST - 1 : s - 1);
    const uint32_t sK = s_w + s * Lay::STAGE_BYTES, sV = sK + Lay::TILE * 2;
    mma_tile<D, LD, TK, ALIBI>(ms, qf, sK, sV, k_lane, v_lane, tile_start(i), lo, s1, scale,
                               cap, capped, c, tig, al);
    if constexpr (Lay::WIDEN) {
      if (i + 1 < nw) put(s ^ 1);
      fetch(i + 2);
    }
  }

  // The block's merge: each warp stages its rows' (m c, l) and O in shared
  // memory; thread by thread over the G * D outputs, the warps are merged
  // in order 0..3 in log-sum-exp form
  cp_async_wait<0>();
  __syncthreads();  // every tile is idle
  float* sO = reinterpret_cast<float*>(sd_smem);  // [warp][16][D]
  float* sML = sO + SD_WARPS * 16 * D;             // [warp][16][2]
  mma_stage(ms, sO, sML, warp * 16, c, lane);
  __syncthreads();
  const float* po[SD_WARPS];
  const float* pml[SD_WARPS];
#pragma unroll
  for (int w = 0; w < SD_WARPS; ++w) {
    po[w] = sO + w * 16 * D;
    pml[w] = sML + w * 32;
  }
  const int64_t row0 = (int64_t)b * Hq + hq0;  // the block's first output row
  for (int idx = tid; idx < GB * D; idx += SD_NT) {
    const int r = idx / D, d = idx - r * D;
    float m, l, acc;
    merge_partials<D, SD_WARPS>(po, pml, SD_WARPS, r, d, m, l, acc);
    if (n_split == 1) {
      out[(row0 + r) * D + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
    } else {
      const int64_t prow = (int64_t)split * B * Hq + row0 + r;
      part[prow * D + d] = acc;
      if (d == 0) {
        float* ml = part + (int64_t)n_split * B * Hq * D + prow * 2;
        ml[0] = m;
        ml[1] = l;
      }
    }
  }
}

// Merges the n_split partials of each output row (the layout above) in
// split order: out = sum_s 2^(m_s - m) O_s / sum_s 2^(m_s - m) l_s, over
// the splits that saw a position (0 where none did).
template <int D>
__global__ void __launch_bounds__(256)
rpa_decode_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                          int n_split, int rows) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)rows * D) return;
  const int64_t row = idx / D;
  const float* ml = part + (int64_t)n_split * rows * D;
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) {
    const float* x = ml + ((int64_t)s * rows + row) * 2;
    if (x[1] > 0.f) m = fmaxf(m, x[0]);
  }
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* x = ml + ((int64_t)s * rows + row) * 2;
    if (x[1] > 0.f) {
      const float f = fast_exp2(x[0] - m);
      l = fmaf(x[1], f, l);
      acc = fmaf(part[(int64_t)s * rows * D + idx], f, acc);
    }
  }
  out[idx] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

template <typename TKV, int D, bool ALIBI>
static int launch_decode_mma(const void* q, const void* k_pool, const void* v_pool,
                             const void* pt, const void* kv_lens, void* out, int B, int Hq,
                             int Hkv, int row_stride, int maxP, int page_size, float scale,
                             float cap, int window, int n_split, int split_len, void* scratch,
                             const void* alibi, cudaStream_t stream) {
  using Lay = SdLayout<TKV, D>;
  if (n_split < 1 || split_len <= 0 || split_len % SD_STEP ||
      (int64_t)n_split * split_len < (int64_t)maxP * page_size ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool grouped = Hq / Hkv > 16;  // head groups of at most 16 query heads
  auto kernel = grouped ? rpa_decode_mma_kernel<TKV, D, ALIBI, true>
                        : rpa_decode_mma_kernel<TKV, D, ALIBI, false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int groups = Hkv * ((Hq / Hkv + 15) / 16);
  kernel<<<dim3(n_split, groups, B), SD_NT, Lay::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(scratch), Hq, Hkv, row_stride, maxP, page_size, scale, cap, window,
      split_len, static_cast<const float*>(alibi));
  if (n_split > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t n = (int64_t)B * Hq * D;
    rpa_decode_combine_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(scratch), static_cast<__nv_bfloat16*>(out), n_split, B * Hq);
  }
  return (int)cudaGetLastError();
}

template <int D, bool ALIBI>
static int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                         const void* kv_lens, void* out, int B, int Hq, int Hkv, int row_stride,
                         int maxP, int page_size, float scale, float cap, int window,
                         const void* alibi, cudaStream_t stream) {
  // the CUDA-core kernel holds G * D outputs a block (DEC_MAXO a thread);
  // the tensor-core one takes any G, in head groups of at most 16
  if ((Hq / Hkv) * D > DEC_MAXO * DEC_NT) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * dec_smem_floats<D>(Hq / Hkv);
  auto kernel = rpa_decode_kernel<D, ALIBI>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, Hkv), DEC_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<float*>(out), Hq, Hkv, row_stride, maxP,
      page_size, scale, cap, window, static_cast<const float*>(alibi));
  return (int)cudaGetLastError();
}

// The tensor-core decode for bf16 q, the CUDA-core kernel for float32 q
// (which takes no plan); their ALIBI instantiations where this build has
// them (HAS_ALIBI), else refused.
template <typename TQ, typename TKV, int D, bool ALIBI>
static int launch(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                  const void* kv_lens, void* out, int B, int Hq, int Hkv, int row_stride,
                  int maxP, int page_size, float scale, float cap, int window, int n_split,
                  int split_len, void* scratch, const void* alibi, cudaStream_t stream) {
  if constexpr (ALIBI && !HAS_ALIBI)
    return (int)cudaErrorInvalidValue;
  else if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return launch_decode_mma<TKV, D, ALIBI>(q, k_pool, v_pool, pt, kv_lens, out, B, Hq, Hkv,
                                            row_stride, maxP, page_size, scale, cap, window,
                                            n_split, split_len, scratch, alibi, stream);
  else {
    static_assert(std::is_same<TQ, float>::value && std::is_same<TKV, float>::value,
                  "the CUDA-core kernel takes the float32 pair only");
    return launch_decode<D, ALIBI>(q, k_pool, v_pool, pt, kv_lens, out, B, Hq, Hkv, row_stride,
                                   maxP, page_size, scale, cap, window, alibi, stream);
  }
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/rpa_packed.py), the
// same for every build of this file. k_pool / v_pool: K and V of the layer
// at slot 0; row_stride: elements from one slot to the next
// (rpa_common.cuh). q_type / kv_type: TypeCode. cap <= 0: no softcap;
// window <= 0: no sliding window. n_split, split_len: the split plan of the
// bf16-q pairs (n_split ranges of split_len positions, a multiple of
// SD_STEP, that cover [0, maxP * page_size)); scratch: with n_split > 1, a
// float32 scratch of n_split * B * Hq * (D + 2) elements. The float32 pair
// ignores the three. alibi_slopes: null, or ALiBi's slopes (float32 [Hq] on
// the card), which the aligned head_dim-128 build alone takes.
// Returns cudaError_t; a head_dim, type pair, plan or slopes this build
// does not take is cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                         const void* page_table, const void* kv_lens, void* out, int B, int Hq,
                         int Hkv, int D, int row_stride, int maxP, int page_size, float scale,
                         float cap, int window, int q_type, int kv_type, int n_split,
                         int split_len, void* scratch, const void* alibi_slopes,
                         void* stream) {
  using namespace rpa;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || D != RPA_HEAD_DIM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_DEC(QC, TQ, KC, TKV)                                                            \
  if (q_type == QC && kv_type == KC)                                                        \
    return (alibi_slopes ? launch<TQ, TKV, RPA_HEAD_DIM, true>                              \
                         : launch<TQ, TKV, RPA_HEAD_DIM, false>)(                           \
        q, k_pool, v_pool, page_table, kv_lens, out, B, Hq, Hkv, row_stride, maxP, page_size, \
        scale, cap, window, n_split, split_len, scratch, alibi_slopes, s);
  RPA_FOR_EACH_PAIR(RPA_DEC)
#undef RPA_DEC
  return (int)cudaErrorInvalidValue;
}
