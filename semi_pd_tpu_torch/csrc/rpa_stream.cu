// Cross-request streaming decode attention over the chunked, the 5D or the
// MLA latent KV pool, for Hopper (sm_90a).
//
// Replaces two TPU kernels (three branches), one build each (every build
// takes bf16 and fp8 e4m3 / e5m2 KV or latent rows under bf16 q, float32
// under float32 q):
//   chunked pool, head_dim 64 (rpa_decode_stream): semi_pd_tpu/ops/attention/
//     rpa_stream.py _rpa_kernel_chunked_stream;
//   5D pool, head_dim 128 (-DRPA_ALIGNED, rpa_decode_stream_aligned) and
//     256 (-DRPA_ALIGNED -DRPA_HEAD_DIM=256, rpa_decode_stream_aligned_256,
//     Gemma-2's full-attention layers): rpa_stream.py _rpa_kernel_stream,
//     its GQA branch;
//   latent pool, DeepSeek-V2's 512 + 64 with V its first 512 (-DRPA_MLA
//     -DRPA_P_F32, rpa_decode_stream_mla), and MiniCPM3's 256 + 32 with V
//     its first 256 (also -DRPA_MLA_DL=288 -DRPA_MLA_DV=256,
//     rpa_decode_stream_mla_288): the same kernel's MLA branch, which
//     computes in float32, P included.
// They compute the decode of rpa_decode.cu and rpa_decode_mla.cu with
// softcap and without a sliding window (the routing keeps windowed batches
// on the packed decode, as the JAX routing does). P is rounded as the TPU
// kernels round it: to q's type on the GQA pools, not on the latent pool.
//
// What carries over from the TPU design is the schedule, not its blocks:
// the KV tiles of many requests form ONE sequence, fetched STREAM_NBUF deep
// across request boundaries, so the next request's first tiles are in
// flight while the current one finishes. The TPU kernel streamed the whole
// batch on one core; here a persistent grid of (P, KV heads) blocks, or on
// the latent pool (P, head groups), shares it out. Each block computes the
// prefix sum of ceil(kv_len / TK) over the batch from kv_lens on the device
// (stream_scan: no host sync, no host plan). Rows with kv_len 0 write
// zeros; no slot at or past kv_len is read.
//
// bf16 q on the GQA pools: rpa_stream_mma_kernel, on the tensor cores with
// the packed decode's warp tile (rpa_decode_mma.cuh: a head group of at most
// 16 query heads of a KV head as the rows of one m16 tile, P rounded to bf16
// as the TPU kernels round it; G <= 16 is one group a KV head, StarCoder's
// multi-query G = 48 three, each reading the KV head's tiles itself). P =
// STREAM_BLOCKS_PER_SM * SMs / (Hkv ceil(G / 16)) blocks per head group
// (rpa_stream.py stream_blocks, from shapes, the KV type and the SM count:
// two blocks per SM with bf16 KV, three with fp8 KV, the card filled once),
// and the 4 P warps of a head group's
// column take equal contiguous shares of the tile sequence, cut at tile
// boundaries (not whole requests, so one long request spreads over the
// card). Each warp walks its share through its own ring of STREAM_NBUF
// stages by cp.async (one commit group per tile, each waited for exactly
// once; the ring does not drain at a request boundary): bf16 KV lands in
// padded bf16 stages that ldmatrix reads in place, fp8 KV lands raw and is
// widened exactly to bf16 from shared memory one tile ahead of the mma. A
// warp needs only __syncwarp while it streams. Its softmax state resets at
// a request's first tile; a request whole in one warp is written there, one
// cut between warps of a block is merged in shared memory in warp order
// (the partial of a request cut at a warp's first tile waits in the
// caller's scratch until the ring is idle), one cut across blocks leaves
// float32 partials in the scratch, which rpa_stream_combine_kernel merges
// in block order. No atomics: two calls are bitwise equal. The warp tile is
// STREAM_TK = 1024 / D positions (16 at head_dim 64, 8 at 128, where P V
// takes mma m16n8k8), so that the four rings of two blocks (bf16 KV) or
// three (fp8 KV) fit an SM at both widths (StreamLayout): the more tiles in
// flight per SM, the closer to the bytes' time. At head_dim 256 the tile
// stays at 8 positions (m16n8k8 needs 8), so a warp's ring is 33 KB and one
// block an SM, either KV type; each warp keeps its request's Q rows in a
// shared tile of its own and reads its A fragments from there (MmaQ, as
// the packed decode at 256).
//
// bf16 q on the latent pool: rpa_stream_mla_mma_kernel, on the tensor cores
// with the packed MLA decode's block tile (rpa_mla_mma.cuh: the query heads
// as the rows of one m16 tile, the four warps of a block sharing each latent
// tile, P as hi + lo). The schedule is the one above with the block, not the
// warp, as the unit that takes a share, and the share cut at the tile's
// fixed chunks of 256 positions: P = MLA_MMA_BLOCKS_PER_SM * SMs / HG blocks
// per head group (two per SM at 576, four at 288; one group of 16 heads on
// DeepSeek-V2-Lite, 16 / 16 / 8 on MiniCPM3's 40),
// each an equal contiguous share of the batch's chunks through its own
// ring, the chunks of a request merged from the scratch by
// rpa_mla_combine_kernel as the packed decode merges them, so that the two
// give the same bits.
//
// float32 q (rpa_stream_kernel, rpa_stream_mla_kernel) stays on the CUDA
// cores, with P = min(B, resident blocks per SM * SMs / the second grid
// dimension, groups of MLA_STREAM_HB query heads on the latent pool): each
// block takes
// the contiguous run of whole requests whose first tile falls in its 1/P
// share of all tiles, walks them through a ring of STREAM_NBUF stages of
// raw KV bytes (16-byte cp.async.cg copies, one commit group per tile),
// widens each tile to float32 on the read side (KVTile::take and store)
// and computes it as the CUDA-core decode kernels do (rpa_decode.cuh,
// rpa_mla.cuh).
//
// Bound on this card: bytes, as the decode's (rpa_decode.cu,
// rpa_mla_mma.cuh): every live KV row is read once; the tensor-core kernels
// do 4 * Hq * D operations per position (2 Hq (576 + 512) on the latent
// pool, 2 Hq (288 + 256) at 288) on bf16 tensor cores, far below the
// bytes' time.
#include <type_traits>

#include "rpa_decode.cuh"
#include "rpa_decode_mma.cuh"
#include "rpa_mla_mma.cuh"

namespace rpa {

// Ring depth: the JAX kernels' default RPA_STREAM_NBUF, a build constant.
constexpr int STREAM_NBUF = 4;
constexpr int STREAM_NT = 128;  // threads per block, both kernels
static_assert(STREAM_NT == DEC_NT, "the GQA stream computes with the decode's block");

__device__ __forceinline__ int stream_tiles(int kv_len, int max_len, int TK) {
  const int n = min(kv_len, max_len);
  return n > 0 ? (n + TK - 1) / TK : 0;
}

// The batch's tile count `total`, and this thread's chunk [b0, b1) of
// requests with its tile count `mine` and the tiles of the requests before
// it, `first`: each thread sums a contiguous chunk of requests, and the
// chunks' exclusive scan runs over the warps in shared memory.
__device__ __forceinline__ void stream_scan(const int* __restrict__ kv_lens, int B, int max_len,
                                            int TK, int& b0, int& b1, int& mine, int& first,
                                            int& total) {
  constexpr int NW = STREAM_NT / 32;
  __shared__ int s_part[NW];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = (B + STREAM_NT - 1) / STREAM_NT;
  b0 = min(B, tid * per);
  b1 = min(B, b0 + per);
  mine = 0;
  for (int b = b0; b < b1; ++b) mine += stream_tiles(kv_lens[b], max_len, TK);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  first = incl - mine;
  total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    total += s_part[w];
    if (w < warp) first += s_part[w];
  }
}

// This block's run [r0, r1) of the batch (the CUDA-core kernels). Request b
// goes to block min(P - 1, first(b) * P / total), where first(b) is the
// prefix sum of the tile counts of the requests before b and total the
// batch's tile count: the owner never decreases with b, so each run is
// contiguous, and each block gets about total / P tiles in whole requests.
__device__ __forceinline__ void stream_run(const int* __restrict__ kv_lens, int B, int max_len,
                                           int TK, int& r0, int& r1) {
  constexpr int NW = STREAM_NT / 32;
  __shared__ int s_cnt[2][NW];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.x, P = gridDim.x;
  int b0, b1, mine, first, total;
  stream_scan(kv_lens, B, max_len, TK, b0, b1, mine, first, total);
  unsigned below = 0, upto = 0;
  for (int b = b0; b < b1; ++b) {
    const int own = total > 0 ? min(P - 1, (int)((int64_t)first * P / total)) : 0;
    below += own < p;
    upto += own <= p;
    first += stream_tiles(kv_lens[b], max_len, TK);
  }
  below = __reduce_add_sync(0xffffffffu, below);
  upto = __reduce_add_sync(0xffffffffu, upto);
  if (lane == 0) {
    s_cnt[0][warp] = (int)below;
    s_cnt[1][warp] = (int)upto;
  }
  __syncthreads();
  r0 = r1 = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    r0 += s_cnt[0][w];
    r1 += s_cnt[1][w];
  }
}

// The fetch side of the ring: the next (request r, tile t) of the run
// [r, r1) to issue; n is request r's tile count. next() issues it, if the
// run has one left, into the stage of its ordinal, and commits one group
// either way, so the consumer's cp_async_wait<STREAM_NBUF - 1> always
// leaves its own tile complete.
template <typename Tile, typename TKV, int TK>
struct StreamFetch {
  const TKV* kb;
  int64_t v_off, row_stride;
  const int* page_table;
  const int* kv_lens;
  int maxP, page_size, max_len, r, r1, t, n, issued;

  __device__ __forceinline__ StreamFetch(const TKV* kb_, int64_t v_off_, int64_t row_stride_,
                                         const int* page_table_, const int* kv_lens_, int maxP_,
                                         int page_size_, int r0, int r1_)
      : kb(kb_), v_off(v_off_), row_stride(row_stride_), page_table(page_table_),
        kv_lens(kv_lens_), maxP(maxP_), page_size(page_size_), max_len(maxP_ * page_size_),
        r(r0), r1(r1_), t(0), n(r0 < r1_ ? stream_tiles(kv_lens_[r0], maxP_ * page_size_, TK) : 0),
        issued(0) {}

  __device__ __forceinline__ void next(const Tile& tile, uint4* ring, int tid) {
    while (r < r1 && t >= n) {  // request r is done (or has no tile): on to the next
      ++r;
      t = 0;
      n = r < r1 ? stream_tiles(kv_lens[r], max_len, TK) : 0;
    }
    if (r < r1) {
      tile.issue(kb, v_off, page_table + (int64_t)r * maxP, page_size, row_stride, t * TK,
                 min(kv_lens[r], max_len), tid, ring + (issued % STREAM_NBUF) * Tile::NVEC);
      ++t;
      ++issued;
    }
    cp_async_commit();
  }
};

// GQA over the chunked or the 5D pool: block (p, KV head h) streams its
// run's G query rows per request (rpa_decode.cuh computes each tile).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(STREAM_NT)
rpa_stream_kernel(const TQ* __restrict__ q,            // [B, Hq, D]
                  const TKV* __restrict__ k_pool,      // K of this layer at slot 0
                  const TKV* __restrict__ v_pool,      // V of this layer at slot 0
                  const int* __restrict__ page_table,  // [B, maxP]
                  const int* __restrict__ kv_lens,     // [B]
                  TQ* __restrict__ out,                // [B, Hq, D]
                  int B, int Hq, int Hkv, int row_stride, int maxP, int page_size,
                  float scale, float cap) {
  constexpr int TK = dec_tk<D>(), LD = dec_ld<D>();
  using Tile = KVTile<TKV, D, TK, STREAM_NT>;
  extern __shared__ __align__(16) float smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [STREAM_NBUF][Tile::NVEC]
  const int h = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv;
  const DecodeSmem s = dec_smem<D>(smem + STREAM_NBUF * Tile::NVEC * 4, G);
  const int max_len = maxP * page_size;
  int r0, r1;
  stream_run(kv_lens, B, max_len, TK, r0, r1);

  Tile tile;
  StreamFetch<Tile, TKV, TK> fetch(k_pool + (int64_t)h * D, v_pool - k_pool, row_stride,
                                   page_table, kv_lens, maxP, page_size, r0, r1);
  for (int i = 0; i < STREAM_NBUF - 1; ++i) fetch.next(tile, ring, tid);
  float acc[DEC_MAXO];
  int used = 0;  // tiles consumed: the ordinal of the next one
  for (int r = r0; r < r1; ++r) {
    const int limit = min(kv_lens[r], max_len);
    const int64_t row = (int64_t)r * Hq + (int64_t)h * G;
    if (limit <= 0) {  // padded batch row
      for (int i = tid; i < G * D; i += STREAM_NT) out[row * D + i] = from_f<TQ>(0.f);
      continue;
    }
    for (int start = 0; start < limit; start += TK) {
      fetch.next(tile, ring, tid);
      cp_async_wait<STREAM_NBUF - 1>();
      tile.take(ring + (used % STREAM_NBUF) * Tile::NVEC, start, limit, tid);
      ++used;
      __syncthreads();  // the previous tile, and request, are fully consumed
      tile.template store<LD>(s.sK, s.sV, tid);
      if (start == 0) decode_begin<TQ, D>(s, q + row * D, G, acc, tid);
      __syncthreads();
      decode_tile<TQ, D>(s, acc, G, start, limit, scale, cap, tid);
    }
    decode_end<TQ, D>(s, acc, out + row * D, G, tid);
  }
  cp_async_wait<0>();  // only empty groups are left
}

// MLA over the latent pool: block (p, group g of MLA_STREAM_HB query heads)
// streams its run, the heads as rows of MLA_TPR threads each (MlaRows, as
// in rpa_decode_mla.cu: 8 heads a block at 576, 16 at 288).
constexpr int MLA_STREAM_HB = STREAM_NT / MLA_TPR;  // query heads per block

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(STREAM_NT)
rpa_stream_mla_kernel(const TQ* __restrict__ q,            // [B, Hq, MLA_DL]
                      const TKV* __restrict__ lat,         // latent rows of this layer at slot 0
                      const int* __restrict__ page_table,  // [B, maxP]
                      const int* __restrict__ kv_lens,     // [B]
                      TQ* __restrict__ out,                // [B, Hq, MLA_DV]
                      int B, int Hq, int maxP, int page_size, float scale, float cap) {
  constexpr int TK = MLA_TK, TPR = STREAM_NT / MLA_STREAM_HB;  // TPR: threads per head
  using Tile = KVTile<TKV, MLA_DL, TK, STREAM_NT, 1>;
  extern __shared__ __align__(16) float smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);          // [STREAM_NBUF][Tile::NVEC]
  float* sK = smem + STREAM_NBUF * Tile::NVEC * 4;        // [TK][MLA_LD]
  const int tid = threadIdx.x, part = tid % TPR;
  const int h = blockIdx.y * MLA_STREAM_HB + tid / TPR;
  const int n_act = h < Hq ? 1 : 0;
  const unsigned row_mask = mla_row_mask<TPR>(tid);
  const int max_len = maxP * page_size;
  int r0, r1;
  stream_run(kv_lens, B, max_len, TK, r0, r1);

  Tile tile;
  StreamFetch<Tile, TKV, TK> fetch(lat, 0, MLA_DL, page_table, kv_lens, maxP, page_size, r0,
                                   r1);
  for (int i = 0; i < STREAM_NBUF - 1; ++i) fetch.next(tile, ring, tid);
  MlaRows<TQ, TPR, 1> rows;
  int used = 0;
  for (int r = r0; r < r1; ++r) {
    const int kv_len = kv_lens[r];
    const int limit = min(kv_len, max_len);
    const int64_t row = (int64_t)r * Hq + min(h, Hq - 1);
    rows.begin(q + row * MLA_DL, 0, n_act, part);
    for (int start = 0; start < limit; start += TK) {
      fetch.next(tile, ring, tid);
      cp_async_wait<STREAM_NBUF - 1>();
      tile.take(ring + (used % STREAM_NBUF) * Tile::NVEC, start, limit, tid);
      ++used;
      __syncthreads();  // the previous tile is fully consumed
      tile.template store<MLA_LD>(sK, sK, tid);
      __syncthreads();
      rows.tile(sK, start, limit, kv_len - 1, 0, scale, cap, 0, part, row_mask);
    }
    rows.write(out + row * MLA_DV, 0, n_act, part);  // zeros where limit <= 0
  }
  cp_async_wait<0>();
}

// P blocks per column of the grid: as many as the card holds at once.
template <typename Kernel>
static int stream_blocks(Kernel kernel, size_t smem, int B, int columns, int& P) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STREAM_NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  P = max(1, min(B, per_sm * sms / columns));
  return 0;
}

template <typename TQ, typename TKV, int D>
static int launch_stream(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                         const void* kv_lens, void* out, int B, int Hq, int Hkv, int row_stride,
                         int maxP, int page_size, float scale, float cap, cudaStream_t stream) {
  // the CUDA-core kernel holds G * D outputs a block (DEC_MAXO a thread);
  // the tensor-core one takes any G, in head groups of at most 16
  if ((Hq / Hkv) * D > DEC_MAXO * DEC_NT) return (int)cudaErrorInvalidValue;
  using Tile = KVTile<TKV, D, dec_tk<D>(), STREAM_NT>;
  const size_t smem =
      sizeof(uint4) * STREAM_NBUF * Tile::NVEC + sizeof(float) * dec_smem_floats<D>(Hq / Hkv);
  auto kernel = rpa_stream_kernel<TQ, TKV, D>;
  int P = 0;
  if (int e = stream_blocks(kernel, smem, B, Hkv, P)) return e;
  kernel<<<dim3(P, Hkv), STREAM_NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<TQ*>(out), B, Hq, Hkv, row_stride, maxP,
      page_size, scale, cap);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
static int launch_stream_mla(const void* q, const void* lat, const void* pt, const void* kv_lens,
                             void* out, int B, int Hq, int maxP, int page_size, float scale,
                             float cap, cudaStream_t stream) {
  using Tile = KVTile<TKV, MLA_DL, MLA_TK, STREAM_NT, 1>;
  const size_t smem =
      sizeof(uint4) * STREAM_NBUF * Tile::NVEC + sizeof(float) * MLA_TK * MLA_LD;
  auto kernel = rpa_stream_mla_kernel<TQ, TKV>;
  const int groups = (Hq + MLA_STREAM_HB - 1) / MLA_STREAM_HB;
  int P = 0;
  if (int e = stream_blocks(kernel, smem, B, groups, P)) return e;
  kernel<<<dim3(P, groups), STREAM_NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(lat), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<TQ*>(out), B, Hq, maxP, page_size, scale,
      cap);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The tensor-core stream (bf16 q over bf16 or fp8 KV).

// The schedule's constants for this build's head_dim; ops/attention/
// rpa_stream.py states the same (STREAM_TILE per build, STREAM_NBUF,
// STREAM_WARPS, STREAM_BLOCKS_PER_SM and STREAM_BLOCKS_PER_SM_FP8), and a
// CPU test (tests/test_torch_stream_split.py) evaluates these lines to hold
// the two equal.
constexpr int STREAM_D256 = RPA_HEAD_DIM / 256;  // 1 at head_dim 256, 0 below
// KV positions per warp tile: 1024 / head_dim, and 8 at 256
constexpr int STREAM_TK = 1024 / RPA_HEAD_DIM + 4 * STREAM_D256;
constexpr int STREAM_WARPS = STREAM_NT / 32;
// blocks an SM holds with bf16 KV (StreamLayout), and with fp8 KV: one at 256
constexpr int STREAM_BLOCKS_PER_SM = 2 - STREAM_D256;
constexpr int STREAM_BLOCKS_PER_SM_FP8 = 3 - 2 * STREAM_D256;

// A warp's shared memory: its ring of STREAM_NBUF stages (bf16 KV: K and V
// tiles in bf16 with padded rows, read by ldmatrix in place; fp8 KV: the
// pool's raw bytes, then two bf16 tiles it is widened into); after the
// four rings, each warp's Q tile (MmaQ<D>::SMEM, head_dim 256). Once the
// ring is idle it holds the warp's two partials for the block's merge: slot 1
// (a request cut at the warp's last tile), then slot 0 (cut at its first
// tile, kept in the scratch while the ring streams).
template <typename TKV, int D>
struct StreamLayout {
  static constexpr bool WIDEN = sizeof(TKV) == 1;
  static constexpr int TK = STREAM_TK;
  static constexpr int LD = D + 8;                  // bf16 row stride: no ldmatrix conflicts
  static constexpr int TILE = TK * LD;              // bf16 elements of one K or V tile
  static constexpr int BF_BYTES = 2 * TILE * 2;     // a K and a V tile in bf16
  static constexpr int STAGE_BYTES = WIDEN ? 2 * TK * D : BF_BYTES;  // one ring stage
  static constexpr int RING_BYTES = STREAM_NBUF * STAGE_BYTES + (WIDEN ? 2 * BF_BYTES : 0);
  static constexpr int PART = 16 * (D + 2);         // floats of a partial: O [16][D], (m c, l) [16][2]
  static constexpr int Q0 = STREAM_WARPS * RING_BYTES;  // the warps' Q tiles
  static constexpr int SMEM = Q0 + STREAM_WARPS * MmaQ<D>::BYTES;
  static constexpr int BLOCKS = WIDEN ? STREAM_BLOCKS_PER_SM_FP8 : STREAM_BLOCKS_PER_SM;
  static constexpr int VE = 16 / (int)sizeof(TKV);  // KV elements per 16-byte vector
  static constexpr int VPR = D / VE;                // vectors per K or V row
  static constexpr int NV = TK * VPR / 32;          // of K (and of V) per lane
  static constexpr int VSTEP = 32 / VPR;            // rows between a lane's vectors
  static_assert(D == RPA_HEAD_DIM && D % 32 == 0 && (TK == 8 || TK % 16 == 0), "tile shape");
  static_assert(32 % VPR == 0 && (TK * VPR) % 32 == 0 && NV >= 1, "tile shape");
  static_assert(2 * PART * 4 <= RING_BYTES && RING_BYTES % 16 == 0, "partials in the ring");
  static_assert(MmaQ<D>::BYTES % 16 == 0, "Q tiles aligned");
  // BLOCKS blocks fit in an SM's 228 KB of shared memory (1 KB of it
  // reserved per block, and the kernel's static shared memory). More
  // blocks keep more tiles in flight: fp8 KV, at half the bytes per tile,
  // gains from a third; bf16 KV, nearer the memory's rate, lost (PERF.md)
  static_assert(BLOCKS * (SMEM + 1024 + 128) <= 233472, "blocks per SM");
};

// The caller's float32 scratch (P blocks per head group, HG = Hkv ceil(G /
// 16) head groups of GS = min(G, 16) rows): each warp's slot-0 partial, GS
// rows per (head group, warp) of O, then of (m c, l); each block's two
// partials for the combine pass, GS rows per (head group, block, slot),
// likewise; one int4 descriptor per (head group, block). P * (6 * HG * GS *
// (D + 2) + 4 * HG) floats in all (HG GS = Hq at G <= 16).
struct StreamScratch {
  float *wo, *wml, *bo, *bml;
  int4* desc;
  __device__ __forceinline__ StreamScratch(float* part, int HG, int P, int GS, int D) {
    const int64_t nw = (int64_t)HG * STREAM_WARPS * P * GS, nb = (int64_t)HG * P * 2 * GS;
    wo = part;
    wml = wo + nw * D;
    bo = wml + nw * 2;
    bml = bo + nb * D;
    desc = reinterpret_cast<int4*>(bml + nb * 2);
  }
};

// Block (p, head group hg) of P x Hkv ceil(G / 16), warp w of 4: the query
// heads [hq0, hq0 + GB) of KV head h (mma_head_group; GROUPS: G > 16),
// and the batch's tiles of TK positions, request-major (each request's ceil(min(kv_len, maxP *
// page_size) / TK) tiles in order), form one sequence of T tiles; global
// warp v = 4 p + w walks [s_v, s_v+1), s_v = floor(v T / (4 P)): equal
// shares cut at tile boundaries, differing by at most one tile. A warp
// resets its softmax at a request's first tile, or at its own first tile,
// and ends a segment at the request's last tile or at its own last. A
// request whole in one warp is written there. One cut between warps of this
// block is merged in shared memory in warp order; one cut across blocks
// leaves one float32 partial per block in `part` (slot 0: the request at
// the block's first tile, begun in an earlier block; slot 1: the request
// at its last tile, going on in a later one), and rpa_stream_combine_kernel
// merges them in block order. Rows with no position are written as zeros
// by block r % P.
template <typename TKV, int D, bool GROUPS>
__global__ void __launch_bounds__(STREAM_NT, StreamLayout<TKV, D>::BLOCKS)
rpa_stream_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
                      const TKV* __restrict__ k_pool,       // K of this layer at slot 0
                      const TKV* __restrict__ v_pool,       // V of this layer at slot 0
                      const int* __restrict__ page_table,   // [B, maxP]
                      const int* __restrict__ kv_lens,      // [B]
                      __nv_bfloat16* __restrict__ out,      // [B, Hq, D]
                      float* __restrict__ part,  // StreamScratch
                      int B, int Hq, int Hkv, int row_stride, int maxP, int page_size,
                      float scale, float cap) {
  using bf16 = __nv_bfloat16;
  using Lay = StreamLayout<TKV, D>;
  constexpr int TK = Lay::TK, LD = Lay::LD, NW = STREAM_WARPS;
  extern __shared__ __align__(16) unsigned char st_smem[];
  // boundary k of the block's shares, the request holding its tile and that
  // request's first tile
  __shared__ int sb[NW + 1], s_req[NW + 1], s_first[NW + 1];
  const int p = blockIdx.x, P = gridDim.x, hg = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane >> 2,
            tig = lane & 3;
  const int max_len = maxP * page_size;
  int h, hq0, GB;
  mma_head_group<GROUPS>(Hq, Hkv, hg, h, hq0, GB);
  // the scratch's head groups and rows a group (without GROUPS: the KV
  // heads and their G)
  const int HG = GROUPS ? (int)gridDim.y : Hkv, GS = GROUPS ? 16 : GB;

  // the tile sequence and the block's boundaries s_k = s_(4 p + k), k = 0..4;
  // the thread whose chunk holds tile s_k finds its request
  int b0, b1, mine, first, T;
  stream_scan(kv_lens, B, max_len, TK, b0, b1, mine, first, T);
#pragma unroll
  for (int k = 0; k <= NW; ++k) {
    const int s = (int)((int64_t)(NW * p + k) * T / (NW * P));
    if (tid == 0) sb[k] = s;
    if (s >= T) {
      if (tid == 0) {
        s_req[k] = B;
        s_first[k] = T;
      }
    } else if (s >= first && s < first + mine) {
      int f = first;
      for (int b = b0; b < b1; ++b) {
        const int n = stream_tiles(kv_lens[b], max_len, TK);
        if (s < f + n) {
          s_req[k] = b;
          s_first[k] = f;
          break;
        }
        f += n;
      }
    }
  }
  __syncthreads();
  // boundary k cuts its request when that request began before it
  auto cut = [&](int k) { return sb[k] < T && s_first[k] < sb[k]; };
  const StreamScratch scr(part, HG, P, GS, D);

  // this warp's ring, and its slot-0 partial in the scratch
  unsigned char* wbase = st_smem + warp * Lay::RING_BYTES;
  const int64_t wrow = ((int64_t)hg * NW * P + NW * p + warp) * GS;
  const TKV* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  const int vc = lane % Lay::VPR, vt0 = lane / Lay::VPR;
  const int ntiles = sb[warp + 1] - sb[warp];

  // The fetch side: the next tile to copy, tile ft of request fr (fn tiles
  // within flim = min(kv_len, maxP * page_size)), and the page of each of
  // this lane's rows of it, loaded a tile ahead so that no copy waits on the
  // page table. One commit group per issue(), empty past the share's end,
  // so that cp_async_wait<STREAM_NBUF - 2> before tile i always leaves tile
  // i complete, across request boundaries too.
  int fr = s_req[warp], ft = sb[warp] - s_first[warp], flim = 0, fn = 0, issued = 0;
  int pg[Lay::NV];
  auto page_of = [&](int pos) { return pshift >= 0 ? pos >> pshift : pos / page_size; };
  auto next_pages = [&]() {
    while (ft >= fn) {  // the next request with a tile; its q rows into L2
      ++fr;
      ft = 0;
      flim = min(kv_lens[fr], max_len);
      fn = flim > 0 ? (flim + TK - 1) / TK : 0;
      if (lane * 32 < GB * D * 2)
        prefetch_l2(reinterpret_cast<const char*>(q + ((int64_t)fr * Hq + hq0) * D) +
                    lane * 32);
    }
    const int* pt_row = page_table + (int64_t)fr * maxP;
#pragma unroll
    for (int k = 0; k < Lay::NV; ++k) {
      const int pos = ft * TK + vt0 + k * Lay::VSTEP;
      pg[k] = pos < flim ? pt_row[page_of(pos)] : 0;
    }
  };
  if (ntiles > 0) {
    flim = min(kv_lens[fr], max_len);
    fn = (flim + TK - 1) / TK;
    next_pages();
  }
  auto issue = [&]() {
    if (issued < ntiles) {
      unsigned char* stage = wbase + (issued % STREAM_NBUF) * Lay::STAGE_BYTES;
#pragma unroll
      for (int k = 0; k < Lay::NV; ++k) {
        const int row = vt0 + k * Lay::VSTEP, pos = ft * TK + row;
        const bool ok = pos < flim;  // nothing at or past kv_len is read
        const TKV* src =
            ok ? kb + ((int64_t)pg[k] * page_size + (pos - page_of(pos) * page_size)) *
                          row_stride + vc * Lay::VE
               : kb;
        if constexpr (Lay::WIDEN) {  // raw bytes, vector (row, vc) of K, then of V
          uint4* dk = reinterpret_cast<uint4*>(stage) + row * Lay::VPR + vc;
          cp_async16_zfill(dk, src, ok);
          cp_async16_zfill(dk + TK * Lay::VPR, src + v_off, ok);
        } else {
          bf16* dk = reinterpret_cast<bf16*>(stage) + row * LD + vc * 8;
          cp_async16_zfill(dk, src, ok);
          cp_async16_zfill(dk + Lay::TILE, src + v_off, ok);
        }
      }
      ++ft;
      if (++issued < ntiles) next_pages();
    }
    cp_async_commit();
  };
  // fp8 KV: the raw stage of tile i, widened exactly by the lanes that copied
  // it into bf16 tile i % 2
  bf16* wide = reinterpret_cast<bf16*>(wbase + STREAM_NBUF * Lay::STAGE_BYTES);
  auto widen = [&](int i) {
    if constexpr (Lay::WIDEN) {
      const uint4* stage =
          reinterpret_cast<const uint4*>(wbase + (i % STREAM_NBUF) * Lay::STAGE_BYTES);
#pragma unroll
      for (int k = 0; k < Lay::NV; ++k) {
        const int row = vt0 + k * Lay::VSTEP;
        uint4* dk = reinterpret_cast<uint4*>(wide + (i & 1) * 2 * Lay::TILE + row * LD + vc * 16);
        uint4* dv = dk + Lay::TILE / 8;
        widen_bf16<TKV>(stage[row * Lay::VPR + vc], dk[0], dk[1]);
        widen_bf16<TKV>(stage[TK * Lay::VPR + row * Lay::VPR + vc], dv[0], dv[1]);
      }
    }
  };

  const uint32_t s_w = static_cast<uint32_t>(
      __cvta_generic_to_shared(Lay::WIDEN ? static_cast<void*>(wide) : wbase));
  uint32_t k_lane, v_lane;
  mma_lanes<LD, TK>(lane, k_lane, v_lane);
  // p = 2^(v c - m c): v the raw dot (c folds in the scale) or the capped score
  const bool capped = cap > 0.f;
  const float c = capped ? LOG2E : scale * LOG2E;

  // the compute side: request cr, tile ct of its cn, within kv_len climit;
  // the segment began at tile ct0 of the request
  int cr = fr, ct = ft, climit = flim, cn = fn, ct0 = 0;
  bool staged0 = false, staged1 = false;
  MmaQ<D> qf;
  bf16* wq = reinterpret_cast<bf16*>(st_smem + Lay::Q0 + warp * MmaQ<D>::BYTES);
  if constexpr (MmaQ<D>::SMEM) qf.point(wq, lane);
  MmaState<D> ms;
  // a whole request's rows go straight to the output
  auto write_out = [&]() {
    const int64_t row0 = (int64_t)cr * Hq + hq0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float l = mma_row_sum(ms, rr);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int r = gid + 8 * rr;
      if (r < GB) {
#pragma unroll
        for (int d = 0; d < D / 8; ++d)
          *reinterpret_cast<uint32_t*>(out + (row0 + r) * D + d * 8 + 2 * tig) =
              pack_bf16(ms.o[d][2 * rr] * inv, ms.o[d][2 * rr + 1] * inv);
      }
    }
  };

  for (int i = 0; i < STREAM_NBUF - 1; ++i) issue();
  if constexpr (Lay::WIDEN) {
    if (ntiles > 0) {
      cp_async_wait<STREAM_NBUF - 2>();  // raw tile 0 has landed
      widen(0);
    }
    issue();
  }
  for (int i = 0; i < ntiles; ++i) {
    if constexpr (!Lay::WIDEN) cp_async_wait<STREAM_NBUF - 2>();  // tile i has landed
    // bf16 KV: tile i is visible to the warp and every lane is done with
    // tile i - 1, whose stage takes tile i + STREAM_NBUF - 1; fp8 KV: bf16
    // tile i is visible and every lane is done with bf16 tile i - 1
    __syncwarp();
    if constexpr (!Lay::WIDEN) issue();
    while (ct >= cn) {
      ++cr;
      ct = 0;
      climit = min(kv_lens[cr], max_len);
      cn = climit > 0 ? (climit + TK - 1) / TK : 0;
    }
    if (i == 0 || ct == 0) {  // a segment begins
      ct0 = ct;
      const bf16* qb = q + ((int64_t)cr * Hq + hq0) * D;
      if constexpr (MmaQ<D>::SMEM) {
        // every lane is past its reads of the previous request's tile (the
        // __syncwarp above); the new one is visible after the next
        mma_store_q<D>(wq, qb, GB, lane, 32);
        __syncwarp();
      } else {
        mma_load_q<D>(qf.qa, qb, GB, lane);
      }
      ms.reset();
    }
    const uint32_t sK = s_w + (Lay::WIDEN ? (i & 1) * Lay::BF_BYTES
                                          : (i % STREAM_NBUF) * Lay::STAGE_BYTES);
    mma_tile<D, LD, TK>(ms, qf, sK, sK + Lay::TILE * 2, k_lane, v_lane, ct * TK, 0, climit,
                        scale, cap, capped, c, tig);
    ++ct;
    if (ct == cn || i + 1 == ntiles) {  // a segment ends
      if (ct0 == 0 && ct == cn)
        write_out();
      else if (ct0 > 0) {  // cut at the warp's first tile: to the scratch
        mma_stage<D, true>(ms, scr.wo + wrow * D, scr.wml + wrow * 2, 0, c, lane, GB);
        staged0 = true;
      } else {  // cut at the warp's last tile: staged once the ring is idle
        staged1 = true;
      }
    }
    if constexpr (Lay::WIDEN) {
      cp_async_wait<STREAM_NBUF - 2>();  // raw tile i + 1 has landed
      if (i + 1 < ntiles) widen(i + 1);
      issue();
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncwarp();  // the ring is idle, and the scratch's slot 0 visible to the warp
  float* slot1 = reinterpret_cast<float*>(wbase);
  float* slot0 = slot1 + Lay::PART;
  if (staged1) mma_stage(ms, slot1, slot1 + 16 * D, 0, c, lane);
  if (staged0) {
    for (int i = lane; i < GB * D; i += 32) slot0[i] = scr.wo[wrow * D + i];
    for (int i = lane; i < GB * 2; i += 32) slot0[16 * D + i] = scr.wml[wrow * 2 + i];
  }
  __syncthreads();

  // The block's merges, one per request cut at boundaries k_lo..k_hi: the
  // slot-1 partial of warp k_lo - 1 (k_lo >= 1), then the slot-0 partials of
  // warps k_lo..min(k_hi, 3) with a tile; the output if the request lies in
  // the block (k_lo >= 1 and k_hi <= 3), else the block's partial slot
  for (int k_lo = 0; k_lo <= NW; ++k_lo) {
    if (!cut(k_lo)) continue;
    const int r = s_req[k_lo];
    int k_hi = k_lo;
    while (k_hi < NW && cut(k_hi + 1) && s_req[k_hi + 1] == r) ++k_hi;
    const float* po[NW];
    const float* pml[NW];
    int n = 0;
    if (k_lo >= 1) {
      po[n] = reinterpret_cast<const float*>(st_smem + (k_lo - 1) * Lay::RING_BYTES);
      pml[n++] = po[0] + 16 * D;
    }
    for (int j = k_lo; j <= min(k_hi, NW - 1); ++j)
      if (sb[j] < sb[j + 1]) {
        po[n] = reinterpret_cast<const float*>(st_smem + j * Lay::RING_BYTES) + Lay::PART;
        pml[n] = po[n] + 16 * D;
        ++n;
      }
    if (n == 0) {  // a block without a tile
      k_lo = k_hi;
      continue;
    }
    const bool whole = k_lo >= 1 && k_hi < NW;
    const int64_t row0 = (int64_t)r * Hq + hq0;
    const int64_t brow = (((int64_t)hg * P + p) * 2 + (k_lo == 0 ? 0 : 1)) * GS;
    for (int idx = tid; idx < GB * D; idx += STREAM_NT) {
      const int g = idx / D, d = idx - g * D;
      float m, l, acc;
      merge_partials<D, NW>(po, pml, n, g, d, m, l, acc);
      if (whole) {
        out[(row0 + g) * D + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
      } else {
        scr.bo[(brow + g) * D + d] = acc;
        if (d == 0) {
          scr.bml[(brow + g) * 2] = m;
          scr.bml[(brow + g) * 2 + 1] = l;
        }
      }
    }
    k_lo = k_hi;
  }

  if (P > 1 && tid == 0) {
    // the request cut at the block's first boundary, if its last tile is in
    // this block: the combine pass merges it from its first block pf on
    int4 dsc = make_int4(-1, 0, T, 0);
    if (cut(0) && s_first[0] + stream_tiles(kv_lens[s_req[0]], max_len, TK) <= sb[NW]) {
      const int f = s_first[0];
      int pf = (int)((int64_t)f * P / T);
      while (pf + 1 < P && (int)((int64_t)(pf + 1) * T / P) <= f) ++pf;
      dsc.x = s_req[0];
      dsc.y = pf;
    }
    scr.desc[(int64_t)hg * P + p] = dsc;
  }
  for (int r = p; r < B; r += P)  // rows with no position
    if (stream_tiles(kv_lens[r], max_len, TK) == 0)
      for (int i = tid; i < GB * D; i += STREAM_NT)
        out[((int64_t)r * Hq + hq0) * D + i] = __float2bfloat16(0.f);
}

// Merges the partials of each request cut across blocks, block (p, hg) the
// request whose last tile lies in block p (rpa_stream_mma_kernel's
// descriptor): slot 1 of its first block pf, then slot 0 of every later
// block up to p that holds a tile, in block order, in log-sum-exp form. One
// pass, a thread per output (GB * D <= 512 on the 1B-class and 8B paths), so
// that the loads of every block are in flight together.
constexpr int STREAM_COMBINE_NT = 512;

template <int D, bool GROUPS>
__global__ void __launch_bounds__(STREAM_COMBINE_NT)
rpa_stream_combine_kernel(float* __restrict__ part, __nv_bfloat16* __restrict__ out, int Hq,
                          int Hkv) {
  const int p = blockIdx.x, P = gridDim.x, hg = blockIdx.y;
  int h, hq0, GB;
  mma_head_group<GROUPS>(Hq, Hkv, hg, h, hq0, GB);
  // the scratch's head groups and rows a group (without GROUPS: the KV
  // heads and their G)
  const int HG = GROUPS ? (int)gridDim.y : Hkv, GS = GROUPS ? 16 : GB;
  const StreamScratch scr(part, HG, P, GS, D);
  const int4 dsc = scr.desc[(int64_t)hg * P + p];
  if (dsc.x < 0) return;
  const int pf = dsc.y, T = dsc.z;
  const int64_t row0 = (int64_t)dsc.x * Hq + hq0;
  for (int idx = threadIdx.x; idx < GB * D; idx += STREAM_COMBINE_NT) {
    const int g = idx / D, d = idx - g * D;
    float m = NEG_INF, l = 0.f, acc = 0.f;
#pragma unroll 4
    for (int b = pf; b <= p; ++b) {
      const int64_t row = (((int64_t)hg * P + b) * 2 + (b == pf ? 1 : 0)) * GS + g;
      const float mb = scr.bml[row * 2], lb = scr.bml[row * 2 + 1], ob = scr.bo[row * D + d];
      const bool held = b == pf || (int64_t)b * T / P < (int64_t)(b + 1) * T / P;
      if (held && lb > 0.f) {
        const float m_new = fmaxf(m, mb);
        const float f_old = fast_exp2(m - m_new), f_new = fast_exp2(mb - m_new);
        l = fmaf(l, f_old, lb * f_new);
        acc = fmaf(acc, f_old, ob * f_new);
        m = m_new;
      }
    }
    out[(row0 + g) * D + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
  }
}

template <typename TKV, int D>
static int launch_stream_mma(const void* q, const void* k_pool, const void* v_pool,
                             const void* pt, const void* kv_lens, void* out, int B, int Hq,
                             int Hkv, int row_stride, int maxP, int page_size, float scale,
                             float cap, int n_blocks, void* scratch, cudaStream_t stream) {
  using Lay = StreamLayout<TKV, D>;
  if (n_blocks < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool grouped = Hq / Hkv > 16;  // head groups of at most 16 query heads
  auto kernel =
      grouped ? rpa_stream_mma_kernel<TKV, D, true> : rpa_stream_mma_kernel<TKV, D, false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int groups = Hkv * ((Hq / Hkv + 15) / 16);
  kernel<<<dim3(n_blocks, groups), STREAM_NT, Lay::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(scratch), B, Hq, Hkv, row_stride, maxP, page_size, scale, cap);
  if (n_blocks > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    auto combine = grouped ? rpa_stream_combine_kernel<D, true>
                           : rpa_stream_combine_kernel<D, false>;
    combine<<<dim3(n_blocks, groups), STREAM_COMBINE_NT, 0, stream>>>(
        static_cast<float*>(scratch), static_cast<__nv_bfloat16*>(out), Hq, Hkv);
  }
  return (int)cudaGetLastError();
}

// The tensor-core stream for bf16 q, the CUDA-core kernel for float32 q
// (which takes its own grid and no scratch).
template <typename TQ, typename TKV, int D>
static int launch_gqa(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                      const void* kv_lens, void* out, int B, int Hq, int Hkv, int row_stride,
                      int maxP, int page_size, float scale, float cap, int n_blocks,
                      void* scratch, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return launch_stream_mma<TKV, D>(q, k_pool, v_pool, pt, kv_lens, out, B, Hq, Hkv,
                                     row_stride, maxP, page_size, scale, cap, n_blocks, scratch,
                                     stream);
  else
    return launch_stream<TQ, TKV, D>(q, k_pool, v_pool, pt, kv_lens, out, B, Hq, Hkv,
                                     row_stride, maxP, page_size, scale, cap, stream);
}

#ifdef RPA_MLA
// ------------------------------------------------------------------------
// The tensor-core MLA stream (bf16 q over bf16 or fp8 latent rows), on the packed
// MLA decode's block tile (rpa_mla_mma.cuh): the four warps of a block share
// each latent tile, so the unit that takes a share is the block, and the
// share is cut at the tile's fixed chunks (MLA_MMA_CHUNK = 256 positions),
// so that every chunk is computed as the packed decode computes it.
//
// Block (p, head group h) of P x HG, the heads [16 h, 16 h + G), G = min(16,
// Hq - 16 h) (rpa_mla_mma.cuh's groups): the batch's chunks, request-major (each
// request's ceil(min(kv_len, maxP * page_size) / MLA_MMA_CHUNK) in order),
// form one sequence of C chunks; block p walks [c_p, c_p+1), c_p = floor(p C
// / P): equal shares of whole chunks, differing by at most one. The block's
// ring runs ahead over the share's tiles across chunk and request
// boundaries without draining. Its softmax state resets at each chunk;
// at a chunk's end a request of one chunk is written (O / l), any other
// chunk leaves its float32 (m c, l, O) in the scratch at its index, and
// rpa_mla_combine_kernel<false> merges the chunks of those requests in
// chunk order, as the packed decode's merge does. Rows with no position
// are written as zeros by block r % P. No atomics: two calls are bitwise
// equal, and equal to the packed decode's.
template <typename TKV>
__global__ void __launch_bounds__(MLA_MMA_NT, MLA_MMA_BLOCKS_PER_SM)
rpa_stream_mla_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hq, MLA_DL]
                          const TKV* __restrict__ lat,  // latent rows of this layer at slot 0
                          const int* __restrict__ page_table,  // [B, maxP]
                          const int* __restrict__ kv_lens,     // [B]
                          __nv_bfloat16* __restrict__ out,     // [B, Hq, MLA_DV]
                          float* __restrict__ part,  // O [n_chunk, B, Hq, MLA_DV], then (m c, l)
                          int B, int Hq, int maxP, int page_size, float scale, float cap) {
  static_assert(MLA_MMA_NT == STREAM_NT, "stream_scan's block");
  constexpr int TK = MLA_MMA_TK, NST = MLA_MMA_NST, CT = MLA_MMA_CHUNK / MLA_MMA_TK;
  extern __shared__ __align__(16) unsigned char mla_smem[];
  __shared__ int s_req, s_first;  // the request holding the block's first chunk, its first chunk
  const int p = blockIdx.x, P = gridDim.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = h * MLA_MMA_ROWS;  // the group's first head
  const int G = min(MLA_MMA_ROWS, Hq - h0), max_len = maxP * page_size;
  const int n_chunk = (max_len + MLA_MMA_CHUNK - 1) / MLA_MMA_CHUNK;  // the scratch's chunks

  // the chunk sequence and the block's share [c0, c1); the thread whose
  // chunk of requests holds chunk c0 finds its request
  int b0, b1, mine, first, C;
  stream_scan(kv_lens, B, max_len, MLA_MMA_CHUNK, b0, b1, mine, first, C);
  const int c0 = (int)((int64_t)p * C / P), c1 = (int)((int64_t)(p + 1) * C / P);
  if (c0 < C && c0 >= first && c0 < first + mine) {
    int f = first;
    for (int b = b0; b < b1; ++b) {
      const int n = mla_chunks(kv_lens[b], max_len);
      if (c0 < f + n) {
        s_req = b;
        s_first = f;
        break;
      }
      f += n;
    }
  }
  __syncthreads();
  // the share's tiles, walked from tile CT (c0 - s_first) of request s_req
  int ntiles = 0, req0 = 0, t0 = 0;
  if (c1 > c0) {
    req0 = s_req;
    t0 = CT * (c0 - s_first);
    for (int r = req0, c = c0 - s_first, left = c1 - c0; left > 0;) {
      const int n = min(kv_lens[r], max_len);
      if (c >= mla_chunks(n, max_len)) {
        ++r;
        c = 0;
        continue;
      }
      ntiles += min(CT, (n - c * MLA_MMA_CHUNK + TK - 1) / TK);
      ++c;
      --left;
    }
  }

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mla_smem);
  float4* xs = reinterpret_cast<float4*>(mla_smem + NST * MLA_MMA_STAGE);
  const uint32_t s_ring = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  // The fetch side: the next tile to copy, tile ft of request fr (fn tiles
  // within flim = min(kv_len, maxP * page_size)); one commit group per
  // issue(), empty past the share's end, so that the waits count the same
  // groups across chunk and request boundaries too; fp8 rows land in their
  // stage at the next cp.land().
  MlaCopy<TKV> cp;
  int fr = req0, ft = t0, flim = 0, fn = 0, issued = 0;
  if (ntiles > 0) {
    flim = min(kv_lens[fr], max_len);
    fn = (flim + TK - 1) / TK;
  }
  auto issue = [&]() {
    if (issued < ntiles) {
      while (ft >= fn) {  // the next request with a tile; its q rows into L2
        ++fr;
        ft = 0;
        flim = min(kv_lens[fr], max_len);
        fn = flim > 0 ? (flim + TK - 1) / TK : 0;
        const __nv_bfloat16* qr = q + ((int64_t)fr * Hq + h0) * MLA_DL;
        for (int o = tid * 64; o < G * MLA_DL; o += MLA_MMA_NT * 64) prefetch_l2(qr + o);
      }
      cp.issue(ring + (issued % NST) * TK * MLA_MMA_LD, lat, page_table + (int64_t)fr * maxP,
               page_size, pshift, ft * TK, 0, flim, tid);
      ++ft;
      ++issued;
    }
    cp_async_commit();
  };
  uint32_t k_lane, v_lane;
  mma_lanes<MLA_MMA_LD, TK>(lane, k_lane, v_lane);
  // p = 2^(v c - m c): v the raw dot (c folds in the scale) or the capped score
  const bool capped = cap > 0.f;
  const float c = capped ? LOG2E : scale * LOG2E;

  // the compute side: request cr, tile ct of its cn, within kv_len climit
  int cr = fr, ct = ft, climit = flim, cn = fn;
  uint32_t qa[MLA_MMA_KS][4];
  MlaState ms;
  for (int i = 0; i < NST - 1; ++i) {
    cp.land(tid);  // fp8: tile i - 1
    issue();
  }
  cp_async_wait<NST - 2>();  // tile 0 (this thread's copies)
  __syncthreads();
  for (int i = 0; i < ntiles; ++i) {
    while (ct >= cn) {
      ++cr;
      ct = 0;
      climit = min(kv_lens[cr], max_len);
      cn = climit > 0 ? (climit + TK - 1) / TK : 0;
    }
    const int64_t row0 = (int64_t)cr * Hq + h0;
    if (i == 0 || ct == 0) mla_load_q(qa, q + row0 * MLA_DL, G, warp, lane);  // a new request
    if (ct % CT == 0) ms.reset();  // a chunk begins
    const uint32_t sT = s_ring + (i % NST) * MLA_MMA_STAGE;
    float4* x = xs + (i & 1) * MLA_MMA_WARPS * 2 * 32;
    mla_partial(x, qa, sT, k_lane, warp, lane);
    cp_async_wait<NST - 3>();  // tile i + 1 (this thread's copies)
    __syncthreads();
    cp.land(tid);  // fp8: tile i + NST - 2, into tile i - 2's stage
    issue();       // tile i + NST - 1, into tile i - 1's stage
    mla_combine_pv(ms, x, sT + warp * MLA_MMA_DW * 2, v_lane, ct * TK, 0, climit, scale, cap,
                   capped, c, lane);
    ++ct;
    if (ct % CT == 0 || ct == cn) {  // a chunk ends
      if (cn <= CT) {
        mla_write_out(ms, out + row0 * MLA_DV, G, warp, lane);
      } else {
        const int64_t prow = (int64_t)((ct - 1) / CT) * B * Hq + row0;
        float* ml = part + (int64_t)n_chunk * B * Hq * MLA_DV;
        mla_write_partial(ms, part + prow * MLA_DV, ml + prow * 2, G, c, warp, lane);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  for (int r = p; r < B; r += P)  // rows with no position
    if (mla_chunks(kv_lens[r], max_len) == 0)
      for (int i = tid; i < G * MLA_DV; i += MLA_MMA_NT)
        out[((int64_t)r * Hq + h0) * MLA_DV + i] = __float2bfloat16(0.f);
}

template <typename TKV>
static int launch_stream_mla_mma(const void* q, const void* lat, const void* pt,
                                 const void* kv_lens, void* out, int B, int Hq, int maxP,
                                 int page_size, float scale, float cap, int n_blocks,
                                 void* scratch, cudaStream_t stream) {
  const int HG = (Hq + MLA_MMA_ROWS - 1) / MLA_MMA_ROWS;  // head groups of at most 16
  if (n_blocks < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = rpa_stream_mla_mma_kernel<TKV>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MLA_MMA_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3(n_blocks, HG), MLA_MMA_NT, MLA_MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(lat),
      static_cast<const int*>(pt), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch), B, Hq, maxP, page_size,
      scale, cap);
  const int n_chunk = (maxP * page_size + MLA_MMA_CHUNK - 1) / MLA_MMA_CHUNK;
  if (n_chunk > 1) {  // requests of several chunks
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t n = (int64_t)B * Hq * MLA_DV;
    rpa_mla_combine_kernel<false><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(scratch), static_cast<__nv_bfloat16*>(out),
        static_cast<const int*>(kv_lens), n_chunk, B, Hq, maxP * page_size);
  }
  return (int)cudaGetLastError();
}

// The tensor-core MLA stream for bf16 q, the CUDA-core kernel for float32 q
// (which takes its own grid and no scratch).
template <typename TQ, typename TKV>
static int launch_mla(const void* q, const void* lat, const void* pt, const void* kv_lens,
                      void* out, int B, int Hq, int maxP, int page_size, float scale, float cap,
                      int n_blocks, void* scratch, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return launch_stream_mla_mma<TKV>(q, lat, pt, kv_lens, out, B, Hq, maxP, page_size, scale,
                                      cap, n_blocks, scratch, stream);
  else
    return launch_stream_mla<TQ, TKV>(q, lat, pt, kv_lens, out, B, Hq, maxP, page_size, scale,
                                      cap, stream);
}
#endif  // RPA_MLA

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/rpa_stream.py), with
// the arguments of the decode kernels (rpa_decode.cu; on the latent pool
// rpa_decode_mla.cu's conventions: v_pool == k_pool, Hkv 1, D = row_stride
// = MLA_DL, out [B, Hq, MLA_DV]) and the tensor-core stream's plan: n_blocks
// P >= 1 blocks per KV head, or per head group on the latent pool
// (rpa_stream.py stream_blocks), and a float32 scratch of P * (6 * Hq * (D
// + 2) + 4 * Hkv) elements (StreamScratch), or on the latent pool n_chunk *
// B * Hq * (MLA_DV + 2), n_chunk = ceil(maxP * page_size / MLA_MMA_CHUNK).
// The float32 pairs ignore both. window must be <= 0: the stream has no
// sliding window. Returns cudaError_t; another geometry, type pair or plan
// is cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                         const void* page_table, const void* kv_lens, void* out, int B, int Hq,
                         int Hkv, int D, int row_stride, int maxP, int page_size, float scale,
                         float cap, int window, int q_type, int kv_type, int n_blocks,
                         void* scratch, void* stream) {
  using namespace rpa;
  if (B == 0) return 0;
  if (window > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef RPA_MLA
  if (Hq <= 0 || Hkv != 1 || D != MLA_DL || row_stride != MLA_DL || v_pool != k_pool)
    return (int)cudaErrorInvalidValue;
#define RPA_STREAM(QC, TQ, KC, TKV)                                                          \
  if (q_type == QC && kv_type == KC)                                                         \
    return launch_mla<TQ, TKV>(q, k_pool, page_table, kv_lens, out, B, Hq, maxP, page_size,  \
                               scale, cap, n_blocks, scratch, s);
  RPA_FOR_EACH_PAIR(RPA_STREAM)
#else
  if (Hkv <= 0 || Hq % Hkv || D != RPA_HEAD_DIM) return (int)cudaErrorInvalidValue;
#define RPA_STREAM(QC, TQ, KC, TKV)                                                        \
  if (q_type == QC && kv_type == KC)                                                       \
    return launch_gqa<TQ, TKV, RPA_HEAD_DIM>(q, k_pool, v_pool, page_table, kv_lens, out, B, \
                                             Hq, Hkv, row_stride, maxP, page_size, scale,   \
                                             cap, n_blocks, scratch, s);
  RPA_FOR_EACH_PAIR(RPA_STREAM)
#endif
#undef RPA_STREAM
  return (int)cudaErrorInvalidValue;
}
