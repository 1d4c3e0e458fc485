// Cross-request streaming decode attention over the chunked, the 5D or the
// MLA latent KV pool, for Hopper (sm_90a).
//
// Replaces two TPU kernels (three branches), one build each:
//   chunked pool, head_dim 64 (rpa_decode_stream): semi_pd_tpu/ops/attention/
//     rpa_stream.py _rpa_kernel_chunked_stream;
//   5D pool, head_dim 128, fp8 KV (-DRPA_ALIGNED, rpa_decode_stream_aligned):
//     rpa_stream.py _rpa_kernel_stream, its GQA branch;
//   latent pool, DeepSeek-V2's 512 + 64 with V its first 512 (-DRPA_MLA
//     -DRPA_P_F32, rpa_decode_stream_mla): the same kernel's MLA branch,
//     which computes in float32, P included.
// They compute the decode of rpa_decode.cu and rpa_decode_mla.cu with
// softcap and without a sliding window (the routing keeps windowed batches
// on the packed decode, as the JAX routing does). P is rounded as the TPU
// kernels round it: to q's type on the GQA pools, not on the latent pool.
//
// What carries over from the TPU design is the schedule, not its blocks:
// the KV tiles of many requests form ONE sequence, fetched STREAM_NBUF deep
// across request boundaries, so the next request's first tiles are in
// flight while the block finishes the current one. The TPU kernel streamed
// the whole batch on one core; here each block streams its own run.
//
// Design: a persistent grid of (P, KV heads) blocks, or (P, groups of 8
// query heads) on the latent pool, with P = min(B, resident blocks per SM *
// SMs / the second grid dimension), so the grid fills the card once. Each
// block computes the prefix sum of ceil(kv_len / TK) over the batch from
// kv_lens on the device (no host sync) and takes the contiguous run of
// requests whose first tile falls in its 1/P share of all tiles: whole
// requests per block, so no combine pass (split-KV with a combine is later
// work). It walks the run's (request, tile) pairs through a ring of
// STREAM_NBUF stages of raw KV bytes in shared memory, filled by 16-byte
// cp.async.cg copies (one commit group per tile; cp.async.wait_group
// STREAM_NBUF - 1 before a tile is read, so every issued tile is waited for
// exactly once), widens each tile to float32 on the read side (KVTile::take
// and store) and computes it as the decode kernels do (rpa_decode.cuh,
// rpa_mla.cuh). The softmax state resets at a request's first tile and the
// output is written at its last. No slot at or past kv_len is read; rows
// with kv_len 0 write zeros.
//
// Bound on this card: bytes, as the decode's (rpa_decode.cu). The ring
// costs STREAM_NBUF * TK * 2 * D * sizeof(KV) bytes of shared memory (64 KB
// in bf16 at D 64 and at D 128, 72 KB on the latent pool; twice that in
// float32), which caps the blocks resident on an SM and so P.
#include "rpa_decode.cuh"
#include "rpa_mla.cuh"

namespace rpa {

// Ring depth: the JAX kernels' default RPA_STREAM_NBUF, a build constant.
constexpr int STREAM_NBUF = 4;
constexpr int STREAM_NT = 128;  // threads per block, both kernels
static_assert(STREAM_NT == DEC_NT, "the GQA stream computes with the decode's block");

__device__ __forceinline__ int stream_tiles(int kv_len, int max_len, int TK) {
  const int n = min(kv_len, max_len);
  return n > 0 ? (n + TK - 1) / TK : 0;
}

// This block's run [r0, r1) of the batch. Request b goes to block
// min(P - 1, first(b) * P / total), where first(b) is the prefix sum of the
// tile counts of the requests before b and total the batch's tile count:
// the owner never decreases with b, so each run is contiguous, and each
// block gets about total / P tiles in whole requests. Each thread sums a
// contiguous chunk of requests; the chunks' exclusive scan runs over the
// warps in shared memory.
__device__ __forceinline__ void stream_run(const int* __restrict__ kv_lens, int B, int max_len,
                                           int TK, int& r0, int& r1) {
  constexpr int NW = STREAM_NT / 32;
  __shared__ int s_part[NW];
  __shared__ int s_cnt[2][NW];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = blockIdx.x, P = gridDim.x;
  const int per = (B + STREAM_NT - 1) / STREAM_NT;
  const int b0 = min(B, tid * per), b1 = min(B, b0 + per);
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += stream_tiles(kv_lens[b], max_len, TK);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int first = incl - mine, total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    total += s_part[w];
    if (w < warp) first += s_part[w];
  }
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
// streams its run, the heads as rows of 16 threads each (MlaRows, as in
// rpa_decode_mla.cu).
constexpr int MLA_STREAM_HB = 8;  // query heads per block

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

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/rpa_stream.py), with
// the signature of the decode kernels (rpa_decode.cu; on the latent pool
// rpa_decode_mla.cu's conventions: v_pool == k_pool, Hkv 1, D = row_stride
// = MLA_DL, out [B, Hq, MLA_DV]). window must be <= 0: the stream has no
// sliding window. Returns cudaError_t; another geometry or type pair is
// cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                         const void* page_table, const void* kv_lens, void* out, int B, int Hq,
                         int Hkv, int D, int row_stride, int maxP, int page_size, float scale,
                         float cap, int window, int q_type, int kv_type, void* stream) {
  using namespace rpa;
  if (B == 0) return 0;
  if (window > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef RPA_MLA
  if (Hq <= 0 || Hkv != 1 || D != MLA_DL || row_stride != MLA_DL || v_pool != k_pool)
    return (int)cudaErrorInvalidValue;
#define RPA_STREAM(QC, TQ, KC, TKV)                                                        \
  if (q_type == QC && kv_type == KC)                                                       \
    return launch_stream_mla<TQ, TKV>(q, k_pool, page_table, kv_lens, out, B, Hq, maxP,    \
                                      page_size, scale, cap, s);
  RPA_MLA_FOR_EACH_PAIR(RPA_STREAM)
#else
  if (Hkv <= 0 || Hq % Hkv || (Hq / Hkv) * D > DEC_MAXO * DEC_NT || D != RPA_HEAD_DIM)
    return (int)cudaErrorInvalidValue;
#define RPA_STREAM(QC, TQ, KC, TKV)                                                          \
  if (q_type == QC && kv_type == KC)                                                         \
    return launch_stream<TQ, TKV, RPA_HEAD_DIM>(q, k_pool, v_pool, page_table, kv_lens, out, \
                                                B, Hq, Hkv, row_stride, maxP, page_size,     \
                                                scale, cap, s);
  RPA_FOR_EACH_PAIR(RPA_STREAM)
#endif
#undef RPA_STREAM
  return (int)cudaErrorInvalidValue;
}
