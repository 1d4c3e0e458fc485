// Paged decode attention over the MLA latent pool, for Hopper (sm_90a).
//
// Replaces the MLA branch of semi_pd_tpu/ops/attention/rpa_packed.py
// _rpa_kernel_packed (called from ragged_paged_attention_packed with v_dim):
// one query row per request at position kv_len - 1, all Hq heads over the
// request's latent rows, float32 online softmax, optional logit softcap and
// sliding window. The TPU kernel upcasts q and the latent rows to float32
// and keeps P in float32, so this build does too (-DRPA_P_F32). What it
// computes and its bound are in rpa_mla.cuh; the entry picks one of two
// kernels by q's type. Two builds: rpa_decode_mla at DeepSeek-V2's latent
// 576 / V 512, rpa_decode_mla_288 (-DRPA_MLA_DL=288 -DRPA_MLA_DV=256) at
// MiniCPM3's 288 / 256.
//
// rpa_decode_mla_mma_kernel (bf16 q over bf16, fp8 e4m3 or fp8 e5m2 latent
// rows, fp8 widened exactly to bf16 on its way into the tile): on the tensor
// cores, the block tile of rpa_mla_mma.cuh (the query heads as the rows of
// one m16 tile, groups of 16 heads with an uneven last one, the four warps
// of a block sharing each latent tile: S cut over the MLA_DL dims, V's
// MLA_DV columns cut over the warps, P as hi + lo), and each request's
// positions split over blocks (flash-decoding) at the tile's fixed chunks.
// Grid (n_split, HG, B): the host's plan (rpa_packed.py decode_split_plan)
// is n_split = ceil(maxP * page_size / MLA_MMA_CHUNK) splits of split_len =
// MLA_MMA_CHUNK positions, from the shapes only (no kv_lens on the host):
// B x n_split blocks for DeepSeek-V2-Lite's one head group of 16, 256 at
// b64 / kv1024 and at b16 / kv4096, two an SM; three times as many for
// MiniCPM3's 40 heads (16 / 16 / 8), four an SM. With
// one split a block writes its rows' output; else its float32 partial (m
// c, l, O) goes to the caller's scratch and rpa_mla_combine_kernel merges
// the chunks in chunk order. The result does not depend on the batch, and
// equals the streaming decode's bit for bit (rpa_mla_mma.cuh). No atomics:
// two calls are bitwise equal. Positions outside [lo, kv_len) are
// zero-filled and never read (the window's low edge may fall inside any
// chunk); a row with no position writes zeros.
//
// rpa_decode_mla_kernel (float32 q and latent rows): on the CUDA cores
// (TF32 would not be the float32 dot it computes). One block of 128
// threads per (request, group of MLA_DEC_HB query heads), the heads as the
// block's rows, MLA_TPR threads per head (rpa_mla.cuh's MlaRows: 16 at
// 576, so 8 heads a block; 8 at 288, so 16); each group stages the
// request's latent rows itself, and there is no split.
#include <type_traits>

#include "rpa_mla_mma.cuh"

namespace rpa {

constexpr int MLA_DEC_NT = 128;                      // threads per block
constexpr int MLA_DEC_TPR = MLA_TPR;                 // threads per head
constexpr int MLA_DEC_HB = MLA_DEC_NT / MLA_DEC_TPR;  // query heads per block

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(MLA_DEC_NT)
rpa_decode_mla_kernel(const TQ* __restrict__ q,            // [B, Hq, MLA_DL]
                      const TKV* __restrict__ lat,         // latent rows of this layer at slot 0
                      const int* __restrict__ page_table,  // [B, maxP]
                      const int* __restrict__ kv_lens,     // [B]
                      TQ* __restrict__ out,                // [B, Hq, MLA_DV]
                      int Hq, int maxP, int page_size, float scale, float cap, int window) {
  __shared__ __align__(16) float sK[MLA_TK * MLA_LD];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int h = blockIdx.y * MLA_DEC_HB + tid / MLA_DEC_TPR;
  const int kv_len = kv_lens[b];
  const int limit = min(kv_len, maxP * page_size);
  // the query sits at kv_len - 1 and sees positions > kv_len - 1 - window
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;
  const int64_t row = (int64_t)b * Hq + min(h, Hq - 1);
  mla_attend<TQ, TKV, MLA_DEC_TPR, 1, MLA_DEC_NT>(
      q + row * MLA_DL, MLA_DL, out + row * MLA_DV, MLA_DV, h < Hq ? 1 : 0, kv_len - 1, 0,
      lat, page_table + (int64_t)b * maxP, page_size, lo, limit, scale, cap, window, sK, tid);
}

template <typename TQ, typename TKV>
static int launch_decode_mla(const void* q, const void* lat, const void* pt, const void* kv_lens,
                             void* out, int B, int Hq, int maxP, int page_size, float scale,
                             float cap, int window, cudaStream_t stream) {
  const dim3 grid(B, (Hq + MLA_DEC_HB - 1) / MLA_DEC_HB);
  rpa_decode_mla_kernel<TQ, TKV><<<grid, MLA_DEC_NT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(lat), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<TQ*>(out), Hq, maxP, page_size, scale, cap,
      window);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The tensor-core decode (bf16 q).

// Block (split, head group h, request b): the G = min(16, Hq - 16 h) query
// heads 16 h .. 16 h + G - 1 over positions [max(s0, lo), s1) of request b,
// s0 = split split_len, s1 = min(s0 + split_len, kv_len), in tiles of
// MLA_MMA_TK from the multiple of MLA_MMA_TK at or below them
// (rpa_mla_mma.cuh's ring; without a window, from the chunk's start).
template <typename TKV>
__global__ void __launch_bounds__(MLA_MMA_NT, MLA_MMA_BLOCKS_PER_SM)
rpa_decode_mla_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hq, MLA_DL]
                          const TKV* __restrict__ lat,  // latent rows of this layer at slot 0
                          const int* __restrict__ page_table,  // [B, maxP]
                          const int* __restrict__ kv_lens,     // [B]
                          __nv_bfloat16* __restrict__ out,     // [B, Hq, MLA_DV]
                          float* __restrict__ part,  // n_split > 1: O [n_split, B, Hq, MLA_DV], ML
                          int Hq, int maxP, int page_size, float scale, float cap, int window,
                          int split_len) {
  constexpr int TK = MLA_MMA_TK, NST = MLA_MMA_NST;
  extern __shared__ __align__(16) unsigned char mla_smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, G = min(MLA_MMA_ROWS, Hq - h * MLA_MMA_ROWS), B = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int kv_len = kv_lens[b];
  const int limit = min(kv_len, maxP * page_size);
  // the query sits at kv_len - 1 and sees positions > kv_len - 1 - window
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, limit);  // this block's positions: [max(s0, lo), s1)
  const int first = max(s0, (lo / TK) * TK);  // tiles start at multiples of TK
  const int ntiles = s1 > first ? (s1 - first + TK - 1) / TK : 0;
  // p = 2^(v c - m c): v the raw dot (c folds in the scale) or the capped score
  const bool capped = cap > 0.f;
  const float c = capped ? LOG2E : scale * LOG2E;
  const int64_t row0 = (int64_t)b * Hq + (int64_t)h * MLA_MMA_ROWS;  // its first output row

  MlaState ms;
  ms.reset();
  if (ntiles > 0) {  // the same for every thread of the block
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mla_smem);
    float4* xs = reinterpret_cast<float4*>(mla_smem + NST * MLA_MMA_STAGE);
    const uint32_t s_ring = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
    const int* pt_row = page_table + (int64_t)b * maxP;
    const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
    // tile i into its stage (zeros outside [lo, s1)), and a commit group
    // either way, so that every wait counts the same groups; fp8 rows land
    // in the stage at the next cp.land()
    MlaCopy<TKV> cp;
    auto issue = [&](int i) {
      if (i < ntiles)
        cp.issue(ring + (i % NST) * TK * MLA_MMA_LD, lat, pt_row, page_size, pshift,
                 first + i * TK, lo, s1, tid);
      cp_async_commit();
    };
    uint32_t k_lane, v_lane;
    mma_lanes<MLA_MMA_LD, TK>(lane, k_lane, v_lane);

    for (int i = 0; i < NST - 1; ++i) {
      cp.land(tid);  // fp8: tile i - 1
      issue(i);
    }
    uint32_t qa[MLA_MMA_KS][4];  // loaded while the first tiles are in flight
    mla_load_q(qa, q + row0 * MLA_DL, G, warp, lane);
    cp_async_wait<NST - 2>();  // tile 0 (this thread's copies)
    __syncthreads();
    for (int i = 0; i < ntiles; ++i) {
      const uint32_t sT = s_ring + (i % NST) * MLA_MMA_STAGE;
      float4* x = xs + (i & 1) * MLA_MMA_WARPS * 2 * 32;
      mla_partial(x, qa, sT, k_lane, warp, lane);
      cp_async_wait<NST - 3>();  // tile i + 1 (this thread's copies)
      __syncthreads();
      cp.land(tid);        // fp8: tile i + NST - 2, into tile i - 2's stage
      issue(i + NST - 1);  // into tile i - 1's stage
      mla_combine_pv(ms, x, sT + warp * MLA_MMA_DW * 2, v_lane, first + i * TK, lo, s1, scale,
                     cap, capped, c, lane);
    }
    cp_async_wait<0>();  // only empty groups are left
  }

  if (n_split == 1) {
    mla_write_out(ms, out + row0 * MLA_DV, G, warp, lane);
  } else {  // a split with no position leaves l = 0, which the combine skips
    const int64_t prow = (int64_t)split * B * Hq + row0;
    float* ml = part + (int64_t)n_split * B * Hq * MLA_DV;
    mla_write_partial(ms, part + prow * MLA_DV, ml + prow * 2, G, c, warp, lane);
  }
}

template <typename TKV>
static int launch_decode_mla_mma(const void* q, const void* lat, const void* pt,
                                 const void* kv_lens, void* out, int B, int Hq, int maxP,
                                 int page_size, float scale, float cap, int window, int n_split,
                                 int split_len, void* scratch, cudaStream_t stream) {
  const int HG = (Hq + MLA_MMA_ROWS - 1) / MLA_MMA_ROWS;  // head groups of at most 16
  if (n_split < 1 || split_len != MLA_MMA_CHUNK ||
      (int64_t)n_split * split_len < (int64_t)maxP * page_size ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = rpa_decode_mla_mma_kernel<TKV>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MLA_MMA_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3(n_split, HG, B), MLA_MMA_NT, MLA_MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(lat),
      static_cast<const int*>(pt), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch), Hq, maxP, page_size, scale,
      cap, window, split_len);
  if (n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t n = (int64_t)B * Hq * MLA_DV;
    rpa_mla_combine_kernel<true><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(scratch), static_cast<__nv_bfloat16*>(out),
        static_cast<const int*>(kv_lens), n_split, B, Hq, maxP * page_size);
  }
  return (int)cudaGetLastError();
}

// The tensor-core decode for bf16 q, the CUDA-core kernel for float32 q
// (which takes no plan).
template <typename TQ, typename TKV>
static int launch(const void* q, const void* lat, const void* pt, const void* kv_lens, void* out,
                  int B, int Hq, int maxP, int page_size, float scale, float cap, int window,
                  int n_split, int split_len, void* scratch, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return launch_decode_mla_mma<TKV>(q, lat, pt, kv_lens, out, B, Hq, maxP, page_size, scale,
                                      cap, window, n_split, split_len, scratch, stream);
  else
    return launch_decode_mla<TQ, TKV>(q, lat, pt, kv_lens, out, B, Hq, maxP, page_size, scale,
                                      cap, window, stream);
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/rpa_packed.py), with the
// signature of the GQA decode builds (rpa_decode.cu): k_pool is the layer's
// latent rows at slot 0 and v_pool must be the same address (V is the
// row's prefix); Hkv 1, D = row_stride = MLA_DL; out is [B, Hq, MLA_DV]
// (the wrapper holds v_dim to MLA_DV). q_type / kv_type: TypeCode.
// cap <= 0: no softcap; window <= 0: no sliding window. n_split, split_len:
// the split plan of the bf16-q pairs (n_split ranges of split_len =
// MLA_MMA_CHUNK positions that cover [0, maxP * page_size)); scratch: with
// n_split > 1, a float32 scratch of n_split * B * Hq * (MLA_DV + 2)
// elements. The float32 pair ignores the three. alibi_slopes must be null
// (MLA takes no ALiBi). Returns cudaError_t; another geometry, type pair,
// plan or slopes is cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                         const void* page_table, const void* kv_lens, void* out, int B, int Hq,
                         int Hkv, int D, int row_stride, int maxP, int page_size, float scale,
                         float cap, int window, int q_type, int kv_type, int n_split,
                         int split_len, void* scratch, const void* alibi_slopes,
                         void* stream) {
  using namespace rpa;
  if (B == 0) return 0;
  if (Hq <= 0 || Hkv != 1 || D != MLA_DL || row_stride != MLA_DL || v_pool != k_pool ||
      alibi_slopes != nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_DEC(QC, TQ, KC, TKV)                                                             \
  if (q_type == QC && kv_type == KC)                                                         \
    return launch<TQ, TKV>(q, k_pool, page_table, kv_lens, out, B, Hq, maxP, page_size, scale, \
                           cap, window, n_split, split_len, scratch, s);
  RPA_FOR_EACH_PAIR(RPA_DEC)
#undef RPA_DEC
  return (int)cudaErrorInvalidValue;
}
