// Paged decode attention over either KV pool, for Hopper (sm_90a).
//
// Replaces two TPU kernels, one build each (rpa_common.cuh):
//   chunked pool, head_dim 64: semi_pd_tpu/ops/attention/rpa_packed.py
//     _rpa_kernel_chunked_packed (called from
//     ragged_paged_attention_chunked_packed);
//   aligned pool, head_dim 128, fp8 KV (-DRPA_ALIGNED):
//     semi_pd_tpu/ops/attention/rpa_packed.py _rpa_kernel_packed (called from
//     ragged_paged_attention_packed; its GQA branch, the MLA branch is
//     rpa_decode_mla.cu).
// One query row per request, GQA with G = Hq / Hkv query heads per KV head,
// float32 online softmax, optional logit softcap and sliding window. fp8 KV
// is widened to float32 exactly, as the TPU kernels upcast it to q's dtype.
//
// Bound on this card: bytes. Each call reads every live KV row once,
// B * kv_len * 2 * Hkv * D * sizeof(KV) bytes, and does only 4 * Hq * D
// operations per KV position (about 1 operation per byte in bf16 with
// G = 4, 2 with fp8 KV, far below the ~295 the H100 needs before its
// tensor cores bind).
//
// Design: one block of 128 threads per (request, KV head). The block stages
// its G query rows in shared memory once, then walks the request's pages
// through the page table in tiles of 4096 / D positions (64 at D 64, 32 at
// D 128, so the float32 K and V tiles stay at ~34 KB of shared memory for
// both): each thread issues the 16-byte loads of its share of the NEXT tile
// into registers before the block computes on the current one (a two-deep
// pipeline without cp.async), so a KV byte is read once and the load
// latency overlaps the score / softmax / P.V work. Positions at or past
// kv_len are never read (the TPU kernels gathered whole sections and relied
// on the dump page being finite); rows with kv_len == 0 write zeros.
// Split-KV across blocks, TMA and wgmma are later work: at B * Hkv blocks
// the card is filled only when B * Hkv >= 132.
#include "rpa_common.cuh"

namespace rpa {

constexpr int DEC_NT = 128;   // threads per block
constexpr int DEC_MAXO = 8;   // outputs per thread: G * D <= DEC_MAXO * DEC_NT

template <int D>
__host__ __device__ constexpr int dec_tk() { return 4096 / D; }  // KV positions per tile
template <int D>
__host__ __device__ constexpr int dec_ld() { return D + 4; }  // padded rows: no bank conflicts

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(DEC_NT)
rpa_decode_kernel(const TQ* __restrict__ q,            // [B, Hq, D]
                  const TKV* __restrict__ k_pool,      // K of this layer at slot 0
                  const TKV* __restrict__ v_pool,      // V of this layer at slot 0
                  const int* __restrict__ page_table,  // [B, maxP]
                  const int* __restrict__ kv_lens,     // [B]
                  TQ* __restrict__ out,                // [B, Hq, D]
                  int Hq, int Hkv, int row_stride, int maxP, int page_size,
                  float scale, float cap, int window) {
  constexpr int NT = DEC_NT, TK = dec_tk<D>(), LD = dec_ld<D>();
  using Tile = KVTile<TKV, D, TK, NT>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = Hq / Hkv;
  float* sK = smem;           // [TK][LD]
  float* sV = sK + TK * LD;   // [TK][LD]
  float* sQ = sV + TK * LD;   // [G][D]
  float* sS = sQ + G * D;     // [G][TK] scores, then probabilities
  float* sM = sS + G * TK;    // [G] running max
  float* sL = sM + G;         // [G] running sum
  float* sC = sL + G;         // [G] this tile's correction factor

  const int kv_len = kv_lens[b];
  const int limit = min(kv_len, maxP * page_size);
  const int n_out = G * D;
  TQ* o = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
  if (limit <= 0) {  // padded batch row
    for (int i = tid; i < n_out; i += NT) o[i] = from_f<TQ>(0.f);
    return;
  }
  // the query sits at kv_len - 1 and sees positions > kv_len - 1 - window
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;

  const TQ* qb = q + ((int64_t)b * Hq + (int64_t)h * G) * D;
  for (int i = tid; i < n_out; i += NT) sQ[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }
  float acc[DEC_MAXO];
#pragma unroll
  for (int k = 0; k < DEC_MAXO; ++k) acc[k] = 0.f;

  const int* pt_row = page_table + (int64_t)b * maxP;
  const TKV* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  Tile tile;
  tile.load(kb, v_off, pt_row, page_size, row_stride, lo, limit, tid);

  for (int start = lo; start < limit; start += TK) {
    __syncthreads();  // the previous tile is fully consumed
    tile.template store<LD>(sK, sV, tid);
    __syncthreads();
    if (start + TK < limit)
      tile.load(kb, v_off, pt_row, page_size, row_stride, start + TK, limit, tid);

    // scores s[g][t] = q_g . k_t * scale (softcapped)
    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, t = i - g * TK;
      float s = NEG_INF;
      if (start + t < limit) {
        const float4* kr = reinterpret_cast<const float4*>(sK + t * LD);
        const float4* qr = reinterpret_cast<const float4*>(sQ + g * D);
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < D / 4; ++d) {
          const float4 kk = kr[d], qq = qr[d];
          a = fmaf(qq.x, kk.x, a);
          a = fmaf(qq.y, kk.y, a);
          a = fmaf(qq.z, kk.z, a);
          a = fmaf(qq.w, kk.w, a);
        }
        s = a * scale;
        if (cap > 0.f) s = cap * tanhf(s / cap);
      }
      sS[i] = s;
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += NT / 32) {
      float mx = NEG_INF;
      for (int t = lane; t < TK; t += 32) mx = fmaxf(mx, sS[g * TK + t]);
      mx = warp_max(mx);
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TK; t += 32) {
        const float p = (start + t < limit) ? expf(sS[g * TK + t] - m_new) : 0.f;
        sum += p;
        sS[g * TK + t] = round_p<TQ>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[g] = corr;
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int k = 0; k < DEC_MAXO; ++k) {
      const int i = tid + k * NT;
      if (i < n_out) {
        const int g = i / D, d = i - g * D;
        const float* p = sS + g * TK;
        float a = acc[k] * sC[g];
#pragma unroll 8
        for (int t = 0; t < TK; ++t) a = fmaf(p[t], sV[t * LD + d], a);
        acc[k] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < DEC_MAXO; ++k) {
    const int i = tid + k * NT;
    if (i < n_out) {
      const float l = sL[i / D];
      o[i] = from_f<TQ>(l > 0.f ? acc[k] / l : 0.f);
    }
  }
}

template <typename TQ, typename TKV, int D>
static int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                         const void* kv_lens, void* out, int B, int Hq, int Hkv, int row_stride,
                         int maxP, int page_size, float scale, float cap, int window,
                         cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * dec_tk<D>() * dec_ld<D>() + G * D + G * dec_tk<D>() + 3 * G);
  auto kernel = rpa_decode_kernel<TQ, TKV, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, Hkv), DEC_NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<TQ*>(out), Hq, Hkv, row_stride, maxP,
      page_size, scale, cap, window);
  return (int)cudaGetLastError();
}

}  // namespace rpa

#ifdef RPA_ALIGNED
#define RPA_DECODE_ENTRY rpa_decode_aligned
#else
#define RPA_DECODE_ENTRY rpa_decode
#endif

// C entry point (bound with ctypes by ops/attention/rpa_packed.py).
// k_pool / v_pool: K and V of the layer at slot 0; row_stride: elements
// from one slot to the next (rpa_common.cuh). q_type / kv_type: TypeCode.
// cap <= 0: no softcap; window <= 0: no sliding window. Returns
// cudaError_t; a head_dim or type pair this build lacks is
// cudaErrorInvalidValue.
extern "C" int RPA_DECODE_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                                const void* page_table, const void* kv_lens, void* out, int B,
                                int Hq, int Hkv, int D, int row_stride, int maxP,
                                int page_size, float scale, float cap, int window, int q_type,
                                int kv_type, void* stream) {
  using namespace rpa;
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || (Hq / Hkv) * D > DEC_MAXO * DEC_NT || D != RPA_HEAD_DIM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_DEC(QC, TQ, KC, TKV)                                                        \
  if (q_type == QC && kv_type == KC)                                                    \
    return launch_decode<TQ, TKV, RPA_HEAD_DIM>(q, k_pool, v_pool, page_table, kv_lens, \
                                                out, B, Hq, Hkv, row_stride, maxP,      \
                                                page_size, scale, cap, window, s);
  RPA_FOR_EACH_PAIR(RPA_DEC)
#undef RPA_DEC
  return (int)cudaErrorInvalidValue;
}
