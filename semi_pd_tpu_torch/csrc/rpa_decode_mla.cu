// Paged decode attention over the MLA latent pool, for Hopper (sm_90a).
//
// Replaces the MLA branch of semi_pd_tpu/ops/attention/rpa_packed.py
// _rpa_kernel_packed (called from ragged_paged_attention_packed with v_dim):
// one query row per request at position kv_len - 1, all Hq heads over the
// request's latent rows, float32 online softmax, optional logit softcap and
// sliding window. What it computes, its bound and the shared design are in
// rpa_mla.cuh.
//
// Decode mapping: one block per (request, group of MLA_DEC_HB query heads),
// the heads as the block's rows (they share every position and mask), 16
// threads per head. Grouping heads gives B * Hq / 8 blocks (B * 2 at
// DeepSeek-V2-Lite's 16 heads) instead of B, at the price of each group
// staging the request's latent rows itself. No slot at or past kv_len is
// read; rows with kv_len == 0 write zeros. Split-KV across blocks, TMA and
// tensor-core tiles are later work.
#include "rpa_mla.cuh"

namespace rpa {

constexpr int MLA_DEC_HB = 8;    // query heads per block
constexpr int MLA_DEC_TPR = 16;  // threads per head
constexpr int MLA_DEC_NT = MLA_DEC_HB * MLA_DEC_TPR;

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

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/rpa_packed.py), with the
// signature of the other decode kernels: k_pool is the layer's latent rows
// at slot 0 and v_pool must be the same address (V is the row's prefix);
// Hkv 1, D = row_stride = MLA_DL; out is [B, Hq, MLA_DV] (the wrapper holds
// v_dim to MLA_DV). q_type / kv_type: TypeCode.
// cap <= 0: no softcap; window <= 0: no sliding window. Returns
// cudaError_t; another geometry or type pair is cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                              const void* page_table, const void* kv_lens, void* out, int B,
                              int Hq, int Hkv, int D, int row_stride, int maxP,
                              int page_size, float scale, float cap, int window, int q_type,
                              int kv_type, void* stream) {
  using namespace rpa;
  if (B == 0) return 0;
  if (Hq <= 0 || Hkv != 1 || D != MLA_DL || row_stride != MLA_DL ||
      v_pool != k_pool)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_DEC(QC, TQ, KC, TKV)                                                           \
  if (q_type == QC && kv_type == KC)                                                       \
    return launch_decode_mla<TQ, TKV>(q, k_pool, page_table, kv_lens, out, B, Hq, maxP,    \
                                      page_size, scale, cap, window, s);
  RPA_MLA_FOR_EACH_PAIR(RPA_DEC)
#undef RPA_DEC
  return (int)cudaErrorInvalidValue;
}
