// Paged decode attention over the chunked or the 5D KV pool, for Hopper
// (sm_90a).
//
// Replaces three TPU kernels (branches), one build each (rpa_common.cuh):
//   chunked pool, head_dim 64 (rpa_decode): semi_pd_tpu/ops/attention/
//     rpa_packed.py _rpa_kernel_chunked_packed (called from
//     ragged_paged_attention_chunked_packed);
//   5D pool, head_dim 128, fp8 KV (-DRPA_ALIGNED, rpa_decode_aligned):
//     semi_pd_tpu/ops/attention/rpa_packed.py _rpa_kernel_packed (called from
//     ragged_paged_attention_packed; its GQA branch, the MLA branch is
//     rpa_decode_mla.cu);
//   5D pool, head_dim 64 (-DRPA_ALIGNED -DRPA_HEAD_DIM=64 -DRPA_P_F32,
//     rpa_decode_merged): the decode of semi_pd_tpu/ops/attention/
//     ragged_paged_attention.py _rpa_kernel_merged, which the JAX dispatcher
//     runs for every D % 128 != 0 batch on that pool. It upcasts q, K and V
//     to float32 and keeps P in float32, so this build does not round P.
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
// latency overlaps the score / softmax / P.V work (rpa_decode.cuh).
// Positions at or past kv_len are never read (the TPU kernels gathered
// whole sections and relied on the dump page being finite); rows with
// kv_len == 0 write zeros.
// Split-KV across blocks, TMA and wgmma are later work: at B * Hkv blocks
// the card is filled only when B * Hkv >= 132.
#include "rpa_decode.cuh"

namespace rpa {

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
  const int G = Hq / Hkv;
  const DecodeSmem s = dec_smem<D>(smem, G);

  const int kv_len = kv_lens[b];
  const int limit = min(kv_len, maxP * page_size);
  TQ* o = out + ((int64_t)b * Hq + (int64_t)h * G) * D;
  if (limit <= 0) {  // padded batch row
    for (int i = tid; i < G * D; i += NT) o[i] = from_f<TQ>(0.f);
    return;
  }
  // the query sits at kv_len - 1 and sees positions > kv_len - 1 - window
  const int lo = window > 0 ? max(kv_len - window, 0) : 0;

  float acc[DEC_MAXO];
  decode_begin<TQ, D>(s, q + ((int64_t)b * Hq + (int64_t)h * G) * D, G, acc, tid);

  const int* pt_row = page_table + (int64_t)b * maxP;
  const TKV* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  Tile tile;
  tile.load(kb, v_off, pt_row, page_size, row_stride, lo, limit, tid);

  for (int start = lo; start < limit; start += TK) {
    __syncthreads();  // the previous tile is fully consumed
    tile.template store<LD>(s.sK, s.sV, tid);
    __syncthreads();
    if (start + TK < limit)
      tile.load(kb, v_off, pt_row, page_size, row_stride, start + TK, limit, tid);
    decode_tile<TQ, D>(s, acc, G, start, limit, scale, cap, tid);
  }
  __syncthreads();
  decode_end<TQ, D>(s, acc, o, G, tid);
}

template <typename TQ, typename TKV, int D>
static int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                         const void* kv_lens, void* out, int B, int Hq, int Hkv, int row_stride,
                         int maxP, int page_size, float scale, float cap, int window,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * dec_smem_floats<D>(Hq / Hkv);
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

// C entry point (bound with ctypes by ops/attention/rpa_packed.py).
// k_pool / v_pool: K and V of the layer at slot 0; row_stride: elements
// from one slot to the next (rpa_common.cuh). q_type / kv_type: TypeCode.
// cap <= 0: no softcap; window <= 0: no sliding window. Returns
// cudaError_t; a head_dim or type pair this build lacks is
// cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                         const void* page_table, const void* kv_lens, void* out, int B, int Hq,
                         int Hkv, int D, int row_stride, int maxP, int page_size, float scale,
                         float cap, int window, int q_type, int kv_type, void* stream) {
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
