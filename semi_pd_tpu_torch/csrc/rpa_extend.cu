// Ragged paged extend (chunked-prefill) attention over the chunked or the
// 5D KV pool, for Hopper (sm_90a).
//
// Replaces three TPU kernels (branches), one build each (rpa_common.cuh):
//   chunked pool, head_dim 64 (rpa_extend): semi_pd_tpu/ops/attention/
//     ragged_paged_attention.py _rpa_kernel_chunked (called from
//     ragged_paged_attention_chunked);
//   5D pool, head_dim 128, fp8 KV (-DRPA_ALIGNED, rpa_extend_aligned):
//     semi_pd_tpu/ops/attention/ragged_paged_attention.py _rpa_kernel
//     (called from ragged_paged_attention; its GQA branch, the MLA v_dim branch
//     is rpa_extend_mla.cu);
//   5D pool, head_dim 64 (-DRPA_ALIGNED -DRPA_HEAD_DIM=64 -DRPA_P_F32,
//     rpa_extend_merged): the extend of semi_pd_tpu/ops/attention/
//     ragged_paged_attention.py _rpa_kernel_merged (D % 128 != 0 on that
//     pool), which computes in float32 throughout, P included.
// Causal attention of the flat new tokens [T, Hq, D] of every request over
// its cached prefix plus the new tokens, through the page table, driven by
// the host-built work list (block_seq / block_row / block_qofs), with
// optional logit softcap and sliding window. fp8 KV is widened to float32
// exactly, as the TPU kernels upcast it to q's dtype.
//
// Bound on this card: operations at the main path's shapes. A block of
// q_len new tokens over kv_len positions does ~4 * q_len * kv_len * Hq * D
// causal operations while reading the kv_len rows once, well above the
// ~295 operations per byte where the H100's bf16 tensor cores bind.
//
// Design: one block per (work-list entry, query head), EXTEND_QBLK query
// rows per block and TPR = D / 64 threads per row (1 at D 64, 2 at D 128):
// each thread keeps 64 head dims of its row's query and float32 output in
// registers (a whole row of both at D 128 would need 256 registers), and
// the TPR partial dot products of a score are summed with __shfl_xor_sync
// among the row's lanes. A thread's dims are float4 chunks j * TPR + part,
// so the lanes of a row read neighbouring 16-byte words of a K or V row
// (no bank conflicts). Measured on the H100 (PERF.md): 32 dims per
// thread (2 threads per row at D 64, 4 at D 128) ran 9-31% slower at D 64
// and 1.7x slower at D 128, with or without q in shared memory, though it
// spilled less. EXTEND_QBLK is passed in
// by the build from ops/attention/ragged_paged_attention.py::
// EXTEND_Q_BLOCK, the same constant the host work list is built with, so
// the list and the kernel agree on the block height. KV tiles go through
// shared memory as float32, every row reading each K and V row as a
// broadcast; the next tile's loads are issued into registers before the
// current one is computed. The walk stops at min(kv_len, last row's
// position + 1); rows mask causally, by kv_len and by the window. A block writes ONLY the n_rows = min(q_len - qofs, QBLK)
// rows its entry owns (the TPU kernels wrote their whole block and relied
// on grid order for the next sequence to overwrite the overrun; blocks here
// run in parallel), and padding entries (block_seq == -1) write nothing.
// The arithmetic runs on the CUDA cores in float32; a wgmma/TMA version is
// later work.
#include "rpa_common.cuh"

#ifndef EXTEND_QBLK
#error "EXTEND_QBLK must be defined by the build (EXTEND_Q_BLOCK)"
#endif

namespace rpa {

constexpr int EXT_DPT = 64;  // head dims per thread
constexpr int EXT_TK = 32;   // KV positions per tile

template <int D>
__host__ __device__ constexpr int ext_tpr() { return D / EXT_DPT; }  // threads per row
template <int D>
__host__ __device__ constexpr int ext_nt() { return EXTEND_QBLK * ext_tpr<D>(); }

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(ext_nt<D>())
rpa_extend_kernel(const TQ* __restrict__ q,               // [T, Hq, D]
                  const TKV* __restrict__ k_pool,         // K of this layer at slot 0
                  const TKV* __restrict__ v_pool,         // V of this layer at slot 0
                  const int* __restrict__ page_table,     // [B, maxP]
                  const int* __restrict__ kv_lens,        // [B]
                  const int* __restrict__ q_lens,         // [B]
                  const int* __restrict__ q_start,        // [B]
                  const int* __restrict__ block_seq,      // [NQB], -1 = padding
                  const int* __restrict__ block_row,      // [NQB]
                  const int* __restrict__ block_qofs,     // [NQB]
                  TQ* __restrict__ out,                   // [T, Hq, D]
                  int Hq, int Hkv, int row_stride, int maxP, int page_size,
                  float scale, float cap, int window) {
  constexpr int TPR = ext_tpr<D>(), NT = ext_nt<D>(), TK = EXT_TK;
  constexpr int NC = EXT_DPT / 4;  // float4 chunks per thread
  using Tile = KVTile<TKV, D, TK, NT>;
  __shared__ __align__(16) float sK[TK * D];
  __shared__ __align__(16) float sV[TK * D];
  const int i = blockIdx.x, hq = blockIdx.y, tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int b = block_seq[i];
  if (b < 0) return;  // padding entry: writes nothing
  const int G = Hq / Hkv, h = hq / G;
  const int row0 = block_row[i], qofs = block_qofs[i];
  const int kv_len = kv_lens[b];
  const int n_rows = min(q_lens[b] - qofs, EXTEND_QBLK);
  const int q_abs_lo = q_start[b] + qofs;
  const int q_abs_hi = q_abs_lo + n_rows - 1;
  const int limit = min(min(kv_len, q_abs_hi + 1), maxP * page_size);
  const bool active = row < n_rows;
  const int q_abs = q_abs_lo + row;
  const int lo = window > 0 ? max(q_abs_lo - window + 1, 0) : 0;
  // the TPR lanes of this row (consecutive lanes of one warp); a row is
  // active or not as a whole, so its lanes meet at every shuffle
  const unsigned lane = tid % 32;
  const unsigned row_mask = ((TPR >= 32) ? 0xffffffffu : ((1u << TPR) - 1u))
                            << (lane & ~(unsigned)(TPR - 1));

  // this thread's dims: float4 chunk c = j * TPR + part, dims 4c .. 4c + 3
  float qr[EXT_DPT], o[EXT_DPT];
#pragma unroll
  for (int d = 0; d < EXT_DPT; ++d) {
    o[d] = 0.f;
    qr[d] = 0.f;
  }
  if (active) {
    const TQ* src = q + ((int64_t)(row0 + row) * Hq + hq) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 v = load4(src + (j * TPR + part) * 4);
      qr[4 * j] = v.x;
      qr[4 * j + 1] = v.y;
      qr[4 * j + 2] = v.z;
      qr[4 * j + 3] = v.w;
    }
  }
  float m = NEG_INF, l = 0.f;

  const int* pt_row = page_table + (int64_t)b * maxP;
  const TKV* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  Tile tile;
  tile.load(kb, v_off, pt_row, page_size, row_stride, lo, limit, tid);

  for (int start = lo; start < limit; start += TK) {
    __syncthreads();  // the previous tile is fully consumed
    tile.template store<D>(sK, sV, tid);
    __syncthreads();
    if (start + TK < limit)
      tile.load(kb, v_off, pt_row, page_size, row_stride, start + TK, limit, tid);
    if (!active) continue;

    float s[TK];
#pragma unroll
    for (int t = 0; t < TK; ++t) s[t] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 qq = make_float4(qr[4 * j], qr[4 * j + 1], qr[4 * j + 2], qr[4 * j + 3]);
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float4 kk = reinterpret_cast<const float4*>(sK + t * D)[j * TPR + part];
        float a = s[t];
        a = fmaf(qq.x, kk.x, a);
        a = fmaf(qq.y, kk.y, a);
        a = fmaf(qq.z, kk.z, a);
        a = fmaf(qq.w, kk.w, a);
        s[t] = a;
      }
    }
#pragma unroll
    for (int t = 0; t < TK; ++t)
#pragma unroll
      for (int x = TPR / 2; x > 0; x >>= 1) s[t] += __shfl_xor_sync(row_mask, s[t], x);
    unsigned valid = 0u;
    float mx = NEG_INF;
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const int pos = start + t;
      const bool ok = pos < limit && pos <= q_abs && (window <= 0 || pos > q_abs - window);
      float v = s[t] * scale;
      if (cap > 0.f) v = cap * tanhf(v / cap);
      s[t] = ok ? v : NEG_INF;
      valid |= (ok ? 1u : 0u) << t;
      mx = fmaxf(mx, s[t]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const float p = ((valid >> t) & 1u) ? expf(s[t] - m_new) : 0.f;
      sum += p;
      s[t] = round_p<TQ>(p);
    }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < EXT_DPT; ++d) o[d] *= corr;
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const float p = s[t];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(sV + t * D)[j * TPR + part];
        o[4 * j] = fmaf(p, vv.x, o[4 * j]);
        o[4 * j + 1] = fmaf(p, vv.y, o[4 * j + 1]);
        o[4 * j + 2] = fmaf(p, vv.z, o[4 * j + 2]);
        o[4 * j + 3] = fmaf(p, vv.w, o[4 * j + 3]);
      }
    }
  }
  if (!active) return;
  TQ* dst = out + ((int64_t)(row0 + row) * Hq + hq) * D;
  const float ls = l > 0.f ? l : 1.f;  // a row that saw no position writes 0
#pragma unroll
  for (int j = 0; j < NC; ++j)
    store4(dst + (j * TPR + part) * 4, make_float4(o[4 * j] / ls, o[4 * j + 1] / ls,
                                                   o[4 * j + 2] / ls, o[4 * j + 3] / ls));
}

template <typename TQ, typename TKV, int D>
static int launch_extend(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                         const void* kv_lens, const void* q_lens, const void* q_start,
                         const void* block_seq, const void* block_row, const void* block_qofs,
                         void* out, int NQB, int Hq, int Hkv, int row_stride, int maxP,
                         int page_size, float scale, float cap, int window,
                         cudaStream_t stream) {
  rpa_extend_kernel<TQ, TKV, D><<<dim3(NQB, Hq), ext_nt<D>(), 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<TQ*>(out), Hq, Hkv, row_stride, maxP, page_size, scale, cap, window);
  return (int)cudaGetLastError();
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/ragged_paged_attention.py).
// k_pool / v_pool: K and V of the layer at slot 0; row_stride: elements
// from one slot to the next (rpa_common.cuh). q_type / kv_type: TypeCode.
// `out` must be zero-filled by the caller: rows no entry owns (bucket
// padding) are left untouched. cap <= 0: no softcap; window <= 0: no
// window. Returns cudaError_t; a head_dim or type pair this build lacks is
// cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                                const void* page_table, const void* kv_lens, const void* q_lens,
                                const void* q_start, const void* block_seq,
                                const void* block_row, const void* block_qofs, void* out,
                                int NQB, int Hq, int Hkv, int D, int row_stride, int maxP,
                                int page_size, float scale, float cap, int window, int q_type,
                                int kv_type, void* stream) {
  using namespace rpa;
  if (NQB == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || D != RPA_HEAD_DIM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_EXT(QC, TQ, KC, TKV)                                                             \
  if (q_type == QC && kv_type == KC)                                                         \
    return launch_extend<TQ, TKV, RPA_HEAD_DIM>(q, k_pool, v_pool, page_table, kv_lens,      \
                                                q_lens, q_start, block_seq, block_row,       \
                                                block_qofs, out, NQB, Hq, Hkv, row_stride,   \
                                                maxP, page_size, scale, cap, window, s);
  RPA_FOR_EACH_PAIR(RPA_EXT)
#undef RPA_EXT
  return (int)cudaErrorInvalidValue;
}
