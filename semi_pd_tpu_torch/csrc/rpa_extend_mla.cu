// Ragged paged extend (chunked-prefill) attention over the MLA latent pool,
// for Hopper (sm_90a).
//
// Replaces the MLA v_dim branch of semi_pd_tpu/ops/attention/
// ragged_paged_attention.py _rpa_kernel (called from ragged_paged_attention
// with v_dim): causal attention of the flat new tokens [T, Hq, MLA_DL] of
// every request over its cached prefix plus the new tokens, through the
// page table, driven by the host-built work list (block_seq / block_row /
// block_qofs), with optional logit softcap and sliding window; output
// [T, Hq, MLA_DV]. What it computes, its bound and the shared design are in
// rpa_mla.cuh.
//
// Extend mapping: one block per (work-list entry, query head, sub-tile of
// MLA_EXT_NR rows of the entry); 16 threads share two consecutive rows, so
// each latent value read from shared memory feeds both. The JAX kernel ran its
// MLA extend with 64-row q-blocks against the 128-row work list and left
// rows 64-127 of each entry unwritten (ROADMAP C1); here the work list and
// this kernel share EXTEND_QBLK (the build passes it from
// ops/attention/ragged_paged_attention.py::EXTEND_Q_BLOCK), and the entry's
// rows are split over EXTEND_QBLK / MLA_EXT_NR blocks that together cover
// all of them. A block walks its request's positions up to min(kv_len, its
// last row's position + 1) and writes ONLY the rows of its entry it owns;
// padding entries (block_seq == -1) and sub-tiles past the entry's rows
// write nothing.
#include "rpa_mla.cuh"

#ifndef EXTEND_QBLK
#error "EXTEND_QBLK must be defined by the build (EXTEND_Q_BLOCK)"
#endif

namespace rpa {

constexpr int MLA_EXT_NR = 32;   // query rows per block
constexpr int MLA_EXT_RPT = 2;   // rows per thread
constexpr int MLA_EXT_TPR = 16;  // threads per row (group of rows)
constexpr int MLA_EXT_NT = MLA_EXT_NR / MLA_EXT_RPT * MLA_EXT_TPR;
static_assert(EXTEND_QBLK % MLA_EXT_NR == 0, "a work-list entry splits into whole sub-tiles");

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(MLA_EXT_NT)
rpa_extend_mla_kernel(const TQ* __restrict__ q,               // [T, Hq, MLA_DL]
                      const TKV* __restrict__ lat,            // latent rows of this layer at slot 0
                      const int* __restrict__ page_table,     // [B, maxP]
                      const int* __restrict__ kv_lens,        // [B]
                      const int* __restrict__ q_lens,         // [B]
                      const int* __restrict__ q_start,        // [B]
                      const int* __restrict__ block_seq,      // [NQB], -1 = padding
                      const int* __restrict__ block_row,      // [NQB]
                      const int* __restrict__ block_qofs,     // [NQB]
                      TQ* __restrict__ out,                   // [T, Hq, MLA_DV]
                      int Hq, int maxP, int page_size, float scale, float cap, int window) {
  __shared__ __align__(16) float sK[MLA_TK * MLA_LD];
  const int i = blockIdx.x, hq = blockIdx.y, tid = threadIdx.x;
  const int b = block_seq[i];
  if (b < 0) return;  // padding entry: writes nothing
  const int r0 = blockIdx.z * MLA_EXT_NR;  // this block's first row within the entry
  const int qofs = block_qofs[i];
  const int n_rows = min(q_lens[b] - qofs, EXTEND_QBLK);
  if (r0 >= n_rows) return;  // the entry is shorter: nothing to write
  const int rows = min(MLA_EXT_NR, n_rows - r0);
  const int kv_len = kv_lens[b];
  const int q_abs_lo = q_start[b] + qofs + r0;
  const int limit = min(min(kv_len, q_abs_lo + rows), maxP * page_size);
  const int lo = window > 0 ? max(q_abs_lo - window + 1, 0) : 0;
  const int row = tid / MLA_EXT_TPR * MLA_EXT_RPT;  // this thread's first row
  const int64_t t = (int64_t)block_row[i] + r0 + min(row, rows - 1);
  mla_attend<TQ, TKV, MLA_EXT_TPR, MLA_EXT_RPT, MLA_EXT_NT>(
      q + (t * Hq + hq) * MLA_DL, (int64_t)Hq * MLA_DL, out + (t * Hq + hq) * MLA_DV,
      (int64_t)Hq * MLA_DV, min(max(rows - row, 0), MLA_EXT_RPT), q_abs_lo + row, 1, lat,
      page_table + (int64_t)b * maxP, page_size, lo, limit, scale, cap, window, sK, tid);
}

template <typename TQ, typename TKV>
static int launch_extend_mla(const void* q, const void* lat, const void* pt,
                             const void* kv_lens, const void* q_lens, const void* q_start,
                             const void* block_seq, const void* block_row,
                             const void* block_qofs, void* out, int NQB, int Hq, int maxP,
                             int page_size, float scale, float cap, int window,
                             cudaStream_t stream) {
  const dim3 grid(NQB, Hq, EXTEND_QBLK / MLA_EXT_NR);
  rpa_extend_mla_kernel<TQ, TKV><<<grid, MLA_EXT_NT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(lat), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<TQ*>(out), Hq, maxP, page_size, scale, cap, window);
  return (int)cudaGetLastError();
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/ragged_paged_attention.py),
// with the signature of the other extend kernels: k_pool is the layer's
// latent rows at slot 0 and v_pool must be the same address (V is the row's
// prefix); Hkv 1, D = row_stride = MLA_DL; out is [T, Hq, MLA_DV] (the
// wrapper holds v_dim to MLA_DV). q_type / kv_type: TypeCode. `out` must
// be zero-filled by the caller: rows no entry owns (bucket padding) are left
// untouched. cap <= 0: no softcap; window <= 0: no window. Returns
// cudaError_t; another geometry or type pair is cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                              const void* page_table, const void* kv_lens, const void* q_lens,
                              const void* q_start, const void* block_seq,
                              const void* block_row, const void* block_qofs, void* out,
                              int NQB, int Hq, int Hkv, int D, int row_stride,
                              int maxP, int page_size, float scale, float cap, int window,
                              int q_type, int kv_type, void* stream) {
  using namespace rpa;
  if (NQB == 0) return 0;
  if (Hq <= 0 || Hkv != 1 || D != MLA_DL || row_stride != MLA_DL ||
      v_pool != k_pool)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_EXT(QC, TQ, KC, TKV)                                                           \
  if (q_type == QC && kv_type == KC)                                                       \
    return launch_extend_mla<TQ, TKV>(q, k_pool, page_table, kv_lens, q_lens, q_start,     \
                                      block_seq, block_row, block_qofs, out, NQB, Hq, maxP, \
                                      page_size, scale, cap, window, s);
  RPA_MLA_FOR_EACH_PAIR(RPA_EXT)
#undef RPA_EXT
  return (int)cudaErrorInvalidValue;
}
