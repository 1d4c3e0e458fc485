// Ragged paged extend (chunked-prefill) attention over the chunked combined
// KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel semi_pd_tpu/ops/attention/ragged_paged_attention.py
// _rpa_kernel_chunked (driver ragged_paged_attention_chunked): causal
// attention of the flat new tokens [T, Hq, D] of every request over its
// cached prefix plus the new tokens, through the page table, driven by the
// host-built work list (block_seq / block_row / block_qofs), with optional
// logit softcap and sliding window.
//
// Bound on this card: operations at the main path's shapes. A block of
// q_len new tokens over kv_len positions does ~4 * q_len * kv_len * Hq * D
// causal operations while reading the kv_len rows once, well above the
// ~295 operations per byte where the H100's bf16 tensor cores bind.
//
// Design: one block of EXTEND_QBLK threads per (work-list entry, query
// head), one thread per query row of the entry. EXTEND_QBLK is passed in by
// the build from ops/attention/ragged_paged_attention.py::EXTEND_Q_BLOCK,
// the same constant the host work list is built with, so the list and the
// kernel agree on the block height. Each thread keeps its query row and its
// float32 output row in registers; KV tiles of 32 positions go through
// shared memory as float32 and every thread reads each K and V row as a
// broadcast. The next tile's loads are issued into registers before the
// current one is computed. The walk stops at min(kv_len, last row's
// position + 1); rows mask causally, by kv_len and by the window. A block
// writes ONLY the n_rows = min(q_len - qofs, QBLK) rows its entry owns (the
// TPU kernel wrote its whole block and relied on grid order for the next
// sequence to overwrite the overrun; blocks here run in parallel), and
// padding entries (block_seq == -1) write nothing. The arithmetic runs on
// the CUDA cores in float32; a wgmma/TMA version is later work.
#include "rpa_common.cuh"

#ifndef EXTEND_QBLK
#error "EXTEND_QBLK must be defined by the build (EXTEND_Q_BLOCK)"
#endif

namespace rpa {

constexpr int EXT_TK = 32;  // KV positions per tile

template <typename T, int D>
__global__ void __launch_bounds__(EXTEND_QBLK)
rpa_extend_kernel(const T* __restrict__ q,               // [T, Hq, D]
                  const T* __restrict__ pool,            // layer slice [S, CT*128]
                  const int* __restrict__ page_table,    // [B, maxP]
                  const int* __restrict__ kv_lens,       // [B]
                  const int* __restrict__ q_lens,        // [B]
                  const int* __restrict__ q_start,       // [B]
                  const int* __restrict__ block_seq,     // [NQB], -1 = padding
                  const int* __restrict__ block_row,     // [NQB]
                  const int* __restrict__ block_qofs,    // [NQB]
                  T* __restrict__ out,                   // [T, Hq, D]
                  int Hq, int Hkv, int row_stride, int maxP, int page_size,
                  float scale, float cap, int window) {
  constexpr int NT = EXTEND_QBLK, TK = EXT_TK, VE = Vec<T>::N;
  using Tile = KVTile<T, D, TK, NT>;
  __shared__ __align__(16) float sK[TK * D];
  __shared__ __align__(16) float sV[TK * D];
  const int i = blockIdx.x, hq = blockIdx.y, tid = threadIdx.x;
  const int b = block_seq[i];
  if (b < 0) return;  // padding entry: writes nothing
  const int G = Hq / Hkv, h = hq / G;
  const int row0 = block_row[i], qofs = block_qofs[i];
  const int kv_len = kv_lens[b];
  const int n_rows = min(q_lens[b] - qofs, NT);
  const int q_abs_lo = q_start[b] + qofs;
  const int q_abs_hi = q_abs_lo + n_rows - 1;
  const int limit = min(min(kv_len, q_abs_hi + 1), maxP * page_size);
  const bool active = tid < n_rows;
  const int q_abs = q_abs_lo + tid;
  const int lo = window > 0 ? max(q_abs_lo - window + 1, 0) : 0;

  float qr[D], o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  if (active) {
    const uint4* src =
        reinterpret_cast<const uint4*>(q + ((int64_t)(row0 + tid) * Hq + hq) * D);
#pragma unroll
    for (int c = 0; c < D / VE; ++c) unpack<T>(src[c], qr + c * VE);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int* pt_row = page_table + (int64_t)b * maxP;
  const int k_off = h * D, v_off = (Hkv + h) * D;
  Tile tile;
  tile.load(pool, pt_row, page_size, row_stride, k_off, v_off, lo, limit, tid);

  for (int start = lo; start < limit; start += TK) {
    __syncthreads();  // the previous tile is fully consumed
    tile.template store<D>(sK, sV, tid);
    __syncthreads();
    if (start + TK < limit)
      tile.load(pool, pt_row, page_size, row_stride, k_off, v_off, start + TK, limit, tid);
    if (!active) continue;

    float s[TK];
#pragma unroll
    for (int t = 0; t < TK; ++t) s[t] = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qq = make_float4(qr[4 * d4], qr[4 * d4 + 1], qr[4 * d4 + 2], qr[4 * d4 + 3]);
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float4 kk = reinterpret_cast<const float4*>(sK + t * D)[d4];
        float a = s[t];
        a = fmaf(qq.x, kk.x, a);
        a = fmaf(qq.y, kk.y, a);
        a = fmaf(qq.z, kk.z, a);
        a = fmaf(qq.w, kk.w, a);
        s[t] = a;
      }
    }
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
      s[t] = round_p<T>(p);
    }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= corr;
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      const float p = s[t];
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = reinterpret_cast<const float4*>(sV + t * D)[d4];
        o[4 * d4] = fmaf(p, vv.x, o[4 * d4]);
        o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
      }
    }
  }
  if (!active) return;
  uint4* dst = reinterpret_cast<uint4*>(out + ((int64_t)(row0 + tid) * Hq + hq) * D);
  float res[D];
#pragma unroll
  for (int d = 0; d < D; ++d) res[d] = l > 0.f ? o[d] / l : 0.f;
#pragma unroll
  for (int c = 0; c < D / VE; ++c) dst[c] = pack<T>(res + c * VE);
}

template <typename T, int D>
static int launch_extend(const void* q, const void* pool, const void* pt, const void* kv_lens,
                         const void* q_lens, const void* q_start, const void* block_seq,
                         const void* block_row, const void* block_qofs, void* out, int NQB,
                         int Hq, int Hkv, int row_stride, int maxP, int page_size,
                         float scale, float cap, int window, cudaStream_t stream) {
  rpa_extend_kernel<T, D><<<dim3(NQB, Hq), EXTEND_QBLK, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<T*>(out), Hq, Hkv, row_stride, maxP, page_size, scale, cap, window);
  return (int)cudaGetLastError();
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/ragged_paged_attention.py).
// pool: the layer's [S, CT*128] slice; row_stride = CT*128 elements. `out`
// must be zero-filled by the caller: rows no entry owns (bucket padding)
// are left untouched. cap <= 0: no softcap; window <= 0: no window.
extern "C" int rpa_extend(const void* q, const void* pool, const void* page_table,
                          const void* kv_lens, const void* q_lens, const void* q_start,
                          const void* block_seq, const void* block_row,
                          const void* block_qofs, void* out, int NQB, int Hq, int Hkv, int D,
                          int row_stride, int maxP, int page_size, float scale, float cap,
                          int window, int is_bf16, void* stream) {
  using namespace rpa;
  if (NQB == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_EXT(T, DD)                                                                    \
  return launch_extend<T, DD>(q, pool, page_table, kv_lens, q_lens, q_start, block_seq,   \
                              block_row, block_qofs, out, NQB, Hq, Hkv, row_stride, maxP, \
                              page_size, scale, cap, window, s)
  if (D != 64) return (int)cudaErrorInvalidValue;  // the main path's head_dim only
  if (is_bf16) RPA_EXT(__nv_bfloat16, 64);
  RPA_EXT(float, 64);
#undef RPA_EXT
}
