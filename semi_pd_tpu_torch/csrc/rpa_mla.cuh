// Shared core of the MLA attention kernels over the latent pool
// [L, 1, S, 1, Dlat] (rpa_decode_mla.cu, rpa_extend_mla.cu, and the
// streaming decode's MLA build in rpa_stream.cu).
//
// MLA in its absorbed form (semi_pd_tpu/models/deepseek_v2.py): each slot
// holds one latent row [c_kv | k_pe] of MLA_DL elements, shared by all
// query heads (MQA with G = Hq). A query row is [q_nope . W_UK | q_pe],
// also MLA_DL wide; scores run over all MLA_DL dims, and V is the row's
// first MLA_DV elements, so the output is MLA_DV wide. The latent geometry
// is a build parameter (-DRPA_MLA_DL, -DRPA_MLA_DV): DeepSeek-V2's 512 + 64
// with V its first 512 by default, MiniCPM3's 256 + 32 with V its first
// 256 in the _288 builds; the wrappers refuse a width no build has.
//
// Bound on this card: at the main path's shapes decode reads kv_len *
// MLA_DL elements per request and does 2 * Hq * (MLA_DL + MLA_DV) operations
// per position, 30 per byte in bf16 with Hq 16 at 576 and 76 with Hq 40
// at 288 (above the ~20 the float32 CUDA cores sustain per byte, below the
// ~295 of the bf16 tensor cores); extend does the same per (query row,
// visible position) and is bound by operations. The MLA builds
// instantiate rpa_common.cuh's four (q, latent) pairs. The design below
// runs in float32 on the CUDA cores: the float32 pair's decodes and
// extend. With bf16 q over bf16 or fp8 (e4m3, e5m2) latent rows the
// decodes run on the tensor cores (rpa_mla_mma.cuh) and the extend on the
// warpgroup tensor cores (rpa_extend_mla.cu), fp8 rows widened exactly to
// bf16 on their way into shared memory, as the TPU kernels' MLA branches
// upcast the rows whatever their dtype; an fp8 row is half a bf16 row's
// bytes, so the decodes' bound halves.
//
// Design: a group of MLA_TPR threads holds RPT query rows. A row's query
// and float32 accumulator do not fit one thread's registers, so thread
// `part` of a group owns the float4 chunks c = j * TPR + part of its rows:
// MLA_DL / (4 * TPR) of q and, because the chunks below MLA_DV / 4 are
// exactly those with j < MLA_DV / (4 * TPR), the same number of V chunks
// for every part (no thread idles on the rope dims). That needs 4 TPR to
// divide both widths: TPR 16 at 576 / 512, TPR 8 at 288 / 256 (288 is not
// a multiple of 64), which leaves a thread the same 9 q chunks and 8 V
// chunks at both widths. Partial scores are summed over the group's lanes
// with __shfl_xor_sync; the lanes of a group read neighbouring 16-byte
// words of a latent row, and the other groups of the warp read the same
// words (a broadcast), so shared-memory reads are conflict-free. The block
// walks its request's KV positions [lo, limit) in tiles of MLA_TK latent
// rows, staged once in shared memory as float32 (a padded row of MLA_LD
// floats) and read as both K and V; the next tile's 16-byte loads are
// issued into registers before the current one is computed (KVTile,
// rpa_common.cuh). Positions at or past `limit` are never read. Online
// softmax in float32, and P stays float32 into P.V: the TPU kernels' MLA
// branches upcast q and the latent rows to float32, so every MLA build is
// -DRPA_P_F32 (round_p, rpa_common.cuh).
//
// Shared-memory reads, not the arithmetic, set the pace (PERF.md, PR 3):
// with one row per thread each float4 read feeds 4 FMAs per lane and the
// extend ran at a fifth of the CUDA cores' peak; two rows per thread (the
// extend's RPT) feed 8 and cut its time by 27%. More rows do not fit the
// 255 registers while q and the accumulator live in registers.
#pragma once

#include "rpa_common.cuh"

#ifndef RPA_MLA_DL
#define RPA_MLA_DL 576
#endif
#ifndef RPA_MLA_DV
#define RPA_MLA_DV 512
#endif

namespace rpa {

constexpr int MLA_DL = RPA_MLA_DL;  // latent row: kv_lora_rank + qk_rope
constexpr int MLA_DV = RPA_MLA_DV;  // V: the row's first kv_lora_rank elements
constexpr int MLA_TPR = 8 * (1 + (MLA_DL % 64 == 0));  // threads per row: 16, or 8 at 288
constexpr int MLA_TK = 16;          // KV positions per tile
constexpr int MLA_LD = MLA_DL + 4;  // shared row stride in floats: no bank conflicts

// The state of RPT query rows r = 0 .. RPT-1 held by one thread, lane
// `part` of a group of TPR (MLA_TPR) threads: its q chunks and output chunks (float4
// chunk c = j * TPR + part) and each row's running max and sum. Row r's
// query is q0 + r * q_step, its output out0 + r * out_step and its
// absolute position q_abs0 + r * q_abs_step; rows r >= n_act are not the
// block's (their lanes still compute, so a row's lanes always meet at the
// shuffles, but write nothing). RPT > 1 reuses each value read from shared
// memory for RPT rows.
template <typename TQ, int TPR, int RPT>
struct MlaRows {
  static_assert(MLA_DL % (4 * TPR) == 0 && MLA_DV % (4 * TPR) == 0 && 32 % TPR == 0,
                "TPR must divide the row's chunks and a warp");
  static constexpr int NQC = MLA_DL / (4 * TPR);  // q chunks per thread
  static constexpr int NVC = MLA_DV / (4 * TPR);  // V chunks per thread: its first NVC
  float qr[RPT][4 * NQC], o[RPT][4 * NVC], m[RPT], l[RPT];

  __device__ __forceinline__ void begin(const TQ* __restrict__ q0, int64_t q_step, int n_act,
                                        int part) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int d = 0; d < 4 * NVC; ++d) o[r][d] = 0.f;
#pragma unroll
      for (int j = 0; j < NQC; ++j) {
        const float4 v = r < n_act ? load4(q0 + r * q_step + (j * TPR + part) * 4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[r][4 * j] = v.x;
        qr[r][4 * j + 1] = v.y;
        qr[r][4 * j + 2] = v.z;
        qr[r][4 * j + 3] = v.w;
      }
    }
  }

  // One staged tile of MLA_TK latent rows sK (float32, row stride MLA_LD)
  // at positions [start, start + MLA_TK): each row sees the positions below
  // `limit` that its causal and window masks allow, and with TREE those the
  // speculation tree (window start wb) leaves to its ancestor mask bits[r].
  // row_mask: the TPR lanes of this thread's rows (consecutive lanes of one
  // warp).
  template <bool TREE = false>
  __device__ __forceinline__ void tile(const float* sK, int start, int limit, int q_abs0,
                                       int q_abs_step, float scale, float cap, int window,
                                       int part, unsigned row_mask,
                                       const SpecTree* tree = nullptr, int wb = 0,
                                       const unsigned* bits = nullptr) {
    constexpr int TK = MLA_TK, LD = MLA_LD;
    float s[RPT][TK];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int t = 0; t < TK; ++t) s[r][t] = 0.f;
#pragma unroll
    for (int j = 0; j < NQC; ++j) {
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float4 kk = reinterpret_cast<const float4*>(sK + t * LD)[j * TPR + part];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          float a = s[r][t];
          a = fmaf(qr[r][4 * j], kk.x, a);
          a = fmaf(qr[r][4 * j + 1], kk.y, a);
          a = fmaf(qr[r][4 * j + 2], kk.z, a);
          a = fmaf(qr[r][4 * j + 3], kk.w, a);
          s[r][t] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int t = 0; t < TK; ++t)
#pragma unroll
        for (int x = TPR / 2; x > 0; x >>= 1) s[r][t] += __shfl_xor_sync(row_mask, s[r][t], x);
      const int q_abs = q_abs0 + r * q_abs_step;
      unsigned valid = 0u;
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const int pos = start + t;
        const bool ok = pos < limit && pos <= q_abs && (window <= 0 || pos > q_abs - window) &&
                        (!TREE || spec_ok(*tree, wb, bits[r], pos));
        float v = s[r][t] * scale;
        if (cap > 0.f) v = cap * tanhf(v / cap);
        s[r][t] = ok ? v : NEG_INF;
        valid |= (ok ? 1u : 0u) << t;
        mx = fmaxf(mx, s[r][t]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float p = ((valid >> t) & 1u) ? expf(s[r][t] - m_new) : 0.f;
        sum += p;
        s[r][t] = round_p<TQ>(p);
      }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < 4 * NVC; ++d) o[r][d] *= corr;
    }
#pragma unroll
    for (int t = 0; t < TK; ++t) {
#pragma unroll
      for (int j = 0; j < NVC; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(sK + t * LD)[j * TPR + part];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float p = s[r][t];
          o[r][4 * j] = fmaf(p, vv.x, o[r][4 * j]);
          o[r][4 * j + 1] = fmaf(p, vv.y, o[r][4 * j + 1]);
          o[r][4 * j + 2] = fmaf(p, vv.z, o[r][4 * j + 2]);
          o[r][4 * j + 3] = fmaf(p, vv.w, o[r][4 * j + 3]);
        }
      }
    }
  }

  // out = o / l for the block's rows; a row that saw no position writes 0.
  __device__ __forceinline__ void write(TQ* __restrict__ out0, int64_t out_step, int n_act,
                                        int part) const {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (r >= n_act) continue;
      const float ls = l[r] > 0.f ? l[r] : 1.f;
      TQ* dst = out0 + r * out_step;
#pragma unroll
      for (int j = 0; j < NVC; ++j)
        store4(dst + (j * TPR + part) * 4,
               make_float4(o[r][4 * j] / ls, o[r][4 * j + 1] / ls, o[r][4 * j + 2] / ls,
                           o[r][4 * j + 3] / ls));
    }
  }
};

// The lanes of a group of TPR threads (consecutive lanes of one warp).
template <int TPR>
__device__ __forceinline__ unsigned mla_row_mask(int tid) {
  const unsigned lane = tid % 32;
  return ((TPR >= 32) ? 0xffffffffu : ((1u << TPR) - 1u)) << (lane & ~(unsigned)(TPR - 1));
}

// One block's walk over the positions [lo, limit) of one request (lo and
// limit are the same for the whole block; every thread calls this), for
// the RPT rows of MlaRows. Each row sees the positions its causal and
// window masks allow (with TREE, refined by the speculation tree whose
// window starts at wb); a row that sees none writes zeros.
template <typename TQ, typename TKV, int TPR, int RPT, int NT, bool TREE = false>
__device__ __forceinline__ void mla_attend(const TQ* __restrict__ q0, int64_t q_step,
                                           TQ* __restrict__ out0, int64_t out_step,
                                           int n_act, int q_abs0, int q_abs_step,
                                           const TKV* __restrict__ lat,
                                           const int* __restrict__ pt_row, int page_size,
                                           int lo, int limit, float scale, float cap,
                                           int window, float* sK, int tid,
                                           const SpecTree* tree = nullptr, int wb = 0) {
  constexpr int TK = MLA_TK, LD = MLA_LD;
  using Tile = KVTile<TKV, MLA_DL, TK, NT, 1>;
  const int part = tid % TPR;
  const unsigned row_mask = mla_row_mask<TPR>(tid);
  MlaRows<TQ, TPR, RPT> rows;
  rows.begin(q0, q_step, n_act, part);
  unsigned bits[RPT];  // each row's ancestor mask (with TREE)
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    bits[r] = TREE ? spec_bits(*tree, q_abs0 + r * q_abs_step - wb) : 0u;

  Tile tile;
  tile.load(lat, 0, pt_row, page_size, MLA_DL, lo, limit, tid);
  for (int start = lo; start < limit; start += TK) {
    __syncthreads();  // the previous tile is fully consumed
    tile.template store<LD>(sK, sK, tid);
    __syncthreads();
    if (start + TK < limit) tile.load(lat, 0, pt_row, page_size, MLA_DL, start + TK, limit, tid);
    if (n_act <= 0) continue;
    rows.template tile<TREE>(sK, start, limit, q_abs0, q_abs_step, scale, cap, window, part,
                             row_mask, tree, wb, bits);
  }
  rows.write(out0, out_step, n_act, part);
}

}  // namespace rpa
