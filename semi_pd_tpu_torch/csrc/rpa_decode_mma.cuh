// The warp tile of the tensor-core decodes: rpa_decode.cu's
// rpa_decode_mma_kernel (the packed decode, each request's positions split
// over warps and blocks) and rpa_stream.cu's rpa_stream_mma_kernel (the
// streaming decode, each warp an equal share of the batch's KV tiles).
//
// One warp computes a head group, at most 16 query heads of one KV head
// (all G of them at G <= 16), the rows of one m16 tile (rows past the
// group's end are zero and written nowhere), against tiles of TK
// KV positions staged as bf16 in shared memory, rows LD elements apart:
//   - S = Q K^T by mma.sync m16n8k16 bf16 -> f32, K fragments by ldmatrix:
//     exact products, float32 sums;
//   - the softcap, and the mask of a tile that crosses lo or hi;
//   - a float32 online softmax in the log2 domain per query row;
//   - O += P V, V fragments by ldmatrix.trans, with P rounded to bf16 (to
//     nearest, as astype rounds it: one product), or with -DRPA_P_F32 as its
//     two bf16 parts hi + lo (split_bf16, rpa_common.cuh: two products, P
//     kept float32 to 2^-18). The running sum l adds the unrounded p.
// A tile is 16, 32 or more positions (m16n8k16 for P V, k = 16 positions),
// or 8 (m16n8k8): the streaming decode's tile at head_dim 128 and 256, and
// the packed decode's at 256, which keeps the rings' bytes per tile as at
// the narrower widths.
//
// Q's A fragments stay in registers up to head_dim 128. At 256, where O
// alone takes 128 registers a thread and Q's fragments would take 64 more,
// Q's 16 rows go to a bf16 tile in shared memory and each k-step's
// fragment is read by ldmatrix where S needs it (MmaQ).
//
// A warp's partial (m c, l, O) of its 16 rows is staged in shared memory
// (mma_stage) and partials are merged in a fixed order in log-sum-exp form
// (merge_partials): no atomics, so two calls are bitwise equal.
#pragma once

#include "rpa_common.cuh"

namespace rpa {

// ldmatrix lane offsets in bytes into a K and a V tile, as in rpa_extend.cu.
// TK a multiple of 16: K fragments of S = Q K^T (matrices 2 and 3 are
// positions 8-15, 1 and 3 the upper 8 dims); V by .trans (matrices 1 and 3
// are positions 8-15, 2 and 3 the next 8 dims). TK 8: matrix j is positions
// 0-7 at dims 8 j .. 8 j + 7 of a 32-dim block, for K and for V alike.
template <int LD, int TK>
__device__ __forceinline__ void mma_lanes(int lane, uint32_t& k_lane, uint32_t& v_lane) {
  const int l7 = lane & 7;
  if constexpr (TK % 16 == 0) {
    const int l8 = ((lane >> 3) & 1) * 8, l16 = ((lane >> 4) & 1) * 8;
    k_lane = ((l7 + l16) * LD + l8) * 2;
    v_lane = ((l7 + l8) * LD + l16) * 2;
  } else {
    static_assert(TK == 8, "a warp tile is 8 positions or a multiple of 16");
    k_lane = v_lane = (l7 * LD + (lane >> 3) * 8) * 2;
  }
}

// Head group hg of the Hkv ceil(G / 16) a grid of the tensor-core decodes
// spans, G = Hq / Hkv: KV head h's query heads [hq0, hq0 + GB), group j of
// h the heads [h G + 16 j, h G + min(16 j + 16, G)). The kernels take
// GROUPS (G > 16) as a template argument, so that at G <= 16, one group a
// KV head (hg = h), they keep the code and registers they had before head
// groups.
template <bool GROUPS>
__device__ __forceinline__ void mma_head_group(int Hq, int Hkv, int hg, int& h, int& hq0,
                                               int& GB) {
  const int G = Hq / Hkv, NG = GROUPS ? (G + 15) >> 4 : 1;
  h = GROUPS ? hg / NG : hg;
  hq0 = h * G + 16 * (hg - h * NG);
  GB = GROUPS ? min(16, h * G + G - hq0) : G;
}

// The A fragments of Q for one warp: row g of the m16 tile is query row g
// of qb (G rows of D), zero past G.
template <int D>
__device__ __forceinline__ void mma_load_q(uint32_t (&qa)[D / 16][4],
                                           const __nv_bfloat16* __restrict__ qb, int G,
                                           int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e & 1), c = ks * 16 + 8 * (e >> 1) + 2 * tig;
      qa[ks][e] = r < G ? *reinterpret_cast<const uint32_t*>(qb + r * D + c) : 0u;
    }
}

// A warp's Q operand of S = Q K^T: the A fragments in registers (qa, from
// mma_load_q), or with SMEM (head_dim 256) a 16-row bf16 tile in shared
// memory, rows LD elements apart (ldmatrix without bank conflicts), written
// by mma_store_q and read a k-step at a time (frag).
template <int D>
struct MmaQ {
  static constexpr bool SMEM = D > 128;
  static constexpr int LD = D + 8;
  static constexpr int BYTES = SMEM ? 16 * LD * 2 : 0;  // the shared tile
  uint32_t qa[SMEM ? 1 : D / 16][4];
  uint32_t s_lane;  // SMEM: this lane's ldmatrix row address at k-step 0

  // SMEM: the tile at `tile` (l16 / l8: matrices 2-3 the upper 8 dims,
  // 1 and 3 rows 8-15, as mma.sync's A fragment orders them)
  __device__ __forceinline__ void point(const __nv_bfloat16* tile, int lane) {
    const int l7 = lane & 7, l8 = ((lane >> 3) & 1) * 8, l16 = ((lane >> 4) & 1) * 8;
    s_lane = static_cast<uint32_t>(__cvta_generic_to_shared(tile)) + ((l7 + l8) * LD + l16) * 2;
  }
  // the A fragment of k-step ks (dims 16 ks .. 16 ks + 15)
  __device__ __forceinline__ void frag(int ks, uint32_t (&a)[4]) const {
    if constexpr (SMEM) {
      ldmatrix_x4(a, s_lane + ks * 32);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
    }
  }
};

// Writes the 16 rows of an m16 tile of Q, query rows g < G of qb (G rows
// of D) and zeros past G, into the shared tile of MmaQ<D>; thread t of nt
// copies every nt-th 16-byte vector. The caller synchronises before the
// tile is read.
template <int D>
__device__ __forceinline__ void mma_store_q(__nv_bfloat16* tile,
                                            const __nv_bfloat16* __restrict__ qb, int G, int t,
                                            int nt) {
  constexpr int VR = D / 8;  // vectors a row
  for (int v = t; v < 16 * VR; v += nt) {
    const int r = v / VR, c = v - r * VR;
    *reinterpret_cast<uint4*>(tile + r * MmaQ<D>::LD + c * 8) =
        r < G ? *reinterpret_cast<const uint4*>(qb + r * D + c * 8) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A warp's softmax state: O (rows gid and gid + 8, columns d * 8 + 2 tig
// and + 1 of each 8-wide block d), the running max m (raw dot or capped
// score) and sum l of its two rows.
template <int D>
struct MmaState {
  float o[D / 8][4];
  float mrow[2], lrow[2];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    mrow[0] = mrow[1] = NEG_INF;
    lrow[0] = lrow[1] = 0.f;
  }
};

// ALiBi's state of one lane (an ALIBI instantiation; rpa_common.cuh): the
// slopes of its two rows (gid and gid + 8 of the m16 tile; 0 past G) and
// the position of the query they belong to.
struct MmaAlibi {
  float slope[2];
  int qpos;
};

// The second half of a tile of TK positions starting at position st, given
// its scores sc (the C fragments of S = Q K^T: TK / 8 n8 tiles of 8
// positions): the softcap, the mask, the online softmax and O += P V, with
// V at the shared address sV (rows LD elements apart, its first D columns
// O's). Positions outside [lo, hi) score nothing (only a tile that crosses
// lo or hi is masked). p = 2^(v c - m c), v the raw dot (c = scale log2 e)
// or, with cap > 0, the capped score (c = log2 e). With ALIBI every score
// is scaled (and capped), then biased by its row's slope times the
// distance to the query (c = log2 e). The MLA decodes' block tile
// (rpa_mla_mma.cuh) runs it on the scores its warps add up, with D the 128
// of V's columns a warp owns.
template <int D, int LD, int TK, bool ALIBI = false>
__device__ __forceinline__ void mma_softmax_pv(MmaState<D>& s, float (&sc)[(TK + 7) / 8][4],
                                               uint32_t sV, uint32_t v_lane, int st, int lo,
                                               int hi, float scale, float cap, bool capped,
                                               float c, int tig, const MmaAlibi& al = {}) {
  constexpr int NJ = (TK + 7) / 8;
  // softcap, ALiBi, mask (only a tile that crosses lo or hi) and the row max
  const bool masked = st < lo || st + TK > hi;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[j][e];
      if constexpr (ALIBI) {
        v = capped ? cap * tanhf(v * scale / cap) : v * scale;
        const int pos = st + j * 8 + 2 * tig + (e & 1);
        v -= al.slope[e >> 1] * static_cast<float>(al.qpos - pos);
      } else if (capped) {
        v = cap * tanhf(v * scale / cap);
      }
      if (masked) {
        const int pos = st + j * 8 + 2 * tig + (e & 1);
        v = (pos >= lo && pos < hi) ? v : NEG_INF;
      }
      sc[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float corr[2], mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(s.mrow[rr], mx[rr]);
    corr[rr] = fast_exp2((s.mrow[rr] - m_new) * c);
    s.mrow[rr] = m_new;
    // a row with nothing valid yet keeps m at NEG_INF: p = 2^(NEG_INF c) = 0
    mc[rr] = (m_new == NEG_INF ? 0.f : m_new) * c;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[j][e], c, -mc[e >> 1]));
      psum[e >> 1] += p;
      sc[j][e] = p;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) s.lrow[rr] = s.lrow[rr] * corr[rr] + psum[rr];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    s.o[d][0] *= corr[0];
    s.o[d][1] *= corr[0];
    s.o[d][2] *= corr[1];
    s.o[d][3] *= corr[1];
  }
  // O += P V: P rounded to bf16 (pa), or with P_F32_BUILD as its bf16
  // parts pa + pl (P kept in float32)
  if constexpr (TK % 16 == 0) {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      [[maybe_unused]] uint32_t pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p0 = sc[2 * kk + (e >> 1)][2 * (e & 1)];
        const float p1 = sc[2 * kk + (e >> 1)][2 * (e & 1) + 1];
        if constexpr (P_F32_BUILD)
          split_bf16(p0, p1, pa[e], pl[e]);
        else
          pa[e] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + v_lane + (kk * 16 * LD + dp * 16) * 2);
        mma_bf16_16816(s.o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(s.o[2 * dp + 1], pa, vf[2], vf[3]);
        if constexpr (P_F32_BUILD) {
          mma_bf16_16816(s.o[2 * dp], pl, vf[0], vf[1]);
          mma_bf16_16816(s.o[2 * dp + 1], pl, vf[2], vf[3]);
        }
      }
    }
  } else {  // TK 8: P is the m16 x k8 A fragment; one x4.trans load, 4 dim blocks
    uint32_t pa[2];
    [[maybe_unused]] uint32_t pl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (P_F32_BUILD)
        split_bf16(sc[0][2 * e], sc[0][2 * e + 1], pa[e], pl[e]);
      else
        pa[e] = pack_bf16(sc[0][2 * e], sc[0][2 * e + 1]);
    }
#pragma unroll
    for (int dq = 0; dq < D / 32; ++dq) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sV + v_lane + dq * 32 * 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_bf16_1688(s.o[4 * dq + j], pa, vf[j]);
        if constexpr (P_F32_BUILD) mma_bf16_1688(s.o[4 * dq + j], pl, vf[j]);
      }
    }
  }
}

// One tile of TK positions starting at position st, K and V at the shared
// addresses sK and sV: S = Q K^T, then mma_softmax_pv (with ALIBI, its
// ALiBi instantiation).
template <int D, int LD, int TK, bool ALIBI = false>
__device__ __forceinline__ void mma_tile(MmaState<D>& s, const MmaQ<D>& q, uint32_t sK,
                                         uint32_t sV, uint32_t k_lane, uint32_t v_lane, int st,
                                         int lo, int hi, float scale, float cap, bool capped,
                                         float c, int tig, const MmaAlibi& al = {}) {
  constexpr int KS = D / 16, NJ = (TK + 7) / 8;
  // S = Q K^T: TK / 8 n8 tiles of 8 positions
  float sc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  if constexpr (TK % 16 == 0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      q.frag(ks, a);
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + k_lane + (np * 16 * LD + ks * 16) * 2);
        mma_bf16_16816(sc[2 * np], a, kf[0], kf[1]);
        mma_bf16_16816(sc[2 * np + 1], a, kf[2], kf[3]);
      }
    }
  } else {  // TK 8: one x4 load covers two k16 steps of the dims
#pragma unroll
    for (int kp = 0; kp < KS / 2; ++kp) {
      uint32_t kf[4], a0[4], a1[4];
      ldmatrix_x4(kf, sK + k_lane + kp * 32 * 2);
      q.frag(2 * kp, a0);
      q.frag(2 * kp + 1, a1);
      mma_bf16_16816(sc[0], a0, kf[0], kf[1]);
      mma_bf16_16816(sc[0], a1, kf[2], kf[3]);
    }
  }
  mma_softmax_pv<D, LD, TK, ALIBI>(s, sc, sV, v_lane, st, lo, hi, scale, cap, capped, c, tig,
                                   al);
}

// l of row rr, summed over the four lanes of a quad
template <int D>
__device__ __forceinline__ float mma_row_sum(const MmaState<D>& s, int rr) {
  float l = s.lrow[rr];
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return l;
}

// Stages the warp's partial of its 16 rows (with CLIP, of its first G) as
// rows row0 .. row0 + 15 of sO ([.][D]: O) and sML ([.][2]: m c, l), in
// shared or global memory.
template <int D, bool CLIP = false>
__device__ __forceinline__ void mma_stage(const MmaState<D>& s, float* sO, float* sML, int row0,
                                          float c, int lane, int G = 16) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = mma_row_sum(s, rr);
    const int r = gid + 8 * rr;
    if (CLIP && r >= G) continue;
    if (tig == 0) {
      sML[(row0 + r) * 2] = s.mrow[rr] * c;
      sML[(row0 + r) * 2 + 1] = l;
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<float2*>(sO + (row0 + r) * D + d * 8 + 2 * tig) =
          make_float2(s.o[d][2 * rr], s.o[d][2 * rr + 1]);
  }
}

// Merges n <= N staged partials in the order given, output (row r, dim d):
// m = max of their (m c) over those that saw a position (l > 0), l = sum
// 2^(m_i - m) l_i, acc = sum 2^(m_i - m) O_i. The output is acc / l (0
// where l is 0), or (acc, m, l) a partial again.
template <int D, int N>
__device__ __forceinline__ void merge_partials(const float* const (&po)[N],
                                               const float* const (&pml)[N], int n, int r,
                                               int d, float& m, float& l, float& acc) {
  m = NEG_INF;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n && pml[i][r * 2 + 1] > 0.f) m = fmaxf(m, pml[i][r * 2]);
  l = 0.f;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const float lw = pml[i][r * 2 + 1];
      if (lw > 0.f) {
        const float f = fast_exp2(pml[i][r * 2] - m);
        l = fmaf(lw, f, l);
        acc = fmaf(po[i][r * D + d], f, acc);
      }
    }
  }
}

}  // namespace rpa
