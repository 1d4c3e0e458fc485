// The GQA decode's block-level pieces (rpa_decode.cu, and the streaming
// decode rpa_stream.cu): one block of DEC_NT threads holds the G query rows
// of one (request, KV head) in shared memory, walks the request's KV
// positions in tiles of dec_tk<D>() positions staged as float32 (KVTile),
// and keeps a float32 online softmax per query head.
//
// Per tile (decode_tile): scores s[g][t] = q_g . k_t * scale (softcapped),
// one warp per query head updates its running max and sum, and each thread
// accumulates up to DEC_MAXO outputs acc[g][d] = acc * corr + sum_t p[g][t]
// * v[t][d], P rounded by round_p (rpa_common.cuh). Positions at or past
// `limit` score nothing.
#pragma once

#include "rpa_common.cuh"

namespace rpa {

constexpr int DEC_NT = 128;  // threads per block
constexpr int DEC_MAXO = 8;  // outputs per thread: G * D <= DEC_MAXO * DEC_NT

template <int D>
__host__ __device__ constexpr int dec_tk() { return 4096 / D; }  // KV positions per tile
template <int D>
__host__ __device__ constexpr int dec_ld() { return D + 4; }  // padded rows: no bank conflicts

// Shared memory of one block, in floats: K and V tiles, the G query rows,
// the scores and three scalars per query head.
template <int D>
__host__ __device__ inline int dec_smem_floats(int G) {
  return 2 * dec_tk<D>() * dec_ld<D>() + G * D + G * dec_tk<D>() + 3 * G;
}

struct DecodeSmem {
  float* sK;  // [TK][LD]
  float* sV;  // [TK][LD]
  float* sQ;  // [G][D]
  float* sS;  // [G][TK] scores, then probabilities
  float* sM;  // [G] running max
  float* sL;  // [G] running sum
  float* sC;  // [G] this tile's correction factor
};

template <int D>
__device__ __forceinline__ DecodeSmem dec_smem(float* smem, int G) {
  constexpr int TK = dec_tk<D>(), LD = dec_ld<D>();
  DecodeSmem s;
  s.sK = smem;
  s.sV = s.sK + TK * LD;
  s.sQ = s.sV + TK * LD;
  s.sS = s.sQ + G * D;
  s.sM = s.sS + G * TK;
  s.sL = s.sM + G;
  s.sC = s.sL + G;
  return s;
}

// Stage the G query rows at qb and reset the softmax state. The caller
// synchronises before the first decode_tile.
template <typename TQ, int D>
__device__ __forceinline__ void decode_begin(const DecodeSmem& s, const TQ* __restrict__ qb,
                                             int G, float (&acc)[DEC_MAXO], int tid) {
  for (int i = tid; i < G * D; i += DEC_NT) s.sQ[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += DEC_NT) {
    s.sM[g] = NEG_INF;
    s.sL[g] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < DEC_MAXO; ++k) acc[k] = 0.f;
}

// One staged tile of positions [start, start + TK). Every thread calls it
// after the tile and the query rows are visible (a __syncthreads). With
// ALIBI, query head g's scores take its slope alibi[g] times the distance
// to the query at qpos (rpa_common.cuh), after the scale and the softcap.
template <typename TQ, int D, bool ALIBI = false>
__device__ __forceinline__ void decode_tile(const DecodeSmem& s, float (&acc)[DEC_MAXO], int G,
                                            int start, int limit, float scale, float cap,
                                            int tid, const float* __restrict__ alibi = nullptr,
                                            int qpos = 0) {
  constexpr int NT = DEC_NT, TK = dec_tk<D>(), LD = dec_ld<D>();
  const int warp = tid / 32, lane = tid % 32;
  // scores s[g][t] = q_g . k_t * scale (softcapped)
  for (int i = tid; i < G * TK; i += NT) {
    const int g = i / TK, t = i - g * TK;
    float sc = NEG_INF;
    if (start + t < limit) {
      const float4* kr = reinterpret_cast<const float4*>(s.sK + t * LD);
      const float4* qr = reinterpret_cast<const float4*>(s.sQ + g * D);
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D / 4; ++d) {
        const float4 kk = kr[d], qq = qr[d];
        a = fmaf(qq.x, kk.x, a);
        a = fmaf(qq.y, kk.y, a);
        a = fmaf(qq.z, kk.z, a);
        a = fmaf(qq.w, kk.w, a);
      }
      sc = a * scale;
      if (cap > 0.f) sc = cap * tanhf(sc / cap);
      if constexpr (ALIBI) sc -= alibi[g] * static_cast<float>(qpos - (start + t));
    }
    s.sS[i] = sc;
  }
  __syncthreads();

  // online softmax update, one warp per query head
  for (int g = warp; g < G; g += NT / 32) {
    float mx = NEG_INF;
    for (int t = lane; t < TK; t += 32) mx = fmaxf(mx, s.sS[g * TK + t]);
    mx = warp_max(mx);
    const float m_old = s.sM[g];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < TK; t += 32) {
      const float p = (start + t < limit) ? expf(s.sS[g * TK + t] - m_new) : 0.f;
      sum += p;
      s.sS[g * TK + t] = round_p<TQ>(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      s.sC[g] = corr;
      s.sL[g] = s.sL[g] * corr + sum;
      s.sM[g] = m_new;
    }
  }
  __syncthreads();

  // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d]
  const int n_out = G * D;
#pragma unroll
  for (int k = 0; k < DEC_MAXO; ++k) {
    const int i = tid + k * NT;
    if (i < n_out) {
      const int g = i / D, d = i - g * D;
      const float* p = s.sS + g * TK;
      float a = acc[k] * s.sC[g];
#pragma unroll 8
      for (int t = 0; t < TK; ++t) a = fmaf(p[t], s.sV[t * LD + d], a);
      acc[k] = a;
    }
  }
}

// o[g][d] = acc / l for the G rows at o (zeros where no position counted).
template <typename TQ, int D>
__device__ __forceinline__ void decode_end(const DecodeSmem& s, const float (&acc)[DEC_MAXO],
                                           TQ* __restrict__ o, int G, int tid) {
#pragma unroll
  for (int k = 0; k < DEC_MAXO; ++k) {
    const int i = tid + k * DEC_NT;
    if (i < G * D) {
      const float l = s.sL[i / D];
      o[i] = from_f<TQ>(l > 0.f ? acc[k] / l : 0.f);
    }
  }
}

}  // namespace rpa
