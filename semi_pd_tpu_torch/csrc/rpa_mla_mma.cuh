// The block tile of the tensor-core MLA decodes (bf16 q over bf16 or fp8
// latent rows):
// rpa_decode_mla.cu's rpa_decode_mla_mma_kernel (the packed decode, one
// block per chunk of a request) and rpa_stream.cu's
// rpa_stream_mla_mma_kernel (the streaming decode, each block an equal
// share of the batch's chunks). What they compute is rpa_mla.cuh's: the
// query heads of a request against its latent rows, scores over all
// MLA_DL dims, V the rows' first MLA_DV, P kept in float32 (-DRPA_P_F32,
// as the TPU kernels' MLA branches upcast to float32). Built at
// DeepSeek-V2's 576 / 512 and MiniCPM3's 288 / 256 (-DRPA_MLA_DL,
// -DRPA_MLA_DV); every constant below follows from the two widths.
//
// Both walk a request's positions in the same fixed chunks of MLA_MMA_CHUNK
// = 256 (16 tiles), whatever the batch: a chunk's (m c, l, O) is computed
// by one block, tile by tile from the chunk's start, and the chunks of a
// request are merged in chunk order by rpa_mla_combine_kernel (a request of
// one chunk is written by its block: O / l, which the merge of one partial
// reproduces exactly). So a request's output does not depend on the batch
// around it, and the two decodes give the same bits: the CUDA-core kernels
// they replace walked each request alone, and DeepSeek-V2-Lite's greedy
// serves, packed or streamed, colocated or semi-PD, gave the same tokens;
// a split or a share cut anywhere else (a plan that fills the card at
// each batch size) made them differ at near ties (17 of 32 requests the
// same, packed against stream, on an H100).
//
// Why a block and not the GQA decodes' warp tile (rpa_decode_mma.cuh): one
// warp holding the m16 tile's Q as A fragments and its float32 O would need
// 16 x 576 bf16 (144 registers a thread) and 16 x 512 float32 (256), more
// than a thread has. So the four warps of a block share each latent tile,
// which they stage and read once, and both cuts are exact:
//   - S = Q K^T: the row's MLA_DL / 16 k-steps of mma.sync m16n8k16 are cut
//     in order over the warps, warp w taking [mla_ks0(w), mla_ks0(w + 1)):
//     9 each at 576 (dims [144 w, 144 w + 144), 36 registers of Q); at 288
//     the 18 k-steps do not divide by four, and the warps take 4, 5, 4 and
//     5 (at most MLA_MMA_KS = 5, 20 registers; a warp skips its fifth step
//     by a warp-uniform test that the 576 build does not compile). The
//     four partials cross through shared memory, a float4 per lane and n8
//     tile, and every warp adds them in warp order 0, 1, 2, 3
//     (mla_combine_pv), so all four hold the same S, bit for bit, and run
//     the same float32 online softmax on it: no max, sum or P crosses
//     between them.
//   - O += P V: warp w owns V's columns [DW w, DW w + DW), DW = MLA_DV / 4
//     (128 at 512, 64 at 256: 16 or 8 n8 blocks, 64 or 32 registers), with
//     P as its two bf16 parts hi + lo (split_bf16: P kept float32 to
//     2^-18), the running sum adding the unrounded p. The softmax and P V
//     are the GQA warp tile's own (mma_softmax_pv, with D the warp's
//     columns and the latent row's stride).
// The query heads of a block are the rows of the m16 tile: DeepSeek-V2-
// Lite's 16 fill it. More heads form HG = ceil(Hq / 16) groups (the grid's
// second dimension, where the GQA decodes put the KV heads), group h the
// heads [16 h, min(16 h + 16, Hq)): every group but the last full, the
// last one's missing rows zeros that are written nowhere. MiniCPM3's 40
// heads make 16 / 16 / 8. Each group reads the latent rows again (the
// groups of one chunk run close together in the grid, so the second and
// third reads can hit L2); equal groups (4 x 10) would read them 4 times
// and run 4 blocks of mma.sync where the uneven cut runs 3, so the cut
// keeps whole m16 tiles and leaves the waste to the last.
//
// The tile: MLA_MMA_TK = 16 positions of 2 MLA_DL bytes (18 KB at 576, 9
// KB at 288), copied by cp.async (MLA_MMA_NV 16-byte vectors a thread: 9
// at 576; 4.5 at 288, so 5 rounds with the last one's upper half idle;
// fp8 rows, half the bytes, through registers and widened, MlaCopy) into
// bf16 rows padded to MLA_MMA_LD = MLA_DL + 8 elements: 1168 bytes at 576,
// 16 mod 128, and 592 at 288, 80 mod 128, so in both the 8 rows of an
// ldmatrix fall on 8 different 16-byte groups of banks (no conflicts). A
// ring of MLA_MMA_NST = 4 stages with one block barrier per tile: tile i's
// partial S, each thread's wait for its copies of tile i + 1, the barrier
// (tile i's partials complete, tile i + 1 visible, every warp done with
// tile i - 1), the refill of tile i - 1's stage with tile i + 3, then tile
// i's sum, softmax and P V. fp8 rows take the same ring: after the barrier
// each thread first widens the tile i + 2 it loaded a tile earlier into
// its stage (free since the barrier of tile i - 1; visible at the barrier
// of tile i + 1), then loads tile i + 3 into its registers (MlaCopy). The
// partials alternate between two buffers, so the barrier of tile i + 1 also
// frees tile i's. Two tiles are in flight (bf16 rows; one with fp8 rows)
// while a block computes. A block holds 82,944 bytes of shared memory at
// 576: two blocks an SM (three would need 251,904 of the 233,472 bytes),
// so an SM has about 112 KB of latent rows requested or landed ahead of
// its mma; at 288 46,080 bytes, four blocks an SM (MLA_MMA_BLOCKS_PER_SM:
// as many as the shared memory holds), which caps a thread at 128
// registers. 16 positions is one k-step of P V; a 32-position tile would
// make a stage 37 KB at 576 and leave one block an SM at three stages. On
// an H100 (mla_decode_plans.py) the packed decode at b64 / kv1024 took
// 0.0465 ms with these constants at 576, 0.0545 with chunks of 128 and
// 0.0648 with 512, 0.0467 with 5 stages and 0.0488 with 3 stages at three
// blocks an SM.
//
// Bound on this card: bytes. A position costs 2 Hq (MLA_DL + MLA_DV)
// operations on 2 MLA_DL bytes: 34,816 on 1,152 at 576 with Hq 16, 30 a
// byte (44 with P as hi + lo; 60 and 88 on the 576 bytes of an fp8 row),
// and 43,520 on 576 at 288 with Hq 40, 76 a byte (the tensor cores run 48
// rows of m16 tiles for the 40 heads: 91 a byte, 121 with P as hi + lo),
// all below the ~295 where the bf16 tensor cores would bind, and above the
// ~20 the float32 CUDA cores sustain (the CUDA-core kernels of
// rpa_mla.cuh, which the float32 pairs keep). Per tile and warp at 576:
// 18 mma for S, 32 for P V (hi and lo), 9 ldmatrix of K and 8 of V; at 288
// 8 or 10 for S, 16 for P V, 4 or 5 ldmatrix of K and 4 of V.
#pragma once

#include <type_traits>

#include "rpa_decode_mma.cuh"
#include "rpa_mla.cuh"

namespace rpa {

// The tile's constants; ops/attention/rpa_packed.py (DECODE_SPLIT) and
// rpa_stream.py (STREAM_TILE) state the ones the wrappers plan with
// (MLA_MMA_CHUNK, MLA_MMA_BLOCKS_PER_SM), and a CPU test
// (tests/test_torch_mla_decode_split.py) evaluates these lines to hold them
// equal and to check the cuts, the copy map, the banks and the budget.
constexpr int MLA_MMA_NT = 128;  // threads per block
constexpr int MLA_MMA_WARPS = MLA_MMA_NT / 32;
constexpr int MLA_MMA_ROWS = 16;  // query heads per block: the m16 tile's rows
constexpr int MLA_MMA_TK = 16;    // latent positions per tile
constexpr int MLA_MMA_NST = 4;    // ring stages
constexpr int MLA_MMA_LD = MLA_DL + 8;                   // bf16 row stride of a stage
constexpr int MLA_MMA_KSTEPS = MLA_DL / 16;              // k-steps of S over a row
constexpr int MLA_MMA_KS = (MLA_MMA_KSTEPS + MLA_MMA_WARPS - 1) / MLA_MMA_WARPS;  // a warp's most
constexpr int MLA_MMA_DW = MLA_DV / MLA_MMA_WARPS;       // V columns per warp
constexpr int MLA_MMA_VPR = MLA_DL * 2 / 16;             // 16-byte vectors per latent row
constexpr int MLA_MMA_NVEC = MLA_MMA_TK * MLA_MMA_VPR;   // 16-byte vectors of a tile
constexpr int MLA_MMA_NV = (MLA_MMA_NVEC + MLA_MMA_NT - 1) / MLA_MMA_NT;  // a thread's copies
constexpr int MLA_MMA_STAGE = MLA_MMA_TK * MLA_MMA_LD * 2;          // bytes of a stage
constexpr int MLA_MMA_XCHG = 2 * MLA_MMA_WARPS * MLA_MMA_TK / 8 * 32 * 16;  // 2 S buffers
constexpr int MLA_MMA_SMEM = MLA_MMA_NST * MLA_MMA_STAGE + MLA_MMA_XCHG;
constexpr int MLA_MMA_BLOCKS_PER_SM = 233472 / (MLA_MMA_SMEM + 1024 + 128);  // blocks an SM holds
constexpr int MLA_MMA_CHUNK = 256;  // positions of a chunk, a block's unit of work
// the warps divide the k-steps of S (576) or not (288); the threads a
// tile's vectors (576) or not (288): each uneven cut compiles a
// warp-uniform test the even one does not
constexpr bool MLA_MMA_EVEN_S = MLA_MMA_KSTEPS % MLA_MMA_WARPS == 0;
constexpr bool MLA_MMA_EVEN_COPY = MLA_MMA_NVEC % MLA_MMA_NT == 0;

static_assert(MLA_DL % 16 == 0 && MLA_MMA_DW * MLA_MMA_WARPS == MLA_DV && MLA_MMA_DW % 16 == 0,
              "the warps' cuts of S's dims and V's columns");
static_assert(MLA_MMA_NV * MLA_MMA_NT >= MLA_MMA_NVEC &&
                  (MLA_MMA_NV - 1) * MLA_MMA_NT < MLA_MMA_NVEC,
              "the copy of a tile: every vector once, the last round whole or partial");
static_assert(MLA_MMA_TK == 16 && MLA_MMA_NST >= 3, "one k-step of P V; a tile ahead");
static_assert(MLA_MMA_CHUNK % MLA_MMA_TK == 0, "whole tiles a chunk");
static_assert(MLA_MMA_BLOCKS_PER_SM * (MLA_MMA_SMEM + 1024 + 128) <= 233472 &&
                  (MLA_MMA_BLOCKS_PER_SM + 1) * (MLA_MMA_SMEM + 1024) > 233472,
              "MLA_MMA_BLOCKS_PER_SM");

using MlaState = MmaState<MLA_MMA_DW>;  // a warp's O columns and its rows' (m, l)

// Warp w's k-steps of S are [mla_ks0(w), mla_ks0(w + 1)): MLA_MMA_KS each
// where the warps divide the row, else MLA_MMA_KS or one fewer.
__device__ __forceinline__ int mla_ks0(int warp) {
  return MLA_MMA_EVEN_S ? warp * MLA_MMA_KS : warp * MLA_MMA_KSTEPS / MLA_MMA_WARPS;
}
// Whether this warp has a k-step ks (< MLA_MMA_KS) of its own.
__device__ __forceinline__ bool mla_has_ks(int warp, int ks) {
  return MLA_MMA_EVEN_S || ks < mla_ks0(warp + 1) - mla_ks0(warp);
}
// Whether vector v of a tile (v < MLA_MMA_NV MLA_MMA_NT) exists.
__device__ __forceinline__ bool mla_has_vec(int v) {
  return MLA_MMA_EVEN_COPY || v < MLA_MMA_NVEC;
}

// This warp's A fragments of Q for its dims: row g of the m16 tile is query
// head g of qb (G rows of MLA_DL), zero past G and past the warp's k-steps.
__device__ __forceinline__ void mla_load_q(uint32_t (&qa)[MLA_MMA_KS][4],
                                           const __nv_bfloat16* __restrict__ qb, int G, int warp,
                                           int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < MLA_MMA_KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e & 1);
      const int c = (mla_ks0(warp) + ks) * 16 + 8 * (e >> 1) + 2 * tig;
      qa[ks][e] = r < G && mla_has_ks(warp, ks)
                      ? *reinterpret_cast<const uint32_t*>(qb + r * MLA_DL + c)
                      : 0u;
    }
}

// A thread's copies of the latent rows of positions [st, st + MLA_MMA_TK)
// into a bf16 stage: vector v = tid + k MLA_MMA_NT of the tile (v <
// MLA_MMA_NVEC) is chunk v % VPR (elements 8 c .. 8 c + 7) of row v / VPR,
// VPR = MLA_MMA_VPR (72 at 576, 36 at 288). Positions outside [lo, hi)
// stage as zeros and are never read. pt_row: the request's row of the
// page table; pshift: log2(page_size), or -1.
//   - bf16 rows (TKV = __nv_bfloat16): issue() copies the 16-byte chunks by
//     cp.async (the caller commits the group and waits for it); land() does
//     nothing.
//   - fp8 rows (e4m3, e5m2): cp.async cannot convert, so the rows pass
//     through registers. In 16-byte vectors a 576-byte row is 36, a tile
//     576, 4.5 a thread: no whole map. In 8-byte vectors it is 72 a row, the
//     bf16 map's count, and vector c widens to exactly the 16-byte bf16
//     chunk c the bf16 map copies: so issue() loads the same map's vectors
//     of 8 bytes (9 a thread at 576, 18 registers; 5 rounds at 288, the
//     last one half idle as the bf16 map's, 10 registers) and land() widens
//     them exactly into the stage issue() was given. The stages stay bf16
//     and the block's shared memory does not grow. A tile's loads are in flight from its
//     issue() to its land() one tile later (cp.async keeps bf16 tiles two
//     tiles in flight).
template <typename TKV>
struct MlaCopy {
  static constexpr bool WIDEN = sizeof(TKV) == 1;
  static_assert(WIDEN || std::is_same<TKV, __nv_bfloat16>::value, "bf16 or fp8 latent rows");
  static_assert(MLA_DL / 8 == MLA_MMA_VPR, "an fp8 row's 8-byte vectors are its bf16 chunks");
  uint2 raw[WIDEN ? MLA_MMA_NV : 1];
  __nv_bfloat16* held = nullptr;  // fp8: the stage the loaded tile goes to

  __device__ __forceinline__ void issue(__nv_bfloat16* stage, const TKV* __restrict__ lat,
                                        const int* __restrict__ pt_row, int page_size,
                                        int pshift, int st, int lo, int hi, int tid) {
#pragma unroll
    for (int k = 0; k < MLA_MMA_NV; ++k) {
      const int v = tid + k * MLA_MMA_NT;
      if (!mla_has_vec(v)) continue;
      const int row = v / MLA_MMA_VPR, chunk = v - row * MLA_MMA_VPR;
      const int pos = st + row;
      const bool ok = pos >= lo && pos < hi;
      const TKV* src = lat;
      if (ok) {
        const int page = pshift >= 0 ? pos >> pshift : pos / page_size;
        src = lat + ((int64_t)pt_row[page] * page_size + (pos - page * page_size)) * MLA_DL +
              chunk * 8;
      }
      if constexpr (WIDEN)
        raw[k] = ok ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
      else
        cp_async16_zfill(stage + row * MLA_MMA_LD + chunk * 8, src, ok);
    }
    if constexpr (WIDEN) held = stage;
  }

  // fp8: the tile of the last issue() into its stage (nothing if none is
  // held). The stage must be free and the block barrier that publishes it
  // must follow.
  __device__ __forceinline__ void land(int tid) {
    if constexpr (WIDEN) {
      if (held == nullptr) return;
#pragma unroll
      for (int k = 0; k < MLA_MMA_NV; ++k) {
        const int v = tid + k * MLA_MMA_NT;
        if (!mla_has_vec(v)) continue;
        const int row = v / MLA_MMA_VPR, chunk = v - row * MLA_MMA_VPR;
        *reinterpret_cast<uint4*>(held + row * MLA_MMA_LD + chunk * 8) =
            widen8_bf16<TKV>(raw[k]);
      }
      held = nullptr;
    }
  }
};

// This warp's partial S of the tile at shared address sK, over its k-steps,
// into its slots of xs (one float4 per lane and n8 tile of positions).
__device__ __forceinline__ void mla_partial(float4* xs, const uint32_t (&qa)[MLA_MMA_KS][4],
                                            uint32_t sK, uint32_t k_lane, int warp, int lane) {
  float sc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < MLA_MMA_KS; ++ks) {
    if (!mla_has_ks(warp, ks)) continue;
    uint32_t kf[4];
    ldmatrix_x4(kf, sK + k_lane + (mla_ks0(warp) + ks) * 16 * 2);
    mma_bf16_16816(sc[0], qa[ks], kf[0], kf[1]);
    mma_bf16_16816(sc[1], qa[ks], kf[2], kf[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    xs[(warp * 2 + j) * 32 + lane] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
}

// After the block barrier: S as the four warps' partials in xs added in
// warp order (the same floats in every warp), then the softmax and O += P V
// on this warp's columns of the tile (sV: the tile's shared address plus
// the warp's first column), for positions st .. st + 15 within [lo, hi).
__device__ __forceinline__ void mla_combine_pv(MlaState& s, const float4* xs, uint32_t sV,
                                               uint32_t v_lane, int st, int lo, int hi,
                                               float scale, float cap, bool capped, float c,
                                               int lane) {
  float sc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float4 a = xs[j * 32 + lane];
#pragma unroll
    for (int w = 1; w < MLA_MMA_WARPS; ++w) {
      const float4 b = xs[(w * 2 + j) * 32 + lane];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    sc[j][0] = a.x;
    sc[j][1] = a.y;
    sc[j][2] = a.z;
    sc[j][3] = a.w;
  }
  mma_softmax_pv<MLA_MMA_DW, MLA_MMA_LD, MLA_MMA_TK>(s, sc, sV, v_lane, st, lo, hi, scale, cap,
                                                    capped, c, lane & 3);
}

// The chunks of a request with kv_len n (and a page table of max_len
// positions).
__device__ __forceinline__ int mla_chunks(int n, int max_len) {
  n = min(n, max_len);
  return n > 0 ? (n + MLA_MMA_CHUNK - 1) / MLA_MMA_CHUNK : 0;
}

// This warp's columns of O / l for the G rows at out ([.][MLA_DV] bf16; 0
// where l is 0), divided as rpa_mla_combine_kernel divides.
__device__ __forceinline__ void mla_write_out(const MlaState& s, __nv_bfloat16* __restrict__ out,
                                              int G, int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = mma_row_sum(s, rr);
    const int r = gid + 8 * rr;
    if (r < G) {
#pragma unroll
      for (int d = 0; d < MLA_MMA_DW / 8; ++d)
        *reinterpret_cast<uint32_t*>(out + r * MLA_DV + warp * MLA_MMA_DW + d * 8 + 2 * tig) =
            l > 0.f ? pack_bf16(s.o[d][2 * rr] / l, s.o[d][2 * rr + 1] / l) : 0u;
    }
  }
}

// The block's float32 partial of its G rows: this warp's columns of O into
// po ([.][MLA_DV]), and (m c, l) into pml ([.][2]) from warp 0 (every warp
// holds the same).
__device__ __forceinline__ void mla_write_partial(const MlaState& s, float* __restrict__ po,
                                                  float* __restrict__ pml, int G, float c,
                                                  int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = mma_row_sum(s, rr);
    const int r = gid + 8 * rr;
    if (r >= G) continue;
    if (warp == 0 && tig == 0) {
      pml[r * 2] = s.mrow[rr] * c;
      pml[r * 2 + 1] = l;
    }
#pragma unroll
    for (int d = 0; d < MLA_MMA_DW / 8; ++d)
      *reinterpret_cast<float2*>(po + r * MLA_DV + warp * MLA_MMA_DW + d * 8 + 2 * tig) =
          make_float2(s.o[d][2 * rr], s.o[d][2 * rr + 1]);
  }
}

// The merge of a request's chunks: part holds the float32 O [n_chunk, rows,
// MLA_DV] of every chunk, then its (m c, l) [n_chunk, rows, 2], rows = B
// Hq; a thread per output of the B Hq MLA_DV, over the chunks of its
// request in chunk order: m the max of their (m c) over those that saw a
// position (l > 0), then l = sum 2^(m_s - m) l_s and acc = sum 2^(m_s - m)
// O_s (the factor exactly 1 at m_s = m), out = acc / l, 0 where l is 0.
// With ALL false, rows whose request has at most one chunk are left as the
// caller's kernel wrote them (the stream's); the packed decode merges every
// row.
template <bool ALL>
__global__ void __launch_bounds__(256)
rpa_mla_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ kv_lens, int n_chunk, int B, int Hq,
                       int max_len) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t rows = (int64_t)B * Hq;
  if (idx >= rows * MLA_DV) return;
  const int64_t row = idx / MLA_DV;
  const int nc = min(mla_chunks(kv_lens[row / Hq], max_len), n_chunk);
  if (!ALL && nc <= 1) return;
  const float* ml = part + (int64_t)n_chunk * rows * MLA_DV;
  float m = NEG_INF;
  for (int s = 0; s < nc; ++s) {
    const float* x = ml + (s * rows + row) * 2;
    if (x[1] > 0.f) m = fmaxf(m, x[0]);
  }
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nc; ++s) {
    const float* x = ml + (s * rows + row) * 2;
    if (x[1] > 0.f) {
      const float f = x[0] == m ? 1.f : fast_exp2(x[0] - m);
      l = fmaf(x[1], f, l);
      acc = fmaf(part[s * rows * MLA_DV + idx], f, acc);
    }
  }
  out[idx] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

}  // namespace rpa
