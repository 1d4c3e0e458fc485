// Ragged paged extend (chunked-prefill) attention over the MLA latent pool,
// for Hopper (sm_90a).
//
// Replaces the MLA v_dim branch of semi_pd_tpu/ops/attention/
// ragged_paged_attention.py _rpa_kernel (called from ragged_paged_attention
// with v_dim): causal attention of the flat new tokens [T, Hq, MLA_DL] of
// every request over its cached prefix plus the new tokens, through the
// page table, driven by the host-built work list (block_seq / block_row /
// block_qofs), with optional logit softcap and sliding window; output
// [T, Hq, MLA_DV]. What it computes and its bound are in rpa_mla.cuh. Two
// builds: rpa_extend_mla at DeepSeek-V2's latent 576 / V 512, and
// rpa_extend_mla_288 (-DRPA_MLA_DL=288 -DRPA_MLA_DV=256) at MiniCPM3's 288 /
// 256, both with the TREE instantiations (NextN's tree verify and tree
// draft steps on a DeepSeek-V2 or a MiniCPM3 target).
// With a speculation tree (spec_anc / win_base: the TPU kernel's
// _spec_tree_mask, which it applies after the MLA branch loads the latent
// rows, so to GQA and MLA alike; SpecTree in rpa_common.cuh) a position
// inside a request's window stays visible to a query row only if its bit
// is set in the row's ancestor mask. Each kernel is a template on TREE,
// and the C entry launches the TREE = true instantiation only for a tree
// (W > 0): the tree-less one is the code without any of it.
//
// Two kernels; the entry point picks one by q's type. Both share the
// work list's EXTEND_QBLK (the build passes it from ops/attention/
// ragged_paged_attention.py::EXTEND_Q_BLOCK): the JAX kernel ran its MLA
// extend with 64-row q-blocks against the 128-row work list and left rows
// 64-127 of each entry unwritten (ROADMAP C1); here the blocks of an entry
// together cover all its rows. A block walks its request's positions up to
// min(kv_len, its last row's position + 1) and writes ONLY the rows of its
// entry it owns; padding entries (block_seq == -1) and blocks past the
// entry's rows write nothing; a row that saw no position writes 0.
//
// bf16 q over bf16 or fp8 (e4m3, e5m2) latent rows, fp8 widened exactly to
// bf16 on its way into the tile: rpa_extend_mla_wgmma_kernel, on Hopper's
//   warpgroup tensor cores (wgmma; rpa_wgmma.cuh). The Hq query heads of a
//   token share its latent row and its causal position, so the packed rows
//   are (token, head) pairs m = r * Hq + g, consecutive in q and in out, and
//   a 64-row tile (wgmma's M) is 4 tokens x 16 heads (DeepSeek-V2-Lite), or
//   1.6 tokens of MiniCPM3's 40 (a tile's rows may start and end inside a
//   token; each lane's two rows take their own token's position): MQA as
//   the GQA kernels pack it, with G = Hq. Grid (ceil(EXTEND_QBLK * Hq /
//   64), entries), one block of two warpgroups per 64 rows, one block per
//   SM. Per tile of MLA_WG_TK = 48 latent positions, staged once by
//   cp.async into a 128-byte swizzled tile and read as both K and V (V is
//   the row's first MLA_DV values, as the TPU kernel reads k2[:, 0:v_dim]):
//   - S = Q K^T over the MLA_DL dims, split between the warpgroups: each
//     runs MLA_DL / 32 m64n48k16 (18 at 576, 9 at 288) with Q (swizzled,
//     read K-major from shared memory for the whole walk) and the tile as
//     operands; the two halves cross through shared memory and both
//     warpgroups add them, so both hold the same S (a + b = b + a exactly)
//     and run the same softmax on it: no P, no rescale factor and no row
//     max has to cross between them;
//   - O += P V for half of V's columns each (256 at 512: a 64 x 256 float32
//     accumulator is 128 registers a thread, where all 512 columns would
//     need 256; 128 at 256, 64 registers): P kept float32 as its bf16 parts
//     hi + lo (split_bf16), as the TPU's MLA branch keeps P in float32
//     (-DRPA_P_F32), in two m64n256k16 (m64n128k16 at 256) per k-step of
//     16 positions, straight from the S accumulators as the register A; V
//     read MN-major through the transpose bit.
//   The 288-wide row is 4.5 of the swizzle's 64-element column blocks.
//   Its Q and latent tiles are laid out in MLA_WG_CB = 5 whole column
//   blocks, a row staged 320 wide: the fifth block's first four chunks hold
//   elements 256-287 and its last four, never written, are never read (S's
//   k-steps 16 and 17 read the block's 32-byte steps 0 and 1, each within
//   the atom; V's 256 columns are blocks 0-3). So the descriptors, the
//   swizzle and the wgmma forms are the 576 build's, the second
//   warpgroup's k-steps (9-17) start mid-atom as every k-step but the
//   first of an atom does, and no 64-byte-swizzled tail is needed.
//   Shared memory at 576: Q 72 KB, two stages of 54 KB, the S halves 24
//   KB: 205 KB. Two 64-position stages (72 KB each) with Q do not fit
//   beside the S halves (or P's hi and lo); three 32-position stages
//   would, but a 32-position S gives each k-step half the work per byte
//   that wgmma reads from shared memory. At 288: Q 40 KB and stages of 30
//   KB (36 and 27 KB without the fifth block's unused half), the S halves
//   24 KB: 125 KB, still one block an SM. Bound: operations (rpa_mla.cuh);
//   the hi + lo product makes the tensor-core work 3200 rather than 2176
//   operations per (row, position) at 576, 1600 rather than 1088 at 288.
//
// float32 q: rpa_extend_mla_kernel, on the CUDA cores (TF32 would not be the
//   float32 dot the float32 pair computes). One block per (work-list entry,
//   query head, sub-tile of MLA_EXT_NR rows of the entry); MLA_TPR threads
//   (16 at 576, 8 at 288) share two consecutive rows, so each latent value
//   read from shared memory feeds both (the shared design is rpa_mla.cuh's).
#include <type_traits>

#include "rpa_mla.cuh"
#include "rpa_wgmma.cuh"

#ifndef EXTEND_QBLK
#error "EXTEND_QBLK must be defined by the build (EXTEND_Q_BLOCK)"
#endif

namespace rpa {

constexpr int MLA_EXT_NR = 32;   // query rows per block
constexpr int MLA_EXT_RPT = 2;   // rows per thread
constexpr int MLA_EXT_TPR = MLA_TPR;  // threads per row (group of rows)
constexpr int MLA_EXT_NT = MLA_EXT_NR / MLA_EXT_RPT * MLA_EXT_TPR;
static_assert(EXTEND_QBLK % MLA_EXT_NR == 0, "a work-list entry splits into whole sub-tiles");

template <typename TQ, typename TKV, bool TREE>
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
                      int Hq, int maxP, int page_size, float scale, float cap, int window,
                      const int* __restrict__ win_base,       // [B], read with TREE
                      const SpecTree tree) {
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
  mla_attend<TQ, TKV, MLA_EXT_TPR, MLA_EXT_RPT, MLA_EXT_NT, TREE>(
      q + (t * Hq + hq) * MLA_DL, (int64_t)Hq * MLA_DL, out + (t * Hq + hq) * MLA_DV,
      (int64_t)Hq * MLA_DV, min(max(rows - row, 0), MLA_EXT_RPT), q_abs_lo + row, 1, lat,
      page_table + (int64_t)b * maxP, page_size, lo, limit, scale, cap, window, sK, tid,
      &tree, TREE ? win_base[b] : 0);
}

template <typename TQ, typename TKV, bool TREE>
static int launch_extend_mla(const void* q, const void* lat, const void* pt,
                             const void* kv_lens, const void* q_lens, const void* q_start,
                             const void* block_seq, const void* block_row,
                             const void* block_qofs, void* out, int NQB, int Hq, int maxP,
                             int page_size, float scale, float cap, int window,
                             const void* win_base, const SpecTree& tree, cudaStream_t stream) {
  const dim3 grid(NQB, Hq, EXTEND_QBLK / MLA_EXT_NR);
  rpa_extend_mla_kernel<TQ, TKV, TREE><<<grid, MLA_EXT_NT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(lat), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<TQ*>(out), Hq, maxP, page_size, scale, cap, window,
      static_cast<const int*>(win_base), tree);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The warpgroup kernel (bf16 q over bf16 or fp8 latent rows), P kept
// float32 as hi + lo. rpa_wgmma.cuh has the layout, the descriptors and the
// wgmma forms.

constexpr int MLA_WG_ROWS = 64;            // packed (token, head) rows per block: wgmma's M
constexpr int MLA_WG_TK = 48;              // latent positions per tile
constexpr int MLA_WG_NT = 256;             // two warpgroups
constexpr int MLA_WG_KS = MLA_DL / 32;     // S k-steps per warpgroup: half of the dims each
constexpr int MLA_WG_DV = MLA_DV / 2;      // V columns (O's) per warpgroup
constexpr int MLA_WG_CB = (MLA_DL + 63) / 64;        // 64-element column blocks of a row
constexpr int MLA_WG_Q = MLA_WG_ROWS * MLA_WG_CB * 128;   // bytes of the Q tile (swizzled)
constexpr int MLA_WG_TILE = MLA_WG_TK * MLA_WG_CB * 128;  // bytes of a latent tile (swizzled)
constexpr int MLA_WG_X = MLA_WG_NT * MLA_WG_TK / 2 * 4;  // S halves exchanged, float32
constexpr int MLA_WG_SMEM = MLA_WG_Q + 2 * MLA_WG_TILE + MLA_WG_X + 1024;
constexpr int MLA_WG_OLD = MLA_DV + 8;    // row stride of the O staging (in the Q tile)
static_assert(MLA_WG_ROWS * MLA_WG_OLD * 2 <= MLA_WG_Q, "O staging");
static_assert(MLA_WG_Q % 1024 == 0 && MLA_WG_TILE % 1024 == 0, "swizzle atoms");
static_assert(MLA_DL % 32 == 0 && MLA_WG_DV % 64 == 0 && (MLA_WG_DV == 256 || MLA_WG_DV == 128),
              "two warpgroups' halves of S's k-steps; wgmma's N for O (its mma_rs forms)");
static_assert(MLA_WG_SMEM <= 232448, "a block's shared memory");

// fp8 rows: a raw stage of 48 x 576 = 27,648 bytes does not fit beside the
// two bf16 stages (237,568 bytes of a block's 232,448), so the rows pass
// through registers: a tile is 1728 16-byte vectors, 6.75 for each of the
// 256 threads, so thread tid takes vectors tid + 256 k for k < 7, the
// last round only below 1728 (threads 192-255 idle in it); at 288 864
// vectors, 3.375 a thread, 4 rounds (threads 96-255 idle in the last).
// 16-byte loads are the fewest instructions, and each widens to two whole
// 16-byte chunks of the swizzled stage (wg::widen_fp8); a map that divides
// (4-byte loads, 27 a thread) would take four times the loads and write
// half chunks. Tile t + 1's 28 registers of loads (16 at 288) are issued
// after the barrier that hands tile t to wgmma, in flight during tile t's
// S and softmax, and widened into the free stage before P V, whose hi and
// lo fragments would not fit beside them in the 255 registers a thread
// (the bf16 build takes 230 at 576).
constexpr int MLA_WG_RV = MLA_DL / 16;  // raw 16-byte fp8 vectors a row
constexpr int MLA_WG_NRV = (MLA_WG_TK * MLA_WG_RV + MLA_WG_NT - 1) / MLA_WG_NT;  // a thread's
static_assert(MLA_WG_NRV * MLA_WG_NT >= MLA_WG_TK * MLA_WG_RV &&
                  (MLA_WG_NRV - 1) * MLA_WG_NT < MLA_WG_TK * MLA_WG_RV,
              "the fp8 copy: every vector once, the last round partial");

template <typename TKV, bool TREE>
__global__ void __launch_bounds__(MLA_WG_NT, 1)
rpa_extend_mla_wgmma_kernel(const __nv_bfloat16* __restrict__ q,    // [T, Hq, MLA_DL]
                            const TKV* __restrict__ lat,            // latent rows at slot 0
                            const int* __restrict__ page_table,     // [B, maxP]
                            const int* __restrict__ kv_lens,        // [B]
                            const int* __restrict__ q_lens,         // [B]
                            const int* __restrict__ q_start,        // [B]
                            const int* __restrict__ block_seq,      // [NQB], -1 = padding
                            const int* __restrict__ block_row,      // [NQB]
                            const int* __restrict__ block_qofs,     // [NQB]
                            __nv_bfloat16* __restrict__ out,        // [T, Hq, MLA_DV]
                            int Hq, int maxP, int page_size, float scale, float cap,
                            int window,
                            const int* __restrict__ win_base,       // [B], read with TREE
                            const SpecTree tree) {
  using bf16 = __nv_bfloat16;
  constexpr bool WIDEN = sizeof(TKV) == 1;  // fp8 rows, widened through registers
  static_assert(WIDEN || std::is_same<TKV, bf16>::value, "bf16 or fp8 latent rows");
  constexpr int TK = MLA_WG_TK, QV = MLA_DL / 8, OV = MLA_DV / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  // entries in reverse launch order: a request's later entries walk more
  // positions, and starting them first leaves the short walks to the last,
  // partial wave of blocks
  const int slice = blockIdx.x, i = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, w = tid / 128, wt = tid % 128;  // warpgroup, its thread
  const int warp = wt / 32, lane = tid % 32;                   // warp of the warpgroup
  const int b = block_seq[i];
  if (b < 0) return;  // padding entry: writes nothing
  const int qofs = block_qofs[i];
  const int n_rows = min(q_lens[b] - qofs, EXTEND_QBLK);
  const int m_lo = slice * MLA_WG_ROWS;  // the block's first packed row (token r, head g: r Hq + g)
  if (m_lo / Hq >= n_rows) return;       // none of the entry's rows is here
  const int n_packed = n_rows * Hq;
  const int64_t row0 = (int64_t)block_row[i] * Hq;  // packed rows are consecutive in q and out
  const int q_abs_lo = q_start[b] + qofs;
  const int r_hi = min((m_lo + MLA_WG_ROWS - 1) / Hq, n_rows - 1);
  const int limit = min(min(kv_lens[b], q_abs_lo + r_hi + 1), maxP * page_size);
  const int lo = window > 0 ? max(q_abs_lo + m_lo / Hq - window + 1, 0) : 0;
  const int ntiles = limit > lo ? (limit - lo + TK - 1) / TK : 0;

  unsigned char* sQ = smem;
  unsigned char* tiles = smem + MLA_WG_Q;
  float4* sX = reinterpret_cast<float4*>(tiles + 2 * MLA_WG_TILE);

  // Q of the block's rows -> its swizzled tile (zeros past the entry's rows)
  for (int v = tid; v < MLA_WG_ROWS * QV; v += MLA_WG_NT) {
    const int m = v / QV, c = v % QV;
    const bool ok = m_lo + m < n_packed;
    cp_async16_zfill(sQ + wg::sw128(MLA_WG_ROWS, m, c),
                     ok ? q + (row0 + m_lo + m) * MLA_DL + c * 8 : q, ok);
  }
  cp_async_commit();

  // bf16 rows: tile t -> stage s at its swizzled offsets by cp.async;
  // neighbouring threads copy neighbouring 16 bytes of a latent row;
  // nothing at or past the walk's end is read (zeros); one group committed
  // either way. fp8 rows: fetch(t) loads the thread's raw vectors of tile t
  // into registers (zeros past the walk's end), put(s) widens them into
  // stage s.
  const int* pt_row = page_table + (int64_t)b * maxP;
  const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  auto issue = [&](int t, int s) {
    if constexpr (!WIDEN) {
      if (t < ntiles) {
        unsigned char* st = tiles + s * MLA_WG_TILE;
        for (int v = tid; v < TK * QV; v += MLA_WG_NT) {
          const int p = v / QV, c = v % QV, pos = lo + t * TK + p;
          const bool ok = pos < limit;
          const TKV* src =
              ok ? lat + wg::slot_of(pt_row, pos, page_size, pshift) * MLA_DL + c * 8 : lat;
          cp_async16_zfill(st + wg::sw128(TK, p, c), src, ok);
        }
      }
      cp_async_commit();
    }
  };
  uint4 raw[WIDEN ? MLA_WG_NRV : 1];
  auto fetch = [&](int t) {
    if constexpr (WIDEN) {
#pragma unroll
      for (int k = 0; k < MLA_WG_NRV; ++k) {
        const int v = tid + k * MLA_WG_NT;
        const int p = v / MLA_WG_RV, c = v - p * MLA_WG_RV, pos = lo + t * TK + p;
        raw[k] = make_uint4(0u, 0u, 0u, 0u);
        if (v < TK * MLA_WG_RV && pos < limit)
          raw[k] = __ldg(reinterpret_cast<const uint4*>(
              lat + wg::slot_of(pt_row, pos, page_size, pshift) * MLA_DL + c * 16));
      }
    }
  };
  auto put = [&](int s) {
    if constexpr (WIDEN) {
      unsigned char* st = tiles + s * MLA_WG_TILE;
#pragma unroll
      for (int k = 0; k < MLA_WG_NRV; ++k) {
        const int v = tid + k * MLA_WG_NT;
        const int p = v / MLA_WG_RV, c = v - p * MLA_WG_RV;
        if (v < TK * MLA_WG_RV) {
          uint4 x, y;
          wg::widen_fp8<TKV>(raw[k], x, y);
          *reinterpret_cast<uint4*>(st + wg::sw128(TK, p, 2 * c)) = x;
          *reinterpret_cast<uint4*>(st + wg::sw128(TK, p, 2 * c + 1)) = y;
        }
      }
    }
  };
  if constexpr (WIDEN) {
    fetch(0);
    put(0);
  } else {
    issue(0, 0);
  }

  // this lane's two packed rows (accumulator rows gid and gid + 8 of its warp)
  const int gid = lane >> 2, tig = lane & 3;
  int qpos[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) qpos[j] = q_abs_lo + (m_lo + warp * 16 + gid + 8 * j) / Hq;
  const int wq_lo = q_abs_lo + (m_lo + warp * 16) / Hq;
  const int wq_hi = q_abs_lo + min((m_lo + warp * 16 + 15) / Hq, n_rows - 1);
  // the tree: its window's start and this lane's two rows' ancestor masks
  // (packed row m = r Hq + g takes token r's)
  const int wb = TREE ? win_base[b] : 0;
  unsigned sbits[2] = {0u, 0u};
  if constexpr (TREE) {
#pragma unroll
    for (int j = 0; j < 2; ++j) sbits[j] = spec_bits(tree, qpos[j] - wb);
  }
  const bool capped = cap > 0.f;
  const float c = capped ? LOG2E : scale * LOG2E;

  float sc[TK / 2], o[MLA_WG_DV / 2];  // S and O accumulators (rpa_wgmma.cuh's fragment)
#pragma unroll
  for (int e = 0; e < TK / 2; ++e) sc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < MLA_WG_DV / 2; ++e) o[e] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};
  const uint32_t s_q = static_cast<uint32_t>(__cvta_generic_to_shared(sQ));
  const uint32_t s_tiles = static_cast<uint32_t>(__cvta_generic_to_shared(tiles));

  // Per tile: one barrier hands tile t (and, first, Q) to wgmma and frees
  // tile t - 1's stage for tile t + 1; warpgroup w computes S over its half
  // of the MLA_DL dims; the halves cross through shared memory (each thread
  // reads the other warpgroup's same fragment: one barrier) and both
  // warpgroups add them (a + b = b + a exactly, so both hold the same S),
  // run the same softmax, and each computes O for its MLA_WG_DV of V's columns.
  for (int t = 0, s = 0; t < ntiles; ++t, s ^= 1) {
    const int st = lo + t * TK;
    cp_async_wait<0>();  // tile t has landed (this thread's copies)
    wg::fence_proxy_async();
    __syncthreads();
    if constexpr (WIDEN) {
      if (t + 1 < ntiles) fetch(t + 1);
    } else {
      issue(t + 1, s ^ 1);
    }
    const uint32_t sK = s_tiles + s * MLA_WG_TILE;
    wg::fence();
#pragma unroll
    for (int k = 0; k < MLA_WG_KS; ++k) {
      const int ks = w * MLA_WG_KS + k;
      wg::mma_ss<0>(sc, wg::desc_k(s_q, MLA_WG_ROWS, ks), wg::desc_k(sK, TK, ks), k);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
      sX[(w * (TK / 8) + j) * 128 + wt] =
          make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float4 x = sX[((w ^ 1) * (TK / 8) + j) * 128 + wt];
      sc[4 * j] += x.x;
      sc[4 * j + 1] += x.y;
      sc[4 * j + 2] += x.z;
      sc[4 * j + 3] += x.w;
    }
    // both warpgroups decide alike (the same rows, the same tile), so both
    // hold the same S; a tile that meets the tree's window takes the pass
    const bool masked = st + TK > limit || st + TK - 1 > wq_lo ||
                        (window > 0 && st <= wq_hi - window) ||
                        (TREE && st < wb + tree.w && st + TK > wb);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const int rr = (e >> 1) & 1;
      float v = sc[e];
      if (capped) v = cap * tanhf(v * scale / cap);
      if (masked) {
        const int pos = st + 8 * (e >> 2) + 2 * tig + (e & 1);
        const bool ok = pos < limit && pos <= qpos[rr] &&
                        (window <= 0 || pos > qpos[rr] - window) &&
                        (!TREE || spec_ok(tree, wb, sbits[rr], pos));
        v = ok ? v : NEG_INF;
      }
      sc[e] = v;
      mx[rr] = fmaxf(mx[rr], v);
    }
    float corr[2], mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(mrow[rr], mx[rr]);
      corr[rr] = fast_exp2((mrow[rr] - m_new) * c);
      mrow[rr] = m_new;
      mc[rr] = (m_new == NEG_INF ? 0.f : m_new) * c;  // nothing valid yet: p = 0
    }
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const float p = fast_exp2(fmaf(sc[e], c, -mc[(e >> 1) & 1]));
      psum[(e >> 1) & 1] += p;
      sc[e] = p;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) lrow[rr] = lrow[rr] * corr[rr] + psum[rr];
#pragma unroll
    for (int e = 0; e < MLA_WG_DV / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    // fp8: tile t + 1 into the stage tile t - 1 left (every warpgroup was
    // done with it at this iteration's barrier), before P's hi and lo take
    // registers; the next barrier, after the async-proxy fence, hands it to
    // wgmma
    if constexpr (WIDEN) {
      if (t + 1 < ntiles) put(s ^ 1);
    }
    // O += P V with P kept float32 as its bf16 parts hi + lo (two products
    // against the same V), P straight from the S accumulators; V = the same
    // tile's columns MLA_WG_DV w .. MLA_WG_DV (w + 1) - 1, read MN-major
    // (the transpose bit)
    uint32_t pa[TK / 16][4], pl[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
        split_bf16(sc[x], sc[x + 1], pa[kk][e], pl[kk][e]);
      }
    const uint32_t sV = sK + w * (MLA_WG_DV / 64) * TK * 128;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wg::mma_rs<1>(o, pa[kk], wg::desc_mn(sV, TK, kk), 1);
      wg::mma_rs<1>(o, pl[kk], wg::desc_mn(sV, TK, kk), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wg::fence_regs(pa[kk]);
      wg::fence_regs(pl[kk]);
    }
  }

  // Epilogue: O / l (0 for a row that saw no position) staged in the Q
  // tile's space, then written as 16-byte vectors to the entry's rows
  cp_async_wait<0>();
  __syncthreads();  // Q and every tile are idle
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lrow[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rr] = l > 0.f ? 1.f / l : 0.f;
  }
  bf16* sO = reinterpret_cast<bf16*>(sQ) + warp * 16 * MLA_WG_OLD + w * MLA_WG_DV;
#pragma unroll
  for (int d = 0; d < MLA_WG_DV / 8; ++d) {
    *reinterpret_cast<uint32_t*>(sO + gid * MLA_WG_OLD + d * 8 + 2 * tig) =
        pack_bf16(o[4 * d] * inv[0], o[4 * d + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (gid + 8) * MLA_WG_OLD + d * 8 + 2 * tig) =
        pack_bf16(o[4 * d + 2] * inv[1], o[4 * d + 3] * inv[1]);
  }
  __syncthreads();
  const bf16* sOut = reinterpret_cast<const bf16*>(sQ);
  for (int v = tid; v < MLA_WG_ROWS * OV; v += MLA_WG_NT) {
    const int m = v / OV, cc = v % OV;
    if (m_lo + m < n_packed)
      *reinterpret_cast<uint4*>(out + (row0 + m_lo + m) * MLA_DV + cc * 8) =
          *reinterpret_cast<const uint4*>(sOut + m * MLA_WG_OLD + cc * 8);
  }
}

template <typename TKV, bool TREE>
static int launch_extend_mla_wgmma(const void* q, const void* lat, const void* pt,
                                   const void* kv_lens, const void* q_lens, const void* q_start,
                                   const void* block_seq, const void* block_row,
                                   const void* block_qofs, void* out, int NQB, int Hq, int maxP,
                                   int page_size, float scale, float cap, int window,
                                   const void* win_base, const SpecTree& tree,
                                   cudaStream_t stream) {
  const cudaError_t attr =
      cudaFuncSetAttribute(rpa_extend_mla_wgmma_kernel<TKV, TREE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MLA_WG_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((EXTEND_QBLK * Hq + MLA_WG_ROWS - 1) / MLA_WG_ROWS, NQB);
  rpa_extend_mla_wgmma_kernel<TKV, TREE><<<grid, MLA_WG_NT, MLA_WG_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(lat),
      static_cast<const int*>(pt), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<const int*>(q_start),
      static_cast<const int*>(block_seq), static_cast<const int*>(block_row),
      static_cast<const int*>(block_qofs), static_cast<__nv_bfloat16*>(out), Hq, maxP,
      page_size, scale, cap, window, static_cast<const int*>(win_base), tree);
  return (int)cudaGetLastError();
}

// bf16 q over bf16 or fp8 latent rows on the warpgroups; float32 on the
// CUDA cores (TF32 would not be the float32 dot the float32 pair computes).
// Each in its TREE instantiation only with a tree.
template <typename TQ, typename TKV>
static int launch(const void* q, const void* lat, const void* pt, const void* kv_lens,
                  const void* q_lens, const void* q_start, const void* block_seq,
                  const void* block_row, const void* block_qofs, void* out, int NQB, int Hq,
                  int maxP, int page_size, float scale, float cap, int window,
                  const void* win_base, const SpecTree& tree, cudaStream_t stream) {
#define RPA_MLA_ARGS                                                                          \
  q, lat, pt, kv_lens, q_lens, q_start, block_seq, block_row, block_qofs, out, NQB, Hq, maxP, \
      page_size, scale, cap, window, win_base, tree, stream
  if (tree.w > 0) {
    if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
      return launch_extend_mla_wgmma<TKV, true>(RPA_MLA_ARGS);
    else
      return launch_extend_mla<TQ, TKV, true>(RPA_MLA_ARGS);
  }
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return launch_extend_mla_wgmma<TKV, false>(RPA_MLA_ARGS);
  else
    return launch_extend_mla<TQ, TKV, false>(RPA_MLA_ARGS);
#undef RPA_MLA_ARGS
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/ragged_paged_attention.py),
// with the signature of the other extend kernels (rpa_extend.cu): k_pool is
// the layer's latent rows at slot 0 and v_pool must be the same address (V
// is the row's prefix); Hkv 1, D = row_stride = MLA_DL; out is [T, Hq,
// MLA_DV] (the wrapper holds v_dim to MLA_DV). q_type / kv_type: TypeCode.
// `out` must be zero-filled by the caller: rows no entry owns (bucket
// padding) are left untouched. cap <= 0: no softcap; window <= 0: no
// window. spec_w: the speculation tree's node count (0: no tree), spec_anc
// its masks in HOST memory, win_base its window start per request on the
// card. alibi_slopes must be null (MLA takes no ALiBi). Returns
// cudaError_t; another geometry or type pair, slopes, or a tree of more
// than SPEC_MAX_NODES nodes, is cudaErrorInvalidValue.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                              const void* page_table, const void* kv_lens, const void* q_lens,
                              const void* q_start, const void* block_seq,
                              const void* block_row, const void* block_qofs, void* out,
                              int NQB, int Hq, int Hkv, int D, int row_stride,
                              int maxP, int page_size, float scale, float cap, int window,
                              int q_type, int kv_type, int spec_w, const void* spec_anc,
                              const void* win_base, const void* alibi_slopes,
                              void* stream) {
  using namespace rpa;
  if (NQB == 0) return 0;
  if (Hq <= 0 || Hkv != 1 || D != MLA_DL || row_stride != MLA_DL ||
      v_pool != k_pool || alibi_slopes != nullptr)
    return (int)cudaErrorInvalidValue;
  SpecTree tree;
  if (!spec_tree_from(spec_w, spec_anc, win_base, tree)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_EXT(QC, TQ, KC, TKV)                                                           \
  if (q_type == QC && kv_type == KC)                                                       \
    return launch<TQ, TKV>(q, k_pool, page_table, kv_lens, q_lens, q_start,     \
                                      block_seq, block_row, block_qofs, out, NQB, Hq, maxP, \
                                      page_size, scale, cap, window, win_base, tree, s);
  RPA_FOR_EACH_PAIR(RPA_EXT)
#undef RPA_EXT
  return (int)cudaErrorInvalidValue;
}
