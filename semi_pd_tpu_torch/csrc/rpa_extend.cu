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
//     pool), which computes in float32 throughout, P included: its bf16-q
//     pairs run the tensor-core kernel with P split into two bf16 parts.
// Causal attention of the flat new tokens [T, Hq, D] of every request over
// its cached prefix plus the new tokens, through the page table, driven by
// the host-built work list (block_seq / block_row / block_qofs), with
// optional logit softcap and sliding window. fp8 KV is widened exactly, as
// the TPU kernels upcast it to q's dtype. EXTEND_QBLK, the rows of one
// work-list entry, is passed in by the build from ops/attention/
// ragged_paged_attention.py::EXTEND_Q_BLOCK, the constant the host work
// list is built with, so the list and the kernel agree on it.
//
// Bound on this card: operations at the main path's shapes. An entry of
// q_len rows over kv_len positions does ~4 * q_len * kv_len * Hq * D
// causal operations while reading the kv_len rows once, well above the
// ~295 operations per byte where the H100's bf16 tensor cores bind.
//
// Three kernels; the entry point picks one by q's type and the build, never
// at run time otherwise:
//
// bf16 q at head_dim 128 (the aligned build's bf16, e4m3 and e5m2 KV):
//   rpa_extend_wgmma_kernel, on Hopper's warpgroup tensor cores (wgmma;
//   layout, descriptors, forms and the mbarrier ring in rpa_wgmma.cuh).
//   What the GQA branch of _rpa_kernel computes is bf16 x bf16 -> float32
//   dots with P cast to V's dtype (fp8 widens to bf16 without loss). Packed
//   rows as below; grid (ceil(EXTEND_QBLK * G / 128), Hkv, entries), one
//   block of three warpgroups per 128 packed rows (32 query positions at
//   G = 4), one block per SM, the FlashAttention-3 arrangement (named as
//   prior art):
//   - a producer warpgroup keeps a ring of four KV stages full: K and V of
//     a 64-position tile, bf16, 128-byte swizzled (bf16 KV by cp.async at
//     the swizzled offsets, its arrival on the stage's full barrier fired
//     by the copies' completion; fp8 KV copied raw and widened by the same
//     thread two tiles later, rpa_wgmma.cuh's widen_fp8); it refills a
//     stage once every consumer warp has released it (empty barrier);
//   - two consumer warpgroups of 64 packed rows (wgmma's M) each: Q goes
//     to shared memory once and, by ldmatrix, into the warps' A fragments
//     (D / 16 k-steps, kept in registers); per tile, S = Q K^T by 8
//     m64n64k16 with K read K-major; scale, softcap, the masks and the
//     online softmax on the S accumulators in registers as below; O += P V
//     by 4 m64n128k16, P rounded to bf16 straight from the S accumulators
//     as the register A, V read MN-major from the same tile through the
//     transpose bit (no transposition pass); O in float32 registers;
//   - P V lags one tile: iteration t issues S_t, then P_{t-1} V_{t-1}, and
//     runs tile t's softmax on the CUDA cores while the tensor cores run
//     P V; the two consumers meet only at the ring's barriers, so one's
//     softmax and waits overlap the other's products (a block barrier per
//     tile, which kept them in step, cost more than the loads);
//   - setmaxnreg moves registers from the producer (56) to the consumers
//     (224) of the 168 a thread the launch gives;
//   - each warpgroup walks every tile of the block's range (wgmma is
//     warpgroup-wide); a warp masks what its rows cannot see.
//   Not TMA: a TMA box of a page would read the page's slots past kv_len,
//   which no kernel here reads. Shared memory 163 KB (bf16 KV), 211 KB
//   (fp8: three raw tiles more). Each K or V byte read from shared memory
//   feeds 64 rows (16 with mma.sync), and each tile copied serves 128.
//
// bf16 q below head_dim 128 (the chunked build; the merged build with P
// split): rpa_extend_mma_kernel, on the tensor cores by mma.sync.
//   What the chunked TPU kernel computes is bf16 x bf16 ->
//   float32 dots with P cast to q's dtype, which is exactly mma.sync
//   m16n8k16 bf16 -> f32 (fp8 widens to bf16 without loss). The merged
//   build (-DRPA_P_F32) keeps P in float32, as _rpa_kernel_merged does with
//   q, K and V upcast to float32: its scores are the same mma (a product of
//   two bf16 values is exact in float32), and its O += P V takes P as two
//   bf16 parts, hi + lo (split_bf16, rpa_common.cuh), in two products
//   against the same V fragments, which leaves P's error at 2^-18 where one
//   bf16 rounding leaves 2^-9. Packed rows, as the TPU kernel builds its
//   QG = QBLK * G rows per KV head: packed row m = r * G + g is query row r
//   of head h * G + g, so the G heads of a query row are one G * D run of q
//   and every KV tile a block stages serves all G heads. Grid
//   (ceil(EXTEND_QBLK * G / 64), Hkv, entries): one block of 4 warps per 64
//   packed rows of one entry and one KV head; blocks of one (entry, head)
//   are neighbours in launch order and share their KV tiles in L2. Warp w
//   owns the m16 tile of packed rows 16w .. 16w + 15:
//   - Q goes to shared memory once and from there, by ldmatrix, into the
//     warp's A fragments (D / 16 k-steps, kept in registers);
//   - per tile of 64 KV positions, S = Q K^T by mma.sync with K fragments
//     by ldmatrix; then scale, softcap (tanh) and the mask: causal by each
//     packed row's own query position, kv_len, window. Tiles a warp's rows
//     cannot see (above the diagonal, below the window) are skipped, and
//     tiles inside every row's range skip the mask;
//   - the online softmax stays in registers: a row of the C fragment lives
//     in the 4 lanes of a quad, so the row max takes two shuffles, and each
//     lane's partial row sum is reduced once at the end. NEG_INF as on the
//     TPU; a masked score gives p = 0 exactly;
//   - P, rounded to bf16 as the TPU casts p to q's dtype (or split into hi
//     and lo in the merged build), is reused straight from the S
//     accumulators as the A operand of O += P V, with V fragments by
//     ldmatrix.trans; O accumulates in float32 registers.
//   KV tiles are bf16 in shared memory, rows padded to D + 8 elements so
//   that the 8 row addresses of an ldmatrix fall in 8 different bank groups;
//   ldmatrix takes 32-bit shared addresses whose tile offsets are
//   immediates. bf16 KV goes global -> shared by cp.async, slot by slot
//   through the page table, through three stages with one barrier per tile:
//   two tiles are in flight while the block computes on the third. fp8 KV
//   (e4m3, e5m2) is loaded into registers one tile ahead and widened to
//   bf16 on its way into one of two bf16 tiles, exactly, as the TPU upcasts
//   it to q's dtype; on the card this ran a few percent faster than cp.async
//   of the raw bytes into shared memory with a widening pass there.
//   Positions at or past the walk's end are zero-filled, never read (no slot
//   past kv_len). Shared memory, dynamic with the opt-in above 48 KB: 54 KB
//   (bf16) and 36 KB (fp8). Registers set the residency: 4 blocks per SM
//   (128 registers a thread; the copy loop stays rolled so that nothing
//   spills). The epilogue stages each warp's 16 output rows in shared
//   memory and writes them as 16-byte vectors.
//   What holds it back from the card's bf16 peak: mma.sync (not wgmma) on
//   16-row tiles, so each K or V fragment read from shared memory feeds one
//   m16 tile; the softmax and O's rescale between the two products.
//
// float32 q: rpa_extend_kernel, on the CUDA cores. TF32 mma would not be
//   the float32 dot the float32 pair computes. One block per (entry, query
//   head), EXTEND_QBLK query rows per block and TPR = D / 64 threads per row
//   (1 at D 64, 2 at D 128): each thread keeps 64 head dims of its row's
//   query and float32 output in registers, and the TPR partial dot products
//   of a score are summed with __shfl_xor_sync among the row's lanes. A
//   thread's dims are float4 chunks j * TPR + part, so the lanes of a row
//   read neighbouring 16-byte words of a K or V row. KV tiles of 32
//   positions go through shared memory as float32, every row reading each K
//   and V row as a broadcast; the next tile's loads are issued into
//   registers before the current one is computed.
//
// All three walk [lo, min(kv_len, the block's last row's position + 1)), lo
// from the window. A block writes ONLY the rows its entry owns (n_rows =
// min(q_len - qofs, EXTEND_QBLK); the TPU kernels wrote their whole block
// and relied on grid order for the next sequence to overwrite the overrun;
// blocks here run in parallel), the tensor-core kernels only their own heads;
// padding entries (block_seq == -1) write nothing, and a row that saw no
// position writes 0.
#include <type_traits>

#include "rpa_common.cuh"
#include "rpa_wgmma.cuh"

#ifndef EXTEND_QBLK
#error "EXTEND_QBLK must be defined by the build (EXTEND_Q_BLOCK)"
#endif


namespace rpa {

// ------------------------------------------------------------------------
// The CUDA-core kernel (float32 q).

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
      s[t] = p;  // float32 q: P is not rounded
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

// ------------------------------------------------------------------------
// The tensor-core kernel (bf16 q). P_SPLIT: P.V as hi.V + lo.V (P kept in
// float32, the merged build) instead of one product with P rounded to bf16.

constexpr int MMA_NT = 128;   // 4 warps
constexpr int MMA_ROWS = 64;  // packed rows per block: one m16 tile per warp
constexpr int MMA_TK = 64;    // KV positions per tile

template <typename TKV, int D>
struct MmaLayout {
  static constexpr bool WIDEN = sizeof(TKV) == 1;  // fp8 KV: widened on the way in
  static constexpr int LD = D + 8;                 // bf16 row stride of every tile
  static constexpr int TILE = MMA_TK * LD;         // elements of one K or V tile
  static constexpr int BF16_BYTES = 2 * TILE * 2;  // a K and a V tile in bf16
  // bf16 tiles: three stages of bf16 KV (cp.async), two of widened fp8 KV
  static constexpr int NBF = WIDEN ? 2 : 3;
  static constexpr int SMEM = NBF * BF16_BYTES;
  static constexpr int VE = 16 / (int)sizeof(TKV);    // KV elements per 16-byte vector
  static constexpr int VPR = D / VE;                  // vectors per K or V row
  static constexpr int NV = MMA_TK * VPR / MMA_NT;    // of K (and of V) per thread
  static_assert(D % 16 == 0 && MMA_NT % VPR == 0 && (MMA_TK * VPR) % MMA_NT == 0,
                "tile shape");
  static_assert(MMA_ROWS * LD * 2 <= BF16_BYTES, "Q and O staging");
  static_assert(D == 64, "head_dim 128 runs the warpgroup kernel");
};

template <typename TKV, int D, bool P_SPLIT>
__global__ void __launch_bounds__(MMA_NT, 4)
rpa_extend_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [T, Hq, D]
                      const TKV* __restrict__ k_pool,       // K of this layer at slot 0
                      const TKV* __restrict__ v_pool,       // V of this layer at slot 0
                      const int* __restrict__ page_table,   // [B, maxP]
                      const int* __restrict__ kv_lens,      // [B]
                      const int* __restrict__ q_lens,       // [B]
                      const int* __restrict__ q_start,      // [B]
                      const int* __restrict__ block_seq,    // [NQB], -1 = padding
                      const int* __restrict__ block_row,    // [NQB]
                      const int* __restrict__ block_qofs,   // [NQB]
                      __nv_bfloat16* __restrict__ out,      // [T, Hq, D]
                      int Hq, int Hkv, int row_stride, int maxP, int page_size,
                      float scale, float cap, int window) {
  using bf16 = __nv_bfloat16;
  using Lay = MmaLayout<TKV, D>;
  constexpr int LD = Lay::LD, TK = MMA_TK, KS = D / 16, QV = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slice = blockIdx.x, h = blockIdx.y, i = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = block_seq[i];
  if (b < 0) return;  // padding entry: writes nothing
  const int G = Hq / Hkv;
  const int qofs = block_qofs[i];
  const int n_rows = min(q_lens[b] - qofs, EXTEND_QBLK);
  const int m_lo = slice * MMA_ROWS;  // the block's first packed row
  if (m_lo / G >= n_rows) return;     // none of the entry's rows is here
  const int row0 = block_row[i];
  const int q_abs_lo = q_start[b] + qofs;
  const int r_hi = min((m_lo + MMA_ROWS - 1) / G, n_rows - 1);
  const int limit = min(min(kv_lens[b], q_abs_lo + r_hi + 1), maxP * page_size);
  const int lo = window > 0 ? max(q_abs_lo + m_lo / G - window + 1, 0) : 0;
  const int ntiles = limit > lo ? (limit - lo + TK - 1) / TK : 0;

  // bf16 tile s (K, then V) at tiles + s * 2 TILE. Q is staged in the last
  // one, which nothing refills before every warp has passed the first
  // tile's barrier.
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  bf16* sQ = tiles + (Lay::NBF - 1) * 2 * Lay::TILE;

  // Q of the block's packed rows -> shared memory (zeros past n_rows)
#pragma unroll
  for (int k = 0; k < MMA_ROWS * QV / MMA_NT; ++k) {
    const int v = tid + k * MMA_NT, m = v / QV, c = v % QV;
    const int pm = m_lo + m, r = pm / G, g = pm - r * G;
    bf16* dst = sQ + m * LD + c * 8;
    if (r < n_rows)
      cp_async16(dst, q + ((int64_t)(row0 + r) * Hq + h * G + g) * D + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();

  // This thread's KV vectors of a tile: chunk vc of the rows vt0 + k VSTEP,
  // of K and of V (neighbouring threads copy neighbouring 16 bytes of a row).
  const int* pt_row = page_table + (int64_t)b * maxP;
  const TKV* kb = k_pool + (int64_t)h * D;
  const int64_t v_off = v_pool - k_pool;
  const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
  constexpr int VSTEP = MMA_NT / Lay::VPR;
  const int vc = tid % Lay::VPR, vt0 = tid / Lay::VPR;
  // the source of this thread's k-th vector of tile t; ok is false past
  // the walk's end, where nothing is read
  auto source = [&](int t, int k, bool& ok) -> const TKV* {
    const int pos = lo + t * TK + vt0 + k * VSTEP;
    ok = pos < limit;
    if (!ok) return kb;
    const int page = pshift >= 0 ? pos >> pshift : pos / page_size;
    return kb + ((int64_t)pt_row[page] * page_size + (pos - page * page_size)) * row_stride +
           vc * Lay::VE;
  };
  // bf16 KV: copies tile t into stage s (zeros past the walk's end; nothing
  // past the last tile) and commits a group either way, so that every wait
  // counts the same groups
  auto issue = [&](int t, int s) {
    if constexpr (!Lay::WIDEN) {
      if (t < ntiles) {
#pragma unroll 1  // unrolled, the D 64 build spills at 4 blocks per SM
        for (int k = 0; k < Lay::NV; ++k) {
          bool ok;
          const TKV* src = source(t, k, ok);
          bf16* dk = tiles + s * 2 * Lay::TILE + (vt0 + k * VSTEP) * LD + vc * 8;
          cp_async16_zfill(dk, src, ok);
          cp_async16_zfill(dk + Lay::TILE, src + v_off, ok);
        }
      }
      cp_async_commit();
    }
  };
  // fp8 KV: fetch() loads tile t into registers (zeros past the walk's end),
  // put() widens them to bf16 into tile s
  uint4 rk[Lay::WIDEN ? Lay::NV : 1], rv[Lay::WIDEN ? Lay::NV : 1];
  auto fetch = [&](int t) {
    if constexpr (Lay::WIDEN) {
#pragma unroll
      for (int k = 0; k < Lay::NV; ++k) {
        bool ok;
        const TKV* src = source(t, k, ok);
        rk[k] = rv[k] = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {  // never past the last tile: its positions are past the walk's end
          rk[k] = __ldg(reinterpret_cast<const uint4*>(src));
          rv[k] = __ldg(reinterpret_cast<const uint4*>(src + v_off));
        }
      }
    }
  };
  auto put = [&](int s) {
    if constexpr (Lay::WIDEN) {
#pragma unroll
      for (int k = 0; k < Lay::NV; ++k) {
        uint4* dk = reinterpret_cast<uint4*>(tiles + s * 2 * Lay::TILE +
                                             (vt0 + k * VSTEP) * LD + vc * 16);
        uint4* dv = dk + Lay::TILE / 8;
        widen_bf16<TKV>(rk[k], dk[0], dk[1]);
        widen_bf16<TKV>(rv[k], dv[0], dv[1]);
      }
    }
  };

  if constexpr (Lay::WIDEN) {
    fetch(0);
    put(0);
    fetch(1);
    cp_async_wait<0>();  // Q has landed
  } else {
    issue(0, 0);
    issue(1, 1);
    cp_async_wait<2>();  // Q has landed
  }
  __syncthreads();
  // ldmatrix addresses: 32-bit shared addresses, each lane's row and
  // column offset in bytes (A: rows of matrices 1 and 3 are 8 further down;
  // B of S = Q K^T: matrices 2 and 3 are positions 8-15 of a pair of n8
  // tiles, 1 and 3 the upper 8 dims; V by .trans: matrices 1 and 3 are
  // positions 8-15, 2 and 3 the next 8 dims)
  const uint32_t s_tiles = static_cast<uint32_t>(__cvta_generic_to_shared(tiles));
  const int l7 = lane & 7, l8 = ((lane >> 3) & 1) * 8, l16 = ((lane >> 4) & 1) * 8;
  const uint32_t a_lane = ((l7 + l8) * LD + l16) * 2;
  const uint32_t k_lane = ((l7 + l16) * LD + l8) * 2;
  const uint32_t v_lane = a_lane;
  uint32_t qa[KS][4];  // the warp's A fragments of Q
  {
    const uint32_t p = s_tiles + (Lay::NBF - 1) * Lay::BF16_BYTES + warp * 16 * LD * 2 + a_lane;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qa[ks], p + ks * 32);
  }

  // this lane's two packed rows (C-fragment rows gid and gid + 8)
  const int gid = lane >> 2, tig = lane & 3;
  int qpos[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) qpos[j] = q_abs_lo + (m_lo + warp * 16 + gid + 8 * j) / G;
  // the warp's query rows that the entry owns: positions wq_lo .. wq_hi
  const int wr_lo = (m_lo + warp * 16) / G;
  const bool warp_live = wr_lo < n_rows;
  const int wq_lo = q_abs_lo + wr_lo;
  const int wq_hi = q_abs_lo + min((m_lo + warp * 16 + 15) / G, n_rows - 1);
  // p = 2^(v c - m c): v the raw dot (c folds in the scale) or the capped score
  const bool capped = cap > 0.f;
  const float c = capped ? LOG2E : scale * LOG2E;

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

  // One barrier per tile: it makes tile t (in bf16 tile s) visible and
  // tells every thread that the block is done with tile t - 1. bf16 KV then
  // copies tile t + 2 into tile t - 1's stage, and has two tiles in flight
  // while it computes; fp8 KV, after computing, widens tile t + 1 (in its
  // registers since tile t - 1) into tile t - 1's bf16 tile and loads tile
  // t + 2 into its registers.
  for (int t = 0, s = 0; t < ntiles; ++t, s = s + 1 == Lay::NBF ? 0 : s + 1) {
    const int st = lo + t * TK;
    if constexpr (!Lay::WIDEN) cp_async_wait<1>();  // tile t has landed (this thread's copies)
    __syncthreads();
    issue(t + 2, s == 0 ? Lay::NBF - 1 : s - 1);
    const uint32_t sK = s_tiles + s * Lay::BF16_BYTES, sV = sK + Lay::TILE * 2;
    const bool skip = !warp_live || st > wq_hi || (window > 0 && st + TK - 1 <= wq_lo - window);
    if (!skip) {
      const bool masked = st + TK > limit || st + TK - 1 > wq_lo ||
                          (window > 0 && st <= wq_hi - window);
      // S = Q K^T: 8 n8 tiles of 8 positions
      float sc[TK / 8][4];
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < TK / 16; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, sK + k_lane + (np * 16 * LD + ks * 16) * 2);
          mma_bf16_16816(sc[2 * np], qa[ks], kf[0], kf[1]);
          mma_bf16_16816(sc[2 * np + 1], qa[ks], kf[2], kf[3]);
        }
      }
      // softcap, mask and the row max (over the 4 lanes of a quad)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          float v = sc[j][e];
          if (capped) v = cap * tanhf(v * scale / cap);
          if (masked) {
            const int pos = st + j * 8 + 2 * tig + (e & 1);
            const bool ok = pos < limit && pos <= qpos[rr] &&
                            (window <= 0 || pos > qpos[rr] - window);
            v = ok ? v : NEG_INF;
          }
          sc[j][e] = v;
          mx[rr] = fmaxf(mx[rr], v);
        }
      }
      float corr[2], mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(mrow[rr], mx[rr]);
        corr[rr] = fast_exp2((mrow[rr] - m_new) * c);
        mrow[rr] = m_new;
        // a row with nothing valid yet keeps m at NEG_INF: p = 2^(NEG_INF c) = 0
        mc[rr] = (m_new == NEG_INF ? 0.f : m_new) * c;
      }
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(sc[j][e], c, -mc[e >> 1]));
          psum[e >> 1] += p;
          sc[j][e] = p;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) lrow[rr] = lrow[rr] * corr[rr] + psum[rr];
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
      // O += P V: P from the S accumulators as A, rounded to bf16 (pa), or
      // as its bf16 parts pa + pl with P_SPLIT
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p0 = sc[2 * kk + (e >> 1)][2 * (e & 1)];
          const float p1 = sc[2 * kk + (e >> 1)][2 * (e & 1) + 1];
          if constexpr (P_SPLIT)
            split_bf16(p0, p1, pa[e], pl[e]);
          else
            pa[e] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sV + v_lane + (kk * 16 * LD + dp * 16) * 2);
          mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
          if constexpr (P_SPLIT) {
            mma_bf16_16816(o[2 * dp], pl, vf[0], vf[1]);
            mma_bf16_16816(o[2 * dp + 1], pl, vf[2], vf[3]);
          }
        }
      }
    }
    if constexpr (Lay::WIDEN) {
      if (t + 1 < ntiles) put(s ^ 1);
      fetch(t + 2);
    }
  }

  // Epilogue: O / l (0 for a row that saw no position) staged per warp in
  // shared memory, then written as 16-byte vectors to the rows the entry owns
  cp_async_wait<0>();
  __syncthreads();  // every tile is idle
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lrow[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rr] = l > 0.f ? 1.f / l : 0.f;
  }
  bf16* sO = tiles + warp * 16 * LD;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    *reinterpret_cast<uint32_t*>(sO + gid * LD + d * 8 + 2 * tig) =
        pack_bf16(o[d][0] * inv[0], o[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (gid + 8) * LD + d * 8 + 2 * tig) =
        pack_bf16(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * QV / 32; ++k) {
    const int v = lane + k * 32, m = v / QV, cc = v % QV;
    const int pm = m_lo + warp * 16 + m, r = pm / G, g = pm - r * G;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(out + ((int64_t)(row0 + r) * Hq + h * G + g) * D + cc * 8) =
          *reinterpret_cast<const uint4*>(sO + m * LD + cc * 8);
  }
}

template <typename TKV, int D, bool P_SPLIT>
static int launch_extend_mma(const void* q, const void* k_pool, const void* v_pool,
                             const void* pt, const void* kv_lens, const void* q_lens,
                             const void* q_start, const void* block_seq, const void* block_row,
                             const void* block_qofs, void* out, int NQB, int Hq, int Hkv,
                             int row_stride, int maxP, int page_size, float scale, float cap,
                             int window, cudaStream_t stream) {
  using Lay = MmaLayout<TKV, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      rpa_extend_mma_kernel<TKV, D, P_SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Lay::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int G = Hq / Hkv;
  const dim3 grid((EXTEND_QBLK * G + MMA_ROWS - 1) / MMA_ROWS, Hkv, NQB);
  rpa_extend_mma_kernel<TKV, D, P_SPLIT><<<grid, MMA_NT, Lay::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, row_stride, maxP, page_size, scale, cap,
      window);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The warpgroup kernel (bf16 q at head_dim 128: the aligned build's three
// bf16-q pairs). rpa_wgmma.cuh has the layout, the descriptors, the wgmma
// forms and the mbarrier ring.

constexpr int WG_NT = 384;       // two consumer warpgroups, then one producer warpgroup
constexpr int WG_ROWS = 128;     // packed rows per block: 64 (wgmma's M) per consumer
constexpr int WG_TK = 64;        // KV positions per tile: the N of S = Q K^T
constexpr int WG_STAGES = 4;     // KV tiles (K and V) in the ring
constexpr int WG_LAG = 2;        // fp8: tiles copied raw ahead of the one being widened
constexpr int WG_PRODUCER_REGS = 56;   // registers a thread after setmaxnreg: the launch
constexpr int WG_CONSUMER_REGS = 224;  // gives 168 (65536 / 384), 2 x 56 move across

template <typename TKV, int D>
struct WgLayout {
  static constexpr bool WIDEN = sizeof(TKV) == 1;  // fp8 KV: widened by the producer
  static constexpr int TILE = WG_TK * D * 2;       // bytes of a K or a V tile (bf16, swizzled)
  static constexpr int STAGE = 2 * TILE;           // K, then V
  static constexpr int RAW = WG_TK * D * 2;        // bytes of a raw fp8 K and V tile
  static constexpr int NRAW = WIDEN ? WG_LAG + 1 : 0;  // raw tiles in flight
  static constexpr int RAW0 = WG_STAGES * STAGE;
  static constexpr int Q0 = RAW0 + NRAW * RAW;       // Q (then O) staging
  static constexpr int QLD = D + 8;                  // its row stride, padded for ldmatrix
  static constexpr int BAR0 = Q0 + WG_ROWS * QLD * 2;  // full[WG_STAGES], empty[WG_STAGES]
  static constexpr int SMEM = BAR0 + 2 * WG_STAGES * 8 + 1024;  // + the atoms' alignment
  static constexpr int VE = 16 / (int)sizeof(TKV);   // KV elements per 16-byte vector
  static constexpr int VPR = D / VE;                 // vectors per K or V row
  static constexpr int VSTEP = 128 / VPR;            // rows between a producer thread's vectors
  static constexpr int NV = WG_TK / VSTEP;           // of K (and of V) per producer thread
  static_assert(D % 64 == 0 && VSTEP % 8 == 0 && WG_TK % VSTEP == 0, "tile shape");
  static_assert(2 * (WG_CONSUMER_REGS - 168) <= 168 - WG_PRODUCER_REGS, "register moves");
};

template <typename TKV, int D>
__global__ void __launch_bounds__(WG_NT, 1)
rpa_extend_wgmma_kernel(const __nv_bfloat16* __restrict__ q,  // [T, Hq, D]
                        const TKV* __restrict__ k_pool,       // K of this layer at slot 0
                        const TKV* __restrict__ v_pool,       // V of this layer at slot 0
                        const int* __restrict__ page_table,   // [B, maxP]
                        const int* __restrict__ kv_lens,      // [B]
                        const int* __restrict__ q_lens,       // [B]
                        const int* __restrict__ q_start,      // [B]
                        const int* __restrict__ block_seq,    // [NQB], -1 = padding
                        const int* __restrict__ block_row,    // [NQB]
                        const int* __restrict__ block_qofs,   // [NQB]
                        __nv_bfloat16* __restrict__ out,      // [T, Hq, D]
                        int Hq, int Hkv, int row_stride, int maxP, int page_size,
                        float scale, float cap, int window) {
  using bf16 = __nv_bfloat16;
  using Lay = WgLayout<TKV, D>;
  constexpr int TK = WG_TK, KS = D / 16, QV = D / 8, QLD = Lay::QLD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  // entries in reverse launch order: a request's later entries walk more
  // positions, and starting them first leaves the short walks to the last,
  // partial wave of blocks
  const int slice = blockIdx.x, h = blockIdx.y, i = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x;
  const int b = block_seq[i];
  if (b < 0) return;  // padding entry: writes nothing
  const int G = Hq / Hkv;
  const int qofs = block_qofs[i];
  const int n_rows = min(q_lens[b] - qofs, EXTEND_QBLK);
  const int m_lo = slice * WG_ROWS;  // the block's first packed row
  if (m_lo / G >= n_rows) return;    // none of the entry's rows is here
  const int row0 = block_row[i];
  const int q_abs_lo = q_start[b] + qofs;
  const int r_hi = min((m_lo + WG_ROWS - 1) / G, n_rows - 1);
  const int limit = min(min(kv_lens[b], q_abs_lo + r_hi + 1), maxP * page_size);
  const int lo = window > 0 ? max(q_abs_lo + m_lo / G - window + 1, 0) : 0;
  const int ntiles = limit > lo ? (limit - lo + TK - 1) / TK : 0;
  if (ntiles == 0) return;  // its rows see no position: they stay 0 (out is zero-filled)

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BAR0);
  uint64_t* empty = full + WG_STAGES;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::mbar_init(full + s, 128);  // the producer's threads
      wg::mbar_init(empty + s, 8);   // the consumers' warps
    }
    wg::mbar_init_fence();
  }
  // Q of the block's packed rows (zeros past n_rows), in padded rows for
  // ldmatrix, copied by the whole block
  bf16* sQ = reinterpret_cast<bf16*>(smem + Lay::Q0);
  for (int v = tid; v < WG_ROWS * QV; v += WG_NT) {
    const int m = v / QV, c = v % QV;
    const int pm = m_lo + m, r = pm / G, g = pm - r * G;
    bf16* dst = sQ + m * QLD + c * 8;
    if (r < n_rows)
      cp_async16(dst, q + ((int64_t)(row0 + r) * Hq + h * G + g) * D + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const uint32_t s_smem = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  if (tid >= 256) {
    // ---- The producer warpgroup: keeps the ring full. Thread p copies
    // chunk vc of the rows vt0 + k VSTEP of K and, from the same slot, of V
    // (neighbouring threads copy neighbouring 16 bytes of a row; VSTEP is a
    // multiple of 8, so all of a thread's rows sit at the same row of their
    // swizzle atoms). Tile t goes to stage t % WG_STAGES once the consumers
    // have released the tile before it there. bf16 KV is copied by cp.async
    // straight to its swizzled offsets, and the thread's arrival on full
    // fires when its copies land. fp8 KV is copied raw into one of NRAW raw
    // tiles; WG_LAG tiles later the same thread (it reads only what it
    // copied) widens it into the stage and arrives. Zeros past the walk's
    // end, where nothing is read.
    wg::regs_dec<WG_PRODUCER_REGS>();
    const int p = tid - 256;
    const int* pt_row = page_table + (int64_t)b * maxP;
    const TKV* kb = k_pool + (int64_t)h * D;
    const int64_t v_off = v_pool - k_pool;
    const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
    // fp8: bits 2 and 3 of the thread swapped, so that lanes 4-7 of a
    // quarter warp widen the next row, whose swizzle phase differs: their
    // 16-byte stores then fall in other banks than lanes 0-3's
    const int pq = Lay::WIDEN ? (p & ~12) | ((p & 4) << 1) | ((p & 8) >> 1) : p;
    const int vc = pq % Lay::VPR, vt0 = pq / Lay::VPR;
    // the source of this thread's k-th vector of tile t (kb past the walk's end)
    auto source = [&](int t, int k, bool& ok) -> const TKV* {
      const int pos = lo + t * TK + vt0 + k * Lay::VSTEP;
      ok = pos < limit;
      return ok ? kb + wg::slot_of(pt_row, pos, page_size, pshift) * row_stride + vc * Lay::VE
                : kb;
    };
    if constexpr (!Lay::WIDEN) {
      for (int t = 0; t < ntiles; ++t) {
        if (t >= WG_STAGES) wg::mbar_wait(empty + t % WG_STAGES, (t / WG_STAGES - 1) & 1);
        unsigned char* st = smem + (t % WG_STAGES) * Lay::STAGE;
#pragma unroll
        for (int k = 0; k < Lay::NV; ++k) {
          bool ok;
          const TKV* src = source(t, k, ok);
          const int off = wg::sw128(TK, vt0 + k * Lay::VSTEP, vc);
          cp_async16_zfill(st + off, src, ok);
          cp_async16_zfill(st + Lay::TILE + off, src + v_off, ok);
        }
        wg::mbar_arrive_cp_async(full + t % WG_STAGES);
      }
    } else {
      uint4* raw = reinterpret_cast<uint4*>(smem + Lay::RAW0);
      for (int t = 0; t < ntiles + WG_LAG; ++t) {
        if (t < ntiles) {
          uint4* rw = raw + (t % Lay::NRAW) * (Lay::RAW / 16);
#pragma unroll
          for (int k = 0; k < Lay::NV; ++k) {
            bool ok;
            const TKV* src = source(t, k, ok);
            cp_async16_zfill(rw + k * 128 + p, src, ok);
            cp_async16_zfill(rw + (Lay::NV + k) * 128 + p, src + v_off, ok);
          }
        }
        cp_async_commit();  // a group every round, so that every wait counts the same
        const int u = t - WG_LAG;
        if (u >= 0) {
          cp_async_wait<WG_LAG>();  // the raw tile u has landed
          if (u >= WG_STAGES) wg::mbar_wait(empty + u % WG_STAGES, (u / WG_STAGES - 1) & 1);
          unsigned char* st = smem + (u % WG_STAGES) * Lay::STAGE;
          const uint4* rw = raw + (u % Lay::NRAW) * (Lay::RAW / 16);
#pragma unroll
          for (int k = 0; k < Lay::NV; ++k) {
            const int row = vt0 + k * Lay::VSTEP;
            const int o0 = wg::sw128(TK, row, 2 * vc), o1 = wg::sw128(TK, row, 2 * vc + 1);
            uint4 x, y;
            wg::widen_fp8<TKV>(rw[k * 128 + p], x, y);
            *reinterpret_cast<uint4*>(st + o0) = x;
            *reinterpret_cast<uint4*>(st + o1) = y;
            wg::widen_fp8<TKV>(rw[(Lay::NV + k) * 128 + p], x, y);
            *reinterpret_cast<uint4*>(st + Lay::TILE + o0) = x;
            *reinterpret_cast<uint4*>(st + Lay::TILE + o1) = y;
          }
          wg::mbar_arrive(full + u % WG_STAGES);
        }
      }
    }
    cp_async_wait<0>();
  } else {
    // ---- The two consumer warpgroups: warps 0-3 own the block's packed
    // rows 0-63, warps 4-7 rows 64-127, each warp 16 of them.
    wg::regs_inc<WG_CONSUMER_REGS>();
    const int warp = tid / 32, lane = tid % 32;
    // the warp's A fragments of Q, by ldmatrix as in the mma.sync kernel:
    // wgmma's register A is that fragment
    const int l7 = lane & 7, l8 = ((lane >> 3) & 1) * 8, l16 = ((lane >> 4) & 1) * 8;
    uint32_t qa[KS][4];
    {
      const uint32_t a = s_smem + Lay::Q0 + warp * 16 * QLD * 2 + ((l7 + l8) * QLD + l16) * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qa[ks], a + ks * 32);
    }
    // this lane's two packed rows (accumulator rows gid and gid + 8 of the warp)
    const int gid = lane >> 2, tig = lane & 3;
    int qpos[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) qpos[j] = q_abs_lo + (m_lo + warp * 16 + gid + 8 * j) / G;
    // the warp's query positions wq_lo .. wq_hi (its rows the entry owns)
    const int wq_lo = q_abs_lo + (m_lo + warp * 16) / G;
    const int wq_hi = q_abs_lo + min((m_lo + warp * 16 + 15) / G, n_rows - 1);
    // p = 2^(v c - m c): v the raw dot (c folds in the scale) or the capped score
    const bool capped = cap > 0.f;
    const float c = capped ? LOG2E : scale * LOG2E;

    float sc[TK / 2], o[D / 2];  // S and O accumulators (rpa_wgmma.cuh's fragment)
    uint32_t pa[TK / 16][4];     // P of the previous tile: the A of its P V
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) sc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

    // Iteration t waits for tile t, issues S_t = Q K_t^T (8 m64n64k16, K
    // read K-major), then O += P_{t-1} V_{t-1} (4 m64n128k16, P rounded to
    // bf16 as the TPU casts p to V's dtype, from registers; V read MN-major
    // through the transpose bit), waits for S_t alone and runs the softmax
    // of tile t on the CUDA cores while the tensor cores run P V; then waits
    // for P V, releases tile t - 1's stage, rescales O and packs P_t. The
    // two warpgroups meet only at the ring's barriers, so one's softmax
    // and waits overlap the other's products. Each walks every tile of
    // [lo, limit) (wgmma is warpgroup-wide); a warp whose rows see none of
    // a tile masks all of it.
    for (int t = 0; t < ntiles; ++t) {
      const int st = lo + t * TK;
      wg::mbar_wait(full + t % WG_STAGES, (t / WG_STAGES) & 1);
      // the producer wrote the tile through the generic proxy (cp.async, or
      // the widening stores): fenced here, after the barrier, for wgmma's
      // async proxy. A fence in the producer would wait for its copies in
      // flight (fence.proxy.async includes a MEMBAR); here none are.
      wg::fence_proxy_async();
      const uint32_t sK = s_smem + (t % WG_STAGES) * Lay::STAGE;
      // P V of tile t - 1; at t = 0, P = 0 times the (finite) K_0 tile, so
      // that no wgmma sits under a branch (ptxas then serializes them)
      const uint32_t sV =
          t > 0 ? s_smem + ((t - 1) % WG_STAGES) * Lay::STAGE + Lay::TILE : sK;
      const bool masked = st + TK > limit || st + TK - 1 > wq_lo ||
                          (window > 0 && st <= wq_hi - window);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wg::mma_rs<0>(sc, qa[ks], wg::desc_k(sK, TK, ks), ks);
      wg::commit();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) wg::mma_rs<1>(o, pa[kk], wg::desc_mn(sV, TK, kk), 1);
      wg::commit();
      wg::wait<1>();  // S_t is done; P V may still run
      wg::fence_regs(sc);
      // softcap, mask and the row max (over the 4 lanes of a quad)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < TK / 2; ++e) {
        const int rr = (e >> 1) & 1;
        float v = sc[e];
        if (capped) v = cap * tanhf(v * scale / cap);
        if (masked) {
          const int pos = st + 8 * (e >> 2) + 2 * tig + (e & 1);
          const bool ok = pos < limit && pos <= qpos[rr] &&
                          (window <= 0 || pos > qpos[rr] - window);
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
        // a row with nothing valid yet keeps m at NEG_INF: p = 2^(NEG_INF c) = 0
        mc[rr] = (m_new == NEG_INF ? 0.f : m_new) * c;
      }
#pragma unroll
      for (int e = 0; e < TK / 2; ++e) {
        const float pe = fast_exp2(fmaf(sc[e], c, -mc[(e >> 1) & 1]));
        psum[(e >> 1) & 1] += pe;
        sc[e] = pe;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) lrow[rr] = lrow[rr] * corr[rr] + psum[rr];
      wg::wait<0>();  // P_{t-1} V_{t-1} is done
      wg::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) wg::fence_regs(pa[kk]);
      if (t > 0 && lane == 0) wg::mbar_arrive(empty + (t - 1) % WG_STAGES);
      // O's rescale, unless no row max of the warp moved (corr is then 1
      // exactly, the common case once the first tiles are in)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      }
      // P_t as the register A of each k-step of 16 positions
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
          pa[kk][e] = pack_bf16(sc[x], sc[x + 1]);
        }
    }
    // the last tile's P V (its stage is not refilled: no release)
    {
      const uint32_t sV = s_smem + ((ntiles - 1) % WG_STAGES) * Lay::STAGE + Lay::TILE;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) wg::mma_rs<1>(o, pa[kk], wg::desc_mn(sV, TK, kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(o);
    }

    // Epilogue: O / l (0 for a row that saw no position) staged per warp in
    // the Q staging (each warp its own 16 rows), then written as 16-byte
    // vectors to the rows the entry owns
    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = lrow[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[rr] = l > 0.f ? 1.f / l : 0.f;
    }
    bf16* sO = sQ + warp * 16 * QLD;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<uint32_t*>(sO + gid * QLD + d * 8 + 2 * tig) =
          pack_bf16(o[4 * d] * inv[0], o[4 * d + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sO + (gid + 8) * QLD + d * 8 + 2 * tig) =
          pack_bf16(o[4 * d + 2] * inv[1], o[4 * d + 3] * inv[1]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 16 * QV / 32; ++k) {
      const int v = lane + k * 32, m = v / QV, cc = v % QV;
      const int pm = m_lo + warp * 16 + m, r = pm / G, g = pm - r * G;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + ((int64_t)(row0 + r) * Hq + h * G + g) * D + cc * 8) =
            *reinterpret_cast<const uint4*>(sO + m * QLD + cc * 8);
    }
  }
}

template <typename TKV, int D>
static int launch_extend_wgmma(const void* q, const void* k_pool, const void* v_pool,
                               const void* pt, const void* kv_lens, const void* q_lens,
                               const void* q_start, const void* block_seq, const void* block_row,
                               const void* block_qofs, void* out, int NQB, int Hq, int Hkv,
                               int row_stride, int maxP, int page_size, float scale, float cap,
                               int window, cudaStream_t stream) {
  using Lay = WgLayout<TKV, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      rpa_extend_wgmma_kernel<TKV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // setmaxnreg.inc waits until the producer has given its registers back:
  // launched with fewer than the moves need, the consumers would wait for
  // ever, so such a build is refused instead
  static const int launch_regs = [] {
    cudaFuncAttributes fa{};
    return cudaFuncGetAttributes(&fa, rpa_extend_wgmma_kernel<TKV, D>) == cudaSuccess
               ? fa.numRegs
               : 0;
  }();
  if (2 * (WG_CONSUMER_REGS - launch_regs) > launch_regs - WG_PRODUCER_REGS)
    return (int)cudaErrorLaunchOutOfResources;
  const int G = Hq / Hkv;
  const dim3 grid((EXTEND_QBLK * G + WG_ROWS - 1) / WG_ROWS, Hkv, NQB);
  rpa_extend_wgmma_kernel<TKV, D><<<grid, WG_NT, Lay::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, row_stride, maxP, page_size, scale, cap,
      window);
  return (int)cudaGetLastError();
}

// The tensor cores for bf16 q: warpgroups (wgmma) at head_dim 128, where P
// is rounded to bf16 (the aligned build), mma.sync below it (with P split
// in the merged build, which keeps P in float32); the CUDA-core kernel for
// float32 q.
template <typename TQ, typename TKV, int D>
static int launch(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                  const void* kv_lens, const void* q_lens, const void* q_start,
                  const void* block_seq, const void* block_row, const void* block_qofs,
                  void* out, int NQB, int Hq, int Hkv, int row_stride, int maxP,
                  int page_size, float scale, float cap, int window, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value && D == 128 && !P_F32_BUILD)
    return launch_extend_wgmma<TKV, D>(q, k_pool, v_pool, pt, kv_lens, q_lens, q_start,
                                       block_seq, block_row, block_qofs, out, NQB, Hq, Hkv,
                                       row_stride, maxP, page_size, scale, cap, window, stream);
  else if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return launch_extend_mma<TKV, D, P_F32_BUILD>(
        q, k_pool, v_pool, pt, kv_lens, q_lens, q_start, block_seq, block_row, block_qofs, out,
        NQB, Hq, Hkv, row_stride, maxP, page_size, scale, cap, window, stream);
  else
    return launch_extend<TQ, TKV, D>(q, k_pool, v_pool, pt, kv_lens, q_lens, q_start,
                                     block_seq, block_row, block_qofs, out, NQB, Hq, Hkv,
                                     row_stride, maxP, page_size, scale, cap, window, stream);
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
    return launch<TQ, TKV, RPA_HEAD_DIM>(q, k_pool, v_pool, page_table, kv_lens, q_lens,     \
                                         q_start, block_seq, block_row, block_qofs, out, NQB, \
                                         Hq, Hkv, row_stride, maxP, page_size, scale, cap,    \
                                         window, s);
  RPA_FOR_EACH_PAIR(RPA_EXT)
#undef RPA_EXT
  return (int)cudaErrorInvalidValue;
}
