// Ragged paged extend (chunked-prefill) attention over the chunked or the
// 5D KV pool, for Hopper (sm_90a).
//
// Replaces three TPU kernels (branches), one build each (rpa_common.cuh;
// every build takes bf16 and fp8 e4m3 / e5m2 KV under bf16 q, float32 KV
// under float32 q):
//   chunked pool, head_dim 64 (rpa_extend): semi_pd_tpu/ops/attention/
//     ragged_paged_attention.py _rpa_kernel_chunked (called from
//     ragged_paged_attention_chunked);
//   5D pool, head_dim 128 (-DRPA_ALIGNED, rpa_extend_aligned) and 256
//     (-DRPA_ALIGNED -DRPA_HEAD_DIM=256, rpa_extend_aligned_256, Gemma-2's):
//     semi_pd_tpu/ops/attention/ragged_paged_attention.py
//     _rpa_kernel (called from ragged_paged_attention; its GQA branch, the
//     MLA v_dim branch is rpa_extend_mla.cu);
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
// Two kernels; the entry point picks one by q's type, never at run time
// otherwise:
//
// bf16 q (every build; bf16, e4m3 and e5m2 KV): rpa_extend_wgmma_kernel,
//   on Hopper's warpgroup tensor cores (wgmma; layout, descriptors, forms
//   and the mbarrier ring in rpa_wgmma.cuh). What the GQA TPU kernels
//   compute is bf16 x bf16 -> float32 dots with P cast to the KV tile's
//   dtype (fp8 widens to bf16 without loss): the chunked and the aligned
//   build round P to bf16 once. The merged build (-DRPA_P_F32, P_SPLIT)
//   keeps P in float32, as _rpa_kernel_merged does with q, K and V upcast
//   to float32: its scores are the same products (a product of two bf16
//   values is exact in float32), and its O += P V takes P as two bf16
//   parts, hi + lo (split_bf16_trunc, rpa_common.cuh), hi then lo against
//   the same V tile, which leaves P's error below 2^-15 where one rounding
//   leaves up to 2^-8. Packed rows, as the TPU kernels build their
//   QG = QBLK * G rows per KV head: packed row m = r * G + g is query row r
//   of head h * G + g, so the G heads of a query row are one G * D run of q
//   and every KV tile a block stages serves all G heads. Both pools address K
//   and V alike (rpa_common.cuh), so one producer serves both. Grid
//   (ceil(EXTEND_QBLK * G / ROWS), Hkv, entries), one block per SM, the
//   FlashAttention-3 arrangement (named as prior art):
//   - a producer warpgroup keeps a ring of STAGES KV stages full: K and V
//     of a TK-position tile, bf16, 128-byte swizzled (bf16 KV by cp.async
//     at the swizzled offsets, its arrival on the stage's full barrier
//     fired by the copies' completion; fp8 KV copied raw and widened by
//     the same thread LAG tiles later, rpa_wgmma.cuh's widen_fp8 and
//     fp8_lane); it refills a stage once every consumer warp has released
//     it (empty barrier);
//   - NCW consumer warpgroups of 64 packed rows (wgmma's M) each: Q goes
//     to shared memory once and, by ldmatrix, into the warps' A fragments
//     (D / 16 k-steps, kept in registers; at head_dim 256 Q stays in shared
//     memory, swizzled, and is read by descriptor: see below); per tile,
//     S = Q K^T by D / 16 m64nTKk16 with K read K-major; scale, softcap,
//     the masks (causal by
//     each packed row's own query position, kv_len, window; tiles inside
//     every row of a warp skip them) and the online softmax on the S
//     accumulators in registers (a row lives in the 4 lanes of a quad: two
//     shuffles for its max; NEG_INF as on the TPU, so a masked score gives
//     p = 0 exactly; softcap and mask each a pass of its own, behind one
//     branch a tile); O += P V by TK / 16 m64nDk16 (twice as many with
//     P_SPLIT), P packed straight from the S accumulators as the register
//     A, V read MN-major from the same tile through the transpose bit (no
//     transposition pass); O in float32 registers;
//   - P V lags one tile: iteration t issues S_t, then P_{t-1} V_{t-1}, and
//     runs tile t's softmax on the CUDA cores while the tensor cores run
//     P V;
//   - setmaxnreg moves registers from the producer to the consumers of the
//     65536 / NT a thread the launch gives (the C entry refuses a build
//     whose launch registers cannot fund the moves: setmaxnreg.inc would
//     wait for ever);
//   - each warpgroup walks every tile of the block's range (wgmma is
//     warpgroup-wide, and none sits under a branch); a warp masks what its
//     rows cannot see.
//   The block shape per head_dim (WG_* and WG64_* below):
//   - head_dim 128 (the aligned build): 2 consumer warpgroups (128 packed
//     rows, 32 query positions at G = 4), 64-position tiles, 4 stages,
//     setmaxnreg 224 / 56 of 168; the consumers meet only at the ring's
//     barriers (a block barrier per tile, which kept them in step, cost
//     more than the loads). Shared memory 163 KB (bf16 KV), 211 KB (fp8).
//   - head_dim 64 (the chunked and the merged build): 2 consumer
//     warpgroups, 128-position tiles (S as m64n128k16: half the barriers,
//     waits and softmax passes per position), 4 stages, 224 / 56. A 64-wide
//     bf16 row is one 128-byte swizzle column, so desc_k stays in it and
//     P V has one N block. Shared memory 147 KB (bf16 KV), 195 KB (fp8).
//     Chosen on the card from eight shapes (extend_shapes.py, b8 x q256 /
//     kv2048, chunked build; PERF.md, PR 10): 64-position tiles ran 0.162
//     ms, 128-position 0.141; three consumer warpgroups (192 rows, 512
//     threads, setmaxnreg 160 / 32, 6 stages) 0.145, but 0.174 against
//     0.163 in the merged build, whose hi and lo fragments of a 128-position
//     P do not fit 160 registers; the consumers taking turns to issue their
//     products (FlashAttention-3's ping-pong, by named barriers) ran slower
//     in all but one case; 3 stages ran slower than 4, 5 no faster. The
//     fp8 producer's thread map is the identity here (fp8_lane: its two
//     rows per quarter warp already fall in other banks).
//   - head_dim 256 (the aligned _256 build, Gemma-2's): O alone is 64 x 256
//     float32, 128 registers a consumer thread; Q's A fragments would take
//     64 more and S 32 more at the 128 build's 64-position tiles. So Q is
//     staged once in the 128-byte swizzled layout (ROWS rows, four column
//     blocks) and S = Q K^T takes it by descriptor (wgmma's SS form, A
//     K-major like K), and the tile is 32 positions (S as m64n32k16, 16
//     registers; P V as m64n256k16 over V's four column blocks, LBO apart):
//     FlashAttention-3's head_dim-256 arrangement (Q from shared memory, a
//     shorter KV tile), named as prior art. 2 consumer warpgroups, 3 stages
//     (32 KB each), 224 / 56 as above: 160 KB of shared memory with bf16
//     KV, 208 KB with fp8 (its 3 raw tiles of 16 KB); 4 stages would leave
//     fp8 no room. Each warp stages its O through its own Q rows (no other
//     warp reads them). A 256-wide row is 32 chunks: a producer thread
//     takes rows 4 apart (VSTEP 4), so that 32 threads copy one row.
//     Chosen on the card from the four shapes that fit fp8 KV
//     (extend_shapes.py --head-dim 256; PERF.md §6): 32 positions x 3
//     stages ran 0.220 ms at b8 x q256 / kv2048 with bf16 and with e4m3
//     KV (a lag of 1 the same with bf16, 2% slower with fp8); 2 stages
//     lost 13-58%, 48-position tiles at 2 stages 7-40%. Its TREE = true
//     instantiation (EAGLE's tree verify on a Gemma-2 target, with the
//     softcap and each layer's window, and the tree's draft steps on the
//     one-layer draft pool) adds each lane's two ancestor masks, the window
//     start and the tile test to the same 224 registers; the TREE = false
//     function is compiled as it was without it.
//   Not TMA: a TMA box of a page would read the page's slots past kv_len,
//   which no kernel here reads. Each K or V byte read from shared memory
//   feeds 64 rows, and each tile copied serves ROWS.
//
// float32 q: rpa_extend_kernel, on the CUDA cores. TF32 mma would not be
//   the float32 dot the float32 pair computes. One block per (entry, query
//   head), EXTEND_QBLK query rows per block and TPR = D / 64 threads per row
//   (1 at D 64, 2 at D 128, 4 at D 256): each thread keeps 64 head dims of
//   its row's query and float32 output in registers (at D 256, 512 threads
//   a block leave 128 registers a thread, and the kernel spills), and the TPR partial dot products
//   of a score are summed with __shfl_xor_sync among the row's lanes. A
//   thread's dims are float4 chunks j * TPR + part, so the lanes of a row
//   read neighbouring 16-byte words of a K or V row. KV tiles of 32
//   positions (16 at D 256, within the 48 KB of static shared memory) go
//   through shared memory as float32, every row reading each K and V row
//   as a broadcast; the next tile's loads are issued into
//   registers before the current one is computed.
//
// The speculation tree (SpecTree and its rule in rpa_common.cuh; ops/
// attention/ragged_paged_attention.py spec_anc / win_base): a query row's
// slot-order position is q_abs = q_start + qofs + r. The causal test, the
// sliding window and the walk's first tile all read that q_abs, as
// _rpa_kernel does (it tests the window against q_abs, not against the
// row's rope depth): tree node i of a request whose tree starts at b sees
// positions above b + i - window (Gemma-2's windowed layers), which may
// cut its own root. The table travels by value in the kernel's
// parameters, so it needs no device buffer. W == 0 is no tree: the launch
// picks each kernel's TREE = false instantiation, the code without any of
// this (the tree's registers and tests cost the others nothing). In the
// warpgroup kernel a packed row m = r * G + g takes query row r's mask,
// each lane computing its two rows' masks once; a tile that meets the
// window takes the mask pass, whatever else it skips. Masked scores are
// NEG_INF (finite) as the others, so p = 0 exactly, and no row's max meets
// NEG_INF - NEG_INF as a NaN: every row sees itself.
//
// ALiBi (the ALIBI instantiations of both kernels, in the aligned
// head_dim-128 build only: Baichuan2-13B): every score takes -slopes[hq] *
// (q_abs - pos) in float32 after the scale and the softcap, before the
// masks and the running max (rpa_common.cuh); a packed row m = r G + g
// reads the slope of head h G + g, each lane its two rows' once; the
// warpgroup kernel scales each dot before the bias, on every tile (p =
// 2^(v log2 e - m log2 e)). The entry launches them only when given slopes,
// never with a tree (no TREE x ALIBI instantiation); the ALIBI = false
// kernels hold no line of it.
//
// Both walk [lo, min(kv_len, the block's last row's position + 1)), lo from
// the window; entries launch in reverse in the warpgroup kernel (a
// request's later entries walk more positions: started first, they leave
// the short walks to the last, partial wave). A block writes ONLY the rows
// its entry owns (n_rows = min(q_len - qofs, EXTEND_QBLK); the TPU kernels
// wrote their whole block and relied on grid order for the next sequence to
// overwrite the overrun; blocks here run in parallel), the warpgroup kernel
// only its own heads; padding entries (block_seq == -1) write nothing, and
// a row that saw no position writes 0. Nothing reads a slot past kv_len:
// positions at or past the walk's end are zero-filled.
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

template <int D>
__host__ __device__ constexpr int ext_tk() { return D > 128 ? 16 : 32; }  // KV positions per tile
template <int D>
__host__ __device__ constexpr int ext_tpr() { return D / EXT_DPT; }  // threads per row
template <int D>
__host__ __device__ constexpr int ext_nt() { return EXTEND_QBLK * ext_tpr<D>(); }

template <typename TQ, typename TKV, int D, bool TREE, bool ALIBI>
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
                  float scale, float cap, int window,
                  const int* __restrict__ win_base,       // [B], read when tree.w > 0
                  const SpecTree tree,
                  const float* __restrict__ alibi) {      // [Hq] slopes (ALIBI)
  constexpr int TPR = ext_tpr<D>(), NT = ext_nt<D>(), TK = ext_tk<D>();
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
  const int wb = TREE ? win_base[b] : 0;
  const unsigned bits = TREE ? spec_bits(tree, q_abs - wb) : 0u;
  const float slope = ALIBI ? alibi[hq] : 0.f;
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
      const bool ok = pos < limit && pos <= q_abs && (window <= 0 || pos > q_abs - window) &&
                      (!TREE || spec_ok(tree, wb, bits, pos));
      float v = s[t] * scale;
      if (cap > 0.f) v = cap * tanhf(v / cap);
      if constexpr (ALIBI) v -= slope * static_cast<float>(q_abs - pos);
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

template <typename TQ, typename TKV, int D, bool TREE, bool ALIBI>
static int launch_extend(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                         const void* kv_lens, const void* q_lens, const void* q_start,
                         const void* block_seq, const void* block_row, const void* block_qofs,
                         void* out, int NQB, int Hq, int Hkv, int row_stride, int maxP,
                         int page_size, float scale, float cap, int window,
                         const void* win_base, const SpecTree& tree, const void* alibi,
                         cudaStream_t stream) {
  rpa_extend_kernel<TQ, TKV, D, TREE, ALIBI><<<dim3(NQB, Hq), ext_nt<D>(), 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<TQ*>(out), Hq, Hkv, row_stride, maxP, page_size, scale, cap, window,
      static_cast<const int*>(win_base), tree, static_cast<const float*>(alibi));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The warpgroup kernel (every bf16-q pair). rpa_wgmma.cuh has the layout,
// the descriptors, the wgmma forms and the mbarrier ring. Its block shape
// per head_dim; the header comment says why each was chosen.

// head_dim 128 (the aligned build)
constexpr int WG_NCW = 2;              // consumer warpgroups of 64 packed rows (wgmma's M)
constexpr int WG_TK = 64;              // KV positions per tile: the N of S = Q K^T
constexpr int WG_STAGES = 4;           // KV tiles (K and V) in the ring
constexpr int WG_LAG = 2;              // fp8: tiles copied raw ahead of the one being widened
constexpr int WG_PRODUCER_REGS = 56;   // registers a thread after setmaxnreg, from the
constexpr int WG_CONSUMER_REGS = 224;  // launch's 65536 / WG_NT (168)
constexpr int WG_NT = 128 * (WG_NCW + 1);  // the consumers, then one producer warpgroup
constexpr int WG_ROWS = 64 * WG_NCW;       // packed rows per block
// head_dim 64 (the chunked and the merged build)
constexpr int WG64_NCW = 2;
constexpr int WG64_TK = 128;
constexpr int WG64_STAGES = 4;
constexpr int WG64_LAG = 2;
constexpr int WG64_PRODUCER_REGS = 56;
constexpr int WG64_CONSUMER_REGS = 224;
constexpr int WG64_NT = 128 * (WG64_NCW + 1);
constexpr int WG64_ROWS = 64 * WG64_NCW;
// head_dim 256 (the aligned _256 build): Q by descriptor
constexpr int WG256_NCW = 2;
constexpr int WG256_TK = 32;
constexpr int WG256_STAGES = 3;
constexpr int WG256_LAG = 2;
constexpr int WG256_PRODUCER_REGS = 56;
constexpr int WG256_CONSUMER_REGS = 224;
constexpr int WG256_NT = 128 * (WG256_NCW + 1);
constexpr int WG256_ROWS = 64 * WG256_NCW;

template <typename TKV, int D>
struct WgLayout {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  static constexpr bool D64 = D == 64;
  static constexpr bool QSS = D == 256;  // Q read by descriptor (wgmma's SS form)
  static constexpr int NCW = D64 ? WG64_NCW : QSS ? WG256_NCW : WG_NCW;
  static constexpr int NT = D64 ? WG64_NT : QSS ? WG256_NT : WG_NT;
  static constexpr int ROWS = D64 ? WG64_ROWS : QSS ? WG256_ROWS : WG_ROWS;
  static constexpr int TK = D64 ? WG64_TK : QSS ? WG256_TK : WG_TK;
  static constexpr int STAGES = D64 ? WG64_STAGES : QSS ? WG256_STAGES : WG_STAGES;
  static constexpr int LAG = D64 ? WG64_LAG : QSS ? WG256_LAG : WG_LAG;
  static constexpr int PRODUCER_REGS =
      D64 ? WG64_PRODUCER_REGS : QSS ? WG256_PRODUCER_REGS : WG_PRODUCER_REGS;
  static constexpr int CONSUMER_REGS =
      D64 ? WG64_CONSUMER_REGS : QSS ? WG256_CONSUMER_REGS : WG_CONSUMER_REGS;
  static constexpr int LAUNCH_REGS = 65536 / NT / 8 * 8;  // one block per SM
  static constexpr bool WIDEN = sizeof(TKV) == 1;  // fp8 KV: widened by the producer
  static constexpr int TILE = TK * D * 2;          // bytes of a K or a V tile (bf16, swizzled)
  static constexpr int STAGE = 2 * TILE;           // K, then V
  static constexpr int RAW = TK * D * 2;           // bytes of a raw fp8 K and V tile
  static constexpr int NRAW = WIDEN ? LAG + 1 : 0;  // raw tiles in flight
  static constexpr int RAW0 = STAGES * STAGE;
  static constexpr int Q0 = RAW0 + NRAW * RAW;     // Q (then O) staging
  static constexpr int QLD = D + 8;                // its row stride, padded for ldmatrix
  // QSS: swizzled like a KV tile (ROWS rows, D / 64 column blocks)
  static constexpr int QBYTES = QSS ? ROWS * D * 2 : ROWS * QLD * 2;
  static constexpr int BAR0 = Q0 + QBYTES;         // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR0 + 2 * STAGES * 8 + 1024;  // + the atoms' alignment
  static constexpr int VE = 16 / (int)sizeof(TKV);  // KV elements per 16-byte vector
  static constexpr int VPR = D / VE;                // vectors per K or V row
  static constexpr int VSTEP = 128 / VPR;           // rows between a producer thread's vectors
  static constexpr int NV = TK / VSTEP;             // of K (and of V) per producer thread
  static_assert(NT == 128 * (NCW + 1) && ROWS == 64 * NCW, "warpgroups");
  static_assert(VSTEP >= 1 && TK % VSTEP == 0 && TK % 16 == 0, "tile shape");
  static_assert(Q0 % 1024 == 0 && BAR0 % 8 == 0, "atoms and barriers aligned");
  static_assert(NCW * (CONSUMER_REGS - LAUNCH_REGS) <= LAUNCH_REGS - PRODUCER_REGS,
                "register moves");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <typename TKV, int D, bool P_SPLIT, bool TREE, bool ALIBI>
__global__ void __launch_bounds__(WgLayout<TKV, D>::NT, 1)
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
                        float scale, float cap, int window,
                        const int* __restrict__ win_base,     // [B], read when tree.w > 0
                        const SpecTree tree,
                        const float* __restrict__ alibi) {    // [Hq] slopes (ALIBI)
  using bf16 = __nv_bfloat16;
  using Lay = WgLayout<TKV, D>;
  constexpr int TK = Lay::TK, NS = Lay::STAGES, KS = D / 16, QV = D / 8, QLD = Lay::QLD;
  constexpr int NC = 128 * Lay::NCW;  // consumer threads; the producer's follow
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
  const int m_lo = slice * Lay::ROWS;  // the block's first packed row
  if (m_lo / G >= n_rows) return;      // none of the entry's rows is here
  const int row0 = block_row[i];
  const int q_abs_lo = q_start[b] + qofs;
  const int r_hi = min((m_lo + Lay::ROWS - 1) / G, n_rows - 1);
  const int limit = min(min(kv_lens[b], q_abs_lo + r_hi + 1), maxP * page_size);
  const int lo = window > 0 ? max(q_abs_lo + m_lo / G - window + 1, 0) : 0;
  const int ntiles = limit > lo ? (limit - lo + TK - 1) / TK : 0;
  if (ntiles == 0) return;  // its rows see no position: they stay 0 (out is zero-filled)

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BAR0);
  uint64_t* empty = full + NS;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::mbar_init(full + s, 128);             // the producer's threads
      wg::mbar_init(empty + s, 4 * Lay::NCW);   // the consumers' warps
    }
    wg::mbar_init_fence();
  }
  // Q of the block's packed rows (zeros past n_rows), copied by the whole
  // block: in padded rows for ldmatrix, or with QSS swizzled for wgmma's
  // descriptor. q_off(m, c): the byte offset of row m's 16-byte chunk c
  // (the epilogue stages O there too)
  auto q_off = [](int m, int c) {
    return Lay::QSS ? wg::sw128(Lay::ROWS, m, c) : (m * QLD + c * 8) * 2;
  };
  unsigned char* sQ = smem + Lay::Q0;
  for (int v = tid; v < Lay::ROWS * QV; v += Lay::NT) {
    const int m = v / QV, c = v % QV;
    const int pm = m_lo + m, r = pm / G, g = pm - r * G;
    unsigned char* dst = sQ + q_off(m, c);
    if (r < n_rows)
      cp_async16(dst, q + ((int64_t)(row0 + r) * Hq + h * G + g) * D + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  // wgmma reads Q through the async proxy: the copies and stores are
  // fenced for it before the barrier hands Q over
  if constexpr (Lay::QSS) wg::fence_proxy_async();
  __syncthreads();
  const uint32_t s_smem = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  if (tid >= NC) {
    // ---- The producer warpgroup: keeps the ring full. Thread p copies
    // chunk vc of the rows vt0 + k VSTEP of K and, from the same slot, of V
    // (neighbouring threads copy neighbouring 16 bytes of a row; below
    // head_dim 256 VSTEP is a multiple of 8, so all of a thread's rows sit
    // at the same row of their swizzle atoms). Tile t goes to stage t % NS once the consumers have
    // released the tile before it there. bf16 KV is copied by cp.async
    // straight to its swizzled offsets, and the thread's arrival on full
    // fires when its copies land. fp8 KV is copied raw into one of NRAW raw
    // tiles; LAG tiles later the same thread (it reads only what it
    // copied) widens it into the stage and arrives. Zeros past the walk's
    // end, where nothing is read.
    wg::regs_dec<Lay::PRODUCER_REGS>();
    const int p = tid - NC;
    const int* pt_row = page_table + (int64_t)b * maxP;
    const TKV* kb = k_pool + (int64_t)h * D;
    const int64_t v_off = v_pool - k_pool;
    const int pshift = (page_size & (page_size - 1)) ? -1 : __ffs(page_size) - 1;
    const int pq = Lay::WIDEN ? wg::fp8_lane(p, Lay::VPR) : p;
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
        if (t >= NS) wg::mbar_wait(empty + t % NS, (t / NS - 1) & 1);
        unsigned char* st = smem + (t % NS) * Lay::STAGE;
#pragma unroll
        for (int k = 0; k < Lay::NV; ++k) {
          bool ok;
          const TKV* src = source(t, k, ok);
          const int off = wg::sw128(TK, vt0 + k * Lay::VSTEP, vc);
          cp_async16_zfill(st + off, src, ok);
          cp_async16_zfill(st + Lay::TILE + off, src + v_off, ok);
        }
        wg::mbar_arrive_cp_async(full + t % NS);
      }
    } else {
      uint4* raw = reinterpret_cast<uint4*>(smem + Lay::RAW0);
      for (int t = 0; t < ntiles + Lay::LAG; ++t) {
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
        const int u = t - Lay::LAG;
        if (u >= 0) {
          cp_async_wait<Lay::LAG>();  // the raw tile u has landed
          if (u >= NS) wg::mbar_wait(empty + u % NS, (u / NS - 1) & 1);
          unsigned char* st = smem + (u % NS) * Lay::STAGE;
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
          wg::mbar_arrive(full + u % NS);
        }
      }
    }
    cp_async_wait<0>();
  } else {
    // ---- The consumer warpgroups: warpgroup w (warps 4 w .. 4 w + 3) owns
    // the block's packed rows 64 w .. 64 w + 63, each warp 16 of them.
    wg::regs_inc<Lay::CONSUMER_REGS>();
    const int warp = tid / 32, lane = tid % 32;
    // the warp's A fragments of Q, by ldmatrix: wgmma's register A is
    // mma.sync's A fragment; with QSS, the warpgroup's 64 rows of the
    // swizzled Q tile, read by descriptor
    const int l7 = lane & 7, l8 = ((lane >> 3) & 1) * 8, l16 = ((lane >> 4) & 1) * 8;
    uint32_t qa[Lay::QSS ? 1 : KS][4];
    const uint32_t s_qwg = s_smem + Lay::Q0 + (warp / 4) * 64 * 128;
    if constexpr (!Lay::QSS) {
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
    // the tree: its window's start and this lane's two rows' ancestor masks
    const int wb = TREE ? win_base[b] : 0;
    unsigned sbits[2] = {0u, 0u};
    if constexpr (TREE) {
#pragma unroll
      for (int j = 0; j < 2; ++j) sbits[j] = spec_bits(tree, qpos[j] - wb);
    }
    // p = 2^(v c - m c): v the raw dot (c folds in the scale), or the capped
    // or ALiBi-biased score
    const bool capped = cap > 0.f;
    const float c = (capped || ALIBI) ? LOG2E : scale * LOG2E;
    // ALiBi: the slopes of this lane's two packed rows (query head h G + g
    // of row m = r G + g)
    float slope[2] = {0.f, 0.f};
    if constexpr (ALIBI) {
#pragma unroll
      for (int j = 0; j < 2; ++j) slope[j] = alibi[h * G + (m_lo + warp * 16 + gid + 8 * j) % G];
    }

    float sc[TK / 2], o[D / 2];        // S and O accumulators (rpa_wgmma.cuh's fragment)
    uint32_t pa[TK / 16][4];           // P of the previous tile: the A of its P V
    uint32_t pl[P_SPLIT ? TK / 16 : 1][4];  // with P_SPLIT, P's lo part (pa its hi)
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) sc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pl[P_SPLIT ? kk : 0][e] = 0u;
    float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

    // Iteration t waits for tile t, issues S_t = Q K_t^T (KS m64nTKk16, K
    // read K-major), then O += P_{t-1} V_{t-1} (TK / 16 m64nDk16, or twice
    // as many with P_SPLIT; P from registers; V read MN-major through the
    // transpose bit), waits for S_t alone and runs the softmax of tile t on
    // the CUDA cores while the tensor cores run P V; then waits for P V,
    // releases tile t - 1's stage, rescales O and packs P_t. Each warpgroup
    // walks every tile of [lo, limit) (wgmma is warpgroup-wide); a warp
    // whose rows see none of a tile masks all of it.
    for (int t = 0; t < ntiles; ++t) {
      const int st = lo + t * TK;
      wg::mbar_wait(full + t % NS, (t / NS) & 1);
      // the producer wrote the tile through the generic proxy (cp.async, or
      // the widening stores): fenced here, after the barrier, for wgmma's
      // async proxy. A fence in the producer would wait for its copies in
      // flight (fence.proxy.async includes a MEMBAR); here none are.
      wg::fence_proxy_async();
      const uint32_t sK = s_smem + (t % NS) * Lay::STAGE;
      // P V of tile t - 1; at t = 0, P = 0 times the (finite) K_0 tile, so
      // that no wgmma sits under a branch (ptxas then serializes them)
      const uint32_t sV = t > 0 ? s_smem + ((t - 1) % NS) * Lay::STAGE + Lay::TILE : sK;
      const bool masked = st + TK > limit || st + TK - 1 > wq_lo ||
                          (window > 0 && st <= wq_hi - window) ||
                          (TREE && st < wb + tree.w && st + TK > wb);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (Lay::QSS)
          wg::mma_ss<0>(sc, wg::desc_k(s_qwg, Lay::ROWS, ks), wg::desc_k(sK, TK, ks), ks);
        else
          wg::mma_rs<0>(sc, qa[ks], wg::desc_k(sK, TK, ks), ks);
      }
      wg::commit();
      // O += P V by k-step: P rounded to bf16 (pa), or with P_SPLIT its
      // bf16 parts, hi (pa) then lo (pl), two products against the same V
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wg::mma_rs<1>(o, pa[kk], wg::desc_mn(sV, TK, kk), 1);
        if constexpr (P_SPLIT) wg::mma_rs<1>(o, pl[kk], wg::desc_mn(sV, TK, kk), 1);
      }
      wg::commit();
      wg::wait<1>();  // S_t is done; P V may still run
      wg::fence_regs(sc);
      // softcap, mask and the row max (over the 4 lanes of a quad), each a
      // pass of its own: the two block-uniform branches taken once a tile,
      // not once a score (8% of the head_dim-64 kernel's time on the card)
      if constexpr (ALIBI) {  // scale, cap, then the bias of each score
#pragma unroll
        for (int e = 0; e < TK / 2; ++e) {
          const int rr = (e >> 1) & 1;
          const int pos = st + 8 * (e >> 2) + 2 * tig + (e & 1);
          const float v = capped ? cap * tanhf(sc[e] * scale / cap) : sc[e] * scale;
          sc[e] = v - slope[rr] * static_cast<float>(qpos[rr] - pos);
        }
      } else if (capped) {
#pragma unroll
        for (int e = 0; e < TK / 2; ++e) sc[e] = cap * tanhf(sc[e] * scale / cap);
      }
      if (masked) {
#pragma unroll
        for (int e = 0; e < TK / 2; ++e) {
          const int rr = (e >> 1) & 1;
          const int pos = st + 8 * (e >> 2) + 2 * tig + (e & 1);
          const bool ok = pos < limit && pos <= qpos[rr] &&
                          (window <= 0 || pos > qpos[rr] - window) &&
                          (!TREE || spec_ok(tree, wb, sbits[rr], pos));
          sc[e] = ok ? sc[e] : NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < TK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
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
      for (int kk = 0; kk < TK / 16; ++kk) {
        wg::fence_regs(pa[kk]);
        if constexpr (P_SPLIT) wg::fence_regs(pl[kk]);
      }
      if (t > 0 && lane == 0) wg::mbar_arrive(empty + (t - 1) % NS);
      // O's rescale, unless no row max of the warp moved (corr is then 1
      // exactly, the common case once the first tiles are in)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      }
      // P_t as the register A of each k-step of 16 positions: rounded to
      // bf16 as the TPU casts p to V's dtype, or hi + lo (P kept float32)
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
          if constexpr (P_SPLIT)
            split_bf16_trunc(sc[x], sc[x + 1], pa[kk][e], pl[kk][e]);
          else
            pa[kk][e] = pack_bf16(sc[x], sc[x + 1]);
        }
    }
    // the last tile's P V (its stage is not refilled: no release)
    {
      const uint32_t sV = s_smem + ((ntiles - 1) % NS) * Lay::STAGE + Lay::TILE;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wg::mma_rs<1>(o, pa[kk], wg::desc_mn(sV, TK, kk), 1);
        if constexpr (P_SPLIT) wg::mma_rs<1>(o, pl[kk], wg::desc_mn(sV, TK, kk), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(o);
    }

    // Epilogue: O / l (0 for a row that saw no position) staged per warp in
    // the Q staging (each warp its own 16 rows, which no other warp reads:
    // with QSS its own swizzled Q rows, whose last reader, the warpgroup's
    // last S, is done), then written as 16-byte vectors to the rows the
    // entry owns
    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = lrow[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[rr] = l > 0.f ? 1.f / l : 0.f;
    }
    const int mw = warp * 16;  // the warp's first row of the staging
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<uint32_t*>(sQ + q_off(mw + gid, d) + 4 * tig) =
          pack_bf16(o[4 * d] * inv[0], o[4 * d + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sQ + q_off(mw + gid + 8, d) + 4 * tig) =
          pack_bf16(o[4 * d + 2] * inv[1], o[4 * d + 3] * inv[1]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 16 * QV / 32; ++k) {
      const int v = lane + k * 32, m = v / QV, cc = v % QV;
      const int pm = m_lo + mw + m, r = pm / G, g = pm - r * G;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + ((int64_t)(row0 + r) * Hq + h * G + g) * D + cc * 8) =
            *reinterpret_cast<const uint4*>(sQ + q_off(mw + m, cc));
    }
  }
}

template <typename TKV, int D, bool P_SPLIT, bool TREE, bool ALIBI>
static int launch_extend_wgmma(const void* q, const void* k_pool, const void* v_pool,
                               const void* pt, const void* kv_lens, const void* q_lens,
                               const void* q_start, const void* block_seq, const void* block_row,
                               const void* block_qofs, void* out, int NQB, int Hq, int Hkv,
                               int row_stride, int maxP, int page_size, float scale, float cap,
                               int window, const void* win_base, const SpecTree& tree,
                               const void* alibi, cudaStream_t stream) {
  using Lay = WgLayout<TKV, D>;
  const cudaError_t attr = cudaFuncSetAttribute(rpa_extend_wgmma_kernel<TKV, D, P_SPLIT, TREE, ALIBI>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                Lay::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // setmaxnreg.inc waits until the producer has given its registers back:
  // launched with fewer than the moves need, the consumers would wait for
  // ever, so such a build is refused instead
  static const int launch_regs = [] {
    cudaFuncAttributes fa{};
    return cudaFuncGetAttributes(&fa, rpa_extend_wgmma_kernel<TKV, D, P_SPLIT, TREE, ALIBI>) ==
                   cudaSuccess
               ? fa.numRegs
               : 0;
  }();
  if (Lay::NCW * (Lay::CONSUMER_REGS - launch_regs) > launch_regs - Lay::PRODUCER_REGS)
    return (int)cudaErrorLaunchOutOfResources;
  const int G = Hq / Hkv;
  const dim3 grid((EXTEND_QBLK * G + Lay::ROWS - 1) / Lay::ROWS, Hkv, NQB);
  rpa_extend_wgmma_kernel<TKV, D, P_SPLIT, TREE, ALIBI><<<grid, Lay::NT, Lay::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(q_start), static_cast<const int*>(block_seq),
      static_cast<const int*>(block_row), static_cast<const int*>(block_qofs),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, row_stride, maxP, page_size, scale, cap,
      window, static_cast<const int*>(win_base), tree, static_cast<const float*>(alibi));
  return (int)cudaGetLastError();
}

// bf16 q: the warpgroup kernel, with P split into hi + lo in the builds
// that keep P in float32 (-DRPA_P_F32: the merged build); float32 q: the
// CUDA-core kernel. Each in its TREE instantiation only with a tree, and in
// its ALIBI one only with slopes (never both), where this build has it
// (HAS_ALIBI), else refused.
template <typename TQ, typename TKV, int D, bool ALIBI>
static int launch(const void* q, const void* k_pool, const void* v_pool, const void* pt,
                  const void* kv_lens, const void* q_lens, const void* q_start,
                  const void* block_seq, const void* block_row, const void* block_qofs,
                  void* out, int NQB, int Hq, int Hkv, int row_stride, int maxP,
                  int page_size, float scale, float cap, int window, const void* win_base,
                  const SpecTree& tree, const void* alibi, cudaStream_t stream) {
#define RPA_EXT_ARGS                                                                     \
  q, k_pool, v_pool, pt, kv_lens, q_lens, q_start, block_seq, block_row, block_qofs, out, NQB, \
      Hq, Hkv, row_stride, maxP, page_size, scale, cap, window, win_base, tree, alibi, stream
  if constexpr (ALIBI && !HAS_ALIBI) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (tree.w > 0) {
      if constexpr (ALIBI)
        return (int)cudaErrorInvalidValue;
      else if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
        return launch_extend_wgmma<TKV, D, P_F32_BUILD, true, false>(RPA_EXT_ARGS);
      else
        return launch_extend<TQ, TKV, D, true, false>(RPA_EXT_ARGS);
    }
    if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
      return launch_extend_wgmma<TKV, D, P_F32_BUILD, false, ALIBI>(RPA_EXT_ARGS);
    else
      return launch_extend<TQ, TKV, D, false, ALIBI>(RPA_EXT_ARGS);
  }
#undef RPA_EXT_ARGS
}

}  // namespace rpa

// C entry point (bound with ctypes by ops/attention/ragged_paged_attention.py).
// k_pool / v_pool: K and V of the layer at slot 0; row_stride: elements
// from one slot to the next (rpa_common.cuh). q_type / kv_type: TypeCode.
// `out` must be zero-filled by the caller: rows no entry owns (bucket
// padding) are left untouched. cap <= 0: no softcap; window <= 0: no
// window. spec_w: the speculation tree's node count (0: no tree), spec_anc
// its masks in HOST memory (spec_w of them, copied here into the kernel's
// parameters), win_base its window start per request on the card. Returns
// cudaError_t; a head_dim or type pair this build lacks, or a tree of more
// than SPEC_MAX_NODES nodes, is cudaErrorInvalidValue. alibi_slopes: null,
// or ALiBi's slopes (float32 [Hq] on the card), which the aligned
// head_dim-128 build alone takes, and without a tree.
extern "C" int RPA_ENTRY(const void* q, const void* k_pool, const void* v_pool,
                                const void* page_table, const void* kv_lens, const void* q_lens,
                                const void* q_start, const void* block_seq,
                                const void* block_row, const void* block_qofs, void* out,
                                int NQB, int Hq, int Hkv, int D, int row_stride, int maxP,
                                int page_size, float scale, float cap, int window, int q_type,
                                int kv_type, int spec_w, const void* spec_anc,
                                const void* win_base, const void* alibi_slopes,
                                void* stream) {
  using namespace rpa;
  if (NQB == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || D != RPA_HEAD_DIM) return (int)cudaErrorInvalidValue;
  SpecTree tree;
  if (!spec_tree_from(spec_w, spec_anc, win_base, tree)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_EXT(QC, TQ, KC, TKV)                                                             \
  if (q_type == QC && kv_type == KC)                                                         \
    return (alibi_slopes ? launch<TQ, TKV, RPA_HEAD_DIM, true>                                 \
                         : launch<TQ, TKV, RPA_HEAD_DIM, false>)(                              \
        q, k_pool, v_pool, page_table, kv_lens, q_lens, q_start, block_seq, block_row,         \
        block_qofs, out, NQB, Hq, Hkv, row_stride, maxP, page_size, scale, cap, window,        \
        win_base, tree, alibi_slopes, s);
  RPA_FOR_EACH_PAIR(RPA_EXT)
#undef RPA_EXT
  return (int)cudaErrorInvalidValue;
}
