// Shared pieces of the ragged paged attention kernels (rpa_decode.cu,
// rpa_extend.cu, rpa_stream.cu): element conversion, the (q, KV) type pairs
// and head_dim each build instantiates, the staging of one KV tile of any
// pool, into registers or, for the streaming decode, through a ring of
// cp.async copies in shared memory, and the PTX of the tensor-core kernels
// (cp.async with zero fill, ldmatrix, mma.sync, the bf16 split of P).
//
// The pools are addressed through two base pointers and one row stride:
// K of slot s and head h sits at k_pool + s * row_stride + h * D, V at
// v_pool + s * row_stride + h * D (semi_pd_tpu_torch/mem/pool.py).
//   chunked [L, S, CT, 128]: one row of CT*128 = 2*Hkv*D elements per slot,
//     K of all heads first, then V; v_pool = k_pool + Hkv*D, row_stride
//     = CT*128.
//   5D [L, 2, S, Hkv, D] (the "aligned" layout, at head_dim 64, 128, 256):
//     K and V each in their own S x Hkv x D plane; v_pool = k_pool +
//     S*Hkv*D, row_stride = Hkv*D.
// Slot = page * page_size + offset, with the page read from the request's
// row of the page table.
//
// Every build names its C entry point with -DRPA_ENTRY=<symbol> (the
// kernel's symbol in semi_pd_tpu_torch/kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rpa {

// Finite "minus infinity" of the online softmax, as in the TPU kernels: a
// running max that starts here never turns exp(m_old - m_new) into NaN.
constexpr float NEG_INF = -1e30f;
// log2(e): the tensor-core kernels take exp(x) as 2^(x log2 e).
constexpr float LOG2E = 1.4426950408889634f;

// Element type codes of the C entry points (ops/attention/rpa_common.py
// TYPE_CODES).
enum TypeCode { F32 = 0, BF16 = 1, E4M3 = 2, E5M2 = 3 };

// What a build instantiates: (q, KV) = (bf16, bf16), (f32, f32), (bf16,
// fp8 e4m3) and (bf16, fp8 e5m2), fp8 KV widened exactly to bf16, at the
// head_dim of its pool: 128 for the 5D pool's kernels (-DRPA_ALIGNED), or
// the RPA_HEAD_DIM the build sets (64 for the merged kernels, 256 for the
// _256 builds), and 64 for the chunked pool's. X(q code, q type, KV code,
// KV type).
#ifndef RPA_HEAD_DIM
#ifdef RPA_ALIGNED
#define RPA_HEAD_DIM 128
#else
#define RPA_HEAD_DIM 64
#endif
#endif
#define RPA_FOR_EACH_PAIR(X)                   \
  X(BF16, __nv_bfloat16, BF16, __nv_bfloat16)  \
  X(F32, float, F32, float)                    \
  X(BF16, __nv_bfloat16, E4M3, __nv_fp8_e4m3)  \
  X(BF16, __nv_bfloat16, E5M2, __nv_fp8_e5m2)

// ALiBi (Baichuan2-13B's position bias; the JAX reference's alibi_slopes,
// semi_pd_tpu/ops/attention/reference.py): the ALIBI instantiations of the
// decode and extend kernels, which their C entries launch when given the
// slopes (float32 [Hq] on the card; null: none). Query head hq's score of
// position pos, after the scale and the softcap and before the mask and
// the running max, is
//     score - slopes[hq] * (q_pos - pos)
// in float32, q_pos the query's position (kv_len - 1 in a decode). Only
// the 5D pool's head_dim-128 build instantiates them (rpa_decode_aligned,
// rpa_extend_aligned), without the speculation tree; every other build's
// entry refuses slopes, and its ALIBI = false kernels hold no line of it,
// so their registers and spills are those they had before.
#if defined(RPA_ALIGNED) && RPA_HEAD_DIM == 128 && !defined(RPA_P_F32)
constexpr bool HAS_ALIBI = true;
#else
constexpr bool HAS_ALIBI = false;
#endif

// The speculation tree of the extend kernels (rpa_extend.cu,
// rpa_extend_mla.cu): the TPU kernels' _spec_tree_mask (rpa_common.py). A
// query row at slot-order position q_abs sits at window offset q_abs -
// win_base[b]; a position inside the window [win_base[b], win_base[b] + W)
// stays visible only if its bit (position - win_base[b]) is set in that
// row's ancestor mask (0 for a row outside the window), and outside the
// window the causal mask stands. The table (at most SPEC_MAX_NODES masks)
// travels by value in the kernel's parameters; win_base is a device array
// [B]. w == 0 is no tree.
constexpr int SPEC_MAX_NODES = 31;  // speculative/tree.py MAX_TREE_NODES

struct SpecTree {
  int w;                         // window nodes; 0: no tree
  unsigned anc[SPEC_MAX_NODES];  // node i's ancestors (itself and the root included)
};

// The ancestor mask of a query row at window offset wq (0 outside the window)
__device__ __forceinline__ unsigned spec_bits(const SpecTree& tree, int wq) {
  return (wq >= 0 && wq < tree.w) ? tree.anc[wq] : 0u;
}

// Whether the tree leaves position pos visible to a row of mask bits (the
// window starting at wb): positions outside the window always
__device__ __forceinline__ bool spec_ok(const SpecTree& tree, int wb, unsigned bits, int pos) {
  const int wk = pos - wb;
  return wk < 0 || wk >= tree.w || ((bits >> wk) & 1u);
}

// The C entries' tree arguments (spec_w masks in HOST memory at spec_anc,
// win_base on the card) as the kernels' SpecTree; false for a tree of more
// than SPEC_MAX_NODES nodes or a missing array.
inline bool spec_tree_from(int spec_w, const void* spec_anc, const void* win_base,
                           SpecTree& tree) {
  if (spec_w < 0 || spec_w > SPEC_MAX_NODES || (spec_w > 0 && (!spec_anc || !win_base)))
    return false;
  tree = SpecTree{};
  tree.w = spec_w;
  for (int i = 0; i < spec_w; ++i) tree.anc[i] = static_cast<const unsigned*>(spec_anc)[i];
  return true;
}

template <typename T> struct Vec;  // elements of T in one 16-byte vector
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<__nv_fp8_e4m3> { static constexpr int N = 16; };
template <> struct Vec<__nv_fp8_e5m2> { static constexpr int N = 16; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P is rounded to q's type before P.V, as the GQA branches of the TPU
// kernels do: they upcast K and V to q's dtype (fp8 KV too) and cast p to
// that dtype for the MXU dot. A no-op for float32. Builds with -DRPA_P_F32
// keep P in float32, as the TPU kernels that upcast q, K and V to float32
// do: _rpa_kernel_merged, and the MLA branches of _rpa_kernel,
// _rpa_kernel_packed and _rpa_kernel_stream (every MLA build, and the
// merged builds).
// On the tensor cores (the extend's and the decode's bf16-q pairs) such a
// build splits P into two bf16 parts (split_bf16 below) where the others
// round it once.
#ifdef RPA_P_F32
constexpr bool P_F32_BUILD = true;
template <typename TQ> __device__ __forceinline__ float round_p(float p) { return p; }
#else
constexpr bool P_F32_BUILD = false;
template <typename TQ> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<TQ>(p));
}
#endif

// 16 bytes of T -> Vec<T>::N floats. fp8 widens exactly (every e4m3 and
// e5m2 value is a half, and every half a float).
template <typename T> __device__ __forceinline__ void unpack(const uint4& v, float* out);
template <> __device__ __forceinline__ void unpack<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <__nv_fp8_interpretation_t KIND>
__device__ __forceinline__ void unpack_fp8(const uint4& v, float* out) {
  const __nv_fp8x2_storage_t* p = reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p[i], KIND)));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <> __device__ __forceinline__ void unpack<__nv_fp8_e4m3>(const uint4& v, float* out) {
  unpack_fp8<__NV_E4M3>(v, out);
}
template <> __device__ __forceinline__ void unpack<__nv_fp8_e5m2>(const uint4& v, float* out) {
  unpack_fp8<__NV_E5M2>(v, out);
}

// Two floats -> one register of bf16 (lo in the low half), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats x -> their bf16 parts hi = bf16(x) and lo = bf16(x - hi),
// each packed as pack_bf16 packs them (x - hi is exact in float32). hi + lo
// is x to within 2^-18 |x|, so the two bf16 products hi.V + lo.V, summed in
// float32, give P.V with P kept in float32 (the -DRPA_P_F32 builds on the
// tensor cores), about 500 times below the bf16 step of the output.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// As split_bf16, but hi is x truncated to bf16 (its top 16 bits, taken by a
// byte permute) and only lo is converted: one conversion per pair where
// split_bf16 has two, for the warpgroup extend, whose softmax shares the
// conversions' pipe (4% of the merged build's time on the card). x - hi is
// exact in float32 and below 2^-7 |x|, so hi + lo is x to within 2^-15 |x|,
// still 128 times below the bf16 step of the output (2^-8 relative).
__device__ __forceinline__ void split_bf16_trunc(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632u);
  lo = pack_bf16(a - __uint_as_float(ua & 0xffff0000u), b - __uint_as_float(ub & 0xffff0000u));
}

// 16 fp8 values -> 16 bf16 (two 16-byte vectors), exactly: every e4m3 and
// e5m2 value is a bf16 value too.
template <typename T>
__device__ __forceinline__ void widen_bf16(const uint4& v, uint4& lo, uint4& hi) {
  float f[16];
  unpack<T>(v, f);
  lo = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                  pack_bf16(f[6], f[7]));
  hi = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]), pack_bf16(f[12], f[13]),
                  pack_bf16(f[14], f[15]));
}

// 8 fp8 values (8 bytes) -> 8 bf16 (one 16-byte vector), exactly: the low
// half of widen_bf16 (the compiler drops the unused high half).
template <typename T>
__device__ __forceinline__ uint4 widen8_bf16(const uint2& v) {
  uint4 lo, hi;
  widen_bf16<T>(make_uint4(v.x, v.y, 0u, 0u), lo, hi);
  return lo;
}

// 4 consecutive elements of q's type <-> float4: one 16-byte access for
// float32, one 8-byte access for bf16 (p 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared without registers (cp.async.cg: cached in L2
// only). A thread's copies complete for it at cp_async_wait<N>() once at
// most N of its committed groups are still pending.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Asks L2 for the 128-byte line at p (no registers, no wait).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// As cp_async16, but with ok false it reads nothing and fills the 16 bytes
// with zeros (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// Tensor-core pieces of the extend kernel (rpa_extend.cu) and of the
// decodes (rpa_decode_mma.cuh). ldmatrix: four 8x8 b16 matrices from
// shared memory (32-bit shared address s), lanes 8j .. 8j + 7 giving the
// row addresses of matrix j; thread l receives row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 of each (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// c[16 x 8] += a[16 x 16] . b[16 x 8]: bf16 operands, float32 accumulate.
// With g = lane / 4 and t = lane % 4: a = {(g, 2t), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8)}, each register two neighbouring columns; b = {(2t, g),
// (2t + 8, g)}, each two neighbouring rows; c = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[16 x 8] += a[16 x 8] . b[8 x 8], the same types: a = {(g, 2t), (g + 8,
// 2t)}, b = {(2t, g)}, each register two neighbouring elements; c as above.
__device__ __forceinline__ void mma_bf16_1688(float (&c)[4], const uint32_t (&a)[2],
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
// 2^x on the special-function unit (relative error ~2^-22; 0 far below).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile of TK consecutive KV positions [start, start + TK) of one request
// and one KV head, K rows then V rows (NCOMP 2), or the latent rows alone
// (NCOMP 1, the MLA pool: V is a prefix of K), spread over NT threads as
// 16-byte vectors (neighbouring threads read neighbouring vectors of a row). load()
// issues the global reads into registers, so the next tile can be in flight
// while the block computes on the current one; store() writes the tile to
// shared memory as float32. Positions at or past `limit` are NOT read: they
// stage as zeros, so the kernels never touch a slot past a request's kv_len.
// kb: K of this head at slot 0 (k_pool + h*D); V sits v_off elements after
// K (v_pool - k_pool). One base and one offset: a second base pointer cost
// the bf16 decode 14 registers and 22% at b64/kv1024 (PERF.md).
template <typename T, int D, int TK, int NT, int NCOMP = 2>
struct KVTile {
  static constexpr int VE = Vec<T>::N;
  static constexpr int VPR = D / VE;             // vectors per head row
  static constexpr int NVEC = NCOMP * TK * VPR;  // K and V, or the latent rows
  static constexpr int NV = (NVEC + NT - 1) / NT;
  uint4 r[NV];

  // Vector v of the tile: its component (K or V), position and 16-byte chunk.
  __device__ __forceinline__ static void locate(int v, int& comp, int& t, int& c) {
    comp = v / (TK * VPR);
    const int rem = v - comp * (TK * VPR);
    t = rem / VPR;
    c = rem - t * VPR;
  }

  __device__ __forceinline__ static const T* source(const T* __restrict__ kb, int64_t v_off,
                                                    const int* __restrict__ pt_row,
                                                    int page_size, int64_t row_stride,
                                                    int pos, int comp, int c) {
    const int64_t slot = (int64_t)pt_row[pos / page_size] * page_size + pos % page_size;
    return kb + slot * row_stride + (comp ? v_off : 0) + c * VE;
  }

  __device__ __forceinline__ void load(const T* __restrict__ kb, int64_t v_off,
                                       const int* __restrict__ pt_row, int page_size,
                                       int64_t row_stride, int start, int limit, int tid) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * NT;
      r[k] = make_uint4(0u, 0u, 0u, 0u);
      if (v < NVEC) {
        int comp, t, c;
        locate(v, comp, t, c);
        if (start + t < limit)
          r[k] = __ldg(reinterpret_cast<const uint4*>(
              source(kb, v_off, pt_row, page_size, row_stride, start + t, comp, c)));
      }
    }
  }

  // The streaming decode's ring (rpa_stream.cu): issue() copies the same
  // vectors as load() with cp.async into `stage` (NVEC raw 16-byte
  // vectors, vector v at stage[v]) instead of registers, reading nothing at
  // or past `limit`; take() later reads this thread's vectors back into r
  // (zeros at or past `limit`), so store() converts to float32 on the read
  // side. A thread takes exactly the vectors it issued, so a stage needs no
  // block barrier between its copies, its reads and its refill: the
  // thread's own cp_async_wait orders them.
  __device__ __forceinline__ void issue(const T* __restrict__ kb, int64_t v_off,
                                        const int* __restrict__ pt_row, int page_size,
                                        int64_t row_stride, int start, int limit, int tid,
                                        uint4* stage) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * NT;
      if (v < NVEC) {
        int comp, t, c;
        locate(v, comp, t, c);
        if (start + t < limit)
          cp_async16(stage + v,
                     source(kb, v_off, pt_row, page_size, row_stride, start + t, comp, c));
      }
    }
  }

  __device__ __forceinline__ void take(const uint4* stage, int start, int limit, int tid) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * NT;
      r[k] = make_uint4(0u, 0u, 0u, 0u);
      if (v < NVEC) {
        int comp, t, c;
        locate(v, comp, t, c);
        if (start + t < limit) r[k] = stage[v];
      }
    }
  }

  // LD: row stride of the shared tiles in floats (a multiple of 4)
  template <int LD>
  __device__ __forceinline__ void store(float* sK, float* sV, int tid) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * NT;
      if (v < NVEC) {
        int comp, t, c;
        locate(v, comp, t, c);
        float f[VE];
        unpack<T>(r[k], f);
        float4* dst = reinterpret_cast<float4*>((comp ? sV : sK) + t * LD + c * VE);
#pragma unroll
        for (int e = 0; e < VE / 4; ++e)
          dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
      }
    }
  }
};

}  // namespace rpa
