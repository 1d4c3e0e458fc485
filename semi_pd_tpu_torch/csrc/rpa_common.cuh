// Shared pieces of the ragged paged attention kernels (rpa_decode.cu,
// rpa_extend.cu): element conversion, the (q, KV) type pairs and head_dim
// each build instantiates, and the staging of one KV tile of either pool.
//
// Both pools are addressed through two base pointers and one row stride:
// K of slot s and head h sits at k_pool + s * row_stride + h * D, V at
// v_pool + s * row_stride + h * D (semi_pd_tpu_torch/mem/pool.py).
//   chunked [L, S, CT, 128]: one row of CT*128 = 2*Hkv*D elements per slot,
//     K of all heads first, then V; v_pool = k_pool + Hkv*D, row_stride
//     = CT*128.
//   aligned [L, 2, S, Hkv, D]: K and V each in their own S x Hkv x D plane;
//     v_pool = k_pool + S*Hkv*D, row_stride = Hkv*D.
// Slot = page * page_size + offset, with the page read from the request's
// row of the page table.
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

// Element type codes of the C entry points (ops/attention/rpa_common.py
// TYPE_CODES).
enum TypeCode { F32 = 0, BF16 = 1, E4M3 = 2, E5M2 = 3 };

// What a build instantiates: the aligned pool's kernels (-DRPA_ALIGNED) take
// head_dim 128 with (q, KV) = (bf16, bf16), (f32, f32), (bf16, fp8 e4m3) and
// (bf16, fp8 e5m2); the chunked pool's take head_dim 64 with the first two.
// X(q code, q type, KV code, KV type).
#ifdef RPA_ALIGNED
#define RPA_HEAD_DIM 128
#define RPA_FOR_EACH_PAIR(X)                   \
  X(BF16, __nv_bfloat16, BF16, __nv_bfloat16)  \
  X(F32, float, F32, float)                    \
  X(BF16, __nv_bfloat16, E4M3, __nv_fp8_e4m3)  \
  X(BF16, __nv_bfloat16, E5M2, __nv_fp8_e5m2)
#else
#define RPA_HEAD_DIM 64
#define RPA_FOR_EACH_PAIR(X)                   \
  X(BF16, __nv_bfloat16, BF16, __nv_bfloat16)  \
  X(F32, float, F32, float)
#endif

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

// P is rounded to q's type before P.V, as the TPU kernels do: they upcast
// K and V to q's dtype (fp8 KV too) and cast p to that dtype for the MXU
// dot. A no-op for float32.
template <typename TQ> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<TQ>(p));
}

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

  __device__ __forceinline__ void load(const T* __restrict__ kb, int64_t v_off,
                                       const int* __restrict__ pt_row, int page_size,
                                       int64_t row_stride, int start, int limit, int tid) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * NT;
      r[k] = make_uint4(0u, 0u, 0u, 0u);
      if (v < NVEC) {
        const int comp = v / (TK * VPR);
        const int rem = v - comp * (TK * VPR);
        const int t = rem / VPR;
        const int c = rem - t * VPR;
        const int pos = start + t;
        if (pos < limit) {
          const int64_t slot =
              (int64_t)pt_row[pos / page_size] * page_size + pos % page_size;
          const T* src = kb + slot * row_stride + (comp ? v_off : 0) + c * VE;
          r[k] = __ldg(reinterpret_cast<const uint4*>(src));
        }
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
        const int comp = v / (TK * VPR);
        const int rem = v - comp * (TK * VPR);
        const int t = rem / VPR;
        const int c = rem - t * VPR;
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
