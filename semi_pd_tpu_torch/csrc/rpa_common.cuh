// Shared pieces of the ragged paged attention kernels (rpa_decode.cu,
// rpa_extend.cu): element conversion and the staging of one KV tile of the
// chunked combined pool.
//
// Pool layout (semi_pd_tpu_torch/mem/pool.py): [L, S, CT, 128], one row of
// CT*128 elements per slot; in each row the K chunks of all KV heads come
// first, then the V chunks, so K of head h sits at element h*D of the row
// and V of head h at (Hkv + h)*D. Slot = page * page_size + offset, with
// the page read from the request's row of the page table.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rpa {

// Finite "minus infinity" of the online softmax, as in the TPU kernels: a
// running max that starts here never turns exp(m_old - m_new) into NaN.
constexpr float NEG_INF = -1e30f;

template <typename T> struct Vec;  // elements of T in one 16-byte vector
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P is rounded to the KV type before P.V, as the TPU kernels do (they cast
// p to the KV dtype for the MXU dot); a no-op for float32.
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<T>(p));
}

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

template <typename T> __device__ __forceinline__ uint4 pack(const float* in);
template <> __device__ __forceinline__ uint4 pack<float>(const float* in) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* in) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return v;
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
// and one KV head, K rows then V rows, spread over NT threads as 16-byte
// vectors (neighbouring threads read neighbouring vectors of a row). load()
// issues the global reads into registers, so the next tile can be in flight
// while the block computes on the current one; store() writes the tile to
// shared memory as float32. Positions at or past `limit` are NOT read: they
// stage as zeros, so the kernels never touch a slot past a request's kv_len.
template <typename T, int D, int TK, int NT>
struct KVTile {
  static constexpr int VE = Vec<T>::N;
  static constexpr int VPR = D / VE;         // vectors per head row
  static constexpr int NVEC = 2 * TK * VPR;  // K and V
  static constexpr int NV = (NVEC + NT - 1) / NT;
  uint4 r[NV];

  __device__ __forceinline__ void load(const T* __restrict__ pool,
                                       const int* __restrict__ pt_row, int page_size,
                                       int64_t row_stride, int k_off, int v_off,
                                       int start, int limit, int tid) {
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
          const T* src = pool + slot * row_stride + (comp ? v_off : k_off) + c * VE;
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
