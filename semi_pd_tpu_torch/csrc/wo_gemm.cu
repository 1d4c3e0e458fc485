// Weight-only dequant GEMM for Hopper (sm_90a): y[T, N] = x[T, K] (bf16) @ dequant(W[K, N]).
//
// Replaces no Pallas kernel. The JAX package's quantized linears are XLA ops
// (semi_pd_tpu/layers/linear.py:30-63 apply_linear / _awq_int4_matmul,
// semi_pd_tpu/ops/quant/fp8.py:53-64 blockwise_fp8_matmul, ops/moe.py:75-88
// expert_weights), whose fp8 / int8 -> bf16 convert and scale XLA folds into
// the matmul's operand read, so no dequantized weight reaches device memory.
// A PyTorch translation (x @ w.to(bf16) * ws) writes a bf16 copy on every
// call; this kernel is the counterpart of that fusion: each weight tile is
// widened to bf16 in shared memory on its way to the tensor cores.
//
// Four kernels, one template (semi_pd_tpu_torch/ops/quant/wo_gemm.py):
//   PER_CHANNEL (wo_gemm)        fp8 e4m3 or int8 w, ws [N]: float32 sum, x ws, cast
//   BLOCK       (wo_gemm_block)  fp8 e4m3 w, ws [ceil(K/128), ceil(N/128)]:
//                                bf16(w * s) on the tile (a 64 x 64 tile has one s)
//   AWQ         (wo_gemm_awq)    int8 w in 0..15, ws / wz [K/g, N]: bf16((w - z) * s);
//                                a group of a multiple of 64 rows (AWQ's 128) gives a
//                                K tile one scale and zero a column, read once a tile
//   EXPERTS     (wo_gemm_experts) fp8 or int8 w [E, K, N], ws [E, N], rows sorted by
//                                expert with the groups' cumulative ends on the device:
//                                bf16(w * s) on the tile; a block per (N tile, expert),
//                                an empty group exits at once
// Each product w x x runs on mma.sync m16n8k16 (bf16 in, float32 accumulate),
// with the JAX order of roundings: the per-channel scale after the float32 sum;
// the block, AWQ and expert scales on the weight, rounded to bf16 before the
// product.
//
// Bound. A decode step's product (T <= 64 rows) reads the whole weight once
// for a few rows: it is bound by the weight's bytes (Meta-Llama-3-8B's fp8
// gate_up, 4096 x 28672 = 117.4 MB: 0.035 ms at 3.35 TB/s). A 4096-row
// extend is bound by operations (2 x 4096 x 4096 x 28672 = 962 GFLOP: 0.97 ms
// at 989 TFLOP/s of bf16). The design: 128 threads a block, a 64 x 64 output
// tile (each warp 64 rows x 16 columns, so each weight element is widened
// once a block), K in steps of 64 through a 4-stage cp.async ring (x and the
// weight's bytes, zero-filled past every tail of T, K and N); where the
// output tiles give fewer than two blocks an SM (decode), K is split over
// blocks (gridDim.z) into float32 partials, which wo_reduce_kernel sums in
// split order and finishes (scale, cast), so results repeat bit for bit.
// The wrapper passes vec = 1 when N % 16 == 0, K % 8 == 0 and both pointers
// are 16-byte aligned (16-byte cp.async); otherwise the tiles are loaded
// element by element.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int XS = BK + 8;        // x tile row stride, bf16 (144 bytes: no bank conflicts)
constexpr int WS = BN + 16;       // weight tile row stride, bytes
constexpr int X_STAGE = BM * XS;  // bf16 elements a stage
constexpr int W_STAGE = BK * WS;  // bytes a stage
constexpr int SMEM = STAGES * (X_STAGE * 2 + W_STAGE);
constexpr int SCALE_BLOCK = 128;  // blockwise fp8's block
constexpr int REDUCE_THREADS = 256;

enum Mode { PER_CHANNEL = 0, BLOCK = 1, AWQ = 2, EXPERTS = 3 };
enum WType { FP8_E4M3 = 0, INT8 = 1 };

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const float* ws;
  const int8_t* wz;
  const long long* ends;  // EXPERTS: cumulative row ends of the groups [E]
  __nv_bfloat16* y;
  float* partial;         // [splits, M, N] when splits > 1
  int M, N, K, E, group, splits;
};

template <int WT>
__device__ __forceinline__ float wval(uint8_t b) {
  if constexpr (WT == FP8_E4M3) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row_end) of x and the weight's rows [k0, k0 + BK) x columns
// [n0, n0 + BN) into one stage, zeros past every tail
template <bool VEC>
__device__ __forceinline__ void load_tile(const Params& p, const uint8_t* w, int row0,
                                          int row_end, int n0, int k0, __nv_bfloat16* xs,
                                          uint8_t* wsm) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {  // 16-byte chunks of x
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int row = row0 + r, k = k0 + kc;
      const bool ok = row < row_end && k < p.K;
      cp_async16(xs + r * XS + kc, ok ? p.x + (size_t)row * p.K + k : p.x, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {  // 16-byte chunks of the weight
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), nc = (c % (BN / 16)) * 16;
      const int k = k0 + r, n = n0 + nc;
      const bool ok = k < p.K && n < p.N;
      cp_async16(wsm + r * WS + nc, ok ? w + (size_t)k * p.N + n : w, ok);
    }
  } else {
    for (int c = tid; c < BM * BK; c += THREADS) {
      const int r = c / BK, kc = c % BK;
      const int row = row0 + r, k = k0 + kc;
      xs[r * XS + kc] = (row < row_end && k < p.K) ? p.x[(size_t)row * p.K + k]
                                                   : __float2bfloat16_rn(0.f);
    }
    for (int c = tid; c < BK * BN; c += THREADS) {
      const int r = c / BN, nc = c % BN;
      const int k = k0 + r, n = n0 + nc;
      wsm[r * WS + nc] = (k < p.K && n < p.N) ? w[(size_t)k * p.N + n] : 0;
    }
  }
}

// one stage: BK / 16 steps of mma over the warp's 64 rows x 16 columns
// ``col_scale`` / ``col_zero``: the thread's two columns' scale (EXPERTS;
// AWQ when ``tile_group``, the K tile inside one group) and zero (AWQ)
template <int MODE, int WT>
__device__ __forceinline__ void compute_stage(const Params& p, const __nv_bfloat16* xs,
                                              const uint8_t* wsm, int k0, int n0, int mt_count,
                                              float acc[4][2][4], float tile_scale,
                                              const float col_scale[2], const float col_zero[2],
                                              bool tile_group) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < mt_count) {
        const __nv_bfloat16* base = xs + (mt * 16 + g) * XS + kk + t * 2;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * XS);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * XS + 8);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int nl = warp * 16 + nt * 8 + g;  // the thread's column in the tile
      const int kl = kk + t * 2;              // its rows: kl, kl + 1, kl + 8, kl + 9
      const int koff[4] = {0, 1, 8, 9};
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = wval<WT>(wsm[(kl + koff[i]) * WS + nl]);
      if constexpr (MODE == BLOCK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] *= tile_scale;
      } else if constexpr (MODE == EXPERTS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] *= col_scale[nt];
      } else if constexpr (MODE == AWQ) {
        if (tile_group) {  // rows past K meet zero rows of x
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = (v[i] - col_zero[nt]) * col_scale[nt];
        } else {
          const int n = n0 + nl;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + kl + koff[i];
            if (n < p.N && k < p.K) {
              const size_t gi = (size_t)(k / p.group) * p.N + n;
              v[i] = (v[i] - static_cast<float>(p.wz[gi])) * p.ws[gi];
            } else {
              v[i] = 0.f;
            }
          }
        }
      }
      const uint32_t b0 = pack_bf16(v[0], v[1]);
      const uint32_t b1 = pack_bf16(v[2], v[3]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mt_count) mma16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ void store_pair(const Params& p, int row, int row_end, int n,
                                           float c0, float c1, int z) {
  if (row >= row_end || n >= p.N) return;
  const bool two = n + 1 < p.N;
  if (p.splits > 1) {
    float* dst = p.partial + ((size_t)z * p.M + row) * p.N + n;
    dst[0] = c0;
    if (two) dst[1] = c1;
    return;
  }
  if constexpr (MODE == PER_CHANNEL) {
    c0 *= p.ws[n];
    if (two) c1 *= p.ws[n + 1];
  }
  __nv_bfloat16* dst = p.y + (size_t)row * p.N + n;
  dst[0] = __float2bfloat16_rn(c0);
  if (two) dst[1] = __float2bfloat16_rn(c1);
}

template <int MODE, int WT, bool VEC>
__global__ void __launch_bounds__(THREADS) wo_gemm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* wsm = smem + STAGES * X_STAGE * 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (p.K + BK - 1) / BK;
  const uint8_t* w = p.w;
  int row_begin, row_end, kt0, kt1, z = 0;
  float col_scale[2] = {0.f, 0.f}, col_zero[2] = {0.f, 0.f};
  // AWQ: a group of a multiple of BK rows holds whole K tiles, whose scale
  // and zero each thread reads once a tile for its two columns
  const bool tile_group = MODE == AWQ && p.group % BK == 0;
  if constexpr (MODE == EXPERTS) {
    const int e = blockIdx.y;
    row_begin = e ? static_cast<int>(p.ends[e - 1]) : 0;
    row_end = static_cast<int>(p.ends[e]);
    if (row_begin >= row_end) return;  // an empty group
    w += (size_t)e * p.K * p.N;
    kt0 = 0;
    kt1 = k_tiles;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = n0 + warp * 16 + nt * 8 + g;
      col_scale[nt] = n < p.N ? p.ws[(size_t)e * p.N + n] : 0.f;
    }
  } else {
    row_begin = blockIdx.y * BM;
    row_end = min(p.M, row_begin + BM);
    z = blockIdx.z;
    const int per = (k_tiles + p.splits - 1) / p.splits;
    kt0 = z * per;
    kt1 = min(k_tiles, kt0 + per);
  }
  const int nk = kt1 - kt0;
  const int n_scale_blocks = (p.N + SCALE_BLOCK - 1) / SCALE_BLOCK;
  for (int row0 = row_begin; row0 < row_end; row0 += BM) {
    const int mt_count = (min(BM, row_end - row0) + 15) / 16;
    float acc[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_tile<VEC>(p, w, row0, row_end, n0, (kt0 + s) * BK, xs + s * X_STAGE,
                       wsm + s * W_STAGE);
      cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nxt = i + STAGES - 1;  // into the stage every thread finished last step
      if (nxt < nk) {
        const int sn = nxt % STAGES;
        load_tile<VEC>(p, w, row0, row_end, n0, (kt0 + nxt) * BK, xs + sn * X_STAGE,
                       wsm + sn * W_STAGE);
      }
      cp_async_commit();
      const int st = i % STAGES;
      const int k0 = (kt0 + i) * BK;
      float tile_scale = 1.f;
      if constexpr (MODE == BLOCK)
        tile_scale = p.ws[(size_t)(k0 / SCALE_BLOCK) * n_scale_blocks + n0 / SCALE_BLOCK];
      if (tile_group) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = n0 + warp * 16 + nt * 8 + g;
          const size_t gi = (size_t)(k0 / p.group) * p.N + n;
          col_scale[nt] = n < p.N ? p.ws[gi] : 0.f;
          col_zero[nt] = n < p.N ? static_cast<float>(p.wz[gi]) : 0.f;
        }
      }
      compute_stage<MODE, WT>(p, xs + st * X_STAGE, wsm + st * W_STAGE, k0, n0, mt_count, acc,
                              tile_scale, col_scale, col_zero, tile_group);
    }
    cp_async_wait<0>();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mt_count) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int row = row0 + mt * 16 + g;
        const int n = n0 + warp * 16 + nt * 8 + t * 2;
        store_pair<MODE>(p, row, row_end, n, acc[mt][nt][0], acc[mt][nt][1], z);
        store_pair<MODE>(p, row + 8, row_end, n, acc[mt][nt][2], acc[mt][nt][3], z);
      }
    }
    __syncthreads();  // the next row tile's prologue reuses the stages
  }
}

// the K splits' float32 partials summed in split order, then the epilogue
template <bool SCALE>
__global__ void wo_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ ws,
                                 __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  if (SCALE) s *= ws[i % N];
  y[i] = __float2bfloat16_rn(s);
}

template <int MODE, int WT, bool VEC>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(wo_gemm_kernel<MODE, WT, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

template <int MODE, int WT>
cudaError_t set_smem_both() {
  cudaError_t e = set_smem<MODE, WT, true>();
  return e != cudaSuccess ? e : set_smem<MODE, WT, false>();
}

// every instantiation's dynamic shared memory, once, at the entry's first
// call (never during a graph capture: a step's first call is eager)
cudaError_t set_smem_all() {
  cudaError_t e;
  if ((e = set_smem_both<PER_CHANNEL, FP8_E4M3>()) != cudaSuccess) return e;
  if ((e = set_smem_both<PER_CHANNEL, INT8>()) != cudaSuccess) return e;
  if ((e = set_smem_both<BLOCK, FP8_E4M3>()) != cudaSuccess) return e;
  if ((e = set_smem_both<AWQ, INT8>()) != cudaSuccess) return e;
  if ((e = set_smem_both<EXPERTS, FP8_E4M3>()) != cudaSuccess) return e;
  return set_smem_both<EXPERTS, INT8>();
}

template <int MODE, int WT>
void launch(const Params& p, int vec, dim3 grid, cudaStream_t st) {
  if (vec)
    wo_gemm_kernel<MODE, WT, true><<<grid, THREADS, SMEM, st>>>(p);
  else
    wo_gemm_kernel<MODE, WT, false><<<grid, THREADS, SMEM, st>>>(p);
}

}  // namespace

extern "C" int wo_gemm_launch(int mode, int wtype, const void* x, const void* w, const void* ws,
                              const void* wz, const void* ends, void* y, void* partial, int M,
                              int N, int K, int E, int group, int splits, int vec,
                              void* stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = set_smem_all();
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (mode == AWQ && group <= 0) ||
      (mode == EXPERTS && (E <= 0 || ends == nullptr)) || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.wz = static_cast<const int8_t*>(wz);
  p.ends = static_cast<const long long*>(ends);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.partial = static_cast<float*>(partial);
  p.M = M;
  p.N = N;
  p.K = K;
  p.E = E;
  p.group = group;
  p.splits = mode == EXPERTS ? 1 : splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + BN - 1) / BN;
  const dim3 grid = mode == EXPERTS ? dim3(n_tiles, E, 1)
                                    : dim3(n_tiles, (M + BM - 1) / BM, p.splits);
  const int key = mode * 2 + wtype;
  switch (key) {
    case PER_CHANNEL * 2 + FP8_E4M3: launch<PER_CHANNEL, FP8_E4M3>(p, vec, grid, st); break;
    case PER_CHANNEL * 2 + INT8: launch<PER_CHANNEL, INT8>(p, vec, grid, st); break;
    case BLOCK * 2 + FP8_E4M3: launch<BLOCK, FP8_E4M3>(p, vec, grid, st); break;
    case AWQ * 2 + INT8: launch<AWQ, INT8>(p, vec, grid, st); break;
    case EXPERTS * 2 + FP8_E4M3: launch<EXPERTS, FP8_E4M3>(p, vec, grid, st); break;
    case EXPERTS * 2 + INT8: launch<EXPERTS, INT8>(p, vec, grid, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const size_t total = (size_t)M * N;
  const unsigned blocks = static_cast<unsigned>((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  if (mode == PER_CHANNEL)
    wo_reduce_kernel<true><<<blocks, REDUCE_THREADS, 0, st>>>(p.partial, p.ws, p.y, M, N,
                                                              p.splits);
  else
    wo_reduce_kernel<false><<<blocks, REDUCE_THREADS, 0, st>>>(p.partial, p.ws, p.y, M, N,
                                                               p.splits);
  return static_cast<int>(cudaGetLastError());
}
