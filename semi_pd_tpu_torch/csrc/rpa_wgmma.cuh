// Hopper's warpgroup tensor cores (wgmma) for the extend kernels
// (rpa_extend.cu's rpa_extend_wgmma_kernel, every GQA pool at head_dim 64,
// 128 and 256, and rpa_extend_mla.cu's rpa_extend_mla_wgmma_kernel, the latent
// pool): the 128-byte swizzled shared-memory layout, wgmma's matrix
// descriptors of it, the fences, and the wgmma.mma_async
// m64nNk16 bf16 x bf16 -> float32 forms the two kernels issue. sm_90a only
// (wgmma does not exist on plain sm_90).
//
// The layout. A tile of `rows` rows of 16-bit elements is stored as column
// blocks of 64 elements (one 128-byte row each), block after block, each
// block `rows` x 128 bytes; inside a block, the 16-byte chunk c of row r
// sits at chunk (c ^ (r % 8)) of its row (sw128 below). This is the layout
// a TMA tensor map with CU_TENSOR_MAP_SWIZZLE_128B writes and the one a
// descriptor with swizzle mode 1 (128 B) reads: the hardware XORs address
// bits 4-6 with bits 7-9, so every tile starts on a 1024-byte boundary (8
// rows of 128 bytes, one swizzle atom). The kernels fill their tiles with
// cp.async or st.shared at these offsets (a flat copy of a row-major page is
// not this layout), writes of the generic proxy, and a fence.proxy.async
// orders them before wgmma's reads through the async proxy: in the MLA
// kernel each writer runs it before the block barrier that hands the tile
// over, in the GQA kernel each consumer after the ring's full barrier
// (the fence includes a MEMBAR, which in the producer would wait for its
// copies in flight). One layout serves both operand forms:
//   K-major (the B of S = Q K^T, the tile's rows being KV positions and its
//     columns the head dims; the A of S from shared memory): 8-row groups
//     1024 bytes apart (SBO), a k-step of 16 elements 32 bytes further along
//     the row (the swizzle is a function of the address, so the step
//     stays inside the atom), the next 64 elements one column block on;
//   MN-major (V as the B of O += P V, read with the transpose bit: the rows
//     are positions, the K of that product, and N runs along the row):
//     8-position groups 1024 bytes apart (SBO), 64-element N blocks one
//     column block apart (LBO), a k-step 16 rows = 2048 bytes on.
// So V needs no transposition pass, and the MLA kernel reads one staged
// latent tile as K (all 576 columns) and as V (its first 512).
//
// Register fragments (per warp w of the warpgroup, lane = 4 g + t): the
// float32 accumulator of m64nNk16 holds d[4j + e] = row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + (e % 2); an A operand from registers holds, for its 16
// rows 16 w .. 16 w + 15, what mma.sync m16n8k16's A fragment holds. So the
// S accumulators of one k-step's 16 positions, packed to bf16 in pairs, are
// the A of O += P V directly.
//
// Ordering: wgmma.fence before each batch of wgmma that reads registers the
// thread wrote (the accumulators, A fragments); commit, then wait before
// touching them; fence_regs after the wait keeps the compiler from moving a
// read of an accumulator, or a reuse of an A fragment's register, above
// the wait (the asm does not tell it that wgmma runs asynchronously).
#pragma once

#include <type_traits>

#include "rpa_common.cuh"

namespace rpa {
namespace wg {

// Byte offset, in a tile of `rows` rows stored as above, of the 16-byte
// chunk c of row r (elements 8 c .. 8 c + 7 of the row).
__host__ __device__ constexpr int sw128(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The fp8 producer's thread map (rpa_extend.cu): with l = fp8_lane(p, vpr),
// producer thread p copies and widens the 16-byte raw vector l % vpr of
// the rows l / vpr + k 128 / vpr of a tile, each into two bf16 chunks
// (vpr: raw vectors per row). At vpr 8 (head_dim 128) a quarter warp
// would hold one row, whose chunks 2 c of both column blocks share banks
// after the swizzle: swapping bits 2 and 3 of p puts the next row, of the
// other swizzle phase, in lanes 4-7. At vpr 4 (head_dim 64) a quarter warp
// already holds two neighbouring rows, and the swap would give it rows r
// and r + 2, a 2-way conflict: the map is p.
__host__ __device__ constexpr int fp8_lane(int p, int vpr) {
  return p ^ (12 * (((p >> 2) ^ (p >> 3)) & 1) * (vpr == 8));
}

// The slot of position pos through a request's page-table row. The page is
// a shift where page_size is a power of two (pshift >= 0): a block-uniform
// branch, so that the division is not evaluated beside it on the copy path,
// where the tiles' address arithmetic is most of the instructions.
__device__ __forceinline__ int64_t slot_of(const int* __restrict__ pt_row, int pos,
                                           int page_size, int pshift) {
  int page, off;
  if (pshift >= 0) {
    page = pos >> pshift;
    off = pos & (page_size - 1);
  } else {
    page = pos / page_size;
    off = pos - page * page_size;
  }
  return (int64_t)pt_row[page] * page_size + off;
}

// 16 fp8 values (e4m3 or e5m2) -> 16 bf16, exactly (widen_bf16's result),
// with half of widen_bf16's conversion instructions, whose pipe the
// softmax's exp2 shares: an fp8 value has at most 4 significant bits, so
// its bf16 is the top half of its float32 (a byte permute where widen_bf16
// rounds), and e5m2 is the top byte of an f16 (a byte permute where
// widen_bf16 converts); e4m3 takes one cvt per pair to f16. The f16 pairs
// widen to float32 exactly. (Building e4m3's f16 bits with integer
// operations and an f16 multiply instead of the cvt ran slower on the
// card.)
template <typename T>
__device__ __forceinline__ void widen_fp8(const uint4& v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // bytes 2 j and 2 j + 1 of w[i]
      uint32_t h;
      if constexpr (std::is_same<T, __nv_fp8_e5m2>::value) {
        h = __byte_perm(w[i], 0u, j ? 0x3424u : 0x1404u);
      } else {
        const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * j)), __NV_E4M3);
        h = static_cast<uint32_t>(hr.x) | (static_cast<uint32_t>(hr.y) << 16);
      }
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
      r[2 * i + j] = __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632u);
    }
  }
  lo = make_uint4(r[0], r[1], r[2], r[3]);
  hi = make_uint4(r[4], r[5], r[6], r[7]);
}

// The first 1024-byte boundary at or after p in shared memory.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (s & 1023u)) & 1023u);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units, bits 0-13, 16-29, 32-45), base offset
// 0 (atoms are 1024-byte aligned), swizzle mode 1 = 128 B (bits 62-63).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand of a tile of `rows` rows at shared address `tile`, k-step
// ks (elements 16 ks .. 16 ks + 15 of each row); LBO is not used.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int ks) {
  return desc128(tile + (ks >> 2) * rows * 128 + (ks & 3) * 32, 16, 1024);
}
// MN-major operand (transpose bit set) of a tile of `rows` rows, k-step kk
// (rows 16 kk .. 16 kk + 15), N from the tile's first column block on.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return desc128(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory (st.shared,
// completed cp.async) before later async-proxy reads (wgmma) of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The mbarrier ring between a producer warpgroup, which fills shared-memory
// stages, and consumer warpgroups: stage s has a "full" barrier (each of the
// producer's threads arrives once its part of the tile has landed) and an
// "empty" one (each consumer warp arrives once its
// wgmma reads of the stage are done). The k-th use of stage s (k = 0, 1,
// ...) completes phase k of each; a thread waits for that phase by its
// parity k & 1, and is never more than one phase behind.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
               "r"(count)
               : "memory");
}
// Makes the initialized barriers visible before any thread uses them
// (followed by a block barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}
// Arrives on bar once all of this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(parity)
      : "memory");
}
// Moves registers between warpgroups (all four warps of one execute it):
// the producer gives registers back, the consumers take them.
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[64 x N] (+)= a[64 x 16] . b[16 x N], bf16 operands, float32 accumulate;
// scale_d 0 overwrites d. mma_rs: A from registers (the fragment above),
// B by descriptor; mma_ss: A and B by descriptor (A K-major). TRANS_B 0:
// B K-major; 1: B MN-major. The forms the kernels issue: N 64, 128 and, at
// head_dim 256, 32 (S, mma_ss) and 256 (P V) (rpa_extend_wgmma_kernel),
// 48 and 256 (rpa_extend_mla_wgmma_kernel).
template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TRANS_B), "r"(scale_d));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TRANS_B), "r"(scale_d));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TRANS_B), "r"(scale_d));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %19, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %18;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "n"(TRANS_B), "r"(scale_d));
}

template <int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %27, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "n"(TRANS_B), "r"(scale_d));
}

}  // namespace wg
}  // namespace rpa
