// Hopper (sm_90a) building blocks of the flash kernels (flash_fwd.cu,
// flash_bwd.cu): the asynchronous tile copies of their K/V (and Q/dO)
// ring, the 128-byte-swizzled shared-memory layout the tensor cores read,
// the wgmma matrix descriptors, and the warpgroup matrix products.
//
// Tiles.  Every operand tile is 64 rows of a [rows, D] bf16 matrix (D 64,
// 80, 96 or 128), kept D wide (WideTile below) by the forward and the
// backward alike: D / 64 panels of [64 rows][64 values] at d 64 and 128,
// and at 80 and 96 one such panel and a narrower tail panel.  A panel row
// is 128 bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8)
// (the "128B swizzle" of wgmma and TMA, so the eight rows a product reads
// together fall in different banks).  Each panel is 8 KB and 1024-byte
// aligned.  The same layout serves both ways a product reads a tile:
//   - K-major (the contracting dimension runs along the row): Q, K, V and
//     dO as the left operand or as the right operand of a score product
//     (S = Q K^T, dP = dO V^T);
//   - MN-major (the contracting dimension runs down the rows): V, K, Q
//     and dO as the right operand of P V, dS K, P^T dO and dS^T Q.
// Rows are copied with cp.async (16 bytes a thread, zero-filled past the
// sequence end), so a strided view (a row stride of 3 n d in a fused qkv
// projection) needs no tensor map and no copy.
//
// Products.  wgmma.mma_async with m64nNk16: one warpgroup (128 threads)
// multiplies a 64-row tile.  The fp32 accumulator of m64nN holds N / 2
// values a thread: value i of thread t is row (t / 32) * 16 + (t % 32) / 4
// + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) + i % 2.  That is
// also the layout of the register A operand (m64k16: four bf16x2 a
// thread), so a score accumulator converts in registers into the A
// operand of the next product (acc_to_a) and never visits shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ymt {

constexpr int kRows = 64;            // rows of every tile
constexpr int kThreads = 128;        // one warpgroup
constexpr int kPanel = 64 * 128;     // bytes of one [64][64] bf16 panel
constexpr int kMaxSmem = 232448;     // the H100's per-block opt-in limit
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// wgmma's shared-memory layout types (bits 62-63 of a descriptor): the
// 128-, 64- and 32-byte swizzles.
constexpr uint32_t kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of chunk c (8 values) of row r inside a swizzled panel of
// `row_bytes` (128, 64 or 32) a row: the swizzle of that width XORs the
// chunk index with bits 7 and up of the row's offset (r % 8 at 128 bytes,
// (r / 2) % 4 at 64, (r / 4) % 2 at 32), on a 1024-byte aligned panel.
__device__ __forceinline__ uint32_t swizzle(int r, int c,
                                            int row_bytes = 128) {
  return r * row_bytes +
         ((c ^ ((r * row_bytes >> 7) & (row_bytes / 16 - 1))) << 4);
}

// 16 bytes global -> shared, asynchronously; zeros when !pred (the source
// is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for this thread's copies of the oldest groups (all but N), make
// every thread's copies visible to the tensor cores' (async proxy) reads,
// and hold the block until all threads are there.
template <int N>
__device__ __forceinline__ void ring_arrive() {
  cp_async_wait<N>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Rows [row0, row0 + 64) of a [rows, D] bf16 matrix (D 64 or 128; row
// stride in elements, 16-byte aligned rows) into the D / 64 swizzled
// panels at `dst`; rows at or past `rows` read as zero (the zero-fill of
// cp.async: no global read).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows) {
  static_assert(D % 64 == 0, "whole panels only: see load_tile_wide");
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* g =
        ok ? src + (long long)(row0 + r) * row_stride + ch * 8 : src;
    cp_async16(dst + (ch / 8) * kPanel + swizzle(r, ch % 8), g, ok);
  }
}

// The D-wide tile.  At D = 64 and 128 it is the D / 64 panels
// of load_tile.  At D = 80 and 96 it is one panel for columns 0-63 and,
// right after it, a tail panel of [64 rows][D - 64 values] for the rest:
// 32-byte rows under the 32B swizzle at d 80, 64-byte rows under the 64B
// swizzle at d 96 (the swizzle of the row's width, which wgmma reads both
// K-major and MN-major), so no column past D is stored, copied or
// multiplied: 10 KB a tile at d 80, 12 KB at 96.
template <int D>
struct WideTile {
  static constexpr int kTail = D % 64;        // columns of the tail panel
  static constexpr int kTailRow = 2 * kTail;  // its bytes a row
  static constexpr int kBytes = kRows * 2 * D;
  static constexpr uint32_t kTailLayout = kTail == 16 ? kSwizzle32
                                                      : kSwizzle64;
  static_assert(kTail == 0 || kTail == 16 || kTail == 32,
                "a tail panel is 16 or 32 columns");
};

// Rows [row0, row0 + 64) of a [rows, D] bf16 matrix into a WideTile at
// `dst`; rows at or past `rows` read as zero.  The tail's chunks are
// copied as the panel's: 16 bytes a thread with cp.async.
template <int D>
__device__ __forceinline__ void load_tile_wide(uint32_t dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int row0,
                                               int rows) {
  using T = WideTile<D>;
  if constexpr (T::kTail == 0) {
    load_tile<D>(dst, src, row_stride, row0, rows);
  } else {
    load_tile<64>(dst, src, row_stride, row0, rows);
    constexpr int kChunks = T::kTail / 8;  // 2 or 4 a row
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / kChunks, ch = idx % kChunks;
      const bool ok = row0 + r < rows;
      const __nv_bfloat16* g =
          ok ? src + (long long)(row0 + r) * row_stride + 64 + ch * 8 : src;
      cp_async16(dst + kPanel + swizzle(r, ch, T::kTailRow), g, ok);
    }
  }
}

// 64 fp32 values [row0, row0 + 64) of a vector into shared memory; zeros
// past `rows`.
__device__ __forceinline__ void load_vec64(uint32_t dst, const float* src,
                                           int row0, int rows) {
  if (threadIdx.x < kRows) {
    const int r = row0 + threadIdx.x;
    cp_async4(dst + 4 * threadIdx.x, src + (r < rows ? r : 0), r < rows);
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout type (the 128-byte swizzle
// unless said).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t layout = kSwizzle128) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// K-major operand (a tile read along its rows), contraction step kk (16
// values): panel kk / 4, 32 bytes a step inside it; 8-row groups 1024
// bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kPanel + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (a tile read down its rows, its row values the output
// columns), contraction step kk (16 rows): 8-row groups 1024 bytes apart,
// 64-column panels kPanel apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, kPanel, 1024);
}

// K-major step kk (< D / 16) of a WideTile: steps 0-3 on the 128B panel
// as desc_k; at d 80 and 96 steps 4 and 5 on the tail panel, 32 bytes a
// step inside its rows, 8-row groups 8 tail rows apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k_wide(uint32_t tile, int kk) {
  using T = WideTile<D>;
  if (T::kTail == 0 || kk < 4) return desc_k(tile, kk);
  return make_desc(tile + kPanel + (kk - 4) * 32, 16, 8 * T::kTailRow,
                   T::kTailLayout);
}

// MN-major step kk (16 rows) of a WideTile's tail panel, its kTail values
// a row the output columns 64 .. D - 1 (one swizzle atom wide, so the
// leading offset, to a next atom along N, is never used).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_tail(uint32_t tile, int kk) {
  using T = WideTile<D>;
  return make_desc(tile + kPanel + kk * 16 * T::kTailRow,
                   kRows * T::kTailRow, 8 * T::kTailRow, T::kTailLayout);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across a wgmma
// fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator value i of this thread: its row (0..63) and column.
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) +
         ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator rounded to bf16 as the A operand of four
// m64k16 steps (columns 16 kk .. 16 kk + 15 for step kk).
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both K-major in shared memory
// (descriptors); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the m64k16
// fragment, four bf16x2 a thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (the m64k16
// fragment, four bf16x2 a thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x D] += A[64 x 16] B[16 x D] for D 80 and 96 on a WideTile: one
// asm statement issues m64n64k16 on the panel and m64n16k16 or m64n32k16 on
// the tail, A from registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, uint64_t dt) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %45, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "l"(dt), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t db, uint64_t dt) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %53, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "l"(dt), "r"(1));
}

// O[64 x D] += A[64 x 16] B[16 x D], contraction step kk (16 rows) of a
// WideTile read MN-major, at any of the four head dims (A in registers):
// one product at N = D over whole panels at d 64 and 128, the panel and
// tail products above at 80 and 96.
template <int D>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t tile, int kk) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, desc_mn(tile, kk));
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, desc_mn(tile, kk));
  } else if constexpr (D == 80) {
    wgmma_rs_n80(d, a, desc_mn(tile, kk), desc_mn_tail<D>(tile, kk));
  } else {
    wgmma_rs_n96(d, a, desc_mn(tile, kk), desc_mn_tail<D>(tile, kk));
  }
}

}  // namespace ymt
