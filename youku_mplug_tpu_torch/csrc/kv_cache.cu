// Per-sample single-row write into the stacked int8 KV cache, fused with
// the row's quantization, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel youku_mplug_tpu/ops/kv_cache.py
// (_scatter_kernel, wrapper cache_scatter_write) together with the
// quantize_rows that feeds it in cache_write: one decode step's K|V rows
// [B, 2*n*d] (bf16, any row stride) are quantized per (sample, head of
// the 2n K and V heads) -- symmetric absmax over the head's d lanes,
// scale = max(amax, 1e-8) / 127, q = clamp(rint(x / scale), -127, 127) --
// and written in place at row idx[b] of layer lidx: the int8 lanes into
// kv [L, B, M, 2*n*d], the 2n fp32 scales into scale [L, B, M, 2*n].
// Every other row is left as it is.  The TPU kernel moved an aligned
// window of rows around idx[b] (a single row at a dynamic offset is not a
// legal TPU block); here each thread writes its own bytes, so only the
// new row is touched.
//
// Bit-exact with the plain version (quantize_rows + indexed assignment):
// the amax is a max (order-free), the division is IEEE (the build has no
// --use_fast_math, and x / scale is never turned into x * (1 / scale)),
// and rintf rounds half to even as torch.round and jnp.round do.
//
// What bounds it on the H100: it moves B * (2nd bf16 read + 2nd int8 and
// 2n fp32 written) bytes -- 256 KB at BloomZ-7B1's B 8, 2nd 8192 -- so
// it is bound by its launch and one round trip to memory.  One warp per
// (sample, head): the lanes read the head's d values with stride-32
// coalesced loads, reduce the absmax with shuffles, and write the int8
// lanes and (lane 0) the scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxPer = 4;  // values per lane: head dims up to 128

__global__ void __launch_bounds__(kWarps * 32)
quantize_scatter_kernel(const __nv_bfloat16* __restrict__ rows,
                        long long row_stride, int8_t* __restrict__ kv,
                        float* __restrict__ scale,
                        const int* __restrict__ idx, int lidx, int B, int M,
                        int n, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + warp;  // (sample, head of 2n)
  if (pair >= B * 2 * n) return;
  const int b = pair / (2 * n), g = pair % (2 * n);
  const int j = idx[b];
  if (j < 0 || j >= M) return;  // no such row: nothing is written

  const __nv_bfloat16* src = rows + b * row_stride + (long long)g * d;
  float x[kMaxPer];
  float amax = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int i = lane + 32 * t;
    x[t] = i < d ? __bfloat162float(src[i]) : 0.f;
    amax = fmaxf(amax, fabsf(x[t]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);

  const long long row = ((long long)lidx * B + b) * M + j;
  int8_t* dst = kv + row * (2LL * n * d) + (long long)g * d;
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int i = lane + 32 * t;
    if (i < d) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(x[t], s)), -127.f), 127.f);
      dst[i] = (int8_t)r;
    }
  }
  if (lane == 0) scale[row * (2LL * n) + g] = s;
}

}  // namespace

// C entry point (loaded with ctypes).  rows: [B, 2*n*d] bf16 with row
// stride row_stride (elements; the lanes contiguous); kv: contiguous int8
// [L, B, M, 2*n*d]; scale: contiguous fp32 [L, B, M, 2*n]; idx: int32 [B]
// on the device; d <= 128.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim past 128.
extern "C" int ymt_quantize_scatter_write(const void* rows,
                                          long long row_stride, void* kv,
                                          void* scale, const void* idx,
                                          int lidx, int B, int M, int n,
                                          int d, void* stream) {
  if (d <= 0 || d > 32 * kMaxPer) return (int)cudaErrorInvalidValue;
  const int pairs = B * 2 * n;
  const int blocks = (pairs + kWarps - 1) / kWarps;
  quantize_scatter_kernel<<<blocks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rows), row_stride,
      static_cast<int8_t*>(kv), static_cast<float*>(scale),
      static_cast<const int*>(idx), lidx, B, M, n, d);
  return (int)cudaGetLastError();
}
