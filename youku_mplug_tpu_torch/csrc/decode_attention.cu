// Single-token decode attention over the stacked packed KV cache, for
// Hopper (sm_90a), bf16 cache, fp32 online softmax.
//
// Replaces the Pallas TPU kernel youku_mplug_tpu/ops/decode_attention.py
// (_kernel, wrapper decode_attention) for the bf16 cache without ALiBi.
// The cache is [L, B, M, 2*n*d] with each row = [K | V] lanes; the kernel
// reads layer `lidx` in place (no layer copy) and only the live keys
// valid_from[b] <= j <= cache_len[b] of each sample.  A sample with no
// live key gets zeros, as in the TPU kernel.
//
// What bounds it on the H100: decode attention does 2 FLOPs per cache
// byte, far below the ~295 FLOP/byte where bf16 tensor-core compute would
// be the limit, so it is bound by reading the live K/V rows from HBM (and,
// at the serving slice's small sizes, by latency).  The design reads each
// live row exactly once, skips dead rows instead of masking them, keeps
// every partial sum in registers, and gives each warp four independent
// rows per step so their loads are in flight together.
//
// Block: one (head, sample); 4 warps stride over the live keys; lane l
// owns head features 2l and 2l + 1.  Warps merge their partial softmax
// states through shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;  // head dim
constexpr int kWarps = 4;
constexpr int kRows = 4;  // keys per warp per step

__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_sb,
                   const __nv_bfloat16* __restrict__ ckv,
                   __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ cache_len,
                   const int* __restrict__ valid_from, int n, int M,
                   long long layer_offset, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nd = (long long)n * kD;
  const long long row_stride = 2 * nd;
  const __nv_bfloat16* base = ckv + layer_offset + (long long)b * M * row_stride;

  const float2 qf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      q + b * q_sb + h * kD + 2 * lane));
  const int lo = max(valid_from[b], 0);
  const int hi = min(cache_len[b], M - 1);

  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int j0 = lo + warp * kRows; j0 <= hi; j0 += kWarps * kRows) {
    float2 kf[kRows], vf[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int j = min(j0 + t, hi);
      const __nv_bfloat16* row = base + j * row_stride + h * kD + 2 * lane;
      kf[t] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
      vf[t] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(row + nd));
    }
    float s[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) s[t] = qf.x * kf[t].x + qf.y * kf[t].y;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (j0 + t > hi) break;
      const float x = s[t] * scale;
      const float m_new = fmaxf(m, x);
      const float alpha = __expf(m - m_new);
      const float p = __expf(x - m_new);
      l = l * alpha + p;
      a0 = a0 * alpha + p * vf[t].x;
      a1 = a1 * alpha + p * vf[t].y;
      m = m_new;
    }
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_a[kWarps][kD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_a[warp][2 * lane] = a0;
  sm_a[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float den = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_m[w] == -INFINITY) continue;  // warp saw no live key
      const float f = __expf(sm_m[w] - mx);
      den += sm_l[w] * f;
      o0 += sm_a[w][2 * lane] * f;
      o1 += sm_a[w][2 * lane + 1] * f;
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)b * nd + h * kD +
                                       2 * lane) =
        __floats2bfloat162_rn(o0 * inv, o1 * inv);
  }
}

}  // namespace

// C entry point (loaded with ctypes).  q: [B, n*64] bf16 with row stride
// q_sb (elements); ckv: contiguous [L, B, M, 2*n*64] bf16; out: contiguous
// [B, n*64] bf16; cache_len, valid_from: int32 [B] on the device;
// layer_offset = lidx * B * M * 2*n*64.  Returns cudaGetLastError().
extern "C" int ymt_decode_attention_bf16(const void* q, long long q_sb,
                                         const void* ckv, void* out,
                                         const void* cache_len,
                                         const void* valid_from, int B, int n,
                                         int M, long long layer_offset,
                                         float scale, void* stream) {
  dim3 grid(n, B);
  decode_attn_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), q_sb,
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(cache_len),
      static_cast<const int*>(valid_from), n, M, layer_offset, scale);
  return (int)cudaGetLastError();
}
