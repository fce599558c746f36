// Single-token decode attention over the stacked packed KV cache, for
// Hopper (sm_90a), bf16 or int8 cache, fp32 online softmax, head dim 64 or
// 128, optionally with the ALiBi bias of the Bloom decoder.
//
// Replaces the Pallas TPU kernel youku_mplug_tpu/ops/decode_attention.py
// (_kernel, wrapper decode_attention) for the bf16 cache and for the int8
// cache with per-(token, head) scales (quantized=True), each with and
// without its ALiBi ladder.  The cache is [L, B, M, 2*n*d] with each row
// = [K | V] lanes; the kernel reads layer `lidx` in place (no layer copy)
// and only the live keys valid_from[b] <= j <= cache_len[b] of each
// sample.  A sample with no live key gets zeros, as in the TPU kernel.
//
// ALiBi: score = scale * q.k + slope_h * j, j the absolute key position,
// added after the scale and before the running max, all in fp32 (the
// bias reaches a few hundred at M = 256).  The slope ladder is generated
// from the head index as the TPU kernel does (decode_attention.py:
// 104-110): 2^(-8(h+1)/c) for the first c heads, c the largest power of
// two <= n, then the half-step ladder 2^(-4(2(h-c)+1)/c); the wrapper
// checks that the caller's slopes are that ladder.
//
// What bounds it on the H100: decode attention does 2 FLOPs per cache
// byte, far below the ~295 FLOP/byte where bf16 tensor-core compute would
// be the limit, so it is bound by reading the live K/V rows from HBM (and,
// at the serving sizes, by latency).  The design reads each live row
// exactly once, skips dead rows instead of masking them, keeps every
// partial sum in registers, and gives each warp four independent rows per
// step so their K and V loads are in flight together and the running
// softmax rescales once per step.
//
// int8 cache: the rows hold int8 lanes and a second array [L, B, M, 2*n]
// holds one fp32 scale per (row, head of the 2n K and V heads), with its
// own layer offset.  The dequant follows the TPU kernel's order
// (decode_attention.py:123-142): score = (q . k_int8) * scale *
// k_scale[j, h], the ALiBi bias added after the K scale; l sums the
// unscaled p; the accumulator takes (p * v_scale[j, h]) * v_int8.  The
// rows never expand to a float copy in memory: an int8 row moves half the
// bytes of a bf16 one, plus 8 bytes of scales per (row, head).
//
// Block: one (head, sample); 4 warps stride over the live keys; lane l
// owns head features kPer*l .. kPer*l + kPer - 1 (kPer = D / 32: two at
// d = 64, four at d = 128, read as one 4- or 8-byte load; int8: one 2- or
// 4-byte load).  Warps merge
// their partial softmax states through shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;  // keys per warp per step

// kPer consecutive bf16 values at p (aligned to 2 * kPer bytes) -> fp32
template <int kPer>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (kPer == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  } else {
    static_assert(kPer == 4, "head dim 64 or 128");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  }
}

// kPer consecutive int8 values at p (aligned to kPer bytes) -> fp32
template <int kPer>
__device__ __forceinline__ void load_row(const int8_t* p, float* out) {
  if constexpr (kPer == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x;
    out[1] = c.y;
  } else {
    static_assert(kPer == 4, "head dim 64 or 128");
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x;
    out[1] = c.y;
    out[2] = c.z;
    out[3] = c.w;
  }
}

template <int kPer>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
  if constexpr (kPer == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(v[0], v[1]),
                              __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(pair);
  }
}

// the standard ALiBi slope of head h of n (models/bloom.py alibi_slopes)
__device__ __forceinline__ float alibi_slope(int h, int n) {
  int c = 1;
  while (2 * c <= n) c *= 2;
  const float e = h < c ? -8.f * (h + 1) / c : -4.f * (2 * (h - c) + 1) / c;
  return exp2f(e);
}

template <int D, bool kAlibi, bool kInt8>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_sb,
                   long long q_sh, const void* __restrict__ ckv,
                   const float* __restrict__ kv_scales,
                   __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ cache_len,
                   const int* __restrict__ valid_from, int n, int M,
                   long long layer_offset, long long scale_layer_offset,
                   float scale) {
  using T = std::conditional_t<kInt8, int8_t, __nv_bfloat16>;
  constexpr int kPer = D / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nd = (long long)n * D;
  const long long row_stride = 2 * nd;
  const T* base = static_cast<const T*>(ckv) + layer_offset +
                  (long long)b * M * row_stride;
  // the (row, head) scales of sample b: K at column h, V at n + h
  const float* sc = kInt8 ? kv_scales + scale_layer_offset +
                                (long long)b * M * 2 * n + h
                          : nullptr;

  float qf[kPer];
  load_row<kPer>(q + b * q_sb + h * q_sh + kPer * lane, qf);
  const float slope = kAlibi ? alibi_slope(h, n) : 0.f;
  const int lo = max(valid_from[b], 0);
  const int hi = min(cache_len[b], M - 1);

  float m = -INFINITY, l = 0.f, acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int j0 = lo + warp * kRows; j0 <= hi; j0 += kWarps * kRows) {
    // all K and V loads of the step first (rows past hi re-read row hi
    // and are masked below), so their latencies overlap
    float kf[kRows][kPer], vf[kRows][kPer], ks[kRows], vs[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int j = min(j0 + t, hi);
      const T* row = base + j * row_stride + h * D + kPer * lane;
      load_row<kPer>(row, kf[t]);
      load_row<kPer>(row + nd, vf[t]);
      if (kInt8) {
        ks[t] = sc[(long long)j * 2 * n];
        vs[t] = sc[(long long)j * 2 * n + n];
      }
    }
    float s[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      s[t] = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[t] += qf[i] * kf[t][i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
      }
    }
    // one online-softmax update per step: rows past hi score -inf (no
    // branch, so the compiler keeps the V loads above instead of sinking
    // each behind an exit test); row j0 <= hi is live, so m_new is finite
    float x[kRows], m_new = m;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      float st = s[t] * scale;
      if (kInt8) st *= ks[t];  // K dequant, before the bias
      x[t] = j0 + t <= hi ? st : -INFINITY;
      if (kAlibi) x[t] += slope * (float)(j0 + t);
      m_new = fmaxf(m_new, x[t]);
    }
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const float p = __expf(x[t] - m_new);
      l += p;
      const float pv = kInt8 ? p * vs[t] : p;  // V dequant folds into p
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += pv * vf[t][i];
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_a[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) sm_a[warp][kPer * lane + i] = acc[i];
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float den = 0.f, o[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_m[w] == -INFINITY) continue;  // warp saw no live key
      const float f = __expf(sm_m[w] - mx);
      den += sm_l[w] * f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[i] += sm_a[w][kPer * lane + i] * f;
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] *= inv;
    store_row<kPer>(out + (long long)b * nd + h * D + kPer * lane, o);
  }
}

template <int D, bool kAlibi, bool kInt8>
void launch(const void* q, long long q_sb, long long q_sh, const void* ckv,
            const void* kv_scales, void* out, const void* cache_len,
            const void* valid_from, int B, int n, int M,
            long long layer_offset, long long scale_layer_offset, float scale,
            cudaStream_t stream) {
  dim3 grid(n, B);
  decode_attn_kernel<D, kAlibi, kInt8><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), q_sb, q_sh, ckv,
      static_cast<const float*>(kv_scales), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(cache_len), static_cast<const int*>(valid_from),
      n, M, layer_offset, scale_layer_offset, scale);
}

}  // namespace

// C entry point (loaded with ctypes).  q: [B, n, head_dim] bf16 with
// batch stride q_sb and head stride q_sh (elements; the head dim
// contiguous); ckv: contiguous [L, B, M, 2*n*head_dim], bf16, or int8 when
// kv_scales is not null; kv_scales: null, or contiguous fp32 [L, B, M,
// 2*n]; out: contiguous [B, n*head_dim] bf16; cache_len, valid_from: int32
// [B] on the device; layer_offset = lidx * B * M * 2*n*head_dim,
// scale_layer_offset = lidx * B * M * 2*n; head_dim 64 or 128; alibi != 0
// adds the standard ALiBi ladder.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim it was not built for.
extern "C" int ymt_decode_attention(const void* q, long long q_sb,
                                    long long q_sh, const void* ckv,
                                    const void* kv_scales, void* out,
                                    const void* cache_len,
                                    const void* valid_from, int B, int n,
                                    int M, long long layer_offset,
                                    long long scale_layer_offset, float scale,
                                    int head_dim, int alibi, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool int8 = kv_scales != nullptr;
#define YMT_DECODE(D, A, Q)                                                   \
  launch<D, A, Q>(q, q_sb, q_sh, ckv, kv_scales, out, cache_len, valid_from, \
                  B, n, M, layer_offset, scale_layer_offset, scale, s)
#define YMT_DECODE_D(D)                                                       \
  if (int8) {                                                                 \
    alibi ? YMT_DECODE(D, true, true) : YMT_DECODE(D, false, true);           \
  } else {                                                                    \
    alibi ? YMT_DECODE(D, true, false) : YMT_DECODE(D, false, false);         \
  }
  if (head_dim == 64) {
    YMT_DECODE_D(64)
  } else if (head_dim == 128) {
    YMT_DECODE_D(128)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef YMT_DECODE_D
#undef YMT_DECODE
  return (int)cudaGetLastError();
}
