// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax, head
// dim 64 or 128, optionally with the ALiBi bias of the Bloom decoder.
//
// Replaces two Pallas TPU kernels of youku_mplug_tpu/ops/flash_attention.py:
//   - _fwd_kernel_packed (packed [B, S, n*d] layout; mask modes none,
//     period, i.e. (qi // p) == (ki // p), and causal, qi >= ki; with ALiBi,
//     s += slope_h * ki after the scale and before the causal mask),
//   - _fwd_kernel (head-major [B, H, S, D] with a static kv_len key mask,
//     and the same causal mode).
// Both compute O = softmax(Q K^T * scale [+ bias]) V with an fp32 online
// softmax and write O plus the fp32 log-sum-exp.  The packed layout is
// only a strided view of [B, S, n, d], so one kernel serves both: the
// caller passes the batch, head and sequence strides (in elements) of q,
// k, v and o; the head dimension must be contiguous.
//
// ALiBi (Bloom's training attention, always causal): the bias is
// slope_h * ki in fp32, ki the GLOBAL key index (so neither a tile
// boundary nor the causal tile skipping can shift it), added to the scaled
// score before the running max.  The slopes are any per-head fp32 values,
// read from a device array of H values by head; at Bloom's S = 768 the
// bias reaches ~0.84 x 767 ~ 645, far inside fp32's exact range, and it is
// never rounded to bf16.
//
// What bounds it on the H100: at the ported paths' shapes (S = 105..1570,
// d = 64 or 128) the score and PV products are small, so the kernel is
// bound by the latency of staging K/V tiles through shared memory and by
// the softmax arithmetic on the CUDA cores, not by HBM bytes (each K/V
// tile is read once per 64-row query tile, and Q/O once).  The design
// keeps the [Sq, Sk] score matrix out of device memory (the point of the
// Pallas kernel too), runs both products on the tensor cores (WMMA
// 16x16x16 bf16 -> fp32), and masks the ragged sequence edge in-kernel
// instead of padding copies.  In period mode it walks only the key tiles
// that hold the query tile's own period groups, where the TPU kernel swept
// the whole sequence; in causal mode query tile i walks key tiles 0..i
// only, as the TPU kernel does.  TMA, wgmma and a multi-stage K/V ring are
// left for a later version.
//
// Block: one (query tile of 64 rows, head, batch); 4 warps, 16 query rows
// each.  Thread layout inside a warp for the softmax: row = lane / 2, and
// each thread owns 32 of the 64 columns of the current key tile and D / 2
// of the D output features of its row.  One template on (D, ALiBi) gives
// the four builds; each has its own shared-memory size (d = 64: 53 KB,
// d = 128: 93 KB) and its own opt-in flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdp = kBK + 8; // bf16 probability row stride (elements)
constexpr int kMaxSmem = 232448;  // the H100's per-block opt-in limit

template <int D>
struct Geo {
  static constexpr int kLdh = D + 8;  // bf16 tile row stride (elements)
  // fp32 scratch row stride: the scores (kBK wide), then PV (D wide)
  static constexpr int kLds = (D > kBK ? D : kBK) + 4;
};

template <int D>
struct Smem {
  __nv_bfloat16 q[kBQ * Geo<D>::kLdh];
  __nv_bfloat16 k[kBK * Geo<D>::kLdh];
  __nv_bfloat16 v[kBK * Geo<D>::kLdh];
  __nv_bfloat16 p[kWarps][16 * kLdp];
  float s[kWarps][16 * Geo<D>::kLds];  // scores, then the PV partial product
};
static_assert(sizeof(Smem<64>) <= kMaxSmem, "d = 64 tiles exceed 227 KB");
static_assert(sizeof(Smem<128>) <= kMaxSmem, "d = 128 tiles exceed 227 KB");

// 64 rows x D bf16 from global rows [row0, row0 + 64) into a padded tile;
// rows at or past `rows` are zero-filled.  16-byte vector loads.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)gr * row_stride +
                                            ch * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Geo<D>::kLdh + ch * 8) = val;
  }
}

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 const float* __restrict__ slopes, int H, int Sq, int Sk,
                 int kv_len, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss, float scale,
                 int period, int causal) {
  constexpr int kLdh = Geo<D>::kLdh, kLds = Geo<D>::kLds, kHalf = D / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[h];

  // Keys this tile can see: [0, kv_len), narrowed in causal mode to keys
  // up to q_last and in period mode to the period groups of rows q0 ..
  // q_last.
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (period > 0) {
    k_lo = (q0 / period) * period;
    k_hi = min(k_hi, (q_last / period + 1) * period);
  }

  load_tile<D>(sm.q, qb, q_ss, q0, Sq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * kLdh + kk * 16, kLdh);
  }

  const int r = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + r;
  const int qg = period > 0 ? qi / period : 0;
  float m_i = -INFINITY, l_i = 0.f;
  float acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) acc[c] = 0.f;
  float* s_w = sm.s[warp];
  __nv_bfloat16* p_w = sm.p[warp];

  for (int kt0 = (k_lo / kBK) * kBK; kt0 < k_hi; kt0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sm.k, kb, k_ss, kt0, Sk);
    load_tile<D>(sm.v, vb, v_ss, kt0, Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: K sits row-major [key][d] in
    // shared memory, which is K^T column-major.
#pragma unroll
    for (int nt = 0; nt < kBK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + nt * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(sc, qa[kk], kf, sc);
      }
      wmma::store_matrix_sync(s_w + nt * 16, sc, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this thread's 32 columns of row r.
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const int ki = kt0 + col;
      const bool ok = ki < kv_len && (!causal || ki <= qi) &&
                      (period == 0 || ki / period == qg);
      float x = s_w[r * kLds + col] * scale;
      if constexpr (kAlibi) x += __fmul_rn(slope, (float)ki);
      x = ok ? x : -INFINITY;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float alpha = 1.f, rowsum = 0.f;
    if (m_new == -INFINITY) {
#pragma unroll
      for (int c = 0; c < 32; ++c) sv[c] = 0.f;
    } else {
      alpha = __expf(m_i - m_new);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        sv[c] = __expf(sv[c] - m_new);
        rowsum += sv[c];
      }
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    l_i = l_i * alpha + rowsum;
    m_i = m_new;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      p_w[r * kLdp + half * 32 + c] = __float2bfloat16(sv[c]);
    }
    __syncwarp();

    // PV = P [16 x 64 keys] @ V [64 keys x D], into the score scratch.
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
      wmma::fill_fragment(pv, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(pa, p_w + kk * 16, kLdp);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * kLdh + nt * 16, kLdh);
        wmma::mma_sync(pv, pa, vf, pv);
      }
      wmma::store_matrix_sync(s_w + nt * 16, pv, kLds, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      acc[c] = acc[c] * alpha + s_w[r * kLds + half * kHalf + c];
    }
    __syncwarp();
  }

  if (qi < Sq) {
    // A row with no visible key (not reachable from the ported paths)
    // yields zeros and lse = -inf.
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    __nv_bfloat16* orow = o + b * o_sb + h * o_sh + qi * o_ss + half * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; c += 8) {
      __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pack[e] = __float2bfloat16(acc[c + e] * inv);
      *reinterpret_cast<uint4*>(orow + c) = *reinterpret_cast<uint4*>(pack);
    }
    if (half == 0) {
      lse[((long long)b * H + h) * Sq + qi] =
          l_i > 0.f ? m_i + logf(l_i) : -INFINITY;
    }
  }
}

template <int D, bool kAlibi>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* slopes, int B, int H, int Sq, int Sk, int kv_len,
           long long q_sb, long long q_sh, long long q_ss, long long k_sb,
           long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, long long o_sb, long long o_sh, long long o_ss,
           float scale, int period, int causal, cudaStream_t stream) {
  static bool attr_set = false;  // one opt-in per template instance
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, kAlibi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<D>));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, kAlibi><<<grid, kThreads, sizeof(Smem<D>), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const float*>(slopes), H, Sq, Sk,
      kv_len, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, o_ss, scale, period, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes).  Strides are in elements; lse is a
// contiguous fp32 [B, H, Sq] buffer.  Keys at or past kv_len are masked
// (the caller passes kv_len = Sk for no key mask); period > 0 selects the
// block-diagonal period mask and causal != 0 the causal mask (Sq == Sk).
// head_dim is 64 or 128; slopes is null, or an fp32 device array of H
// ALiBi slopes (the caller requires causal with it).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim it was not built for.
extern "C" int ymt_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Sk, int kv_len, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int period, int causal,
    int head_dim, const void* slopes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define YMT_FWD(D, A)                                                         \
  launch<D, A>(q, k, v, o, lse, slopes, B, H, Sq, Sk, kv_len, q_sb, q_sh,    \
               q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,   \
               scale, period, causal, s)
  const bool alibi = slopes != nullptr;
  if (head_dim == 64) return alibi ? YMT_FWD(64, true) : YMT_FWD(64, false);
  if (head_dim == 128) return alibi ? YMT_FWD(128, true) : YMT_FWD(128, false);
#undef YMT_FWD
  return (int)cudaErrorInvalidValue;
}
