// Flash attention backward for Hopper (sm_90a): bf16 in, fp32 accumulation,
// head dim 64 or 128, optionally with the ALiBi bias of the Bloom decoder.
//
// Replaces the Pallas TPU backward kernels of
// youku_mplug_tpu/ops/flash_attention.py:
//   - _bwd_dq_kernel_packed / _bwd_dkv_kernel_packed (packed [B, S, n*d];
//     mask modes none, period and causal; ALiBi with causal) and their
//     _multi forms, which run the same bodies m samples per TPU grid cell;
//   - _bwd_dq_kernel / _bwd_dkv_kernel (head-major [B, H, S, D], static
//     kv_len key mask).
// As there, p is rebuilt from (q, k, lse) instead of being stored:
//   p  = exp(q k^T * scale [+ slope_h * ki] - lse),   dp = dO v^T,
//   dS = p * (dp - delta) * scale,   delta = rowsum(dO * O)  (given, fp32),
//   dq = dS k,  dk = dS^T q,  dv = p^T dO,
// with p and dS rounded to bf16 before their products, as the TPU kernels
// do.  The ALiBi bias is the forward's (flash_fwd.cu): fp32, the global key
// index ki, added after the scale, slopes read from an fp32 device array by
// head.  Like the forward kernel each kernel takes the batch, head and
// sequence strides of every operand, so the packed layout and head-major
// views of wider projections go in without copies.
//
// What bounds it on the H100: at the training shapes (S = 105..1571,
// d = 64 or 128) each 64 x 64 tile does four small tensor-core products and
// an exp per score, so the kernels are bound by staging tiles through
// shared memory and by the elementwise softmax-gradient arithmetic on the
// CUDA cores, not by HBM bytes.  The design keeps the [Sq, Sk] score and
// probability matrices out of device memory; runs all four products on
// the tensor cores (WMMA 16x16x16 bf16 -> fp32) with the dq / dk / dv sums
// held in accumulator fragments across the loop; and visits only the
// tiles a mask leaves live (causal: key tiles 0..i for query tile i, and
// query tiles from the diagonal on for a key tile; period: the tiles of
// the tile's own period groups).  dq and dk/dv are two kernels, as on the
// TPU, so no block adds into another's output: no atomics, and the
// gradients are deterministic.  TMA, wgmma and a multi-stage ring are left
// for a later version.
//
// Registers at d = 128: a warp's fp32 accumulator over 16 rows x 128
// columns is 8 WMMA fragments (64 registers a thread), and dk/dv holds
// two.  So the A operands of the score products (the block's own Q and dO
// rows for dq, K and V rows for dk/dv) are not kept in registers across
// the loop: they stay in shared memory, which the block loaded once, and
// each product reads them one 16-wide slice at a time (mm_abt: the slice
// outer, the four output fragments inner, so each slice is read once per
// tile and every sum is taken in the order of a resident-operand loop).
//
// Blocks: dq: one (64-query tile, head, batch), looping over key tiles;
// dkv: one (64-key tile, head, batch), looping over query tiles.  4 warps,
// each owning 16 rows (queries for dq, keys for dkv).  Elementwise work:
// row = lane / 2, and each thread owns 32 of the 64 columns of the tile.
// One template on (D, ALiBi) gives four builds of each kernel, each with
// its own shared-memory size and opt-in flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kT = 64;        // rows per tile (queries or keys)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdt = kT + 4;  // fp32 per-warp tile scratch row stride
constexpr int kLdp = kT + 8;  // bf16 per-warp tile row stride (elements)
constexpr int kMaxSmem = 232448;  // the H100's per-block opt-in limit

template <int D>
struct Geo {
  static constexpr int kLdh = D + 8;  // bf16 tile row stride (elements)
  // fp32 scratch that holds a 16 x 64 tile, then a 16 x D output slab
  static constexpr int kLds = (D > kT ? D : kT) + 4;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Mask {
  int Sq, kv_len, period, causal;
  __device__ __forceinline__ bool ok(int qi, int ki) const {
    return qi < Sq && ki < kv_len && (!causal || ki <= qi) &&
           (period == 0 || qi / period == ki / period);
  }
};

// 64 rows x D bf16 from global rows [row0, row0 + 64) into a padded tile;
// rows at or past `rows` are zero-filled.  16-byte vector loads.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kT * kChunks; c += kThreads) {
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

// out[16 x 64] (fp32 scratch, row stride ldo) = A[16 x D] times B^T, with A
// 16 rows of a padded shared-memory tile and B a 64 x D tile stored
// row-major in shared memory (so B^T is col_major).
template <int D>
__device__ __forceinline__ void mm_abt(float* out, int ldo,
                                       const __nv_bfloat16* a,
                                       const __nv_bfloat16* b_tile) {
  constexpr int kLdh = Geo<D>::kLdh;
  FragC c[kT / 16];
#pragma unroll
  for (int nt = 0; nt < kT / 16; ++nt) wmma::fill_fragment(c[nt], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, a + kk * 16, kLdh);
#pragma unroll
    for (int nt = 0; nt < kT / 16; ++nt) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b_tile + nt * 16 * kLdh + kk * 16, kLdh);
      wmma::mma_sync(c[nt], af, bf, c[nt]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kT / 16; ++nt) {
    wmma::store_matrix_sync(out + nt * 16, c[nt], ldo, wmma::mem_row_major);
  }
}

// acc[16 x D] += A[16 x 64] (bf16 in shared memory, row stride kLdp)
// times B[64 x D] (row-major tile in shared memory).
template <int D>
__device__ __forceinline__ void mm_acc(FragC (&acc)[D / 16],
                                       const __nv_bfloat16* a,
                                       const __nv_bfloat16* b_tile) {
  constexpr int kLdh = Geo<D>::kLdh;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, a + kk * 16, kLdp);
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b_tile + kk * 16 * kLdh + nt * 16, kLdh);
      wmma::mma_sync(acc[nt], af, bf, acc[nt]);
    }
  }
}

// Write a warp's 16 x D fp32 accumulator as bf16 rows [row0, row0 + 16)
// of a strided global tensor (rows at or past `rows` are skipped), staged
// through the warp's fp32 scratch (row stride Geo<D>::kLds).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           long long row_stride, int row0,
                                           int rows, FragC (&acc)[D / 16],
                                           float* scratch) {
  constexpr int kLds = Geo<D>::kLds, kHalf = D / 2;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(scratch + nt * 16, acc[nt], kLds,
                            wmma::mem_row_major);
  }
  __syncwarp();
  if (row0 + r < rows) {
    __nv_bfloat16* row =
        dst + (long long)(row0 + r) * row_stride + half * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; c += 8) {
      __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pack[e] = __float2bfloat16(scratch[r * kLds + half * kHalf + c + e]);
      }
      *reinterpret_cast<uint4*>(row + c) = *reinterpret_cast<uint4*>(pack);
    }
  }
  __syncwarp();
}

template <int D>
struct DqSmem {
  __nv_bfloat16 q[kT * Geo<D>::kLdh];
  __nv_bfloat16 dout[kT * Geo<D>::kLdh];
  __nv_bfloat16 k[kT * Geo<D>::kLdh];
  __nv_bfloat16 v[kT * Geo<D>::kLdh];
  __nv_bfloat16 ds[kWarps][16 * kLdp];
  float s[kWarps][16 * Geo<D>::kLds];  // scores, then the output staging
  float dp[kWarps][16 * kLdt];
};
static_assert(sizeof(DqSmem<128>) <= kMaxSmem, "dq tiles exceed 227 KB");

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq,
                    const float* __restrict__ slopes, int H, int Sq, int Sk,
                    int kv_len, long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long do_sb, long long do_sh, long long do_ss,
                    long long dq_sb, long long dq_sh, long long dq_ss,
                    float scale, int period, int causal) {
  constexpr int kLdh = Geo<D>::kLdh, kLds = Geo<D>::kLds;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const Mask mask{Sq, kv_len, period, causal};
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[h];

  // Keys this query tile can see (as in flash_fwd.cu).
  const int q_last = min(q0 + kT, Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (period > 0) {
    k_lo = (q0 / period) * period;
    k_hi = min(k_hi, (q_last / period + 1) * period);
  }

  load_tile<D>(sm.q, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  load_tile<D>(sm.dout, dout + b * do_sb + h * do_sh, do_ss, q0, Sq);
  const __nv_bfloat16* q_w = sm.q + warp * 16 * kLdh;
  const __nv_bfloat16* do_w = sm.dout + warp * 16 * kLdh;

  const int r = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + r;
  float lse_i = 0.f, delta_i = 0.f;
  if (qi < Sq) {
    const long long row = ((long long)b * H + h) * Sq + qi;
    lse_i = lse[row];
    delta_i = delta[row];
  }
  FragC acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) wmma::fill_fragment(acc[nt], 0.f);
  float* s_w = sm.s[warp];
  float* dp_w = sm.dp[warp];
  __nv_bfloat16* ds_w = sm.ds[warp];

  for (int kt0 = (k_lo / kT) * kT; kt0 < k_hi; kt0 += kT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sm.k, kb, k_ss, kt0, Sk);
    load_tile<D>(sm.v, vb, v_ss, kt0, Sk);
    __syncthreads();

    mm_abt<D>(s_w, kLds, q_w, sm.k);    // S = Q K^T
    mm_abt<D>(dp_w, kLdt, do_w, sm.v);  // dP = dO V^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const int ki = kt0 + col;
      float ds = 0.f;
      if (mask.ok(qi, ki)) {
        float x = s_w[r * kLds + col] * scale;
        if constexpr (kAlibi) x += __fmul_rn(slope, (float)ki);
        const float p = __expf(x - lse_i);
        ds = p * (dp_w[r * kLdt + col] - delta_i) * scale;
      }
      ds_w[r * kLdp + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    mm_acc<D>(acc, ds_w, sm.k);  // dQ += dS K
  }
  store_rows<D>(dq + b * dq_sb + h * dq_sh, dq_ss, q0 + warp * 16, Sq, acc,
                s_w);
}

template <int D>
struct DkvSmem {
  __nv_bfloat16 k[kT * Geo<D>::kLdh];
  __nv_bfloat16 v[kT * Geo<D>::kLdh];
  __nv_bfloat16 q[kT * Geo<D>::kLdh];
  __nv_bfloat16 dout[kT * Geo<D>::kLdh];
  __nv_bfloat16 p[kWarps][16 * kLdp];   // P^T for the warp's 16 keys
  __nv_bfloat16 ds[kWarps][16 * kLdp];  // dS^T
  float s[kWarps][16 * Geo<D>::kLds];   // S^T, then the output staging
  float dp[kWarps][16 * kLdt];          // dP^T
  float lse[kT];
  float delta[kT];
};
static_assert(sizeof(DkvSmem<128>) <= kMaxSmem, "dk/dv tiles exceed 227 KB");

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     const float* __restrict__ slopes, int H, int Sq, int Sk,
                     int kv_len, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh,
                     long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, long long do_sb, long long do_sh,
                     long long do_ss, long long dk_sb, long long dk_sh,
                     long long dk_ss, long long dv_sb, long long dv_sh,
                     long long dv_ss, float scale, int period, int causal) {
  constexpr int kLdh = Geo<D>::kLdh, kLds = Geo<D>::kLds;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const Mask mask{Sq, kv_len, period, causal};
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const float* lse_b = lse + ((long long)b * H + h) * Sq;
  const float* delta_b = delta + ((long long)b * H + h) * Sq;

  // Queries that can see this key tile; none when every key is at or
  // past kv_len (dk = dv = 0 then).
  const int k_last = min(k0 + kT, Sk) - 1;
  int q_lo = 0, q_hi = k0 < kv_len ? Sq : 0;
  if (causal) q_lo = k0;
  if (period > 0) {
    q_lo = max(q_lo, (k0 / period) * period);
    q_hi = min(q_hi, (k_last / period + 1) * period);
  }

  load_tile<D>(sm.k, k + b * k_sb + h * k_sh, k_ss, k0, Sk);
  load_tile<D>(sm.v, v + b * v_sb + h * v_sh, v_ss, k0, Sk);
  const __nv_bfloat16* k_w = sm.k + warp * 16 * kLdh;
  const __nv_bfloat16* v_w = sm.v + warp * 16 * kLdh;

  const int r = lane >> 1, half = lane & 1;
  const int ki = k0 + warp * 16 + r;
  float bias = 0.f;  // the key's ALiBi bias: one per thread row
  if constexpr (kAlibi) bias = __fmul_rn(slopes[h], (float)ki);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fill_fragment(dk_acc[nt], 0.f);
    wmma::fill_fragment(dv_acc[nt], 0.f);
  }
  float* s_w = sm.s[warp];
  float* dp_w = sm.dp[warp];
  __nv_bfloat16* p_w = sm.p[warp];
  __nv_bfloat16* ds_w = sm.ds[warp];

  for (int qt0 = (q_lo / kT) * kT; qt0 < q_hi; qt0 += kT) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D>(sm.q, qb, q_ss, qt0, Sq);
    load_tile<D>(sm.dout, dob, do_ss, qt0, Sq);
    for (int t = threadIdx.x; t < kT; t += kThreads) {
      const bool in = qt0 + t < Sq;
      sm.lse[t] = in ? lse_b[qt0 + t] : 0.f;
      sm.delta[t] = in ? delta_b[qt0 + t] : 0.f;
    }
    __syncthreads();

    mm_abt<D>(s_w, kLds, k_w, sm.q);     // S^T = K Q^T
    mm_abt<D>(dp_w, kLdt, v_w, sm.dout); // dP^T = V dO^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      float p = 0.f, ds = 0.f;
      if (mask.ok(qt0 + col, ki)) {
        float x = s_w[r * kLds + col] * scale;
        if constexpr (kAlibi) x += bias;
        p = __expf(x - sm.lse[col]);
        ds = p * (dp_w[r * kLdt + col] - sm.delta[col]) * scale;
      }
      p_w[r * kLdp + col] = __float2bfloat16(p);
      ds_w[r * kLdp + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    mm_acc<D>(dv_acc, p_w, sm.dout);  // dV += P^T dO
    mm_acc<D>(dk_acc, ds_w, sm.q);    // dK += dS^T Q
  }
  const int row0 = k0 + warp * 16;
  store_rows<D>(dk + b * dk_sb + h * dk_sh, dk_ss, row0, Sk, dk_acc, s_w);
  store_rows<D>(dv + b * dv_sb + h * dv_sh, dv_ss, row0, Sk, dv_acc, s_w);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  *done = true;
  return 0;
}

template <int D, bool kAlibi>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* slopes, int B, int H, int Sq, int Sk, int kv_len,
              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss, long long do_sb, long long do_sh,
              long long do_ss, long long dq_sb, long long dq_sh,
              long long dq_ss, float scale, int period, int causal,
              cudaStream_t stream) {
  static bool attr_set = false;  // one opt-in per template instance
  int err = set_smem(flash_bwd_dq_kernel<D, kAlibi>,
                     (int)sizeof(DqSmem<D>), &attr_set);
  if (err) return err;
  dim3 grid((Sq + kT - 1) / kT, H, B);
  flash_bwd_dq_kernel<D, kAlibi>
      <<<grid, kThreads, sizeof(DqSmem<D>), stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dq), static_cast<const float*>(slopes),
          H, Sq, Sk, kv_len, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
          v_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, scale, period,
          causal);
  return (int)cudaGetLastError();
}

template <int D, bool kAlibi>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* slopes, int B, int H, int Sq, int Sk, int kv_len,
               long long q_sb, long long q_sh, long long q_ss, long long k_sb,
               long long k_sh, long long k_ss, long long v_sb, long long v_sh,
               long long v_ss, long long do_sb, long long do_sh,
               long long do_ss, long long dk_sb, long long dk_sh,
               long long dk_ss, long long dv_sb, long long dv_sh,
               long long dv_ss, float scale, int period, int causal,
               cudaStream_t stream) {
  static bool attr_set = false;  // one opt-in per template instance
  int err = set_smem(flash_bwd_dkv_kernel<D, kAlibi>,
                     (int)sizeof(DkvSmem<D>), &attr_set);
  if (err) return err;
  dim3 grid((Sk + kT - 1) / kT, H, B);
  flash_bwd_dkv_kernel<D, kAlibi>
      <<<grid, kThreads, sizeof(DkvSmem<D>), stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          static_cast<const float*>(slopes), H, Sq, Sk, kv_len, q_sb, q_sh,
          q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
          dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, scale, period, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes).  Strides are in elements; lse and
// delta are contiguous fp32 [B, H, Sq] buffers; kv_len <= Sk masks keys at
// or past it; period > 0 selects the block-diagonal period mask and
// causal != 0 the causal mask (Sq == Sk).  head_dim is 64 or 128; slopes
// is null, or an fp32 device array of H ALiBi slopes (the caller requires
// causal with it).  Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a head dim it was not built for.
extern "C" int ymt_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int kv_len, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    float scale, int period, int causal, int head_dim, const void* slopes,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define YMT_DQ(D, A)                                                          \
  launch_dq<D, A>(q, k, v, dout, lse, delta, dq, slopes, B, H, Sq, Sk,       \
                  kv_len, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,    \
                  v_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, scale,     \
                  period, causal, s)
  const bool alibi = slopes != nullptr;
  if (head_dim == 64) return alibi ? YMT_DQ(64, true) : YMT_DQ(64, false);
  if (head_dim == 128) return alibi ? YMT_DQ(128, true) : YMT_DQ(128, false);
#undef YMT_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int ymt_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int kv_len, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int period, int causal, int head_dim, const void* slopes,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define YMT_DKV(D, A)                                                         \
  launch_dkv<D, A>(q, k, v, dout, lse, delta, dk, dv, slopes, B, H, Sq, Sk,  \
                   kv_len, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,   \
                   v_ss, do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss, dv_sb,    \
                   dv_sh, dv_ss, scale, period, causal, s)
  const bool alibi = slopes != nullptr;
  if (head_dim == 64) return alibi ? YMT_DKV(64, true) : YMT_DKV(64, false);
  if (head_dim == 128)
    return alibi ? YMT_DKV(128, true) : YMT_DKV(128, false);
#undef YMT_DKV
  return (int)cudaErrorInvalidValue;
}
