// Flash attention backward for Hopper (sm_90a): bf16 in, fp32 accumulation,
// head dim 64, 80, 96 or 128, optionally (64 and 128) with the ALiBi bias
// of the Bloom decoder.
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
// with p and dS rounded to bf16 before their products and fp32 sums, as
// the TPU kernels do.  The ALiBi bias is the forward's (flash_fwd.cu):
// fp32, the global key index ki, added after the scale, slopes read from
// an fp32 device array by head.  Each kernel takes the batch, head and
// sequence strides of every operand, so the packed layout and head-major
// views of wider projections go in without copies.
//
// What bounds it on the H100: at the training shapes (S = 105..1570, d 64
// or 128) HBM bytes (each operand read once, each gradient written once:
// 26 + 48 us for AttentionPool's q [16, 128, 12x64] over 1570 keys at
// 3.35 TB/s, its operations 14 + 19 us at 989 TFLOP/s).  As in the
// forward, the products run on wgmma (hopper.cuh) with the score-shaped
// accumulators (S, dP, or S^T, dP^T) turned into p and dS in registers and
// fed straight back as the register A operand of the next product; only
// tiles stay in shared memory, and the streamed tiles come through a
// two-stage cp.async ring:
//   - dq kernel: one block per (64-query tile, head, batch), Q and dO
//     resident, K and V streaming; S = Q K^T and dP = dO V^T (m64n64,
//     both operands K-major), dQ += dS K (m64nD, K read MN-major).
//   - dk/dv kernel: one block per (64-key tile, head, batch), K and V
//     resident, Q, dO, lse and delta streaming; S^T = K Q^T, dP^T = V dO^T,
//     dV += P^T dO and dK += dS^T Q (the last two read the streamed tiles
//     MN-major).
// The dq chain stays whole: AttentionPool's dq in the pretrain step has
// 384 (query tile, head, batch) blocks walking 25 key tiles each, which
// already fills the card (PERF.md), so dq, unlike the forward, takes no
// split of the keys.  No block adds into another's output and no atomics
// are used, so the gradients are bitwise repeatable.  Both kernels visit
// only the tiles a mask leaves
// live (causal: key tiles 0..i for query tile i, query tiles from the
// diagonal on for a key tile; period: the tiles of the tile's own period
// groups).
//
// One template on (D, ALiBi) gives six builds of each kernel.  Shared
// memory: 51 KB at d 64, 99 KB at d 80, 96 and 128.  Head dims 80 (the
// GPT-3 2.7B decoder) and 96 (clip-b16's AttentionPool) take the d = 128
// tile layout with the columns from D on zero-filled (hopper.cuh): the
// score products S and dP contract over the D real columns (5 or 6 k16
// steps; at d = 80 the fifth reads columns 64-79 of the second panel),
// the products into dQ, dK and dV run at N = 128 and only their first D
// columns are stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace ymt;

namespace {

struct Mask {
  int Sq, kv_len, period, causal;
  __device__ __forceinline__ bool ok(int qi, int ki) const {
    return qi < Sq && ki < kv_len && (!causal || ki <= qi) &&
           (period == 0 || qi / period == ki / period);
  }
};

// Two resident [64, D] tiles, then per stage two streamed tiles and
// (dk/dv only) 64 lse and 64 delta values, padded to keep every panel
// 1024-byte aligned.
template <int D>
struct BwdSmem {
  static constexpr int kStages = 2;  // as in the forward
  static constexpr int kTile = (padded(D) / 64) * kPanel;
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kAlloc = kRing + kStages * kStage + 1024;
};
static_assert(BwdSmem<128>::kAlloc <= kMaxSmem, "tiles exceed 227 KB");

// Write this thread's rows of a [64, padded(D)] fp32 accumulator, rows
// row0 + r and its first D columns, as bf16 into a strided tensor (rows at
// or past `rows` skipped).  Values i and i + 1 of a thread share a row and
// two neighbouring columns (hopper.cuh), and value i lies in column group
// i / 4 (8 columns), so the first D / 2 values a thread holds are exactly
// its values of columns 0 .. D - 1 (D a multiple of 16: 10 groups at 80).
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst,
                                          long long row_stride, int row0,
                                          int rows,
                                          const float (&acc)[padded(D) / 2]) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row0 + acc_row(i);
    if (r < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * row_stride + acc_col(i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

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
                    int kv_len, long long q_sb, long long q_sh,
                    long long q_ss, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss, long long do_sb, long long do_sh,
                    long long do_ss, long long dq_sb, long long dq_sh,
                    long long dq_ss, float scale, int period, int causal) {
  using Sm = BwdSmem<D>;
  constexpr int DP = padded(D);  // the gradient accumulators' width
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + Sm::kTile;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const Mask mask{Sq, kv_len, period, causal};
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[h];

  // Key tiles this query tile can see (as in flash_fwd.cu).
  const int q_last = min(q0 + kRows, Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (period > 0) {
    k_lo = (q0 / period) * period;
    k_hi = min(k_hi, (q_last / period + 1) * period);
  }
  const int j0 = k_lo / kRows;
  const int j1 = k_hi > k_lo ? (k_hi + kRows - 1) / kRows : j0;

  constexpr int kStages = Sm::kStages;
  auto slot = [&](int j) {
    return base + Sm::kRing + ((j - j0) % kStages) * Sm::kStage;
  };
  auto fetch = [&](int j) {
    if (j < j1) {
      load_tile<D>(slot(j), kb, k_ss, j * kRows, Sk);
      load_tile<D>(slot(j) + Sm::kTile, vb, v_ss, j * kRows, Sk);
    }
    cp_async_commit();
  };
  load_tile<D>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  load_tile<D>(do_s, dout + b * do_sb + h * do_sh, do_ss, q0, Sq);
#pragma unroll
  for (int j = j0; j < j0 + kStages - 1; ++j) fetch(j);

  const int qi0 = q0 + acc_row(0);  // this thread's rows: qi0, qi0 + 8
  const float scale_log2 = scale * kLog2e;
  float lse2[2], delta_r[2];  // lse in base 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    const long long row = ((long long)b * H + h) * Sq + qi;
    lse2[r] = qi < Sq ? lse[row] * kLog2e : 0.f;
    delta_r[r] = qi < Sq ? delta[row] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    ring_arrive<kStages - 2>();
    fetch(j + kStages - 1);
    const uint32_t ks = slot(j), vs = ks + Sm::kTile;

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(q_s, kk), desc_k(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(do_s, kk), desc_k(vs, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);

    const int kt0 = j * kRows;
    const bool whole = kt0 + kRows <= kv_len && q0 + kRows <= Sq &&
                       period == 0 && (!causal || kt0 + kRows - 1 <= q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, ki = kt0 + acc_col(i);
      float x;
      if constexpr (kAlibi) {
        x = (s[i] * scale + __fmul_rn(slope, (float)ki)) * kLog2e;
      } else {
        x = s[i] * scale_log2;
      }
      const float p = exp2f(x - lse2[r]);
      const float ds = p * (dp[i] - delta_r[r]) * scale;
      s[i] = whole || mask.ok(qi0 + 8 * r, ki) ? ds : 0.f;
    }
    uint32_t da[4][4];
    acc_to_a(s, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(acc, da[kk], desc_mn(ks, kk));
    wg_commit();
    wg_wait<0>();
    pin(acc);
  }
  cp_async_wait<0>();
  store_acc<D>(dq + b * dq_sb + h * dq_sh, dq_ss, q0, Sq, acc);
}

template <int D, bool kAlibi>
__global__ void __launch_bounds__(kThreads, 1)
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
  using Sm = BwdSmem<D>;
  constexpr int DP = padded(D);  // the gradient accumulators' width
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + Sm::kTile;
  // the lse / delta rows of a stage, read through a generic pointer
  unsigned char* base_ptr = smem_raw + (base - smem_addr(smem_raw));

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const Mask mask{Sq, kv_len, period, causal};
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const float* lse_b = lse + ((long long)b * H + h) * Sq;
  const float* delta_b = delta + ((long long)b * H + h) * Sq;

  // Query tiles that can see this key tile; none when every key is at or
  // past kv_len (dk = dv = 0 then).
  const int k_last = min(k0 + kRows, Sk) - 1;
  int q_lo = 0, q_hi = k0 < kv_len ? Sq : 0;
  if (causal) q_lo = k0;
  if (period > 0) {
    q_lo = max(q_lo, (k0 / period) * period);
    q_hi = min(q_hi, (k_last / period + 1) * period);
  }
  const int j0 = q_lo / kRows;
  const int j1 = q_hi > q_lo ? (q_hi + kRows - 1) / kRows : j0;

  constexpr int kStages = Sm::kStages;
  auto slot = [&](int j) {
    return Sm::kRing + ((j - j0) % kStages) * Sm::kStage;  // offset
  };
  auto fetch = [&](int j) {
    if (j < j1) {
      const uint32_t s = base + slot(j);
      load_tile<D>(s, qb, q_ss, j * kRows, Sq);
      load_tile<D>(s + Sm::kTile, dob, do_ss, j * kRows, Sq);
      load_vec64(s + 2 * Sm::kTile, lse_b, j * kRows, Sq);
      load_vec64(s + 2 * Sm::kTile + kRows * 4, delta_b, j * kRows, Sq);
    }
    cp_async_commit();
  };
  load_tile<D>(k_s, k + b * k_sb + h * k_sh, k_ss, k0, Sk);
  load_tile<D>(v_s, v + b * v_sb + h * v_sh, v_ss, k0, Sk);
#pragma unroll
  for (int j = j0; j < j0 + kStages - 1; ++j) fetch(j);

  const int ki0 = k0 + acc_row(0);  // this thread's key rows: ki0, ki0 + 8
  const float scale_log2 = scale * kLog2e;
  float bias[2] = {0.f, 0.f};
  if constexpr (kAlibi) {
    bias[0] = __fmul_rn(slopes[h], (float)ki0);
    bias[1] = __fmul_rn(slopes[h], (float)(ki0 + 8));
  }
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    ring_arrive<kStages - 2>();
    fetch(j + kStages - 1);
    const uint32_t qs = base + slot(j), dos = qs + Sm::kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(base_ptr + slot(j) + 2 * Sm::kTile);
    const float* delta_s = lse_s + kRows;

    float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_k(k_s, kk), desc_k(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k(v_s, kk), desc_k(dos, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(st);
    pin(dpt);

    const int qt0 = j * kRows;
    const bool whole = qt0 + kRows <= Sq && k0 + kRows <= kv_len &&
                       period == 0 && (!causal || k0 + kRows - 1 <= qt0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, c = acc_col(i);
      const float x = kAlibi ? (st[i] * scale + bias[r]) * kLog2e
                             : st[i] * scale_log2;
      const float p = exp2f(x - lse_s[c] * kLog2e);
      const float ds = p * (dpt[i] - delta_s[c]) * scale;
      const bool ok = whole || mask.ok(qt0 + c, ki0 + 8 * r);
      st[i] = ok ? p : 0.f;
      dpt[i] = ok ? ds : 0.f;
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a(st, pa);
    acc_to_a(dpt, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dv_acc, pa[kk], desc_mn(dos, kk));  // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dk_acc, da[kk], desc_mn(qs, kk));   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
  }
  cp_async_wait<0>();
  store_acc<D>(dk + b * dk_sb + h * dk_sh, dk_ss, k0, Sk, dk_acc);
  store_acc<D>(dv + b * dv_sb + h * dv_sh, dv_ss, k0, Sk, dv_acc);
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
              long long q_sb, long long q_sh, long long q_ss,
              long long k_sb, long long k_sh, long long k_ss, long long v_sb,
              long long v_sh, long long v_ss, long long do_sb,
              long long do_sh, long long do_ss, long long dq_sb,
              long long dq_sh, long long dq_ss, float scale, int period,
              int causal, cudaStream_t stream) {
  static bool attr_set = false;  // one opt-in per template instance
  int err = set_smem(flash_bwd_dq_kernel<D, kAlibi>, BwdSmem<D>::kAlloc,
                     &attr_set);
  if (err) return err;
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<D, kAlibi>
      <<<grid, kThreads, BwdSmem<D>::kAlloc, stream>>>(
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
  int err = set_smem(flash_bwd_dkv_kernel<D, kAlibi>, BwdSmem<D>::kAlloc,
                     &attr_set);
  if (err) return err;
  dim3 grid((Sk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<D, kAlibi>
      <<<grid, kThreads, BwdSmem<D>::kAlloc, stream>>>(
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
// causal != 0 the causal mask (Sq == Sk).  head_dim is 64, 80, 96 or 128;
// slopes is null, or (64 and 128 only) an fp32 device array of H ALiBi
// slopes (the caller requires causal with it).  Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a head
// dim it was not built for (ALiBi at 80 and 96 included).
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
  if (head_dim == 80 && !alibi) return YMT_DQ(80, false);
  if (head_dim == 96 && !alibi) return YMT_DQ(96, false);
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
  if (head_dim == 80 && !alibi) return YMT_DKV(80, false);
  if (head_dim == 96 && !alibi) return YMT_DKV(96, false);
#undef YMT_DKV
  return (int)cudaErrorInvalidValue;
}
