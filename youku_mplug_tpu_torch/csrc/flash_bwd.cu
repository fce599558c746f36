// Flash attention backward for Hopper (sm_90a): bf16 in, fp32 accumulation,
// head dim 64, 80, 88, 96 or 128, optionally (64 and 128) with the ALiBi
// bias of the Bloom decoder.
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
// the TPU kernels do; delta comes from flash_bwd_delta_kernel below (XLA
// computes it in the JAX package).  The ALiBi bias is the forward's
// (flash_fwd.cu): fp32, the global key index ki, added after the scale,
// slopes read from an fp32 device array by head.  Each kernel takes the
// batch, head and sequence strides of every operand, so the packed layout
// and head-major views of wider projections go in without copies.
//
// What bounds it on the H100: at the training shapes (S = 105..1570, d 64
// or 128) HBM bytes (each operand read once, each gradient written once:
// 26 + 48 us for AttentionPool's q [16, 128, 12x64] over 1570 keys at
// 3.35 TB/s, its operations 14 + 19 us at 989 TFLOP/s).  As in the
// forward, the products run on wgmma (hopper.cuh) with the score-shaped
// accumulators (S, dP, or S^T, dP^T) turned into p and dS in registers and
// fed straight back as the register A operand of the next product; only
// tiles stay in shared memory, and the streamed tiles come through a
// cp.async ring (two stages; three for dk/dv at d 80, 88 and 96):
//   - dq kernel: one block per (64-query tile, head, batch), Q and dO
//     resident, K and V streaming; S = Q K^T and dP = dO V^T (m64n64,
//     both operands K-major), dQ += dS K (m64nD, K read MN-major).
//   - dk/dv kernel: one block per (64-key tile, head, batch), K and V
//     resident, Q, dO, lse and delta streaming; S^T = K Q^T, dP^T = V dO^T,
//     dV += P^T dO and dK += dS^T Q (the last two read the streamed tiles
//     MN-major);
//   - short-query dk/dv kernel (head dim 96, Sq <= 128, no causal or
//     period mask: AttentionPool's 128 queries): the same products with
//     the roles of the tiles turned, every query resident and the key
//     tiles streaming, one block per share of a (head, batch)'s key tiles
//     (flash_bwd_dkv_short_kernel below says why).
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
// One template on (D, ALiBi) gives six builds of each kernel, all on the
// D-wide tiles of the forward (hopper.cuh's WideTile); a third parameter,
// the output type, adds a seventh dq and dk/dv build at d 64 without ALiBi
// that writes its gradients in fp32 (ring attention's per-block shares,
// summed round the ring before one rounding).  Head dims 80 (the
// GPT-3 2.7B decoder) and 96 (clip-b16's AttentionPool) keep columns 0-63
// in a 128B-swizzled panel and the 16 or 32 columns past them in a tail
// panel of 32- or 64-byte rows: the score products S, dP (and their
// transposes) take four k16 steps on the panel and one or two on the
// tail, the products into dQ, dK and dV are m64n64k16 on the panel plus
// m64n16k16 or m64n32k16 on the tail, into D / 2-value accumulators, so
// no column past D is stored, copied or multiplied.  Shared memory: dq
// 49, 61, 73 and 97 KB at d 64, 80, 96 and 128 (Q and dO resident, two
// K/V stages); dk/dv 51, 84, 100 and 99 KB (K and V resident, stages of
// Q, dO and a 1 KB lse / delta slot: two, three at d 80 and 96); the
// short-query dk/dv 98 KB at d 96.  The dq builds are made
// for the blocks an SM of kDqMinBlocks below (3 at d 80 and 96); the
// dk/dv builds hold 2 (3 at d 64).
//
// Head dim 88 (EVA-ViT-g's AttentionPool) runs d 96's tiles and rings
// with the tail's columns 88-95 zero in shared memory (hopper.cuh's
// WideTile): S and dP (and their transposes) take two k16 steps on the
// tail, where the zeros add nothing; dQ, dK and dV are m64n64k16 on the
// panel plus m64n24k16 on the tail's 24 real columns into 44-value
// accumulators, and no column past 87 is stored.  dk/dv takes the
// key-tile kernel (the short-query one is built at d 96 only); shared
// memory as d 96: dq 73 KB (3 blocks an SM), dk/dv 100 KB (2).

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

// Two resident D-wide tiles, then the ring's stages, each two streamed
// tiles and (dk/dv only) 64 lse and 64 delta values in a 1 KB slot, so
// that every panel stays 1024-byte aligned.  The ring is one tile ahead,
// two ahead for dk/dv at d 80, 88 and 96 (measured 1-2% faster at 80 and
// 96 than one ahead, PERF.md; either way 2 blocks an SM, which the
// registers set).
template <int D, bool kDkv>
struct BwdSmem {
  static constexpr int kStages = kDkv && (D == 80 || D == 88 || D == 96)
                                     ? 3 : 2;
  static constexpr int kTile = WideTile<D>::kBytes;
  static constexpr int kStats = kDkv ? 1024 : 0;  // lse and delta
  static constexpr int kStage = 2 * kTile + kStats;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kAlloc = kRing + kStages * kStage + 1024;
};
static_assert(BwdSmem<128, true>::kAlloc <= kMaxSmem, "tiles exceed 227 KB");

// The blocks an SM each dq build is compiled for
// (ymt_flash_bwd_blocks_per_sm reads what the card makes of it).  At d 80
// and 96 the dq kernel's 61 or 73 KB admit 3 blocks, and the cap this
// asks of nvcc (168 registers a thread) makes the registers admit as
// many; at d 64 without ALiBi the cap of 128 keeps the 4 blocks nvcc's
// own choice gave it before the bound was stated.  The other builds, and
// every dk/dv build (at 80 and 96 its 160 accumulator and score values a
// thread spill under a cap of 168), take nvcc's own choice.
template <int D, bool kAlibi>
constexpr int kDqMinBlocks = D == 80 || D == 88 || D == 96 ? 3
                             : D == 64 && !kAlibi ? 4
                                                  : 1;

// Write this thread's rows of a [64, D] fp32 accumulator (D / 2 values a
// thread), rows row0 + r, as bf16 (or fp32) into a strided tensor (rows at
// or past `rows` skipped).  Values i and i + 1 of a thread share a row and two
// neighbouring columns, and value i lies in column group i / 4 (8
// columns): at d 80, 88 and 96 the values from 32 on are the tail's,
// columns 64 and up, as in the forward's epilogue.
template <int D, typename TO>
__device__ __forceinline__ void store_acc(TO* dst, long long row_stride,
                                          int row0, int rows,
                                          const float (&acc)[D / 2]) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row0 + acc_row(i);
    if (r < rows) store_pair(dst + r * row_stride + acc_col(i), acc[i],
                             acc[i + 1]);
  }
}

template <int D, bool kAlibi, bool kF32Out>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<D, kAlibi>)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    OutT<kF32Out>* __restrict__ dq,
                    const float* __restrict__ slopes, int H, int Sq, int Sk,
                    int kv_len, long long q_sb, long long q_sh,
                    long long q_ss, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss, long long do_sb, long long do_sh,
                    long long do_ss, long long dq_sb, long long dq_sh,
                    long long dq_ss, float scale, int period, int causal) {
  using Sm = BwdSmem<D, false>;
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
      load_tile_wide<D>(slot(j), kb, k_ss, j * kRows, Sk);
      load_tile_wide<D>(slot(j) + Sm::kTile, vb, v_ss, j * kRows, Sk);
    }
    cp_async_commit();
  };
  load_tile_wide<D>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  load_tile_wide<D>(do_s, dout + b * do_sb + h * do_sh, do_ss, q0, Sq);
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
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    ring_arrive<kStages - 2>();
    fetch(j + kStages - 1);
    const uint32_t ks = slot(j), vs = ks + Sm::kTile;

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
      wgmma_ss_n64(s, desc_k_wide<D>(q_s, kk), desc_k_wide<D>(ks, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
      wgmma_ss_n64(dp, desc_k_wide<D>(do_s, kk), desc_k_wide<D>(vs, kk),
                   kk > 0);
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
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide<D>(acc, da[kk], ks, kk);
    wg_commit();
    wg_wait<0>();
    pin(acc);
  }
  cp_async_wait<0>();
  store_acc<D>(dq + b * dq_sb + h * dq_sh, dq_ss, q0, Sq, acc);
}

template <int D, bool kAlibi, bool kF32Out>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     OutT<kF32Out>* __restrict__ dk,
                     OutT<kF32Out>* __restrict__ dv,
                     const float* __restrict__ slopes, int H, int Sq, int Sk,
                     int kv_len, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh,
                     long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, long long do_sb, long long do_sh,
                     long long do_ss, long long dk_sb, long long dk_sh,
                     long long dk_ss, long long dv_sb, long long dv_sh,
                     long long dv_ss, float scale, int period, int causal) {
  using Sm = BwdSmem<D, true>;
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
      load_tile_wide<D>(s, qb, q_ss, j * kRows, Sq);
      load_tile_wide<D>(s + Sm::kTile, dob, do_ss, j * kRows, Sq);
      load_vec64(s + 2 * Sm::kTile, lse_b, j * kRows, Sq);
      load_vec64(s + 2 * Sm::kTile + kRows * 4, delta_b, j * kRows, Sq);
    }
    cp_async_commit();
  };
  load_tile_wide<D>(k_s, k + b * k_sb + h * k_sh, k_ss, k0, Sk);
  load_tile_wide<D>(v_s, v + b * v_sb + h * v_sh, v_ss, k0, Sk);
#pragma unroll
  for (int j = j0; j < j0 + kStages - 1; ++j) fetch(j);

  const int ki0 = k0 + acc_row(0);  // this thread's key rows: ki0, ki0 + 8
  const float scale_log2 = scale * kLog2e;
  float bias[2] = {0.f, 0.f};
  if constexpr (kAlibi) {
    bias[0] = __fmul_rn(slopes[h], (float)ki0);
    bias[1] = __fmul_rn(slopes[h], (float)(ki0 + 8));
  }
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
    for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
      wgmma_ss_n64(st, desc_k_wide<D>(k_s, kk), desc_k_wide<D>(qs, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
      wgmma_ss_n64(dpt, desc_k_wide<D>(v_s, kk), desc_k_wide<D>(dos, kk),
                   kk > 0);
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
      wgmma_rs_wide<D>(dv_acc, pa[kk], dos, kk);  // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_wide<D>(dk_acc, da[kk], qs, kk);   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
  }
  cp_async_wait<0>();
  store_acc<D>(dk + b * dk_sb + h * dk_sh, dk_ss, k0, Sk, dk_acc);
  store_acc<D>(dv + b * dv_sb + h * dv_sh, dv_ss, k0, Sk, dv_acc);
}

// The short-query dk/dv kernel's shared memory: every query tile of the
// sequence (at most two) and its dO resident, their 128 lse and 128 delta
// values, then a two-stage ring of (K, V) tiles.
template <int D>
struct ShortSmem {
  static constexpr int kQTiles = 2;  // Sq <= 128
  static constexpr int kStages = 2;
  static constexpr int kTile = WideTile<D>::kBytes;
  static constexpr int kDo = kQTiles * kTile;
  static constexpr int kStats = 2 * kQTiles * kTile;  // lse, then delta
  static constexpr int kRing = kStats + 1024;
  static constexpr int kAlloc = kRing + kStages * 2 * kTile + 1024;
};

// dk/dv for a short query sequence (Sq <= 128, no causal or period mask;
// head dim 96: clip-b16's AttentionPool, 128 queries over up to 3138
// keys).  There the key-tile kernel above walks only two query tiles
// a block, so each block pays its prologue (the resident K and V, the
// ring's first Q/dO stage) and its epilogue for two tiles of work.  Here
// the roles turn: one block per (share of the key tiles, head, batch)
// keeps the query side resident (Q, dO, lse and delta of every query)
// and streams K and V through the ring as the dq kernel does; for each
// key tile it runs S^T, dP^T, dV += P^T dO and dK += dS^T Q over the
// query tiles, stores dK and dV and clears the accumulators, while the
// next K/V tile lands.  A key tile at or past kv_len is stored as zeros
// without a product.  Measured 5-7% faster than the key-tile kernel at
// the cls and caption27 train shapes, 2% at ITM's (PERF.md): the
// prologues were not most of the time.
template <int D, bool kAlibi>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_short_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Sq,
                           int Sk, int kv_len, int splits, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long do_sb,
                           long long do_sh, long long do_ss, long long dk_sb,
                           long long dk_sh, long long dk_ss, long long dv_sb,
                           long long dv_sh, long long dv_ss, float scale) {
  static_assert(!kAlibi, "built without ALiBi only");
  using Sm = ShortSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const float* lse_s = reinterpret_cast<const float*>(
      smem_raw + (base - smem_addr(smem_raw)) + Sm::kStats);
  const float* delta_s = lse_s + Sm::kQTiles * kRows;

  const int h = blockIdx.y, b = blockIdx.z;
  const Mask mask{Sq, kv_len, 0, 0};
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const long long bh = (long long)b * H + h;

  // This block's contiguous share of all the key tiles (those past
  // kv_len included: their dK and dV are written as zeros).
  const int tiles = (Sk + kRows - 1) / kRows;
  const int per = (tiles + splits - 1) / splits;
  const int j0 = min((int)blockIdx.x * per, tiles);
  const int j1 = min(j0 + per, tiles);
  const int nq = (Sq + kRows - 1) / kRows;

  constexpr int kStages = Sm::kStages;
  auto slot = [&](int j) {
    return base + Sm::kRing + ((j - j0) % kStages) * 2 * Sm::kTile;
  };
  auto fetch = [&](int j) {
    if (j < j1 && j * kRows < kv_len) {
      load_tile_wide<D>(slot(j), kb, k_ss, j * kRows, Sk);
      load_tile_wide<D>(slot(j) + Sm::kTile, vb, v_ss, j * kRows, Sk);
    }
    cp_async_commit();
  };
  for (int t = 0; t < nq; ++t) {
    load_tile_wide<D>(base + t * Sm::kTile, q + b * q_sb + h * q_sh, q_ss,
                      t * kRows, Sq);
    load_tile_wide<D>(base + Sm::kDo + t * Sm::kTile,
                      dout + b * do_sb + h * do_sh, do_ss, t * kRows, Sq);
    load_vec64(base + Sm::kStats + 4 * t * kRows, lse + bh * Sq, t * kRows,
               Sq);
    load_vec64(base + Sm::kStats + 4 * (Sm::kQTiles + t) * kRows,
               delta + bh * Sq, t * kRows, Sq);
  }
#pragma unroll
  for (int j = j0; j < j0 + kStages - 1; ++j) fetch(j);  // with the above

  const float scale_log2 = scale * kLog2e;
  for (int j = j0; j < j1; ++j) {
    ring_arrive<kStages - 2>();
    fetch(j + kStages - 1);
    const uint32_t ks = slot(j), vs = ks + Sm::kTile;
    const int k0 = j * kRows, ki0 = k0 + acc_row(0);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int t = 0; k0 < kv_len && t < nq; ++t) {
      const uint32_t qs = base + t * Sm::kTile, dos = base + Sm::kDo +
                                                       t * Sm::kTile;
      float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
        wgmma_ss_n64(st, desc_k_wide<D>(ks, kk), desc_k_wide<D>(qs, kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
        wgmma_ss_n64(dpt, desc_k_wide<D>(vs, kk), desc_k_wide<D>(dos, kk),
                     kk > 0);
      wg_commit();
      wg_wait<0>();
      pin(st);
      pin(dpt);

      const int qt0 = t * kRows;
      const bool whole = qt0 + kRows <= Sq && k0 + kRows <= kv_len;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1, c = qt0 + acc_col(i);
        const float p = exp2f(st[i] * scale_log2 - lse_s[c] * kLog2e);
        const float ds = p * (dpt[i] - delta_s[c]) * scale;
        const bool ok = whole || mask.ok(c, ki0 + 8 * r);
        st[i] = ok ? p : 0.f;
        dpt[i] = ok ? ds : 0.f;
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(st, pa);
      acc_to_a(dpt, da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_wide<D>(dv_acc, pa[kk], dos, kk);  // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_wide<D>(dk_acc, da[kk], qs, kk);   // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      pin(dv_acc);
      pin(dk_acc);
    }
    store_acc<D>(dk + b * dk_sb + h * dk_sh, dk_ss, k0, Sk, dk_acc);
    store_acc<D>(dv + b * dv_sb + h * dv_sh, dv_ss, k0, Sk, dv_acc);
  }
  cp_async_wait<0>();
}

// delta = rowsum(dO * O) in fp32, the backward's preprocessing (the JAX
// package leaves it to XLA, which fuses it into one pass over dO and O;
// as separate torch ops it took five, ~0.25 ms at [32, 32, 208, 80]).
// Bound by bytes: dO and O read once.  A block per (64 query rows, head,
// batch), as the other kernels' grids, so no index is divided; each warp
// takes kDeltaRows rows and issues their loads together, so that enough
// bytes are in flight.  For each row lane l takes the bf16 pairs l and
// l + 32 (those below D / 2), and the products are summed in fp32 in a
// fixed order; written to a contiguous fp32 [B, H, Sq].
constexpr int kDeltaRows = kRows / (kThreads / 32);  // 16 a warp

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq,
                       long long o_sb, long long o_sh, long long o_ss,
                       long long do_sb, long long do_sh, long long do_ss) {
  constexpr int kPairs = D / 2;
  constexpr int kPer = (kPairs + 31) / 32;  // pairs a lane: 1 or 2
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kRows + (threadIdx.x >> 5) * kDeltaRows;
  const auto* op = reinterpret_cast<const __nv_bfloat162*>(
      o + b * o_sb + h * o_sh);
  const auto* dp = reinterpret_cast<const __nv_bfloat162*>(
      dout + b * do_sb + h * do_sh);
  __nv_bfloat162 x[kDeltaRows][kPer], y[kDeltaRows][kPer];
#pragma unroll
  for (int r = 0; r < kDeltaRows; ++r) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = lane + 32 * c;
      const bool ok = q0 + r < Sq && i < kPairs;
      x[r][c] = ok ? op[(q0 + r) * (o_ss / 2) + i]
                   : __floats2bfloat162_rn(0.f, 0.f);
      y[r][c] = ok ? dp[(q0 + r) * (do_ss / 2) + i]
                   : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
  float* out = delta + ((long long)b * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < kDeltaRows; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const float2 a = __bfloat1622float2(x[r][c]);
      const float2 g = __bfloat1622float2(y[r][c]);
      sum = fmaf(a.x, g.x, sum);
      sum = fmaf(a.y, g.y, sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && q0 + r < Sq) out[q0 + r] = sum;
  }
}

// The backward's kernels: the dq kernel, the dk/dv kernel and the
// short-query dk/dv kernel (the C entries' `kind` 0, 1 and 2).
enum Kind { kKindDq = 0, kKindDkv = 1, kKindShort = 2 };

// The opt-in to a build's dynamic shared memory, once per template
// instance.
template <int D, bool kAlibi, int kKind, bool kF32Out = false>
cudaError_t opt_in() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  constexpr auto kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if constexpr (kKind == kKindDq) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kAlibi, kF32Out>, kAttr,
                               BwdSmem<D, false>::kAlloc);
  } else if constexpr (kKind == kKindDkv) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, kAlibi, kF32Out>, kAttr,
                               BwdSmem<D, true>::kAlloc);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_short_kernel<D, kAlibi>, kAttr,
                               ShortSmem<D>::kAlloc);
  }
  attr_set = err == cudaSuccess;
  return err;
}

template <int D, bool kAlibi, bool kF32Out = false>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* slopes, int B, int H, int Sq, int Sk, int kv_len,
              long long q_sb, long long q_sh, long long q_ss,
              long long k_sb, long long k_sh, long long k_ss, long long v_sb,
              long long v_sh, long long v_ss, long long do_sb,
              long long do_sh, long long do_ss, long long dq_sb,
              long long dq_sh, long long dq_ss, float scale, int period,
              int causal, cudaStream_t stream) {
  if (cudaError_t err = opt_in<D, kAlibi, kKindDq, kF32Out>();
      err != cudaSuccess)
    return (int)err;
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<D, kAlibi, kF32Out>
      <<<grid, kThreads, BwdSmem<D, false>::kAlloc, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<OutT<kF32Out>*>(dq), static_cast<const float*>(slopes),
          H, Sq, Sk, kv_len, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
          v_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, scale, period,
          causal);
  return (int)cudaGetLastError();
}

template <int D, bool kAlibi, bool kF32Out = false>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* slopes, int B, int H, int Sq, int Sk, int kv_len,
               long long q_sb, long long q_sh, long long q_ss, long long k_sb,
               long long k_sh, long long k_ss, long long v_sb, long long v_sh,
               long long v_ss, long long do_sb, long long do_sh,
               long long do_ss, long long dk_sb, long long dk_sh,
               long long dk_ss, long long dv_sb, long long dv_sh,
               long long dv_ss, float scale, int period, int causal,
               int short_splits, cudaStream_t stream) {
  if (short_splits > 0) {
    if constexpr (D == 96 && !kF32Out) {
      if (kAlibi || causal || period || Sq > 2 * kRows)
        return (int)cudaErrorInvalidValue;
      if (cudaError_t err = opt_in<D, false, kKindShort>(); err != cudaSuccess)
        return (int)err;
      dim3 grid(short_splits, H, B);
      flash_bwd_dkv_short_kernel<D, false>
          <<<grid, kThreads, ShortSmem<D>::kAlloc, stream>>>(
              static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<__nv_bfloat16*>(dk),
              static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, kv_len,
              short_splits, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
              v_ss, do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh,
              dv_ss, scale);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
  }
  if (cudaError_t err = opt_in<D, kAlibi, kKindDkv, kF32Out>();
      err != cudaSuccess)
    return (int)err;
  dim3 grid((Sk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<D, kAlibi, kF32Out>
      <<<grid, kThreads, BwdSmem<D, true>::kAlloc, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<OutT<kF32Out>*>(dk), static_cast<OutT<kF32Out>*>(dv),
          static_cast<const float*>(slopes), H, Sq, Sk, kv_len, q_sb, q_sh,
          q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
          dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, scale, period, causal);
  return (int)cudaGetLastError();
}

template <int D, bool kAlibi, int kKind, bool kF32Out = false>
int blocks_per_sm_of(int* blocks) {
  if (cudaError_t err = opt_in<D, kAlibi, kKind, kF32Out>();
      err != cudaSuccess)
    return (int)err;
  if constexpr (kKind == kKindDq) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_bwd_dq_kernel<D, kAlibi, kF32Out>, kThreads,
        BwdSmem<D, false>::kAlloc);
  } else if constexpr (kKind == kKindDkv) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_bwd_dkv_kernel<D, kAlibi, kF32Out>, kThreads,
        BwdSmem<D, true>::kAlloc);
  } else {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_bwd_dkv_short_kernel<D, kAlibi>, kThreads,
        ShortSmem<D>::kAlloc);
  }
}

template <int D, bool kAlibi>
int blocks_per_sm(int kind, int* blocks) {
  if (kind == kKindDq) return blocks_per_sm_of<D, kAlibi, kKindDq>(blocks);
  if (kind == kKindDkv) return blocks_per_sm_of<D, kAlibi, kKindDkv>(blocks);
  if constexpr (!kAlibi && D == 96) {
    if (kind == kKindShort)
      return blocks_per_sm_of<D, false, kKindShort>(blocks);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points (loaded with ctypes).  Strides are in elements; lse and
// delta are contiguous fp32 [B, H, Sq] buffers; kv_len <= Sk masks keys at
// or past it; period > 0 selects the block-diagonal period mask and
// causal != 0 the causal mask (Sq == Sk).  head_dim is 64, 80, 88, 96 or
// 128;
// slopes is null, or (64 and 128 only) an fp32 device array of H ALiBi
// slopes (the caller requires causal with it).  The dk/dv entry's
// short_splits 0 runs the key-tile kernel; n > 0 the short-query kernel
// with each (head, batch)'s key tiles split n ways (head dim 96, Sq <=
// 128, no mask but kv_len).  Each returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for a head dim it was not built
// for (ALiBi at 80, 88 and 96 included) or a short-query call it cannot
// take.
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
  if (head_dim == 88 && !alibi) return YMT_DQ(88, false);
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
    int short_splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (short_splits < 0) return (int)cudaErrorInvalidValue;
#define YMT_DKV(D, A)                                                         \
  launch_dkv<D, A>(q, k, v, dout, lse, delta, dk, dv, slopes, B, H, Sq, Sk,  \
                   kv_len, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,   \
                   v_ss, do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss, dv_sb,    \
                   dv_sh, dv_ss, scale, period, causal, short_splits, s)
  const bool alibi = slopes != nullptr;
  if (head_dim == 64) return alibi ? YMT_DKV(64, true) : YMT_DKV(64, false);
  if (head_dim == 128)
    return alibi ? YMT_DKV(128, true) : YMT_DKV(128, false);
  if (head_dim == 80 && !alibi) return YMT_DKV(80, false);
  if (head_dim == 88 && !alibi) return YMT_DKV(88, false);
  if (head_dim == 96 && !alibi) return YMT_DKV(96, false);
#undef YMT_DKV
  return (int)cudaErrorInvalidValue;
}

// C entry point: the blocks of the dq (kind 0), dk/dv (kind 1) or
// short-query dk/dv (kind 2; head dim 96) kernel resident on one
// SM at a head dim (with ALiBi if alibi != 0), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it for the build's
// threads and dynamic shared memory, into *blocks.  Returns the CUDA
// error, or cudaErrorInvalidValue for a build or kind that does not exist.
extern "C" int ymt_flash_bwd_blocks_per_sm(int head_dim, int alibi, int kind,
                                           int* blocks) {
  if (head_dim == 64)
    return alibi ? blocks_per_sm<64, true>(kind, blocks)
                 : blocks_per_sm<64, false>(kind, blocks);
  if (head_dim == 128)
    return alibi ? blocks_per_sm<128, true>(kind, blocks)
                 : blocks_per_sm<128, false>(kind, blocks);
  if (head_dim == 80 && !alibi) return blocks_per_sm<80, false>(kind, blocks);
  if (head_dim == 88 && !alibi) return blocks_per_sm<88, false>(kind, blocks);
  if (head_dim == 96 && !alibi) return blocks_per_sm<96, false>(kind, blocks);
  return (int)cudaErrorInvalidValue;
}

// C entry point: delta = rowsum(dO * O) in fp32 into the contiguous
// [B, H, Sq] buffer `delta`, from bf16 o and dout [B, H, Sq, head_dim]
// views (strides in elements, the head dim contiguous, rows 4-byte
// aligned).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another head dim or no rows.
extern "C" int ymt_flash_bwd_delta_bf16(const void* o, const void* dout,
                                        void* delta, int B, int H, int Sq,
                                        long long o_sb, long long o_sh,
                                        long long o_ss, long long do_sb,
                                        long long do_sh, long long do_ss,
                                        int head_dim, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  auto s = static_cast<cudaStream_t>(stream);
#define YMT_DELTA(D)                                                         \
  flash_bwd_delta_kernel<D><<<grid, kThreads, 0, s>>>(                       \
      static_cast<const __nv_bfloat16*>(o),                                  \
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta),   \
      H, Sq, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss)
  if (head_dim == 64) YMT_DELTA(64);
  else if (head_dim == 80) YMT_DELTA(80);
  else if (head_dim == 88) YMT_DELTA(88);
  else if (head_dim == 96) YMT_DELTA(96);
  else if (head_dim == 128) YMT_DELTA(128);
  else return (int)cudaErrorInvalidValue;
#undef YMT_DELTA
  return (int)cudaGetLastError();
}

// C entry points: the dq and dk/dv kernels with the gradients written in
// fp32 (ring attention's per-block shares, summed in fp32 round the ring
// before one rounding).  Arguments as ymt_flash_bwd_dq_bf16's and
// ymt_flash_bwd_dkv_bf16's, the gradients fp32 views (8-byte aligned
// rows); built at head dim 64 without ALiBi (the ring's blocks), the
// key-tile dk/dv kernel (short_splits 0); cudaErrorInvalidValue elsewhere.
extern "C" int ymt_flash_bwd_dq_f32out(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int kv_len, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    float scale, int period, int causal, int head_dim, const void* slopes,
    void* stream) {
  if (head_dim != 64 || slopes != nullptr) return (int)cudaErrorInvalidValue;
  return launch_dq<64, false, true>(
      q, k, v, dout, lse, delta, dq, slopes, B, H, Sq, Sk, kv_len, q_sb, q_sh,
      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, dq_sb,
      dq_sh, dq_ss, scale, period, causal, static_cast<cudaStream_t>(stream));
}

extern "C" int ymt_flash_bwd_dkv_f32out(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int kv_len, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int period, int causal, int head_dim, const void* slopes,
    int short_splits, void* stream) {
  if (head_dim != 64 || slopes != nullptr || short_splits != 0)
    return (int)cudaErrorInvalidValue;
  return launch_dkv<64, false, true>(
      q, k, v, dout, lse, delta, dk, dv, slopes, B, H, Sq, Sk, kv_len, q_sb,
      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
      dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, scale, period, causal, 0,
      static_cast<cudaStream_t>(stream));
}

// C entry point: the fp32-output dq (kind 0) or dk/dv (kind 1) kernel's
// blocks resident on one SM at a head dim, as ymt_flash_bwd_blocks_per_sm
// counts them; cudaErrorInvalidValue for a build or kind that does not
// exist.
extern "C" int ymt_flash_bwd_f32out_blocks_per_sm(int head_dim, int kind,
                                                  int* blocks) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  if (kind == kKindDq)
    return blocks_per_sm_of<64, false, kKindDq, true>(blocks);
  if (kind == kKindDkv)
    return blocks_per_sm_of<64, false, kKindDkv, true>(blocks);
  return (int)cudaErrorInvalidValue;
}
