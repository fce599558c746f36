// Flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax, head
// dim 64, 80, 88, 96 or 128 on tiles D wide, optionally (64 and 128) with
// the ALiBi bias of the Bloom decoder.
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
// boundary, a split nor the causal tile skipping can shift it), added to
// the scaled score before the running max.  The slopes are any per-head
// fp32 values, read from a device array of H values by head; at Bloom's
// S = 768 the bias reaches ~0.84 x 767 ~ 645, far inside fp32's exact
// range, and it is never rounded to bf16.
//
// What bounds it on the H100: at the ported paths' shapes (S = 105..3138,
// d = 64, 80, 96 or 128) HBM bytes bound it (Q, K, V read once and O written
// once: 12 us for AttentionPool's [8, 128, 12x64] over 1570 keys at
// 3.35 TB/s, its operations 8 us at 989 TFLOP/s), so the kernel has to
// keep the tensor cores fed while the next tiles arrive, keep the scores
// out of shared memory, and put enough blocks on the 132 SMs.  The design:
//   - products on wgmma (hopper.cuh): S = Q K^T as m64n64k16 with Q and
//     the K tile in swizzled shared memory, O += P V at N = D with P
//     taken from registers: the S accumulator is masked, exponentiated
//     and rounded to bf16 where it lies, so neither S nor P is stored;
//   - K and V stream through a ring of cp.async copies (two stages; three
//     slots at d = 96, FwdSmem): tile j + 1 is in flight while tile j is
//     multiplied (any row stride, the ragged end zero-filled, never read
//     out of bounds);
//   - split-KV: when the (query tile, head, batch) blocks are too few for
//     the card (AttentionPool: 192 blocks each walking 25 key tiles), the
//     caller asks for `splits` > 1 and each block takes a contiguous share
//     of its key tiles, writing its normalised o and its lse in fp32 to
//     scratch the caller allocated; flash_fwd_merge_kernel then weighs the
//     shares by exp(lse_s - lse) into O and the one-pass lse;
//   - mask-aware tile skipping: causal query tile i walks key tiles
//     0..i, period mode only the tiles of its own period groups, and keys
//     at or past kv_len are never loaded.
//
// Block: one warpgroup (4 warps) for one (64-row query tile, head, batch,
// split); each thread holds two query rows of S and O in the wgmma
// accumulator layout.  The softmax runs in base 2 (scores times log2 e,
// exp2, lse converted back to base e); a key tile that every row of the
// query tile sees whole skips the mask arithmetic.  One template on (D,
// ALiBi, output type) gives the seven bf16 builds and an eighth, at d = 64,
// that writes o in fp32
// (kF32Out: ring attention's partials, rounded once after their merge);
// shared memory is Q plus the K/V ring:
// 41 KB at d = 64, 51 KB at 80, 49 KB at 88 and 96 (a three-slot ring),
// 81 KB at 128.
//
// Head dims 80 (the GPT-3 2.7B decoder, 32 heads of 80) and 96 (clip-b16's
// AttentionPool, 8 heads of 96) run on D-wide tiles (hopper.cuh's
// WideTile): columns 0-63 in a 128B-swizzled panel, the 16 or 32 columns
// past them in a tail panel of 32- or 64-byte rows under the swizzle of
// that width.  S = Q K^T takes four k16 steps on the panel and one (d 80)
// or two (d 96) on the tail; O += P V is m64n64k16 on the panel plus
// m64n16k16 or m64n32k16 on the tail, into a D / 2-value accumulator.  No
// column past D is stored, copied or multiplied, and the smaller tiles and
// accumulator let 4 blocks share an SM at d = 80 and 3 at d = 96 (2 at
// d = 128), which is what hides one block's prologue (its Q tile and first
// K/V tile) behind the others' products at the 2.7B decoder's causal
// shape, where a block walks 1-4 key tiles.
//
// Head dim 88 (EVA-ViT-g's AttentionPool, 16 heads of 88: 128 queries over
// 258 keys in the image pretrain step) runs d 96's tiles with the tail's
// columns 88-95 zero in shared memory (hopper.cuh's WideTile): rows of 176
// bytes are eleven 16-byte chunks, the twelfth zero-filled by cp.async, so
// nothing is padded through HBM and the caller copies nothing.  S = Q K^T
// takes two k16 steps on the tail, where the zeros add nothing; O += P V
// is m64n64k16 on the panel plus m64n24k16 on the tail's real columns,
// into a 44-value accumulator; no column past 87 is stored.  The three-
// slot ring and the 3 blocks an SM of d 96 hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace ymt;

namespace {

// The K/V ring is one tile ahead.  A deeper ring, 128 keys a step, two
// warpgroups a block sharing each K/V tile, and issuing the next tile's
// S product before this tile's softmax all measured slower on the H100 at
// the paths' shapes (PERF.md).  At d = 64, 80 and 128 it holds two stages
// of (K, V).  At d = 96 (and 88, on its tiles) it is three slots that the
// sequence K_0, V_0, K_1,
// V_1, ... takes in turn (element t in slot t % 3): K_j+1 goes into
// V_j-1's slot once PV_j-1 is done, V_j+1 into K_j's once S_j is done, so
// each copy still has one tile's work to land in, and S_j waits for K_j
// alone.  That measured 10% faster at clip-b16's cls train shape and 1%
// slower at d = 80 (PERF.md).
template <int D>
struct FwdSmem {
  static constexpr bool kThree = D == 96 || D == 88;
  static constexpr int kStages = 2;
  static constexpr int kTile = WideTile<D>::kBytes;  // one tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                 // then the K/V ring
  static constexpr int kBytes = kTile * (kThree ? 4 : 1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;     // room to align to 1 KB
};
static_assert(FwdSmem<128>::kAlloc <= kMaxSmem, "d = 128 tiles exceed 227 KB");

// The blocks an SM each build is compiled for.  At d = 80 the shared
// memory (51 KB, plus the 1 KB the card keeps a block) admits 4, and the
// register cap this asks of nvcc (128 a thread) makes the registers admit
// as many; at d = 96 the cap is 168 a thread, 3 blocks (4 would need 128
// registers, and nvcc then spills).  d = 64 and 128 keep nvcc's own
// choice; d 88 takes d 96's cap (its 44 accumulator values fit in less).
// ymt_flash_fwd_blocks_per_sm reads what the card makes of each build.
template <int D>
constexpr int kFwdMinBlocks = D == 80 ? 4 : D == 96 || D == 88 ? 3 : 1;

template <int D, bool kAlibi, bool kF32Out>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks<D>)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 OutT<kF32Out>* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ o_part, float* __restrict__ lse_part,
                 const float* __restrict__ slopes, int B, int H, int Sq,
                 int Sk, int kv_len, int splits, long long q_sb,
                 long long q_sh, long long q_ss, long long k_sb,
                 long long k_sh, long long k_ss, long long v_sb,
                 long long v_sh, long long v_ss, long long o_sb,
                 long long o_sh, long long o_ss, float scale, int period,
                 int causal) {
  using Sm = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + Sm::kQ;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  float slope = 0.f;
  if constexpr (kAlibi) slope = slopes[h];

  // Key tiles this query tile can see: keys [0, kv_len), narrowed in
  // causal mode to keys up to q_last and in period mode to the period
  // groups of rows q0 .. q_last; then this split's contiguous share.
  const int q_last = min(q0 + kRows, Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (period > 0) {
    k_lo = (q0 / period) * period;
    k_hi = min(k_hi, (q_last / period + 1) * period);
  }
  constexpr int kStages = Sm::kStages;
  const int t_lo = k_lo / kRows;
  const int t_hi = k_hi > k_lo ? (k_hi + kRows - 1) / kRows : t_lo;
  const int per = (t_hi - t_lo + splits - 1) / splits;
  const int j0 = min(t_lo + split * per, t_hi);
  const int j1 = min(j0 + per, t_hi);

  auto k_slot = [&](int j) {
    return base + Sm::kK + ((j - j0) % kStages) * 2 * Sm::kTile;
  };
  auto fetch = [&](int j) {
    if (j < j1) {
      load_tile_wide<D>(k_slot(j), kb, k_ss, j * kRows, Sk);
      load_tile_wide<D>(k_slot(j) + Sm::kTile, vb, v_ss, j * kRows, Sk);
    }
    cp_async_commit();
  };
  // the three-slot ring: element t = 2 (j - j0) + (0 for K_j, 1 for V_j)
  auto slot3 = [&](int t) { return base + Sm::kK + (t % 3) * Sm::kTile; };
  auto fetch3 = [&](int t) {
    const int j = j0 + t / 2;
    if (j < j1) {
      if (t & 1) {
        load_tile_wide<D>(slot3(t), vb, v_ss, j * kRows, Sk);
      } else {
        load_tile_wide<D>(slot3(t), kb, k_ss, j * kRows, Sk);
      }
    }
    cp_async_commit();
  };
  load_tile_wide<D>(q_s, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  if constexpr (Sm::kThree) {
    fetch3(0);  // Q and K_j0, then V_j0
    fetch3(1);
  } else {
#pragma unroll
    for (int j = j0; j < j0 + kStages - 1; ++j) fetch(j);  // Q in the first
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  const int qi0 = q0 + acc_row(0);  // this thread's rows: qi0, qi0 + 8
  const float scale_log2 = scale * kLog2e;

  for (int j = j0; j < j1; ++j) {
    const int t = 2 * (j - j0);
    uint32_t ks;
    if constexpr (Sm::kThree) {
      ring_arrive<1>();  // K_j landed; all are done with PV_j-1 ...
      fetch3(t + 2);     // ... so V_j-1's slot takes K_j+1
      ks = slot3(t);
    } else {
      ring_arrive<kStages - 2>();  // tile j landed; all are done with j - 1
      fetch(j + kStages - 1);      // ... so its slot takes tile j + stages - 1
      ks = k_slot(j);
    }

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WideTile<D>::kSteps; ++kk)
      wgmma_ss_n64(s, desc_k_wide<D>(q_s, kk), desc_k_wide<D>(ks, kk),
                   kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(s);
    uint32_t vs;
    if constexpr (Sm::kThree) {
      ring_arrive<1>();  // V_j landed; all are done with S_j ...
      fetch3(t + 3);     // ... so K_j's slot takes V_j+1
      vs = slot3(t + 1);
    } else {
      vs = ks + Sm::kTile;
    }

    // Online softmax on the accumulator, in base 2 (x log2 e, exp2): two
    // rows a thread, their 16 columns each spread over the quad of threads
    // that share the row.  A tile every row sees whole skips the mask.
    const int kt0 = j * kRows;
    const bool whole = kt0 + kRows <= kv_len && period == 0 &&
                       (!causal || kt0 + kRows - 1 <= q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, qi = qi0 + 8 * r, ki = kt0 + acc_col(i);
      float x;
      if constexpr (kAlibi) {
        x = (s[i] * scale + __fmul_rn(slope, (float)ki)) * kLog2e;
      } else {
        x = s[i] * scale_log2;
      }
      if (!whole) {
        const bool ok = ki < kv_len && (!causal || ki <= qi) &&
                        (period == 0 || ki / period == qi / period);
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      // no visible key yet: keep everything at zero
      alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];  // this thread's partial row sum
    }
    const float m_use[2] = {m_i[0] == -INFINITY ? 0.f : m_i[0],
                            m_i[1] == -INFINITY ? 0.f : m_i[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m_use[r]);  // exp2(-inf) = 0 for masked keys
      l_i[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[4][4];
    acc_to_a(s, pa);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide<D>(acc, pa[kk], vs, kk);
    wg_commit();
    wg_wait<0>();
    pin(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  // A row with no visible key (an empty split, or not reachable from the
  // ported paths) yields zeros and lse = -inf.
  const float inv[2] = {l_i[0] > 0.f ? 1.f / l_i[0] : 0.f,
                        l_i[1] > 0.f ? 1.f / l_i[1] : 0.f};
  const long long bh = (long long)b * H + h;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1, qi = qi0 + 8 * r;
      if (qi < Sq)
        store_pair(o + b * o_sb + h * o_sh + qi * o_ss + acc_col(i),
                   acc[i] * inv[r], acc[i + 1] * inv[r]);
    }
  } else {
    float* op = o_part + (((long long)split * B * H + bh) * Sq) * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1, qi = qi0 + 8 * r;
      if (qi < Sq) {
        *reinterpret_cast<float2*>(op + (long long)qi * D + acc_col(i)) =
            make_float2(acc[i] * inv[r], acc[i + 1] * inv[r]);
      }
    }
  }
  if ((threadIdx.x & 3) == 0) {
    float* out = splits == 1 ? lse + bh * Sq
                             : lse_part + ((long long)split * B * H + bh) * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;
      if (qi < Sq)
        out[qi] = l_i[r] > 0.f ? m_i[r] * kLn2 + logf(l_i[r]) : -INFINITY;
    }
  }
}

// The split-KV merge: one warp per (batch, head, query row), lane l
// taking columns l, l + 32, l + 64, ... below D, so each load and store
// of the warp is one contiguous run of columns whatever D is.  With the
// shares' lse_s, lse = log(sum_s exp(lse_s)) and O = sum_s exp(lse_s -
// lse) o_s (o_s already normalised), summed in split order.
template <int D, bool kF32Out>
__global__ void __launch_bounds__(kThreads)
flash_fwd_merge_kernel(const float* __restrict__ o_part,
                       const float* __restrict__ lse_part,
                       OutT<kF32Out>* __restrict__ o, float* __restrict__ lse,
                       int B, int H, int Sq, int splits, long long o_sb,
                       long long o_sh, long long o_ss) {
  // columns a lane: 2 at d = 64, 3 at 80 (lanes 0-15), 88 (lanes 0-23)
  // and 96, 4 at 128
  constexpr int kPer = (D + 31) / 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const long long rows = (long long)B * H * Sq;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / Sq;
  const int qi = (int)(row % Sq), b = (int)(bh / H), h = (int)(bh % H);
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, lse_part[s * rows + row]);
  float out[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) out[c] = 0.f;
  float total = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < splits; ++s)
      total += __expf(lse_part[s * rows + row] - m);
    for (int s = 0; s < splits; ++s) {
      const float w = __expf(lse_part[s * rows + row] - m) / total;
      const float* src = o_part + (s * rows + row) * D + lane;
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        if (lane + 32 * c < D) out[c] += w * src[32 * c];
    }
  }
  OutT<kF32Out>* dst = o + b * o_sb + h * o_sh + qi * o_ss + lane;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (lane + 32 * c < D) store_one(dst + 32 * c, out[c]);
  if (lane == 0) lse[row] = m == -INFINITY ? -INFINITY : m + logf(total);
}

// The opt-in to the build's dynamic shared memory, once per template
// instance.
template <int D, bool kAlibi, bool kF32Out>
cudaError_t opt_in() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kAlibi, kF32Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<D>::kAlloc);
  attr_set = err == cudaSuccess;
  return err;
}

template <int D, bool kAlibi, bool kF32Out = false>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           void* o_part, void* lse_part, const void* slopes, int B, int H,
           int Sq, int Sk, int kv_len, int splits, long long q_sb,
           long long q_sh, long long q_ss, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           long long o_sb, long long o_sh, long long o_ss, float scale,
           int period, int causal, cudaStream_t stream) {
  using TO = OutT<kF32Out>;
  if (cudaError_t err = opt_in<D, kAlibi, kF32Out>(); err != cudaSuccess)
    return (int)err;
  dim3 grid((Sq + kRows - 1) / kRows, H, B * splits);
  flash_fwd_kernel<D, kAlibi, kF32Out>
      <<<grid, kThreads, FwdSmem<D>::kAlloc, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<TO*>(o),
          static_cast<float*>(lse), static_cast<float*>(o_part),
          static_cast<float*>(lse_part), static_cast<const float*>(slopes),
          B, H, Sq, Sk, kv_len, splits, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
          v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, period, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long rows = (long long)B * H * Sq;
  flash_fwd_merge_kernel<D, kF32Out>
      <<<(unsigned)((rows + 3) / 4), kThreads, 0, stream>>>(
          static_cast<const float*>(o_part),
          static_cast<const float*>(lse_part), static_cast<TO*>(o),
          static_cast<float*>(lse), B, H, Sq, splits, o_sb, o_sh, o_ss);
  return (int)cudaGetLastError();
}

template <int D, bool kAlibi, bool kF32Out = false>
int blocks_per_sm(int* blocks) {
  if (cudaError_t err = opt_in<D, kAlibi, kF32Out>(); err != cudaSuccess)
    return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_fwd_kernel<D, kAlibi, kF32Out>, kThreads,
      FwdSmem<D>::kAlloc);
}

}  // namespace

// C entry point (loaded with ctypes).  Strides are in elements; lse is a
// contiguous fp32 [B, H, Sq] buffer.  Keys at or past kv_len are masked
// (the caller passes kv_len = Sk for no key mask); period > 0 selects the
// block-diagonal period mask and causal != 0 the causal mask (Sq == Sk).
// head_dim is 64, 80, 88, 96 or 128; slopes is null, or (64 and 128 only) an
// fp32 device array of H ALiBi slopes (the caller requires causal with it).
// splits > 1 splits
// each block's key tiles that many ways: o_part (fp32 [splits, B, H, Sq,
// head_dim]) and lse_part (fp32 [splits, B, H, Sq]) are then the caller's
// scratch, and the merge kernel runs after the main one.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// head dim it was not built for (ALiBi at 80, 88 and 96 included) or
// splits < 1.
extern "C" int ymt_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Sk, int kv_len, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int period, int causal,
    int head_dim, const void* slopes, int splits, void* o_part,
    void* lse_part, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (splits < 1) return (int)cudaErrorInvalidValue;
#define YMT_FWD(D, A)                                                         \
  launch<D, A>(q, k, v, o, lse, o_part, lse_part, slopes, B, H, Sq, Sk,      \
               kv_len, splits, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,     \
               v_sh, v_ss, o_sb, o_sh, o_ss, scale, period, causal, s)
  const bool alibi = slopes != nullptr;
  if (head_dim == 64) return alibi ? YMT_FWD(64, true) : YMT_FWD(64, false);
  if (head_dim == 128) return alibi ? YMT_FWD(128, true) : YMT_FWD(128, false);
  if (head_dim == 80 && !alibi) return YMT_FWD(80, false);
  if (head_dim == 88 && !alibi) return YMT_FWD(88, false);
  if (head_dim == 96 && !alibi) return YMT_FWD(96, false);
#undef YMT_FWD
  return (int)cudaErrorInvalidValue;
}

// C entry point: the forward's blocks resident on one SM at a head dim
// (with ALiBi if alibi != 0), as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives it for the build's threads and dynamic shared memory, into
// *blocks.  Returns the CUDA error, or cudaErrorInvalidValue for a build
// that does not exist.
extern "C" int ymt_flash_fwd_blocks_per_sm(int head_dim, int alibi,
                                           int* blocks) {
  if (head_dim == 64)
    return alibi ? blocks_per_sm<64, true>(blocks)
                 : blocks_per_sm<64, false>(blocks);
  if (head_dim == 128)
    return alibi ? blocks_per_sm<128, true>(blocks)
                 : blocks_per_sm<128, false>(blocks);
  if (head_dim == 80 && !alibi) return blocks_per_sm<80, false>(blocks);
  if (head_dim == 88 && !alibi) return blocks_per_sm<88, false>(blocks);
  if (head_dim == 96 && !alibi) return blocks_per_sm<96, false>(blocks);
  return (int)cudaErrorInvalidValue;
}

// C entry point: the forward with o written in fp32 (ring attention's
// per-block partials, merged by their lse in fp32 before one rounding).
// Arguments as ymt_flash_fwd_bf16's, o an fp32 [B, H, Sq, head_dim] view
// (8-byte aligned rows); built at head dim 64 without ALiBi (the ring's
// blocks), cudaErrorInvalidValue elsewhere.
extern "C" int ymt_flash_fwd_f32out(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Sk, int kv_len, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int period, int causal,
    int head_dim, const void* slopes, int splits, void* o_part,
    void* lse_part, void* stream) {
  if (splits < 1 || head_dim != 64 || slopes != nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<64, false, true>(
      q, k, v, o, lse, o_part, lse_part, slopes, B, H, Sq, Sk, kv_len, splits,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
      scale, period, causal, static_cast<cudaStream_t>(stream));
}

// C entry point: the fp32-output forward's blocks resident on one SM at a
// head dim, as ymt_flash_fwd_blocks_per_sm counts them;
// cudaErrorInvalidValue for a head dim it was not built for.
extern "C" int ymt_flash_fwd_f32out_blocks_per_sm(int head_dim, int* blocks) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  return blocks_per_sm<64, false, true>(blocks);
}
