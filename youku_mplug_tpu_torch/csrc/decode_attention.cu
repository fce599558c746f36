// One decode step's cache write and single-token attention over the
// stacked packed KV cache, in one launch, for Hopper (sm_90a): bf16 or int8
// cache, fp32 online softmax, head dim 64, 80 or 128, optionally (64 and
// 128) with the ALiBi bias of the Bloom decoder.
//
// Replaces two Pallas TPU kernels and the call that ran them in a row:
// youku_mplug_tpu/ops/decode_attention.py (_kernel, wrapper
// decode_attention; bf16 cache, and int8 cache with per-(token, head)
// scales, quantized=True) and youku_mplug_tpu/ops/kv_cache.py
// (_scatter_kernel, wrapper cache_scatter_write, with the quantize_rows
// that feeds it in cache_write), as the JAX decode step runs them: write
// the new token's K|V row at row cache_len[b] of layer lidx, then attend
// over keys valid_from[b] <= j <= cache_len[b].  The cache is
// [L, B, M, 2*n*d] with each row = [K | V] lanes; layer lidx is read in
// place.  A sample with no live key gets zeros; cache_len[b] >= M reads
// rows up to M-1 and writes nothing (JAX leaves that write undefined: XLA
// clamps it to row M-1, the scatter kernel's window to the last one; the
// serving engine never sends it).
//
// ALiBi: score = scale * q.k + slope_h * j, j the absolute key position,
// added after the scale and before the running max, all in fp32.  The
// slope ladder is generated from the head index as the TPU kernel does
// (decode_attention.py:104-110): 2^(-8(h+1)/c) for the first c heads, c
// the largest power of two <= n, then 2^(-4(2(h-c)+1)/c); the wrapper
// checks that the caller's slopes are that ladder.  On a model shard the
// launch holds a contiguous slice of the heads: its head h is head
// h + head_offset of n_total, and takes that head's slope (the TPU kernel
// always sees every head, so it needs no offset).
//
// int8 cache: a second array [L, B, M, 2*n] holds one fp32 scale per
// (row, head of the 2n K and V heads).  The dequant follows the TPU
// kernel's order (decode_attention.py:123-142): score = (q . k_int8) *
// scale * k_scale[j, h], the bias after the K scale; l sums the unscaled
// p; the accumulator takes (p * v_scale[j, h]) * v_int8.  The new row is
// quantized bit for bit as quantize_rows does it: absmax over the head's d
// lanes, s = max(amax, 1e-8) / 127 as an IEEE division, rint(x / s) (half
// to even, IEEE division) clipped to +-127.
//
// What bounds it on the H100: 2 operations per cache byte, so bytes and,
// at the serving sizes (8 samples x <= 256 keys), latency.  The design:
// - Each (head, sample) is one thread block cluster of kCluster = 2
//   blocks (the fastest of 1, 2, 4 and 8 at every serving shape, see
//   PERF.md).  The keys the step reads from the cache are split into two
//   equal shares computed on the device, so the longest sample no longer
//   runs on one block; a block with an empty share loads nothing.  Each
//   block stores its partial (m, l, acc) state into its slot of block 0's
//   shared memory (distributed shared memory, one barrier.cluster), and
//   block 0 merges the slots: no second launch, no global scratch, no
//   atomics, so the output is bitwise repeatable.
// - Wide loads: a team of D / 8 lanes reads one head's slice of one row, 8
//   values a lane (16 bytes bf16, 8 bytes int8: both caches share one
//   geometry and register budget).  Teams never straddle a warp: a warp
//   holds 32 / (D / 8) of them (4 at d 64, 3 at d 80, 2 at d 128), so a
//   warp reads that many rows a load.  At d 80 a team is 10 lanes, lanes
//   0-9, 10-19 and 20-29 of the warp; lanes 30 and 31 shadow lane 20
//   (the same loads and values, which they never store).  Each team
//   issues the K and V loads of kRows rows before it uses any; on an int8
//   cache each lane also loads the two scales of one of those rows, and
//   shuffles hand them to the team.
// - A team's sums (q . k) and maxima (the int8 absmax) are shuffle
//   reductions inside the warp: a butterfly over a team of 8 or 16 lanes,
//   an aligned group of the warp; at 10 lanes a tree into the team's
//   first lane from explicit source lanes, then a broadcast
//   (team_reduce).
// - The cache write: warp 0 of the cluster's last block loads head h's new
//   K and V slices with q, writes them (int8: quantized, and the two
//   scales) while its first round of cache loads is in flight, and starts
//   its state from the new key as it wrote it, so no block reads row
//   cache_len[b] of head h from memory and no ordering between blocks is
//   needed.  The result equals write-then-attend.
//
// Block: 4 warps, 4 x 32 / (D / 8) teams (16, 12, 8); lane tl of a team
// owns head features E*tl .. E*tl + E-1 (E = 8).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;    // rows a team loads before it uses any
constexpr int kValues = 8;  // values of a row a lane loads: 16 bytes bf16,
                            // 8 int8, so both caches share one geometry
constexpr int kCluster = 2;  // blocks that split a (head, sample)'s keys

template <int kBytes>
struct VecOf;
template <>
struct VecOf<8> {
  using type = uint2;
};
template <>
struct VecOf<16> {
  using type = uint4;
};

__device__ __forceinline__ void words(const uint2& r, uint32_t (&w)[2]) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void words(const uint4& r, uint32_t (&w)[4]) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ uint2 vec(const uint32_t (&w)[2]) {
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ uint4 vec(const uint32_t (&w)[4]) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// E bf16 values at p (2-byte aligned; one 16-byte load each 8 values
// when p is 16-byte aligned) -> their raw bits in pairs
template <int E>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          uint32_t (&raw)[E / 2]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      raw[4 * i] = w.x;
      raw[4 * i + 1] = w.y;
      raw[4 * i + 2] = w.z;
      raw[4 * i + 3] = w.w;
    }
  } else {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      raw[i] = s[2 * i] | (uint32_t)s[2 * i + 1] << 16;
    }
  }
}

// byte i of w as a signed int8, exactly: 2^23 + (x + 128) - (2^23 + 128),
// one byte permute and one add instead of an integer conversion
__device__ __forceinline__ float s8_to_float(uint32_t w, int i) {
  const uint32_t u = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | i);
  return __uint_as_float(u) - 8388736.f;
}

// the words of a lane's slice of a row (int8 or bf16) -> E fp32 values
template <bool kInt8, int E, int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W],
                                       float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if constexpr (kInt8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[4 * k + i] = s8_to_float(w[k], i);
    } else {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// x summed (kMax: maxed) over the kLanes lanes of this lane's team, the
// result in every lane of the team (tl: the lane's index in its team;
// first: the warp lane of the team's lane 0).  Every lane of the warp
// calls it.  A team of 8 or 16 lanes is an aligned group of the warp and
// reduces by a butterfly.  Otherwise (10 lanes at d 80) lane i adds lane
// i + off while tl + off < kLanes, for off = 1, 2, 4, 8: after the step
// at `off`, lane i holds lanes i .. min(i + 2 off, kLanes) - 1, so the
// first lane holds the team's whole sum, which it then broadcasts.
template <int kLanes, bool kMax>
__device__ __forceinline__ float team_reduce(float x, int tl, int first) {
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : a + b; };
  if constexpr ((kLanes & (kLanes - 1)) == 0) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      x = op(x, __shfl_xor_sync(0xffffffffu, x, off));
    }
    return x;
  } else {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float y = __shfl_sync(0xffffffffu, x, (lane + off) & 31);
      if (tl + off < kLanes) x = op(x, y);
    }
    return __shfl_sync(0xffffffffu, x, first);
  }
}

// quantize_rows on one head spread over a team of kLanes lanes (E values
// each): x becomes the rounded int8 values (as floats); returns the scale
template <int E, int kLanes>
__device__ __forceinline__ float quantize_head(float (&x)[E], int tl,
                                               int first) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(x[i]));
  amax = team_reduce<kLanes, true>(amax, tl, first);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    x[i] = fminf(fmaxf(rintf(__fdiv_rn(x[i], s)), -127.f), 127.f);
  }
  return s;
}

// E int8 values held as floats -> their E bytes in words
template <int E>
__device__ __forceinline__ void pack_s8(const float (&x)[E],
                                        uint32_t (&w)[E / 4]) {
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    w[k] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[k] |= (uint32_t)(uint8_t)(int8_t)(int)x[4 * k + i] << (8 * i);
    }
  }
}

// the standard ALiBi slope of head h of n (models/bloom.py alibi_slopes)
__device__ __forceinline__ float alibi_slope(int h, int n) {
  int c = 1;
  while (2 * c <= n) c *= 2;
  const float e = h < c ? -8.f * (h + 1) / c : -4.f * (2 * (h - c) + 1) / c;
  return exp2f(e);
}

template <int E>
__device__ __forceinline__ float dot(const float (&a)[E], const float (&b)[E]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) s += a[i] * b[i];
  return s;
}

template <int D, bool kAlibi, bool kInt8>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_sb,
                   long long q_sh, const __nv_bfloat16* __restrict__ k_new,
                   long long k_sb, long long k_sh,
                   const __nv_bfloat16* __restrict__ v_new, long long v_sb,
                   long long v_sh, void* ckv, float* kv_scales,
                   __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ cache_len,
                   const int* __restrict__ valid_from, int n, int M,
                   int lidx, float scale, int head_offset, int n_total) {
  using T = std::conditional_t<kInt8, int8_t, __nv_bfloat16>;
  constexpr int E = kValues;
  constexpr int kLoad = E * sizeof(T);  // bytes a lane loads from a row
  using V = typename VecOf<kLoad>::type;
  constexpr int W = kLoad / 4;          // their 32-bit words
  constexpr int kLanes = D / E;         // lanes of a team: one head slice
  constexpr int kPerWarp = 32 / kLanes;  // teams a warp: 4, 3 (d 80), 2
  constexpr int kTeams = kWarps * kPerWarp;
  constexpr int kStep = kTeams * kRows;  // rows a block reads a round
  static_assert(D % E == 0 && kLanes <= 32, "a team is one head slice");
  static_assert(kRows <= kLanes, "a team's lanes load its rows' scales");

  // every block arrives once it has started; block 0's shared memory is
  // written by the others only after the matching wait
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / C, b = blockIdx.y, B = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the lanes past a warp's last team (30 and 31 at d 80) shadow lane 0
  // of that team: they load and compute what it does and store nothing
  const bool spare = lane >= kPerWarp * kLanes;
  const int slot = spare ? kPerWarp - 1 : lane / kLanes;
  const int team = warp * kPerWarp + slot, tl = spare ? 0 : lane % kLanes;
  const int first = slot * kLanes;  // the warp lane of the team's lane 0
  const long long nd = (long long)n * D;
  const long long row_stride = 2 * nd;
  const long long row0 = ((long long)lidx * B + b) * M;  // (lidx, b, 0)
  // this lane's bytes of head h's K slice in row 0 of sample b (the V
  // slice is nd further), and the K scale of head h in row 0 (V: n further)
  T* const rows = static_cast<T*>(ckv) + row0 * row_stride + h * D + tl * E;
  float* const sc = kInt8 ? kv_scales + row0 * 2 * n + h : nullptr;

  // the loads that need no index go out first, together: q, and for the
  // writer (warp 0 of the cluster's last block) the new K and V slices
  const bool writer = rank == C - 1 && warp == 0;
  float qf[E];
  uint32_t kraw[E / 2], vraw[E / 2];
  {
    uint32_t raw[E / 2];
    load_bf16<E>(q + b * q_sb + h * q_sh + tl * E, raw);
    unpack<false>(raw, qf);
  }
  if (writer) {
    load_bf16<E>(k_new + b * k_sb + h * k_sh + tl * E, kraw);
    load_bf16<E>(v_new + b * v_sb + h * v_sh + tl * E, vraw);
  }
  const float slope = kAlibi ? alibi_slope(h + head_offset, n_total) : 0.f;
  const int idx = cache_len[b];  // the new row
  const int lo = max(valid_from[b], 0), hi = min(idx, M - 1);
  const bool write = idx >= 0 && idx < M;
  const bool new_live = write && idx >= lo;  // then idx == hi
  // keys read from the cache: lo .. lo + count - 1 (the new key, when
  // live, comes from registers), split into C equal shares
  const int count = max(hi - lo + 1 - (new_live ? 1 : 0), 0);
  const int share = (count + C - 1) / C;
  const int start = lo + rank * share;
  const int end = min(start + share, lo + count) - 1;  // < start: empty
  const int rounds = end >= start ? (end - start + kStep) / kStep : 0;

  // a round's loads: the K and V slices of the team's kRows rows (rows
  // past the share re-read its last row and are masked below), and on an
  // int8 cache, for lane tl of a team, the K and V scales of the team's
  // row tl mod kRows (shuffles hand row t's to the team)
  V kr[kRows], vr[kRows];
  float ksl = 0.f, vsl = 0.f;
  auto load_round = [&](int r) {
    const int j0 = start + r * kStep + team;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const T* p = rows + (long long)min(j0 + t * kTeams, end) * row_stride;
      kr[t] = *reinterpret_cast<const V*>(p);
      vr[t] = *reinterpret_cast<const V*>(p + nd);
    }
    if constexpr (kInt8) {
      const long long j = min(j0 + (tl % kRows) * kTeams, end);
      ksl = sc[j * 2 * n];
      vsl = sc[j * 2 * n + n];
    }
  };
  if (rounds > 0) load_round(0);

  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  // the cache write, while the first round's loads are in flight (every
  // team of the writer warp computes it, so the shuffles see the whole
  // warp; team 0 stores it and starts its state from the new key)
  if (write && writer) {
    float kf[E], vf[E];
    unpack<false>(kraw, kf);
    unpack<false>(vraw, vf);
    T* const dst = rows + (long long)idx * row_stride;
    float ksn = 1.f, vsn = 1.f;
    if constexpr (kInt8) {
      ksn = quantize_head<E, kLanes>(kf, tl, first);
      vsn = quantize_head<E, kLanes>(vf, tl, first);
      if (team == 0) {  // no spare lane: those sit in the warp's last team
        uint32_t kw[W], vw[W];
        pack_s8<E>(kf, kw);
        pack_s8<E>(vf, vw);
        *reinterpret_cast<V*>(dst) = vec(kw);
        *reinterpret_cast<V*>(dst + nd) = vec(vw);
        if (tl == 0) {
          sc[(long long)idx * 2 * n] = ksn;
          sc[(long long)idx * 2 * n + n] = vsn;
        }
      }
    } else if (team == 0) {
      *reinterpret_cast<V*>(dst) = vec(kraw);
      *reinterpret_cast<V*>(dst + nd) = vec(vraw);
    }
    if (new_live) {
      const float s = team_reduce<kLanes, false>(dot<E>(qf, kf), tl, first);
      if (team == 0) {
        m = s * scale * ksn;  // the score as the loop forms it
        if constexpr (kAlibi) m += slope * (float)idx;
        l = 1.f;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] = vsn * vf[i];
      }
    }
  }

  // rounds is uniform over the block, so every lane takes the shuffles
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) load_round(r);
    const int j0 = start + r * kStep + team;
    float ks[kRows], vs[kRows];
    if constexpr (kInt8) {
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        ks[t] = __shfl_sync(0xffffffffu, ksl, first + t);
        vs[t] = __shfl_sync(0xffffffffu, vsl, first + t);
      }
    }
    float s[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      uint32_t w[W];
      words(kr[t], w);
      float kt[E];
      unpack<kInt8>(w, kt);
      s[t] = dot<E>(qf, kt);
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      s[t] = team_reduce<kLanes, false>(s[t], tl, first);
    }
    float x[kRows], m_new = m;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int j = j0 + t * kTeams;
      float st = s[t] * scale;
      if constexpr (kInt8) st *= ks[t];  // K dequant, before the bias
      if constexpr (kAlibi) st += slope * (float)j;
      x[t] = j <= end ? st : -INFINITY;
      m_new = fmaxf(m_new, x[t]);
    }
    if (m_new != -INFINITY) {  // a team past the share's end: no change
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const float p = __expf(x[t] - m_new);
        l += p;
        const float pv = kInt8 ? p * vs[t] : p;  // V dequant folds into p
        uint32_t w[W];
        words(vr[t], w);
        float vt[E];
        unpack<kInt8>(w, vt);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] += pv * vt[i];
      }
      m = m_new;
    }
  }

  // merge the teams of the block; each block then stores its state into
  // slot `rank` of block 0's shared memory, and block 0 merges the slots
  __shared__ float sm_m[kTeams], sm_l[kTeams];
  __shared__ __align__(16) float sm_acc[kTeams][D];
  __shared__ float cl_ml[kCluster][2];
  __shared__ __align__(16) float cl_acc[kCluster][D];
  if (!spare) {
    if (tl == 0) {
      sm_m[team] = m;
      sm_l[team] = l;
    }
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      *reinterpret_cast<float4*>(&sm_acc[team][tl * E + i]) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
  }
  __syncthreads();
  const int f = threadIdx.x;  // the head feature this thread merges
  float mx = -INFINITY, den = 0.f, o = 0.f;
  if (f < D) {
#pragma unroll
    for (int t = 0; t < kTeams; ++t) mx = fmaxf(mx, sm_m[t]);
    if (mx != -INFINITY) {
#pragma unroll
      for (int t = 0; t < kTeams; ++t) {
        const float w = __expf(sm_m[t] - mx);  // a team with no key: 0
        den += sm_l[t] * w;
        o += sm_acc[t][f] * w;
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (f < D) {
    cluster.map_shared_rank(&cl_acc[rank][0], 0)[f] = o;
    if (f == 0) {
      float* ml = cluster.map_shared_rank(&cl_ml[rank][0], 0);
      ml[0] = mx;
      ml[1] = den;
    }
  }
  cluster.sync();  // the slots are written and visible to block 0
  if (rank == 0 && f < D) {
    float mc = -INFINITY;
#pragma unroll
    for (int r = 0; r < C; ++r) mc = fmaxf(mc, cl_ml[r][0]);
    float dc = 0.f, oc = 0.f;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (cl_ml[r][0] != -INFINITY) {
        const float w = __expf(cl_ml[r][0] - mc);
        dc += cl_ml[r][1] * w;
        oc += cl_acc[r][f] * w;
      }
    }
    out[b * nd + h * D + f] = __float2bfloat16_rn(dc > 0.f ? oc / dc : 0.f);
  }
}

template <int D, bool kAlibi, bool kInt8>
cudaError_t launch(const void* q, long long q_sb, long long q_sh,
                   const void* k, long long k_sb, long long k_sh,
                   const void* v, long long v_sb, long long v_sh, void* ckv,
                   void* kv_scales, void* out, const void* cache_len,
                   const void* valid_from, int B, int n, int M, int lidx,
                   float scale, int head_offset, int n_total,
                   cudaStream_t stream) {
  decode_attn_kernel<D, kAlibi, kInt8>
      <<<dim3(kCluster * n, B), kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q), q_sb, q_sh,
          static_cast<const __nv_bfloat16*>(k), k_sb, k_sh,
          static_cast<const __nv_bfloat16*>(v), v_sb, v_sh, ckv,
          static_cast<float*>(kv_scales), static_cast<__nv_bfloat16*>(out),
          static_cast<const int*>(cache_len),
          static_cast<const int*>(valid_from), n, M, lidx, scale,
          head_offset, n_total);
  return cudaGetLastError();
}

// f(head dim, alibi, int8) with each as a compile-time constant
template <typename F>
cudaError_t dispatch(int head_dim, int alibi, bool int8, F f) {
  auto by_cache = [&](auto d) {
    if (int8) {
      return alibi ? f(d, std::true_type{}, std::true_type{})
                   : f(d, std::false_type{}, std::true_type{});
    }
    return alibi ? f(d, std::true_type{}, std::false_type{})
                 : f(d, std::false_type{}, std::false_type{});
  };
  if (head_dim == 64) return by_cache(std::integral_constant<int, 64>{});
  if (head_dim == 128) return by_cache(std::integral_constant<int, 128>{});
  if (head_dim == 80 && !alibi) {  // the GPT-3 2.7B decoder: no ALiBi build
    constexpr std::integral_constant<int, 80> d{};
    return int8 ? f(d, std::false_type{}, std::true_type{})
                : f(d, std::false_type{}, std::false_type{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (loaded with ctypes).  q, k, v: [B, n, head_dim] bf16,
// each with its own batch and head strides (elements; the head dim
// contiguous): the step's query and its new K and V rows; ckv: contiguous
// [L, B, M, 2*n*head_dim] at a 16-byte aligned address, bf16, or int8 when
// kv_scales is not null; kv_scales: null, or contiguous fp32 [L, B, M,
// 2*n]; out: contiguous [B, n*head_dim] bf16; cache_len, valid_from: int32
// [B] on the device.  Writes k and v at row cache_len[b] of layer lidx
// (nothing where cache_len[b] is outside [0, M)), then attends over rows
// valid_from[b] .. min(cache_len[b], M-1).  head_dim 64, 80 or 128;
// alibi != 0 (64 and 128 only) adds the standard ALiBi ladder of n_total
// heads, of which the launch's n are heads head_offset .. head_offset + n - 1
// (a model shard's; 0 and n unsharded).  Returns the
// launch's error, or cudaErrorInvalidValue for a head dim (or ALiBi at a
// head dim) it was not built for.
extern "C" int ymt_decode_attention(
    const void* q, long long q_sb, long long q_sh, const void* k,
    long long k_sb, long long k_sh, const void* v, long long v_sb,
    long long v_sh, void* ckv, void* kv_scales, void* out,
    const void* cache_len, const void* valid_from, int B, int n, int M,
    int lidx, float scale, int head_dim, int alibi, int head_offset,
    int n_total, void* stream) {
  return (int)dispatch(
      head_dim, alibi, kv_scales != nullptr, [&](auto d, auto a, auto q8) {
        return launch<decltype(d)::value, decltype(a)::value,
                      decltype(q8)::value>(
            q, q_sb, q_sh, k, k_sb, k_sh, v, v_sb, v_sh, ckv, kv_scales, out,
            cache_len, valid_from, B, n, M, lidx, scale, head_offset,
            n_total, static_cast<cudaStream_t>(stream));
      });
}
