// The bfloat16 decode-attention body for Hopper (sm_90a) that both
// decode_attention.cu (head-major contiguous caches) and
// paged_decode_attention.cu (block pools walked through block tables)
// launch.  Only the producer's addressing differs between the two; the
// consumer code is this one copy.
//
// One block per (split, KV head, sequence): a producer warp streams
// 64-row K and V tiles with TMA into a ring of STAGES stages (full and
// empty mbarriers); four consumer warps own 16 rows of every tile each and
// keep their own online softmax over them: S^T = K q^T and O^T += V^T P^T
// on mma.sync m16n8k16 (rows as M, the G <= 8 query heads as N), P^T from
// the scores' accumulator by movmatrix.  After the walk the four warps'
// states merge in shared memory; the block writes its split's (m, l, acc)
// and the last block of the (sequence, KV head), by a self-resetting
// ticket, sums the splits in split order and writes the output.
//
// Addressing (the producer's, the rest is shared):
//   contiguous  a 4-D map over (D, S, Hkv, B), one 64-row box per tile
//               and 64-column region;
//   paged       a 4-D map over the pool as (D, bs, Hkv, n_blocks) with
//               boxes of `box` = gcd(bs, 64) rows: logical row r of
//               sequence b lies at row r % bs of pool block
//               tables[b, r / bs], so a 64-row tile takes 64 / box loads
//               (4 at bs 16, 2 at bs 32, 1 at bs >= 64), spread over the
//               producer warp's lanes; each lane reads its table entries
//               for the next tile while the ring drains.  Only sub-loads
//               that start below the split's end are issued (and only
//               their bytes expected), so table entries past the live
//               blocks are never read.  The 128-byte swizzle is a
//               function of the shared-memory address, so boxes of fewer
//               than 8 rows land where one 64-row box would put them.
#pragma once

#include <math_constants.h>

#include "hopper.cuh"

namespace {

typedef unsigned short u16;

constexpr int kRows = 64;      // K/V rows per tile
constexpr int kCons = 4;       // consumer warps, 16 rows of a tile each
constexpr int kBfThreads = (kCons + 1) * 32;
constexpr int kRegion = kRows * 128;  // one 64-column swizzle region, bytes
constexpr int kMaxSplits = 64;        // splits of one cache walk, at most

template <int D, int STAGES>
struct Bf {
  static constexpr int TILE = kRegion * (D / 64);  // K or V tile, bytes
  static constexpr int STAGE = 2 * TILE;
  // the ring, 1 KB of slack to align it to the swizzle's 1 KB atoms, and
  // the barriers; the merge of the warps reuses the ring
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8 + 16;
  // the warps' merge, then the combine's weights of up to kMaxSplits
  static_assert(kCons * 8 * (D + 2) * 4 + 8 * kMaxSplits * 12 <=
                    STAGES * STAGE,
                "merge and combine fit the ring");
};

// the 8 x 8 b16 matrix held a row pair a lane (row lane / 4), transposed
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// byte offset of (row, channel d) in a TMA tile of 64-column regions,
// 128-byte swizzle (16-byte chunk c of row r lands at c ^ (r % 8)); d is
// a multiple of 8
__device__ __forceinline__ uint32_t swz(int row, int d) {
  return (d >> 6) * kRegion + row * 128 +
         ((((d & 63) >> 3) ^ (row & 7)) << 4);
}

// the max (or sum) over the 8 lanes holding one head's rows (lane / 4)
__device__ __forceinline__ float rows_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}
__device__ __forceinline__ float rows_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// The float32 outputs of a launch that returns the log-sum-exp (the
// sequence-sharded decode combines ranks' partials with it): when `out`
// is set the output is written there unrounded, [B, H, D] float, in place
// of the bfloat16 one, and `lse` [B, H] gets ln(sum_j exp(s_j)) of each
// row's scaled scores, -inf where the row has no live key (its output
// is then 0).  Null for every other launch.
struct LseOut {
  float* out;
  float* lse;
};

constexpr float kLn2 = 0.6931471805599453f;

// the natural log-sum-exp of a row from its max `mx` in log2 units and
// its sum `l` of 2^(s - mx): -inf for a row with no live key
__device__ __forceinline__ float lse_of(float mx, float l) {
  return l > 0.f ? fmaf(mx, kLn2, logf(l)) : -CUDART_INF_F;
}

// Where the paged producer finds a sequence's rows; unused (null) for
// contiguous caches.
struct PagedRows {
  const int* tables;  // [B, NB], row stride `stride` elements
  i64 stride;
  int bs;             // rows per pool block
  int box;            // rows per TMA box: gcd(bs, 64)
};

// grid (splits, Hkv, B).  Scores are kept in log2 units (scale * log2 e
// folded into one multiply), m and l per (split, query head) likewise.
// S is the walk's row capacity (the cache length, or NB * bs).
template <int D, int STAGES, bool PAGED>
__device__ __forceinline__ void decode_bf16_body(
    const CUtensorMap* kmap, const CUtensorMap* vmap, const u16* q,
    const int* kv_len, u16* out, float* part_acc, float* part_ml,
    int* tickets, int H, int Hkv, int S, i64 qsb, i64 qsh, int splits,
    int chunk, float scale_log2, const PagedRows& pg,
    const LseOut lse_out = LseOut{nullptr, nullptr}) {
  typedef Bf<D, STAGES> C;
  const float NEG_INF = -CUDART_INF_F;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + STAGES * C::STAGE, empty = full + 8 * STAGES;
  int* last_flag = reinterpret_cast<int*>(smem + STAGES * C::STAGE +
                                          16 * STAGES);

  const int len = min(kv_len[b], S);
  const int lo = split * chunk, hi = min(lo + chunk, len);
  const int ntiles = hi > lo ? (hi - lo + kRows - 1) / kRows : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons) {  // producer: keeps the ring full
    if constexpr (!PAGED) {
      if (lane == 0)
        for (int i = 0; i < ntiles; ++i) {
          const int s = i % STAGES;
          mbar_spin(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, C::STAGE);
          const uint32_t dst = ring + s * C::STAGE;
#pragma unroll
          for (int r = 0; r < D / 64; ++r) {
            tma_load(dst + r * kRegion, kmap, full + 8 * s, r * 64,
                     lo + i * kRows, hk, b);
            tma_load(dst + C::TILE + r * kRegion, vmap, full + 8 * s, r * 64,
                     lo + i * kRows, hk, b);
          }
        }
    } else {
      // sub-load j of a tile (rows j * box ...) belongs to lane j % 32;
      // kRows / box <= 64, so two per lane at most
      const int* tab = pg.tables + (i64)b * pg.stride;
      const int box = pg.box, bs = pg.bs;
      int nxt[2] = {0, 0};
      auto entries = [&](int i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lo + i * kRows + (lane + 32 * e) * box;
          if ((lane + 32 * e) * box < kRows && r < hi) nxt[e] = tab[r / bs];
        }
      };
      if (ntiles > 0) entries(0);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const int cur[2] = {nxt[0], nxt[1]};
        if (i + 1 < ntiles) entries(i + 1);  // in flight while we wait
        const int row0 = lo + i * kRows;
        const int n_live = (min(kRows, hi - row0) + box - 1) / box;
        if (lane == 0) {
          mbar_spin(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, n_live * box * 128 * (D / 64) * 2);
        }
        __syncwarp();
        const uint32_t dst = ring + s * C::STAGE;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = lane + 32 * e;
          if (j < n_live) {
            const int in_block = (row0 + j * box) % bs;
#pragma unroll
            for (int r = 0; r < D / 64; ++r) {
              tma_load(dst + r * kRegion + j * box * 128, kmap, full + 8 * s,
                       r * 64, in_block, hk, cur[e]);
              tma_load(dst + C::TILE + r * kRegion + j * box * 128, vmap,
                       full + 8 * s, r * 64, in_block, hk, cur[e]);
            }
          }
        }
      }
    }
    return;
  }

  // q^T as the B operand of S^T = K q^T: head g's channels 16ks + 2t (+1)
  // and 16ks + 8 + 2t (+1); heads past G are zero
  uint32_t qf[D / 16][2];
  {
    const u16* qh = q + (i64)b * qsb + (i64)(hk * G + g) * qsh;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t lo2 = 0, hi2 = 0;
      if (g < G) {
        const int d = 16 * ks + 2 * t;
        lo2 = (uint32_t)qh[d] | ((uint32_t)qh[d + 1] << 16);
        hi2 = (uint32_t)qh[d + 8] | ((uint32_t)qh[d + 9] << 16);
      }
      qf[ks][0] = lo2;
      qf[ks][1] = hi2;
    }
  }

  // this thread's heads 2t and 2t + 1: running max, partial sum over its
  // rows, and O^T's columns (channels 16mt + g, + 8)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;

  const int r0 = 16 * warp;  // the warp's rows in every tile
  const int j = lane >> 3;   // the ldmatrix matrix this lane addresses
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t kt = ring + s * C::STAGE, vt = kt + C::TILE;
    const int row0 = lo + i * kRows + r0;  // cache row of the warp's row 0

    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm4<false>(a, kt + swz(r0 + (lane & 7) + 8 * (j & 1),
                                16 * ks + 8 * (j >> 1)));
      mma_bf16(c, a, qf[ks][0], qf[ks][1]);
    }
    // c: rows g (c0, c1) and g + 8 (c2, c3), heads 2t and 2t + 1
    const bool live0 = row0 + g < hi, live1 = row0 + g + 8 < hi;
    const float s0 = live0 ? c[0] * scale_log2 : NEG_INF;
    const float s1 = live0 ? c[1] * scale_log2 : NEG_INF;
    const float s2 = live1 ? c[2] * scale_log2 : NEG_INF;
    const float s3 = live1 ? c[3] * scale_log2 : NEG_INF;
    const float mn0 = fmaxf(m[0], rows_max(fmaxf(s0, s2)));
    const float mn1 = fmaxf(m[1], rows_max(fmaxf(s1, s3)));
    // no live row yet: exponentiate against 0, so every p is 0, not NaN
    const float ref0 = mn0 == NEG_INF ? 0.f : mn0;
    const float ref1 = mn1 == NEG_INF ? 0.f : mn1;
    const float p0 = ex2(s0 - ref0), p1 = ex2(s1 - ref1);
    const float p2 = ex2(s2 - ref0), p3 = ex2(s3 - ref1);
    const float corr0 = ex2(m[0] - ref0), corr1 = ex2(m[1] - ref1);
    l[0] = fmaf(l[0], corr0, p0 + p2);
    l[1] = fmaf(l[1], corr1, p1 + p3);
    m[0] = mn0;
    m[1] = mn1;
    // rows past hi in the last tile: V zeroed, so 0 * (whatever lies in
    // shared memory there: the cache, or a stale tile where the paged
    // producer issued no load) stays 0
    if (row0 + 16 > hi) {
      for (int e = lane; e < 16 * (D / 8); e += 32) {
        const int r = e / (D / 8);
        if (row0 + r >= hi)
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                           vt + swz(r0 + r, 8 * (e % (D / 8)))),
                       "r"(0)
                       : "memory");
      }
      __syncwarp();
    }
    // P^T as the B operand of O^T += V^T P^T: rows 2t, 2t + 1 (and + 8)
    // of head g, rounded to bf16 as the Pallas kernel rounds p
    const uint32_t pb0 = transpose8(pack_bf16(p0, p1));
    const uint32_t pb1 = transpose8(pack_bf16(p2, p3));
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      o[mt][0] *= corr0;
      o[mt][1] *= corr1;
      o[mt][2] *= corr0;
      o[mt][3] *= corr1;
      uint32_t a[4];
      ldsm4<true>(a, vt + swz(r0 + (lane & 7) + 8 * (j >> 1),
                               16 * mt + 8 * (j & 1)));
      mma_bf16(o[mt], a, pb0, pb1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  l[0] = rows_sum(l[0]);
  l[1] = rows_sum(l[1]);

  // merge the four warps' states through the (drained) ring: per warp and
  // head, D channels of acc then (m, l)
  named_sync(1, kCons * 32);
  float* ms = reinterpret_cast<float*>(smem);
  auto at = [&](int w, int h) { return ms + (w * 8 + h) * (D + 2); };
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      at(warp, 2 * t + (e & 1))[16 * mt + g + (e >= 2 ? 8 : 0)] = o[mt][e];
  if (g == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      at(warp, 2 * t + e)[D] = m[e];
      at(warp, 2 * t + e)[D + 1] = l[e];
    }
  named_sync(1, kCons * 32);

  const size_t bh0 = (size_t)b * H + (size_t)hk * G;  // row of head 0
  for (int i = tid; i < G * D; i += kCons * 32) {
    const int h = i / D, d = i - h * D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < kCons; ++w) mx = fmaxf(mx, at(w, h)[D]);
    float acc = 0.f, sum = 0.f;
    if (mx > NEG_INF)
#pragma unroll
      for (int w = 0; w < kCons; ++w) {
        const float wt = ex2(at(w, h)[D] - mx);
        acc = fmaf(wt, at(w, h)[d], acc);
        sum = fmaf(wt, at(w, h)[D + 1], sum);
      }
    if (splits == 1) {
      if (lse_out.out) {
        lse_out.out[(bh0 + h) * D + d] = acc / fmaxf(sum, 1e-30f);
        if (d == 0) lse_out.lse[bh0 + h] = lse_of(mx, sum);
      } else {
        out[(bh0 + h) * D + d] = __bfloat16_as_ushort(
            __float2bfloat16(acc / fmaxf(sum, 1e-30f)));
      }
    } else {
      part_acc[((bh0 + h) * splits + split) * D + d] = acc;
      if (d == 0) {
        float* ml = part_ml + ((bh0 + h) * splits + split) * 2;
        ml[0] = mx;
        ml[1] = sum;
      }
    }
  }
  if (splits == 1) return;

  // the last split of this (sequence, KV head) to finish combines them all
  __threadfence();
  named_sync(1, kCons * 32);
  if (tid == 0) {
    int* ticket = tickets + (size_t)b * Hkv + hk;
    const int done = atomicAdd(ticket, 1) == splits - 1;
    if (done) *ticket = 0;  // ready for the next launch
    *last_flag = done;
  }
  named_sync(1, kCons * 32);
  if (!*last_flag) return;
  __threadfence();
  // each head's splits: (m, l) into shared memory past the merge area,
  // then one thread per head turns m into the split's weight and sums l;
  // the outputs sum acc in split order, the loads of eight splits in
  // flight before their adds
  float2* wl = reinterpret_cast<float2*>(ms + kCons * 8 * (D + 2));
  float* lsum = reinterpret_cast<float*>(wl + 8 * splits);
  for (int i = tid; i < G * splits; i += kCons * 32)
    wl[i] = __ldcg(reinterpret_cast<const float2*>(part_ml) +
                   (bh0 + i / splits) * splits + i % splits);
  named_sync(1, kCons * 32);
  for (int h = tid; h < G; h += kCons * 32) {
    float mx = NEG_INF, sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, wl[h * splits + sp].x);
    for (int sp = 0; sp < splits; ++sp) {
      const float wt = mx > NEG_INF ? ex2(wl[h * splits + sp].x - mx) : 0.f;
      sum = fmaf(wt, wl[h * splits + sp].y, sum);
      wl[h * splits + sp].x = wt;
    }
    lsum[h] = fmaxf(sum, 1e-30f);
    if (lse_out.out) lse_out.lse[bh0 + h] = lse_of(mx, sum);
  }
  named_sync(1, kCons * 32);
  for (int i = tid; i < G * D; i += kCons * 32) {
    const int h = i / D, d = i - h * D;
    const float* pa = part_acc + (bh0 + h) * splits * D + d;
    float acc = 0.f;
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      float u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (sp0 + q < splits) u[q] = __ldcg(pa + (size_t)(sp0 + q) * D);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (sp0 + q < splits) acc = fmaf(wl[h * splits + sp0 + q].x, u[q], acc);
    }
    if (lse_out.out)
      lse_out.out[(bh0 + h) * D + d] = acc / lsum[h];
    else
      out[(bh0 + h) * D + d] =
          __bfloat16_as_ushort(__float2bfloat16(acc / lsum[h]));
  }
}

}  // namespace
