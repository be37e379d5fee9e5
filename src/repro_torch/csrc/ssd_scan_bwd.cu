// The backward of the Mamba2 SSD chunked scan for Hopper (sm_90a): the
// gradients SSM co-training needs of kernels/ssd_scan.py::ssd_scan.
//
// It replaces no TPU kernel: the Pallas ssd_scan (src/repro/kernels/
// ssd_scan.py:78) is forward only, and JAX trains through autodiff of the
// jnp repro.models.mamba2.ssd_chunked.  It computes what jax.vjp of
// ssd_chunked gives, and what kernels/ssd_scan.py::ssd_scan_bwd_ref writes
// out (single B/C group, Q = 64 positions a chunk):
//
//   x, dy  [B, S, H, P]  T (float or bfloat16); x any strides with unit
//                        stride along P, dy contiguous
//   dt     [B, S, H]     float32, any strides
//   a      [H]           float32
//   bm, cm [B, S, N]     float32, any strides with unit stride along N
//   init   [B, H, P, N]  float32, contiguous (or null: zeros)
//   dfin   [B, H, P, N]  float32, contiguous (or null: zeros)
//   dx     [B, S, H, P]  T, contiguous;  ddt [B, S, H], da [H], dB, dC
//   [B, S, N], dinit [B, H, P, N] (written when init is given): float32,
//   contiguous
//
// Per chunk and head, with cum the inclusive cumsum of dt * a, seg its
// last value, L[i, j] = exp(cum_i - cum_j) for i >= j (never exp of a
// positive difference: the upper triangle is not computed), w = exp(seg -
// cum) dt, E the state entering the chunk and G the gradient of the state
// leaving it:
//   M = dy x^T, K = C B^T o L o M, scores = C B^T o L o dt^T
//   dx  = scores^T dy + w o (B G^T)
//   dCB = sum over heads of M o L o dt^T  (C B^T is shared by the heads)
//   dC  = dCB B + sum_h exp(cum) o (dy E),  dB = dCB^T C + sum_h w o (x G)
//   d cum = K dt - dt o colsum K + exp(cum) o (C . dy E) - w o (x . B G^T)
//   d seg = exp(seg) <G, E> + sum_j w_j x_j . (B G^T)_j
//   d(dt a) = reverse cumsum of d cum, plus d seg
//   ddt = a d(dt a) + colsum K + exp(seg - cum) o (x . B G^T)
//   da  = sum over batch and positions of d(dt a) o dt
// E runs from the first chunk to the last (E' = exp(seg) E + x^T (w o B)),
// G from the last to the first (G_{c-1} = exp(seg_c) G_c + dy^T (exp(cum)
// o C) over chunk c, starting from dfin); what G reaches before chunk 0 is
// dinit.
//
// What bounds it: operations.  The work the algorithm needs, per (batch,
// chunk of r rows, head): 2 r P N each for the chunk's own state, its
// reverse term, B G^T, x G and dy E, and 2 P per causal pair (r (r + 1) /
// 2 of them) each for dy x^T and scores^T dy; per (batch, chunk) 2 N per
// causal pair each for C B^T, dCB B and dCB^T C (chip_smoke.py::
// ssd_bwd_bound).  At mamba2-780m's 4 x 2,048 rows (H 48, P 64, N 128)
// that is 35.7 GFLOP: 0.53 ms at the 67 TFLOP/s of float32 FMA, 0.216 ms
// as 3xTF32 on the tensor cores (three TF32 products for each float32
// one, 3 x 35.7 GFLOP at 495 TFLOP/s); at hymba-1.5b's (H 50, N 16) 7.6
// GFLOP, 0.114 and 0.046 ms.  The bytes it must move are a few percent of
// that time.
//
// Design: two or three launches (kernels/ssd_scan.py::bwd_plan names them).
//   * chain (past a single chunk, or with init): the states handed from
//     chunk to chunk.  One block per (chain, batch, head) walks its
//     chunks with the state in registers: an E block from chunk 0 up,
//     E' = exp(seg) E + (w o x)^T B, writing the state entering each
//     later chunk; a G block from the last chunk down, G_{c-1} =
//     exp(seg) G + (e o dy)^T C, writing the gradient leaving each
//     earlier chunk (dinit at chunk 0).  The MMAs sum onto the state
//     itself, so a step is one product, its loads in flight before it:
//     x or dy rows two chunks ahead by cp.async into the other of two
//     buffers, B or C one chunk ahead, the next chunk's cumsum at the
//     end of each step.  The workspace holds the states main reads,
//     each written once and read once: 2 B (S / 64) H P NP floats
//     (mamba2-780m at 4 x 2,048 tokens: 403 MB written and 403 MB read,
//     0.24 ms at 3.35 TB/s, where PR 25's four launches (own states, a
//     scan over them in place, main, reduce) moved 1.6 GB).  A single
//     chunk needs none of it: E is init or 0, G is dfin or 0.
//   * main, one block per (batch, chunk, head group): C B^T once, then for
//     each head of the group every product above, dx and ddt written
//     directly, d(dt a) o dt summed per (batch, chunk, head), and dCB,
//     exp(cum) o (dy E) and w o (x G) summed over the group's heads in
//     registers; at the end dCB B and dCB^T C, and the group's dB and dC
//     (written directly when there is one group).  Head groups are as few
//     as give 132 blocks: at 4 x 2,048 tokens 2 groups of 24 heads (256
//     blocks), at 4 x 32 one head a group (192 blocks for mamba2, 200 for
//     hymba).
//   * reduce: da summed over (batch, chunk) in a fixed order by one block;
//     with more than one group, dB and dC summed over the groups in group
//     order, a thread per output.
//   No float atomics anywhere, so two calls on the same inputs give
//   bitwise-equal gradients.
//   * arithmetic: every product on the tensor cores, mma.sync m16n8k8
//     TF32, 16 x 8 output tiles a warp, in 3xTF32: each float32 operand
//     split into a TF32 high part and the TF32 rounding of the rest, and
//     lo*hi + hi*lo + hi*hi summed in float32 (hopper.cuh::split_tf32),
//     which keeps ~22 bits of each product where one TF32 product keeps
//     ~11 (tests/test_torch_ssd_scan.py emulates it: 5e-7 of the largest
//     output against float64, where one TF32 product is 2.5e-4 off).  A
//     bf16 x or dy is exact in TF32 and takes no low part: dy x^T from
//     bf16 is one product, x G, dy E and scores^T dy two.  The products
//     over position pairs (dy x^T, C B^T, scores^T dy, dCB B, dCB^T C)
//     take only the tiles on or below the diagonal and mask the diagonal
//     ones; a warp's few tiles of a product run as independent chains of
//     MMAs (the split's correction terms in accumulators of their own).
//     Operands come from shared memory, rows padded so that most
//     fragment loads fall on distinct banks, each phase's global loads
//     all in flight before its first store.  Rows past S load as zeros
//     (dt = 0 there), so padded positions and state columns add nothing.
//   * occupancy: main keeps 160 KB of tiles at NP 128 (one block, 8
//     warps an SM) and 74 KB at NP 16 (two blocks); chain 73 KB at NP
//     128 (three blocks), 44 KB at NP 16 (four).
//   What still holds it back (chip_smoke.py's kernel_ssd_bwd, each
//   launch's device time under torch.profiler; mamba2 4 x 2,048, bf16):
//   main, 0.95 ms: each head of a group loads x, dy, G and E before its
//   products, with eight warps an SM at NP 128 to hide those loads, and
//   its mma.sync is fed by scalar shared-memory loads that split each
//   operand element where it is loaded; the chain, 0.47 ms: 31 serial
//   steps a (batch, head); reduce 12 us.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
//   kernel_ssd_bwd; PERF.md section 6 has every shape against PR 25's
//   kernel, from chip_smoke.py --ab): mamba2 4 x 2,048 1.52 ms (bf16;
//   PR 25's 4.33), 2.9x its f32 bound and 7.0x its 3xTF32 bound; hymba
//   4 x 2,048 0.64 ms (1.59); the 4 x 32 calls 69 us (mamba2; 155) and
//   28 us (hymba; 69).
#include "hopper.cuh"

namespace {

constexpr int kQ = 64;          // positions per chunk
constexpr int kP = 64;          // state rows (P <= 64)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int LQ = kQ + 4;      // main: pitch of x, dy and score rows
constexpr int kCausal = 20;     // 16 x 8 tiles of a 64 x 64 lower triangle

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}

// acc[j] (a 16 x 8 tile, columns 8 j ..) += sum over k in [k0, k1) (steps
// of 8) of A(r, k) B(k, c): A(r, k) at A[r * ai + k * ak], B(k, c) at
// Bm[k * bk + c * bn], both already offset to the tile's first row and
// column.  SA / SB: split that operand (3xTF32); false when it is exact in
// TF32.
template <int NT, bool SA, bool SB>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], const float* A,
                                         int ai, int ak, const float* Bm,
                                         int bk, int bn, int k0, int k1,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * ai;
  const float* a1 = A + (g + 8) * ai;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32<SA>(a0[(k + t) * ak], ah[0], al[0]);
    split_tf32<SA>(a1[(k + t) * ak], ah[1], al[1]);
    split_tf32<SA>(a0[(k + t + 4) * ak], ah[2], al[2]);
    split_tf32<SA>(a1[(k + t + 4) * ak], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bc = Bm + (8 * j + g) * bn;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32<SB>(bc[(k + t) * bk], bh0, bl0);
      split_tf32<SB>(bc[(k + t + 4) * bk], bh1, bl1);
      if constexpr (SA) mma_tf32(acc[j], al, bh0, bh1);
      if constexpr (SB) {
        mma_tf32(acc[j], ah, bl0, bl1);
      }
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

// The same for MT row blocks (A[m] offset to block m's first row) over
// the same B columns, with the split's correction terms in accumulators
// of their own: 2 MT NT independent chains of MMAs, where a product of
// few tiles would otherwise wait on one chain.
template <int MT, int NT, bool SA, bool SB>
__device__ __forceinline__ void tile_mma_rows(float (&acc)[MT][NT][4],
                                              const float* const (&A)[MT],
                                              int ai, int ak,
                                              const float* Bm, int bk,
                                              int bn, int k0, int k1,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  float cor[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      cor[m][j][0] = cor[m][j][1] = cor[m][j][2] = cor[m][j][3] = 0.f;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a0 = A[m] + g * ai;
      const float* a1 = A[m] + (g + 8) * ai;
      split_tf32<SA>(a0[(k + t) * ak], ah[m][0], al[m][0]);
      split_tf32<SA>(a1[(k + t) * ak], ah[m][1], al[m][1]);
      split_tf32<SA>(a0[(k + t + 4) * ak], ah[m][2], al[m][2]);
      split_tf32<SA>(a1[(k + t + 4) * ak], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bc = Bm + (8 * j + g) * bn;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32<SB>(bc[(k + t) * bk], bh0, bl0);
      split_tf32<SB>(bc[(k + t + 4) * bk], bh1, bl1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (SA) mma_tf32(cor[m][j], al[m], bh0, bh1);
        if constexpr (SB) {
          mma_tf32(cor[m][j], ah[m], bl0, bl1);
        }
        mma_tf32(acc[m][j], ah[m], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] += cor[m][j][e];
}

// One 16 x 8 tile each of `count` (<= MT) tiles, each with its own A rows
// and B columns, over the same k range; correction terms apart, as above.
template <int MT, bool SA, bool SB>
__device__ __forceinline__ void tiles_mma(float (&acc)[MT][4],
                                          const float* const (&A)[MT],
                                          int ai, int ak,
                                          const float* const (&Bm)[MT],
                                          int bk, int bn, int k0, int k1,
                                          int count, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float cor[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) cor[m][0] = cor[m][1] = cor[m][2] = cor[m][3] = 0.f;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= count) break;
      uint32_t ah[4], al[4];
      const float* a0 = A[m] + g * ai;
      const float* a1 = A[m] + (g + 8) * ai;
      split_tf32<SA>(a0[(k + t) * ak], ah[0], al[0]);
      split_tf32<SA>(a1[(k + t) * ak], ah[1], al[1]);
      split_tf32<SA>(a0[(k + t + 4) * ak], ah[2], al[2]);
      split_tf32<SA>(a1[(k + t + 4) * ak], ah[3], al[3]);
      const float* bc = Bm[m] + g * bn;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32<SB>(bc[(k + t) * bk], bh0, bl0);
      split_tf32<SB>(bc[(k + t + 4) * bk], bh1, bl1);
      if constexpr (SA) mma_tf32(cor[m], al, bh0, bh1);
      if constexpr (SB) {
        mma_tf32(cor[m], ah, bl0, bl1);
      }
      mma_tf32(acc[m], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] += cor[m][e];
}

// tile_mma with A(r, k) scaled by ksc[k] as it is loaded (both operands
// split): acc[j] += sum_k ksc[k] A(r, k) B(k, c); with one or two column
// tiles the split's correction terms go to accumulators of their own (a
// second chain of MMAs), with more the tiles already give chains enough
template <int NT>
__device__ __forceinline__ void tile_mma_ks(float (&acc)[NT][4],
                                            const float* A, int ai, int ak,
                                            const float* ksc,
                                            const float* Bm, int bk, int bn,
                                            int k0, int k1, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * ai;
  const float* a1 = A + (g + 8) * ai;
  constexpr bool SEP = NT <= 2;
  float cor[SEP ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < (SEP ? NT : 1); ++j)
    cor[j][0] = cor[j][1] = cor[j][2] = cor[j][3] = 0.f;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    const float s0 = ksc[k + t], s1 = ksc[k + t + 4];
    uint32_t ah[4], al[4];
    split_tf32<true>(a0[(k + t) * ak] * s0, ah[0], al[0]);
    split_tf32<true>(a1[(k + t) * ak] * s0, ah[1], al[1]);
    split_tf32<true>(a0[(k + t + 4) * ak] * s1, ah[2], al[2]);
    split_tf32<true>(a1[(k + t + 4) * ak] * s1, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bc = Bm + (8 * j + g) * bn;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32<true>(bc[(k + t) * bk], bh0, bl0);
      split_tf32<true>(bc[(k + t + 4) * bk], bh1, bl1);
      float (&c)[4] = cor[SEP ? j : 0];
      mma_tf32(SEP ? c : acc[j], al, bh0, bh1);
      mma_tf32(SEP ? c : acc[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
  if constexpr (SEP) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += cor[j][e];
  }
}

// the causal 16 x 8 tile `k` of a 64 x 64 lower triangle: row block rb,
// column tile nt (nt <= 2 rb + 1); rb's tiles start at rb (rb + 1)
__device__ __forceinline__ void causal_tile(int k, int& rb, int& nt) {
  rb = k >= 12 ? 3 : k >= 6 ? 2 : k >= 2 ? 1 : 0;
  nt = k - rb * (rb + 1);
}

// warp 0: inclusive cumsum of dt * a over the chunk (two positions a lane),
// exp(cum), exp(seg - cum), w = exp(seg - cum) dt; returns exp(seg) on
// every lane
__device__ __forceinline__ float chunk_cumsum(const float* vdt, float ah,
                                              float* vcum, float* vecum,
                                              float* ved, float* vw,
                                              int lane) {
  const float v0 = vdt[2 * lane] * ah, v1 = vdt[2 * lane + 1] * ah;
  float inc = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  float exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = 0.f;
  const float c0 = exc + v0, c1 = inc;
  const float seg = __shfl_sync(0xffffffffu, inc, 31);
  vcum[2 * lane] = c0;
  vcum[2 * lane + 1] = c1;
  vecum[2 * lane] = expf(c0);
  vecum[2 * lane + 1] = expf(c1);
  const float e0 = expf(seg - c0), e1 = expf(seg - c1);
  if (ved) {
    ved[2 * lane] = e0;
    ved[2 * lane + 1] = e1;
  }
  vw[2 * lane] = e0 * vdt[2 * lane];
  vw[2 * lane + 1] = e1 * vdt[2 * lane + 1];
  return expf(seg);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// four consecutive elements as floats, those from `valid` on zero; vec:
// one aligned 16-byte (float) or 8-byte (bf16) load when all four count
__device__ __forceinline__ float4 load4(const float* p, int valid, bool vec) {
  if (vec && valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(valid > 0 ? p[0] : 0.f, valid > 1 ? p[1] : 0.f,
                     valid > 2 ? p[2] : 0.f, valid > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int valid,
                                        bool vec) {
  if (vec && valid >= 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(valid > 0 ? to_f(p[0]) : 0.f,
                     valid > 1 ? to_f(p[1]) : 0.f,
                     valid > 2 ? to_f(p[2]) : 0.f,
                     valid > 3 ? to_f(p[3]) : 0.f);
}

// ROWS x COLS of src (row stride srow) into dst (pitch ld) as float, rows
// past nv and columns past ncols zero: every load of a thread issued
// before its first store, so that a phase waits on memory once
template <int ROWS, int COLS, int THREADS, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      i64 srow, int nv, int ncols, bool vec,
                                      int t) {
  constexpr int G4 = COLS / 4, V = ROWS * G4 / THREADS;
  static_assert(V * THREADS == ROWS * G4, "whole float4s a thread");
  float4 v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = t + u * THREADS, r = i / G4, c = 4 * (i % G4);
    v[u] = load4(src + (i64)r * srow + c, r < nv ? ncols - c : 0, vec);
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = t + u * THREADS, r = i / G4, c = 4 * (i % G4);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v[u];
  }
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most the newest of this thread's copy groups is in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------------------------------------------- chain ----
// One block per (chain, batch, head), walking its chain's chunks with the
// state in registers; the next chunk's x or dy rows on their way (cp.async
// into the other of two buffers) while it works on this one.  ws_e / ws_g
// [B][nc][H][P][NP]: the state entering / the gradient of the state
// leaving each chunk (E of chunk 0 and G of the last chunk are not
// stored: init and dfin).
constexpr int LX = kP + 8;           // pitch of a chain block's x / dy rows

template <typename T, int NC>
struct ChainSmem {
  static constexpr int NP = 16 * NC, LN = NP + 8;
  static constexpr int XW = kQ * LX * (int)sizeof(T) / 4;  // a T buffer
  static constexpr int BR = 0;                  // [Q][LN] B or C rows
  static constexpr int XR = BR + kQ * LN;       // 2 x [Q][LX] x or dy rows
  static constexpr int XS = XR + 2 * XW;        // [Q][LX] w o x (bf16 x;
                                                // float x is scaled in place)
  static constexpr int VEC = XS + (sizeof(T) == 4 ? 0 : kQ * LX);
  static constexpr int MISC = VEC + 4 * kQ;     // dt, cum, exp(cum), w;
  static constexpr int FLOATS = MISC + 4;       // exp(seg)
};

// rows [Q][NP] of B or C (16-byte copies when vec) into br, rows past nv
// and columns past N zero
template <int NP, int LN>
__device__ __forceinline__ void chain_fetch_bc(float* br, const float* bc,
                                               i64 sbc, int nv, int N,
                                               bool vec, int t) {
  if (vec) {
    for (int i = t; i < kQ * NP / 4; i += kThreads) {
      const int j = i / (NP / 4), n = 4 * (i % (NP / 4));
      const bool ok = j < nv && n < N;
      cp16(br + j * LN + n, ok ? bc + (i64)j * sbc + n : bc, ok);
    }
  } else {
    for (int i = t; i < kQ * NP; i += kThreads) {
      const int j = i / NP, n = i % NP;
      br[j * LN + n] = j < nv && n < N ? bc[(i64)j * sbc + n] : 0.f;
    }
  }
}

// rows [Q][P] of x or dy (T; 16-byte copies when vec) into xr, rows past
// nv and columns past P zero
template <typename T>
__device__ __forceinline__ void chain_fetch_x(T* xr, const T* xv, i64 sx,
                                              int nv, int P, bool vec,
                                              int t) {
  constexpr int E16 = 16 / sizeof(T);  // elements a 16-byte copy
  if (vec) {
    for (int i = t; i < kQ * kP / E16; i += kThreads) {
      const int j = i / (kP / E16), p = E16 * (i % (kP / E16));
      const bool ok = j < nv && p < P;
      cp16(xr + j * LX + p, ok ? xv + (i64)j * sx + p : xv, ok);
    }
  } else {
    for (int i = t; i < kQ * kP; i += kThreads) {
      const int j = i / kP, p = i % kP;
      xr[j * LX + p] = j < nv && p < P ? xv[(i64)j * sx + p] : T(0.f);
    }
  }
}

// grid: (E and G walks, or the G walks alone) x B H, the chain fastest.
// E walks chunks 0 .. nc - 2, writing E of chunks 1 .. nc - 1; G walks
// chunks nc - 1 down to 1 (down to 0 with dinit), writing G of chunks
// nc - 2 .. 0 (then dinit).  Per chunk the state becomes exp(seg) times
// itself plus (w o x)^T B or (e o dy)^T C, [P, NP] over the chunk's rows,
// summed by the MMAs onto the state itself.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC >= 8 ? 3 : 4)
    ssd_scan_bwd_chain(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const float* __restrict__ bm,
                       const float* __restrict__ cm,
                       const float* __restrict__ init,
                       const float* __restrict__ dfin,
                       float* __restrict__ dinit, float* __restrict__ ws_e,
                       float* __restrict__ ws_g, int S, int H, int P, int N,
                       int nc, int both, int vec, i64 sxb, i64 sxs, i64 sxh,
                       i64 sdb, i64 sds, i64 sdh, i64 sbb, i64 sbs, i64 scb,
                       i64 scs) {
  typedef ChainSmem<T, NC> L;
  constexpr int NP = L::NP, LN = L::LN, NT = NP / 16;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem[];
  float* br = smem + L::BR;
  float* vdt = smem + L::VEC;
  float* vcum = vdt + kQ;
  float* vecum = vcum + kQ;
  float* vw = vecum + kQ;
  float* misc = vdt + 4 * kQ;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const bool gchain = both ? (blockIdx.x & 1) : true;
  const int bh = both ? blockIdx.x >> 1 : blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int rb = warp & 3, cbase = (warp >> 2) * (NP / 2);
  const i64 per = (i64)P * NP;
  const int steps = gchain ? nc - (dinit ? 0 : 1) : nc - 1;
  const bool vec_bc = gchain ? (vec & 4) : (vec & 2);
  const bool vec_x = gchain || (vec & 1);   // dy is contiguous

  auto chunk = [&](int step) { return gchain ? nc - 1 - step : step; };
  auto fetch_bc = [&](int step) {
    const int s0 = chunk(step) * kQ, nv = min(kQ, S - s0);
    if (gchain)
      chain_fetch_bc<NP, LN>(br, cm + b * scb + (i64)s0 * scs, scs, nv, N,
                             vec_bc, t);
    else
      chain_fetch_bc<NP, LN>(br, bm + b * sbb + (i64)s0 * sbs, sbs, nv, N,
                             vec_bc, t);
  };
  auto fetch_x = [&](int step) {
    if (step >= steps) return;
    const int s0 = chunk(step) * kQ, nv = min(kQ, S - s0);
    T* xr = reinterpret_cast<T*>(smem + L::XR + (step & 1) * L::XW);
    if (gchain)
      chain_fetch_x<T>(xr, dy + ((i64)b * S + s0) * H * P + (i64)h * P,
                       (i64)H * P, nv, P, vec_x, t);
    else
      chain_fetch_x<T>(xr, x + b * sxb + h * sxh + (i64)s0 * sxs, sxs, nv, P,
                       vec_x, t);
  };
  auto dt_of = [&](int step) {
    if (step >= steps || t >= kQ) return 0.f;
    const int s = chunk(step) * kQ + t;
    return s < S ? dt[b * sdb + h * sdh + (i64)s * sds] : 0.f;
  };

  // the state, in the product's layout: rows 16 rb + g8 (+ 8), columns
  // cbase + 8 j + 2 tq (+ 1)
  float st[NT][4];
  {
    const float* src = gchain ? dfin : init;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * rb + g8 + 8 * (e >> 1);
        const int n = cbase + 8 * j + 2 * tq + (e & 1);
        st[j][e] = src && p < P && n < N ? src[((i64)bh * P + p) * N + n]
                                         : 0.f;
      }
  }
  // a chunk's dt (warps 0 and 1), then its cumsum, exp(cum), w and
  // exp(seg) (warp 0)
  auto cumsum = [&](float dtv) {
    vdt[t] = dtv;
    named_sync(1, kQ);
    if (t < 32) {
      const float e = chunk_cumsum(vdt, a[h], vcum, vecum, nullptr, vw, lane);
      if (lane == 0) misc[0] = e;
    }
  };
  // copy groups: B or C of a chunk, then x or dy of the chunk after, so
  // that waiting for all but the newest group waits for this chunk's rows
  fetch_x(0);
  cp_commit();
  fetch_bc(0);
  cp_commit();
  fetch_x(1);
  cp_commit();
  if (t < kQ) cumsum(dt_of(0));
  for (int step = 0; step < steps; ++step) {
    const int c = chunk(step);
    const int nv = min(kQ, S - c * kQ);
    const T* xr = reinterpret_cast<const T*>(smem + L::XR +
                                             (step & 1) * L::XW);
    cp_wait_one();      // this chunk's B or C and x or dy rows
    __syncthreads();
    const float dt_next = dt_of(step + 1);
    const float es = misc[0];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= es;
    // x^T (w o B) as (w o x)^T B: w (or exp(cum)) scales x's rows
    const float* scale = gchain ? vecum : vw;
    if constexpr (kF32) {
      tile_mma_ks<NT>(st, reinterpret_cast<const float*>(xr) + 16 * rb, 1,
                      LX, scale, br + cbase, LN, 1, 0, (nv + 7) & ~7, lane);
    } else {
      float* xs = smem + L::XS;
      for (int i = t; i < kQ * kP; i += kThreads) {
        const int j = i / kP, p = i % kP;
        xs[j * LX + p] = to_f(xr[j * LX + p]);
      }
      __syncthreads();
      tile_mma_ks<NT>(st, xs + 16 * rb, 1, LX, scale, br + cbase, LN, 1, 0,
                      (nv + 7) & ~7, lane);
    }
    const bool to_dinit = gchain && c == 0;
    float* dst = to_dinit ? dinit + (i64)bh * P * N
                 : gchain ? ws_g + ((i64)(b * nc + c - 1) * H + h) * per
                          : ws_e + ((i64)(b * nc + c + 1) * H + h) * per;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = 16 * rb + g8 + 8 * hr;
        const int n = cbase + 8 * j + 2 * tq;
        const float u = st[j][2 * hr], v = st[j][2 * hr + 1];
        if (p >= P) continue;
        if (to_dinit) {
          if (n < N) dst[(i64)p * N + n] = u;
          if (n + 1 < N) dst[(i64)p * N + n + 1] = v;
        } else {
          __stcg(reinterpret_cast<float2*>(dst + (i64)p * NP + n),
                 make_float2(u, v));
        }
      }
    __syncthreads();    // this chunk's rows and vectors are read
    if (step + 1 < steps) fetch_bc(step + 1);
    cp_commit();
    fetch_x(step + 2);
    cp_commit();
    if (t < kQ) cumsum(dt_next);
  }
}

// ------------------------------------------------------------ reduce ----
// da [H] by the last block: the (batch, chunk) partials of dap [B nc][H]
// summed in a fixed order (rows to lanes, then the warp's butterfly).
// With more than one head group, dB and dC [B][S][N] by the blocks before
// it: the groups' partials summed in group order, a thread per output.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_reduce(const float* __restrict__ part,
                        const float* __restrict__ dap,
                        float* __restrict__ da, float* __restrict__ db,
                        float* __restrict__ dc, int B, int S, int H, int N,
                        int NP, int nc, int G) {
  if (blockIdx.x == gridDim.x - 1) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rows = B * nc;
    for (int hh = warp; hh < H; hh += kWarps) {
      float s = 0.f;
      for (int i = lane; i < rows; i += 32) s += dap[(i64)i * H + hh];
      s = warp_sum(s);
      if (lane == 0) da[hh] = s;
    }
    return;
  }
  const i64 i = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (i64)B * S * N) return;
  const int n = (int)(i % N);
  const i64 bs_ = i / N;
  const int s = (int)(bs_ % S), b = (int)(bs_ / S);
  const int c = s / kQ, j = s % kQ;
  const float* p0 = part + ((i64)b * nc + c) * G * 2 * kQ * NP + j * NP + n;
  float sb = 0.f, sc = 0.f;
#pragma unroll 4
  for (int g = 0; g < G; ++g) {
    sb += p0[(i64)g * 2 * kQ * NP];
    sc += p0[(i64)g * 2 * kQ * NP + kQ * NP];
  }
  db[i] = sb;
  dc[i] = sc;
}

// -------------------------------------------------------------- main ----
template <int NC>
struct MainSmem {
  static constexpr int NP = 16 * NC, LN = NP + 4;
  static constexpr int BS = 0;                 // [Q][LN] B rows
  static constexpr int CS = BS + kQ * LN;      // [Q][LN] C rows
  static constexpr int SS = CS + kQ * LN;      // [Q][LQ] scores; dCB
  static constexpr int XS = SS + kQ * LQ;      // [Q][LQ] x
  static constexpr int DY = XS + kQ * LQ;      // [Q][LQ] dy
  static constexpr int EG = DY + kQ * LQ;      // [kP][LN] G, then E
  static constexpr int VEC = EG + kP * LN;     // 10 vectors of Q
  static constexpr int RP = VEC + 10 * kQ;     // [20][16] K dt row parts
  static constexpr int CP = RP + kCausal * 16; // [20][8] K column parts
  static constexpr int VP = CP + kCausal * 8;  // [4][Q] x . B G^T parts
  static constexpr int RR = VP + 4 * kQ;       // [2][Q] C . dy E parts
  static constexpr int MISC = RR + 2 * kQ;     // exp(seg), warp sums
  static constexpr int FLOATS = MISC + 16;
};

// [P][NP] of a state into eg (pitch LN): from the workspace (padded rows),
// from init / dfin ([P][N]) or zeros, every load of a thread in flight
// before its first store; with dot, also the sum of eg's old values times
// the new ones over this thread's elements (<G, E> as E replaces G)
template <int NP, int LN>
__device__ __forceinline__ float load_state(float* eg, const float* src,
                                            bool padded, int P, int N,
                                            int t, bool dot) {
  constexpr int V = kP * NP / 4 / kThreads;
  float4 v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = t + u * kThreads;
    const int p = i / (NP / 4), n = 4 * (i % (NP / 4));
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < P && src) {
      if (padded)
        v[u] = __ldcg(reinterpret_cast<const float4*>(src + (i64)p * NP + n));
      else
        v[u] = load4(src + (i64)p * N + n, N - n, false);
    }
  }
  float ge = 0.f;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = t + u * kThreads;
    const int p = i / (NP / 4), n = 4 * (i % (NP / 4));
    float4* d = reinterpret_cast<float4*>(eg + p * LN + n);
    if (dot) {
      const float4 o = *d;
      ge = fmaf(o.x, v[u].x, fmaf(o.y, v[u].y, fmaf(o.z, v[u].z,
                                                   fmaf(o.w, v[u].w, ge))));
    }
    *d = v[u];
  }
  return ge;
}

// grid (B * chunks * G), block (b, c, g) in that order: heads g HG ..
// min(H, (g + 1) HG).  dap [B][nc][H]: sum_k d(dt a)_k dt_k; part
// [B][nc][G][2][Q][NP]: dB, then dC (G > 1).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
    ssd_scan_bwd_main(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ init,
                      const float* __restrict__ dfin, const float* ws_e,
                      const float* ws_g, T* __restrict__ dx,
                      float* __restrict__ ddt, float* __restrict__ db,
                      float* __restrict__ dc, float* dap, float* part,
                      int S, int H, int P, int N, int nc, int G, int HG,
                      int vec, i64 sxb, i64 sxs, i64 sxh, i64 sdb, i64 sds,
                      i64 sdh, i64 sbb, i64 sbs, i64 scb, i64 scs) {
  typedef MainSmem<NC> L;
  constexpr int NP = L::NP, LN = L::LN, NT = NP / 16;
  constexpr bool kExact = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem + L::BS;
  float* cs = smem + L::CS;
  float* ss = smem + L::SS;
  float* xs = smem + L::XS;
  float* dys = smem + L::DY;
  float* eg = smem + L::EG;
  float* vdt = smem + L::VEC;
  float* vcum = vdt + kQ;
  float* vecum = vcum + kQ;
  float* ved = vecum + kQ;
  float* vw = ved + kQ;
  float* vrow = vw + kQ;
  float* vcol = vrow + kQ;
  float* vv = vcol + kQ;
  float* vu = vv + kQ;
  float* vr = vu + kQ;
  float* rp = smem + L::RP;
  float* cp = smem + L::CP;
  float* vp = smem + L::VP;
  float* rr = smem + L::RR;
  float* misc = smem + L::MISC;  // [0] exp(seg), [8..15] warp sums

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int grp = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % nc, b = bc / nc;
  const int s0 = c * kQ, nv = min(kQ, S - s0);
  const int h0 = grp * HG, h1 = min(H, h0 + HG);
  const i64 per = (i64)P * NP;

  stage<kQ, NP, kThreads>(bs, LN, bm + b * sbb + (i64)s0 * sbs, sbs, nv, N,
                          vec & 2, t);
  stage<kQ, NP, kThreads>(cs, LN, cm + b * scb + (i64)s0 * scs, scs, nv, N,
                          vec & 4, t);
  __syncthreads();

  // C B^T on this warp's causal tiles, warp, warp + 8 and (warps 0-3)
  // warp + 16: the same tiles as dy x^T below, so it stays in registers,
  // as does dCB, summed over the heads there
  const int ntiles = warp + 2 * kWarps < kCausal ? 3 : 2;
  int trb[3], tnt[3];
#pragma unroll
  for (int q = 0; q < 3; ++q)
    causal_tile(min(warp + kWarps * q, kCausal - 1), trb[q], tnt[q]);
  float cbr[3][4], dcb[3][4];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) cbr[q][e] = dcb[q][e] = 0.f;
  {
    const float* const ta[3] = {cs + 16 * trb[0] * LN, cs + 16 * trb[1] * LN,
                                cs + 16 * trb[2] * LN};
    const float* const tb[3] = {bs + 8 * tnt[0] * LN, bs + 8 * tnt[1] * LN,
                                bs + 8 * tnt[2] * LN};
    tiles_mma<3, true, true>(cbr, ta, LN, 1, tb, 1, LN, 0, NP, ntiles, lane);
  }

  // dB and dC of this warp's rows (16 rx ..) and half of the columns
  const int rx = warp & 3, cbase = (warp >> 2) * (NP / 2);
  float dba[NT][4], dca[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[j][e] = dca[j][e] = 0.f;
  // dx: column tiles 2 (warp & 3), + 1 of row blocks warp >> 2 and 3 -
  // that (the long and the short rows of the causal product together)
  const int ntb = 2 * (warp & 3);
  const int rbs[2] = {warp >> 2, 3 - (warp >> 2)};

  for (int h = h0; h < h1; ++h) {
    const i64 hs = ((i64)(b * nc + c) * H + h) * per;
    stage<kQ, kP, kThreads>(xs, LQ, x + b * sxb + h * sxh + (i64)s0 * sxs,
                            sxs, nv, P, vec & 1, t);
    stage<kQ, kP, kThreads>(dys, LQ,
                            dy + ((i64)b * S + s0) * H * P + (i64)h * P,
                            (i64)H * P, nv, P, true, t);
    if (c < nc - 1)
      load_state<NP, LN>(eg, ws_g + hs, true, P, N, t, false);
    else
      load_state<NP, LN>(eg, dfin ? dfin + ((i64)b * H + h) * P * N
                                  : nullptr, false, P, N, t, false);
    if (t < kQ)
      vdt[t] = t < nv ? dt[b * sdb + h * sdh + (i64)(s0 + t) * sds] : 0.f;
    __syncthreads();
    if (t < 32) {
      const float e = chunk_cumsum(vdt, a[h], vcum, vecum, ved, vw, lane);
      if (lane == 0) misc[0] = e;
    }
    __syncthreads();

    // M = dy x^T on the causal tiles: dCB += M o L o dt^T, K = C B^T o L
    // o M (its row sums against dt and its column sums, per tile), the
    // scores C B^T o L o dt^T into ss
    float mt[3][4] = {};
    {
      const float* const ta[3] = {dys + 16 * trb[0] * LQ,
                                  dys + 16 * trb[1] * LQ,
                                  dys + 16 * trb[2] * LQ};
      const float* const tb[3] = {xs + 8 * tnt[0] * LQ, xs + 8 * tnt[1] * LQ,
                                  xs + 8 * tnt[2] * LQ};
      tiles_mma<3, !kExact, !kExact>(mt, ta, LQ, 1, tb, 1, LQ, 0, P, ntiles,
                                     lane);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int k = warp + kWarps * q;
      if (k >= kCausal) continue;
      const int rb = trb[q], nt = tnt[q];
      float rs[2] = {0.f, 0.f}, cl[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * rb + g8 + 8 * (e >> 1);
        const int j = 8 * nt + 2 * tq + (e & 1);
        float s = 0.f;
        if (i >= j) {
          const float l = expf(vcum[i] - vcum[j]);
          const float ml = mt[q][e] * l;
          dcb[q][e] = fmaf(ml, vdt[j], dcb[q][e]);
          const float kij = cbr[q][e] * ml;
          rs[e >> 1] = fmaf(kij, vdt[j], rs[e >> 1]);
          cl[e & 1] += kij;
          s = cbr[q][e] * l * vdt[j];
        }
        ss[i * LQ + j] = s;
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], off);
      if (tq == 0) {
        rp[k * 16 + g8] = rs[0];
        rp[k * 16 + g8 + 8] = rs[1];
      }
      if (g8 == 0) {
        cp[k * 8 + 2 * tq] = cl[0];
        cp[k * 8 + 2 * tq + 1] = cl[1];
      }
    }

    // B G^T [j][p] on this warp's dx tiles: x . B G^T per row, then w o
    // (B G^T) is where dx starts
    float dxa[2][2][4] = {};
    {
      const float* const ta[2] = {bs + 16 * rbs[0] * LN,
                                  bs + 16 * rbs[1] * LN};
      tile_mma_rows<2, 2, true, true>(dxa, ta, LN, 1, eg + 8 * ntb * LN, 1,
                                      LN, 0, NP, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float xb[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * rbs[r] + g8 + 8 * (e >> 1);
          const int p = 8 * (ntb + j) + 2 * tq + (e & 1);
          xb[e >> 1] = fmaf(xs[row * LQ + p], dxa[r][j][e], xb[e >> 1]);
        }
      xb[0] = quad_sum(xb[0]);
      xb[1] = quad_sum(xb[1]);
      if (tq == 0) {
        vp[(warp & 3) * kQ + 16 * rbs[r] + g8] = xb[0];
        vp[(warp & 3) * kQ + 16 * rbs[r] + g8 + 8] = xb[1];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dxa[r][j][e] *= vw[16 * rbs[r] + g8 + 8 * (e >> 1)];
    }

    // x G [j][n]: dB += w o (x G)
    {
      float tmp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
      tile_mma<NT, !kExact, true>(tmp, xs + 16 * rx * LQ, LQ, 1, eg + cbase,
                                  LN, 1, 0, P, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dba[j][e] = fmaf(vw[16 * rx + g8 + 8 * (e >> 1)], tmp[j][e],
                           dba[j][e]);
    }
    __syncthreads();  // G read; scores and partials written

    {  // E over G, and <G, E>
      const i64 es_off = ((i64)b * H + h) * P * N;
      const float ge =
          c > 0 ? load_state<NP, LN>(eg, ws_e + hs, true, P, N, t, true)
                : load_state<NP, LN>(eg, init ? init + es_off : nullptr,
                                     false, P, N, t, true);
      const float w = warp_sum(ge);
      if (lane == 0) misc[8 + warp] = w;
    }
    __syncthreads();

    // dx += scores^T dy over the pairs i >= j (both row blocks from the
    // later one's diagonal on, the earlier one's own rows before), then out
    {
      const float* const ta[2] = {ss + 16 * rbs[0], ss + 16 * rbs[1]};
      tile_mma_rows<2, 2, true, !kExact>(dxa, ta, 1, LQ, dys + 8 * ntb, LQ,
                                         1, 16 * rbs[1], kQ, lane);
      float (&d0)[1][2][4] = reinterpret_cast<float (&)[1][2][4]>(dxa[0]);
      const float* const t0[1] = {ss + 16 * rbs[0]};
      tile_mma_rows<1, 2, true, !kExact>(d0, t0, 1, LQ, dys + 8 * ntb, LQ, 1,
                                         16 * rbs[0], 16 * rbs[1], lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int jb = rbs[r];
      T* dxb = dx + ((i64)b * S + s0) * H * P + (i64)h * P;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = 16 * jb + g8 + 8 * hr;
        if (j >= nv) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = 8 * (ntb + q) + 2 * tq;
          if (p < P)
            store2(dxb + (i64)j * H * P + p, dxa[r][q][2 * hr],
                   dxa[r][q][2 * hr + 1]);
        }
      }
    }

    // dy E [i][n]: dC += exp(cum) o (dy E); C . (dy E) per row
    {
      float tmp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
      tile_mma<NT, !kExact, true>(tmp, dys + 16 * rx * LQ, LQ, 1,
                                  eg + cbase, LN, 1, 0, P, lane);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * rx + g8 + 8 * (e >> 1);
          const int n = cbase + 8 * j + 2 * tq + (e & 1);
          const float v = vecum[i] * tmp[j][e];
          dca[j][e] += v;
          rsum[e >> 1] = fmaf(cs[i * LN + n], v, rsum[e >> 1]);
        }
      rsum[0] = quad_sum(rsum[0]);
      rsum[1] = quad_sum(rsum[1]);
      if (tq == 0) {
        rr[(warp >> 2) * kQ + 16 * rx + g8] = rsum[0];
        rr[(warp >> 2) * kQ + 16 * rx + g8 + 8] = rsum[1];
      }
    }
    __syncthreads();

    if (t < kQ) {  // the per-position sums, each in a fixed order
      const int rb = t >> 4, nt = t >> 3;
      float s = 0.f;
      for (int q = 0; q <= 2 * rb + 1; ++q) s += rp[(rb * (rb + 1) + q) * 16 + (t & 15)];
      vrow[t] = s;
      s = 0.f;
      for (int q = nt >> 1; q < 4; ++q) s += cp[(q * (q + 1) + nt) * 8 + (t & 7)];
      vcol[t] = s;
      const float v = ved[t] * (vp[t] + vp[kQ + t] + vp[2 * kQ + t] +
                                vp[3 * kQ + t]);
      vv[t] = v;
      vu[t] = vdt[t] * v;
      vr[t] = rr[t] + rr[kQ + t];
    }
    __syncthreads();
    if (t < 32) {  // d cum, its reverse cumsum, ddt and the da partial
      float gsum = 0.f;
      for (int w8 = 0; w8 < kWarps; ++w8) gsum += misc[8 + w8];
      const int k0 = 2 * lane, k1 = k0 + 1;
      const float d0 = vrow[k0] - vdt[k0] * vcol[k0] + vr[k0] - vu[k0];
      const float d1 = vrow[k1] - vdt[k1] * vcol[k1] + vr[k1] - vu[k1];
      const float dseg = fmaf(misc[0], gsum, warp_sum(vu[k0] + vu[k1]));
      float inc = d0 + d1;  // suffix sums over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, inc, off);
        if (lane + off < 32) inc += o;
      }
      float exc = __shfl_down_sync(0xffffffffu, inc, 1);
      if (lane == 31) exc = 0.f;
      const float dda1 = exc + d1 + dseg, dda0 = exc + d1 + d0 + dseg;
      const float ah = a[h];
      float* dd = ddt + ((i64)b * S + s0) * H + h;
      if (k0 < nv) dd[(i64)k0 * H] = fmaf(ah, dda0, vcol[k0] + vv[k0]);
      if (k1 < nv) dd[(i64)k1 * H] = fmaf(ah, dda1, vcol[k1] + vv[k1]);
      const float s = warp_sum(fmaf(dda0, vdt[k0], dda1 * vdt[k1]));
      if (lane == 0) dap[(i64)(b * nc + c) * H + h] = s;
    }
    __syncthreads();
  }

  // the heads' dCB: dC += dCB B over j <= i, dB += dCB^T C over i >= j
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k = warp + kWarps * q;
    if (k >= kCausal) continue;
    int rb, nt;
    causal_tile(k, rb, nt);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ss[(16 * rb + g8 + 8 * (e >> 1)) * LQ + 8 * nt + 2 * tq + (e & 1)] =
          dcb[q][e];
  }
  __syncthreads();
  tile_mma<NT, true, true>(dca, ss + 16 * rx * LQ, LQ, 1, bs + cbase, LN, 1,
                           0, 16 * rx + 16, lane);
  tile_mma<NT, true, true>(dba, ss + 16 * rx, 1, LQ, cs + cbase, LN, 1,
                           16 * rx, kQ, lane);

  if (G == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * rx + g8 + 8 * (e >> 1);
        const int n = cbase + 8 * j + 2 * tq + (e & 1);
        if (row < nv && n < N) {
          const i64 o = ((i64)b * S + s0 + row) * N + n;
          db[o] = dba[j][e];
          dc[o] = dca[j][e];
        }
      }
  } else {  // summed over the groups by the reduce launch
    float* pb = part + (i64)blockIdx.x * 2 * kQ * NP;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int o = (16 * rx + g8 + 8 * hr) * NP + cbase + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(pb + o) =
            make_float2(dba[j][2 * hr], dba[j][2 * hr + 1]);
        *reinterpret_cast<float2*>(pb + kQ * NP + o) =
            make_float2(dca[j][2 * hr], dca[j][2 * hr + 1]);
      }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int NC>
int launch(const void* x, const void* dy, const void* dt, const void* a,
           const void* bm, const void* cm, const void* init, const void* dfin,
           void* dx, void* ddt, void* da, void* db, void* dc, void* dinit,
           void* ws, int B, int S, int H, int P, int N, int G, int HG,
           int vec, const i64* st, cudaStream_t stream) {
  constexpr int NP = 16 * NC;
  const int nc = (S + kQ - 1) / kQ;
  // the chain's states (none for a single chunk: E is init, G dfin)
  const i64 states = nc > 1 ? (i64)B * nc * H * P * NP : 0;
  float* ws_e = static_cast<float*>(ws);
  float* ws_g = ws_e + states;
  float* dap = ws_g + states;
  float* part = dap + (i64)B * nc * H;
  if ((i64)B * nc * H > 0x3fffffff || (i64)B * nc * G > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int chain_smem = ChainSmem<T, NC>::FLOATS * (int)sizeof(float);
  const int main_smem = MainSmem<NC>::FLOATS * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = opt_in(ssd_scan_bwd_chain<T, NC>, chain_smem);
    if (e == cudaSuccess) e = opt_in(ssd_scan_bwd_main<T, NC>, main_smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bmf = static_cast<const float*>(bm);
  const float* cmf = static_cast<const float*>(cm);
  const float* initf = static_cast<const float*>(init);
  const float* dfinf = static_cast<const float*>(dfin);
  if (nc > 1 || dinit) {
    const int both = nc > 1;
    ssd_scan_bwd_chain<T, NC>
        <<<(1 + both) * B * H, kThreads, chain_smem, stream>>>(
            xt, dyt, dtf, af, bmf, cmf, initf, dfinf,
            static_cast<float*>(dinit), ws_e, ws_g, S, H, P, N, nc, both,
            vec, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
            st[9]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_bwd_main<T, NC><<<B * nc * G, kThreads, main_smem, stream>>>(
      xt, dyt, dtf, af, bmf, cmf, initf, dfinf, ws_e, ws_g,
      static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(db),
      static_cast<float*>(dc), dap, part, S, H, P, N, nc, G, HG, vec, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // dB and dC's blocks (more than one group), then da's
  const i64 outs = G > 1 ? (i64)B * S * N : 0;
  ssd_scan_bwd_reduce<<<(unsigned)((outs + kThreads - 1) / kThreads + 1),
                        kThreads, 0, stream>>>(
      part, dap, static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), B, S, H, N, NP, nc, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* dy, const void* dt, const void* a,
             const void* bm, const void* cm, const void* init,
             const void* dfin, void* dx, void* ddt, void* da, void* db,
             void* dc, void* dinit, void* ws, int B, int S, int H, int P,
             int N, int G, int HG, int vec, const i64* st, cudaStream_t s) {
  const auto fn = N <= 16   ? launch<T, 1>
                  : N <= 32 ? launch<T, 2>
                  : N <= 64 ? launch<T, 4>
                            : launch<T, 8>;
  return fn(x, dy, dt, a, bm, cm, init, dfin, dx, ddt, da, db, dc, dinit, ws,
            B, S, H, P, N, G, HG, vec, st, s);
}

}  // namespace

// dtype (of x, dy and dx): 0 = float32, 1 = bfloat16.  Strides are in
// elements: x (batch, seq, head), dt (batch, seq, head), bm and cm
// (batch, seq); dy, init, dfin and every output contiguous; init, dfin and
// dinit may be null (dinit is written when it is not).  ws: the floats of
// kernels/ssd_scan.py::bwd_plan for the head groups G of HG heads.  vec:
// bit 0 when x's base and strides allow aligned 4-element loads, bit 1
// when B's do, bit 2 when C's do (and N is a multiple of 4).  The
// chain launch (past a single chunk, or with dinit), main and reduce on
// `stream`; returns
// cudaGetLastError() after them.  The caller checks
// shapes and dtypes; this entry refuses only what the kernel cannot do.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const void* dy, const void* dt, const void* a,
    const void* bm, const void* cm, const void* init, const void* dfin,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dinit, void* ws,
    int B, int S, int H, int P, int N, int G, int HG,
    long long sxb, long long sxs, long long sxh, long long sdb,
    long long sds, long long sdh, long long sbb, long long sbs,
    long long scb, long long scs, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > 128 || P <= 0 ||
      P > kP || P % 16 != 0 || G <= 0 || HG <= 0 || (i64)G * HG < H ||
      (i64)(G - 1) * HG >= H || ws == nullptr ||
      (dinit != nullptr) != (init != nullptr))
    return (int)cudaErrorInvalidValue;
  const i64 st[10] = {sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, dy, dt, a, bm, cm, init, dfin, dx, ddt, da, db,
                           dc, dinit, ws, B, S, H, P, N, G, HG, vec, st, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, dy, dt, a, bm, cm, init, dfin, dx, ddt,
                                   da, db, dc, dinit, ws, B, S, H, P, N, G,
                                   HG, vec, st, s);
  return (int)cudaErrorInvalidValue;
}
