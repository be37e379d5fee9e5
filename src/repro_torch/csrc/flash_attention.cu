// Flash attention for Hopper (sm_90a), forward and backward:
//
//   o[b, h, q] = sum_k softmax_k(q . k * scale | allowed) v[b, h / G, k]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (its pallas_call at :110, kernel body _kernel at :30).
// The Pallas kernel is forward only; JAX trains through autodiff of the
// lax.scan in src/repro/models/layers.py::attention_blockwise (:105).
// Here the backward is three kernels of its own.
//
// Allowed keys of query row q: k < Skv; with causal k <= q; with
// window > 0, q - k < window.  Head h reads KV head h / G (G = H / Hkv)
// through its index.  A fully masked row gives zeros.  Numerics of the
// Pallas kernel: q . k with operands in the input dtype T and f32
// accumulation, the online max and sum in f32, p rounded to T for the
// PV product, the output in T.  The forward also writes the per-row
// log-sum-exp (natural log, f32; +inf for a fully masked row) that the
// backward recomputes P from.
//
// Tensors come as [B, H, S, D] with element strides for (b, h, s) and
// unit stride along D, so the model's [B, S, H, D] activations go in
// without a transposing copy.  Ragged Sq and Skv are zero-filled at the
// loads and guarded at the stores; nothing is padded by the caller.
// Tiles whose every (query, key) pair is masked are skipped: the loop
// bounds of each block start and stop at the first and last tile that
// holds an allowed pair (above the causal diagonal, or older than the
// window, on either side).
//
// What bounds it (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s): at 2,048
// tokens a causal head does 2 * 2 * S^2 / 2 * D flop against 4 * S * D
// elements of q/k/v/o, ~1,000 flop per byte: operations.
//
// Design, bfloat16 (the serving and training dtype): mma.sync m16n8k16
// with f32 accumulators, operands staged in shared memory with 16-byte
// cp.async (rows padded by 8 elements) and read with ldmatrix (.trans
// where the contraction runs along the staged rows), the next tile in
// flight while the current one is multiplied.  The score fragment of an
// m16n8 product is laid out as the A fragment of the next m16n8k16, so P
// (and dS) go from the accumulators to the second product in registers.
//   * forward: one block of 4 warps per (64-row query tile, head,
//     batch); each warp owns 16 query rows and walks the 64-row K/V
//     tiles with the online softmax (row max and sum over the 4 lanes of
//     a fragment row by shuffles).
//   * backward, after delta = rowsum(dO * O) (one warp per row):
//     dK/dV: one block per (64-key tile, KV head, batch), each warp owns
//     16 keys and walks the query tiles (32 rows) of every head of its
//     group, so dK and dV sum over the group without atomics:
//     S^T = K Q^T, P^T = exp(S^T - lse), dV += P^T dO, dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta), dK += dS^T Q;
//     dQ: one block per (64-row query tile, head, batch), each warp 16
//     rows, walking the K/V tiles: dQ += (P (dO V^T - delta)) K.
// Design, float32 (the reduced reference configs): plain FMAs (no TF32,
// so the card agrees with the CPU to f32 rounding); 8 lanes per query
// (or key) row, each owning D / 8 channels, dot products reduced across
// the 8 lanes by shuffles; 32-row tiles in shared memory.
// Not yet: wgmma and TMA, warp specialisation, a persistent schedule,
// a split of the KV walk across blocks when B * H * Sq / 64 is small.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned short u16;

constexpr float NEG = -1e30f;  // masked score (finite: no inf - inf)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float *lse, *delta;
  void *out, *dk, *dv;  // out: o (forward) or dq
  float* lse_out;
  int B, H, Hkv, G, Sq, Skv;
  i64 qs[3], ks[3], vs[3], os[3], dos[3], outs[3], dks[3], dvs[3];
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp) {
  return kp < a.Skv && qp < a.Sq && (!a.causal || kp <= qp) &&
         (a.window <= 0 || qp - kp < a.window);
}

__host__ __device__ __forceinline__ int cdiv(int x, int y) {
  return (x + y - 1) / y;
}

// KV tiles [jb, je) of BK rows holding an allowed key for some query of
// [q0, q0 + BQ)
__device__ __forceinline__ void kv_range(const Args& a, int q0, int BQ,
                                         int BK, int& jb, int& je) {
  const int q_hi = min(q0 + BQ - 1, a.Sq - 1);
  je = cdiv(a.Skv, BK);
  if (a.causal) je = min(je, q_hi / BK + 1);
  jb = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) jb = (q0 - a.window + 1) / BK;
}

// query tiles [ib, ie) of BQ rows holding an allowed query for some key
// of [k0, k0 + BK)
__device__ __forceinline__ void q_range(const Args& a, int k0, int BK,
                                        int BQ, int& ib, int& ie) {
  const int k_hi = min(k0 + BK - 1, a.Skv - 1);
  ie = cdiv(a.Sq, BQ);
  ib = a.causal ? k0 / BQ : 0;
  if (a.window > 0) ie = min(ie, (k_hi + a.window - 1) / BQ + 1);
}

__device__ __forceinline__ float bf16_f(u16 x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ u16 bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// two floats as a bf16 pair, the first in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(bf16_bits(lo)) |
         (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// sum over the 8 lanes of one row (lanes 8r .. 8r + 7)
__device__ __forceinline__ float oct_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// ------------------------------------------------ bf16 building blocks --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes == 0 zero-fills the chunk
__device__ __forceinline__ void cp_async16(u16* dst, const u16* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t* r, const u16* p) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a @ b for one m16n8k16 bf16 fragment, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16) at (row, k) of a [rows][k] tile of pitch P
template <int P>
__device__ __forceinline__ void frag_a(uint32_t* a, const u16* s, int row,
                                       int k, int lane) {
  const int j = lane / 8;
  ldsm4<false>(a, s + (row + lane % 8 + 8 * (j % 2)) * P + k + 8 * (j / 2));
}

// B fragments of the column groups n and n + 8 (16 x 8 each) at depth k:
// b[0..1] for n, b[2..3] for n + 8.  KN: the tile is stored [k][n];
// otherwise [n][k].
template <bool KN, int P>
__device__ __forceinline__ void frag_b2(uint32_t* b, const u16* s, int n,
                                        int k, int lane) {
  const int j = lane / 8, i = lane % 8;
  if (KN)
    ldsm4<true>(b, s + (k + i + 8 * (j % 2)) * P + n + 8 * (j / 2));
  else
    ldsm4<false>(b, s + (n + i + 8 * (j / 2)) * P + k + 8 * (j % 2));
}

// the A fragment of a 16 x 16 slice (columns 16 kk .. 16 kk + 15) of a
// 16 x N accumulator c[N / 8][4], rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Stage rows [r0, r0 + R) of a [n, D] operand (row stride ld, unit
// stride along D) in shared memory at pitch D + 8; rows past n load as 0
template <int R, int D, int NT>
__device__ __forceinline__ void stage_rows(u16* s, const u16* base, i64 ld,
                                           int r0, int n, int tid) {
  constexpr int CH = D / 8, P = D + 8;
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, gr = r0 + r;
    const u16* src = base;
    int bytes = 0;
    if (gr < n) {
      src = base + (i64)gr * ld + c;
      bytes = 16;
    }
    cp_async16(s + r * P + c, src, bytes);
  }
}

// rows r and r + 8 of a 16 x D accumulator, scaled by f, stored as bf16
// pairs at base + row * ld (rows at or past n are dropped)
template <int D>
__device__ __forceinline__ void store_rows(u16* base, i64 ld, int r, int n,
                                           const float (*c)[4], int t,
                                           const float* f) {
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    const int col = jn * 8 + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r + 8 * hf;
      if (row < n)
        *reinterpret_cast<uint32_t*>(base + (i64)row * ld + col) =
            pack_bf16(c[jn][2 * hf] * f[hf], c[jn][2 * hf + 1] * f[hf]);
    }
  }
}

// --------------------------------------------------- bf16 forward --------
template <int D>
struct FwdBf16 {
  static constexpr int BQ = 64, BK = 64, NT = 128, P = D + 8;
  static constexpr int SMEM = (BQ + 4 * BK) * P * 2;
};

template <int D>
__global__ void __launch_bounds__(128) fa_fwd_bf16(Args a) {
  typedef FwdBf16<D> C;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, P = C::P;
  extern __shared__ __align__(16) u16 smem[];
  u16* Qs = smem;
  u16* KV = smem + BQ * P;  // buffer st: K at KV + 2 st BK P, V after it
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const u16* Q = static_cast<const u16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const u16* K = static_cast<const u16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const u16* V = static_cast<const u16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  int jb, je;
  kv_range(a, q0, BQ, BK, jb, je);
  const float sl2 = a.scale * LOG2E;

  auto load_kv = [&](int j, int st) {
    u16* Ks = KV + st * 2 * BK * P;
    stage_rows<BK, D, NT>(Ks, K, a.ks[2], j * BK, a.Skv, tid);
    stage_rows<BK, D, NT>(Ks + BK * P, V, a.vs[2], j * BK, a.Skv, tid);
  };
  stage_rows<BQ, D, NT>(Qs, Q, a.qs[2], q0, a.Sq, tid);
  if (jb < je) load_kv(jb, 0);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + g;  // this lane's rows r0, r0 + 8

  for (int j = jb; j < je; ++j) {
    const int it = j - jb;
    if (j + 1 < je) load_kv(j + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j (and Q) landed
    const u16* Ks = KV + (it & 1) * 2 * BK * P;
    const u16* Vs = Ks + BK * P;

    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      frag_a<P>(af, Qs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jn = 0; jn < BK / 8; jn += 2) {
        uint32_t bb[4];
        frag_b2<false, P>(bb, Ks, jn * 8, kk * 16, lane);
        mma_bf16(s[jn], af, bb[0], bb[1]);
        mma_bf16(s[jn + 1], af, bb[2], bb[3]);
      }
    }
    // scores in log2 units; masked ones at NEG
    const int k0 = j * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + jn * 8 + 2 * t + (e & 1);
        const float x = allowed(a, r0 + 8 * (e >> 1), kp) ? s[jn][e] * sl2
                                                          : NEG;
        s[jn][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[jn][e] == NEG ? 0.f : exp2f(s[jn][e] - m[e >> 1]);
        s[jn][e] = p;
        l[e >> 1] += p;  // this lane's part of the row sum, in f32
      }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= corr[e >> 1];
    // acc += round_T(P) @ V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s, kk);
#pragma unroll
      for (int jn = 0; jn < D / 8; jn += 2) {
        uint32_t bb[4];
        frag_b2<true, P>(bb, Vs, jn * 8, kk * 16, lane);
        mma_bf16(acc[jn], pa, bb[0], bb[1]);
        mma_bf16(acc[jn + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  u16* O = static_cast<u16*>(a.out) + b * a.outs[0] + h * a.outs[1];
  store_rows<D>(O, a.outs[2], r0, a.Sq, acc, t, inv);
  if (t == 0) {
    float* L = a.lse_out + ((i64)b * a.H + h) * a.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < a.Sq)
        L[row] = l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : INFINITY;
    }
  }
}

// ------------------------------------------------- bf16 backward ---------
template <int D>
struct DkdvBf16 {
  static constexpr int BK = 64, BQ = 32, NT = 128, P = D + 8;
  // K, V, then two buffers of (Q, dO) tiles, then two of (lse, delta)
  static constexpr int SMEM = (2 * BK + 4 * BQ) * P * 2 + 4 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(128) fa_dkdv_bf16(Args a) {
  typedef DkdvBf16<D> C;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::NT, P = C::P;
  extern __shared__ __align__(16) u16 smem[];
  u16* Ks = smem;
  u16* Vs = smem + BK * P;
  u16* QD = smem + 2 * BK * P;  // buffer st: Q at QD + 2 st BQ P, dO after
  float* LD = reinterpret_cast<float*>(QD + 4 * BQ * P);  // [st][lse|dl][BQ]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const u16* K = static_cast<const u16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const u16* V = static_cast<const u16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  int ib, ie;
  q_range(a, k0, BK, BQ, ib, ie);
  const int ni = ie > ib ? ie - ib : 0, n_it = a.G * ni;
  const float sl2 = a.scale * LOG2E;

  auto load_q = [&](int it, int st) {
    const int hh = hk * a.G + it / ni, q0 = (ib + it % ni) * BQ;
    u16* Qs = QD + st * 2 * BQ * P;
    stage_rows<BQ, D, NT>(
        Qs, static_cast<const u16*>(a.q) + b * a.qs[0] + hh * a.qs[1],
        a.qs[2], q0, a.Sq, tid);
    stage_rows<BQ, D, NT>(
        Qs + BQ * P,
        static_cast<const u16*>(a.dO) + b * a.dos[0] + hh * a.dos[1],
        a.dos[2], q0, a.Sq, tid);
    if (tid < BQ) {
      const int qp = q0 + tid;
      const i64 row = ((i64)b * a.H + hh) * a.Sq + qp;
      LD[st * 2 * BQ + tid] = qp < a.Sq ? a.lse[row] * LOG2E : INFINITY;
      LD[st * 2 * BQ + BQ + tid] = qp < a.Sq ? a.delta[row] : 0.f;
    }
  };
  stage_rows<BK, D, NT>(Ks, K, a.ks[2], k0, a.Skv, tid);
  stage_rows<BK, D, NT>(Vs, V, a.vs[2], k0, a.Skv, tid);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int kr = k0 + warp * 16 + g;  // this lane's keys kr, kr + 8

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const u16* Qs = QD + st * 2 * BQ * P;
    const u16* dOs = Qs + BQ * P;
    const float* lse2 = LD + st * 2 * BQ;
    const float* dl = lse2 + BQ;
    const int q0 = (ib + it % ni) * BQ;

    // P^T = exp(K Q^T * scale - lse): rows are keys, columns queries
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<P>(ka, Ks, warp * 16, kk * 16, lane);
      frag_a<P>(va, Vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jn = 0; jn < BQ / 8; jn += 2) {
        uint32_t bb[4];
        frag_b2<false, P>(bb, Qs, jn * 8, kk * 16, lane);
        mma_bf16(s[jn], ka, bb[0], bb[1]);
        mma_bf16(s[jn + 1], ka, bb[2], bb[3]);
        frag_b2<false, P>(bb, dOs, jn * 8, kk * 16, lane);  // dP^T = V dO^T
        mma_bf16(dp[jn], va, bb[0], bb[1]);
        mma_bf16(dp[jn + 1], va, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int jn = 0; jn < BQ / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = jn * 8 + 2 * t + (e & 1);
        const float p = allowed(a, q0 + qc, kr + 8 * (e >> 1))
                            ? exp2f(s[jn][e] * sl2 - lse2[qc])
                            : 0.f;
        s[jn][e] = p;
        dp[jn][e] = p * (dp[jn][e] - dl[qc]);  // dS^T
      }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s, kk);
      acc_to_a(da, dp, kk);
#pragma unroll
      for (int jn = 0; jn < D / 8; jn += 2) {
        uint32_t bb[4];
        frag_b2<true, P>(bb, dOs, jn * 8, kk * 16, lane);
        mma_bf16(dv[jn], pa, bb[0], bb[1]);
        mma_bf16(dv[jn + 1], pa, bb[2], bb[3]);
        frag_b2<true, P>(bb, Qs, jn * 8, kk * 16, lane);
        mma_bf16(dk[jn], da, bb[0], bb[1]);
        mma_bf16(dk[jn + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const float one[2] = {1.f, 1.f}, sc[2] = {a.scale, a.scale};
  store_rows<D>(static_cast<u16*>(a.dk) + b * a.dks[0] + hk * a.dks[1],
                a.dks[2], kr, a.Skv, dk, t, sc);
  store_rows<D>(static_cast<u16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1],
                a.dvs[2], kr, a.Skv, dv, t, one);
}

template <int D>
struct DqBf16 {
  static constexpr int BQ = 64, BK = 64, NT = 128, P = D + 8;
  static constexpr int SMEM = (2 * BQ + 4 * BK) * P * 2;
};

template <int D>
__global__ void __launch_bounds__(128) fa_dq_bf16(Args a) {
  typedef DqBf16<D> C;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, P = C::P;
  extern __shared__ __align__(16) u16 smem[];
  u16* Qs = smem;
  u16* dOs = smem + BQ * P;
  u16* KV = smem + 2 * BQ * P;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const u16* K = static_cast<const u16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const u16* V = static_cast<const u16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  int jb, je;
  kv_range(a, q0, BQ, BK, jb, je);
  const float sl2 = a.scale * LOG2E;

  auto load_kv = [&](int j, int st) {
    u16* Ks = KV + st * 2 * BK * P;
    stage_rows<BK, D, NT>(Ks, K, a.ks[2], j * BK, a.Skv, tid);
    stage_rows<BK, D, NT>(Ks + BK * P, V, a.vs[2], j * BK, a.Skv, tid);
  };
  stage_rows<BQ, D, NT>(
      Qs, static_cast<const u16*>(a.q) + b * a.qs[0] + h * a.qs[1], a.qs[2],
      q0, a.Sq, tid);
  stage_rows<BQ, D, NT>(
      dOs, static_cast<const u16*>(a.dO) + b * a.dos[0] + h * a.dos[1],
      a.dos[2], q0, a.Sq, tid);
  if (jb < je) load_kv(jb, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    const i64 row = ((i64)b * a.H + h) * a.Sq + qp;
    lse2[r] = qp < a.Sq ? a.lse[row] * LOG2E : INFINITY;
    dl[r] = qp < a.Sq ? a.delta[row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int j = jb; j < je; ++j) {
    const int it = j - jb;
    if (j + 1 < je) load_kv(j + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const u16* Ks = KV + (it & 1) * 2 * BK * P;
    const u16* Vs = Ks + BK * P;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a<P>(qa, Qs, warp * 16, kk * 16, lane);
      frag_a<P>(da, dOs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int jn = 0; jn < BK / 8; jn += 2) {
        uint32_t bb[4];
        frag_b2<false, P>(bb, Ks, jn * 8, kk * 16, lane);  // S = Q K^T
        mma_bf16(s[jn], qa, bb[0], bb[1]);
        mma_bf16(s[jn + 1], qa, bb[2], bb[3]);
        frag_b2<false, P>(bb, Vs, jn * 8, kk * 16, lane);  // dP = dO V^T
        mma_bf16(dp[jn], da, bb[0], bb[1]);
        mma_bf16(dp[jn + 1], da, bb[2], bb[3]);
      }
    }
    const int k0 = j * BK;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + jn * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = allowed(a, r0 + 8 * r, kp)
                            ? exp2f(s[jn][e] * sl2 - lse2[r])
                            : 0.f;
        dp[jn][e] = p * (dp[jn][e] - dl[r]);  // dS
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp, kk);
#pragma unroll
      for (int jn = 0; jn < D / 8; jn += 2) {
        uint32_t bb[4];
        frag_b2<true, P>(bb, Ks, jn * 8, kk * 16, lane);
        mma_bf16(dq[jn], da, bb[0], bb[1]);
        mma_bf16(dq[jn + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const float sc[2] = {a.scale, a.scale};
  store_rows<D>(static_cast<u16*>(a.out) + b * a.outs[0] + h * a.outs[1],
                a.outs[2], r0, a.Sq, dq, t, sc);
}

// ------------------------------------------------------ float32 ---------
// 8 lanes per row: lane `sub` of a row owns channels sub, sub + 8, ...
constexpr int F_ROWS = 32, F_NT = 256;

template <int D>
__device__ __forceinline__ void load_row(float* r, const float* base,
                                         i64 ld, int row, int n, int sub) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    r[i] = row < n ? base[(i64)row * ld + sub + 8 * i] : 0.f;
}

// rows [r0, r0 + F_ROWS) of a [n, D] operand into s[F_ROWS][D]
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* base,
                                          i64 ld, int r0, int n, int tid) {
  for (int i = tid; i < F_ROWS * D; i += F_NT) {
    const int r = i / D, c = i % D;
    s[i] = r0 + r < n ? base[(i64)(r0 + r) * ld + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float* r, const float* s,
                                         int sub) {
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) x = fmaf(r[i], s[sub + 8 * i], x);
  return oct_sum(x);
}

template <int D>
__global__ void __launch_bounds__(F_NT) fa_fwd_f32(Args a) {
  constexpr int BQ = F_ROWS, BK = F_ROWS, E = D / 8;
  __shared__ float Ks[BK * D], Vs[BK * D];
  const int tid = threadIdx.x, sub = tid % 8;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G, qp = q0 + tid / 8;
  const float* K = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* V = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  float q[E], acc[E];
  load_row<D>(q, static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1],
              a.qs[2], qp, a.Sq, sub);
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;
  int jb, je;
  kv_range(a, q0, BQ, BK, jb, je);
  for (int j = jb; j < je; ++j) {
    __syncthreads();
    load_tile<D>(Ks, K, a.ks[2], j * BK, a.Skv, tid);
    load_tile<D>(Vs, V, a.vs[2], j * BK, a.Skv, tid);
    __syncthreads();
    float s[BK];
    float mx = m;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float x = dot_row<D>(q, Ks + kk * D, sub);
      s[kk] = allowed(a, qp, j * BK + kk) ? x * a.scale : NEG;
      mx = fmaxf(mx, s[kk]);
    }
    const float corr = expf(m - mx);
    m = mx;
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      s[kk] = s[kk] == NEG ? 0.f : expf(s[kk] - m);
      psum += s[kk];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      float x = acc[i] * corr;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) x = fmaf(s[kk], Vs[kk * D + sub + 8 * i], x);
      acc[i] = x;
    }
  }
  if (qp < a.Sq) {
    float* O = static_cast<float*>(a.out) + b * a.outs[0] + h * a.outs[1] +
               (i64)qp * a.outs[2];
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < E; ++i) O[sub + 8 * i] = acc[i] / lc;
    if (sub == 0)
      a.lse_out[((i64)b * a.H + h) * a.Sq + qp] =
          l > 0.f ? m + logf(l) : INFINITY;
  }
}

template <int D>
__global__ void __launch_bounds__(F_NT) fa_dkdv_f32(Args a) {
  constexpr int BQ = F_ROWS, BK = F_ROWS, E = D / 8;
  __shared__ float Qs[BQ * D], dOs[BQ * D], ls[BQ], dls[BQ];
  const int tid = threadIdx.x, sub = tid % 8;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int kp = k0 + tid / 8;
  float kr[E], vr[E], dk[E], dv[E];
  load_row<D>(kr,
              static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1],
              a.ks[2], kp, a.Skv, sub);
  load_row<D>(vr,
              static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1],
              a.vs[2], kp, a.Skv, sub);
#pragma unroll
  for (int i = 0; i < E; ++i) dk[i] = dv[i] = 0.f;
  int ib, ie;
  q_range(a, k0, BK, BQ, ib, ie);
  for (int hh = hk * a.G; hh < (hk + 1) * a.G; ++hh) {
    const float* Q = static_cast<const float*>(a.q) + b * a.qs[0] +
                     hh * a.qs[1];
    const float* dO = static_cast<const float*>(a.dO) + b * a.dos[0] +
                      hh * a.dos[1];
    const i64 lrow = ((i64)b * a.H + hh) * a.Sq;
    for (int i = ib; i < ie; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile<D>(Qs, Q, a.qs[2], q0, a.Sq, tid);
      load_tile<D>(dOs, dO, a.dos[2], q0, a.Sq, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < a.Sq;
        ls[tid] = in ? a.lse[lrow + q0 + tid] : INFINITY;
        dls[tid] = in ? a.delta[lrow + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int qq = 0; qq < BQ; ++qq) {
        const float x = dot_row<D>(kr, Qs + qq * D, sub);
        const float p = allowed(a, q0 + qq, kp)
                            ? expf(x * a.scale - ls[qq])
                            : 0.f;
        const float dp = dot_row<D>(vr, dOs + qq * D, sub);
        const float ds = p * (dp - dls[qq]);
#pragma unroll
        for (int c = 0; c < E; ++c) {
          dv[c] = fmaf(p, dOs[qq * D + sub + 8 * c], dv[c]);
          dk[c] = fmaf(ds, Qs[qq * D + sub + 8 * c], dk[c]);
        }
      }
    }
  }
  if (kp < a.Skv) {
    float* DK = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1] +
                (i64)kp * a.dks[2];
    float* DV = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1] +
                (i64)kp * a.dvs[2];
#pragma unroll
    for (int c = 0; c < E; ++c) {
      DK[sub + 8 * c] = dk[c] * a.scale;
      DV[sub + 8 * c] = dv[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F_NT) fa_dq_f32(Args a) {
  constexpr int BQ = F_ROWS, BK = F_ROWS, E = D / 8;
  __shared__ float Ks[BK * D], Vs[BK * D];
  const int tid = threadIdx.x, sub = tid % 8;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G, qp = q0 + tid / 8;
  const float* K = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* V = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  float q[E], dO[E], dq[E];
  load_row<D>(q, static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1],
              a.qs[2], qp, a.Sq, sub);
  load_row<D>(dO,
              static_cast<const float*>(a.dO) + b * a.dos[0] + h * a.dos[1],
              a.dos[2], qp, a.Sq, sub);
#pragma unroll
  for (int i = 0; i < E; ++i) dq[i] = 0.f;
  const i64 row = ((i64)b * a.H + h) * a.Sq + qp;
  const float lse = qp < a.Sq ? a.lse[row] : INFINITY;
  const float dl = qp < a.Sq ? a.delta[row] : 0.f;
  int jb, je;
  kv_range(a, q0, BQ, BK, jb, je);
  for (int j = jb; j < je; ++j) {
    __syncthreads();
    load_tile<D>(Ks, K, a.ks[2], j * BK, a.Skv, tid);
    load_tile<D>(Vs, V, a.vs[2], j * BK, a.Skv, tid);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      const float x = dot_row<D>(q, Ks + kk * D, sub);
      const float p =
          allowed(a, qp, j * BK + kk) ? expf(x * a.scale - lse) : 0.f;
      const float dp = dot_row<D>(dO, Vs + kk * D, sub);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int c = 0; c < E; ++c)
        dq[c] = fmaf(ds, Ks[kk * D + sub + 8 * c], dq[c]);
    }
  }
  if (qp < a.Sq) {
    float* DQ = static_cast<float*>(a.out) + b * a.outs[0] + h * a.outs[1] +
                (i64)qp * a.outs[2];
#pragma unroll
    for (int c = 0; c < E; ++c) DQ[sub + 8 * c] = dq[c] * a.scale;
  }
}

// ----------------------------------------------------- delta (both) -----
// delta[b, h, q] = sum_d dO * O in f32; one warp per row
template <bool BF16>
__global__ void __launch_bounds__(256) fa_delta(Args a, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const i64 row = (i64)blockIdx.x * 8 + warp;
  if (row >= (i64)a.B * a.H * a.Sq) return;
  const int qp = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.H), b = (int)(row / a.Sq / a.H);
  const i64 oo = b * a.os[0] + h * a.os[1] + qp * a.os[2];
  const i64 od = b * a.dos[0] + h * a.dos[1] + qp * a.dos[2];
  float x = 0.f;
  for (int c = lane; c < D; c += 32) {
    if (BF16)
      x = fmaf(bf16_f(static_cast<const u16*>(a.o)[oo + c]),
               bf16_f(static_cast<const u16*>(a.dO)[od + c]), x);
    else
      x = fmaf(static_cast<const float*>(a.o)[oo + c],
               static_cast<const float*>(a.dO)[od + c], x);
  }
#pragma unroll
  for (int w = 16; w > 0; w /= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  if (lane == 0) a.lse_out[row] = x;
}

// ------------------------------------------------------ launching -------
template <class KernelT>
int opt_in(KernelT kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool ok_strides(const i64* s) {
  return s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
}

void set3(i64* dst, i64 a, i64 b, i64 c) {
  dst[0] = a;
  dst[1] = b;
  dst[2] = c;
}

Args make_args(int B, int H, int Hkv, int Sq, int Skv, int causal,
               int window, float scale) {
  Args a = {};
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

bool bad_dims(int dtype, int B, int H, int Hkv, int Sq, int Skv, int D) {
  return (dtype != 0 && dtype != 1) || (D != 64 && D != 128) || B <= 0 ||
         Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0;
}

template <int D>
int fwd(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    typedef FwdBf16<D> C;
    static bool done = false;
    const int e = opt_in(fa_fwd_bf16<D>, C::SMEM, done);
    if (e) return e;
    dim3 grid(cdiv(a.Sq, C::BQ), a.H, a.B);
    fa_fwd_bf16<D><<<grid, C::NT, C::SMEM, s>>>(a);
  } else {
    dim3 grid(cdiv(a.Sq, F_ROWS), a.H, a.B);
    fa_fwd_f32<D><<<grid, F_NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dkdv(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    typedef DkdvBf16<D> C;
    static bool done = false;
    const int e = opt_in(fa_dkdv_bf16<D>, C::SMEM, done);
    if (e) return e;
    dim3 grid(cdiv(a.Skv, C::BK), a.Hkv, a.B);
    fa_dkdv_bf16<D><<<grid, C::NT, C::SMEM, s>>>(a);
  } else {
    dim3 grid(cdiv(a.Skv, F_ROWS), a.Hkv, a.B);
    fa_dkdv_f32<D><<<grid, F_NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dq(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    typedef DqBf16<D> C;
    static bool done = false;
    const int e = opt_in(fa_dq_bf16<D>, C::SMEM, done);
    if (e) return e;
    dim3 grid(cdiv(a.Sq, C::BQ), a.H, a.B);
    fa_dq_bf16<D><<<grid, C::NT, C::SMEM, s>>>(a);
  } else {
    dim3 grid(cdiv(a.Sq, F_ROWS), a.H, a.B);
    fa_dq_f32<D><<<grid, F_NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  q [B, H, Sq, D], k and v [B, Hkv, Skv,
// D], o [B, H, Sq, D], each with element strides (b, h, s) and unit
// stride along D (bf16: strides multiples of 8 elements, 16-byte aligned
// pointers); lse a contiguous f32 [B, H, Sq].  D is 64 or 128.  Each
// entry returns cudaGetLastError() after its launch (0 when accepted),
// or cudaErrorInvalidValue for operands it does not take.
extern "C" int flash_attention_fwd_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int H, int Hkv, int Sq, int Skv, int D, i64 sqb,
    i64 sqh, i64 sqs, i64 skb, i64 skh, i64 sks, i64 svb, i64 svh, i64 svs,
    i64 sob, i64 soh, i64 sos, int causal, int window, float scale,
    void* stream) {
  if (bad_dims(dtype, B, H, Hkv, Sq, Skv, D))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, Hkv, Sq, Skv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse_out = lse;
  set3(a.qs, sqb, sqh, sqs);
  set3(a.ks, skb, skh, sks);
  set3(a.vs, svb, svh, svs);
  set3(a.outs, sob, soh, sos);
  if (dtype == 1 &&
      !(ok_strides(a.qs) && ok_strides(a.ks) && ok_strides(a.vs) &&
        ok_strides(a.outs) && aligned(q) && aligned(k) && aligned(v) &&
        aligned(o)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? fwd<64>(a, dtype, s) : fwd<128>(a, dtype, s);
}

extern "C" int flash_attention_bwd_delta_launch(int dtype, const void* o,
                                                const void* dO, float* delta,
                                                int B, int H, int Sq, int D,
                                                i64 sob, i64 soh, i64 sos,
                                                i64 sdb, i64 sdh, i64 sds,
                                                void* stream) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || H <= 0 || Sq <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, 1, Sq, 1, 0, 0, 0.f);
  a.H = H;
  a.o = o;
  a.dO = dO;
  a.lse_out = delta;
  set3(a.os, sob, soh, sos);
  set3(a.dos, sdb, sdh, sds);
  const i64 rows = (i64)B * H * Sq;
  dim3 grid((unsigned)((rows + 7) / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    fa_delta<true><<<grid, 256, 0, s>>>(a, D);
  else
    fa_delta<false><<<grid, 256, 0, s>>>(a, D);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dkdv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Skv, int D, i64 sqb, i64 sqh, i64 sqs, i64 skb,
    i64 skh, i64 sks, i64 svb, i64 svh, i64 svs, i64 sdb, i64 sdh, i64 sds,
    i64 skgb, i64 skgh, i64 skgs, i64 svgb, i64 svgh, i64 svgs, int causal,
    int window, float scale, void* stream) {
  if (bad_dims(dtype, B, H, Hkv, Sq, Skv, D))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, Hkv, Sq, Skv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  set3(a.qs, sqb, sqh, sqs);
  set3(a.ks, skb, skh, sks);
  set3(a.vs, svb, svh, svs);
  set3(a.dos, sdb, sdh, sds);
  set3(a.dks, skgb, skgh, skgs);
  set3(a.dvs, svgb, svgh, svgs);
  if (dtype == 1 &&
      !(ok_strides(a.qs) && ok_strides(a.ks) && ok_strides(a.vs) &&
        ok_strides(a.dos) && ok_strides(a.dks) && ok_strides(a.dvs) &&
        aligned(q) && aligned(k) && aligned(v) && aligned(dO) &&
        aligned(dk) && aligned(dv)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? dkdv<64>(a, dtype, s) : dkdv<128>(a, dtype, s);
}

extern "C" int flash_attention_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* delta, void* dq_out, int B, int H,
    int Hkv, int Sq, int Skv, int D, i64 sqb, i64 sqh, i64 sqs, i64 skb,
    i64 skh, i64 sks, i64 svb, i64 svh, i64 svs, i64 sdb, i64 sdh, i64 sds,
    i64 sgb, i64 sgh, i64 sgs, int causal, int window, float scale,
    void* stream) {
  if (bad_dims(dtype, B, H, Hkv, Sq, Skv, D))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, Hkv, Sq, Skv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = lse;
  a.delta = delta;
  a.out = dq_out;
  set3(a.qs, sqb, sqh, sqs);
  set3(a.ks, skb, skh, sks);
  set3(a.vs, svb, svh, svs);
  set3(a.dos, sdb, sdh, sds);
  set3(a.outs, sgb, sgh, sgs);
  if (dtype == 1 &&
      !(ok_strides(a.qs) && ok_strides(a.ks) && ok_strides(a.vs) &&
        ok_strides(a.dos) && ok_strides(a.outs) && aligned(q) &&
        aligned(k) && aligned(v) && aligned(dO) && aligned(dq_out)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? dq<64>(a, dtype, s) : dq<128>(a, dtype, s);
}
