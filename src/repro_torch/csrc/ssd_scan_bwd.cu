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
// E runs from the first chunk to the last (E' = exp(seg) E + (x o w)^T B),
// G from the last to the first (G_{c-1} = exp(seg_c) G_c + sum_i
// exp(cum_i) dy_i^T C_i, starting from dfin); what G reaches before chunk
// 0 is dinit.
//
// Design (simple and deterministic; four launches):
//   * states, one block per (batch, chunk, head): the chunk's own state
//     (x o w)^T B and its own reverse term (dy o exp(cum))^T C, each [P, NP]
//     (N padded to NP = 16, 32, 64 or 128), and exp(seg), into the
//     workspace.
//   * scan, one thread per (batch, head, p, n): walks the chunks forward,
//     turning each own state into the state entering the chunk, then
//     backward, turning each reverse term into the gradient of the state
//     leaving it, in place.  So the backward recomputes E rather than
//     keeping it from the forward: the workspace lives for one layer's
//     backward, 2 B (S / 64) H P NP floats (mamba2-780m at 4 x 2,048
//     tokens: 403 MB, freed when the call returns), where autograd would
//     hold 201 MB a layer for every layer until the backward reached it.
//   * main, one block per (batch, chunk, head group): C B^T once, then for
//     each head of the group every product above from shared memory,
//     dx and ddt written directly, d(dt a) o dt summed per (batch, chunk,
//     head), and dCB, exp(cum) o (dy E) and w o (x G) summed over the
//     group's heads in registers and shared memory; at the end the
//     group's dB and dC partials.  Head groups are as few as give ~132
//     blocks (kernels/ssd_scan.py::bwd_plan), so a call at 4 x 2,048
//     tokens runs 2 groups of 24 heads.
//   * reduce: dB and dC summed over the groups, da over batch and chunks,
//     each in a fixed order.  No float atomics anywhere, so two calls on
//     the same inputs give bitwise-equal gradients; what it costs is the
//     partials' round trip (2 x 64 x NP floats a block) and a launch.
//   * arithmetic: float32 FMA from shared memory (rows padded to an odd
//     pitch, so a warp's column reads fall on distinct banks), 4 x 4 or
//     4 x NP/16 outputs a thread; no tensor cores (TF32 would keep ~3
//     digits).  Rows past S load as zeros (dt = 0 there), so padded
//     positions and state columns add nothing to dB, dC or ddt.
//
// What bounds it: float32 operations.  The work the algorithm needs, per
// (batch, chunk of r rows, head): 2 r P N each for the chunk's own state,
// its reverse term, B G^T, x G and dy E, and 2 P per causal pair (r (r +
// 1) / 2 of them) each for dy x^T and scores^T dy; per (batch, chunk) 2 N
// per causal pair each for C B^T, dCB B and dCB^T C.  At mamba2-780m's 4 x
// 2,048 rows (H 48, P 64, N 128) that is 35.7 GFLOP, 0.53 ms at 67
// TFLOP/s; at hymba-1.5b's (H 50, N 16) 7.6 GFLOP, 0.11 ms (chip_smoke.py
// computes the bound of every shape it times from this count; PERF.md has
// the times).  The kernel does more than that: the full 64 x 64 products
// where only the causal half counts, and N padded to NP.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int kQ = 64;          // positions per chunk
constexpr int kP = 64;          // state rows (P <= 64)
constexpr int kThreads = 256;
constexpr int LQ = kQ + 1;      // odd pitches: conflict-free column reads
constexpr int LP = kP + 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[r][c] += sum_k A(r0 + 16 r, k) * B(c0 + 16 c, k), A(i, k) at
// A[i * sai + k * sak], B(j, k) at B[j * sbj + k * sbk]
template <int R, int C>
__device__ __forceinline__ void mm(float (&acc)[R][C], const float* A,
                                   int sai, int sak, const float* Bm,
                                   int sbj, int sbk, int K, int r0, int c0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = A[(r0 + 16 * r) * sai + k * sak];
#pragma unroll
    for (int c = 0; c < C; ++c) bv[c] = Bm[(c0 + 16 * c) * sbj + k * sbk];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
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
  if (vecum) {
    vecum[2 * lane] = expf(c0);
    vecum[2 * lane + 1] = expf(c1);
  }
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

// a [Q][LP] tile of x or dy (rows past nv and columns past P zero)
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, i64 srow,
                                          int nv, int P, int t) {
  for (int i = t; i < kQ * kP; i += kThreads) {
    const int j = i / kP, p = i % kP;
    dst[j * LP + p] = j < nv && p < P ? to_f(src[(i64)j * srow + p]) : 0.f;
  }
}

// [Q][LN] rows of B or C (rows past nv and columns past N zero)
template <int NP>
__device__ __forceinline__ void load_bc(float* dst, const float* src,
                                        i64 srow, int nv, int N, int t) {
  constexpr int LN = NP + 1;
  for (int i = t; i < kQ * NP; i += kThreads) {
    const int j = i / NP, n = i % NP;
    dst[j * LN + n] = j < nv && n < N ? src[(i64)j * srow + n] : 0.f;
  }
}

// ------------------------------------------------------------ states ----
// grid (B * chunks * H), block (b, c, h) in that order.  own [B][nc][H][P]
// [NP]: (x o w)^T B; rev (same layout): (dy o exp(cum))^T C; es [B][nc][H]:
// exp(seg).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_states(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm, float* __restrict__ own,
                        float* __restrict__ rev, float* __restrict__ es,
                        int S, int H, int P, int N, int nc, i64 sxb, i64 sxs,
                        i64 sxh, i64 sdb, i64 sds, i64 sdh, i64 sbb, i64 sbs,
                        i64 scb, i64 scs) {
  constexpr int NP = 16 * NC, LN = NP + 1;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [Q][LP] x o w
  float* dys = xs + kQ * LP;        // [Q][LP] dy o exp(cum)
  float* bs = dys + kQ * LP;        // [Q][LN]
  float* cs = bs + kQ * LN;         // [Q][LN]
  float* vdt = cs + kQ * LN;
  float* vcum = vdt + kQ;
  float* vecum = vcum + kQ;
  float* vw = vecum + kQ;
  const int t = threadIdx.x;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int s0 = c * kQ, nv = min(kQ, S - s0);

  load_rows(xs, x + b * sxb + h * sxh + (i64)s0 * sxs, sxs, nv, P, t);
  load_rows(dys, dy + ((i64)b * S + s0) * H * P + (i64)h * P, (i64)H * P, nv,
            P, t);
  load_bc<NP>(bs, bm + b * sbb + (i64)s0 * sbs, sbs, nv, N, t);
  load_bc<NP>(cs, cm + b * scb + (i64)s0 * scs, scs, nv, N, t);
  if (t < kQ) vdt[t] = t < nv ? dt[b * sdb + h * sdh + (i64)(s0 + t) * sds]
                              : 0.f;
  __syncthreads();
  if (t < 32) {
    const float e = chunk_cumsum(vdt, a[h], vcum, vecum, nullptr, vw, t);
    if (t == 0) es[((i64)b * nc + c) * H + h] = e;
  }
  __syncthreads();
  for (int i = t; i < kQ * kP; i += kThreads) {
    const int j = i / kP, p = i % kP;
    xs[j * LP + p] *= vw[j];
    dys[j * LP + p] *= vecum[j];
  }
  __syncthreads();
  const int r0 = t >> 4, c0 = t & 15;
  float so[4][NC] = {}, sr[4][NC] = {};
  // rows p, columns n, summed over the chunk's positions j
  mm(so, xs, 1, LP, bs, 1, LN, nv, r0, c0);
  mm(sr, dys, 1, LP, cs, 1, LN, nv, r0, c0);
  const i64 base = (((i64)b * nc + c) * H + h) * P * NP;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = r0 + 16 * r;
    if (p >= P) break;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      own[base + p * NP + c0 + 16 * q] = so[r][q];
      rev[base + p * NP + c0 + 16 * q] = sr[r][q];
    }
  }
}

// -------------------------------------------------------------- scan ----
// one thread per (b, h, p, n), n fastest: own -> the state entering each
// chunk (from init), rev -> the gradient of the state leaving each chunk
// (from dfin), in place; dinit what the gradient reaches before chunk 0.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_scan(float* __restrict__ own, float* __restrict__ rev,
                      const float* __restrict__ es,
                      const float* __restrict__ init,
                      const float* __restrict__ dfin,
                      float* __restrict__ dinit, int B, int H, int P, int N,
                      int NP, int nc) {
  const i64 i = (i64)blockIdx.x * kThreads + threadIdx.x;
  const i64 per = (i64)P * NP;
  if (i >= (i64)B * H * per) return;
  const int n = (int)(i % NP), p = (int)((i / NP) % P);
  const int bh = (int)(i / per), b = bh / H, h = bh % H;
  const i64 st = ((i64)bh * P + p) * N + n;
  const i64 step = (i64)H * per;
  const i64 first = ((i64)b * nc * H + h) * per + (i64)p * NP + n;
  const float* eseg = es + (i64)b * nc * H + h;
  float e = init != nullptr && n < N ? init[st] : 0.f;
  for (int c = 0; c < nc; ++c) {
    float* q = own + first + c * step;
    const float v = *q;
    *q = e;
    e = fmaf(eseg[(i64)c * H], e, v);
  }
  float g = dfin != nullptr && n < N ? dfin[st] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    float* q = rev + first + c * step;
    const float v = *q;
    *q = g;
    g = fmaf(eseg[(i64)c * H], g, v);
  }
  if (dinit != nullptr && n < N) dinit[st] = g;
}

// -------------------------------------------------------------- main ----
template <int NC>
struct MainSmem {
  static constexpr int NP = 16 * NC, LN = NP + 1;
  static constexpr int BS = 0;                 // [Q][LN] B rows
  static constexpr int CS = BS + kQ * LN;      // [Q][LN] C rows
  static constexpr int CB = CS + kQ * LN;      // [Q][LQ] C_i . B_j
  static constexpr int DCB = CB + kQ * LQ;     // [Q][LQ] dCB over the heads
  static constexpr int XS = DCB + kQ * LQ;     // [Q][LP] x
  static constexpr int DY = XS + kQ * LP;      // [Q][LP] dy
  static constexpr int EG = DY + kQ * LP;      // [kP][LN] G, then E
  static constexpr int KM = EG + kP * LN;      // [Q][LQ] K, then scores
  static constexpr int BG = KM + kQ * LQ;      // [Q][LP] B G^T
  static constexpr int VEC = BG + kQ * LP;     // 10 vectors of Q
  static constexpr int MISC = VEC + 10 * kQ;   // exp(seg), warp sums
  static constexpr int FLOATS = MISC + 16;
};

// grid (B * chunks * G), block (b, c, g) in that order: heads g HG ..
// min(H, (g + 1) HG).  state: the scan's entering states; grad: the
// gradients of the leaving ones (both [B][nc][H][P][NP]).  dap [B][nc][H]:
// sum_k d(dt a)_k dt_k; part [B][nc][G][2][Q][NP]: dB, then dC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_bwd_main(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ state,
                      const float* __restrict__ grad, T* __restrict__ dx,
                      float* __restrict__ ddt, float* __restrict__ dap,
                      float* __restrict__ part, int S, int H, int P, int N,
                      int nc, int G, int HG, i64 sxb, i64 sxs, i64 sxh,
                      i64 sdb, i64 sds, i64 sdh, i64 sbb, i64 sbs, i64 scb,
                      i64 scs) {
  typedef MainSmem<NC> L;
  constexpr int NP = L::NP, LN = L::LN;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem + L::BS;
  float* cs = smem + L::CS;
  float* cbm = smem + L::CB;
  float* dcb = smem + L::DCB;
  float* xs = smem + L::XS;
  float* dys = smem + L::DY;
  float* eg = smem + L::EG;
  float* km = smem + L::KM;
  float* bg = smem + L::BG;
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
  float* misc = smem + L::MISC;  // [0] exp(seg), [8..15] warp sums

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = t >> 4, c0 = t & 15;
  const int g = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % nc, b = bc / nc;
  const int s0 = c * kQ, nv = min(kQ, S - s0);
  const int h0 = g * HG, h1 = min(H, h0 + HG);

  load_bc<NP>(bs, bm + b * sbb + (i64)s0 * sbs, sbs, nv, N, t);
  load_bc<NP>(cs, cm + b * scb + (i64)s0 * scs, scs, nv, N, t);
  for (int i = t; i < kQ * LQ; i += kThreads) dcb[i] = 0.f;
  __syncthreads();
  {
    float acc[4][4] = {};
    mm(acc, cs, LN, 1, bs, LN, 1, NP, r0, c0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cbm[(r0 + 16 * r) * LQ + c0 + 16 * q] = acc[r][q];
  }
  float dba[4][NC] = {}, dca[4][NC] = {};
  const i64 chunk_base = ((i64)b * nc + c) * H;
  for (int h = h0; h < h1; ++h) {
    const i64 hb = (chunk_base + h) * P * NP;
    const float* gsrc = grad + hb;
    const float* esrc = state + hb;
    load_rows(xs, x + b * sxb + h * sxh + (i64)s0 * sxs, sxs, nv, P, t);
    load_rows(dys, dy + ((i64)b * S + s0) * H * P + (i64)h * P, (i64)H * P,
              nv, P, t);
    for (int i = t; i < kP * NP; i += kThreads) {
      const int p = i / NP, n = i % NP;
      eg[p * LN + n] = p < P ? gsrc[p * NP + n] : 0.f;
    }
    if (t < kQ)
      vdt[t] = t < nv ? dt[b * sdb + h * sdh + (i64)(s0 + t) * sds] : 0.f;
    __syncthreads();
    if (t < 32) {
      const float e = chunk_cumsum(vdt, a[h], vcum, vecum, ved, vw, lane);
      if (lane == 0) misc[0] = e;
    }
    __syncthreads();
    {  // B G^T [j][p]
      float acc[4][4] = {};
      mm(acc, bs, LN, 1, eg, LN, 1, NP, r0, c0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bg[(r0 + 16 * r) * LP + c0 + 16 * q] = acc[r][q];
    }
    {  // dB += w o (x G) [j][n]
      float acc[4][NC] = {};
      mm(acc, xs, LP, 1, eg, 1, LN, P, r0, c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float wj = vw[r0 + 16 * r];
#pragma unroll
        for (int q = 0; q < NC; ++q) dba[r][q] = fmaf(wj, acc[r][q], dba[r][q]);
      }
    }
    __syncthreads();  // G read, B G^T written
    float ge = 0.f;
    for (int i = t; i < kP * NP; i += kThreads) {
      const int p = i / NP, n = i % NP;
      const float e = p < P ? esrc[p * NP + n] : 0.f;
      eg[p * LN + n] = e;
      if (p < P) ge = fmaf(e, gsrc[p * NP + n], ge);
    }
    ge = warp_sum(ge);
    if (lane == 0) misc[8 + warp] = ge;
    if (t < kQ) {
      float v = 0.f;
      for (int p = 0; p < P; ++p) v = fmaf(xs[t * LP + p], bg[t * LP + p], v);
      vv[t] = ved[t] * v;
      vu[t] = vdt[t] * vv[t];
    }
    {  // M = dy x^T; dCB += M o L o dt^T; K = C B^T o L o M
      float m[4][4] = {};
      mm(m, dys, LP, 1, xs, LP, 1, P, r0, c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = c0 + 16 * q;
          const float ml = i >= j ? m[r][q] * expf(vcum[i] - vcum[j]) : 0.f;
          dcb[i * LQ + j] = fmaf(ml, vdt[j], dcb[i * LQ + j]);
          km[i * LQ + j] = cbm[i * LQ + j] * ml;
        }
      }
    }
    __syncthreads();
    if (t < kQ) {
      float s = 0.f;
      for (int j = 0; j < kQ; ++j) s = fmaf(km[t * LQ + j], vdt[j], s);
      vrow[t] = s;
    } else if (t < 2 * kQ) {
      const int j = t - kQ;
      float s = 0.f;
      for (int i = 0; i < kQ; ++i) s += km[i * LQ + j];
      vcol[j] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // the scores, over K
      const int i = r0 + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = c0 + 16 * q;
        km[i * LQ + j] =
            i >= j ? cbm[i * LQ + j] * expf(vcum[i] - vcum[j]) * vdt[j] : 0.f;
      }
    }
    __syncthreads();
    {  // dx = scores^T dy + w o (B G^T)
      float acc[4][4] = {};
      mm(acc, km, 1, LQ, dys, 1, LP, nv, r0, c0);
      T* dxb = dx + ((i64)b * S + s0) * H * P + (i64)h * P;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = r0 + 16 * r;
        if (j >= nv) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = c0 + 16 * q;
          if (p < P)
            from_f(dxb + (i64)j * H * P + p,
                   fmaf(vw[j], bg[j * LP + p], acc[r][q]));
        }
      }
    }
    {  // dy E [i][n]: dC += exp(cum) o (dy E); R = exp(cum) o (C . dy E)
      float acc[4][NC] = {};
      mm(acc, dys, LP, 1, eg, 1, LN, P, r0, c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + 16 * r;
        const float e = vecum[i];
        float rp = 0.f;
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const float v = e * acc[r][q];
          dca[r][q] += v;
          rp = fmaf(cs[i * LN + c0 + 16 * q], v, rp);
        }
        // the 16 lanes of a half-warp share r0
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rp += __shfl_xor_sync(0xffffffffu, rp, off);
        if (c0 == 0) vr[i] = rp;
      }
    }
    __syncthreads();
    if (t < 32) {  // d cum, its reverse cumsum, ddt and the da partial
      float gsum = 0.f;
      for (int w8 = 0; w8 < kThreads / 32; ++w8) gsum += misc[8 + w8];
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
      float* db = ddt + ((i64)b * S + s0) * H + h;
      if (k0 < nv) db[(i64)k0 * H] = fmaf(ah, dda0, vcol[k0] + vv[k0]);
      if (k1 < nv) db[(i64)k1 * H] = fmaf(ah, dda1, vcol[k1] + vv[k1]);
      const float s = warp_sum(fmaf(dda0, vdt[k0], dda1 * vdt[k1]));
      if (lane == 0) dap[chunk_base + h] = s;
    }
    __syncthreads();
  }
  {  // the heads' dCB: dC += dCB B, dB += dCB^T C
    float acc[4][NC] = {};
    mm(acc, dcb, LQ, 1, bs, 1, LN, nv, r0, c0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < NC; ++q) dca[r][q] += acc[r][q];
  }
  {
    float acc[4][NC] = {};
    mm(acc, dcb, 1, LQ, cs, 1, LN, nv, r0, c0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < NC; ++q) dba[r][q] += acc[r][q];
  }
  float* pb = part + (i64)blockIdx.x * 2 * kQ * NP;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int o = (r0 + 16 * r) * NP + c0 + 16 * q;
      pb[o] = dba[r][q];
      pb[kQ * NP + o] = dca[r][q];
    }
}

// ------------------------------------------------------------ reduce ----
// dB, dC [B][S][N]: the groups' partials summed in order; the last block:
// da [H], the (batch, chunk) partials summed in order.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_reduce(const float* __restrict__ part,
                        const float* __restrict__ dap, float* __restrict__ db,
                        float* __restrict__ dc, float* __restrict__ da, int B,
                        int S, int H, int N, int NP, int nc, int G) {
  const int t = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = t; h < H; h += kThreads) {
      float s = 0.f;
      for (int i = 0; i < B * nc; ++i) s += dap[(i64)i * H + h];
      da[h] = s;
    }
    return;
  }
  const i64 i = (i64)blockIdx.x * kThreads + t;
  if (i >= (i64)B * S * N) return;
  const int n = (int)(i % N);
  const i64 bs_ = i / N;
  const int s = (int)(bs_ % S), b = (int)(bs_ / S);
  const int c = s / kQ, j = s % kQ;
  const float* p0 = part + ((i64)b * nc + c) * G * 2 * kQ * NP + j * NP + n;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < G; ++g) {
    sb += p0[(i64)g * 2 * kQ * NP];
    sc += p0[(i64)g * 2 * kQ * NP + kQ * NP];
  }
  db[i] = sb;
  dc[i] = sc;
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
           const i64* st, cudaStream_t stream) {
  constexpr int NP = 16 * NC;
  const int nc = (S + kQ - 1) / kQ;
  float* own = static_cast<float*>(ws);
  float* rev = own + (i64)B * nc * H * P * NP;
  float* es = rev + (i64)B * nc * H * P * NP;
  float* dap = es + (i64)B * nc * H;
  float* part = dap + (i64)B * nc * H;
  if ((i64)B * nc * H > 0x7fffffff || (i64)B * nc * G > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int states_smem =
      (2 * kQ * LP + 2 * kQ * (NP + 1) + 4 * kQ) * (int)sizeof(float);
  const int main_smem = MainSmem<NC>::FLOATS * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = opt_in(ssd_scan_bwd_states<T, NC>, states_smem);
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
  ssd_scan_bwd_states<T, NC><<<B * nc * H, kThreads, states_smem, stream>>>(
      xt, dyt, dtf, af, bmf, cmf, own, rev, es, S, H, P, N, nc, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const i64 cells = (i64)B * H * P * NP;
  ssd_scan_bwd_scan<<<(unsigned)((cells + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(
      own, rev, es, static_cast<const float*>(init),
      static_cast<const float*>(dfin), static_cast<float*>(dinit), B, H, P,
      N, NP, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_scan_bwd_main<T, NC><<<B * nc * G, kThreads, main_smem, stream>>>(
      xt, dyt, dtf, af, bmf, cmf, own, rev, static_cast<T*>(dx),
      static_cast<float*>(ddt), dap, part, S, H, P, N, nc, G, HG, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const i64 outs = (i64)B * S * N;
  ssd_scan_bwd_reduce<<<(unsigned)((outs + kThreads - 1) / kThreads + 1),
                        kThreads, 0, stream>>>(
      part, dap, static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), B, S, H, N, NP, nc, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* dy, const void* dt, const void* a,
             const void* bm, const void* cm, const void* init,
             const void* dfin, void* dx, void* ddt, void* da, void* db,
             void* dc, void* dinit, void* ws, int B, int S, int H, int P,
             int N, int G, int HG, const i64* st, cudaStream_t s) {
  const auto fn = N <= 16   ? launch<T, 1>
                  : N <= 32 ? launch<T, 2>
                  : N <= 64 ? launch<T, 4>
                            : launch<T, 8>;
  return fn(x, dy, dt, a, bm, cm, init, dfin, dx, ddt, da, db, dc, dinit, ws,
            B, S, H, P, N, G, HG, st, s);
}

}  // namespace

// dtype (of x, dy and dx): 0 = float32, 1 = bfloat16.  Strides are in
// elements: x (batch, seq, head), dt (batch, seq, head), bm and cm
// (batch, seq); dy, init, dfin and every output contiguous; init, dfin and
// dinit may be null (dinit is written when it is not).  ws: the floats of
// kernels/ssd_scan.py::bwd_plan for the head groups G of HG heads.  Four
// launches on `stream`; returns cudaGetLastError() after them.  The caller
// checks shapes and dtypes; this entry refuses only what the kernel cannot
// do.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const void* dy, const void* dt, const void* a,
    const void* bm, const void* cm, const void* init, const void* dfin,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dinit, void* ws,
    int B, int S, int H, int P, int N, int G, int HG, long long sxb,
    long long sxs, long long sxh, long long sdb, long long sds,
    long long sdh, long long sbb, long long sbs, long long scb,
    long long scs, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > 128 || P <= 0 ||
      P > kP || P % 16 != 0 || G <= 0 || HG <= 0 || (i64)G * HG < H ||
      (i64)(G - 1) * HG >= H || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const i64 st[10] = {sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, dy, dt, a, bm, cm, init, dfin, dx, ddt, da, db,
                           dc, dinit, ws, B, S, H, P, N, G, HG, st, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, dy, dt, a, bm, cm, init, dfin, dx, ddt,
                                   da, db, dc, dinit, ws, B, S, H, P, N, G,
                                   HG, st, s);
  return (int)cudaErrorInvalidValue;
}
