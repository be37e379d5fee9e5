// Mamba2 SSD chunked scan for Hopper (sm_90a): the prefill of every
// attention-free (state-space) layer.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (its
// pallas_call at :94, kernel body _kernel at :27).  It computes what
// repro.models.mamba2.ssd_chunked computes (single B/C group):
//
//   x      [B, S, H, P]  T (float or bfloat16), any strides, unit along P
//   dt     [B, S, H]     float32, any strides       (softplus-ed, > 0)
//   a      [H]           float32, contiguous        (negative decay rate)
//   bm, cm [B, S, N]     float32, any strides, unit along N
//   init   [B, H, P, N]  float32, any strides, unit along N (or null: 0)
//   y      [B, S, H, P]  T, contiguous
//   fin    [B, H, P, N]  float32, contiguous        (state after S)
//
// Per chunk of Q positions, with cum the inclusive cumsum of dt * a:
//   y     = (C B^T o L o dt^T) x + exp(cum) o (C state^T),
//           L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   state = exp(cum_Q) state + (x o exp(cum_Q - cum) dt)^T B
// everything in float32, y rounded to T once at the end.
//
// What bounds it: operations.  Per chunk the products take 2 Q^2 N
// (C B^T, once: the heads share the single B/C group) and per head
// 2 Q^2 P (scores x) + 4 Q P N (state in and out) FLOP against
// (Q P + 2 Q N) input elements, tens of FLOP per byte, all of it
// float32 outside the tensor cores (67 TFLOP/s on an H100 SXM).  This
// kernel forms C B^T in every block (per head and slice of P), work
// the bound does not count.
//
// Design:
//   * the TPU grid (B, H, chunks) carries the [P, N] state in VMEM
//     scratch along its sequential chunk axis.  Hopper blocks run in no
//     order, so a loop inside one block walks the chunks in order and
//     keeps the state in shared memory.  One block per (batch, head,
//     slice of P): the state's rows are independent (row p reads only
//     x[:, p]), so P splits across blocks at the price of recomputing
//     C B^T in each; the wrapper splits P in two when that still fits
//     in one wave of blocks (a one-request prefill is 48 heads: 96
//     blocks instead of 48 on 132 SMs).
//   * the chunk is the kernel's own, Q = 64, not the Pallas 256: a
//     [256, 256] float32 score tile is 256 KB, more than the 227 KB a
//     block may have.  The recurrence is the same for any chunk length;
//     only the rounding differs.
//   * each chunk stages dt, B, C (f32) and x (as f32) in shared memory,
//     rows past S as zeros (dt = 0 there keeps the final state exact,
//     as the Pallas kernel's zeroed tail does; no padded copies).
//     Warp 0 scans dt * a with shuffles.  Then three register-tiled
//     float32 FMA passes: the masked scores (L only for i >= j, so
//     exp of a positive difference is never formed), y (the causal
//     half of the scores only), and the state update.  Row strides in
//     shared memory are padded by one word against bank conflicts.
//   * left for later: wgmma (TF32 or bf16 operands would break the
//     float32 contract of the reference), C B^T shared across the heads
//     of the single group, the chunk-parallel form (per-chunk states in
//     parallel, then a short scan) to fill more SMs, and cp.async
//     prefetch of the next chunk.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // positions per chunk
constexpr int kThreads = 256;
constexpr int kMaxN = 128;      // state size (4 columns of 32 per lane)
constexpr int kMaxPB = 64;      // state rows per block
constexpr int kLdq = kQ + 1;    // padded row stride of the score tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16(v);
}

size_t smem_floats(int N, int PB) {
  const int ldn = N + 1;
  return (size_t)2 * kQ * ldn        // B, C
         + (size_t)kQ * PB           // x
         + (size_t)kQ * kLdq         // scores
         + (size_t)PB * ldn          // state
         + 4 * (size_t)kQ + 1;       // dt, cum, w, exp(cum), exp(seg)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fin, int S, int H,
                int P, int N, int PB, long long sxb, long long sxs,
                long long sxh, long long sdb, long long sds, long long sdh,
                long long sbb, long long sbs, long long scb, long long scs,
                long long sib, long long sih, long long sip) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* Bs = smem;                       // [Q][ldn]
  float* Cs = Bs + kQ * ldn;              // [Q][ldn]
  float* Xs = Cs + kQ * ldn;              // [Q][PB]
  float* Ss = Xs + kQ * PB;               // [Q][kLdq]
  float* St = Ss + kQ * kLdq;             // [PB][ldn]
  float* dts = St + PB * ldn;             // [Q]
  float* cum = dts + kQ;                  // [Q]
  float* wv = cum + kQ;                   // [Q] exp(seg - cum) * dt
  float* ecum = wv + kQ;                  // [Q] exp(cum)
  float* eseg = ecum + kQ;                // [1] exp(seg)

  const int t = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int p0 = blockIdx.y * PB;
  const float ah = a[h];
  const T* xb = x + b * sxb + h * sxh + p0;
  const float* dtb = dt + b * sdb + h * sdh;
  const float* bb = bm + b * sbb;
  const float* cb = cm + b * scb;

  // the carried state: init_state's rows [p0, p0 + PB), or zeros
  for (int idx = t; idx < PB * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    St[p * ldn + n] = init ? init[b * sib + h * sih + (p0 + p) * sip + n]
                           : 0.f;
  }

  // thread tiles: passes 1 and 2 take 4 consecutive rows (i = 4 ti + r)
  // and columns tc + 16 c; pass 3 takes state rows warp + 8 m and
  // columns lane + 32 k
  const int ti = t >> 4, tc = t & 15;
  const int warp = t >> 5, lane = t & 31;
  const int n_pc = PB / 16, n_pm = PB / 8;

  for (int s0 = 0; s0 < S; s0 += kQ) {
    const int nv = min(kQ, S - s0);       // valid rows of this chunk
    for (int idx = t; idx < kQ * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      const bool ok = r < nv;
      Bs[r * ldn + n] = ok ? bb[(long long)(s0 + r) * sbs + n] : 0.f;
      Cs[r * ldn + n] = ok ? cb[(long long)(s0 + r) * scs + n] : 0.f;
    }
    for (int idx = t; idx < kQ * PB; idx += kThreads) {
      const int r = idx / PB, p = idx % PB;
      Xs[idx] = r < nv ? to_f(xb[(long long)(s0 + r) * sxs + p]) : 0.f;
    }
    if (t < kQ) dts[t] = t < nv ? dtb[(long long)(s0 + t) * sds] : 0.f;
    __syncthreads();

    // inclusive cumsum of dt * a: two positions per lane of warp 0
    if (warp == 0) {
      const float v0 = dts[2 * lane] * ah, v1 = dts[2 * lane + 1] * ah;
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
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = expf(c0);
      ecum[2 * lane + 1] = expf(c1);
      wv[2 * lane] = expf(seg - c0) * dts[2 * lane];
      wv[2 * lane + 1] = expf(seg - c1) * dts[2 * lane + 1];
      if (lane == 0) *eseg = expf(seg);
    }
    __syncthreads();

    // pass 1: scores[i][j] = (C_i . B_j) L[i][j] dt_j for i >= j, else 0
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(4 * ti + r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tc + 16 * c) * ldn + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += cv[r] * bv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tc + 16 * c;
          Ss[i * kLdq + j] =
              j <= i ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // pass 2: y = scores x (causal half) + exp(cum) (C state^T)
    {
      float acc[4][4] = {}, inter[4][4] = {};
      const int jend = min(4 * ti + 4, nv);
      for (int j = 0; j < jend; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = Ss[(4 * ti + r) * kLdq + j];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xv[c] = c < n_pc ? Xs[j * PB + tc + 16 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += sv[r] * xv[c];
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(4 * ti + r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sv[c] = c < n_pc ? St[(tc + 16 * c) * ldn + n] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] += cv[r] * sv[c];
      }
      T* yrow = y + ((long long)b * S + s0) * H * P + (long long)h * P + p0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        if (i >= nv) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= n_pc) continue;
          yrow[(long long)i * H * P + tc + 16 * c] =
              from_f<T>(acc[r][c] + inter[r][c] * ecum[i]);
        }
      }
    }
    __syncthreads();

    // pass 3: state = exp(seg) state + sum_j (x_j w_j) B_j
    {
      float acc[8][4] = {};
      for (int j = 0; j < nv; ++j) {
        const float wj = wv[j];
        float xw[8], bv[4];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          xw[m] = m < n_pm ? Xs[j * PB + warp + 8 * m] * wj : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = lane + 32 * k;
          bv[k] = n < N ? Bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[m][k] += xw[m] * bv[k];
      }
      const float es = *eseg;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (m >= n_pm) continue;
        const int p = warp + 8 * m;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = lane + 32 * k;
          if (n < N) St[p * ldn + n] = es * St[p * ldn + n] + acc[m][k];
        }
      }
    }
    __syncthreads();
  }

  float* fb = fin + ((long long)b * H + h) * P * N + (long long)p0 * N;
  for (int idx = t; idx < PB * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    fb[idx] = St[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* init, void* y, void* fin, int B,
           int S, int H, int P, int N, int p_split, const long long* st,
           cudaStream_t stream) {
  const int PB = P / p_split;
  const size_t smem = smem_floats(N, PB) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, p_split);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(fin), S, H, P, N, PB, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and y): 0 = float32, 1 = bfloat16.  Strides are in
// elements: x (batch, seq, head), dt (batch, seq, head), bm and cm
// (batch, seq), init (batch, head, row); init may be null.  p_split
// blocks share each (batch, head): P / p_split rows of the state each.
// Returns cudaGetLastError() after the launch (a refused launch never
// runs, and a later synchronize would not report it).  The caller
// checks shapes and dtypes; this entry refuses only what the kernel
// cannot do.
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* init, void* y, void* fin, int B, int S,
    int H, int P, int N, long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh, long long sbb,
    long long sbs, long long scb, long long scs, long long sib,
    long long sih, long long sip, int p_split, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxN || p_split <= 0 ||
      P % p_split != 0)
    return (int)cudaErrorInvalidValue;
  const int PB = P / p_split;
  if (PB % 16 != 0 || PB > kMaxPB) return (int)cudaErrorInvalidValue;
  const long long st[13] = {sxb, sxs, sxh, sdb, sds, sdh, sbb,
                            sbs, scb, scs, sib, sih, sip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, init, y, fin, B, S, H, P, N,
                         p_split, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, init, y, fin, B, S, H, P,
                                 N, p_split, st, s);
  return (int)cudaErrorInvalidValue;
}
