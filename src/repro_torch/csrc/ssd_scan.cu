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
//   y     = (C B^T o L o dt^T) x + exp(cum) o (C E^T),
//           L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   E'    = exp(cum_Q) E + (x o exp(cum_Q - cum) dt)^T B
// where E is the state entering the chunk and E' the one leaving it;
// everything in float32, y rounded to T once at the end.
//
// What bounds it: operations.  Per chunk the products take 2 Q^2 N
// (C B^T, once: the heads share the single B/C group) and per head
// 2 Q^2 P (scores x) + 4 Q P N (state in and out) FLOP against
// (Q P + 2 Q N) input elements, tens of FLOP per byte, all of it
// float32 FMA outside the tensor cores (67 TFLOP/s on an H100 SXM).
//
// Design: the chunk-parallel form in two launches (the hand-off form).
//   * prep, grid (chunks, B, 4): C B^T once per (batch, chunk), as
//     [j][i] (each block a quarter of the rows j), and C^T per chunk,
//     into scratch: 16 KB + 32 KB per chunk at N 128.  B and C come in
//     by rows, every load of a thread in flight at once.
//   * main, one block per (batch, chunk, head): at 2,048 tokens 32 x 48
//     blocks, two resident on each SM, where a walk over the chunks in
//     one block per head gave 48 (or 96) blocks on 132 SMs.  A block
//     loads its chunk (x, B, C^T, C B^T by cp.async, dt), scans dt * a
//     (one warp), forms the masked scores and the chunk's own state
//     (x o w)^T B and the intra-chunk output in registers, and only then
//     needs the state E entering its chunk.  That state is handed from
//     the block of the previous chunk through two slots per (batch,
//     head) in global memory (L2): each warp waits on its own progress
//     counter per (batch, head), reads its part of E, writes E' =
//     exp(seg) E + its own state to the other slot and raises the
//     counter by a release store (the same warp of the next chunk reads
//     exactly those elements, so no block-wide barrier sits on the
//     chain), then the block adds exp(cum) o (C E^T) to its output.
//     Only that read, update and write is serial along the chunks; the
//     rest runs on the whole card.
//     Blocks take their (chunk, batch, head) from an atomic ticket in
//     chunk-major order, so the block a waiter waits on has always
//     started (no deadlock whatever order the hardware launches blocks
//     in).  The ticket and the counters reset themselves (the last
//     ticket, the last chunk), so the scratch of kernels/_scratch.py is
//     zero between launches.
//   * the chunk is the kernel's own, Q = 64, not the Pallas 256 (the
//     recurrence is the same for any chunk length; only the rounding
//     differs): a block's tiles fit 107 KB of shared memory at N 128,
//     two blocks an SM.  Rows past S load as zeros (dt = 0 there keeps
//     the final state exact, as the Pallas kernel's zeroed tail does).
//   * arithmetic: float32 FMA from registers, 4 x 4 (or 4 x 8) register
//     tiles over float4 shared-memory reads laid out so a warp's reads
//     are broadcasts or 16 consecutive float4s.  Tensor cores would need
//     TF32 operands, which keep ~3 decimal digits: 3xTF32 is left for
//     later.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md,
//   cold L2): a 2,048-token mamba2 prefill layer 172 us, 2.4x its 73.2 us
//   bound (the walk in one block per head and half of P: 1,097).  The
//   hand-off hides under the blocks' own work: handing the states
//   through device memory instead (own states, a scan over them, the
//   outputs: four launches) lost at every shape, 225 against 172 us at
//   2,048 tokens, its two compute launches alone taking about what this
//   one takes (PERF.md); a lone block takes 17.5 us on one 32-row chunk.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int kQ = 64;          // positions per chunk
constexpr int kP = 64;          // state rows in shared memory (P <= 64)
constexpr int kThreads = 256;
constexpr int kMaxN = 128;      // state size: N padded to 64 * NK

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void fma4(float (&acc)[4], float s, float4 v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}
// acc[r][c] += u[r] * v[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 u,
                                       float4 v) {
  fma4(acc[0], u.x, v);
  fma4(acc[1], u.y, v);
  fma4(acc[2], u.z, v);
  fma4(acc[3], u.w, v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ----------------------------------------------------------- prep ---------
// grid (chunks, B, 4).  ct_g [B, chunks, NP, Q]: C^T (rows n >= N and
// columns past S zero); cbt_g [B, chunks, Q, Q]: (C B^T)^T, i.e. [j][i] =
// C_i . B_j; block z writes rows n in [z NP / 4, (z + 1) NP / 4) of C^T
// and rows j in [16 z, 16 z + 16) of (C B^T)^T.  B and C rows come in as
// rows (16 bytes a load when vec has bits 1 and 2, else 4), every load of
// a thread in flight before its stores; the odd row pitch makes the
// column reads that follow conflict-free.
template <int NK>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_prep(const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         float* __restrict__ cbt_g, float* __restrict__ ct_g,
                         int S, int N, int nc, int vec, i64 sbb, i64 sbs,
                         i64 scb, i64 scs) {
  constexpr int NP = 64 * NK;
  constexpr int LD = NP + 1;
  extern __shared__ __align__(16) float psm[];
  float* brow = psm;             // [Q][LD]
  float* crow = brow + kQ * LD;  // [Q][LD]
  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int t = threadIdx.x;
  const int s0 = c * kQ, nv = min(kQ, S - s0);
  const float* bb = bm + b * sbb + (i64)s0 * sbs;
  const float* cb = cm + b * scb + (i64)s0 * scs;
  if ((vec & 6) == 6) {
    constexpr int kPer = kQ * NP / 4 / kThreads;
    float4 vb[kPer], vc[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = t + u * kThreads;
      const int r = i / (NP / 4), n = 4 * (i % (NP / 4));
      const bool ok = r < nv && n < N;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      vb[u] = ok ? __ldg(reinterpret_cast<const float4*>(bb + (i64)r * sbs +
                                                         n))
                 : zero;
      vc[u] = ok ? __ldg(reinterpret_cast<const float4*>(cb + (i64)r * scs +
                                                         n))
                 : zero;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = t + u * kThreads;
      const int o = (i / (NP / 4)) * LD + 4 * (i % (NP / 4));
      const float* pb = &vb[u].x;
      const float* pc = &vc[u].x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        brow[o + k] = pb[k];
        crow[o + k] = pc[k];
      }
    }
  } else {
    constexpr int kPer = kQ * NP / kThreads;
#pragma unroll
    for (int u0 = 0; u0 < kPer; u0 += 8) {
      float vb[8], vc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = t + (u0 + u) * kThreads;
        const int r = i / NP, n = i % NP;
        const bool ok = r < nv && n < N;
        vb[u] = ok ? bb[(i64)r * sbs + n] : 0.f;
        vc[u] = ok ? cb[(i64)r * scs + n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = t + (u0 + u) * kThreads;
        brow[(i / NP) * LD + i % NP] = vb[u];
        crow[(i / NP) * LD + i % NP] = vc[u];
      }
    }
  }
  __syncthreads();
  const i64 chunk = (i64)b * nc + c;
  // this quarter's rows of C^T, i fastest (coalesced stores)
  float* ctd = ct_g + chunk * NP * kQ;
  for (int e = t; e < NP / 4 * kQ; e += kThreads) {
    const int n = z * (NP / 4) + e / kQ, i = e % kQ;
    ctd[n * kQ + i] = crow[i * LD + n];
  }
  // (C B^T)^T rows j = 16 z + t / 64 + 4 m, column i = t % 64
  const int i = t % kQ, j0 = 16 * z + t / kQ;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float cv = crow[i * LD + n];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      acc[m] = fmaf(brow[(j0 + 4 * m) * LD + n], cv, acc[m]);
  }
  float* cbd = cbt_g + chunk * kQ * kQ;
#pragma unroll
  for (int m = 0; m < 4; ++m) cbd[(j0 + 4 * m) * kQ + i] = acc[m];
}

// ----------------------------------------------------------- main ---------
template <int NK>
struct MainSmem {
  static constexpr int NP = 64 * NK;
  static constexpr int X = 0;                 // [Q][kP] x as float
  static constexpr int BW = X + kQ * kP;      // [Q][NP] B o w; then E^T [NP][kP]
  static constexpr int CT = BW + kQ * NP;     // [NP][Q] C^T
  static constexpr int ST = CT + NP * kQ;     // [Q][Q] (C B^T)^T, then scores^T
  static constexpr int XR = ST + kQ * kQ;     // [Q][kP] x as loaded (bfloat16)
  static constexpr int DT = XR + kQ * kP / 2; // [Q] dt, cum, w, exp(cum)
  static constexpr int MISC = DT + 4 * kQ;    // exp(seg), ticket
  static constexpr int FLOATS = MISC + 4;
};

// grid (B * H * chunks).  vec: bit 0, x rows take 16-byte copies; bit 1,
// B rows do; bit 2, C rows do.  sync: [0] the ticket, [1 + (b * H + h) * 8 + warp] the
// chunks whose leaving state that warp has published.  slots [B * H][2]
// [NP][kP].
template <typename T, int NK>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    const float* __restrict__ init,
                    const float* __restrict__ cbt_g,
                    const float* __restrict__ ct_g, float* slots, int* sync,
                    T* __restrict__ y, float* __restrict__ fin, int S, int H,
                    int P, int N, int nc, int vec, i64 sxb, i64 sxs, i64 sxh,
                    i64 sdb, i64 sds, i64 sdh, i64 sbb, i64 sbs, i64 sib,
                    i64 sih, i64 sip) {
  typedef MainSmem<NK> L;
  constexpr int NP = L::NP;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + L::X;
  float* bw = smem + L::BW;
  float* et = bw;
  float* ct = smem + L::CT;
  float* st = smem + L::ST;
  T* xr = reinterpret_cast<T*>(smem + L::XR);
  float* dts = smem + L::DT;
  float* cum = dts + kQ;
  float* wv = cum + kQ;
  float* ecum = wv + kQ;
  float* misc = smem + L::MISC;
  int* tk = reinterpret_cast<int*>(misc + 1);

  const int t = threadIdx.x;
  const int BH = gridDim.x / nc;
  if (t == 0) {
    const int v = atomicAdd(sync, 1);
    if (v == (int)gridDim.x - 1) *sync = 0;  // every ticket is taken
    *tk = v;
  }
  __syncthreads();
  const int ticket = *tk;
  const int c = ticket / BH, bh = ticket % BH;
  const int b = bh / H, h = bh % H;
  const int s0 = c * kQ, nv = min(kQ, S - s0);

  // ---- the chunk's inputs
  const float* dtb = dt + b * sdb + h * sdh + (i64)s0 * sds;
  if (t < kQ) dts[t] = t < nv ? dtb[(i64)t * sds] : 0.f;
  const i64 chunk = (i64)b * nc + c;
  const float* cbg = cbt_g + chunk * kQ * kQ;
  const float* ctg = ct_g + chunk * NP * kQ;
  for (int i = t; i < kQ * kQ / 4; i += kThreads)
    cp16(st + 4 * i, cbg + 4 * i, true);
  for (int i = t; i < NP * kQ / 4; i += kThreads)
    cp16(ct + 4 * i, ctg + 4 * i, true);
  const float* bb = bm + b * sbb + (i64)s0 * sbs;
  if (vec & 2) {
    for (int i = t; i < kQ * NP / 4; i += kThreads) {
      const int r = i / (NP / 4), n = 4 * (i % (NP / 4));
      const bool ok = r < nv && n < N;
      cp16(bw + r * NP + n, ok ? bb + (i64)r * sbs + n : bb, ok);
    }
  } else {
    for (int i = t; i < kQ * NP; i += kThreads) {
      const int r = i / NP, n = i % NP;
      bw[i] = r < nv && n < N ? bb[(i64)r * sbs + n] : 0.f;
    }
  }
  const T* xb = x + b * sxb + h * sxh + (i64)s0 * sxs;
  constexpr int V = 16 / sizeof(T);  // elements per 16 bytes
  if (vec & 1) {
    T* dst = sizeof(T) == 4 ? reinterpret_cast<T*>(xs) : xr;
    for (int i = t; i < kQ * kP / V; i += kThreads) {
      const int r = i / (kP / V), p = V * (i % (kP / V));
      const bool ok = r < nv && p < P;
      cp16(dst + r * kP + p, ok ? xb + (i64)r * sxs + p : xb, ok);
    }
  } else {
    for (int i = t; i < kQ * kP; i += kThreads) {
      const int r = i / kP, p = i % kP;
      xs[i] = r < nv && p < P ? to_f(xb[(i64)r * sxs + p]) : 0.f;
    }
  }
  cp_wait_all();
  __syncthreads();

  // ---- inclusive cumsum of dt * a, two positions per lane of warp 0
  if (t < 32) {
    const int lane = t;
    const float ah = a[h];
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
    if (lane == 0) misc[0] = expf(seg);
  }
  __syncthreads();

  // ---- B o w, the masked scores (transposed), x as float
  for (int i = t; i < kQ * NP / 4; i += kThreads) {
    float4* p = reinterpret_cast<float4*>(bw) + i;
    const float w = wv[i / (NP / 4)];
    float4 v = *p;
    v.x *= w;
    v.y *= w;
    v.z *= w;
    v.w *= w;
    *p = v;
  }
  for (int e = t; e < kQ * kQ; e += kThreads) {
    const int j = e / kQ, i = e % kQ;
    st[e] = j <= i ? st[e] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
  }
  if (sizeof(T) != 4 && (vec & 1))
    for (int i = t; i < kQ * kP; i += kThreads) xs[i] = to_f(xr[i]);
  __syncthreads();

  // thread tiles: p = 4 pg ... + 3; the chunk's own state takes n = 4 rg
  // + cn + 64 k, the outputs rows i = 4 rg ... + 3
  const int pg = t & 15, rg = t >> 4;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);

  // ---- the chunk's own state: own[k][cn][cp] = sum_j B_j[n] w_j x_j[p]
  float own[NK][4][4] = {};
#pragma unroll 4
  for (int j = 0; j < nv; ++j) {
    const float4 xv = xs4[j * (kP / 4) + pg];
#pragma unroll
    for (int k = 0; k < NK; ++k)
      outer4(own[k], *reinterpret_cast<const float4*>(bw + j * NP + 64 * k +
                                                      4 * rg),
             xv);
  }
  // ---- intra-chunk output: yi[ci][cp] = sum_{j <= i} S[i][j] x_j[p]
  float yi[4][4] = {};
  const int jmax = min(4 * rg + 4, nv);
#pragma unroll 4
  for (int j = 0; j < jmax; ++j)
    outer4(yi, *reinterpret_cast<const float4*>(st + j * kQ + 4 * rg),
           xs4[j * (kP / 4) + pg]);
  __syncthreads();  // B o w read: its space takes E^T

  // ---- the entering state E, then the leaving one
  // each warp hands its own elements (rows n of rg = 2 warp, 2 warp + 1)
  // to the same warp of the next chunk's block, through its own flag
  const int lane = t & 31;
  int* flag = sync + 1 + bh * (kThreads / 32) + (t >> 5);
  const i64 slot = (i64)NP * kP;
  float4 e[NK][4];
  float* mine = slots + (i64)bh * 2 * slot;
  if (c == 0) {
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int cn = 0; cn < 4; ++cn) {
        const int n = 64 * k + 4 * rg + cn;
        float v[4];
#pragma unroll
        for (int cp = 0; cp < 4; ++cp) {
          const int p = 4 * pg + cp;
          v[cp] = init && n < N && p < P
                      ? init[b * sib + h * sih + p * sip + n]
                      : 0.f;
        }
        e[k][cn] = make_float4(v[0], v[1], v[2], v[3]);
      }
  } else {
    // the same warp of the previous chunk's block has started (ticket
    // order) and needs microseconds; a wait of seconds is a fault,
    // trapped, not a hang
    if (lane == 0)
      for (long long spins = 0; ld_acquire(flag) < c; ++spins)
        if (spins > (1LL << 24)) __trap();
    __syncwarp();
    const float* src = mine + ((c - 1) & 1) * slot;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int cn = 0; cn < 4; ++cn)
        e[k][cn] = __ldcg(reinterpret_cast<const float4*>(
            src + (64 * k + 4 * rg + cn) * kP + 4 * pg));
  }
  const float es = misc[0];
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int cn = 0; cn < 4; ++cn) {
      own[k][cn][0] = fmaf(es, e[k][cn].x, own[k][cn][0]);
      own[k][cn][1] = fmaf(es, e[k][cn].y, own[k][cn][1]);
      own[k][cn][2] = fmaf(es, e[k][cn].z, own[k][cn][2]);
      own[k][cn][3] = fmaf(es, e[k][cn].w, own[k][cn][3]);
    }
  if (c + 1 < nc) {
    float* dst = mine + (c & 1) * slot;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int cn = 0; cn < 4; ++cn)
        __stcg(reinterpret_cast<float4*>(dst + (64 * k + 4 * rg + cn) * kP +
                                         4 * pg),
               make_float4(own[k][cn][0], own[k][cn][1], own[k][cn][2],
                           own[k][cn][3]));
    // the warp barrier orders every lane's stores before lane 0's
    // release (the pattern of CUTLASS's semaphore)
    __syncwarp();
    if (lane == 0) st_release(flag, c + 1);
  } else {
    float* fb = fin + (i64)bh * P * N;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int cn = 0; cn < 4; ++cn) {
        const int n = 64 * k + 4 * rg + cn;
#pragma unroll
        for (int cp = 0; cp < 4; ++cp) {
          const int p = 4 * pg + cp;
          if (n < N && p < P) fb[p * N + n] = own[k][cn][cp];
        }
      }
    if (lane == 0) *flag = 0;  // ready for the next launch
  }
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int cn = 0; cn < 4; ++cn)
      *reinterpret_cast<float4*>(et + (64 * k + 4 * rg + cn) * kP + 4 * pg) =
          e[k][cn];
  __syncthreads();

  // ---- y = yi + exp(cum_i) sum_n C_i[n] E[p][n]
  float yo[4][4] = {};
  const int nlim = (N + 3) & ~3;  // rows n >= N are zero in both
#pragma unroll 4
  for (int n = 0; n < nlim; ++n)
    outer4(yo, *reinterpret_cast<const float4*>(ct + n * kQ + 4 * rg),
           *reinterpret_cast<const float4*>(et + n * kP + 4 * pg));
  if (4 * pg >= P) return;
  T* yb = y + ((i64)b * S + s0) * H * P + (i64)h * P + 4 * pg;
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    const int i = 4 * rg + ci;
    if (i >= nv) break;
    float v[4];
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) v[cp] = fmaf(ecum[i], yo[ci][cp], yi[ci][cp]);
    store4(yb + (i64)i * H * P, v);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int NK>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* init, void* y, void* fin, void* ws,
           void* sync, int B, int S, int H, int P, int N, int vec,
           const i64* st, cudaStream_t stream) {
  constexpr int NP = 64 * NK;
  const int nc = (S + kQ - 1) / kQ;
  float* cbt = static_cast<float*>(ws);
  float* ctg = cbt + (i64)B * nc * kQ * kQ;
  float* slots = ctg + (i64)B * nc * NP * kQ;
  if ((i64)B * H * nc > 0x7fffffff) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  const int prep_smem = 2 * kQ * (NP + 1) * sizeof(float);
  const int main_smem = MainSmem<NK>::FLOATS * sizeof(float);
  if (!opted_in) {
    cudaError_t e = opt_in(ssd_scan_kernel_prep<NK>, prep_smem);
    if (e == cudaSuccess) e = opt_in(ssd_scan_kernel<T, NK>, main_smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  ssd_scan_kernel_prep<NK><<<dim3(nc, B, 4), kThreads, prep_smem, stream>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm), cbt, ctg,
      S, N, nc, vec, st[6], st[7], st[8], st[9]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<T, NK><<<B * H * nc, kThreads, main_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(init), cbt, ctg, slots,
      static_cast<int*>(sync), static_cast<T*>(y), static_cast<float*>(fin),
      S, H, P, N, nc, vec, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[10], st[11], st[12]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and y): 0 = float32, 1 = bfloat16.  Strides are in
// elements: x (batch, seq, head), dt (batch, seq, head), bm and cm
// (batch, seq), init (batch, head, row); init may be null.  vec: bit 0
// when x's base and strides allow 16-byte copies, bit 1 when B's do, bit 2
// when C's do (and N is a multiple of 4).  ws: the floats of
// kernels/ssd_scan.py::scratch_sizes (C B^T and C^T of every chunk, then
// two state slots per (batch, head)); sync: 1 + 8 B H int32, zero before
// the first call (each call leaves them zero).  Two launches (prep, main) on `stream`; returns
// cudaGetLastError() after them (a refused launch never runs, and a later
// synchronize would not report it).  The caller checks shapes and
// dtypes; this entry refuses only what the kernel cannot do.
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* init, void* y, void* fin, void* ws,
    void* sync, int B, int S, int H, int P, int N, long long sxb,
    long long sxs, long long sxh, long long sdb, long long sds,
    long long sdh, long long sbb, long long sbs, long long scb,
    long long scs, long long sib, long long sih, long long sip, int vec,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxN || P <= 0 ||
      P > kP || P % 16 != 0 || ws == nullptr || sync == nullptr)
    return (int)cudaErrorInvalidValue;
  const i64 st[13] = {sxb, sxs, sxh, sdb, sds, sdh, sbb,
                      sbs, scb, scs, sib, sih, sip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N > 64;
  if (dtype == 0)
    return wide ? launch<float, 2>(x, dt, a, bm, cm, init, y, fin, ws, sync,
                                   B, S, H, P, N, vec, st, s)
                : launch<float, 1>(x, dt, a, bm, cm, init, y, fin, ws, sync,
                                   B, S, H, P, N, vec, st, s);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 2>(x, dt, a, bm, cm, init, y, fin, ws,
                                           sync, B, S, H, P, N, vec, st, s)
                : launch<__nv_bfloat16, 1>(x, dt, a, bm, cm, init, y, fin, ws,
                                           sync, B, S, H, P, N, vec, st, s);
  return (int)cudaErrorInvalidValue;
}
