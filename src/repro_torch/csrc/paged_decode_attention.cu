// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over its KV cache, gathered from a global block pool
// through a per-sequence block table.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// ::paged_decode_attention (its pallas_call at :215, kernel body
// _paged_kernel at :125).
//
//   q        [B, H, D]                     T (float or bfloat16)
//   k_pool   [n_blocks, bs, Hkv, D]        T
//   v_pool   [n_blocks, bs, Hkv, D]        T
//   tables   [B, NB] int32, row stride `table_stride` elements
//   kv_len   [B] int32
//   out      [B, H, D]                     T
//
// Query head h reads KV head h / G (G = H / Hkv).  Table entries past a
// sequence's live blocks point at scratch block 0 and are never read:
// only logical rows below kv_len are gathered.  l is clamped at 1e-30,
// so a sequence with kv_len == 0 gets zeros.
//
// What bounds it: nothing but memory.  Each live K/V row is read once
// (sum_b kv_len_b * Hkv * D * 2 * sizeof(T) bytes per call) for ~2 FLOP
// per K/V element read, far below the card's ~295 FLOP/byte bf16 ridge.
//
// Design:
//   * grid (B, Hkv): the TPU grid (B, NB) carries the online-softmax
//     state across grid steps in VMEM; Hopper blocks run in no order, so
//     the walk over a sequence's cache is a loop inside one thread
//     block, and each (sequence, KV head) is one block.  At the serving
//     shape (B=8, Hkv=16) that is 128 blocks for 132 SMs.
//   * the walk goes over LOGICAL rows, `rows` at a time (at most 128,
//     fewer when the tile would not fit 160 KB of shared memory): each
//     row finds its pool block through the table, so a sub-tile may
//     span several small pool blocks or cover part of a large one, and
//     shared memory is bounded whatever the block size is.  The K and
//     V rows are staged in shared memory as float, with 16-byte loads
//     (D * sizeof(T) a multiple of 16 and pools 16-byte aligned).
//   * the block is latency-bound: one (sequence, KV head) per block
//     leaves one or two blocks per SM, so each sub-tile's chain of
//     gather, scores, softmax and PV is paid in full.  Large sub-tiles
//     and >= 512 threads cut the number and length of those chains
//     (on an NVIDIA H100 80GB HBM3 at 700 W, 64-row tiles and 128
//     threads took 3.4x the time at 1k context, see PERF.md).
//   * scores: kLanes lanes per (head, row) pair, D split over them and
//     summed with shuffles.  Softmax: one warp per head updates the
//     running max m and sum l (kept in shared memory, f32) and turns the
//     scores into probabilities.  PV: thread (split, g, d) sums every
//     `splits`-th row into its own f32 accumulator; the splits keep
//     small heads at >= 512 threads and are added up at the end.
//   * the probabilities stay in f32 for the PV product; the TPU kernel
//     rounds them to v.dtype first.  For bf16 pools that is the only
//     numerical difference, well inside bf16 tolerance.
// Split-KV, cp.async/TMA pipelining and one block for all heads of a
// sequence are left for later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// shared memory a block may take; above 48 KB the launch opts in
constexpr int kMaxSmemBytes = 160 * 1024;
constexpr int kMaxRows = 128;             // logical rows per sub-tile
constexpr int kMinThreads = 512;
constexpr int kLanes = 4;                 // lanes per (head, row) score
// K rows are padded by kLanes floats, so the 32 / kLanes rows one warp
// scores at a time start on distinct banks (and rows stay 16-byte
// aligned for the vector stores)
constexpr int kPad = kLanes;
static_assert(32 % kLanes == 0 && kPad % 4 == 0, "kLanes: 4, 8, 16 or 32");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from global memory, widened to float in shared memory
// (both pointers 16-byte aligned)
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) =
        __ldg(reinterpret_cast<const float4*>(src));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// at most 1024 threads: caps registers at 64 so every launch fits
template <typename T>
__global__ void __launch_bounds__(1024)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int H, int Hkv, int D, int bs, int NB,
                        int table_stride, int rows, int splits,
                        float scale) {
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int G = H / Hkv;
  const int GD = G * D;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // a multiple of 32
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [G][D]
  const int kp = D + kPad;             // K row pitch
  float* k_s = q_s + GD;               // [rows][kp]
  float* v_s = k_s + rows * kp;        // [rows][D]
  float* p_s = v_s + rows * D;         // [G][rows] scores -> probabilities
  float* m_s = p_s + G * rows;         // [G] running max
  float* l_s = m_s + G;                // [G] running sum
  float* c_s = l_s + G;                // [G] this sub-tile's rescale
  float* red_s = c_s + G;              // [splits - 1][G][D]

  // the G query heads that share KV head hk are contiguous in q
  const T* qh = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < GD; i += nthreads) q_s[i] = to_float(qh[i]);
  for (int i = tid; i < G; i += nthreads) {
    m_s[i] = -CUDART_INF_F;
    l_s[i] = 0.f;
  }

  int len = kv_len[b];
  if (len > NB * bs) len = NB * bs;
  const int* row = tables + (size_t)b * table_stride;
  const size_t row_stride = (size_t)Hkv * D;  // between pool rows
  const T* kh = k_pool + (size_t)hk * D;
  const T* vh = v_pool + (size_t)hk * D;

  const bool owner = tid < splits * GD;
  const int split = tid / GD, gd = tid % GD;
  const int g = gd / D, d = gd % D;
  float acc = 0.f;
  __syncthreads();  // q_s, m_s, l_s written

  for (int t0 = 0; t0 < len; t0 += rows) {
    const int n = min(rows, len - t0);  // live rows of this sub-tile
    // gather the n logical rows through the table, 16 bytes a load
    constexpr int V = Vec16<T>::n;
    const int vpr = D / V;
#pragma unroll 4
    for (int i = tid; i < n * vpr; i += nthreads) {
      const int r = i / vpr, c = (i - r * vpr) * V;
      const int pos = t0 + r;
      const size_t off =
          ((size_t)row[pos / bs] * bs + pos % bs) * row_stride + c;
      Vec16<T>::load(kh + off, k_s + r * kp + c);
      Vec16<T>::load(vh + off, v_s + r * D + c);
    }
    __syncthreads();
    // scores: kLanes lanes per (head, row) pair, D split over them and
    // summed with shuffles; the loop is uniform over each warp
    constexpr int per_warp = 32 / kLanes;
    for (int p0 = warp * per_warp; p0 < G * n; p0 += nwarps * per_warp) {
      const int p = p0 + lane / kLanes, gl = lane % kLanes;
      const bool live = p < G * n;
      const int gg = live ? p / n : 0, r = live ? p - gg * n : 0;
      const float* qg = q_s + gg * D;
      const float* kr = k_s + r * kp;
      float dot = 0.f;
      if (live)
        for (int c = gl; c < D; c += kLanes) dot = fmaf(qg[c], kr[c], dot);
      for (int o = kLanes / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (live && gl == 0) p_s[gg * rows + r] = dot * scale;
    }
    __syncthreads();
    // online softmax: one warp per head.  n >= 1, so m_new is finite and
    // exp(-inf - m_new) = 0 is the first sub-tile's rescale.
    for (int gg = warp; gg < G; gg += nwarps) {
      float* sg = p_s + gg * rows;
      float mx = -CUDART_INF_F;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_old = m_s[gg];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(sg[r] - m_new);
        sg[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);  // every lane has read m_s[gg] by now
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[gg] = corr;
        l_s[gg] = l_s[gg] * corr + sum;
        m_s[gg] = m_new;
      }
    }
    __syncthreads();
    if (owner) {
      const float* pg = p_s + g * rows;
      float pv = 0.f;
      for (int r = split; r < n; r += splits)
        pv = fmaf(pg[r], v_s[r * D + d], pv);
      acc = fmaf(acc, c_s[g], pv);
    }
    __syncthreads();  // sub-tile consumed before the next gather
  }
  if (splits > 1) {
    if (owner && split > 0) red_s[(split - 1) * GD + gd] = acc;
    __syncthreads();
    if (owner && split == 0)
      for (int s = 1; s < splits; ++s) acc += red_s[(s - 1) * GD + gd];
  }
  if (owner && split == 0) {
    const float o = acc / fmaxf(l_s[g], 1e-30f);
    out[((size_t)b * H + (size_t)hk * G + g) * D + d] = from_float<T>(o);
  }
}

size_t smem_bytes(int G, int D, int rows, int splits) {
  return sizeof(float) *
         ((size_t)G * D + (size_t)rows * (2 * D + kPad) + (size_t)G * rows +
          3 * (size_t)G + (size_t)(splits - 1) * G * D);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_len, void* out, int B, int H,
           int Hkv, int D, int bs, int NB, int table_stride, float scale,
           cudaStream_t stream) {
  const int G = H / Hkv;
  const int GD = G * D;
  const int splits = GD >= kMinThreads ? 1 : kMinThreads / GD;
  const int threads = (splits * GD + 31) / 32 * 32;
  int rows = kMaxRows;
  while (rows > 1 && smem_bytes(G, D, rows, splits) > kMaxSmemBytes)
    rows /= 2;
  const size_t smem = smem_bytes(G, D, rows, splits);
  if (threads > 1024 || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads: the wrapper checks both, this only refuses
  if (D % Vec16<T>::n != 0 || (uintptr_t)k_pool % 16 != 0 ||
      (uintptr_t)v_pool % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), static_cast<T*>(out), H, Hkv, D, bs,
      NB, table_stride, rows, splits, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (a refused launch never runs, and a later synchronize
// would not report it).  The caller checks shapes; this entry checks
// only what would make the launch itself invalid.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* kv_len, void* out, int B, int H,
    int Hkv, int D, int bs, int NB, int table_stride, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || bs <= 0 || NB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, kv_len, out, B, H, Hkv,
                         D, bs, NB, table_stride, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, kv_len, out, B,
                                 H, Hkv, D, bs, NB, table_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}
