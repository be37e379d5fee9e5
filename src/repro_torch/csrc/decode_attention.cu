// Decode attention over contiguous head-major caches for Hopper
// (sm_90a): one query token per sequence attends over its K/V, with the
// cache axis split across thread blocks whose partial softmaxes are then
// combined.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// ::decode_attention (its pallas_call at :101, kernel body _kernel at
// :42).
//
//   q         [B, H, D]            T (float or bfloat16), strides (qsb, qsh, 1)
//   k, v      [B, Hkv, S, D]       T, strides (sb, sh, ss, 1) each
//   kv_len    [B] int32
//   out       [B, H, D]            T, contiguous
//   part_acc  [B, H, splits, D]    float, the splits' unnormalised outputs
//   part_ml   [B, H, splits, 2]    float, the splits' (m, l)
//   tickets   [B, Hkv] int32       bfloat16 only: zero between launches
//
// It computes what the Pallas kernel computes: the G = H / Hkv query
// heads of KV head hk share every K/V row read; scores are masked at
// kv_len; the online softmax keeps m, l and acc in float32; l is
// clamped at 1e-30, so a sequence with kv_len == 0 gets zeros; the
// output is in q's dtype.  The cache axis is not zero-padded up to a
// tile multiple as on the TPU: the loop bound masks the tail (the VLM's
// 1,601 vision tokens are prime).  Any stride with a unit last axis is
// taken, so the model passes k.transpose(1, 2) of its [B, T, Hkv, D]
// projection without a copy.
//
// What bounds it: nothing but memory.  Each live K/V row is read once
// (sum_b kv_len_b * Hkv * D * 2 * sizeof(T) bytes per call) for ~2 FLOP
// per K/V element read, far below the card's ~295 FLOP/byte bf16 ridge:
// 52.5 MB and 15.7 us at the VLM's cross-attention (B 8, H 64 / Hkv 8,
// D 128, T 1,601) in bf16.
//
// Design, bfloat16 (the serving dtype; D 64 or 128, G <= 8):
//   * K and V stay bf16 in shared memory.  A producer warp issues TMA
//     loads of 64-row tiles (4-D tensor maps over (D, S, Hkv, B) with
//     the caches' byte strides, 128-byte swizzle, a D = 128 row as two
//     64-column regions) into a ring of three stages tracked by full and
//     empty mbarriers: 96 KB a block at D 128 (two blocks fit an SM).
//   * tensor cores for both products.  Four consumer warps take 16 rows
//     of each tile: S^T = K q^T on mma.sync m16n8k16 with the K rows as
//     M and the G query heads as N (padded to 8; q^T's fragments stay in
//     registers for the whole walk), the online softmax in f32 on the
//     [rows, G] scores (log2 units), then O^T += V^T P^T with D as M, the
//     heads as N and the rows as K, P^T taken from the scores'
//     accumulator by movmatrix.  p is rounded to bf16 for PV, as the
//     Pallas kernel rounds p to the cache dtype (l sums the unrounded p,
//     as there); the earlier CUDA-core kernel kept p in f32.  Each warp
//     keeps its own (m, l, O) and the four merge in shared memory at the
//     end.  V rows past the split's end in its last tile are zeroed in
//     shared memory, so rows the walk must not read add 0, never NaN.
//   * splits (kernels/decode_attention.py::split_plan_bf16): whole 64-row
//     tiles, as many as keep the blocks within half the SMs; the last
//     block of each (sequence, KV head) to finish, found by a ticket
//     counter that it resets, sums the splits' partials in split order
//     (deterministic, one launch), the loads of eight splits in flight at
//     a time.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md,
//   cold L2): the cross shape takes 33.2 us (the earlier kernel, f32
//   staging through registers, CUDA-core FMAs and a combine launch: 80.2;
//   SDPA 46.3; bound 15.7), 1.58 TB/s of the bound's bytes, where a torch
//   sum over 128 MB holds 2.12 in the same timing.  More splits did not
//   raise the rate, they only added the combine (chip_smoke.py splits: 1
//   split 32.7 us, 2 36.3, 4 36.5, 26 63.9; a contiguous copy of K/V the
//   same as the transposed view), and deeper rings tried in bring-up
//   builds were no faster.
//
// Design, float32 (the reduced reference configs), unchanged since it was
// written: grid (splits, Hkv, B) of 256 threads, 32-row tiles staged in
// shared memory as float (each thread loads its share of the next tile
// into registers before the math on this one); scores by one thread per
// (row, head) pair from float4 reads; one warp per head updates m and l;
// PV by one thread per (4 heads, channel) column; p stays f32; a combine
// kernel per (sequence, query head) sums the splits
// (kernels/decode_attention.py::split_plan: about eight blocks per SM).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "decode_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;             // K/V rows staged per tile
constexpr int kPasses = 2;                // PV columns a thread keeps
constexpr int kMaxSmemBytes = 96 * 1024;  // at least two blocks per SM
// q and K rows are padded by 4 floats, so the rows one warp reads at a
// time as float4 start on distinct banks
constexpr int kPad = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
// 16 bytes of T: loaded from global memory into a register, then widened
// to float in shared memory (both pointers 16-byte aligned).  A thread
// keeps at most `in_flight` of them (a 32-row tile at D 128).
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  static constexpr int in_flight = 8;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* src) {
    return __ldg(reinterpret_cast<const float4*>(src));
  }
  __device__ __forceinline__ static void widen(const Raw& raw, float* dst) {
    *reinterpret_cast<float4*>(dst) = raw;
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

// The tile a thread loads: vectors tid, tid + kThreads, ... of the n rows'
// K vectors followed by their V vectors.  `fetch` leaves them in
// registers (in flight while the previous tile is consumed), `stage`
// widens them into shared memory.
template <typename T> struct TileLoader {
  using VT = Vec16<T>;
  typename VT::Raw buf[VT::in_flight];
  const T* kh;
  const T* vh;
  long long kss, vss;
  int vpr;  // vectors per row

  __device__ __forceinline__ void fetch(int t0, int n, int tid) {
#pragma unroll
    for (int j = 0; j < VT::in_flight; ++j) {
      const int i = tid + j * kThreads;
      if (i < 2 * n * vpr) {
        const bool is_v = i >= n * vpr;
        const int e = is_v ? i - n * vpr : i;
        const int r = e / vpr, c = (e - r * vpr) * VT::n;
        const size_t row = (size_t)(t0 + r);
        buf[j] = is_v ? VT::load(vh + row * vss + c)
                      : VT::load(kh + row * kss + c);
      }
    }
  }
  __device__ __forceinline__ void stage(int n, int tid, float* k_s, int kp,
                                        float* v_s, int D) {
#pragma unroll
    for (int j = 0; j < VT::in_flight; ++j) {
      const int i = tid + j * kThreads;
      if (i < 2 * n * vpr) {
        const bool is_v = i >= n * vpr;
        const int e = is_v ? i - n * vpr : i;
        const int r = e / vpr, c = (e - r * vpr) * VT::n;
        VT::widen(buf[j], is_v ? v_s + r * D + c : k_s + r * kp + c);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const int* __restrict__ kv_len,
                             T* __restrict__ out, float* __restrict__ part_acc,
                             float* __restrict__ part_ml, int H, int Hkv,
                             int D, int S, long long qsb, long long qsh,
                             long long ksb, long long ksh, long long kss,
                             long long vsb, long long vsh, long long vss,
                             int splits, int chunk, int rows, float scale) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int Gp = (G + 3) / 4 * 4;      // heads padded to float4 groups
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  const int kp = D + kPad;             // q and K row pitch
  float* q_s = smem;                   // [G][kp]
  float* k_s = q_s + G * kp;           // [rows][kp]
  float* v_s = k_s + rows * kp;        // [rows][D]
  float* p_s = v_s + rows * D;         // [rows][Gp] scores -> probabilities
  float* m_s = p_s + rows * Gp;        // [Gp] running max
  float* l_s = m_s + Gp;               // [Gp] running sum
  float* c_s = l_s + Gp;               // [Gp] this tile's rescale

  // the G query heads that share KV head hk
  const T* qh = q + (size_t)b * qsb + (size_t)hk * G * qsh;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    q_s[g * kp + d] = to_float(qh[(size_t)g * qsh + d]);
  }
  for (int i = tid; i < Gp; i += kThreads) {
    m_s[i] = -CUDART_INF_F;
    l_s[i] = 0.f;
    c_s[i] = 0.f;
  }
  // padded heads keep probability 0 (only g < G is ever written)
  for (int i = tid; i < rows * Gp; i += kThreads) p_s[i] = 0.f;

  const int len = min(kv_len[b], S);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);
  TileLoader<T> tiles;
  tiles.kh = k + (size_t)b * ksb + (size_t)hk * ksh;
  tiles.vh = v + (size_t)b * vsb + (size_t)hk * vsh;
  tiles.kss = kss;
  tiles.vss = vss;
  tiles.vpr = D / Vec16<T>::n;

  const int ncols = Gp / 4 * D;        // PV columns: (4 heads, channel)
  float acc[kPasses][4];
#pragma unroll
  for (int j = 0; j < kPasses; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (lo < hi) tiles.fetch(lo, min(rows, hi - lo), tid);
  for (int t0 = lo; t0 < hi; t0 += rows) {
    const int n = min(rows, hi - t0);  // live rows of this tile
    tiles.stage(n, tid, k_s, kp, v_s, D);
    __syncthreads();                   // tile (and q_s, m_s, ...) written
    const int t1 = t0 + rows;
    if (t1 < hi) tiles.fetch(t1, min(rows, hi - t1), tid);
    // scores: one thread per (row, head) pair, the whole dot product
    // from float4 reads; the heads of a row sit in neighbouring lanes,
    // so each K read is a broadcast
    for (int pr = tid; pr < n * G; pr += kThreads) {
      const int r = pr / G, g = pr - r * G;
      const float4* qg = reinterpret_cast<const float4*>(q_s + g * kp);
      const float4* kr = reinterpret_cast<const float4*>(k_s + r * kp);
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < D / 4; ++c) {
        const float4 a = qg[c], e = kr[c];
        dot = fmaf(a.x, e.x, dot);
        dot = fmaf(a.y, e.y, dot);
        dot = fmaf(a.z, e.z, dot);
        dot = fmaf(a.w, e.w, dot);
      }
      p_s[r * Gp + g] = dot * scale;
    }
    __syncthreads();
    // online softmax: one warp per head.  n >= 1, so m_new is finite and
    // exp(-inf - m_new) = 0 is the first tile's rescale.
    for (int gg = warp; gg < G; gg += kWarps) {
      float mx = -CUDART_INF_F;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, p_s[r * Gp + gg]);
      mx = warp_max(mx);
      const float m_old = m_s[gg];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(p_s[r * Gp + gg] - m_new);
        p_s[r * Gp + gg] = e;
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
    // PV: thread column (4 heads, channel d); per row one V read and one
    // float4 broadcast of the 4 heads' probabilities
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int col = tid + j * kThreads;
      if (col < ncols) {
        const int g4 = col / D * 4, d = col - col / D * D;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int r = 0; r < n; ++r) {
          const float x = v_s[r * D + d];
          const float4 pr = *reinterpret_cast<const float4*>(p_s + r * Gp + g4);
          a0 = fmaf(pr.x, x, a0);
          a1 = fmaf(pr.y, x, a1);
          a2 = fmaf(pr.z, x, a2);
          a3 = fmaf(pr.w, x, a3);
        }
        acc[j][0] = fmaf(acc[j][0], c_s[g4], a0);
        acc[j][1] = fmaf(acc[j][1], c_s[g4 + 1], a1);
        acc[j][2] = fmaf(acc[j][2], c_s[g4 + 2], a2);
        acc[j][3] = fmaf(acc[j][3], c_s[g4 + 3], a3);
      }
    }
    __syncthreads();  // tile consumed before the next one is staged
  }
  __syncthreads();    // l_s final even when this split had no rows

  // (b, query head hk * G + g) is row bh0 + g of out and of the partials
  const size_t bh0 = (size_t)b * H + (size_t)hk * G;
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int col = tid + j * kThreads;
    if (col < ncols) {
      const int g4 = col / D * 4, d = col - col / D * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = g4 + e;
        if (g >= G) break;
        if (splits == 1)
          out[(bh0 + g) * D + d] =
              from_float<T>(acc[j][e] / fmaxf(l_s[g], 1e-30f));
        else
          part_acc[((bh0 + g) * splits + split) * D + d] = acc[j][e];
      }
    }
  }
  if (splits > 1)
    for (int g = tid; g < G; g += kThreads) {
      float* ml = part_ml + ((bh0 + g) * splits + split) * 2;
      ml[0] = m_s[g];
      ml[1] = l_s[g];
    }
}

// one block per (sequence, query head): the partials rescaled to their
// common max and summed.  Splits past kv_len hold m = -inf and weigh 0;
// when every split is empty (kv_len == 0) the output is 0, as with the
// clamped l of one pass.
template <typename T>
__global__ void decode_attn_combine_kernel(const float* __restrict__ part_acc,
                                           const float* __restrict__ part_ml,
                                           T* __restrict__ out, int D,
                                           int splits) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float m = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f, l = 0.f;
    if (m > -CUDART_INF_F)
      for (int s = 0; s < splits; ++s) {
        const float w = expf(ml[2 * s] - m);
        l = fmaf(w, ml[2 * s + 1], l);
        acc = fmaf(w, part_acc[(bh * splits + s) * D + d], acc);
      }
    out[bh * D + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

size_t smem_bytes(int G, int D, int rows) {
  const size_t Gp = (G + 3) / 4 * 4;
  return sizeof(float) * ((size_t)G * (D + kPad) +
                          (size_t)rows * (2 * D + kPad) + (size_t)rows * Gp +
                          3 * Gp);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* part_acc, void* part_ml, int B, int H, int Hkv,
           int D, int S, long long qsb, long long qsh, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, int splits, int chunk, float scale,
           cudaStream_t stream) {
  const int G = H / Hkv;
  if ((G + 3) / 4 * D > kPasses * kThreads || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads: the wrapper checks strides and bases, this only refuses
  if (D % Vec16<T>::n != 0 || (uintptr_t)k % 16 != 0 ||
      (uintptr_t)v % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // a tile fits shared memory, and each thread's share of its loads fits
  // the registers it keeps in flight
  const int vpr = D / Vec16<T>::n;
  const int max_vec = Vec16<T>::in_flight * kThreads;
  int rows = kTileRows;
  while (rows > 1 && (smem_bytes(G, D, rows) > kMaxSmemBytes ||
                      2 * rows * vpr > max_vec))
    rows /= 2;
  if (2 * rows * vpr > max_vec) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, D, rows);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(splits, Hkv, B);
  decode_attn_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Hkv, D, S, qsb, qsh, ksb, ksh, kss,
      vsb, vsh, vss, splits, chunk, rows, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int threads = D >= 128 ? 128 : (D + 31) / 32 * 32;
  decode_attn_combine_kernel<T><<<B * H, threads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(out), D, splits);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bfloat16 -------
// The body is decode_bf16.cuh's, shared with the paged kernel; here the
// producer reads 64-row boxes of the caches' own 4-D maps.
constexpr int kStages = 3;     // tiles in the ring

template <int D>
__global__ void __launch_bounds__(kBfThreads)
    decode_attn_bf16(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const u16* __restrict__ q, const int* __restrict__ kv_len,
                     u16* __restrict__ out, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int* __restrict__ tickets,
                     int H, int Hkv, int S, i64 qsb, i64 qsh, int splits,
                     int chunk, float scale_log2) {
  decode_bf16_body<D, kStages, false>(&kmap, &vmap, q, kv_len, out, part_acc,
                                      part_ml, tickets, H, Hkv, S, qsb, qsh,
                                      splits, chunk, scale_log2, PagedRows{});
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* kv_len, void* out, void* part_acc, void* part_ml,
                void* tickets, int B, int H, int Hkv, int S, i64 qsb, i64 qsh,
                i64 ksb, i64 ksh, i64 kss, i64 vsb, i64 vsh, i64 vss,
                int splits, int chunk, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  // N = 8 query heads per MMA; whole 64-row tiles per split; TMA reads
  // 16-byte aligned bases and strides
  if (G > 8 || chunk % kRows != 0 || splits > kMaxSplits || B > 65535 ||
      Hkv > 65535 ||
      (splits > 1 && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  // 4-D maps (D, S, Hkv, B) over the caches' strides, 64-row boxes
  CUtensorMap km, vm;
  const i64 ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  if (!tensor_map(&km, k, D, S, Hkv, B, ks, kRows) ||
      !tensor_map(&vm, v, D, S, Hkv, B, vs, kRows))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Bf<D, kStages>::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid(splits, Hkv, B);
  decode_attn_bf16<D><<<grid, kBfThreads, Bf<D, kStages>::SMEM, stream>>>(
      km, vm, static_cast<const u16*>(q), static_cast<const int*>(kv_len),
      static_cast<u16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(tickets), H, Hkv, S, qsb,
      qsh, splits, chunk, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launches (a refused launch never runs, and a later synchronize
// would not report it).  The caller checks shapes and strides and
// allocates the partials ([B, H, splits, D] and [B, H, splits, 2] float
// when splits > 1) and, for bfloat16 with splits > 1, B * Hkv int32
// tickets that are zero before the first call (each launch leaves them
// zero); this entry checks only what would make a launch itself invalid.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_len, void* out, void* part_acc, void* part_ml,
    void* tickets, int B, int H, int Hkv, int D, int S, long long qsb,
    long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int splits, int chunk,
    float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || S <= 0 ||
      splits <= 0 || chunk <= 0 || (long long)splits * chunk < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kv_len, out, part_acc, part_ml, B, H, Hkv,
                         D, S, qsb, qsh, ksb, ksh, kss, vsb, vsh, vss,
                         splits, chunk, scale, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, kv_len, out, part_acc, part_ml, tickets,
                           B, H, Hkv, S, qsb, qsh, ksb, ksh, kss, vsb, vsh,
                           vss, splits, chunk, scale, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, kv_len, out, part_acc, part_ml, tickets,
                            B, H, Hkv, S, qsb, qsh, ksb, ksh, kss, vsb, vsh,
                            vss, splits, chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}
