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
//   (return_lse) out_f32 [B, H, D] float and lse [B, H] float in place of
//            out: the unrounded output and each row's log-sum-exp, the
//            partial a rank of the sequence-sharded decode contributes
//            (models/layers.py::attention_decode_seqsharded; the TPU
//            reference's shard_map body, src/repro/models/layers.py:383,
//            carries the same (m, l) through pmax / psum)
//
// Query head h reads KV head h / G (G = H / Hkv).  Table entries past a
// sequence's live blocks point at scratch block 0 and are never read:
// only logical rows below kv_len are gathered.  l is clamped at 1e-30,
// so a sequence with kv_len == 0 gets zeros.
//
// What bounds it: nothing but memory.  Each live K/V row is read once
// (sum_b kv_len_b * Hkv * D * 2 * sizeof(T) bytes per call) for ~2 FLOP
// per K/V element read, far below the card's ~295 FLOP/byte bf16 ridge:
// at the serve tick after 2,048-token prompts (B 8, 16 KV heads of 64,
// 2,080 rows) ~68 MB, ~20 us at 3.35 TB/s.
//
// Design, bfloat16 (the serving dtype; D 64 or 128, G <= 8): the body of
// decode_attention.cu's bf16 kernel (decode_bf16.cuh), walked through
// the block table.  A producer warp TMA-loads 64-row K/V tiles, each as
// 64 / gcd(bs, 64) boxes of gcd(bs, 64) rows of a 4-D map over the pool
// viewed as [n_blocks, Hkv, bs, D] (its own strides), into a ring of
// kPagedStages<D> stages; four consumer warps run S^T = K q^T and O^T += V^T P^T
// on mma.sync m16n8k16, p rounded to bf16 as the Pallas kernel rounds
// it; the walk splits across blocks as the contiguous kernel's does
// (kernels/decode_attention.py::split_plan_bf16 over NB * bs rows) and
// the last block of each (sequence, KV head) combines the splits in one
// launch.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py;
// PERF.md, cold L2): the serve tick after 2,048-token prompts 39.3 us,
// 1.9x its bound, where PR 11's kernel (f32 staging, CUDA-core products,
// one block per (sequence, KV head) and no pipelining) took 86.2.
//
// Design, float32 (the reduced reference configs), PR 11's kernel:
//   * grid (B, Hkv): the TPU grid (B, NB) carries the online-softmax
//     state across grid steps in VMEM; Hopper blocks run in no order, so
//     the walk over a sequence's cache is a loop inside one thread
//     block, and each (sequence, KV head) is one block.
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
//     and >= 512 threads cut the number and length of those chains.
//   * scores: kLanes lanes per (head, row) pair, D split over them and
//     summed with shuffles.  Softmax: one warp per head updates the
//     running max m and sum l (kept in shared memory, f32) and turns the
//     scores into probabilities.  PV: thread (split, g, d) sums every
//     `splits`-th row into its own f32 accumulator; the splits keep
//     small heads at >= 512 threads and are added up at the end.
//   * the probabilities stay in f32 for the PV product; the TPU kernel
//     rounds them to v.dtype first (for float32 pools a no-op).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "decode_bf16.cuh"

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
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
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
                        float* __restrict__ lse, int H, int Hkv, int D,
                        int bs, int NB,
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
    // natural units: -inf for a row with no live key (m_s still -inf)
    if (lse && d == 0)
      lse[(size_t)b * H + (size_t)hk * G + g] =
          l_s[g] > 0.f ? m_s[g] + logf(l_s[g]) : -CUDART_INF_F;
  }
}

size_t smem_bytes(int G, int D, int rows, int splits) {
  return sizeof(float) *
         ((size_t)G * D + (size_t)rows * (2 * D + kPad) + (size_t)G * rows +
          3 * (size_t)G + (size_t)(splits - 1) * G * D);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* kv_len, void* out, void* lse,
           int B, int H, int Hkv, int D, int bs, int NB, int table_stride,
           float scale, cudaStream_t stream) {
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
      static_cast<const int*>(kv_len), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, D, bs, NB, table_stride, rows, splits,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bfloat16 -------
// Tiles in the TMA ring, per head_dim: at 64 six stages (96 KB) beat three
// by 2-4% at the 2,048-token serve tick; at 128 three (96 KB) already
// hold the walk (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
template <int D>
constexpr int kPagedStages = D == 64 ? 6 : 3;

// The shared body (decode_bf16.cuh) with the paged producer.
template <int D>
__global__ void __launch_bounds__(kBfThreads)
    paged_decode_kernel_bf16(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const u16* __restrict__ q,
                             const int* __restrict__ kv_len,
                             u16* __restrict__ out,
                             float* __restrict__ part_acc,
                             float* __restrict__ part_ml,
                             int* __restrict__ tickets, int H, int Hkv,
                             int S, i64 qsb, i64 qsh, int splits, int chunk,
                             float scale_log2, const PagedRows pg,
                             const LseOut lse_out) {
  decode_bf16_body<D, kPagedStages<D>, true>(&kmap, &vmap, q, kv_len, out, part_acc,
                                    part_ml, tickets, H, Hkv, S, qsb, qsh,
                                    splits, chunk, scale_log2, pg, lse_out);
}

template <int D>
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const void* tables, const void* kv_len, void* out,
                const LseOut& lse_out, void* part_acc, void* part_ml,
                void* tickets, int B, int H,
                int Hkv, int n_blocks, int bs, int NB, i64 table_stride,
                i64 qsb, i64 qsh, const i64* ks, const i64* vs, int splits,
                int chunk, int box, float scale, cudaStream_t stream) {
  // 4-D maps over the pools as [n_blocks, Hkv, bs, D]: element strides
  // (block, head, row), boxes of `box` rows
  CUtensorMap km, vm;
  const i64 kst[3] = {ks[0], ks[2], ks[1]}, vst[3] = {vs[0], vs[2], vs[1]};
  if (!tensor_map(&km, k_pool, D, bs, Hkv, n_blocks, kst, box) ||
      !tensor_map(&vm, v_pool, D, bs, Hkv, n_blocks, vst, box))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel_bf16<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Bf<D, kPagedStages<D>>::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const PagedRows pg{static_cast<const int*>(tables), table_stride, bs, box};
  dim3 grid(splits, Hkv, B);
  paged_decode_kernel_bf16<D>
      <<<grid, kBfThreads, Bf<D, kPagedStages<D>>::SMEM, stream>>>(
          km, vm, static_cast<const u16*>(q),
          static_cast<const int*>(kv_len), static_cast<u16*>(out),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml),
          static_cast<int*>(tickets), H, Hkv, NB * bs, qsb, qsh, splits,
          chunk, scale * 1.4426950408889634f, pg, lse_out);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 only (dtype 0; bfloat16 takes paged_decode_attention_bf16_launch).
// `lse` [B, H] float, or null: each row's natural log-sum-exp of its
// scaled scores, -inf for a row with kv_len 0.  Returns cudaGetLastError() after the launch (a refused launch never
// runs, and a later synchronize would not report it).  The caller checks
// shapes; this entry checks only what would make the launch itself
// invalid.
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* kv_len, void* out, void* lse, int B,
    int H, int Hkv, int D, int bs, int NB, int table_stride, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || bs <= 0 || NB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, kv_len, out, lse, B, H,
                         Hkv, D, bs, NB, table_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

// bfloat16: q [B, H, D] with strides (qsb, qsh, 1); pools [n_blocks, bs,
// Hkv, D] with element strides ks / vs = (block, row, head) and a unit
// last axis; splits of `chunk` logical rows (a multiple of 64) over the
// table's NB * bs; `box` = gcd(bs, 64) rows per TMA load; D 64 or 128.
// The caller allocates the partials ([B, H,
// splits, D] and [B, H, splits, 2] float) and B * Hkv int32 tickets that
// are zero before the first call (each launch leaves them zero) when
// splits > 1.  `out_f32` [B, H, D] and `lse` [B, H] float, both or
// neither: the unrounded output goes to out_f32 (out is not written) and
// each row's natural log-sum-exp to lse (-inf for kv_len 0), the partials
// the sequence-sharded decode combines across ranks.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode_attention_bf16_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* kv_len, void* out, void* out_f32,
    void* lse, void* part_acc, void* part_ml, void* tickets, int B, int H,
    int Hkv, int D,
    int n_blocks, int bs, int NB, long long table_stride, long long qsb,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int splits, int chunk,
    int box, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 8 || n_blocks <= 0 ||
      bs <= 0 || NB <= 0 || splits <= 0 || splits > kMaxSplits ||
      chunk <= 0 || chunk % kRows != 0 || (long long)splits * chunk <
      (long long)NB * bs || box <= 0 || kRows % box != 0 || bs % box != 0 ||
      B > 65535 || Hkv > 65535 || (splits > 1 && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  if ((out_f32 == nullptr) != (lse == nullptr))
    return (int)cudaErrorInvalidValue;
  const LseOut lse_out{static_cast<float*>(out_f32),
                      static_cast<float*>(lse)};
  if (D == 64)
    return launch_bf16<64>(q, k_pool, v_pool, tables, kv_len, out, lse_out,
                           part_acc, part_ml, tickets, B, H, Hkv, n_blocks, bs, NB,
                           table_stride, qsb, qsh, ks, vs, splits, chunk, box,
                           scale, s);
  if (D == 128)
    return launch_bf16<128>(q, k_pool, v_pool, tables, kv_len, out,
                            lse_out, part_acc, part_ml, tickets, B, H, Hkv, n_blocks, bs, NB,
                            table_stride, qsb, qsh, ks, vs, splits, chunk,
                            box, scale, s);
  return (int)cudaErrorInvalidValue;
}
