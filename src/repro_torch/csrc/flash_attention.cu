// Flash attention for Hopper (sm_90a), forward and backward:
//
//   o[b, h, q] = sum_k softmax_k(q . k * scale | allowed) v[b, h / G, k]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (its pallas_call at :110, kernel body _kernel at :30).
// The Pallas kernel is forward only; JAX trains through autodiff of the
// lax.scan in src/repro/models/layers.py::attention_blockwise (:105).
// Here the backward is kernels of its own.
//
// Allowed keys of query row q: k < Skv; with causal k <= q; with
// window > 0, q - k < window.  Head h reads KV head h / G (G = H / Hkv)
// through its index.  A fully masked row gives zeros.  Numerics of the
// Pallas kernel: q . k with operands in the input dtype T and f32
// accumulation, the online max and sum in f32 (the sum over unrounded
// p), p rounded to T for the PV product, the output in T.  The forward
// also writes the per-row log-sum-exp (natural log, f32; +inf for a
// fully masked row) that the backward recomputes P from.
//
// Tensors come as [B, H, S, D] with element strides for (b, h, s) and
// unit stride along D, so the model's [B, S, H, D] activations go in
// without a transposing copy.  Ragged Sq and Skv are zero-filled at the
// loads and clipped at the stores; nothing is padded by the caller.
// Tiles whose every (query, key) pair is masked are skipped: the loop
// bounds of each block start and stop at the first and last tile that
// holds an allowed pair (above the causal diagonal, or older than the
// window, on either side).
//
// What bounds it (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s): at 2,048
// tokens a causal head does 2 * 2 * S^2 / 2 * D flop against 4 * S * D
// elements of q/k/v/o, ~1,000 flop per byte: operations.  At head_dim 64
// the exponentials come close too: one ex2 per score against 4 * 64 flop,
// and the card has ~250x more tensor flop than ex2 per cycle.
//
// Head dims 64, 80 and 128.  The bfloat16 kernels are written for 64 and
// 128 (one or two 64-column swizzle regions); head_dim 80 (hubert-xlarge)
// runs the 128 body on tensor maps whose D extent is 80: TMA loads fill
// columns 80-127 with zeros, so every product over D and every output
// column past 80 is exact zero, and TMA stores clip at the extent.  The
// stores that do not go through TMA (the f32 dQ accumulator and slices,
// which keep a 128-column layout, and their rounding into the outputs)
// mask the columns past D.  The scale comes from the caller (1 / sqrt(80)
// for hubert), never from the padded width.  The float32 kernels take D
// = 80 as it is (10 channels per lane).
//
// Design, bfloat16 (the serving and training dtype), warp-specialised:
// one producer warp feeds shared memory with TMA (4-D tensor maps over
// (D, S, H, B) with the views' byte strides, 128-byte swizzle, 64-column
// boxes: a D = 128 row is two swizzle atoms, kept as two 64-column
// regions), completion tracked by full / empty mbarriers; two consumer
// warpgroups of 64 rows run wgmma (m64nNk16, f32 accumulators) from
// shared memory, the second product of each pair with its A operand (P
// or dS, rounded to bf16) in registers, laid out as the first product's
// accumulator.  setmaxnreg gives the consumers 240 registers and the
// producer 24.  Only tiles that cross the causal diagonal, the window
// edge or Skv test each (query, key) pair; interior tiles take no test.
//   * forward: persistent, one block per SM walking 128-row query tiles
//     (head, batch), longest causal rows first within groups of heads
//     whose K/V share L2; Q double-buffered, K and V tiles through
//     separate two-stage rings.  Each warpgroup overlaps its next S =
//     Q K^T with the current O += P V: issue both, wait for S, run the
//     online softmax (in log2 units), then rescale O.  The two
//     warpgroups take turns to issue their products.  The epilogue
//     writes O into the warpgroup's Q rows (swizzled) and stores it with
//     TMA; lse is written per row.
//   * backward, single pass, after a prep kernel (delta = rowsum(dO * O)
//     and lse in log2 units per row, padded to 128 rows, and the f32 dQ
//     accumulator zeroed): one block per (128-key tile, KV head, batch,
//     slice of the group's heads: one slice unless the grid is smaller
//     than the card), in groups of heads whose Q/dO share L2, the tile
//     with the most query tiles first; each warpgroup owns 64 keys,
//     keeps dK and dV in registers, and walks the query tiles of its
//     heads (128 rows at D = 64, 64 at D = 128; Q, dO, lse and delta
//     through a two-stage ring): S^T = K Q^T and dP^T =
//     V dO^T (wgmma from shared memory), P^T = exp2(S^T - lse) once,
//     dS^T = P^T (dP^T - delta), dV += P^T dO and dK += dS^T Q (A in
//     registers).  dS goes to shared memory (double-buffered), and after
//     a barrier of both warpgroups each forms one 64 x 64 piece of
//     dQ += dS K over all 128 keys, stages it (f32) in shared memory and
//     adds it into the accumulator with one bulk reduce-add
//     (cp.reduce.async.bulk .add.f32).  A last kernel rounds dQ into the
//     model layout (and sums the slices' f32 dK and dV, if any).  dK and
//     dV are bitwise repeatable; dQ's adds land in an order that changes
//     from run to run (f32 rounding).
// Design, float32 (the reduced reference configs): plain FMAs (no TF32,
// so the card agrees with the CPU to f32 rounding); 8 lanes per query
// (or key) row, each owning D / 8 channels, dot products reduced across
// the 8 lanes by shuffles; 32-row tiles in shared memory; the backward
// is delta, then dK/dV, then dQ, each recomputing P.
// What limits the forward (clock64 traces and variants timed on the
// card): the softmax.  Its ~350 instructions per warp and 64 x 128 tile
// (66 of them ex2, 16 per cycle on an SM) take ~1,700 cycles inside the
// kernel against ~850 in a kernel of their own, so at D = 64 the two
// warpgroups' softmaxes, not the tensor cores, set the pace.  ptxas
// places the exponentials after the wait for the warpgroup's own PV
// product; forcing them to overlap it measured ~10% slower, and a turn
// for the softmax as well as for the issue gained nothing.  Not yet: a
// persistent backward; two score buffers, to issue the next S before
// the softmax, which ptxas serializes (C7513) as written.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef long long i64;
typedef unsigned short u16;

constexpr float NEG = -1e30f;  // masked score of the f32 kernels
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

// ---------------------------------------------- Hopper building blocks ---
// one box from shared memory into a 4-D tensor map (out-of-range rows are
// not written)
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// dst[i] += src[i] over `bytes` of f32, done by the memory system
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
      " [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}


// Set the elements of this thread's part of a 64 x N accumulator whose
// column (0 .. N - 1 within the tile) lies outside [lo[r], hi[r]] to v:
// the mask of a tile, one bound pair per row, two compares per element.
// Bounds come with the thread's 2t column offset taken off.
template <int N>
__device__ __forceinline__ void mask_cols(float (&c)[N / 2], const int (&lo)[2],
                                          const int (&hi)[2], float v) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + (e & 1);
      if (col < lo[e >> 1] || col > hi[e >> 1]) c[4 * j + e] = v;
    }
}

// Write this thread's part of a 64 x N accumulator (row r times f[r]),
// rounded to bf16, into a 128-byte-swizzled tile of 64-column regions
// `reg` bytes apart whose rows are 128 bytes: the layout a TMA store map
// (or an MN-major wgmma operand) reads.  `row` is the tile row of the
// thread's first element (warp * 16 + g); region starts are 1024-byte
// aligned.
template <int N>
__device__ __forceinline__ void store_swizzled(uint32_t base, int reg,
                                               const float (&c)[N / 2],
                                               const float (&f)[2], int row,
                                               int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      st_u32(base + (j / 8) * reg + rr * 128 + (((j % 8) ^ (rr & 7)) << 4) +
                 t * 4,
             pack_bf16(c[4 * j + 2 * r] * f[r], c[4 * j + 2 * r + 1] * f[r]));
    }
}

constexpr int WG = 128, N_CONS = 256, N_THREADS = 384;

// --------------------------------------------------- bf16 forward -------
template <int D>
struct Fwd {
  // two consumer warpgroups of 64 rows, 128-key tiles
  static constexpr int BQ = 128, BK = 128, ST = 2;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // bytes of one 64-column region of the Q and of a K or V tile
  static constexpr int QREG = BQ * 128, KREG = BK * 128;
  // two Q buffers, then the K and V rings
  static constexpr int OFF_K = 2 * Q_BYTES, OFF_V = OFF_K + ST * KV_BYTES,
                       OFF_BAR = OFF_V + ST * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 4 * ST) + 1024;
};

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile (K-major both)
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t qa,
                                        uint32_t ka) {
  typedef Fwd<D> C;
  keep(s);
  wg_arrive();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128<0, 0>(
        s, sw128(qa + (kk / 4) * C::QREG + (kk % 4) * 32, 16, 1024),
        sw128(ka + (kk / 4) * C::KREG + (kk % 4) * 32, 16, 1024), kk > 0);
  wg_commit();
}

// O += P V: P (64 x 128 keys) in registers, V MN-major
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&p)[32], uint32_t va) {
  typedef Fwd<D> C;
  keep(o);
  keep(p);
  wg_arrive();
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    mma_rs<D, 1>(o, &p[4 * kk], sw128(va + kk * 2048, C::KREG, 1024), 1);
  wg_commit();
}

// The online softmax of one 64 x 128 score tile in place: masks it when
// the tile needs it, updates the row max m (log2 units) and the row sum l
// (this thread's part, over unrounded p), leaves p in s and returns each
// row's rescale factor in corr.  row0: this thread's first query row.
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2],
                                               const Args& a, float sl2,
                                               bool mask, int row0, int k0,
                                               int t) {
  if (mask) {  // keys k0 + col allowed for query q: [q - window + 1, q]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + 8 * r;
      hi[r] = (q < a.Sq ? min(a.Skv - 1, a.causal ? q : a.Skv - 1)
                        : -(1 << 30)) - k0 - 2 * t;
      lo[r] = (a.window > 0 ? q - a.window + 1 : -(1 << 30)) - k0 - 2 * t;
    }
    mask_cols<128>(s, lo, hi, -INFINITY);
  }
  // row maxima and sums over four independent chains per row, so that
  // the few warps an SM sub-partition holds do not wait on one long
  // dependent chain
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    mx[0][k] = fmaxf(s[4 * k], s[4 * k + 1]);
    mx[1][k] = fmaxf(s[4 * k + 2], s[4 * k + 3]);
  }
#pragma unroll
  for (int c = 4; c < 16; ++c) {
    mx[0][c & 3] = fmaxf(mx[0][c & 3], fmaxf(s[4 * c], s[4 * c + 1]));
    mx[1][c & 3] = fmaxf(mx[1][c & 3], fmaxf(s[4 * c + 2], s[4 * c + 3]));
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x =
        fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    const float mn = fmaxf(m[r], quad_max(x) * sl2);
    mb[r] = mn == -INFINITY ? 0.f : mn;  // an all-masked row so far
    corr[r] = ex2(m[r] - mb[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      s[4 * c + e] = ex2(fmaf(s[4 * c + e], sl2, -mb[r]));
      if (c < 4 && !(e & 1))
        sum[r][c] = s[4 * c + e];
      else
        sum[r][c & 3] += s[4 * c + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] +
           ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// Tile of block c in round k of a persistent walk over n blocks: rounds
// alternate direction, so each block's share of a heaviest-first list
// evens out
__device__ __forceinline__ int snake(int k, int c, int n) {
  return k * n + ((k & 1) ? n - 1 - c : c);
}

// Work item i of a list that takes the (head, batch) units in groups of
// gh and, inside a group, walks its n tiles per unit heaviest first:
// (tile rank, unit).  A group's tiles fill about one round of the grid,
// so the blocks in flight share gh units' K/V (or Q/dO) in L2 instead of
// streaming every unit's from memory.
__device__ __forceinline__ void grouped(int i, int n, int units, int gh,
                                        int& rank, int& unit) {
  const int grp = i / (gh * n), j = i % (gh * n);
  const int size = min(gh, units - grp * gh);
  rank = j / size;
  unit = grp * gh + j % size;
}

// The forward's query tile t: the last (longest causal) rows first
struct FwdTile {
  int q0, h, b;
};
__device__ __forceinline__ FwdTile fwd_tile(const Args& a, int t, int BQ,
                                            int gh) {
  const int nq = cdiv(a.Sq, BQ);
  int rank, bh;
  grouped(t, nq, a.H * a.B, gh, rank, bh);
  return {(nq - 1 - rank) * BQ, bh % a.H, bh / a.H};
}

// The two consumer warpgroups take turns to issue their products (named
// barrier 8 + w is warpgroup w's turn), so that one warpgroup's softmax
// runs while the other's wgmma run.
__device__ __forceinline__ void turn_wait(int w) { named_sync(8 + w, N_CONS); }
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(8 + (w ^ 1)), "r"(N_CONS)
               : "memory");
}

// Persistent: one block per SM walks its share of the query tiles (see
// snake); Q is double-buffered so the producer loads the next tile's Q
// and first K/V tiles while the consumers finish this one.  The K/V
// ring's stage counter runs on across tiles.
template <int D>
__global__ void __launch_bounds__(N_THREADS, 1)
    fa_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, const Args a,
                 int n_tiles, int gh) {
  typedef Fwd<D> C;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::OFF_K, sV = base + C::OFF_V;
  // barriers: per Q buffer full, empty; per stage K full, K empty, V
  // full, V empty
  const uint32_t qfull = base + C::OFF_BAR, qempty = qfull + 16,
                 kfull = qempty + 16, kempty = kfull + 8 * ST,
                 vfull = kempty + 8 * ST, vempty = vfull + 8 * ST;

  // empty barriers take one arrival per consumer warpgroup: its wgmma
  // have read the buffer once its wait returns
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 2);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, 2);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(vempty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONS) {  // the producer warpgroup; one thread loads
    regs_dec<24>();
    if (threadIdx.x == N_CONS) {
      int kv = 0;  // K/V tiles loaded so far
      for (int lt = 0;; ++lt) {
        const int t = snake(lt, blockIdx.x, gridDim.x);
        if (t >= n_tiles) break;
        const FwdTile ti = fwd_tile(a, t, BQ, gh);
        int jb, je;
        kv_range(a, ti.q0, BQ, BK, jb, je);
        const int qb = lt & 1;
        mbar_wait(qempty + 8 * qb, ((lt >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull + 8 * qb, C::Q_BYTES);
        for (int dh = 0; dh < D / 64; ++dh)
          tma_load(sQ + qb * C::Q_BYTES + dh * C::QREG, &qmap, qfull + 8 * qb,
                   dh * 64, ti.q0, ti.h, ti.b);
        for (int j = jb; j < je; ++j, ++kv) {
          const int s = kv % ST, k0 = j * BK;
          const uint32_t ph = ((kv / ST) & 1) ^ 1;
          mbar_wait(kempty + 8 * s, ph);
          mbar_expect_tx(kfull + 8 * s, C::KV_BYTES);
          for (int dh = 0; dh < D / 64; ++dh)
            tma_load(sK + s * C::KV_BYTES + dh * C::KREG, &kmap,
                     kfull + 8 * s, dh * 64, k0, ti.h / a.G, ti.b);
          mbar_wait(vempty + 8 * s, ph);
          mbar_expect_tx(vfull + 8 * s, C::KV_BYTES);
          for (int dh = 0; dh < D / 64; ++dh)
            tma_load(sV + s * C::KV_BYTES + dh * C::KREG, &vmap,
                     vfull + 8 * s, dh * 64, k0, ti.h / a.G, ti.b);
        }
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    regs_inc<240>();
    const int w = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
    const float sl2 = a.scale * LOG2E;
    float o[D / 2], s[64], m[2], l[2], corr[2];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    if (w == 1) turn_pass(w);  // warpgroup 0 goes first
    int kv = 0;  // K/V tiles consumed so far
    for (int lt = 0;; ++lt) {
      const int t = snake(lt, blockIdx.x, gridDim.x);
      if (t >= n_tiles) break;
      const FwdTile ti = fwd_tile(a, t, BQ, gh);
      int jb, je;
      kv_range(a, ti.q0, BQ, BK, jb, je);
      const int nt = max(je - jb, 0), qb = lt & 1;
      const int r_lo = ti.q0 + 64 * w;            // this warpgroup's rows
      const int row0 = r_lo + warp * 16 + g;      // this thread's: +0, +8
      // its 64 rows in each region of this tile's Q buffer
      const uint32_t qa = sQ + qb * C::Q_BYTES + w * 64 * 128;
      // whether tile k0 holds a masked pair for these 64 rows
      auto needs_mask = [&](int k0) {
        return k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > r_lo) ||
               (a.window > 0 && r_lo + 63 - k0 >= a.window);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      mbar_wait(qfull + 8 * qb, (lt >> 1) & 1);
      if (nt > 0) {
        int st = kv % ST;
        mbar_wait(kfull + 8 * st, (kv / ST) & 1);
        turn_wait(w);
        issue_s<D>(s, qa, sK + st * C::KV_BYTES);
        turn_pass(w);
        wg_wait<0>();
        keep(s);
        if (tid == 0) mbar_arrive(kempty + 8 * st);
        online_softmax(s, m, l, corr, a, sl2, needs_mask(jb * BK), row0,
                       jb * BK, t4);
        to_frags<128>(p, s);
        for (int it = 1; it < nt; ++it) {
          const int ps = st, k0 = (jb + it) * BK;
          const uint32_t pph = (kv / ST) & 1;
          ++kv;
          st = kv % ST;
          mbar_wait(kfull + 8 * st, (kv / ST) & 1);
          mbar_wait(vfull + 8 * ps, pph);
          turn_wait(w);
          issue_s<D>(s, qa, sK + st * C::KV_BYTES);
          issue_pv<D>(o, p, sV + ps * C::KV_BYTES);
          turn_pass(w);
          wg_wait<1>();  // S is in; PV of the previous tile may run on
          keep(s);
          if (tid == 0) mbar_arrive(kempty + 8 * st);
          online_softmax(s, m, l, corr, a, sl2, needs_mask(k0), row0, k0,
                         t4);
          wg_wait<0>();
          keep(o);
          keep(p);
          if (tid == 0) mbar_arrive(vempty + 8 * ps);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
          to_frags<128>(p, s);
        }
        mbar_wait(vfull + 8 * st, (kv / ST) & 1);
        issue_pv<D>(o, p, sV + st * C::KV_BYTES);
        wg_wait<0>();
        keep(o);
        keep(p);
        if (tid == 0) mbar_arrive(vempty + 8 * st);
        ++kv;
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      }
      // O into this warpgroup's (finished) Q rows, then one TMA store per
      // 64-column region; rows past Sq are clipped by the map.  The Q
      // buffer is free again once the store has read it.
      store_swizzled<D>(qa, C::QREG, o, inv, warp * 16 + g, t4);
      fence_async_smem();
      named_sync(1 + w, WG);
      if (tid == 0) {
        for (int dh = 0; dh < D / 64; ++dh)
          tma_store(&omap, qa + dh * C::QREG, dh * 64, r_lo, ti.h, ti.b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(qempty + 8 * qb);
      }
      __syncwarp();
      if (t4 == 0) {
        float* L = a.lse_out + ((i64)ti.b * a.H + ti.h) * a.Sq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row0 + 8 * r < a.Sq)
            L[row0 + 8 * r] =
                l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : INFINITY;
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// -------------------------------------------------- bf16 backward -------
template <int D>
struct Bwd {
  static constexpr int BK = 128, BQ = D == 64 ? 128 : 64, ST = 2;
  static constexpr int KV_BYTES = BK * D * 2, KREG = BK * 128;
  static constexpr int QT_BYTES = BQ * D * 2, QREG = BQ * 128;
  // one stage: Q, dO, then lse (log2 units) and delta rows
  static constexpr int STAGE = 2 * QT_BYTES + 1024;
  // dS^T [BK keys][BQ queries]: 64-query regions of BK rows
  static constexpr int DS_BYTES = BK * BQ * 2, DSREG = BK * 128;
  static constexpr int DQ_PIECE = 64 * 64 * 4;  // one f32 dQ piece
  static constexpr int OFF_V = KV_BYTES, OFF_ST = 2 * KV_BYTES,
                       OFF_DS = OFF_ST + ST * STAGE,
                       OFF_DQ = OFF_DS + 2 * DS_BYTES,
                       OFF_BAR = OFF_DQ + 2 * DQ_PIECE;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * ST) + 1024;
};

// One 64 x 64 f32 piece of the dQ accumulator, in the order a warpgroup
// holds it: float4 i * 128 + tid is thread tid's accumulator chunk i.
// Pieces: [B][H][Sqp / 64][D / 64].
__device__ __forceinline__ i64 dq_piece(int b, int h, int qb, int db, int H,
                                        int Sqp, int D) {
  return ((((i64)b * H + h) * (Sqp / 64) + qb) * (D / 64) + db) * 4096;
}

template <int D>
__global__ void __launch_bounds__(N_THREADS, 1)
    fa_bwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap dkmap,
                 const __grid_constant__ CUtensorMap dvmap, const Args a,
                 const float* lse2, const float* dlt, float* dq_acc,
                 int Sqp, int split, float* part, int Skvp, int gh) {
  typedef Bwd<D> C;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + C::OFF_V, sSt = base + C::OFF_ST,
                 sDS = base + C::OFF_DS, sDQ = base + C::OFF_DQ;
  // barriers: K and V; per stage full, empty
  const uint32_t kvbar = base + C::OFF_BAR, full = kvbar + 8,
                 empty = full + 8 * ST;

  // block: (KV tile, unit = (batch, KV head, slice of its group's
  // heads)), units in groups of gh, KV tile 0 (the most causal query
  // tiles) first in each
  int kt, u;
  grouped(blockIdx.x, cdiv(a.Skv, BK), a.B * a.Hkv * split, gh, kt, u);
  const int sp = u % split, hk = (u / split) % a.Hkv, b = u / split / a.Hkv;
  const int k0 = kt * BK, gs = a.G / split, h0 = hk * a.G + sp * gs;
  int ib, ie;
  q_range(a, k0, BK, BQ, ib, ie);
  const int ni = max(ie - ib, 0), n_it = gs * ni;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, N_CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= N_CONS) {  // the producer warpgroup; one thread loads
    regs_dec<24>();
    if (threadIdx.x == N_CONS) {
      mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
      for (int dh = 0; dh < D / 64; ++dh) {
        tma_load(sK + dh * C::KREG, &kmap, kvbar, dh * 64, k0, hk, b);
        tma_load(sV + dh * C::KREG, &vmap, kvbar, dh * 64, k0, hk, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, hh = h0 + it / ni;
        const int q0 = (ib + it % ni) * BQ;
        const uint32_t st = sSt + s * C::STAGE;
        mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::QT_BYTES + 2 * BQ * 4);
        for (int dh = 0; dh < D / 64; ++dh) {
          tma_load(st + dh * C::QREG, &qmap, full + 8 * s, dh * 64, q0, hh,
                   b);
          tma_load(st + C::QT_BYTES + dh * C::QREG, &domap, full + 8 * s,
                   dh * 64, q0, hh, b);
        }
        const i64 row = ((i64)b * a.H + hh) * Sqp + q0;
        bulk_load(st + 2 * C::QT_BYTES, lse2 + row, BQ * 4, full + 8 * s);
        bulk_load(st + 2 * C::QT_BYTES + BQ * 4, dlt + row, BQ * 4,
                  full + 8 * s);
      }
    }
  } else {  // two consumer warpgroups, 64 keys each
    regs_inc<240>();
    const int w = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int klo = k0 + 64 * w;             // this warpgroup's keys
    const int krow = klo + warp * 16 + g;    // this thread's: +0, +8
    const uint32_t ka = sK + w * 64 * 128, va = sV + w * 64 * 128;
    const float sl2 = a.scale * LOG2E;
    // the dQ piece this warpgroup forms: 64 queries (half qh of the tile)
    // by 64 channels (half dh of D)
    const int qh = D == 64 ? w : 0, dh = D == 64 ? 0 : w;
    float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2], dq[32];
    uint32_t pf[BQ / 4], df[BQ / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    mbar_wait(kvbar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int sidx = it % ST, hh = h0 + it / ni;
      const int q0 = (ib + it % ni) * BQ;
      const uint32_t sq = sSt + sidx * C::STAGE, sdo = sq + C::QT_BYTES;
      const float2* L2 = reinterpret_cast<const float2*>(
          gbase + (sq - base) + 2 * C::QT_BYTES);
      const float2* Dl2 = L2 + BQ / 2;
      mbar_wait(full + 8 * sidx, (it / ST) & 1);
      // S^T = K Q^T and dP^T = V dO^T: keys x queries
      keep(s);
      keep(dp);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BQ, 0, 0>(
            s, sw128(ka + (kk / 4) * C::KREG + (kk % 4) * 32, 16, 1024),
            sw128(sq + (kk / 4) * C::QREG + (kk % 4) * 32, 16, 1024), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BQ, 0, 0>(
            dp, sw128(va + (kk / 4) * C::KREG + (kk % 4) * 32, 16, 1024),
            sw128(sdo + (kk / 4) * C::QREG + (kk % 4) * 32, 16, 1024),
            kk > 0);
      wg_commit();
      wg_wait<1>();
      keep(s);
      // P^T = exp2(S^T scale log2(e) - lse2), once; masked only where the
      // tile holds a masked pair (queries past Sq have lse2 = +inf)
      const bool mask = klo + 63 >= a.Skv || (a.causal && klo + 63 > q0) ||
                        (a.window > 0 && q0 + BQ - 1 - klo >= a.window);
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 lv = L2[4 * c + t];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * c + e] = ex2(fmaf(s[4 * c + e], sl2, -(e & 1 ? lv.y : lv.x)));
      }
      if (mask) {  // queries q0 + col allowed for key k: [k, k + window)
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = krow + 8 * r;
          lo[r] = (a.causal ? k : 0) - q0 - 2 * t;
          hi[r] = (k < a.Skv ? min(a.Sq - 1,
                                   a.window > 0 ? k + a.window - 1 : a.Sq - 1)
                             : -(1 << 30)) - q0 - 2 * t;
        }
        mask_cols<BQ>(s, lo, hi, 0.f);
      }
      wg_wait<0>();
      keep(dp);
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 dl = Dl2[4 * c + t];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * c + e] =
              s[4 * c + e] * (dp[4 * c + e] - (e & 1 ? dl.y : dl.x));
      }
      to_frags<BQ>(pf, s);
      to_frags<BQ>(df, dp);
      // dV += P^T dO, dK += dS^T Q (A from registers, B MN-major)
      keep(dv);
      keep(dk);
      keep(pf);
      keep(df);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<D, 1>(dv, &pf[4 * kk], sw128(sdo + kk * 2048, C::QREG, 1024),
                     1);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<D, 1>(dk, &df[4 * kk], sw128(sq + kk * 2048, C::QREG, 1024),
                     1);
      wg_commit();
      // dS^T into this iteration's buffer, swizzled: 64-query regions of
      // 128-byte key rows (the MN-major A operand of dQ = dS K)
      const uint32_t ds = sDS + (it & 1) * C::DS_BYTES;
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = 64 * w + warp * 16 + g + 8 * r;
          st_u32(ds + (c / 8) * C::DSREG + kr * 128 +
                     (((c % 8) ^ (kr & 7)) << 4) + t * 4,
                 df[2 * c + r]);
        }
      fence_async_smem();
      wg_wait<0>();
      keep(dv);
      keep(dk);
      keep(pf);
      keep(df);
      mbar_arrive(empty + 8 * sidx);  // Q, dO, lse, delta of it are done
      named_sync(1, N_CONS);          // both halves of dS^T are in
      // this warpgroup's dQ piece over all 128 keys: A = dS (MN-major),
      // B = K (MN-major)
      keep(dq);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_n64<1, 1>(
            dq, sw128(ds + qh * C::DSREG + kk * 2048, C::DSREG, 1024),
            sw128(sK + dh * C::KREG + kk * 2048, C::KREG, 1024), kk > 0);
      wg_commit();
      wg_wait<0>();
      keep(dq);
      const uint32_t dqs = sDQ + w * C::DQ_PIECE;
      if (tid == 0) bulk_wait_read();  // the last piece has left dqs
      named_sync(2 + w, WG);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st_f4(dqs + (i * WG + tid) * 16, dq[4 * i], dq[4 * i + 1],
              dq[4 * i + 2], dq[4 * i + 3]);
      fence_async_smem();
      named_sync(2 + w, WG);
      if (tid == 0) {
        bulk_reduce_add(
            dq_acc + dq_piece(b, hh, q0 / 64 + qh, dh, a.H, Sqp, D), dqs,
            C::DQ_PIECE);
        bulk_commit();
      }
      __syncwarp();
    }
    if (split > 1) {
      // f32 partial sums over this slice of the group's heads,
      // part[2][split][B][Hkv][Skvp][D] (dK unscaled); the last kernel
      // adds the slices in order
      const i64 plane = (i64)split * a.B * a.Hkv * Skvp * D;
      float* pk = part + ((((i64)sp * a.B + b) * a.Hkv + hk) * Skvp) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const i64 off = (i64)(krow + 8 * r) * D + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(pk + off) =
              make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(pk + plane + off) =
              make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
      if (tid == 0) bulk_wait();
    } else {
      // dK (times scale) and dV through the K and V tiles, once both
      // warpgroups are done reading them
      named_sync(1, N_CONS);
      const float sc[2] = {a.scale, a.scale}, one[2] = {1.f, 1.f};
      store_swizzled<D>(ka, C::KREG, dk, sc, warp * 16 + g, t);
      store_swizzled<D>(va, C::KREG, dv, one, warp * 16 + g, t);
      fence_async_smem();
      named_sync(2 + w, WG);
      if (tid == 0) {
        for (int d = 0; d < D / 64; ++d) {
          tma_store(&dkmap, ka + d * C::KREG, d * 64, klo, hk, b);
          tma_store(&dvmap, va + d * C::KREG, d * 64, klo, hk, b);
        }
        bulk_commit();
        bulk_wait();
      }
    }
  }
}

// The width of the bf16 body a head_dim runs on, and of its f32 dQ
// accumulator rows: 64, else 128 (head_dim 80 padded)
__host__ __device__ __forceinline__ int body_width(int D) {
  return D == 64 ? 64 : 128;
}

// Before the backward: delta = rowsum(dO * O) in f32 and lse in log2 units
// for every row padded to Sqp (0 and +inf past Sq), and the dQ
// accumulator (rows of body_width(D) floats) zeroed; one warp per padded
// row
__global__ void __launch_bounds__(256)
    fa_bwd_prep(const Args a, int D, int Sqp, float* lse2, float* dlt,
                float* acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const i64 row = (i64)blockIdx.x * 8 + warp;
  if (row >= (i64)a.B * a.H * Sqp) return;
  const int qp = (int)(row % Sqp);
  const i64 bh = row / Sqp;
  const int h = (int)(bh % a.H), b = (int)(bh / a.H);
  float x = 0.f;
  if (qp < a.Sq && lane < D / 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const u16*>(a.o) + b * a.os[0] + h * a.os[1] +
        (i64)qp * a.os[2] + lane * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        static_cast<const u16*>(a.dO) + b * a.dos[0] + h * a.dos[1] +
        (i64)qp * a.dos[2] + lane * 8);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
    const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x = fmaf(__uint_as_float(ow[i] << 16), __uint_as_float(dw[i] << 16), x);
      x = fmaf(__uint_as_float(ow[i] & 0xffff0000u),
               __uint_as_float(dw[i] & 0xffff0000u), x);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m /= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  if (lane == 0) {
    dlt[row] = x;
    lse2[row] = qp < a.Sq ? a.lse[bh * a.Sq + qp] * LOG2E : INFINITY;
  }
  const int W = body_width(D);
  float4* z = reinterpret_cast<float4*>(acc + row * W);
  for (int i = lane; i < W / 4; i += 32) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// After it: dQ = scale * the accumulator, rounded to bf16 into the model
// layout, one thread per float4 of a piece (rows past Sq and columns past
// D dropped); with split > 1 also dK = scale * the sum of its slices and
// dV the sum of its, one thread per 4 channels of a key row.  The
// accumulator and the slices are laid out body_width(D) wide.
__global__ void __launch_bounds__(256)
    fa_bwd_finish(const Args a, int Dreal, int Sqp, const float* acc, u16* dq,
                  int split, const float* part, int Skvp) {
  const int D = body_width(Dreal);
  i64 idx = (i64)blockIdx.x * 256 + threadIdx.x;
  const i64 n_dq = (i64)a.B * a.H * Sqp * D / 4;
  if (idx >= n_dq) {
    idx -= n_dq;
    if (split < 2 || idx >= (i64)a.B * a.Hkv * a.Skv * D / 4) return;
    const int c = (int)(idx % (D / 4)) * 4;
    if (c >= Dreal) return;
    i64 r = idx / (D / 4);
    const int kp = (int)(r % a.Skv);
    r /= a.Skv;
    const int hk = (int)(r % a.Hkv), b = (int)(r / a.Hkv);
    const i64 plane = (i64)split * a.B * a.Hkv * Skvp * D;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int sp = 0; sp < split; ++sp) {
      const i64 off = ((((i64)sp * a.B + b) * a.Hkv + hk) * Skvp + kp) * D + c;
      const float4 x = *reinterpret_cast<const float4*>(part + off);
      const float4 y = *reinterpret_cast<const float4*>(part + plane + off);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    u16* k = static_cast<u16*>(a.dk) + b * a.dks[0] + hk * a.dks[1] +
             (i64)kp * a.dks[2] + c;
    u16* v = static_cast<u16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1] +
             (i64)kp * a.dvs[2] + c;
    *reinterpret_cast<uint2*>(k) =
        make_uint2(pack_bf16(sk.x * a.scale, sk.y * a.scale),
                   pack_bf16(sk.z * a.scale, sk.w * a.scale));
    *reinterpret_cast<uint2*>(v) =
        make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
    return;
  }
  const int within = (int)(idx % 1024), i = within / WG, tid = within % WG;
  i64 piece = idx / 1024;
  const int db = (int)(piece % (D / 64));
  piece /= D / 64;
  const int qb = (int)(piece % (Sqp / 64));
  piece /= Sqp / 64;
  const int h = (int)(piece % a.H), b = (int)(piece / a.H);
  const int lane = tid % 32;
  const int row = qb * 64 + (tid / 32) * 16 + (lane >> 2);
  const int col = db * 64 + 8 * i + 2 * (lane & 3);
  if (col >= Dreal) return;
  const float4 v = reinterpret_cast<const float4*>(acc)[idx];
  u16* out = dq + b * a.outs[0] + h * a.outs[1] + col;
  if (row < a.Sq)
    *reinterpret_cast<uint32_t*>(out + (i64)row * a.outs[2]) =
        pack_bf16(v.x * a.scale, v.y * a.scale);
  if (row + 8 < a.Sq)
    *reinterpret_cast<uint32_t*>(out + (i64)(row + 8) * a.outs[2]) =
        pack_bf16(v.z * a.scale, v.w * a.scale);
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

// ---------------------------------------------------- float32 delta ------
// delta[b, h, q] = sum_d dO * O in f32; one warp per row
__global__ void __launch_bounds__(256) fa_delta_f32(Args a, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const i64 row = (i64)blockIdx.x * 8 + warp;
  if (row >= (i64)a.B * a.H * a.Sq) return;
  const int qp = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.H), b = (int)(row / a.Sq / a.H);
  const float* O = static_cast<const float*>(a.o) + b * a.os[0] +
                   h * a.os[1] + (i64)qp * a.os[2];
  const float* dO = static_cast<const float*>(a.dO) + b * a.dos[0] +
                    h * a.dos[1] + (i64)qp * a.dos[2];
  float x = 0.f;
  for (int c = lane; c < D; c += 32) x = fmaf(O[c], dO[c], x);
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

// bytes of L2 (50 MB on the H100) that the blocks in flight share: the
// tile orders group their work so that this much of the operands stays
// resident
constexpr double L2_SHARE = 40e6;

// SMs of the current device (the persistent grid's size)
int n_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
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
  return (dtype != 0 && dtype != 1) || (D != 64 && D != 80 && D != 128) ||
         B <= 0 ||
         Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0;
}

// DK: the kernel's width (D = 64, or 128 for 80 and 128); D: the tensors'
template <int DK>
int fwd(const Args& a, int D, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    typedef Fwd<DK> C;
    CUtensorMap qm, km, vm, om;
    if (!tensor_map(&qm, a.q, D, a.Sq, a.H, a.B, a.qs, C::BQ) ||
        !tensor_map(&km, a.k, D, a.Skv, a.Hkv, a.B, a.ks, C::BK) ||
        !tensor_map(&vm, a.v, D, a.Skv, a.Hkv, a.B, a.vs, C::BK) ||
        !tensor_map(&om, a.out, D, a.Sq, a.H, a.B, a.outs, 64))
      return (int)cudaErrorInvalidValue;
    static bool done = false;
    const int e = opt_in(fa_fwd_wgmma<DK>, C::SMEM, done);
    if (e) return e;
    const int nq = cdiv(a.Sq, C::BQ), n_tiles = nq * a.H * a.B;
    const int sms = n_sms();
    // a group: at least a round of the grid, and as many (head, batch)
    // units as share L2_SHARE bytes of K and V
    const int gh =
        max(cdiv(sms, nq), (int)(L2_SHARE / (4.0 * a.Skv * D / a.G)));
    fa_fwd_wgmma<DK><<<min(n_tiles, sms), N_THREADS, C::SMEM, s>>>(
        qm, km, vm, om, a, n_tiles, gh);
  } else {
    dim3 grid(cdiv(a.Sq, F_ROWS), a.H, a.B);
    if (D == 80)
      fa_fwd_f32<80><<<grid, F_NT, 0, s>>>(a);
    else
      fa_fwd_f32<DK><<<grid, F_NT, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dkdv_f32(const Args& a, cudaStream_t s) {
  dim3 grid(cdiv(a.Skv, F_ROWS), a.Hkv, a.B);
  fa_dkdv_f32<D><<<grid, F_NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int dq_f32(const Args& a, cudaStream_t s) {
  dim3 grid(cdiv(a.Sq, F_ROWS), a.H, a.B);
  fa_dq_f32<D><<<grid, F_NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DK>
int bwd_bf16(const Args& a, int D, int Sqp, const float* lse2,
             const float* dlt, float* acc, int split, float* part, int Skvp,
             cudaStream_t s) {
  typedef Bwd<DK> C;
  CUtensorMap qm, km, vm, dom, dkm, dvm;
  if (!tensor_map(&qm, a.q, D, a.Sq, a.H, a.B, a.qs, C::BQ) ||
      !tensor_map(&km, a.k, D, a.Skv, a.Hkv, a.B, a.ks, C::BK) ||
      !tensor_map(&vm, a.v, D, a.Skv, a.Hkv, a.B, a.vs, C::BK) ||
      !tensor_map(&dom, a.dO, D, a.Sq, a.H, a.B, a.dos, C::BQ) ||
      !tensor_map(&dkm, a.dk, D, a.Skv, a.Hkv, a.B, a.dks, 64) ||
      !tensor_map(&dvm, a.dv, D, a.Skv, a.Hkv, a.B, a.dvs, 64))
    return (int)cudaErrorInvalidValue;
  static bool done = false;
  const int e = opt_in(fa_bwd_wgmma<DK>, C::SMEM, done);
  if (e) return e;
  // a group: at least a wave of the grid, and as many units as share
  // L2_SHARE bytes of Q, dO and the f32 dQ accumulator
  const int nk = cdiv(a.Skv, C::BK);
  const int gh = max(cdiv(n_sms(), nk),
                     (int)(L2_SHARE / (8.0 * a.Sq * D * (a.G / split))));
  fa_bwd_wgmma<DK><<<nk * a.Hkv * a.B * split, N_THREADS, C::SMEM, s>>>(
      qm, km, vm, dom, dkm, dvm, a, lse2, dlt, acc, Sqp, split, part, Skvp,
      gh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  q [B, H, Sq, D], k and v [B, Hkv, Skv,
// D], o [B, H, Sq, D], each with element strides (b, h, s) and unit
// stride along D (bf16: strides multiples of 8 elements, 16-byte aligned
// pointers); lse a contiguous f32 [B, H, Sq].  D is 64, 80 or 128.  Each
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
  return D == 64 ? fwd<64>(a, D, dtype, s) : fwd<128>(a, D, dtype, s);
}

// ---- float32 backward: delta, then dK/dV, then dQ (three launches)
extern "C" int flash_attention_bwd_delta_launch(int dtype, const void* o,
                                                const void* dO, float* delta,
                                                int B, int H, int Sq, int D,
                                                i64 sob, i64 soh, i64 sos,
                                                i64 sdb, i64 sdh, i64 sds,
                                                void* stream) {
  if (dtype != 0 || B <= 0 || H <= 0 || Sq <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, 1, Sq, 1, 0, 0, 0.f);
  a.H = H;
  a.o = o;
  a.dO = dO;
  a.lse_out = delta;
  set3(a.os, sob, soh, sos);
  set3(a.dos, sdb, sdh, sds);
  const i64 rows = (i64)B * H * Sq;
  fa_delta_f32<<<(unsigned)((rows + 7) / 8), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(a, D);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dkdv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Skv, int D, i64 sqb, i64 sqh, i64 sqs, i64 skb,
    i64 skh, i64 sks, i64 svb, i64 svh, i64 svs, i64 sdb, i64 sdh, i64 sds,
    i64 skgb, i64 skgh, i64 skgs, i64 svgb, i64 svgh, i64 svgs, int causal,
    int window, float scale, void* stream) {
  if (dtype != 0 || bad_dims(dtype, B, H, Hkv, Sq, Skv, D))
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? dkdv_f32<64>(a, s)
                 : D == 80 ? dkdv_f32<80>(a, s) : dkdv_f32<128>(a, s);
}

extern "C" int flash_attention_bwd_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* delta, void* dq_out, int B, int H,
    int Hkv, int Sq, int Skv, int D, i64 sqb, i64 sqh, i64 sqs, i64 skb,
    i64 skh, i64 sks, i64 svb, i64 svh, i64 svs, i64 sdb, i64 sdh, i64 sds,
    i64 sgb, i64 sgh, i64 sgs, int causal, int window, float scale,
    void* stream) {
  if (dtype != 0 || bad_dims(dtype, B, H, Hkv, Sq, Skv, D))
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? dq_f32<64>(a, s)
                 : D == 80 ? dq_f32<80>(a, s) : dq_f32<128>(a, s);
}

// ---- bfloat16 backward: prep, the single pass, finish (three launches).
// Sqp: Sq rounded up to 128; lse2 and delta f32 [B, H, Sqp]; acc the f32
// dQ accumulator, B * H * Sqp * W floats in 64 x 64 pieces, W =
// body_width(D) (128 for D = 80).  split (a divisor of H / Hkv) slices
// each group's heads over that many blocks; above 1 the slices' f32 dK
// and dV go to part, 2 * split * B * Hkv * Skvp * W floats (Skvp: Skv
// rounded up to 128), and finish adds them.
extern "C" int flash_attention_bwd_bf16_prep_launch(
    const void* o, const void* dO, const float* lse, float* lse2,
    float* delta, float* acc, int B, int H, int Sq, int D, int Sqp, i64 sob,
    i64 soh, i64 sos, i64 sdb, i64 sdh, i64 sds, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || (D != 64 && D != 80 && D != 128) ||
      Sqp % 128 != 0 || Sqp < Sq)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, 1, Sq, 1, 0, 0, 0.f);
  a.H = H;
  a.o = o;
  a.dO = dO;
  a.lse = lse;
  set3(a.os, sob, soh, sos);
  set3(a.dos, sdb, sdh, sds);
  if (!(ok_strides(a.os) && ok_strides(a.dos) && aligned(o) && aligned(dO) &&
        aligned(acc)))
    return (int)cudaErrorInvalidValue;
  const i64 rows = (i64)B * H * Sqp;
  fa_bwd_prep<<<(unsigned)((rows + 7) / 8), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(a, D, Sqp, lse2, delta,
                                                     acc);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse2, const float* delta, float* acc, void* dk, void* dv,
    int B, int H, int Hkv, int Sq, int Skv, int D, int Sqp, i64 sqb, i64 sqh,
    i64 sqs, i64 skb, i64 skh, i64 sks, i64 svb, i64 svh, i64 svs, i64 sdb,
    i64 sdh, i64 sds, i64 skgb, i64 skgh, i64 skgs, i64 svgb, i64 svgh,
    i64 svgs, int causal, int window, float scale, int split, float* part,
    int Skvp, void* stream) {
  if (bad_dims(1, B, H, Hkv, Sq, Skv, D) || Sqp % 128 != 0 || Sqp < Sq ||
      split < 1 || (H / Hkv) % split != 0 || Skvp % 128 != 0 || Skvp < Skv)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, Hkv, Sq, Skv, causal, window, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.dk = dk;
  a.dv = dv;
  set3(a.qs, sqb, sqh, sqs);
  set3(a.ks, skb, skh, sks);
  set3(a.vs, svb, svh, svs);
  set3(a.dos, sdb, sdh, sds);
  set3(a.dks, skgb, skgh, skgs);
  set3(a.dvs, svgb, svgh, svgs);
  if (!(ok_strides(a.qs) && ok_strides(a.ks) && ok_strides(a.vs) &&
        ok_strides(a.dos) && ok_strides(a.dks) && ok_strides(a.dvs) &&
        aligned(q) && aligned(k) && aligned(v) && aligned(dO) &&
        aligned(dk) && aligned(dv) && aligned(acc) && aligned(lse2) &&
        aligned(delta) && aligned(part)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd_bf16<64>(a, D, Sqp, lse2, delta, acc, split, part,
                                Skvp, s)
                 : bwd_bf16<128>(a, D, Sqp, lse2, delta, acc, split, part,
                                 Skvp, s);
}

extern "C" int flash_attention_bwd_bf16_finish_launch(
    const float* acc, void* dq, const float* part, void* dk, void* dv, int B,
    int H, int Hkv, int Sq, int Skv, int D, int Sqp, int split, int Skvp,
    i64 sgb, i64 sgh, i64 sgs, i64 skgb, i64 skgh, i64 skgs, i64 svgb,
    i64 svgh, i64 svgs, float scale, void* stream) {
  if (bad_dims(1, B, H, Hkv, Sq, Skv, D) || Sqp % 128 != 0 || Sqp < Sq ||
      split < 1 || Skvp % 128 != 0 || Skvp < Skv)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, H, Hkv, Sq, Skv, 0, 0, scale);
  a.out = dq;
  a.dk = dk;
  a.dv = dv;
  set3(a.outs, sgb, sgh, sgs);
  set3(a.dks, skgb, skgh, skgs);
  set3(a.dvs, svgb, svgh, svgs);
  if (!(ok_strides(a.outs) && ok_strides(a.dks) && ok_strides(a.dvs) &&
        aligned(dq) && aligned(dk) && aligned(dv) && aligned(acc) &&
        aligned(part)))
    return (int)cudaErrorInvalidValue;
  const i64 W = body_width(D);
  const i64 n = (i64)B * H * Sqp * W / 4 +
                (split > 1 ? (i64)B * Hkv * Skv * W / 4 : 0);
  fa_bwd_finish<<<(unsigned)((n + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      a, D, Sqp, acc, static_cast<u16*>(dq), split, part, Skvp);
  return (int)cudaGetLastError();
}
