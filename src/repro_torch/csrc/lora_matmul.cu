// Fused LoRA matmul for Hopper (sm_90a):
//
//   out[M, N] = x[M, K] @ W[K, N] + s * round_T(x @ A)[M, r] @ B[r, N]
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py::lora_matmul
// (its pallas_call at :72, kernel body _kernel at :34): both products are
// summed in f32 over the K loop, x @ A is rounded to B's dtype T once,
// the low-rank product runs once in the epilogue, and the output is in
// T.  x, W, A and B share the dtype T (float or bfloat16; the wrapper
// casts the f32 LoRA leaves first, as repro/models/lora.py does).
//
// Every operand is passed with its two element strides, so the backward
// pass calls this same kernel on (dY, W^T, B^T, A^T) without a
// transposed copy of the shared base weights.  The ragged edges of M, N,
// K and r are masked here (out-of-range chunks load as zeros, stores are
// guarded); nothing is padded by the caller.
//
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16):
//   * decode (M = 8, K = N = 1024): bytes.  W alone is 2 MB, 0.63 us at
//     the memory rate; the 2*M*K*N = 17 MFLOP are nothing.
//   * train and prefill (M >= ~300): operations.  M = 3968 is 8.6 GFLOP
//     of base product, 8.7 us at the bf16 tensor-core rate.
//
// Design (see PERF.md for its times against those bounds):
//   * bfloat16: one thread block per [BM, BN] output tile, mma.sync
//     m16n8k16 on the tensor cores with f32 accumulators.  The K loop
//     keeps STAGES - 1 tiles of x, W and A in flight with cp.async
//     (16-byte chunks, zero-filled past the edges) while it multiplies
//     the tile that landed.  Shared tiles are laid out along each
//     operand's unit stride, padded by 8 elements, and read with
//     ldmatrix (.trans where that stride runs along N or r), so the
//     forward's row-major W, A, B and the backward's transposed views
//     both load coalesced and conflict-free.  Warps tile the block
//     WARPS_M x WARPS_N for x @ W; x @ A is split by rows, warp w owning
//     rows [16w, 16w + 16), so it is computed once per block.  Epilogue:
//     x @ A goes through shared memory rounded to bf16, B's [r, BN]
//     slice is staged beside it, and each warp adds s * (xa @ B) to its
//     accumulators with r/16 more MMAs per fragment.  The tile is the
//     largest that still gives every SM a block: 128 x 128 (8 warps),
//     64 x 64 (4 warps), 32 x 32 (2 warps).  M <= 16 (decode) takes
//     16 x 16 tiles, so N / 16 blocks stream W, each with eight warps
//     that split every staged tile's K depth between them (KS below) and
//     sum their accumulators through shared memory before the epilogue:
//     one warp alone could not keep enough of W in flight.
//   * float32: plain f32 FMAs (no TF32, so the card agrees with the CPU
//     to f32 rounding), 64 x 64 tiles, 4 x 4 outputs per thread, any
//     strides; the next K step's tiles are loaded into registers while
//     the current one is multiplied.  It serves the reduced float32
//     reference config only.
// Not yet: split-K across blocks (at M = 8, N / 16 blocks leave half the
// SMs idle), TMA and wgmma, a persistent schedule, an epilogue that
// stores 16 bytes a lane.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef long long i64;

// ------------------------------------------------------- bfloat16 -------
typedef unsigned short u16;

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register; bytes < 16 zero-fills
// the rest (0 for a chunk wholly outside the operand)
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

// four 8 x 8 b16 matrices from shared memory (lane i gives row i % 8 of
// matrix i / 8); TRANS hands each thread a column pair instead of a row
// pair
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

// one bf16 operand: unit stride along one dimension, `ld` elements along
// the other, logical [rows, cols]
struct Op16 {
  const u16* p;
  i64 ld;
  int rows, cols;
};

// Stage an R x C tile at (r0, c0) of `op` in shared memory with cp.async,
// one line per index of the strided dimension, along the unit-stride one
// (cols when UNIT_COLS, else rows), each line padded by 8 elements so the
// ldmatrix rows of a fragment fall on distinct banks.
template <int R, int C, bool UNIT_COLS, int NT>
__device__ __forceinline__ void stage(u16* s, const Op16& op, int r0,
                                      int c0, int tid) {
  constexpr int F = UNIT_COLS ? C : R;
  constexpr int L = UNIT_COLS ? R : C;
  constexpr int CH = F / 8, PITCH = F + 8;
  static_assert(F % 8 == 0, "lines of whole 16-byte chunks");
  const int l0 = UNIT_COLS ? r0 : c0, f0 = UNIT_COLS ? c0 : r0;
  const int nl = UNIT_COLS ? op.rows : op.cols;
  const int nf = UNIT_COLS ? op.cols : op.rows;
  for (int i = tid; i < L * CH; i += NT) {
    const int l = i / CH, f = (i % CH) * 8;
    const int gl = l0 + l, gf = f0 + f;
    int bytes = 0;
    const u16* src = op.p;
    if (gl < nl && gf < nf) {
      bytes = 2 * min(8, nf - gf);
      src = op.p + (i64)gl * op.ld + gf;
    }
    cp_async16(s + l * PITCH + f, src, bytes);
  }
}

// A fragment (16 x 16) at (row, k) of a [rows][k] tile of pitch P
template <int P>
__device__ __forceinline__ void frag_a(uint32_t* a, const u16* s, int row,
                                       int k, int lane) {
  const int j = lane / 8;
  ldsm4<false>(a, s + (row + lane % 8 + 8 * (j % 2)) * P + k + 8 * (j / 2));
}

// B fragments of the column pairs n and n + 8 (16 x 8 each) at depth k:
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

// Tile shape of one bf16 kernel.  KN: W, A and B have unit stride along
// their columns (the forward's row-major W [K,N], A [K,r], B [r,N]);
// otherwise along their rows (the backward's W^T, B^T, A^T views).  KS > 1
// (one 16-row warp tile only): KS warps each multiply BK / KS of every
// staged tile's depth, and warp 0 sums their accumulators at the end.
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_,
          int STAGES_, int RP_, bool KN_, int KS_ = 1>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, RP = RP_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool KN = KN_;
  static constexpr int KS = KS_, KW = BK / KS;
  static constexpr int NT = WARPS_M * WARPS_N * KS * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MF = WM / 16, NF = WN / 8;
  // pitches: x [BM][BK]; W [BK][BN] or [BN][BK]; A [BK][RP] or [RP][BK];
  // epilogue xa [BM][RP], B [RP][BN] or [BN][RP]
  static constexpr int PX = BK + 8;
  static constexpr int PW = KN ? BN + 8 : BK + 8;
  static constexpr int PA = KN ? RP + 8 : BK + 8;
  static constexpr int PXA = RP + 8;
  static constexpr int PB = KN ? BN + 8 : RP + 8;
  static constexpr int SX = BM * PX;
  static constexpr int SW = (KN ? BK : BN) * PW;
  static constexpr int SA = (KN ? BK : RP) * PA;
  static constexpr int STAGE = SX + SW + SA;
  static constexpr int EPI = BM * PXA + (KN ? RP : BN) * PB;
  // KS > 1: one f32 per lane for each accumulator of warps 1..KS-1
  static constexpr int PER = MF * NF * 4 + RP / 8 * 4;
  static constexpr int RED = 2 * (KS - 1) * 32 * PER;
  static constexpr int SMAX = STAGES * STAGE > EPI ? STAGES * STAGE : EPI;
  static constexpr int SMEM_BYTES = 2 * (SMAX > RED ? SMAX : RED);
  static_assert(BM == 16 * WARPS_M * WARPS_N, "x @ A: 16 rows per warp");
  static_assert(KS == 1 || (WARPS_M == 1 && WARPS_N == 1),
                "K split across the warps of a one-warp tile only");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && KW % 16 == 0 &&
                    KW * KS == BK && RP % 16 == 0 && STAGES >= 2,
                "fragment multiples");
};

template <class C>
__global__ void __launch_bounds__(C::NT)
lora_mma_kernel(Op16 X, Op16 W, Op16 A, Op16 B, u16* __restrict__ out,
                int M, int N, int K, float scaling) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, RP = C::RP;
  constexpr int MF = C::MF, NF = C::NF, NT = C::NT;
  constexpr bool KN = C::KN;
  extern __shared__ __align__(16) u16 smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // KS > 1: every warp owns the whole tile and the depth slice kw0
  const int wq = C::KS > 1 ? 0 : warp, kw0 = C::KS > 1 ? warp * C::KW : 0;
  const int wm = wq / C::WARPS_N, wn = wq % C::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + BK - 1) / BK;

  float acc[MF][NF][4];
  float xacc[RP / 8][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < RP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xacc[j][e] = 0.f;

  auto load = [&](int kt) {
    u16* s = smem + (kt % C::STAGES) * C::STAGE;
    const int k0 = kt * BK;
    stage<BM, BK, true, NT>(s, X, m0, k0, tid);
    stage<BK, BN, KN, NT>(s + C::SX, W, k0, n0, tid);
    stage<BK, RP, KN, NT>(s + C::SX + C::SW, A, k0, 0, tid);
  };

  // STAGES - 1 tiles in flight ahead of the one being multiplied
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < KT) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's buffer is free
    if (kt + C::STAGES - 1 < KT) load(kt + C::STAGES - 1);
    cp_async_commit();
    const u16* Xs = smem + (kt % C::STAGES) * C::STAGE;
    const u16* Ws = Xs + C::SX;
    const u16* As = Ws + C::SW;
#pragma unroll
    for (int k16 = 0; k16 < C::KW; k16 += 16) {
      const int kk = kw0 + k16;
      uint32_t af[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        frag_a<C::PX>(af[i], Xs, wm * C::WM + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        uint32_t b[4];
        frag_b2<KN, C::PW>(b, Ws, wn * C::WN + j * 8, kk, lane);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
      uint32_t xf[4];
      frag_a<C::PX>(xf, Xs, wq * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < RP / 8; j += 2) {
        uint32_t b[4];
        frag_b2<KN, C::PA>(b, As, j * 8, kk, lane);
        mma_bf16(xacc[j], xf, b[0], b[1]);
        mma_bf16(xacc[j + 1], xf, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the staged tiles

  if constexpr (C::KS > 1) {
    // warp 0 sums the other warps' depth slices, [accumulator][warp][lane]
    float* red = reinterpret_cast<float*>(smem);
    auto slot = [&](int e, int w) {
      return (e * (C::KS - 1) + w) * 32 + lane;
    };
    if (warp > 0) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[slot((i * NF + j) * 4 + e, warp - 1)] = acc[i][j][e];
#pragma unroll
      for (int j = 0; j < RP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[slot(MF * NF * 4 + j * 4 + e, warp - 1)] = xacc[j][e];
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 0; w < C::KS - 1; ++w) {
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] += red[slot((i * NF + j) * 4 + e, w)];
#pragma unroll
        for (int j = 0; j < RP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xacc[j][e] += red[slot(MF * NF * 4 + j * 4 + e, w)];
      }
    }
    __syncthreads();  // the sums are read before the epilogue reuses smem
  }

  // epilogue, over the staged tiles: this warp's 16 rows of x @ A
  // rounded to bf16, and B's [r, BN] slice
  u16* XAs = smem;
  u16* Bs = smem + BM * C::PXA;
  if (warp == wq) {  // with KS > 1, warp 0 holds the sums
#pragma unroll
    for (int j = 0; j < RP / 8; ++j) {
      u16* p = XAs + (wq * 16 + g) * C::PXA + j * 8 + 2 * t;
      p[0] = bf16_bits(xacc[j][0]);
      p[1] = bf16_bits(xacc[j][1]);
      p[8 * C::PXA] = bf16_bits(xacc[j][2]);
      p[8 * C::PXA + 1] = bf16_bits(xacc[j][3]);
    }
  }
  stage<RP, BN, KN, NT>(Bs, B, 0, n0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp != wq) return;

#pragma unroll
  for (int i = 0; i < MF; ++i) {
    uint32_t xf[RP / 16][4];
#pragma unroll
    for (int kr = 0; kr < RP / 16; ++kr)
      frag_a<C::PXA>(xf[kr], XAs, wm * C::WM + i * 16, kr * 16, lane);
    const int row = m0 + wm * C::WM + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      float low[2][4] = {};
#pragma unroll
      for (int kr = 0; kr < RP / 16; ++kr) {
        uint32_t b[4];
        frag_b2<KN, C::PB>(b, Bs, wn * C::WN + j * 8, kr * 16, lane);
        mma_bf16(low[0], xf[kr], b[0], b[1]);
        mma_bf16(low[1], xf[kr], b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + wn * C::WN + (j + h) * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + (e >= 2 ? 8 : 0), c = col + (e & 1);
          if (r < M && c < N)
            out[(i64)r * N + c] =
                bf16_bits(acc[i][j + h][e] + scaling * low[h][e]);
        }
      }
    }
  }
}

// -------------------------------------------------------- float32 -------
// one float32 operand: base pointer, logical [rows, cols] bounds and element
// strides; col_fast says which index the loaders vary fastest (the
// unit-stride one), so a transposed view loads coalesced too
struct Mat {
  const void* p;
  i64 s0, s1;
  int rows, cols;
  int col_fast;
};

// An R x C tile of a strided matrix, loaded into registers (E elements a
// thread) and stored into shared memory at dst[r * ldr + c * ldc].  NT is
// a multiple of R and of C, so a thread keeps one index of the fast
// dimension and steps the slow one by NT / (fast extent): one base
// address and one stride per tile, not an address per element.
template <int R, int C, int NT>
struct Tile {
  static_assert(NT % R == 0 && NT % C == 0, "tile must split over threads");
  static constexpr int E = R * C / NT;
  float v[E];

  // the thread's first (r, c) and its step in r and c from one element
  // to the next
  __device__ __forceinline__ static void walk(bool col_fast, int tid,
                                              int& r, int& c, int& dr,
                                              int& dc) {
    if (col_fast) {
      r = tid / C;
      c = tid % C;
      dr = NT / C;
      dc = 0;
    } else {
      r = tid % R;
      c = tid / R;
      dr = 0;
      dc = NT / R;
    }
  }

  __device__ __forceinline__ void load(const Mat& m, int r0, int c0,
                                       int tid) {
    int r, c, dr, dc;
    walk(m.col_fast, tid, r, c, dr, dc);
    r += r0;
    c += c0;
    const float* q =
        static_cast<const float*>(m.p) + (i64)r * m.s0 + (i64)c * m.s1;
    const i64 step = (i64)dr * m.s0 + (i64)dc * m.s1;
#pragma unroll
    for (int i = 0; i < E; ++i)
      v[i] = (r + i * dr < m.rows && c + i * dc < m.cols) ? q[i * step]
                                                          : 0.f;
  }

  __device__ __forceinline__ void store(float* dst, int ldr, int ldc,
                                        bool col_fast, int tid) const {
    int r, c, dr, dc;
    walk(col_fast, tid, r, c, dr, dc);
    float* d = dst + r * ldr + c * ldc;
    const int step = dr * ldr + dc * ldc;
#pragma unroll
    for (int i = 0; i < E; ++i) d[i * step] = v[i];
  }
};

template <int RP>
__global__ void __launch_bounds__(256)
lora_fma_kernel(Mat X, Mat W, Mat A, Mat B, float* __restrict__ out, int M,
                int N, int K, float scaling) {
  constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
  constexpr int LDX = BM + 4, LDXA = RP + 1;
  __shared__ float Xs[BK * LDX];          // [k][m]
  __shared__ float Ws[BK * BN];           // [k][n]
  __shared__ float As[BK * RP];           // [k][r]
  __shared__ float XAs[BM * LDXA];        // [m][r]
  __shared__ float Bs[RP * BN];           // [r][n]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // x @ W: rows ty + 16i
  const int xr = tid % BM, xc = tid / BM;     // x @ A: row xr, cols xc + 4j
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[4][4] = {};
  float xacc[RP / 4] = {};
  Tile<BM, BK, NT> lx;
  Tile<BK, BN, NT> lw;
  Tile<BK, RP, NT> la;
  lx.load(X, m0, 0, tid);
  lw.load(W, 0, n0, tid);
  la.load(A, 0, 0, tid);
  lx.store(Xs, 1, LDX, X.col_fast, tid);
  lw.store(Ws, BN, 1, W.col_fast, tid);
  la.store(As, RP, 1, A.col_fast, tid);
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) {
      lx.load(X, m0, k0 + BK, tid);
      lw.load(W, k0 + BK, n0, tid);
      la.load(A, k0 + BK, 0, tid);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[k * LDX + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      const float xv = Xs[k * LDX + xr];
#pragma unroll
      for (int j = 0; j < RP / 4; ++j)
        xacc[j] = fmaf(xv, As[k * RP + xc + 4 * j], xacc[j]);
    }
    __syncthreads();
    if (more) {
      lx.store(Xs, 1, LDX, X.col_fast, tid);
      lw.store(Ws, BN, 1, W.col_fast, tid);
      la.store(As, RP, 1, A.col_fast, tid);
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < RP / 4; ++j) XAs[xr * LDXA + xc + 4 * j] = xacc[j];
  {
    Tile<RP, BN, NT> lb;
    lb.load(B, 0, n0, tid);
    lb.store(Bs, BN, 1, B.col_fast, tid);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float low = 0.f;
      for (int q = 0; q < RP; ++q)
        low = fmaf(XAs[(ty + 16 * i) * LDXA + q], Bs[q * BN + tx + 16 * j],
                   low);
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(i64)r * N + c] = acc[i][j] + scaling * low;
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <class C>
int launch_mma(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
               void* out, int M, int N, int K, float scaling,
               cudaStream_t s) {
  static bool opted_in = false;  // shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid(cdiv(M, C::BM), cdiv(N, C::BN));
  lora_mma_kernel<C><<<grid, C::NT, C::SMEM_BYTES, s>>>(
      X, W, A, B, static_cast<u16*>(out), M, N, K, scaling);
  return (int)cudaGetLastError();
}

// the tile that still gives the card a block per SM, largest first:
// 128 x 128 (8 warps), 64 x 64 (4 warps), 32 x 32 (2 warps); decode-sized
// M takes 16 x 16 tiles so N / 16 blocks stream W, 8 warps splitting K
template <int RP, bool KN>
int launch_bf16(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
                void* out, int M, int N, int K, float scaling,
                cudaStream_t s) {
  if (M <= 16)
    return launch_mma<Cfg<16, 16, 128, 1, 1, 4, RP, KN, 8>>(
        X, W, A, B, out, M, N, K, scaling, s);
  if ((i64)cdiv(M, 128) * cdiv(N, 128) >= 132)
    return launch_mma<Cfg<128, 128, 32, 4, 2, 3, RP, KN>>(
        X, W, A, B, out, M, N, K, scaling, s);
  if ((i64)cdiv(M, 64) * cdiv(N, 64) >= 132)
    return launch_mma<Cfg<64, 64, 64, 2, 2, 3, RP, KN>>(
        X, W, A, B, out, M, N, K, scaling, s);
  return launch_mma<Cfg<32, 32, 64, 1, 2, 4, RP, KN>>(
      X, W, A, B, out, M, N, K, scaling, s);
}

template <int RP>
int launch_f32(const Mat& X, const Mat& W, const Mat& A, const Mat& B,
               void* out, int M, int N, int K, float scaling,
               cudaStream_t s) {
  dim3 grid(cdiv(M, 64), cdiv(N, 64));
  lora_fma_kernel<RP><<<grid, 256, 0, s>>>(
      X, W, A, B, static_cast<float*>(out), M, N, K, scaling);
  return (int)cudaGetLastError();
}

Mat mat(const void* p, i64 s0, i64 s1, int rows, int cols) {
  Mat m;
  m.p = p;
  m.s0 = s0;
  m.s1 = s1;
  m.rows = rows;
  m.cols = cols;
  // vary the unit-stride index fastest; rows only when they are it
  m.col_fast = !(s0 == 1 && s1 != 1);
  return m;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a bf16 operand with unit stride along cols (kn) or rows (!kn), its
// other stride a whole number of 16-byte chunks, 16-byte aligned
bool op16(Op16& o, const void* p, i64 s0, i64 s1, int rows, int cols,
          bool kn) {
  const i64 unit = kn ? s1 : s0, ld = kn ? s0 : s1;
  o.p = static_cast<const u16*>(p);
  o.ld = ld;
  o.rows = rows;
  o.cols = cols;
  return unit == 1 && ld % 8 == 0 && aligned(p);
}

}  // namespace

// dtype 0: float32 (any strides), 1: bfloat16 (x with unit stride along
// K; W, A and B all with unit stride along their columns or all along
// their rows; the other strides multiples of 8 elements, pointers 16-byte
// aligned).  Strides are in elements; out is a contiguous [M, N] tensor
// of the same dtype.  Returns cudaGetLastError() after the launch (0 when
// it was accepted), cudaErrorInvalidValue for operands it does not take.
extern "C" int lora_matmul_launch(int dtype, const void* x, const void* w,
                                  const void* a, const void* b, void* out,
                                  int M, int N, int K, int r, i64 sxm,
                                  i64 sxk, i64 swk, i64 swn, i64 sak,
                                  i64 sar, i64 sbr, i64 sbn, float scaling,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || r <= 0 || r > 64 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Mat X = mat(x, sxm, sxk, M, K), W = mat(w, swk, swn, K, N);
    const Mat A = mat(a, sak, sar, K, r), B = mat(b, sbr, sbn, r, N);
    if (r <= 16) return launch_f32<16>(X, W, A, B, out, M, N, K, scaling, s);
    if (r <= 32) return launch_f32<32>(X, W, A, B, out, M, N, K, scaling, s);
    return launch_f32<64>(X, W, A, B, out, M, N, K, scaling, s);
  }
  Op16 X, W, A, B;
  if (!op16(X, x, sxm, sxk, M, K, true)) return (int)cudaErrorInvalidValue;
  const bool kn = swn == 1 && sar == 1 && sbn == 1;
  if (!(op16(W, w, swk, swn, K, N, kn) && op16(A, a, sak, sar, K, r, kn) &&
        op16(B, b, sbr, sbn, r, N, kn)))
    return (int)cudaErrorInvalidValue;
  if (kn)
    return r <= 16
               ? launch_bf16<16, true>(X, W, A, B, out, M, N, K, scaling, s)
               : launch_bf16<64, true>(X, W, A, B, out, M, N, K, scaling, s);
  return r <= 16
             ? launch_bf16<16, false>(X, W, A, B, out, M, N, K, scaling, s)
             : launch_bf16<64, false>(X, W, A, B, out, M, N, K, scaling, s);
}
