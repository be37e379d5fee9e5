// The LoRA matmul kernels shared by lora_matmul.cu and
// segmented_lora_matmul.cu (sm_90a):
//
//   out[m, :] = x[m] @ W + s * round_T(x[m] @ A[slot(m)]) @ B[slot(m)]
//
// over NA adapter slots A [NA][K, r], B [NA][r, N] (one slot for the
// single-adapter lora_matmul).  slot(m) is idx[m], clamped to the last
// slot; a row with idx[m] < 0 (or past M) takes no low-rank term, and
// without idx every row takes slot 0.  Both products are summed in f32
// over the K loop, x @ A is rounded to B's dtype T once, and the output is
// in T.  The select happens AFTER the products: a row only ever adds its
// own slot's (x @ A) @ B, so other slots' values, even NaN, never reach it.
//
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16):
//   * decode (M <= 16): bytes.  At qwen1.5-0.5b's q/k/v/o (M 8, K = N =
//     1,024) W alone is 2 MB, 0.63 us at the memory rate, and the
//     low-rank slots add 2 * 32 KB each at r = 16; at the VLM's q/o (K =
//     N = 8,192) W is 128 MB, 40 us.
//   * train and prefill (M >= ~300): operations.  M = 3968 is 8.6 GFLOP
//     of base product, 8.7 us at the bf16 tensor-core rate.
//
// Design, bfloat16, M <= 16 (dec_body; PERF.md has its times against
// those bounds): the transposed product out^T = W^T x^T, so 64 columns of
// W are the MMA's M (each staged K row of W is 128 contiguous bytes) and
// the <= 16 rows of x its N (one fragment of 8 when M <= 8).  K is split
// across blocks, about two blocks per SM at every decode shape of the
// port (kernels/lora_matmul.py::decode_split_plan, a function of K and N
// alone, splits on 16-row steps); a block streams its chunk of W, x and A
// through a four-stage cp.async ring (64-row stages with one slot at
// r <= 16, 32-row where several slots' A tiles share a stage; the
// grouping of the copies does not change the order of the MMAs), and
// writes f32 partials of x @ W and of x @ A to a workspace.  The last
// block of each 64-column tile to finish (a ticket counter, reset by that
// block, so no memset per call) sums the partials in split order
// (deterministic: no float atomics), sixteen splits' loads in flight at a
// time, rounds x @ A over the whole of K to bf16 once, and adds
// s * (x @ A) @ B from the B slice every block prefetched at its start.
// Adapter slots run the same path with the same split: each slot the rows
// use gets its own x @ A partial and (x @ A_s) @ B_s product, kept for
// the rows of slot s, so a row is bitwise lora_matmul of its own slot.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md,
// cold L2): the VLM's q/o (M 8, K = N = 8,192) 144 -> 75 us (bound 40.3,
// cuBLAS's merged-weight product 58); qwen1.5-0.5b's q/k/v/o 12.3 ->
// 12.8 us (merged 9.0): at 2 MB of W the time is the chain of round
// trips (the loads, the partials' writes and ticket, the last block's
// reads), not the bytes, and more splits lengthen it (chip_smoke.py
// splits: 8 splits 11.7 us, 16 12.8, 32 17.9).  Tried in bring-up builds
// and dropped: deeper rings (fewer blocks fit an SM, and the memory
// system gave no more), 128-column tiles (faster at the VLM's q/o only),
// all of a tile's splits' loads in flight at once (more registers than
// four blocks an SM allow).  Before this design (one block of 8 warps per
// 16 output columns, the warps splitting each staged K tile; 64 blocks
// at N = 1,024) half the SMs sat idle.
//
// Design, bfloat16, M > 16 (mma_body; not yet redesigned for Hopper):
//   * one thread block per [BM, BN] output tile, mma.sync
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
//     64 x 64 (4 warps), 32 x 32 (2 warps).
//   * Adapter slots (NA > 1): each slot's A and B tiles are staged as a
//     sub-tile of their own, read through the slot strides (the stacks
//     are never concatenated).  A block stages only the slots its rows
//     use, a warp multiplies x @ A only for the slots its 16 rows use,
//     and each epilogue fragment runs (x @ A_s) @ B_s from a zero
//     accumulator for every slot s among its rows, then keeps it for the
//     rows of slot s alone.  So a row's low-rank term is the same
//     sequence of MMAs as lora_matmul's with that slot's A and B, and its
//     base product the same tile and K order at the same M: the output
//     is bitwise lora_matmul's, and a row of idx < 0 bitwise
//     lora_matmul's with B = 0.  A tile whose rows are all < 0 does no
//     low-rank work.  Shared memory is sized at launch for the call's
//     slots.  With one slot (lora_matmul) the row select compiles away
//     and the stage stride stays a compile-time constant: a runtime
//     stride alone cost the 128 x 128 tile 30% (PERF.md).
//   * Not yet: wgmma fed by TMA with the low-rank product fused into its
//     epilogue (2-5x cuBLAS's base-only product at mamba2's ssm_in),
//     a persistent schedule, 16-byte epilogue stores, a per-row gather of
//     the slots (the low-rank work grows with the number of slots a
//     tile's rows use).
// Design, float32: plain f32 FMAs (no TF32, so the card agrees with the
// CPU to f32 rounding), 64 x 64 tiles, 4 x 4 outputs per thread, any
// strides; the next K step's tiles are loaded into registers while the
// current one is multiplied.  A thread sums x @ A for its row's own slot
// only; the epilogue stages one slot's B at a time.  It serves the
// reduced float32 reference config only.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// bit of a row's slot in a mask of slots (0 for a base-only row)
__device__ __forceinline__ unsigned slot_bit(int s) {
  return s >= 0 ? 1u << s : 0u;
}

// the slot a row reads: idx clamped to the last slot, -1 for base only
// and for rows past M; slot 0 for every row without idx
__device__ __forceinline__ int row_slot(const int* idx, int row, int M,
                                        int na) {
  if (idx == nullptr) return 0;
  if (row >= M) return -1;
  const int s = idx[row];
  return s < 0 ? -1 : (s < na ? s : na - 1);
}

// ------------------------------------------------------- bfloat16 -------
typedef unsigned short u16;

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// 16 bytes global -> shared without a register; bytes < 16 zero-fills
// the rest (0 for a chunk wholly outside the operand)
__device__ __forceinline__ void cp_async16(u16* dst, const u16* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldsm4 at a shared-memory pointer
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t* r, const u16* p) {
  ldsm4<TRANS>(r, smem_u32(p));
}

// one bf16 operand: unit stride along one dimension, `ld` elements along
// the other, logical [rows, cols]
struct Op16 {
  const u16* p;
  i64 ld;
  int rows, cols;
};

// the same operand `step` elements further on (the next adapter slot)
__device__ __forceinline__ Op16 shifted(Op16 op, i64 step) {
  op.p += step;
  return op;
}

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
// otherwise along their rows (the backward's W^T, B^T, A^T views).
// NA: adapter slots, each with A and B sub-tiles of RP columns / rows.
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_,
          int STAGES_, int RP_, bool KN_, int NA_ = 1>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, RP = RP_, NA = NA_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool KN = KN_;
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MF = WM / 16, NF = WN / 8;
  // pitches: x [BM][BK]; W [BK][BN] or [BN][BK]; each slot's A [BK][RP]
  // or [RP][BK]; epilogue xa [BM][NA * RP], each slot's B [RP][BN] or
  // [BN][RP]
  static constexpr int PX = BK + 8;
  static constexpr int PW = KN ? BN + 8 : BK + 8;
  static constexpr int PA = KN ? RP + 8 : BK + 8;
  static constexpr int PXA = NA * RP + 8;
  static constexpr int PB = KN ? BN + 8 : RP + 8;
  static constexpr int SX = BM * PX;
  static constexpr int SW = (KN ? BK : BN) * PW;
  static constexpr int SA1 = (KN ? BK : RP) * PA;
  static constexpr int SB1 = (KN ? RP : BN) * PB;
  // shared memory for na <= NA slots (a launch sizes it for the slots
  // the call has, so fewer slots leave room for more blocks per SM): a
  // stage of x, W and na A tiles; the epilogue's xa and na B tiles
  __host__ __device__ static constexpr int stage_elems(int na) {
    return SX + SW + na * SA1;
  }
  // with slots, the rows' slots (BM ints) lie ahead of the tiles
  static constexpr int ROWS = NA > 1 ? 2 * BM : 0;
  __host__ __device__ static constexpr int smem_bytes(int na) {
    const int loop = STAGES * stage_elems(na);
    const int epi = BM * PXA + na * SB1;
    return 2 * (ROWS + (loop > epi ? loop : epi));
  }
  static_assert(BM == 16 * WARPS_M * WARPS_N, "x @ A: 16 rows per warp");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0 &&
                    RP % 16 == 0 && STAGES >= 2,
                "fragment multiples");
  static_assert(NA >= 1 && NA <= 32, "slot masks are 32 bits");
};

// A and B are slot 0's operands; slot s lies sa (sb) elements further on.
// idx: [M] int32 row slots on the device, or nullptr (every row slot 0).
template <class C>
__device__ __forceinline__ void mma_body(Op16 X, Op16 W, Op16 A, Op16 B,
                                         i64 sa, i64 sb,
                                         const int* __restrict__ idx, int na,
                                         u16* __restrict__ out, int M, int N,
                                         int K, float scaling) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, RP = C::RP;
  constexpr int MF = C::MF, NF = C::NF, NT = C::NT, NA = C::NA;
  constexpr bool KN = C::KN;
  constexpr bool SEG = NA > 1;  // one slot: every row takes slot 0
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) u16 smem_all[];
  int* rslot = reinterpret_cast<int*>(smem_all);
  u16* smem = smem_all + C::ROWS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // one slot: a compile-time stride, so the tile addresses fold
  const int STAGE = C::stage_elems(SEG ? na : 1);
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + BK - 1) / BK;

  // the slots of the block's rows (staged) and of this warp's x @ A rows
  unsigned bmask = 1u, wmask = 1u;
  if constexpr (SEG) {
    for (int i = tid; i < BM; i += NT)
      rslot[i] = row_slot(idx, m0 + i, M, na);
    __syncthreads();
    unsigned bits = 0;
    for (int i = lane; i < BM; i += 32) bits |= slot_bit(rslot[i]);
    bmask = __reduce_or_sync(FULL, bits);
    wmask = __reduce_or_sync(
        FULL, lane < 16 ? slot_bit(rslot[warp * 16 + lane]) : 0u);
  }

  float acc[MF][NF][4];
  float xacc[NA][RP / 8][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < NA; ++s)
#pragma unroll
    for (int j = 0; j < RP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[s][j][e] = 0.f;

  auto load = [&](int kt) {
    u16* st = smem + (kt % C::STAGES) * STAGE;
    const int k0 = kt * BK;
    stage<BM, BK, true, NT>(st, X, m0, k0, tid);
    stage<BK, BN, KN, NT>(st + C::SX, W, k0, n0, tid);
#pragma unroll
    for (int s = 0; s < NA; ++s)
      if (bmask >> s & 1u)
        stage<BK, RP, KN, NT>(st + C::SX + C::SW + s * C::SA1,
                              shifted(A, s * sa), k0, 0, tid);
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
    const u16* Xs = smem + (kt % C::STAGES) * STAGE;
    const u16* Ws = Xs + C::SX;
    const u16* As = Ws + C::SW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
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
      if (wmask) {
        uint32_t xf[4];
        frag_a<C::PX>(xf, Xs, warp * 16, kk, lane);
#pragma unroll
        for (int s = 0; s < NA; ++s) {
          if (!(wmask >> s & 1u)) continue;
#pragma unroll
          for (int j = 0; j < RP / 8; j += 2) {
            uint32_t b[4];
            frag_b2<KN, C::PA>(b, As + s * C::SA1, j * 8, kk, lane);
            mma_bf16(xacc[s][j], xf, b[0], b[1]);
            mma_bf16(xacc[s][j + 1], xf, b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the staged tiles

  // epilogue, over the staged tiles: this warp's 16 rows of x @ A for
  // each slot they use, rounded to bf16, and each used slot's [r, BN]
  // slice of B
  u16* XAs = smem;
  u16* Bs = smem + BM * C::PXA;
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    if (!(wmask >> s & 1u)) continue;
#pragma unroll
    for (int j = 0; j < RP / 8; ++j) {
      u16* p = XAs + (warp * 16 + g) * C::PXA + s * RP + j * 8 + 2 * t;
      p[0] = bf16_bits(xacc[s][j][0]);
      p[1] = bf16_bits(xacc[s][j][1]);
      p[8 * C::PXA] = bf16_bits(xacc[s][j][2]);
      p[8 * C::PXA + 1] = bf16_bits(xacc[s][j][3]);
    }
  }
#pragma unroll
  for (int s = 0; s < NA; ++s)
    if (bmask >> s & 1u)
      stage<RP, BN, KN, NT>(Bs + s * C::SB1, shifted(B, s * sb), 0, n0, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MF; ++i) {
    const int rl = wm * C::WM + i * 16 + g;
    const int s0 = SEG ? rslot[rl] : 0, s1 = SEG ? rslot[rl + 8] : 0;
    const unsigned fmask =
        SEG ? __reduce_or_sync(FULL, slot_bit(s0) | slot_bit(s1)) : 1u;
    uint32_t xf[NA][RP / 16][4];
#pragma unroll
    for (int s = 0; s < NA; ++s) {
      if (!(fmask >> s & 1u)) continue;
#pragma unroll
      for (int kr = 0; kr < RP / 16; ++kr)
        frag_a<C::PXA>(xf[s][kr], XAs, wm * C::WM + i * 16, s * RP + kr * 16,
                       lane);
    }
    const int row = m0 + rl;
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      float low[2][4] = {};
#pragma unroll
      for (int s = 0; s < NA; ++s) {
        if (!(fmask >> s & 1u)) continue;
        // d += (x @ A_s) @ B_s for the column pairs j and j + 1
        auto product = [&](float (&d)[2][4]) {
#pragma unroll
          for (int kr = 0; kr < RP / 16; ++kr) {
            uint32_t b[4];
            frag_b2<KN, C::PB>(b, Bs + s * C::SB1, wn * C::WN + j * 8,
                               kr * 16, lane);
            mma_bf16(d[0], xf[s][kr], b[0], b[1]);
            mma_bf16(d[1], xf[s][kr], b[2], b[3]);
          }
        };
        if constexpr (SEG) {
          float part[2][4] = {};
          product(part);
          // keep slot s's product for the rows of slot s alone
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (s0 == s) low[h][0] = part[h][0], low[h][1] = part[h][1];
            if (s1 == s) low[h][2] = part[h][2], low[h][3] = part[h][3];
          }
        } else {
          product(low);  // one slot: every row's
        }
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

// one body, two names, so a profile tells lora_matmul's launches (one
// slot) from segmented_lora_matmul's
#define MMA_ARGS                                                            \
  Op16 X, Op16 W, Op16 A, Op16 B, i64 sa, i64 sb,                           \
      const int *__restrict__ idx, int na, u16 *__restrict__ out, int M,    \
      int N, int K, float scaling
template <class C>
__global__ void __launch_bounds__(C::NT) lora_mma_kernel(MMA_ARGS) {
  mma_body<C>(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling);
}
template <class C>
__global__ void __launch_bounds__(C::NT) segmented_mma_kernel(MMA_ARGS) {
  mma_body<C>(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling);
}
#undef MMA_ARGS

// ------------------------------------------- bfloat16, M <= 16 (decode) ---
// The transposed product out^T = W^T x^T per 64-column tile of W: the
// tile's columns are the MMA's M (four warps, 16 columns each), the
// M <= 16 rows of x its N (one or two fragments of 8), K its depth.  K is
// split across blocks (grid: N tiles x splits, the plan from the wrapper,
// a function of K and N alone); each block streams its chunk of K through
// a cp.async ring and writes f32 partials of x @ W and of x @ A (for every
// slot its rows use) to a workspace.  The last block of each N tile,
// found by a ticket counter it resets, sums the partials in split order,
// rounds x @ A once, and adds s * (x @ A) @ B from the B slice every
// block prefetched at its start.
struct Dec {
  static constexpr int BN = 64, NT = 128, MAX_SPLITS = 32;
};

template <int RP_, bool KN_, int NA_>
struct DecCfg {
  static constexpr int RP = RP_, NA = NA_, BN = Dec::BN;
  static constexpr bool KN = KN_;
  static constexpr int NT = Dec::NT;
  // rows of K a stage and stages of the ring: how the copies are grouped
  // and how far they run ahead, not the order of the MMAs, so one slot
  // (64-row stages) and many (32, where na A tiles share the stage) sum
  // alike
  static constexpr int BK = NA * RP <= 32 ? 64 : 32;
  static constexpr int STAGES = 4;
  // pitches (elements): x [16][BK]; W [BK][BN] or [BN][BK]; A per slot
  // [BK][RP] or [RP][BK]; B per slot [RP][BN] or [BN][RP]; xa [16][NA RP]
  static constexpr int PX = BK + 8;
  static constexpr int PW = KN ? BN + 8 : BK + 8;
  static constexpr int PA = KN ? RP + 8 : BK + 8;
  static constexpr int PB = KN ? BN + 8 : RP + 8;
  static constexpr int PXA = NA * RP + 8;
  static constexpr int SX = 16 * PX;
  static constexpr int SW = (KN ? BK : BN) * PW;
  static constexpr int SA1 = (KN ? BK : RP) * PA;
  static constexpr int SB1 = (KN ? RP : BN) * PB;
  // (slot, 16 rows of r) pairs of x @ A, dealt round the four warps
  static constexpr int PAIRS = NA * RP / 16, PPW = (PAIRS + 3) / 4;
  __host__ __device__ static constexpr int stage_elems(int na) {
    return SX + SW + na * SA1;
  }
  // rows' slots (32 u16), the B slices, then the ring (which the
  // epilogue's sums and xa reuse)
  __host__ __device__ static constexpr int smem_bytes(int na) {
    const int ring = STAGES * stage_elems(na);
    const int epi = 2 * BN * 16 + 16 * PXA;  // f32 sums, then xa
    return 2 * (32 + na * SB1 + (ring > epi ? ring : epi));
  }
  // f32 workspace record of one (N tile, split): x @ W [BN][16], then
  // x @ A [na][RP][16]
  __host__ __device__ static constexpr int record(int na) {
    return BN * 16 + na * RP * 16;
  }
};

// A fragment (16 x 16) of op^T at (c0, k0), from a shared tile of op
// stored [k][c] (KN) or [c][k], pitch P
template <bool KN, int P>
__device__ __forceinline__ void frag_t(uint32_t* a, const u16* s, int c0,
                                       int k0, int lane) {
  const int j = lane / 8, i = lane % 8;
  if (KN)
    ldsm4<true>(a, s + (k0 + i + 8 * (j / 2)) * P + c0 + 8 * (j % 2));
  else
    ldsm4<false>(a, s + (c0 + i + 8 * (j % 2)) * P + k0 + 8 * (j / 2));
}

template <class C>
__device__ __forceinline__ void dec_body(Op16 X, Op16 W, Op16 A, Op16 B,
                                         i64 sa, i64 sb,
                                         const int* __restrict__ idx, int na,
                                         u16* __restrict__ out, int M, int N,
                                         int K, float scaling, int splits,
                                         int chunk, float* __restrict__ ws,
                                         int* __restrict__ tickets) {
  constexpr int BN = C::BN, BK = C::BK, RP = C::RP, NA = C::NA, NT = C::NT;
  constexpr bool KN = C::KN, SEG = NA > 1;
  extern __shared__ __align__(16) u16 smem_all[];
  int* rslot = reinterpret_cast<int*>(smem_all);       // [16]
  u16* Bs = smem_all + 32;                             // na x SB1
  u16* ring = Bs + na * C::SB1;
  __shared__ int last_flag;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n0 = tile * BN, k_lo = split * chunk;
  const int k_hi = min(K, k_lo + chunk);
  const int KT = (k_hi - k_lo + BK - 1) / BK;
  // a split ends on a 16-row step, not always on a stage: its last stage
  // reads zeros past k_hi
  X.cols = k_hi;
  W.rows = k_hi;
  A.rows = k_hi;
  const bool two = M > 8;  // a second fragment of 8 rows
  // one slot: a compile-time stride, so the tile addresses fold
  const int STAGE = C::stage_elems(SEG ? na : 1);

  if (tid < 16) rslot[tid] = row_slot(idx, tid, M, na);
  __syncthreads();
  unsigned bmask = 1u;
  if constexpr (SEG) {
    bmask = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) bmask |= slot_bit(rslot[i]);
  }

  // the B slices of the slots the rows use, for whichever block finishes
  // the tile last
#pragma unroll
  for (int s = 0; s < NA; ++s)
    if (bmask >> s & 1u)
      stage<RP, BN, KN, NT>(Bs + s * C::SB1, shifted(B, s * sb), 0, n0, tid);
  auto load = [&](int kt) {
    u16* st = ring + (kt % C::STAGES) * STAGE;
    const int k0 = k_lo + kt * BK;
    stage<16, BK, true, NT>(st, X, 0, k0, tid);
    stage<BK, BN, KN, NT>(st + C::SX, W, k0, n0, tid);
#pragma unroll
    for (int s = 0; s < NA; ++s)
      if (bmask >> s & 1u)
        stage<BK, RP, KN, NT>(st + C::SX + C::SW + s * C::SA1,
                              shifted(A, s * sa), k0, 0, tid);
  };
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < KT) load(st);
    cp_async_commit();  // the B slices ride in the first group
  }

  float acc[2][4] = {};           // x @ W: columns 16 warp + g (+8), rows
  float xacc[C::PPW][2][4] = {};  // x @ A: the warp's (slot, r) pairs
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's buffer is free
    if (kt + C::STAGES - 1 < KT) load(kt + C::STAGES - 1);
    cp_async_commit();
    const u16* Xs = ring + (kt % C::STAGES) * STAGE;
    const u16* Ws = Xs + C::SX;
    const u16* As = Ws + C::SW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t xb[4];  // x^T: rows 0-7 in xb[0..1], rows 8-15 in xb[2..3]
      frag_b2<false, C::PX>(xb, Xs, 0, kk, lane);
      uint32_t a[4];
      frag_t<KN, C::PW>(a, Ws, 16 * warp, kk, lane);
      mma_bf16(acc[0], a, xb[0], xb[1]);
      if (two) mma_bf16(acc[1], a, xb[2], xb[3]);
#pragma unroll
      for (int q = 0; q < C::PPW; ++q) {
        const int p = warp + 4 * q, s = p / (RP / 16);
        if (p < C::PAIRS && (bmask >> s & 1u)) {
          frag_t<KN, C::PA>(a, As + s * C::SA1, 16 * (p % (RP / 16)), kk,
                            lane);
          mma_bf16(xacc[q][0], a, xb[0], xb[1]);
          if (two) mma_bf16(xacc[q][1], a, xb[2], xb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the B slices landed; every warp is done with the ring

  // this split's partials: C fragments (column or r = 16m + g (+8), row
  // 8f + 2t (+1)) as float2 at [column][row]
  const int R = C::record(SEG ? na : 1);
  float* rec = ws + ((size_t)tile * splits + split) * R;
  auto put = [&](float* base, int c, const float (&f)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !two) break;
      *reinterpret_cast<float2*>(base + (c + g) * 16 + 8 * h + 2 * t) =
          make_float2(f[h][0], f[h][1]);
      *reinterpret_cast<float2*>(base + (c + g + 8) * 16 + 8 * h + 2 * t) =
          make_float2(f[h][2], f[h][3]);
    }
  };
  put(rec, 16 * warp, acc);
#pragma unroll
  for (int q = 0; q < C::PPW; ++q) {
    const int p = warp + 4 * q, s = p / (RP / 16);
    if (p < C::PAIRS && (bmask >> s & 1u))
      put(rec + BN * 16 + s * RP * 16, 16 * (p % (RP / 16)), xacc[q]);
  }

  // the last of the tile's splits to finish sums them all (the barrier
  // orders the block's writes before thread 0's fence, which is
  // cumulative)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int done = atomicAdd(tickets + tile, 1) == splits - 1;
    if (done) tickets[tile] = 0;  // ready for the next launch
    last_flag = done;
  }
  __syncthreads();
  if (!last_flag) return;
  __threadfence();

  // Sums over the splits in split order, four floats an item, the loads
  // of sixteen splits of an item in flight before their adds.  Items: x @ W's
  // [BN][16] (rows 0-7 only when M <= 8) into shared f32 sums, then
  // x @ A's [slot][RP][16] of the slots the rows use, rounded to bf16 once
  // into XAs [row][slot * RP + r] for the low-rank product.
  const float* rec0 = ws + (size_t)tile * splits * R;
  float* sums = reinterpret_cast<float*>(ring);
  u16* XAs = ring + 2 * BN * 16;
  const int quads = two ? 4 : 2;  // float4s of a column's rows
  const int n_base = BN * quads;
  for (int i = tid; i < n_base + na * RP * quads; i += NT) {
    const int col = i / quads, q4 = i % quads;  // col: BN + slot * RP + r
    const int s = col < BN ? -1 : (col - BN) / RP;
    if (s >= 0 && !(bmask >> s & 1u)) continue;
    const float* src = rec0 + col * 16 + 4 * q4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += 16) {
      float4 u[16];
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (sp0 + q < splits)
          u[q] = __ldcg(reinterpret_cast<const float4*>(
              src + (size_t)(sp0 + q) * R));
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (sp0 + q < splits) {
          v.x += u[q].x;
          v.y += u[q].y;
          v.z += u[q].z;
          v.w += u[q].w;
        }
    }
    if (s < 0) {
      *reinterpret_cast<float4*>(sums + col * 16 + 4 * q4) = v;
    } else {
      u16* x = XAs + (4 * q4) * C::PXA + s * RP + (col - BN) % RP;
      x[0] = bf16_bits(v.x);
      x[C::PXA] = bf16_bits(v.y);
      x[2 * C::PXA] = bf16_bits(v.z);
      x[3 * C::PXA] = bf16_bits(v.w);
    }
  }
  __syncthreads();
  // this warp's columns of x @ W, as the accumulator fragments
  float sum[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sum[h][e] = sums[(16 * warp + g + (e >= 2 ? 8 : 0)) * 16 + 8 * h +
                       2 * t + (e & 1)];

  // s * (x @ A_s) @ B_s for each slot s the rows use, kept for the rows
  // of slot s alone; out = round(x @ W + s * low)
  float low[2][4] = {};
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    if (!(bmask >> s & 1u)) continue;
    float part[2][4] = {};
#pragma unroll
    for (int kr = 0; kr < RP; kr += 16) {
      uint32_t xb[4], a[4];
      frag_b2<false, C::PXA>(xb, XAs, 0, s * RP + kr, lane);
      frag_t<KN, C::PB>(a, Bs + s * C::SB1, 16 * warp, kr, lane);
      mma_bf16(part[0], a, xb[0], xb[1]);
      if (two) mma_bf16(part[1], a, xb[2], xb[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!SEG || rslot[8 * h + 2 * t + (e & 1)] == s) low[h][e] = part[h][e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * h + 2 * t + (e & 1);
      const int col = n0 + 16 * warp + g + (e >= 2 ? 8 : 0);
      if (row < M && col < N)
        out[(i64)row * N + col] = bf16_bits(sum[h][e] + scaling * low[h][e]);
    }
}

#define DEC_ARGS                                                            \
  Op16 X, Op16 W, Op16 A, Op16 B, i64 sa, i64 sb,                           \
      const int *__restrict__ idx, int na, u16 *__restrict__ out, int M,    \
      int N, int K, float scaling, int splits, int chunk,                   \
      float *__restrict__ ws, int *__restrict__ tickets
template <class C>
__global__ void __launch_bounds__(Dec::NT) lora_dec_kernel(DEC_ARGS) {
  dec_body<C>(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling, splits,
              chunk, ws, tickets);
}
template <class C>
__global__ void __launch_bounds__(Dec::NT) segmented_dec_kernel(DEC_ARGS) {
  dec_body<C>(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling, splits,
              chunk, ws, tickets);
}
#undef DEC_ARGS

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

__device__ __forceinline__ Mat shifted(Mat m, i64 step) {
  m.p = static_cast<const float*>(m.p) + step;
  return m;
}

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

// A and B are slot 0's operands, slot s sa (sb) elements further on; idx
// as for mma_body.  The loop's tiles and the epilogue's share one shared
// buffer.
template <int RP, int NA>
__device__ __forceinline__ void fma_body(Mat X, Mat W, Mat A, Mat B, i64 sa,
                                         i64 sb, const int* __restrict__ idx,
                                         int na, float* __restrict__ out,
                                         int M, int N, int K,
                                         float scaling) {
  constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
  constexpr int LDX = BM + 4, LDXA = RP + 1, CA = NA * RP;
  constexpr int LOOP = BK * LDX + BK * BN + BK * CA;
  constexpr int EPI = BM * LDXA + RP * BN;
  __shared__ float sm[LOOP > EPI ? LOOP : EPI];
  __shared__ int rslot[BM];
  float* Xs = sm;                  // [k][m]
  float* Ws = Xs + BK * LDX;       // [k][n]
  float* As = Ws + BK * BN;        // [k][slot * RP + r]
  float* XAs = sm;                 // [m][r], the row's own slot
  float* Bs = sm + BM * LDXA;      // [r][n], one slot at a time

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // x @ W: rows ty + 16i
  const int xr = tid % BM, xc = tid / BM;     // x @ A: row xr, cols xc + 4j
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (tid < BM) rslot[tid] = row_slot(idx, m0 + tid, M, na);
  __syncthreads();
  unsigned bmask = 0;
  for (int i = 0; i < BM; ++i) bmask |= slot_bit(rslot[i]);
  const int xs = rslot[xr];

  float acc[4][4] = {};
  float xacc[RP / 4] = {};
  Tile<BM, BK, NT> lx;
  Tile<BK, BN, NT> lw;
  Tile<BK, RP, NT> la[NA];
  auto load = [&](int k0) {
    lx.load(X, m0, k0, tid);
    lw.load(W, k0, n0, tid);
#pragma unroll
    for (int s = 0; s < NA; ++s)
      if (bmask >> s & 1u) la[s].load(shifted(A, s * sa), k0, 0, tid);
  };
  auto store = [&]() {
    lx.store(Xs, 1, LDX, X.col_fast, tid);
    lw.store(Ws, BN, 1, W.col_fast, tid);
#pragma unroll
    for (int s = 0; s < NA; ++s)
      if (bmask >> s & 1u) la[s].store(As + s * RP, CA, 1, A.col_fast, tid);
  };
  load(0);
  store();
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
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
      if (xs >= 0) {
        const float xv = Xs[k * LDX + xr];
        const float* ak = As + k * CA + xs * RP + xc;
#pragma unroll
        for (int j = 0; j < RP / 4; ++j) xacc[j] = fmaf(xv, ak[4 * j], xacc[j]);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // the loop's tiles are dead: x @ A of each row's own slot, then one
  // slot's B at a time for the outputs of that slot's rows
#pragma unroll
  for (int j = 0; j < RP / 4; ++j) XAs[xr * LDXA + xc + 4 * j] = xacc[j];
  float low[4][4] = {};
  for (int s = 0; s < NA; ++s) {
    if (!(bmask >> s & 1u)) continue;
    {
      Tile<RP, BN, NT> lb;
      lb.load(shifted(B, s * sb), 0, n0, tid);
      __syncthreads();  // XAs written; the previous slot's Bs read
      lb.store(Bs, BN, 1, B.col_fast, tid);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rslot[ty + 16 * i] != s) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float l = 0.f;
        for (int q = 0; q < RP; ++q)
          l = fmaf(XAs[(ty + 16 * i) * LDXA + q], Bs[q * BN + tx + 16 * j],
                   l);
        low[i][j] = l;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(i64)r * N + c] = acc[i][j] + scaling * low[i][j];
    }
  }
}

#define FMA_ARGS                                                            \
  Mat X, Mat W, Mat A, Mat B, i64 sa, i64 sb, const int *__restrict__ idx, \
      int na, float *__restrict__ out, int M, int N, int K, float scaling
template <int RP, int NA>
__global__ void __launch_bounds__(256) lora_fma_kernel(FMA_ARGS) {
  fma_body<RP, NA>(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling);
}
template <int RP, int NA>
__global__ void __launch_bounds__(256) segmented_fma_kernel(FMA_ARGS) {
  fma_body<RP, NA>(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling);
}
#undef FMA_ARGS

// the kernel of a tile shape: segmented_* for more than one slot
template <class C>
auto mma_kernel() {
  if constexpr (C::NA > 1)
    return segmented_mma_kernel<C>;
  else
    return lora_mma_kernel<C>;
}
template <class C>
auto dec_kernel() {
  if constexpr (C::NA > 1)
    return segmented_dec_kernel<C>;
  else
    return lora_dec_kernel<C>;
}
template <int RP, int NA>
auto fma_kernel() {
  if constexpr (NA > 1)
    return segmented_fma_kernel<RP, NA>;
  else
    return lora_fma_kernel<RP, NA>;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <class C>
int launch_mma(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
               i64 sa, i64 sb, const int* idx, int na, void* out, int M,
               int N, int K, float scaling, cudaStream_t s) {
  constexpr int max_bytes = C::smem_bytes(C::NA);
  static_assert(max_bytes <= 232448, "shared memory per block");
  const auto kernel = mma_kernel<C>();
  static bool opted_in = false;  // shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid(cdiv(M, C::BM), cdiv(N, C::BN));
  kernel<<<grid, C::NT, C::smem_bytes(na), s>>>(
      X, W, A, B, sa, sb, idx, na, static_cast<u16*>(out), M, N, K,
      scaling);
  return (int)cudaGetLastError();
}

// The decode path (M <= 16): a grid of (N / 64 tiles, splits) blocks, the
// split of K from the caller (a multiple of 16 rows a split, every split
// non-empty), an f32 workspace of record(na) floats per (tile,
// split) and one int32 ticket per tile, zero before the first launch
// (each launch leaves them zero).
template <int RP, bool KN, int NA>
int launch_dec(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
               i64 sa, i64 sb, const int* idx, int na, void* out, int M,
               int N, int K, float scaling, int splits, int chunk, void* ws,
               void* tickets, cudaStream_t s) {
  typedef DecCfg<RP, KN, NA> C;
  if (ws == nullptr || tickets == nullptr || splits < 1 ||
      splits > Dec::MAX_SPLITS ||
      chunk < 1 || chunk % 16 != 0 || (i64)(splits - 1) * chunk >= K ||
      (i64)splits * chunk < K)
    return (int)cudaErrorInvalidValue;
  constexpr int max_bytes = C::smem_bytes(C::NA);
  static_assert(max_bytes <= 232448, "shared memory per block");
  const auto kernel = dec_kernel<C>();
  static bool opted_in = false;  // shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid(cdiv(N, C::BN), splits);
  kernel<<<grid, Dec::NT, C::smem_bytes(na), s>>>(
      X, W, A, B, sa, sb, idx, na, static_cast<u16*>(out), M, N, K, scaling,
      splits, chunk, static_cast<float*>(ws), static_cast<int*>(tickets));
  return (int)cudaGetLastError();
}

// M <= 16 (decode) takes the split-K decode path; larger M the tile that
// still gives the card a block per SM, largest first: 128 x 128 (8
// warps), 64 x 64 (4 warps), 32 x 32 (2 warps).  The choice depends on M,
// K and N alone, so a row sums in the same order whatever the number of
// slots; STAGES (only how far the copies run ahead) drops to 3 where NA
// slots' A tiles would not fit four deep.  NA: the most slots the call may
// have (na <= NA).
template <int RP, bool KN, int NA>
int launch_bf16(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
                i64 sa, i64 sb, const int* idx, int na, void* out, int M,
                int N, int K, float scaling, int splits, int chunk, void* ws,
                void* tickets, cudaStream_t s) {
  if (M <= 16)
    return launch_dec<RP, KN, NA>(X, W, A, B, sa, sb, idx, na, out, M, N, K,
                                  scaling, splits, chunk, ws, tickets, s);
  if ((i64)cdiv(M, 128) * cdiv(N, 128) >= 132)
    return launch_mma<Cfg<128, 128, 32, 4, 2, 3, RP, KN, NA>>(
        X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling, s);
  if ((i64)cdiv(M, 64) * cdiv(N, 64) >= 132)
    return launch_mma<Cfg<64, 64, 64, 2, 2, 3, RP, KN, NA>>(
        X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling, s);
  return launch_mma<Cfg<32, 32, 64, 1, 2, 4, RP, KN, NA>>(
      X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling, s);
}

template <int RP, int NA>
int launch_f32(const Mat& X, const Mat& W, const Mat& A, const Mat& B,
               i64 sa, i64 sb, const int* idx, int na, void* out, int M,
               int N, int K, float scaling, cudaStream_t s) {
  const auto kernel = fma_kernel<RP, NA>();
  dim3 grid(cdiv(M, 64), cdiv(N, 64));
  kernel<<<grid, 256, 0, s>>>(
      X, W, A, B, sa, sb, idx, na, static_cast<float*>(out), M, N, K,
      scaling);
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
