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
//   * train and prefill (M >= ~300): operations.  M = 3968 is 8.3 GFLOP
//     of base product, 8.4 us at the bf16 tensor-core rate.
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
// Design, bfloat16, M > 16 (wg_body): a persistent, warp-specialised
// wgmma GEMM with the low-rank product in its epilogue.
//   * One block per SM (the tile plan, kernels/lora_matmul.py::
//     mma_tile_plan, a function of M, K and N alone) walks 128 x BN output
//     tiles, BN 256, 192, 128 or 64 (the fewest rounds of the widest
//     tiles, by a cost model of shared-memory traffic), in groups of 8 M
//     tiles so the blocks in flight share W and x in L2.
//   * A producer warp keeps a ring of 2-8 stages (as many as shared memory
//     holds) in flight with TMA (3-D tensor maps over the operands' own
//     strides, 128-byte swizzle; A's 16-column tile at r <= 16 with a
//     32-byte swizzle): x [128][64], W [64][BN] in 64-column regions
//     (MN-major: the forward's row-major W) or [BN][64] (K-major: the
//     backward's W^T view, never copied), and the A tile of each slot the
//     tile's rows use.  Ragged M, N and K read as zeros from the maps;
//     nothing is padded by the caller.
//   * Two consumer warpgroups of 64 rows: per stage four m64nBNk16 wgmma
//     for x @ W and four m64nRPk16 (RP = 16 or 64: r padded) for x @ A_s
//     from the same staged x, one commit group in flight behind the one
//     being issued; stages go back to the producer by mbarrier.
//   * Epilogue, 32 columns at a time: x @ A_s rounded to bf16 once (in
//     registers, the A operand) times B_s's slice (TMA-loaded per tile,
//     after the tile's stages) by RP/16 more wgmma into a fragment of its
//     own; out = round(x @ W + s * low), with s applied to the f32
//     product (never folded into x @ A: s need not be a power of two).
//     The tile's accumulator is only read there: writing it between
//     wgmma would serialize every wgmma of the kernel (ptxas C7515).
//     The bf16 tile is staged swizzled in shared memory and leaves by TMA
//     stores (by 16-bit stores where N is no multiple of 8), overlapping
//     the next tile's main loop.
//   * Adapter slots (NA > 1): the same code with a row select.  A tile
//     stages the A and B tiles of the slots its rows use (read in place
//     through the stacks' slot strides), a warpgroup multiplies x @ A_s
//     for the slots of its 64 rows, and each row keeps its own slot's
//     low-rank product; rows of idx < 0 take round(x @ W).  lora_matmul
//     is the NA = 1 instance: the same tile plan, K order and wgmma
//     sequence, so a segmented row is bitwise lora_matmul of its slot.
//     Shared memory and the ring depth are sized for NA at compile time.
//   * Bring-up runs on an NVIDIA H100 80GB HBM3 at 700 W (cold L2; PERF.md
//     has the A/B against the parent): qwen1.5-0.5b's q/k/v/o at M 3,968
//     22.6 us (parent 66.9, merged-weight cuBLAS 19.1), M 16,384 67.8
//     (54.3); llama3-8b's q/o at 2,048 rows 116 (95); mamba2's ssm_in at
//     2,048 rows 99 (parent 278, base-only 65).  What holds it back:
//     shared-memory bandwidth (x @ A reads the staged x a second time,
//     11-17% of the time in builds without it), wave quantization (ssm_in:
//     416 tiles on 132 SMs), an epilogue that does not overlap the tensor
//     cores, and at most 168 registers a thread (384 threads a block; the
//     segmented kernel spills at 8 slots or r > 16 with BN 192-256, C7512).
//     Tried and dropped: each M tile's first N tile handing its x @ A to
//     the others (the waiting and the injected fences cost more than the
//     reads saved, but at ssm_in), blocks walking contiguous tile ranges
//     to reuse x @ A (x re-read from HBM: L2 does not keep the panels).
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
#include <string.h>

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

// ------------------------------------------- bfloat16, M > 16 (wgmma) ---
// A persistent, warp-specialised GEMM: two consumer warpgroups of 64 rows
// each own a 128 x BN output tile; a producer warp keeps a ring of ST
// stages (x [128][64], W [64][BN], each used slot's A [64][RP]) in
// flight with TMA.  Per stage each consumer issues x @ W as four
// m64nBNk16 wgmma and, for each slot its rows use, x @ A_s as four
// m64nRPk16, all into f32 registers.  Epilogue: x @ A_s rounded to bf16
// in registers is the A operand of RP/16 more wgmma against B_s [RP][BN]
// (double- or single-buffered per tile), kept for the rows of slot s
// alone and added as out = x @ W + s * low; the bf16 tile then leaves
// through shared memory in 16-byte stores.
template <int BN_, int RP_, bool KN_, int NA_>
struct WgCfg {
  static constexpr int BM = 128, BK = 64, BN = BN_, RP = RP_, NA = NA_;
  static constexpr bool KN = KN_, SEG = NA > 1;
  static constexpr int TB = KN ? 1 : 0;  // B operands MN-major (forward)
  // bytes: x [BM][64] K-major; W [64][BN] in 64-column regions (KN) or
  // [BN][64]; each slot's A [64][RP] (KN) or [RP][64]; each slot's B
  // [RP][BN] in 64-column regions (KN) or [BN][RP]
  static constexpr int X_BYTES = BM * 128, W_BYTES = BN * 128;
  static constexpr int A_BYTES = RP * 128, B_BYTES = RP * BN * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES + NA * A_BYTES;
  static constexpr int BBUF = NA * B_BYTES;
  __host__ __device__ static constexpr int bytes(int st, int nb, int oc) {
    return st * STAGE + nb * BBUF + BM * oc * 2 + 8 * (2 * st + 2 * nb) + 1024;
  }
  static constexpr int CAP = 232448;  // shared memory a block may have
  __host__ __device__ static constexpr bool fits(int st, int oc) {
    return bytes(st, 1, oc) <= CAP;
  }
  // the deepest ring that fits (how far the copies run ahead, never the
  // order of the products), the output leaving through shared memory OC
  // columns at a time (64-column regions of 128-byte rows, 128-byte
  // swizzle, as a TMA store reads them), 128 if that still fits, then a
  // second B buffer if it still fits
  static constexpr int ST = fits(8, 64)   ? 8
                            : fits(7, 64) ? 7
                            : fits(6, 64) ? 6
                            : fits(5, 64) ? 5
                            : fits(4, 64) ? 4
                            : fits(3, 64) ? 3
                                          : 2;
  static constexpr int OC = BN != 256 && fits(ST, BN)   ? BN
                            : BN == 256 && fits(ST, 128) ? 128
                                                         : 64;
  static constexpr int OUT_BYTES = BM * OC * 2;
  static constexpr int NB = bytes(ST, 2, OC) <= CAP ? 2 : 1;
  static constexpr int SMEM = bytes(ST, NB, OC);
  static constexpr int OFF_B = ST * STAGE, OFF_OUT = OFF_B + NB * BBUF,
                       OFF_BAR = OFF_OUT + OUT_BYTES;
  static_assert(SMEM <= CAP, "shared memory per block");
  static_assert(BN == 64 || BN == 128 || BN == 192 || BN == 256,
                "tile widths");
  static_assert(RP == 16 || RP == 64, "padded ranks");
  static_assert(NA >= 1 && NA <= 32, "slot masks are 32 bits");
};

constexpr int WG_NT = 384;  // two consumer warpgroups and a producer

// Output tile t of a walk that takes the M tiles in groups of `group` and,
// inside a group, every N tile of the group's first M tile, then of the
// next: the blocks in flight share W's columns and x's rows in L2.  Block
// b takes tiles b, b + G, b + 2 G, ... of the G blocks; the wrapper's
// kernels/lora_matmul.py::mma_tile mirrors it
__device__ __forceinline__ void tile_mn(int t, int tiles_m, int tiles_n,
                                        int group, int& tm, int& tn) {
  const int per = group * tiles_n, first = (t / per) * group;
  const int size = min(group, tiles_m - first), j = t % per;
  tm = first + j % size;
  tn = j / size;
}

template <class C>
__device__ __forceinline__ void wg_body(
    const CUtensorMap* xm, const CUtensorMap* wm, const CUtensorMap* am,
    const CUtensorMap* bm, const CUtensorMap* om, const int* __restrict__ idx,
    int na, u16* __restrict__ out, int M, int N, int K, float scaling,
    int group) {
  constexpr int BM = C::BM, BN = C::BN, RP = C::RP, NA = C::NA, ST = C::ST,
                NB = C::NB, TB = C::TB;
  constexpr bool KN = C::KN, SEG = C::SEG;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sB = base + C::OFF_B;
  const uint32_t full = base + C::OFF_BAR, empty = full + 8 * ST,
                 bfull = empty + 8 * ST, bempty = bfull + 8 * NB;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n, KT = (K + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < NB; ++b) {
      mbar_init(bfull + 8 * b, 1);
      mbar_init(bempty + 8 * b, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: warp 8 loads
    regs_dec<40>();
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x % 32;
    int it = 0;  // stages loaded so far
    for (int lt = 0;; ++lt) {
      const int t = blockIdx.x + lt * gridDim.x;
      if (t >= n_tiles) break;
      int tm, tn;
      tile_mn(t, tiles_m, tiles_n, group, tm, tn);
      const int m0 = tm * BM, n0 = tn * BN;
      unsigned bmask = 1u;  // the slots of the tile's rows
      if constexpr (SEG) {
        unsigned bits = 0;
#pragma unroll
        for (int q = 0; q < BM / 32; ++q)
          bits |= slot_bit(row_slot(idx, m0 + lane + 32 * q, M, na));
        bmask = __reduce_or_sync(FULL, bits);
      }
      const uint32_t a_tx = __popc(bmask) * C::A_BYTES;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int st = it % ST, k0 = kt * C::BK;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t bar = full + 8 * st, dst = base + st * C::STAGE;
          mbar_expect_tx(bar, C::X_BYTES + C::W_BYTES + a_tx);
          tma_load3(dst, xm, bar, k0, m0, 0);
          const uint32_t dw = dst + C::X_BYTES, da = dw + C::W_BYTES;
          if (KN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load3(dw + j * 8192, wm, bar, n0 + 64 * j, k0, 0);
          } else {
            tma_load3(dw, wm, bar, k0, n0, 0);
          }
#pragma unroll
          for (int s = 0; s < NA; ++s)
            if (bmask >> s & 1u) {
              if (KN)
                tma_load3(da + s * C::A_BYTES, am, bar, 0, k0, s);
              else
                tma_load3(da + s * C::A_BYTES, am, bar, k0, 0, s);
            }
        }
        __syncwarp();
      }
      // the tile's B slices, for its epilogue, after its stages: by then
      // the consumers are done with the buffer's previous tile
      const int bb = lt % NB;
      mbar_wait(bempty + 8 * bb, ((lt / NB) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t bar = bfull + 8 * bb, dst = sB + bb * C::BBUF;
        if (bmask == 0u) {
          mbar_arrive(bar);
        } else {
          mbar_expect_tx(bar, __popc(bmask) * C::B_BYTES);
#pragma unroll
          for (int s = 0; s < NA; ++s)
            if (bmask >> s & 1u) {
              if (KN) {
#pragma unroll
                for (int j = 0; j < BN / 64; ++j)
                  tma_load3(dst + s * C::B_BYTES + j * RP * 128, bm, bar,
                            n0 + 64 * j, 0, s);
              } else {
                tma_load3(dst + s * C::B_BYTES, bm, bar, 0, n0, s);
              }
            }
        }
      }
      __syncwarp();
    }
    return;
  }

  // two consumer warpgroups, 64 rows each
  regs_inc<232>();
  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  // this warpgroup's 64 rows of staged output, and whether they leave by
  // TMA (N a multiple of 8: the map's row stride is whole 16 bytes) or
  // by stores clipped here
  const uint32_t so = base + C::OFF_OUT + w * 64 * C::OC * 2;
  const bool tma_out = N % 8 == 0;
  float acc[BN / 2], part[16], xacc[NA][RP / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) part[i] = 0.f;
#pragma unroll
  for (int s = 0; s < NA; ++s)
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) xacc[s][i] = 0.f;

  int it = 0;  // stages consumed so far
  for (int lt = 0;; ++lt) {
    const int t = blockIdx.x + lt * gridDim.x;
    if (t >= n_tiles) break;
    int tm, tn;
    tile_mn(t, tiles_m, tiles_n, group, tm, tn);
    const int m0 = tm * BM, n0 = tn * BN, r_lo = m0 + 64 * w;
    // the slots of this warpgroup's rows, and of this thread's two rows
    unsigned wmask = 1u;
    int s0 = 0, s1 = 0;
    if constexpr (SEG) {
      wmask = __reduce_or_sync(
          FULL, slot_bit(row_slot(idx, r_lo + lane, M, na)) |
                    slot_bit(row_slot(idx, r_lo + lane + 32, M, na)));
      s0 = row_slot(idx, r_lo + warp * 16 + g, M, na);
      s1 = row_slot(idx, r_lo + warp * 16 + g + 8, M, na);
    }
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int st = it % ST;
      mbar_wait(full + 8 * st, (it / ST) & 1);
      const uint32_t sx = base + st * C::STAGE + w * 64 * 128;
      const uint32_t sw = base + st * C::STAGE + C::X_BYTES;
      const uint32_t sa = sw + C::W_BYTES;
      keep(acc);
#pragma unroll
      for (int s = 0; s < NA; ++s) keep(xacc[s]);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<BN, 0, TB>(acc, sw128(sx + kk * 32, 16, 1024),
                          KN ? sw128(sw + kk * 2048, 8192, 1024)
                             : sw128(sw + kk * 32, 16, 1024),
                          (kt | kk) != 0);
#pragma unroll
      for (int s = 0; s < NA; ++s) {
        if (!(wmask >> s & 1u)) continue;
        const uint32_t a = sa + s * C::A_BYTES;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<RP, 0, TB>(xacc[s], sw128(sx + kk * 32, 16, 1024),
                            !KN        ? sw128(a + kk * 32, 16, 1024)
                            : RP == 16 ? sw32(a + kk * 512)
                                       : sw128(a + kk * 2048, 8192, 1024),
                            (kt | kk) != 0);
      }
      wg_commit();
      if (kt > 0) {  // the previous stage's products are done
        wg_wait<1>();
        if (tid == 0) mbar_arrive(empty + 8 * ((it - 1) % ST));
      }
    }
    wg_wait<0>();
    keep(acc);
#pragma unroll
    for (int s = 0; s < NA; ++s) keep(xacc[s]);
    if (tid == 0) mbar_arrive(empty + 8 * ((it - 1) % ST));

    // Epilogue, OC columns at a time through shared memory (the
    // warpgroup's last pass has left it): for each 32 columns and each
    // slot s of the warpgroup's rows, low = round(x @ A_s) @ B_s (RP/16
    // wgmma, A from registers), and the rows of slot s take
    // round(x @ W + s * low); rows of no slot take round(x @ W).  The
    // tile's accumulator is only read here (a register a later wgmma
    // accumulates into, written between wgmma, would serialize them all).
    // Then TMA stores (or, N no multiple of 8, stores clipped here).
    const int bb = lt % NB;
    mbar_wait(bfull + 8 * bb, (lt / NB) & 1);
    const uint32_t sb = sB + bb * C::BBUF;
    constexpr int OC = C::OC, CH = OC / 8;  // 16-byte chunks per row
    // the staged pair (e, e + 1) at column 8 j + 2 t4 of row warp * 16 + g
    // + 8 r: 64-column regions, the 16-byte chunks of row q XORed with q % 8
    auto put = [&](int j, int r, float lo, float hi) {
      const int q = warp * 16 + g + 8 * r;
      st_u32(so + (j / 8) * 8192 + q * 128 + (((j % 8) ^ (q & 7)) << 4) +
                 4 * t4,
             pack_bf16(lo, hi));
    };
    // x @ A_s rounded to bf16 once: the A operand of the low-rank wgmma
    uint32_t f[NA][RP / 4];
#pragma unroll
    for (int s = 0; s < NA; ++s) to_frags<RP>(f[s], xacc[s]);
#pragma unroll
    for (int hc = 0; hc < BN / OC; ++hc) {
      if (tma_out && tid == 0) bulk_wait_read();  // the last store read it
      named_sync(1 + w, 128);
#pragma unroll
      for (int h = 0; h < OC / 32; ++h) {
        const int c32 = hc * OC / 32 + h;  // the tile's 32-column chunk
        if constexpr (SEG) {
#pragma unroll
          for (int i = 0; i < 16; i += 2)
            if (((i >> 1) & 1 ? s1 : s0) < 0)
              put(4 * h + i / 4, (i >> 1) & 1, acc[16 * c32 + i],
                  acc[16 * c32 + i + 1]);
        }
#pragma unroll
        for (int s = 0; s < NA; ++s) {
          if (!(wmask >> s & 1u)) continue;
          // B_s's columns 32 c32 on: half c32 % 2 of region c32 / 2 (KN)
          // or rows 32 c32 on
          const uint32_t b =
              sb + s * C::B_BYTES +
              (KN ? (c32 / 2) * RP * 128 + (c32 % 2) * 64 : c32 * RP * 64);
          keep(part);
          keep(f[s]);
          wg_arrive();
#pragma unroll
          for (int kr = 0; kr < RP / 16; ++kr)
            mma_rs<32, TB>(part, &f[s][4 * kr],
                           KN         ? sw128(b + kr * 2048, RP * 128, 1024)
                           : RP == 16 ? sw32(b)
                                      : sw128(b + kr * 32, 16, 1024),
                           kr > 0);
          wg_commit();
          wg_wait<0>();
          keep(part);
          keep(f[s]);
#pragma unroll
          for (int i = 0; i < 16; i += 2)
            if (!SEG || ((i >> 1) & 1 ? s1 : s0) == s)
              put(4 * h + i / 4, (i >> 1) & 1,
                  fmaf(scaling, part[i], acc[16 * c32 + i]),
                  fmaf(scaling, part[i + 1], acc[16 * c32 + i + 1]));
        }
      }
      const int c0 = n0 + hc * OC;
      if (tma_out) {
        fence_async_smem();
        named_sync(1 + w, 128);
        if (tid == 0) {
#pragma unroll
          for (int j = 0; j < OC / 64; ++j)
            tma_store3(om, so + j * 8192, c0 + 64 * j, r_lo, 0);
          bulk_commit();
        }
      } else {
        named_sync(1 + w, 128);
#pragma unroll 4
        for (int c = tid; c < 64 * CH; c += 128) {
          const int q = c / CH, j = c % CH, row = r_lo + q, col = c0 + 8 * j;
          if (row >= M || col >= N) continue;
          uint4 v;
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                       : "r"(so + (j / 8) * 8192 + q * 128 +
                             (((j % 8) ^ (q & 7)) << 4)));
          const u16* src = reinterpret_cast<const u16*>(&v);
          u16* dst = out + (i64)row * N + col;
          for (int e = 0; e < 8 && col + e < N; ++e) dst[e] = src[e];
        }
      }
    }
    if (tid == 0) mbar_arrive(bempty + 8 * bb);
  }
  if (tma_out && tid == 0) bulk_wait();  // the last stores are done
}

// one body, two names, so a profile tells lora_matmul's launches (one
// slot) from segmented_lora_matmul's
#define WG_ARGS                                                            \
  const __grid_constant__ CUtensorMap xm,                                  \
      const __grid_constant__ CUtensorMap wm,                              \
      const __grid_constant__ CUtensorMap am,                              \
      const __grid_constant__ CUtensorMap bm,                              \
      const __grid_constant__ CUtensorMap om, const int *__restrict__ idx, \
      int na, u16 *__restrict__ out, int M, int N, int K, float scaling,   \
      int group
template <class C>
__global__ void __launch_bounds__(WG_NT, 1) lora_wg_kernel(WG_ARGS) {
  wg_body<C>(&xm, &wm, &am, &bm, &om, idx, na, out, M, N, K, scaling, group);
}
template <class C>
__global__ void __launch_bounds__(WG_NT, 1) segmented_wg_kernel(WG_ARGS) {
  wg_body<C>(&xm, &wm, &am, &bm, &om, idx, na, out, M, N, K, scaling, group);
}
#undef WG_ARGS

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

// A and B are slot 0's operands, slot s sa (sb) elements further on; idx:
// [M] int32 row slots on the device, or nullptr (every row slot 0).  The
// loop's tiles and the epilogue's share one shared buffer.
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

// the kernel of a configuration: segmented_* for more than one slot
template <class C>
auto wg_kernel() {
  if constexpr (C::NA > 1)
    return segmented_wg_kernel<C>;
  else
    return lora_wg_kernel<C>;
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

// The TMA map of bf16 operand `op` (slot stacks: `na` slots `slot`
// elements apart) in boxes of `bf` elements along its unit stride by
// `bs` along its other dimension, with the swizzle of a `bf`-element row
inline bool op_map(CUtensorMap* m, const Op16& op, bool kn, int na, i64 slot,
                   int bf, int bs) {
  const i64 fast = kn ? op.cols : op.rows, slow = kn ? op.rows : op.cols;
  return tensor_map3(m, op.p, fast, slow, na, op.ld,
                     na > 1 ? slot : op.ld * slow, bf, bs,
                     bf == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                              : CU_TENSOR_MAP_SWIZZLE_128B);
}

// M > 16: the persistent wgmma kernel on `blocks` blocks walking the 128 x
// BN output tiles in groups of `group` M tiles (the plan from the caller)
template <int BN, int RP, bool KN, int NA>
int launch_wg(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
              i64 sa, i64 sb, const int* idx, int na, void* out, int M,
              int N, int K, float scaling, int blocks, int group,
              cudaStream_t s) {
  typedef WgCfg<BN, RP, KN, NA> C;
  if (blocks < 1 || group < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm, am, bm, om;
  // x [M][K] in 64 x 128 boxes; W, A and B as the kernel stages them
  if (!(op_map(&xm, X, true, 1, 0, 64, C::BM) &&
        (KN ? op_map(&wm, W, true, 1, 0, 64, 64)
            : op_map(&wm, W, false, 1, 0, 64, BN)) &&
        (KN ? op_map(&am, A, true, na, sa, RP, 64)
            : op_map(&am, A, false, 1, 0, 64, RP)) &&
        (KN ? op_map(&bm, B, true, na, sb, 64, RP)
            : op_map(&bm, B, false, 1, 0, RP, BN))))
    return (int)cudaErrorInvalidValue;
  // out [M][N] in boxes of 64 x 64 for the TMA stores, where its row
  // stride is whole 16 bytes (else the kernel stores by thread)
  memset(&om, 0, sizeof(om));
  if (N % 8 == 0 &&
      !tensor_map3(&om, out, N, M, 1, N, (i64)N * M, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const auto kernel = wg_kernel<C>();
  static bool opted_in = false;  // shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<blocks, WG_NT, C::SMEM, s>>>(xm, wm, am, bm, om, idx, na,
                                        static_cast<u16*>(out), M, N, K,
                                        scaling, group);
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

// M <= 16 (decode) takes the split-K decode path (splits, chunk, ws,
// tickets as launch_dec says), larger M the wgmma kernel with the
// caller's tile plan (tile_n 64, 128, 192 or 256, blocks, group), which
// depends on M, K and N alone, so a row sums in the same order whatever
// the number of slots.  NA: the most slots the call may have (na <= NA).
template <int RP, bool KN, int NA>
int launch_bf16(const Op16& X, const Op16& W, const Op16& A, const Op16& B,
                i64 sa, i64 sb, const int* idx, int na, void* out, int M,
                int N, int K, float scaling, int splits, int chunk, void* ws,
                void* tickets, int tile_n, int blocks, int group,
                cudaStream_t s) {
  if (M <= 16)
    return launch_dec<RP, KN, NA>(X, W, A, B, sa, sb, idx, na, out, M, N, K,
                                  scaling, splits, chunk, ws, tickets, s);
  const auto launch = tile_n == 256   ? launch_wg<256, RP, KN, NA>
                      : tile_n == 192 ? launch_wg<192, RP, KN, NA>
                      : tile_n == 128 ? launch_wg<128, RP, KN, NA>
                      : tile_n == 64  ? launch_wg<64, RP, KN, NA>
                                      : nullptr;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(X, W, A, B, sa, sb, idx, na, out, M, N, K, scaling, blocks,
                group, s);
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
