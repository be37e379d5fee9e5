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
// The kernels are lora_mma.cuh's with one adapter slot and no row index
// (segmented_lora_matmul.cu runs the same kernels over many slots); their
// bounds and design notes are there.
#include "lora_mma.cuh"

// dtype 0: float32 (any strides), 1: bfloat16 (x with unit stride along
// K; W, A and B all with unit stride along their columns or all along
// their rows; the other strides multiples of 8 elements, pointers 16-byte
// aligned).  Strides are in elements; out is a contiguous [M, N] tensor
// of the same dtype.  bfloat16 at M <= 16 splits K into `splits` chunks
// of `chunk` rows (a multiple of 16) and needs the f32 workspace `ws`
// (DecCfg::record floats per 64-column tile and split) and one int32
// ticket per tile, zero before the first call; bfloat16 at M > 16 runs
// the wgmma kernel on `blocks` persistent blocks over 128 x `tile_n`
// output tiles (64, 128, 192 or 256) walked in groups of `group` M tiles
// (kernels/lora_matmul.py::mma_tile_plan); other calls ignore them.
// Returns cudaGetLastError() after the launch (0 when it was accepted),
// cudaErrorInvalidValue for operands it does not take.
extern "C" int lora_matmul_launch(int dtype, const void* x, const void* w,
                                  const void* a, const void* b, void* out,
                                  int M, int N, int K, int r, i64 sxm,
                                  i64 sxk, i64 swk, i64 swn, i64 sak,
                                  i64 sar, i64 sbr, i64 sbn, float scaling,
                                  int splits, int chunk, void* ws,
                                  void* tickets, int tile_n,
                                  int blocks, int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || r <= 0 || r > 64 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Mat X = mat(x, sxm, sxk, M, K), W = mat(w, swk, swn, K, N);
    const Mat A = mat(a, sak, sar, K, r), B = mat(b, sbr, sbn, r, N);
    if (r <= 16)
      return launch_f32<16, 1>(X, W, A, B, 0, 0, nullptr, 1, out, M, N, K,
                               scaling, s);
    if (r <= 32)
      return launch_f32<32, 1>(X, W, A, B, 0, 0, nullptr, 1, out, M, N, K,
                               scaling, s);
    return launch_f32<64, 1>(X, W, A, B, 0, 0, nullptr, 1, out, M, N, K,
                             scaling, s);
  }
  Op16 X, W, A, B;
  if (!op16(X, x, sxm, sxk, M, K, true)) return (int)cudaErrorInvalidValue;
  const bool kn = swn == 1 && sar == 1 && sbn == 1;
  if (!(op16(W, w, swk, swn, K, N, kn) && op16(A, a, sak, sar, K, r, kn) &&
        op16(B, b, sbr, sbn, r, N, kn)))
    return (int)cudaErrorInvalidValue;
  const auto launch = r <= 16 ? (kn ? launch_bf16<16, true, 1>
                                    : launch_bf16<16, false, 1>)
                              : (kn ? launch_bf16<64, true, 1>
                                    : launch_bf16<64, false, 1>);
  return launch(X, W, A, B, 0, 0, nullptr, 1, out, M, N, K, scaling, splits,
                chunk, ws, tickets, tile_n, blocks, group, s);
}
