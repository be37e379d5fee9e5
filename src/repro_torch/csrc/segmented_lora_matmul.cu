// Multi-tenant LoRA matmul for Hopper (sm_90a): one call serves rows of
// many adapters over one shared base weight,
//
//   out[m, :] = x[m] @ W + s * round_T(x[m] @ A[idx[m]]) @ B[idx[m]]
//
// with x [M, K], W [K, N], the stacks A [NA, K, r] and B [NA, r, N], and
// idx [M] int32 on the device (< 0: the row takes the base product alone;
// past the last slot: the last slot, as the plain version clamps).
//
// Replaces the TPU kernel
// src/repro/kernels/lora_matmul.py::segmented_lora_matmul (its pallas_call
// at :170, kernel body _seg_kernel at :91), which multiplies x by the
// stacks concatenated along the rank axis and masks each row's segment
// before the B product.  Here the stacks are read in place through their
// slot strides, each slot's (x @ A) @ B is a sub-tile of its own, and a
// row keeps only its own slot's product (lora_mma.cuh, where the bounds
// and design notes are): with r a multiple of 16 each row is bitwise what
// lora_matmul gives with its slot's A and B at the same M, and a row of
// idx < 0 is bitwise lora_matmul with B = 0.
//
// Taken: float32 (any strides) or bfloat16 (x, W, A and B with unit
// stride along their last axis, every other stride a multiple of 8
// elements, pointers 16-byte aligned); r <= 64 and NA * (r <= 16 ? 16 :
// 64) <= 128 (up to 8 slots at r = 16).  No gradient: training steps one
// adapter through lora_matmul.
#include "lora_mma.cuh"

// Strides are in elements (slot, then row, then column of each stack);
// out is a contiguous [M, N] tensor of x's dtype.  bfloat16 at M <= 16
// takes lora_matmul's decode path with the same split of K (splits,
// chunk: the same plan, which depends on K and N alone), workspace and
// tickets as lora_matmul_launch describes (the workspace record holds na
// slots' x @ A); at M > 16 lora_matmul's wgmma kernel with the same tile
// plan (tile_n, blocks, group: a function of M, K and N alone).  Returns
// cudaGetLastError() after the launch (0 when it was accepted),
// cudaErrorInvalidValue for operands it does not take.
extern "C" int segmented_lora_matmul_launch(
    int dtype, const void* x, const void* w, const void* a, const void* b,
    const int* idx, void* out, int M, int N, int K, int r, int na, i64 sxm,
    i64 sxk, i64 swk, i64 swn, i64 sas, i64 sak, i64 sar, i64 sbs, i64 sbr,
    i64 sbn, float scaling, int splits, int chunk, void* ws, void* tickets,
    int tile_n, int blocks, int group, void* stream) {
  const int rp = r <= 16 ? 16 : 64;
  if (M <= 0 || N <= 0 || K <= 0 || r <= 0 || r > 64 || na <= 0 ||
      na * rp > 128 || idx == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Mat X = mat(x, sxm, sxk, M, K), W = mat(w, swk, swn, K, N);
    const Mat A = mat(a, sak, sar, K, r), B = mat(b, sbr, sbn, r, N);
    if (rp == 16)
      return launch_f32<16, 8>(X, W, A, B, sas, sbs, idx, na, out, M, N, K,
                               scaling, s);
    return launch_f32<64, 2>(X, W, A, B, sas, sbs, idx, na, out, M, N, K,
                             scaling, s);
  }
  Op16 X, W, A, B;
  if (!(op16(X, x, sxm, sxk, M, K, true) && op16(W, w, swk, swn, K, N, true) &&
        op16(A, a, sak, sar, K, r, true) && op16(B, b, sbr, sbn, r, N, true) &&
        sas % 8 == 0 && sbs % 8 == 0))
    return (int)cudaErrorInvalidValue;
  // register arrays and shared memory sized for at most 4 or 8 slots
  const auto launch = rp == 64  ? launch_bf16<64, true, 2>
                      : na <= 4 ? launch_bf16<16, true, 4>
                                : launch_bf16<16, true, 8>;
  return launch(X, W, A, B, sas, sbs, idx, na, out, M, N, K, scaling, splits,
                chunk, ws, tickets, tile_n, blocks, group, s);
}
