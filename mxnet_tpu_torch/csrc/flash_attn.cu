// Dense flash attention, forward, for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/attention.py `_train_kernel` (mxk_flash_attn):
// o = softmax(q k^T / sqrt(D) [causal mask]) v over (B, H, T, D) tensors,
// online softmax with f32 running max, sum and accumulator for f32 and
// bf16 inputs, masked scores -1e30 BEFORE the max and p forced to 0 after
// the exp, output acc / max(l, 1e-30) rounded once to the input dtype.
//
// Bound: at the prefill shape (16, 12, 128, 64) f32 causal the bytes
// (q, k, v read once, o written once: 25.2 MB, 0.0075 ms at 3.35 TB/s)
// outweigh the causal half of the 2*2*T*T*D flops per head (0.41 GFLOP,
// three times over on the TF32 tensor cores: 0.0025 ms at 495 TFLOP/s);
// at the training shape (8, 12, 1024, 64) the operations bound it:
// 3 x 12.9 GFLOP, 0.078 ms. Design: the tile of flash_tile.cuh, shared
// with flash_fwd.cu (B7): wgmma on TF32 with an error-compensated
// split (three products where both operands are f32; the scaled q's and
// p's small parts for bf16), so the result stays the f32 one. p meets V
// as f32 (the TPU kernel's f32 dot), so its small part is kept in both
// dtypes. The TPU grid walks every KV tile and skips the future ones
// with pl.when; here the CTA's loop ends at the last tile the causal
// mask lets it see, and each warpgroup skips the tiles its rows cannot.
//
// C interface for ctypes: mxk_flash_attn launches on the caller's stream
// and returns cudaGetLastError() (0 = launched).

#include "flash_tile.cuh"

// q: (bh, tq, d), k and v: (bh, tk, d), o: (bh, tq, d), contiguous, one
// dtype (0 = f32, 1 = bf16); d <= 128. sm_scale is 1/sqrt(d) rounded to
// f32 by the caller, as the JAX package rounds its Python float.
extern "C" int mxk_flash_attn(const void* q, const void* k, const void* v,
                              void* o, int bh, int tq, int tk, int d,
                              int causal, float sm_scale, int dtype,
                              void* stream) {
  return flash_entry<false>(q, k, v, o, bh, tq, tk, d, causal, sm_scale,
                            dtype, stream);
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
