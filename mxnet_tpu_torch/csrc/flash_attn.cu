// Dense flash attention, forward, for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/attention.py `_train_kernel` (mxk_flash_attn):
// o = softmax(q k^T / sqrt(D) [causal mask]) v over (B, H, T, D) tensors,
// online softmax with f32 running max, sum and accumulator for f32 and
// bf16 inputs, masked scores -1e30 BEFORE the max and p forced to 0 after
// the exp, output acc / max(l, 1e-30) rounded once to the input dtype.
//
// Bound: at the prefill shape (16, 12, 128, 64) f32 the bytes (q, k, v
// read once, o written once: 25 MB) and the causal half of the 2*2*T*T*D
// flops per head (0.4-0.6 GFLOP after 64-row tile pruning, on f32 CUDA
// cores) take about the same time, a few microseconds each; at this size
// the launch itself may dominate. Design, simple and right first: the
// tile of flash_tile.cuh (one CTA per (b*h, 64-row q tile), 4 threads
// per q row, 64-row K/V tiles in shared memory). The TPU grid walks
// every KV tile and skips the future ones with pl.when; here the CTA's
// loop ends at the last tile the causal mask lets it see.
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
