// The legacy flash-attention forward for Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_flash.py `_kernel` (the pallas_call at
// :121): o = softmax(q k^T / sqrt(D) [causal mask]) v over (B, H, T, D),
// q scaled before the dot, f32 running max, sum and accumulator, scores
// masked to -1e30 before the max for the tail and, when causal, for
// kv > q + (tk - tq); each probability is rounded to the input dtype
// before it meets V (the TPU kernel's p.astype(v.dtype)), the sum takes
// it unrounded; output acc / max(l, 1e-30), so a fully masked row
// (causal with tq > tk) is exactly 0. The caller's block_q and block_k
// chose the TPU's tiles and do not change the function: this kernel
// keeps its own 64-row K/V tile (the running max moves once per tile,
// which sets where a bf16 p rounds).
//
// Bound: at the training shape (8, 12, 1024, 64) f32 causal, q, k, v
// read once and o written once are 100.7 MB (0.030 ms at 3.35 TB/s);
// the causal half of the 2*2*T*T*D flops per head is 12.9 GFLOP, three
// times over on the TF32 tensor cores (the split below): 0.078 ms at
// 495 TFLOP/s, so operations bound it (on the f32 CUDA cores alone it
// would be 0.19 ms at 67 TFLOP/s). Design: the tile of flash_tile.cuh,
// shared with flash_attn.cu (B3) but built as its own entry point so
// each has its own launch count: wgmma on TF32 with an error-compensated
// split, three products where both operands are f32; in bf16, K and V
// and the rounded p are exact in TF32, so S takes two products (the
// scaled q's small part) and P.V one.
//
// C interface for ctypes: mxk_flash_fwd launches on the caller's stream
// and returns cudaGetLastError() (0 = launched).

#include "flash_tile.cuh"

// q: (bh, tq, d), k and v: (bh, tk, d), o: (bh, tq, d), contiguous, one
// dtype (0 = f32, 1 = bf16); d <= 128. sm_scale is 1/sqrt(d) rounded to
// f32 by the caller.
extern "C" int mxk_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, int bh, int tq, int tk, int d,
                             int causal, float sm_scale, int dtype,
                             void* stream) {
  return flash_entry<true>(q, k, v, o, bh, tq, tk, d, causal, sm_scale,
                           dtype, stream);
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
