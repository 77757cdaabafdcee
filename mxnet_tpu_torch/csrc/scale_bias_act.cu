// Fused per-feature scale + bias + activation for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/mlp.py `_kernel` (mxk_scale_bias_act):
// y = act(x * scale[f] + bias[f]) over a contiguous (rows, F) view, f32
// arithmetic, one rounding to x's dtype on the way out. scale and bias
// are f32 vectors of F values; either may be NULL (scale 1, bias 0).
// act: 0 identity, 1 ReLU, 2 exact (erf) GeLU.
//
// Bound: memory bandwidth. Each element is read once and written once
// with a handful of flops; the coefficient vectors are F floats,
// L1/L2-resident. At the training path's MLP up-projection, (8192, 3072)
// f32, that is 201 MB, 0.060 ms at 3.35 TB/s. Design: one flat
// grid-stride loop in which a thread handles VEC neighbouring elements
// of one row (VEC = 4 when F is a multiple of 4 and the pointers are
// 16-byte aligned for f32, 8-byte for bf16; else 1), loaded and stored
// as one vector, so a warp moves 512 contiguous bytes of f32 per
// instruction. The TPU kernel's (block_r, block_f) tiles, its (1,
// block_f) coefficient rows and its padding to block multiples have no
// counterpart: the column is (i % F), the tail needs no padding.
//
// C interface for ctypes: mxk_scale_bias_act launches on the caller's
// stream and returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float load_f32(T v);
template <> __device__ __forceinline__ float load_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T store_t(float v);
template <> __device__ __forceinline__ float store_t<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == 1) return v < 0.f ? 0.f : v;  // NaN passes through
  if (ACT == 2) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;
}

// VEC elements of T in one aligned vector load/store
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, typename I, int VEC, int ACT>
__global__ void scale_bias_act_kernel(const T* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      T* __restrict__ y, I n_vec, I f) {
  const I stride = (I)gridDim.x * (I)blockDim.x;
  for (I i = (I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x; i < n_vec;
       i += stride) {
    const I col = (i * VEC) % f;
    Pack<T, VEC> in = reinterpret_cast<const Pack<T, VEC>*>(x)[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = load_f32<T>(in.v[j]);
      if (scale != nullptr) v *= __ldg(scale + col + j);
      if (bias != nullptr) v += __ldg(bias + col + j);
      out.v[j] = store_t<T>(activate<ACT>(v));
    }
    reinterpret_cast<Pack<T, VEC>*>(y)[i] = out;
  }
}

template <typename T, typename I, int VEC>
cudaError_t launch_act(const void* x, const float* sc, const float* b,
                       void* y, I n_vec, I f, int act, int blocks,
                       int threads, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (act == 0)
    scale_bias_act_kernel<T, I, VEC, 0><<<blocks, threads, 0, s>>>(
        xt, sc, b, yt, n_vec, f);
  else if (act == 1)
    scale_bias_act_kernel<T, I, VEC, 1><<<blocks, threads, 0, s>>>(
        xt, sc, b, yt, n_vec, f);
  else if (act == 2)
    scale_bias_act_kernel<T, I, VEC, 2><<<blocks, threads, 0, s>>>(
        xt, sc, b, yt, n_vec, f);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_indexed(const void* x, const float* sc, const float* b,
                           void* y, long long n, long long f, int act,
                           int threads, int max_blocks, cudaStream_t s) {
  const long long n_vec = n / VEC;
  long long want = (n_vec + threads - 1) / threads;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  if (n <= 0x7fffffffLL)
    return launch_act<T, uint32_t, VEC>(x, sc, b, y, (uint32_t)n_vec,
                                        (uint32_t)f, act, blocks, threads,
                                        s);
  return launch_act<T, int64_t, VEC>(x, sc, b, y, (int64_t)n_vec,
                                     (int64_t)f, act, blocks, threads, s);
}

template <typename T>
cudaError_t dispatch_vec(const void* x, const float* sc, const float* b,
                         void* y, long long n, long long f, int act,
                         int vec, int threads, int max_blocks,
                         cudaStream_t s) {
  if (vec == 4)
    return launch_indexed<T, 4>(x, sc, b, y, n, f, act, threads, max_blocks,
                                s);
  if (vec == 1)
    return launch_indexed<T, 1>(x, sc, b, y, n, f, act, threads, max_blocks,
                                s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: n = rows * f contiguous elements of one dtype (0 = f32, 1 = bf16);
// scale, bias: f floats each, or NULL. vec is 4 (f % 4 == 0 and x, y
// aligned to 4 elements) or 1. The grid is min(ceil(n / vec / threads),
// max_blocks) blocks of `threads`.
extern "C" int mxk_scale_bias_act(const void* x, const float* scale,
                                  const float* bias, void* y, long long n,
                                  long long f, int dtype, int act, int vec,
                                  int threads, int max_blocks,
                                  void* stream) {
  if (n <= 0 || f <= 0 || n % f != 0 || threads <= 0 || max_blocks <= 0 ||
      (vec != 1 && vec != 4) || f % vec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_vec<float>(x, scale, bias, y, n, f, act, vec, threads,
                              max_blocks, s);
  else if (dtype == 1)
    err = dispatch_vec<__nv_bfloat16>(x, scale, bias, y, n, f, act, vec,
                                      threads, max_blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
