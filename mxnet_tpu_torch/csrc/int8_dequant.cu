// Fused int8 dequantize -> per-channel affine -> activation epilogue for
// Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/int8_dequant.py `_dequant_kernel`
// (mxk_int8_dequant): y = act(f32(acc) * sc[c] + sh[c]) over the int32
// accumulator of an int8 x int8 product, act relu or identity, f32 out.
// The coefficients fold the dequantization scale, the inference BatchNorm
// affine and the layer's bias (quant/rewrite.py); the caller passes them
// per channel. Two forms, as the TPU wrapper has them, over a row-major
// (R, S) accumulator:
//   per row    (conv, NCHW viewed (N*C, H*W)): channel (i / S) % C,
//   per column (conv as (N*OH*OW, O) from the GEMM, and FC):  channel i % S.
//
// Bound: memory bandwidth. Each element is one int32 read and one f32
// write (8 bytes) for an FMA and a max; the coefficients are a few KB and
// stay in L1/L2. At ResNet-50 batch 32 the 54 sites move 2.71 GB, about
// 0.81 ms at 3.35 TB/s.
//
// Design: the bn_act.cu mold. One flat grid-stride loop over the n = R*S
// elements, the channel taken from the flat index, so the coefficients
// are never tiled N times (the TPU wrapper tiles them into an (N*C, 1)
// column) and a short or odd row (S = 49 at ResNet-50's last stage) costs
// nothing: each thread takes 4 consecutive elements with one 16-byte load
// (int4) and one 16-byte store (float4), computes the first channel with
// one division and steps the other three, and a scalar tail takes the
// last n % 4 elements. Pointers that are not 16-byte aligned take the
// scalar loop throughout. Indices are 32-bit where the tensor allows it.
//
// Rounding: fmaf(__int2float_rn(acc), sc, sh) rounds the affine once, as
// XLA contracts acc * sc + sh into an FMA in the JAX package; the int32 ->
// f32 conversion rounds to nearest even, as astype(float32) does.
//
// C interface for ctypes: mxk_int8_dequant launches on the caller's stream
// and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Channel of flat element i, stepped one element at a time.
template <typename I, bool PER_ROW>
struct Channel {
  I col;  // position within the row (per-row form)
  I ch;   // coefficient index
  __device__ __forceinline__ Channel(I i, I s, I c) {
    if (PER_ROW) {
      const I row = i / s;
      col = i - row * s;
      ch = row % c;
    } else {
      col = 0;
      ch = i % s;
    }
  }
  __device__ __forceinline__ void next(I s, I c) {
    if (PER_ROW) {
      if (++col == s) {
        col = 0;
        if (++ch == c) ch = 0;
      }
    } else {
      if (++ch == s) ch = 0;
    }
  }
};

template <typename I, bool RELU>
__device__ __forceinline__ float dequant(int a, const float* __restrict__ sc,
                                         const float* __restrict__ sh, I ch) {
  float v = fmaf(__int2float_rn(a), __ldg(sc + ch), __ldg(sh + ch));
  if (RELU) v = v < 0.f ? 0.f : v;
  return v;
}

template <typename I, bool PER_ROW, bool RELU>
__global__ void int8_dequant_vec4(const int4* __restrict__ acc,
                                  const float* __restrict__ sc,
                                  const float* __restrict__ sh,
                                  float4* __restrict__ y, I n, I s, I c) {
  const I groups = n / 4;
  const I stride = (I)gridDim.x * (I)blockDim.x;
  const I first = (I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x;
  for (I g = first; g < groups; g += stride) {
    const int4 a = __ldg(acc + g);
    Channel<I, PER_ROW> k(g * 4, s, c);
    float4 o;
    o.x = dequant<I, RELU>(a.x, sc, sh, k.ch);
    k.next(s, c);
    o.y = dequant<I, RELU>(a.y, sc, sh, k.ch);
    k.next(s, c);
    o.z = dequant<I, RELU>(a.z, sc, sh, k.ch);
    k.next(s, c);
    o.w = dequant<I, RELU>(a.w, sc, sh, k.ch);
    y[g] = o;
  }
  // the tail: the last n % 4 elements, one thread each
  const I i = groups * 4 + first;
  if (i < n) {
    const int* a = reinterpret_cast<const int*>(acc);
    float* out = reinterpret_cast<float*>(y);
    Channel<I, PER_ROW> k(i, s, c);
    out[i] = dequant<I, RELU>(__ldg(a + i), sc, sh, k.ch);
  }
}

template <typename I, bool PER_ROW, bool RELU>
__global__ void int8_dequant_scalar(const int* __restrict__ acc,
                                    const float* __restrict__ sc,
                                    const float* __restrict__ sh,
                                    float* __restrict__ y, I n, I s, I c) {
  const I stride = (I)gridDim.x * (I)blockDim.x;
  for (I i = (I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x; i < n;
       i += stride) {
    Channel<I, PER_ROW> k(i, s, c);
    y[i] = dequant<I, RELU>(__ldg(acc + i), sc, sh, k.ch);
  }
}

template <typename I, bool PER_ROW, bool RELU>
void launch(const int* acc, const float* sc, const float* sh, float* y, I n,
            I s, I c, bool vec, int threads, int max_blocks,
            cudaStream_t stream) {
  const long long work = vec ? (long long)(n / 4) : (long long)n;
  long long want = (work + threads - 1) / threads;
  if (want < 1) want = 1;  // the tail alone (n < 4) still needs a block
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  if (vec)
    int8_dequant_vec4<I, PER_ROW, RELU><<<blocks, threads, 0, stream>>>(
        reinterpret_cast<const int4*>(acc), sc, sh,
        reinterpret_cast<float4*>(y), n, s, c);
  else
    int8_dequant_scalar<I, PER_ROW, RELU><<<blocks, threads, 0, stream>>>(
        acc, sc, sh, y, n, s, c);
}

template <typename I>
void launch_form(const int* acc, const float* sc, const float* sh, float* y,
                 I n, I s, I c, int per_row, int relu, bool vec, int threads,
                 int max_blocks, cudaStream_t stream) {
  if (per_row) {
    if (relu)
      launch<I, true, true>(acc, sc, sh, y, n, s, c, vec, threads,
                            max_blocks, stream);
    else
      launch<I, true, false>(acc, sc, sh, y, n, s, c, vec, threads,
                             max_blocks, stream);
  } else {
    if (relu)
      launch<I, false, true>(acc, sc, sh, y, n, s, c, vec, threads,
                             max_blocks, stream);
    else
      launch<I, false, false>(acc, sc, sh, y, n, s, c, vec, threads,
                              max_blocks, stream);
  }
}

}  // namespace

// acc: n = R*S contiguous int32; y: n contiguous f32; s = S, the row
// length. per_row = 1: sc, sh hold c floats and row r uses entry r % c
// (c divides R); per_row = 0: sc, sh hold s floats (c is ignored). The
// grid is min(ceil(work / threads), max_blocks) blocks, work = n / 4 on
// the vector path and n on the scalar one.
extern "C" int mxk_int8_dequant(const int* acc, const float* sc,
                                const float* sh, float* y, long long n,
                                long long s, long long c, int per_row,
                                int relu, int threads, int max_blocks,
                                void* stream) {
  if (n <= 0 || s <= 0 || n % s != 0 || threads <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (per_row && (c <= 0 || (n / s) % c != 0))
    return (int)cudaErrorInvalidValue;
  if (!per_row) c = s;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the vector loop forms g * 4 + 3, and the tail groups * 4 + thread
  if (n + 4LL * threads * max_blocks <= 0x7fffffffLL)
    launch_form<uint32_t>(acc, sc, sh, y, (uint32_t)n, (uint32_t)s,
                          (uint32_t)c, per_row, relu, vec, threads,
                          max_blocks, st);
  else
    launch_form<int64_t>(acc, sc, sh, y, (int64_t)n, (int64_t)s, (int64_t)c,
                         per_row, relu, vec, threads, max_blocks, st);
  return (int)cudaGetLastError();
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
