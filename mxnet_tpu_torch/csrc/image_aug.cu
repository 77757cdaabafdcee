// The image record augment pass for Hopper (sm_90a): crop, optional
// constant border, mirror, BGR -> RGB, normalisation, HWC -> CHW and the
// cast to the batch's type, for a whole batch in one launch.
//
// Replaces no TPU kernel. The JAX package runs this transform on the
// host in numpy and cv2 (mxnet_tpu/io/image_record_iter.py
// `_build_augmenter`: pad -> crop -> mirror -> BGR->RGB -> (x - mean) /
// std * scale -> CHW) and copies the f32 batch to the device. The port
// decodes on the card (nvjpeg_decode.cu) and runs the transform here,
// so the f32 batch is written once, on the card, and never crosses the
// host-to-device link.
//
// Input: a table of B descriptors, six int64 each: the address of the
// decoded image (height rows of width * 3 bytes, B, G, R), its height,
// its width, the crop's top row y0 and left column x0 in the padded
// image, and the mirror flag. Pixel (c, y, x) of output image i reads
// padded row y0 + y and padded column x0 + x (x0 + tw - 1 - x when
// mirrored) of channel 2 - c; a padded position outside the image reads
// the fill byte.
//
// Arithmetic: the float of the byte, then (v - mean[c]) / std[c] * scale
// in f32, each operation rounded on its own as numpy does it (the
// intrinsics below, and -fmad=false for this source), so the kernel is
// bitwise its plain torch version; then one round-to-nearest-even cast.
//
// Bound: memory bandwidth. Each output element is written once and each
// cropped source byte read once (three reads of a pixel hit one sector);
// there are four f32 operations an output element. Design: one thread an
// output pixel, a 2-D grid of (pixel blocks, images); consecutive threads
// write consecutive columns of each channel plane.
//
// C interface for ctypes: mxk_image_aug launches on the caller's stream
// and returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AugParams {
  float mean[3];
  float std_[3];
  float scale;
  int normalize;
  int pad;
  int fill;
};

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float v, __half* p) {
  *p = __float2half_rn(v);
}

template <typename T>
__global__ void image_aug_kernel(const int64_t* __restrict__ table,
                                 T* __restrict__ out, int th, int tw,
                                 AugParams prm) {
  const int64_t i = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= th * tw) return;
  const int y = pix / tw;
  const int x = pix - y * tw;
  const int64_t* d = table + i * 6;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(d[0]);
  const int h = (int)d[1], w = (int)d[2];
  const int y0 = (int)d[3], x0 = (int)d[4];
  const int sy = y0 + y - prm.pad;
  const int sx = (d[5] ? x0 + tw - 1 - x : x0 + x) - prm.pad;
  uint8_t bgr[3];
  if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
    const uint8_t* p = src + ((int64_t)sy * w + sx) * 3;
    bgr[0] = p[0];
    bgr[1] = p[1];
    bgr[2] = p[2];
  } else {
    bgr[0] = bgr[1] = bgr[2] = (uint8_t)prm.fill;
  }
  const int64_t plane = (int64_t)th * tw;
  T* o = out + i * 3 * plane + pix;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = (float)bgr[2 - c];
    if (prm.normalize)
      v = __fmul_rn(__fdiv_rn(__fsub_rn(v, prm.mean[c]), prm.std_[c]),
                    prm.scale);
    store(v, o + c * plane);
  }
}

template <typename T>
void launch(const int64_t* table, void* out, int n, int th, int tw,
            const AugParams& prm, int threads, cudaStream_t s) {
  dim3 grid((unsigned)((th * tw + threads - 1) / threads), (unsigned)n);
  image_aug_kernel<T><<<grid, threads, 0, s>>>(table, static_cast<T*>(out),
                                               th, tw, prm);
}

}  // namespace

// table: n descriptors of 6 int64 on the device; out: n x 3 x th x tw of
// dtype (0 f32, 1 bf16, 2 f16); mean, std: 3 floats each (host).
extern "C" int mxk_image_aug(const int64_t* table, void* out, int n, int th,
                             int tw, int dtype, const float* mean,
                             const float* std_, float scale, int normalize,
                             int pad, int fill, int threads, void* stream) {
  if (n <= 0 || n > 65535 || th <= 0 || tw <= 0 ||
      (long long)th * tw > 0x7fffffffLL || threads <= 0 || threads > 1024 ||
      pad < 0 || fill < 0 || fill > 255)
    return (int)cudaErrorInvalidValue;
  AugParams prm;
  for (int c = 0; c < 3; ++c) {
    prm.mean[c] = mean[c];
    prm.std_[c] = std_[c];
  }
  prm.scale = scale;
  prm.normalize = normalize;
  prm.pad = pad;
  prm.fill = fill;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(table, out, n, th, tw, prm, threads, s); break;
    case 1: launch<__nv_bfloat16>(table, out, n, th, tw, prm, threads, s);
      break;
    case 2: launch<__half>(table, out, n, th, tw, prm, threads, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
