// JPEG chroma upsampling and YCbCr -> BGR for Hopper (sm_90a), with
// libjpeg-turbo's integer arithmetic, for the images of one launch.
//
// Replaces no TPU kernel. The JAX package decodes with cv2, whose
// libjpeg-turbo upsamples subsampled chroma with its "fancy" triangle
// filter and converts with 16-bit fixed-point tables (jdsample.c,
// jdcolor.c). nvJPEG's own conversion to BGR upsamples 4:2:0 chroma
// differently (up to 77 levels apart at sharp colour edges on this
// repository's fixture), so the port takes nvJPEG's planar output (Y at
// full size, Cb and Cr as stored) and does the rest here, bit for bit as
// libjpeg-turbo does it from the same planes:
//   h2v2 (4:2:0): colsum(c) = 3 * P[r][c] + P[r'][c], r' the row above
//     (even output rows) or below (odd), clamped to the plane; even
//     output columns (3 * colsum(c) + colsum(c - 1) + 8) >> 4, odd ones
//     (3 * colsum(c) + colsum(c + 1) + 7) >> 4; the first and last
//     columns (4 * colsum + 8 or 7) >> 4;
//   h2v1 (4:2:2): (3 * P[c] + P[c -/+ 1] + 1 or 2) >> 2, the edge columns
//     copied;
//   then R = y + Cr_r[cr], G = y + ((Cb_g[cb] + Cr_g[cr]) >> 16),
//     B = y + Cb_b[cb], clamped to [0, 255], the tables' FIX() constants
//     91881, 116130, 46802 and 22554 with round-half-up.
// A plane two samples wide or less is replicated (libjpeg's box case).
//
// Input: a table of n descriptors, ten int64 each: the addresses of the
// Y, Cb and Cr planes (Y rows of w bytes, chroma rows of cw bytes) and of
// the output (h rows of w * 3 bytes, B, G, R), then h, w, cw, ch and the
// mode: 1 4:4:4, 2 4:2:2, 3 4:2:0.
//
// Bound: memory bandwidth (read the planes once, write 3 bytes a pixel;
// a few integer operations a pixel). Design: one thread an output pixel,
// a 2-D grid of (pixel blocks over the largest image, images).
//
// C interface for ctypes: mxk_jpeg_color launches on the caller's stream
// and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// 4:2:2: the chroma value at output column ox of chroma row p.
__device__ __forceinline__ int up_h2v1(const uint8_t* p, int cw, int ox) {
  const int c = ox >> 1;
  if (cw <= 2) return p[c];
  if ((ox & 1) == 0)
    return c == 0 ? p[0] : (3 * p[c] + p[c - 1] + 1) >> 2;
  return c == cw - 1 ? p[c] : (3 * p[c] + p[c + 1] + 2) >> 2;
}

// 4:2:0: the chroma value at output pixel (oy, ox) of plane P.
__device__ __forceinline__ int up_h2v2(const uint8_t* P, int cw, int ch,
                                       int oy, int ox) {
  const int r = oy >> 1, c = ox >> 1;
  if (cw <= 2) return P[(int64_t)r * cw + c];
  int rn = (oy & 1) ? r + 1 : r - 1;
  rn = rn < 0 ? 0 : (rn >= ch ? ch - 1 : rn);
  const uint8_t* p0 = P + (int64_t)r * cw;
  const uint8_t* p1 = P + (int64_t)rn * cw;
  const int s = 3 * p0[c] + p1[c];
  if ((ox & 1) == 0) {
    if (c == 0) return (s * 4 + 8) >> 4;
    return (s * 3 + (3 * p0[c - 1] + p1[c - 1]) + 8) >> 4;
  }
  if (c == cw - 1) return (s * 4 + 7) >> 4;
  return (s * 3 + (3 * p0[c + 1] + p1[c + 1]) + 7) >> 4;
}

__global__ void jpeg_color_kernel(const int64_t* __restrict__ table) {
  const int64_t* d = table + (int64_t)blockIdx.y * 10;
  const int h = (int)d[4], w = (int)d[5], cw = (int)d[6], ch = (int)d[7];
  const int mode = (int)d[8];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  const int oy = pix / w, ox = pix - oy * w;
  const uint8_t* Y = reinterpret_cast<const uint8_t*>(d[0]);
  uint8_t* o = reinterpret_cast<uint8_t*>(d[3]) + (int64_t)pix * 3;
  const int y = Y[pix];
  const uint8_t* Cb = reinterpret_cast<const uint8_t*>(d[1]);
  const uint8_t* Cr = reinterpret_cast<const uint8_t*>(d[2]);
  int cb, cr;
  if (mode == 1) {
    cb = Cb[(int64_t)oy * cw + ox];
    cr = Cr[(int64_t)oy * cw + ox];
  } else if (mode == 2) {
    cb = up_h2v1(Cb + (int64_t)oy * cw, cw, ox);
    cr = up_h2v1(Cr + (int64_t)oy * cw, cw, ox);
  } else {
    cb = up_h2v2(Cb, cw, ch, oy, ox);
    cr = up_h2v2(Cr, cw, ch, oy, ox);
  }
  const int x_cb = cb - 128, x_cr = cr - 128;
  const int r_off = (91881 * x_cr + 32768) >> 16;
  const int b_off = (116130 * x_cb + 32768) >> 16;
  const int g_off = ((-22554) * x_cb + 32768 + (-46802) * x_cr) >> 16;
  o[0] = (uint8_t)clamp255(y + b_off);
  o[1] = (uint8_t)clamp255(y + g_off);
  o[2] = (uint8_t)clamp255(y + r_off);
}

}  // namespace

// table: n descriptors of 10 int64 on the device; max_pixels: the
// largest h * w among them.
extern "C" int mxk_jpeg_color(const int64_t* table, int n,
                              long long max_pixels, int threads,
                              void* stream) {
  if (n <= 0 || n > 65535 || max_pixels <= 0 || max_pixels > 0x7fffffffLL ||
      threads <= 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((max_pixels + threads - 1) / threads), (unsigned)n);
  jpeg_color_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      table);
  return (int)cudaGetLastError();
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
