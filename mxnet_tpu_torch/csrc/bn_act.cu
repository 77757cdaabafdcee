// Fused BatchNorm epilogue + activation (+ residual add) for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/bn_act.py `_epilogue_kernel` (mxk_bn_act) and
// `_epilogue_res_kernel` (mxk_bn_act_res): y = act(x * sc[c] + sh[c] [+ r])
// over an NCHW tensor, f32 arithmetic, one rounding to x's dtype on the way
// out. The per-channel f32 coefficients come from the caller (plain torch,
// kernels/bn_act.py `_coefs`).
//
// Bound: memory bandwidth. The kernel reads x (and r) once and writes y
// once, a few flops per element; sc and sh are C floats each, L1-resident.
// A flat loop of one element a thread (two run-time integer divisions for
// its channel, 2-4 bytes a load) ran out of instructions before HBM ran
// out of bytes, so the design spends few instructions per byte:
//
// - The flat N*C*H*W tensor moves in 16-byte vectors (4 f32 or 8 bf16) for
//   x, r and y, whatever H*W is: a scalar head up to 16-byte alignment, the
//   vector body, a scalar tail, all in one launch. Rows of odd length
//   (Inception-v3's 147x147 ... 17x17, ResNet-50's 7x7) leave every row
//   start misaligned, so the vectors are not cut at rows.
// - One channel lookup per vector: row = first / HW and channel = row % C
//   by multiply-and-shift division (Div32; magic numbers from the host),
//   and a vector that crosses a row boundary takes the next channel for
//   the elements past it. HW < vector width (on no model's path) looks the
//   channel up per element.
// - One vector a thread an iteration, and a grid of as many blocks as the
//   tensor needs, so a small tensor gets a partial wave of full blocks.
//   On the H100 at ResNet-50's and Inception-v3's sites a grid of one wave
//   (SMs x resident blocks) looping over the tensor ran slower at the
//   large sites, and 2-8 loads a thread in flight no faster; L2
//   evict-first, streaming (.cs) and 256-byte-prefetch loads of x changed
//   nothing (PERF.md, B1).
// - x, r and y disagreeing in their address mod 16 (views at a storage
//   offset) take the scalar path for every element, in the same kernel.
//
// The TPU kernel's (N*C, HW) block view, its tiled (N*C, 1) coefficient
// columns and its padding to block multiples have no counterpart.
//
// C interface for ctypes: mxk_bn_act launches on the caller's stream and
// returns cudaGetLastError() (0 = launched). Nothing is allocated, queried
// or synchronised, so a launch can be captured into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// floor(n / d) by one multiply and a shift, for 0 <= n < 2^31 and
// 1 <= d < 2^31: with L = ceil(log2 d) and s = 31 + L, m = ceil(2^s / d)
// fits 32 bits, and n * m / 2^s exceeds n / d by less than 2^-L <= 1/d,
// too little to reach the next integer.
struct Div32 {
  typedef uint32_t index;
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (uint32_t)(((uint64_t)n * m) >> s);
  }
};

Div32 make_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  Div32 v;
  v.d = d;
  v.s = 31 + l;
  v.m = (uint32_t)(((1ull << v.s) + d - 1) / d);
  return v;
}

// Tensors of 2^31 elements or more: the hardware's 64-bit division, still
// once per vector.
struct Div64 {
  typedef uint64_t index;
  uint64_t d;
  __device__ __forceinline__ uint64_t div(uint64_t n) const { return n / d; }
};

Div64 make_div(uint64_t d) {
  Div64 v;
  v.d = d;
  return v;
}

// 16 bytes of T as f32 values and back (one rounding, to nearest even).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void half(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);  // the element at the lower address
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t two(float a, float b) {
    __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    half(u.x, f);
    half(u.y, f + 2);
    half(u.z, f + 4);
    half(u.w, f + 6);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

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

template <bool HAS_RES, bool RELU>
__device__ __forceinline__ float epilogue(float x, float s, float h,
                                          float r) {
  float v = x * s + h;
  if (HAS_RES) v += r;
  if (RELU) v = v < 0.f ? 0.f : v;  // NaN passes through, as in the TPU kernel
  return v;
}

template <typename Div>
__device__ __forceinline__ typename Div::index channel(
    typename Div::index i, const Div& hw, const Div& c) {
  const typename Div::index row = hw.div(i);
  return row - c.div(row) * c.d;
}

// Elements [0, head) and [head + nvec * V, n) one at a time; the nvec
// vectors of V elements from `head` on, one a thread an iteration. Keep
// HAS_RES the third template argument: chip_smoke.census_name reads it there.
template <typename T, typename Div, bool HAS_RES, bool RELU>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const float* __restrict__ sc,
                              const float* __restrict__ sh,
                              const T* __restrict__ r, T* __restrict__ y,
                              typename Div::index n, typename Div::index head,
                              typename Div::index nvec, Div hw, Div c) {
  typedef typename Div::index I;
  constexpr int V = Vec<T>::kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* rv = HAS_RES ? reinterpret_cast<const uint4*>(r + head)
                            : nullptr;
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  const I step = (I)gridDim.x * blockDim.x;
  for (I v = (I)blockIdx.x * blockDim.x + threadIdx.x; v < nvec; v += step) {
    float f[V], g[V];
    Vec<T>::unpack(__ldg(xv + v), f);
    if (HAS_RES) Vec<T>::unpack(__ldg(rv + v), g);
    const I first = head + v * V;
    if (hw.d >= (I)V) {
      // at most one row boundary inside the vector: the elements from
      // `left` on belong to the next row, whose channel is ch + 1 mod C
      const I row = hw.div(first);
      const I left = hw.d - (first - row * hw.d);
      const I ch = row - c.div(row) * c.d;
      const I ch1 = ch + 1 == c.d ? 0 : ch + 1;
      const float s0 = __ldg(sc + ch), h0 = __ldg(sh + ch);
      const float s1 = __ldg(sc + ch1), h1 = __ldg(sh + ch1);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool here = (I)j < left;
        f[j] = epilogue<HAS_RES, RELU>(f[j], here ? s0 : s1, here ? h0 : h1,
                                       HAS_RES ? g[j] : 0.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const I ch = channel(first + j, hw, c);
        f[j] = epilogue<HAS_RES, RELU>(f[j], __ldg(sc + ch), __ldg(sh + ch),
                                       HAS_RES ? g[j] : 0.f);
      }
    }
    yv[v] = Vec<T>::pack(f);
  }
  const I body = nvec * V;
  const I ns = n - body;
  for (I s = (I)blockIdx.x * blockDim.x + threadIdx.x; s < ns; s += step) {
    const I i = s < head ? s : s + body;
    const I ch = channel(i, hw, c);
    y[i] = store_t<T>(epilogue<HAS_RES, RELU>(
        load_f32<T>(x[i]), __ldg(sc + ch), __ldg(sh + ch),
        HAS_RES ? load_f32<T>(r[i]) : 0.f));
  }
}

template <typename T, typename Div, bool HAS_RES, bool RELU>
cudaError_t launch_variant(const T* x, const float* sc, const float* sh,
                           const T* r, T* y, typename Div::index n,
                           typename Div::index hw, typename Div::index c,
                           int threads, int max_blocks, cudaStream_t s) {
  typedef typename Div::index I;
  constexpr int V = Vec<T>::kN;
  // the vector body needs x, r and y at one address mod 16
  const uintptr_t ax = (uintptr_t)x, ay = (uintptr_t)y;
  const uintptr_t ar = HAS_RES ? (uintptr_t)r : ax;
  I head = 0, nvec = 0;
  if ((((ax ^ ay) | (ax ^ ar)) & 15) == 0) {
    head = (I)(((16 - (ax & 15)) & 15) / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / V;
  }
  // one thread for each vector, or for each scalar element if more
  const long long scalar = (long long)(n - nvec * V);
  const long long want = (long long)nvec > scalar ? (long long)nvec : scalar;
  long long blocks = (want + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  bn_act_kernel<T, Div, HAS_RES, RELU><<<(unsigned)blocks, threads, 0, s>>>(
      x, sc, sh, r, y, n, head, nvec, make_div(hw), make_div(c));
  return cudaGetLastError();
}

template <typename T, typename Div>
cudaError_t launch(const void* x, const float* sc, const float* sh,
                   const void* r, void* y, typename Div::index n,
                   typename Div::index hw, typename Div::index c, int relu,
                   int threads, int max_blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  if (r != nullptr) {
    if (relu)
      return launch_variant<T, Div, true, true>(xt, sc, sh, rt, yt, n, hw, c,
                                                threads, max_blocks, s);
    return launch_variant<T, Div, true, false>(xt, sc, sh, rt, yt, n, hw, c,
                                               threads, max_blocks, s);
  }
  if (relu)
    return launch_variant<T, Div, false, true>(xt, sc, sh, rt, yt, n, hw, c,
                                               threads, max_blocks, s);
  return launch_variant<T, Div, false, false>(xt, sc, sh, rt, yt, n, hw, c,
                                              threads, max_blocks, s);
}

template <typename T>
cudaError_t launch_indexed(const void* x, const float* sc, const float* sh,
                           const void* r, void* y, long long n, long long hw,
                           int c, int relu, int threads, int max_blocks,
                           cudaStream_t s) {
  if (n <= 0x7fffffffLL)
    return launch<T, Div32>(x, sc, sh, r, y, (uint32_t)n, (uint32_t)hw,
                            (uint32_t)c, relu, threads, max_blocks, s);
  return launch<T, Div64>(x, sc, sh, r, y, (uint64_t)n, (uint64_t)hw,
                          (uint64_t)c, relu, threads, max_blocks, s);
}

}  // namespace

// x, r, y: n = N*C*H*W contiguous elements of one dtype (0 = f32, 1 = bf16);
// r may be NULL (the mxk_bn_act form) or x's shape (mxk_bn_act_res);
// sc, sh: c floats. The grid is what the tensor needs, one vector (on the
// scalar path one element) a thread, at most max_blocks; blocks past that
// loop.
extern "C" int mxk_bn_act(const void* x, const float* sc, const float* sh,
                          const void* r, void* y, long long n, long long hw,
                          int c, int dtype, int relu, int threads,
                          int max_blocks, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || threads <= 0 || threads > 1024 ||
      max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_indexed<float>(x, sc, sh, r, y, n, hw, c, relu,
                                      threads, max_blocks, s);
  if (dtype == 1)
    return (int)launch_indexed<__nv_bfloat16>(x, sc, sh, r, y, n, hw, c,
                                              relu, threads, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
