// Paged-KV flash attention, forward, for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/attention.py `_paged_kernel`
// (mxk_flash_attn_paged): (S, W, C) queries, H heads of Dh = C / H, over
// a flat (R, C) page store read through an (S, MP) block table. Query row
// w of slot s sits at position pos[s] + w and sees positions
// t <= pos[s] + w of the slot's context; position t lives in store row
// bt[s, t / page] * page + t % page (clipped to [0, R-1], as the plain
// gather clips). Online softmax in f32 for f32 and bf16 inputs, masked
// scores -1e30 BEFORE the max and p forced to 0 after the exp, output
// acc / max(l, 1e-30) in the input dtype.
//
// Bound: memory bandwidth. A decode step (W = 1) reads every visible K
// and V row of every slot once (2 * L_visible * C * 4 B per slot in f32)
// for about 4 flops per byte-pair; a chunk of W = 128 rows over a few
// hundred positions is still a few flops per byte.
//
// Design. One CTA of 4 warps per (slot, head, block of 8 query rows). The
// CTA reads its slot's position once and walks only the positions that
// its last row can see, in sub-tiles of 32 positions; the 4 warps take
// every 4th sub-tile (a split of the context, so a decode step with one
// query row still keeps 4 warps busy), each keeping its own running max,
// sum and accumulator per row, and the 4 partial states are merged through
// shared memory at the end. In a sub-tile a lane owns one position for
// the scores (K staged in shared memory with a padded row stride, so the
// 32 lanes read 32 banks) and then owns head dims for the accumulator
// (p broadcast by shuffle, V read along a row). This is the design
// difference from the TPU kernel, whose grid visits all MP pages of a
// slot and masks the invisible ones: masking multiplies p = 0 by the V
// row, and 0 times a non-finite row left in an unused page is NaN. Here
// rows past the last visible position are never read (the staged tile is
// zero-filled instead). Scalar FMAs, no tensor cores, no async copies.
//
// C interface for ctypes: mxk_flash_attn_paged launches on the caller's
// stream and returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int RB = 8;   // query rows per CTA
constexpr int TP = 32;  // positions per sub-tile (one per lane)
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
__host__ __device__ constexpr int warp_floats() {
  return TP * (DMAX + 1) + TP * DMAX;  // K (padded stride) + V
}

template <int DMAX>
__host__ __device__ constexpr int smem_floats() {
  // q rows, then per warp a K/V sub-tile; the merge reuses the sub-tiles
  return RB * DMAX + WARPS * warp_floats<DMAX>();
}

// DPL: head dims per lane (the kernel holds Dh <= 32 * DPL, zero padded).
template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS)
    flash_attn_paged_kernel(const T* __restrict__ q,
                            const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int32_t* __restrict__ bt,
                            const int32_t* __restrict__ pos,
                            T* __restrict__ o, int W, int C, int dh,
                            int page, int mp, int64_t rows, float sm_scale) {
  constexpr int DMAX = 32 * DPL;
  extern __shared__ float smem[];
  float* qs = smem;  // RB x DMAX, pre-scaled
  float* wbase = smem + RB * DMAX;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * RB;
  const int h = blockIdx.y;
  const int64_t sl = blockIdx.z;
  const int nrows = W - w0 < RB ? W - w0 : RB;
  const int p0 = __ldg(pos + sl);
  const int32_t* btr = bt + sl * mp;
  const int64_t col0 = (int64_t)h * dh;

  for (int i = threadIdx.x; i < RB * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    qs[i] = (r < nrows && d < dh)
                ? to_f32<T>(q[(sl * W + w0 + r) * C + col0 + d]) * sm_scale
                : 0.f;
  }
  __syncthreads();

  // positions any row of this CTA may see: t <= p0 + w0 + nrows - 1
  const int64_t last = (int64_t)p0 + w0 + nrows - 1;
  const int64_t ctx = (int64_t)mp * page;
  const int n_vis = last < 0 ? 0 : (int)(last + 1 < ctx ? last + 1 : ctx);
  const int n_sub = (n_vis + TP - 1) / TP;

  float* ks = wbase + warp * warp_floats<DMAX>();  // TP x (DMAX + 1)
  float* vs = ks + TP * (DMAX + 1);                // TP x DMAX
  float m[RB], l[RB], acc[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  for (int st = warp; st < n_sub; st += WARPS) {
    const int t0 = st * TP;
    __syncwarp();  // the warp is done with its previous sub-tile
#pragma unroll 4
    for (int pp = 0; pp < TP; ++pp) {
      const int t = t0 + pp;
      const bool in = t < n_vis;
      int64_t rid = 0;
      if (in) {
        rid = (int64_t)__ldg(btr + t / page) * page + t % page;
        rid = rid < 0 ? 0 : (rid >= rows ? rows - 1 : rid);
      }
      const T* krow = kp + rid * C + col0;
      const T* vrow = vp + rid * C + col0;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        const bool ld = in && d < dh;
        ks[pp * (DMAX + 1) + d] = ld ? to_f32<T>(krow[d]) : 0.f;
        vs[pp * DMAX + d] = ld ? to_f32<T>(vrow[d]) : 0.f;
      }
    }
    __syncwarp();

    const int t = t0 + lane;  // the position this lane scores
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int qpos = p0 + w0 + r;
      // warp-uniform: the row exists and sees part of this sub-tile
      if (r < nrows && t0 <= qpos) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DMAX; ++d)
          dot = fmaf(qs[r * DMAX + d], ks[lane * (DMAX + 1) + d], dot);
        const bool vis = t < n_vis && t <= qpos;
        const float sc = vis ? dot : NEG_INF;
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float corr = expf(m[r] - m_new);
        const float p = vis ? expf(sc - m_new) : 0.f;
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
        // positions past the row's last visible one have p == 0
        int jn = qpos - t0 + 1;
        jn = jn < TP ? jn : TP;
        jn = jn < n_vis - t0 ? jn : n_vis - t0;
        for (int jj = 0; jj < jn; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[r][j] = fmaf(pj, vs[jj * DMAX + lane + 32 * j], acc[r][j]);
        }
        m[r] = m_new;
      }
    }
  }

  // merge the 4 warps' partial states of each row
  __syncthreads();  // every warp is done with its sub-tiles
  float* ms = wbase;                 // WARPS x RB
  float* ls = ms + WARPS * RB;       // WARPS x RB
  float* as = ls + WARPS * RB;       // WARPS x RB x DMAX
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const float lsum = warp_sum(l[r]);
    if (lane == 0) {
      ms[warp * RB + r] = m[r];
      ls[warp * RB + r] = lsum;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      as[(warp * RB + r) * DMAX + lane + 32 * j] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    if (d >= dh) continue;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, ms[w * RB + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(ms[w * RB + r] - mm);
      ll += ls[w * RB + r] * f;
      aa += as[(w * RB + r) * DMAX + d] * f;
    }
    o[(sl * W + w0 + r) * C + col0 + d] = from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int32_t* bt, const int32_t* pos, void* o, int S,
                   int W, int C, int heads, int page, int mp, int64_t rows,
                   float sm_scale, cudaStream_t s) {
  const int smem = smem_floats<32 * DPL>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_paged_kernel<T, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((W + RB - 1) / RB), (unsigned)heads, (unsigned)S);
  flash_attn_paged_kernel<T, DPL><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), W, C,
      C / heads, page, mp, rows, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int32_t* bt, const int32_t* pos, void* o, int S,
                       int W, int C, int heads, int page, int mp,
                       int64_t rows, float sm_scale, cudaStream_t s) {
  const int dh = C / heads;
  if (dh <= 32)
    return launch<T, 1>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                        rows, sm_scale, s);
  if (dh <= 64)
    return launch<T, 2>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                        rows, sm_scale, s);
  return launch<T, 4>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp, rows,
                      sm_scale, s);
}

}  // namespace

// q, o: (S, W, C); k_pages, v_pages: (rows, C); bt: (S, mp) int32;
// pos: (S,) int32; all contiguous, q/o/pages of one dtype (0 = f32,
// 1 = bf16); C % heads == 0 and C / heads <= 128. sm_scale is
// 1/sqrt(C / heads) rounded to f32 by the caller.
extern "C" int mxk_flash_attn_paged(const void* q, const void* kp,
                                    const void* vp, const int32_t* bt,
                                    const int32_t* pos, void* o, int S,
                                    int W, int C, int heads, int page,
                                    int mp, long long rows, float sm_scale,
                                    int dtype, void* stream) {
  if (S <= 0 || S > 65535 || W <= 0 || heads <= 0 || heads > 65535 ||
      C <= 0 || C % heads != 0 || C / heads > 128 || page <= 0 || mp <= 0 ||
      rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                            rows, sm_scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, kp, vp, bt, pos, o, S, W, C, heads,
                                    page, mp, rows, sm_scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
