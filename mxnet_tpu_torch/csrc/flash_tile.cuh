// Flash-attention forward tile shared by flash_attn.cu (B3) and
// flash_fwd.cu (B7): one CTA of 256 threads per (b*h, 64-row q tile),
// online softmax with f32 running max, sum and accumulator, masked scores
// -1e30 BEFORE the max and p forced to 0 after the exp, output
// acc / max(l, 1e-30) rounded once to the input dtype. Four threads own
// a q row, each holding D/4 of its dims (interleaved, so the four read
// neighbouring words of a shared row: no bank conflicts) of q and of the
// accumulator in registers; a score is their partial dots summed with
// two xor shuffles. K and V tiles of 64 rows are staged in shared memory
// as f32. The causal loop ends at the last tile the mask lets the CTA
// see (tile pruning); the tail past T is masked. Scalar FMAs, no tensor
// cores, no async copies: wgmma and TMA are later work. Each including
// file defines its own extern "C" entry through flash_entry<ROUND_P>.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per staged tile
constexpr int THREADS = 256;  // 4 threads per q row
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

// DQ: head dims per thread (the kernel holds D <= 4 * DQ, zero padded).
// ROUND_P: round each probability to T before it meets V (the legacy
// flash forward's p.astype(v.dtype)); the sum l takes it unrounded.
template <typename T, int DQ, bool ROUND_P>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int tq,
                      int tk, int d, int causal, float sm_scale) {
  constexpr int DMAX = 4 * DQ;
  extern __shared__ float smem[];
  float* ks = smem;              // BK x DMAX
  float* vs = smem + BK * DMAX;  // BK x DMAX

  const int64_t bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int qrow = qt * BQ + (tid >> 2);
  const bool row_ok = qrow < tq;
  const T* qb = q + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  float qr[DQ], acc[DQ];
#pragma unroll
  for (int j = 0; j < DQ; ++j) {
    const int dd = part + 4 * j;
    qr[j] = (row_ok && dd < d) ? to_f32<T>(qb[(int64_t)qrow * d + dd]) *
                                     sm_scale
                               : 0.f;
    acc[j] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int off = tk - tq;  // causal diagonal offset (0 when square)
  int n_tiles = (tk + BK - 1) / BK;
  if (causal) {
    // causal tile pruning: the last kv position any row of this q tile
    // may see is (qt + 1) * BQ - 1 + off
    const int last = (qt + 1) * BQ - 1 + off;
    const int seen = last < 0 ? 0 : last / BK + 1;
    n_tiles = n_tiles < seen ? n_tiles : seen;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BK * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const int kv = kt * BK + r;
      float kk = 0.f, vv = 0.f;
      if (kv < tk && c < d) {
        kk = to_f32<T>(kb[(int64_t)kv * d + c]);
        vv = to_f32<T>(vb[(int64_t)kv * d + c]);
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    float s[BK];
    float m_blk = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < DQ; ++t)
        dot = fmaf(qr[t], ks[j * DMAX + part + 4 * t], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kv = kt * BK + j;
      const bool vis = kv < tk && (!causal || kv <= qrow + off);
      s[j] = vis ? dot : NEG_INF;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int t = 0; t < DQ; ++t) acc[t] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kv = kt * BK + j;
      const bool vis = kv < tk && (!causal || kv <= qrow + off);
      const float p = vis ? expf(s[j] - m_new) : 0.f;
      psum += p;
      const float pv = ROUND_P ? to_f32<T>(from_f32<T>(p)) : p;
#pragma unroll
      for (int t = 0; t < DQ; ++t)
        acc[t] = fmaf(pv, vs[j * DMAX + part + 4 * t], acc[t]);
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* ob = o + bh * tq * d + (int64_t)qrow * d;
#pragma unroll
    for (int t = 0; t < DQ; ++t) {
      const int dd = part + 4 * t;
      if (dd < d) ob[dd] = from_f32<T>(acc[t] * inv);
    }
  }
}

template <typename T, int DQ, bool ROUND_P>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int tq, int tk, int d, int causal,
                   float sm_scale, cudaStream_t s) {
  const int smem = 2 * BK * 4 * DQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, DQ, ROUND_P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)bh, (unsigned)((tq + BQ - 1) / BQ));
  flash_attn_kernel<T, DQ, ROUND_P><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, d, causal,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, bool ROUND_P>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int bh, int tq, int tk, int d, int causal,
                       float sm_scale, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 8, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal,
                                  sm_scale, s);
  if (d <= 64)
    return launch<T, 16, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal,
                                   sm_scale, s);
  return launch<T, 32, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal, sm_scale, s);
}

// The common C entry: checks, then dispatch on dtype (0 = f32, 1 = bf16).
template <bool ROUND_P>
int flash_entry(const void* q, const void* k, const void* v, void* o, int bh,
                int tq, int tk, int d, int causal, float sm_scale, int dtype,
                void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal,
                                     sm_scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16, ROUND_P>(q, k, v, o, bh, tq, tk, d,
                                             causal, sm_scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
