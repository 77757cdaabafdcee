// Paged-KV flash attention, forward, for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/attention.py `_paged_kernel` / `_paged_call`
// (mxk_flash_attn_paged): (S, W, C) queries, H heads of Dh = C / H, over
// a flat (R, C) page store read through an (S, MP) block table. Query row
// w of slot s sits at position pos[s] + w and sees positions
// t <= pos[s] + w of the slot's context; position t lives in store row
// bt[s, t / page] * page + t % page (clipped to [0, R-1], as the plain
// gather clips). Online softmax in f32 for f32 and bf16 inputs: q
// pre-scaled by 1/sqrt(Dh), masked scores -1e30 by a select BEFORE the
// max, p forced to 0 after the exp, output acc / max(l, 1e-30) in the
// input dtype.
//
// Non-finite contract: the TPU kernel's grid visits every listed page of
// a slot and adds p @ V with p = 0 at masked positions, so a non-finite
// V value at a position masked for a row makes that row's column NaN
// (0 * inf = 0 * NaN = NaN), whether the page lies wholly past the
// position or is the masked tail of the last visible page; a non-finite
// K value at a masked position changes nothing (its score is replaced by
// the select); non-finite values at visible positions propagate as the
// plain version propagates them (+inf in V with p > 0 gives inf). This
// kernel computes the same: it reads V at every listed position and
// accumulates 0 * V where a row may not look. Positions that no row of
// the CTA sees need V only, not K, and a run of equal block-table entries
// past the last visible position is scanned once (0 * V is idempotent;
// serving lists the scratch page 0 in every unused entry).
//
// Bound: memory bandwidth. A decode step (W = 1) reads visible K and V
// once and V of the listed positions no query sees, about 4 flops per
// visible (position, dim) for 8 bytes of K and V in f32.
//
// Design. One CTA of 4 warps per (slot, head, block of query rows: 1 for
// a decode step, else 8), every CTA of a decode step resident at once
// (68 KB of shared memory a CTA in f32, 3 a SM). The CTA copies its
// slot's block-table row and its scaled queries to shared memory once;
// then each warp takes every 4th unit of 16 positions (a page of 16, or a
// 16-row part of a larger page) and streams it into its own 2-stage ring
// with 16-byte `cp.async.cg` copies (L1 bypassed): the next unit is in
// flight while the warp scores the current one. Lanes t and t + 16 each
// take half of position t's K row (K rows padded by 16 bytes, so a
// 16-byte load phase of 8 lanes on 8 rows meets 8 distinct bank groups)
// and one shuffle joins the halves; p is broadcast back by shuffle for
// the accumulator, in which a lane keeps DPL head dims. The warps'
// partial (max, sum, accumulator) states are merged through shared
// memory at the end, each scaled by exp(m_w - m); a state with l == 0 is
// not skipped, since its accumulator may carry the contract's NaN.
// Scalar FMAs, no tensor cores: a decode row is a matrix-vector product.
//
// C interface for ctypes: mxk_flash_attn_paged launches on the caller's
// stream and returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TP = 16;  // positions per unit
constexpr int NS = 2;   // ring stages per warp
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// DPL consecutive elements of a shared-memory row as floats
__device__ __forceinline__ void lds(const float* p, float (&o)[1]) {
  o[0] = p[0];
}
__device__ __forceinline__ void lds(const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void lds(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[1]) {
  o[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[4]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max16(float x) {
  // the max over lanes 0-15 (lanes 16-31 hold the same values)
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void ld16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The shared-memory plan of one CTA, in bytes. K rows are padded by 16
// bytes, so that the 8 lanes of a 16-byte load phase, each on its own
// row, meet 8 distinct groups of 4 banks.
template <typename T, int DPL, int RB>
struct Plan {
  static constexpr int DMAX = 32 * DPL;               // head dims held
  static constexpr int EPV = 16 / (int)sizeof(T);     // elements a copy
  static constexpr int KSTR = DMAX + EPV;             // K row stride
  static constexpr int STAGE = TP * (KSTR + DMAX);    // K + V, elements
  static constexpr int RING = WARPS * NS * STAGE * (int)sizeof(T);
  static constexpr int MERGE = (2 * WARPS * RB + WARPS * RB * DMAX) * 4;
  static constexpr int Q = RB * DMAX * 4;             // scaled q, f32
  static constexpr int BODY = Q + (RING > MERGE ? RING : MERGE);
};

__host__ __device__ constexpr int bt_bytes(int mp) {
  return (mp * 4 + 15) / 16 * 16;
}

// DPL: head dims per lane in the accumulator (the kernel holds
// Dh <= 32 * DPL, zero padded). RB: query rows per CTA (1 for a decode
// step, else 8; a last block's missing rows run on zero queries and are
// not written). vec: rows of the stores are 16-byte aligned slices
// (cp.async), else they are copied an element at a time.
template <typename T, int DPL, int RB>
__global__ void __launch_bounds__(THREADS)
    flash_attn_paged_kernel(const T* __restrict__ q,
                            const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int32_t* __restrict__ bt,
                            const int32_t* __restrict__ pos,
                            T* __restrict__ o, int W, int C, int dh,
                            int page, int mp, int64_t rows, float sm_scale,
                            int vec) {
  using P = Plan<T, DPL, RB>;
  constexpr int DMAX = P::DMAX, EPV = P::EPV, KSTR = P::KSTR;
  constexpr int KC = DMAX / 2;  // K columns a lane scores: half a row
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* bts = reinterpret_cast<int32_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + bt_bytes(mp));
  T* ring = reinterpret_cast<T*>(smem + bt_bytes(mp) + P::Q);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t sl = blockIdx.x;
  const int h = blockIdx.y;
  const int w0 = blockIdx.z * RB;
  const int nrows = W - w0 < RB ? W - w0 : RB;
  const int p0 = __ldg(pos + sl);
  const int64_t col0 = (int64_t)h * dh;

  for (int i = threadIdx.x; i < mp; i += THREADS)
    bts[i] = __ldg(bt + sl * mp + i);
  for (int i = threadIdx.x; i < RB * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    qs[i] = (r < nrows && d < dh)
                ? to_f32<T>(q[(sl * W + w0 + r) * C + col0 + d]) * sm_scale
                : 0.f;
  }
  if (dh < DMAX) {  // K's padding columns meet q's zeros: keep them 0
    float4* z = reinterpret_cast<float4*>(ring);
    for (int i = threadIdx.x; i < P::RING / 16; i += THREADS)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the last position any row of this CTA sees
  const int64_t last = (int64_t)p0 + w0 + nrows - 1;
  const int nsub = (page + TP - 1) / TP;  // units a page
  const int nunits = mp * nsub;
  auto page_of = [&](int u) { return nsub == 1 ? u : u / nsub; };

  // a unit no row sees is skipped when the entry before it lists the same
  // page and that page is wholly past `last` (its units were scanned)
  auto next_unit = [&](int u) {
    for (; u < nunits; u += WARPS) {
      const int pi = page_of(u);
      const int64_t t0 = (int64_t)pi * page + (u - pi * nsub) * TP;
      if (t0 <= last || pi == 0 || bts[pi] != bts[pi - 1] ||
          (int64_t)(pi - 1) * page <= last)
        break;
    }
    return u;
  };

  T* wring = ring + warp * NS * P::STAGE;
  auto issue = [&](int u, int stage) {
    T* ks = wring + stage * P::STAGE;
    T* vs = ks + TP * KSTR;
    const int pi = page_of(u), sub = u - pi * nsub;
    const int64_t t0 = (int64_t)pi * page + sub * TP;
    const int n_t = page - sub * TP < TP ? page - sub * TP : TP;
    const int64_t base = (int64_t)bts[pi] * page + sub * TP;
    const bool kv = t0 <= last;
    if (n_t < TP)  // rows past a short page: zeros, read as 0 * 0
      for (int i = lane; i < (TP - n_t) * DMAX; i += 32)
        vs[n_t * DMAX + i] = from_f32<T>(0.f);
    if (vec && dh == DMAX) {
      // a lane copies one 16-byte column slice of every RPI-th row
      constexpr int NV = DMAX / EPV, RPI = 32 / NV;
      const int c = (lane % NV) * EPV;
      for (int r = lane / NV; r < n_t; r += RPI) {
        int64_t rid = base + r;
        rid = rid < 0 ? 0 : (rid >= rows ? rows - 1 : rid);
        const int64_t g = rid * C + col0 + c;
        if (kv) cp_async16(ks + r * KSTR + c, kp + g);
        cp_async16(vs + r * DMAX + c, vp + g);
      }
    } else if (vec) {
      const int nv = dh / EPV;
      for (int i = lane; i < n_t * nv; i += 32) {
        const int r = i / nv, c = (i - r * nv) * EPV;
        int64_t rid = base + r;
        rid = rid < 0 ? 0 : (rid >= rows ? rows - 1 : rid);
        const int64_t g = rid * C + col0 + c;
        if (kv) cp_async16(ks + r * KSTR + c, kp + g);
        cp_async16(vs + r * DMAX + c, vp + g);
      }
    } else {
      for (int i = lane; i < n_t * dh; i += 32) {
        const int r = i / dh, c = i - r * dh;
        int64_t rid = base + r;
        rid = rid < 0 ? 0 : (rid >= rows ? rows - 1 : rid);
        const int64_t g = rid * C + col0 + c;
        if (kv) ks[r * KSTR + c] = kp[g];
        vs[r * DMAX + c] = vp[g];
      }
    }
  };

  float m[RB], l[RB], acc[RB][DPL], zv[DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;  // this lane's share of the row sum (lanes 0-15 only)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) zv[j] = 0.f;  // sum of 0 * V no row sees

  // scores: lane t and t + 16 each take half of position t's row
  const int tl = lane & 15, hf = lane >> 4;
  auto compute = [&](int u, int stage) {
    const T* ks = wring + stage * P::STAGE;
    const T* vs = ks + TP * KSTR;
    const int pi = page_of(u), sub = u - pi * nsub;
    const int64_t t0 = (int64_t)pi * page + sub * TP;
    const int n_t = page - sub * TP < TP ? page - sub * TP : TP;
    if (t0 > last) {  // no row sees the unit: 0 * V for every row
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        float vv[DPL];
        lds(vs + t * DMAX + lane * DPL, vv);
#pragma unroll
        for (int j = 0; j < DPL; ++j) zv[j] = fmaf(0.f, vv[j], zv[j]);
      }
      return;
    }
    const T* krow = ks + tl * KSTR + hf * KC;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int64_t qpos = (int64_t)p0 + w0 + r;
      const float* qrow = qs + r * DMAX + hf * KC;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int c = 0; c < KC; c += EPV) {
        float kc[EPV];
        ld16(krow + c, kc);
#pragma unroll
        for (int e = 0; e < EPV; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + c + e);
          s0 = fmaf(qv.x, kc[e], s0);
          s1 = fmaf(qv.y, kc[e + 1], s1);
          s0 = fmaf(qv.z, kc[e + 2], s0);
          s1 = fmaf(qv.w, kc[e + 3], s1);
        }
      }
      float dot = s0 + s1;
      dot += __shfl_xor_sync(FULL, dot, 16);
      const bool vis = tl < n_t && t0 + tl <= qpos;
      const float sc = vis ? dot : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max16(sc));
      const float corr = expf(m[r] - m_new);
      const float p = vis ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * corr + (hf ? 0.f : p);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
      // every position of the unit, masked ones with p == 0 (0 * V)
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        const float pt = __shfl_sync(FULL, p, t);
        float vv[DPL];
        lds(vs + t * DMAX + lane * DPL, vv);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] = fmaf(pt, vv[j], acc[r][j]);
      }
      m[r] = m_new;
    }
  };

  // the warp's units, NS in flight: its k-th unit lives in stage k % NS;
  // inflight[0] is the one to compute next
  int inflight[NS];
  int nxt = next_unit(warp);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    inflight[s] = nxt;
    if (nxt < nunits) {
      issue(nxt, s);
      nxt = next_unit(nxt + WARPS);
    }
    cp_async_commit();
  }
  for (int stage = 0; inflight[0] < nunits;
       stage = stage + 1 == NS ? 0 : stage + 1) {
    cp_async_wait<NS - 1>();
    __syncwarp();
    compute(inflight[0], stage);
    __syncwarp();  // the warp is done with this stage
#pragma unroll
    for (int s = 0; s + 1 < NS; ++s) inflight[s] = inflight[s + 1];
    inflight[NS - 1] = nxt;
    if (nxt < nunits) {
      issue(nxt, stage);
      nxt = next_unit(nxt + WARPS);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the warps' partial states of each row
  __syncthreads();  // every warp is done with its ring
  float* ms = reinterpret_cast<float*>(ring);  // WARPS x RB
  float* ls = ms + WARPS * RB;                 // WARPS x RB
  float* as = ls + WARPS * RB;                 // WARPS x RB x DMAX
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const float lsum = warp_sum(l[r]);
    if (lane == 0) {
      ms[warp * RB + r] = m[r];
      ls[warp * RB + r] = lsum;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      as[(warp * RB + r) * DMAX + lane * DPL + j] = acc[r][j] + zv[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
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

template <typename T, int DPL, int RB>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int32_t* bt, const int32_t* pos, void* o, int S,
                   int W, int C, int heads, int page, int mp, int64_t rows,
                   float sm_scale, cudaStream_t s) {
  const int dh = C / heads;
  const int smem = bt_bytes(mp) + Plan<T, DPL, RB>::BODY;
  auto kernel = flash_attn_paged_kernel<T, DPL, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const int eb = (int)sizeof(T);
  const int vec = (dh * eb) % 16 == 0 && (C * eb) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  dim3 grid((unsigned)S, (unsigned)heads, (unsigned)((W + RB - 1) / RB));
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), W, C, dh, page,
      mp, rows, sm_scale, vec);
  return cudaGetLastError();
}

template <typename T, int DPL>
cudaError_t dispatch_rb(const void* q, const void* kp, const void* vp,
                        const int32_t* bt, const int32_t* pos, void* o,
                        int S, int W, int C, int heads, int page, int mp,
                        int64_t rows, float sm_scale, cudaStream_t s) {
  if (W == 1)
    return launch<T, DPL, 1>(q, kp, vp, bt, pos, o, S, W, C, heads, page,
                             mp, rows, sm_scale, s);
  return launch<T, DPL, 8>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                           rows, sm_scale, s);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int32_t* bt, const int32_t* pos, void* o, int S,
                       int W, int C, int heads, int page, int mp,
                       int64_t rows, float sm_scale, cudaStream_t s) {
  const int dh = C / heads;
  if (dh <= 32)
    return dispatch_rb<T, 1>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                             rows, sm_scale, s);
  if (dh <= 64)
    return dispatch_rb<T, 2>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                             rows, sm_scale, s);
  return dispatch_rb<T, 4>(q, kp, vp, bt, pos, o, S, W, C, heads, page, mp,
                           rows, sm_scale, s);
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
  if (S <= 0 || W <= 0 || (W + 7) / 8 > 65535 || heads <= 0 ||
      heads > 65535 || C <= 0 || C % heads != 0 || C / heads > 128 ||
      page <= 0 || mp <= 0 || rows <= 0)
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
