// Flash-attention forward tile for Hopper (sm_90a), shared by
// flash_attn.cu (B3) and flash_fwd.cu (B7): both scores and the P.V
// product run on the TF32 tensor cores (wgmma) with an error-compensated
// split, so the function stays the f32 one.
//
// The function: q is scaled in f32 before the dot; f32 running max, sum
// and accumulator; masked scores (causal with offset tk - tq, and the
// tail past tk) are -1e30 BEFORE the max and p is forced to 0 after the
// exp; the output is acc / max(l, 1e-30), rounded once to the input
// dtype, so a row that sees no key is exactly 0. With ROUND_P (B7) each
// p is rounded to the input dtype before it meets V and l takes it
// unrounded; without it (B3) p meets V as f32. The running max moves
// once per 64-row K/V tile (BK), which sets where B7's bf16 p rounds.
//
// Why the split: one TF32 product keeps 10 mantissa bits of each
// operand (max abs error ~1e-3 at T 1024, far outside the f32
// tolerance). Each f32 operand x is split into big = tf32(x) and
// small = tf32(x - big), and a product of two full-f32 operands is
// a_big.b_big + a_big.b_small + a_small.b_big (3 wgmmas; the dropped
// a_small.b_small is ~2^-22 relative). A bf16 value is exact in TF32
// and needs no small part: bf16 K and V take 2 products (the scaled q's
// and B3's f32 p's small parts), B7's bf16-rounded p against bf16 V 1.
//
// What bounds it: at the training shape (8, 12, 1024, 64) f32 causal,
// 3 x 12.9 GFLOP at 495 TFLOP/s dense TF32 is 0.078 ms, the bytes
// (100.7 MB) 0.030 ms: the tensor cores' rate over three products. What
// holds it back today: the softmax and the split of each staged tile
// run on the CUDA cores between the products, not beside them.
//
// Design: one CTA per (b*h, BQ q rows), one warpgroup (128 threads) per
// 64 q rows: BQ = 128 for head dims up to 64, 64 above (shared memory).
// Heavy causal q tiles launch first (blockIdx.y reversed). The head dim
// is zero-padded to DP (32, 64 or 128) in shared memory. Q is scaled,
// split and staged once; each 64-row K/V tile is read from global memory
// into registers while the previous tile multiplies, then split by all
// threads into a second shared buffer (one split per staged tile, shared
// by every q row of the CTA). Shared tiles are K-major with the 128-byte
// swizzle (wgmma's .tf32 takes K-major operands only): K as stored,
// (kv, d); V transposed to (d, kv). S = Q.K^T is a wgmma from shared
// memory into registers; the softmax runs on the accumulator fragments
// (row max and sum by quad shuffles; masks only on the tiles a warp does
// not see whole); P feeds the P.V wgmma straight from registers. The accumulator holds S's columns 2t and 2t+1 of each
// 8-wide slice where the register A fragment wants columns t and t+4, so
// V^T's kv order is permuted within each 8 (logical k = t <- kv 2t,
// k = t + 4 <- kv 2t + 1) and the fragment is used as it lies.
// No branch may part a warpgroup between a wgmma and its wait (ptxas
// then serializes every wgmma): the next tile's reads and their split
// run whether or not a next tile exists (past the last one they read
// nothing), and a warpgroup whose rows see none of a tile skips the
// whole tile's products in one branch.
// Each including file defines its own extern "C" entry through
// flash_entry<ROUND_P>.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;  // kv rows per staged tile
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------ wgmma (PTX)
// D (64 x 64, f32) += A (64 x 8) * B (8 x 64), A and B tf32 in shared
// memory, both K-major (descriptors); scale_d 0 overwrites D.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 8, tf32, the register fragment a0..a3)
// * B (8 x 32, tf32, K-major in shared memory).
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 8, tf32, the register fragment a0..a3)
// * B (8 x 64, tf32, K-major in shared memory).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 8, tf32, the register fragment a0..a3)
// * B (8 x 128, tf32, K-major in shared memory).
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  if constexpr (N == 32)
    mma_rs_n32(d, a0, a1, a2, a3, b);
  else if constexpr (N == 64)
    mma_rs_n64(d, a0, a1, a2, a3, b);
  else
    mma_rs_n128(d, a0, a1, a2, a3, b);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin a register across the asynchronous wgmma: the compiler may not
// read, move or reuse it on either side of this point.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Order this thread's shared-memory stores before wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (SBO), LBO unused by this layout.
__device__ __forceinline__ uint64_t sdesc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Float offset of element (r, c) of a K-major tile of R rows (c along
// K): K blocks of 32 floats (128 bytes) of R rows each; within a block
// row r's 16-byte chunk j sits at chunk j ^ (r % 8). Tiles start on a
// 1024-byte boundary.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * (R * 32) + r * 32 + ((((c >> 2) ^ r) & 7) << 2) +
         (c & 3);
}

// The descriptor of k-step s (8 columns) of such a tile.
template <int R>
__device__ __forceinline__ uint64_t kstep(const float* tile, int s) {
  return sdesc(tile + (s >> 2) * (R * 32) + (s & 3) * 8);
}

// ------------------------------------------------------------ softmax
__device__ __forceinline__ float tree_max16(const float (&x)[16]) {
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = fmaxf(x[i], x[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = fmaxf(a[i], a[i + 4]);
  return fmaxf(fmaxf(a[0], a[2]), fmaxf(a[1], a[3]));
}
__device__ __forceinline__ float tree_sum16(const float (&x)[16]) {
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = x[i] + x[i + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] += a[i + 4];
  return (a[0] + a[2]) + (a[1] + a[3]);
}

// ------------------------------------------------------------ the split
// Round to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32r(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
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

// Four consecutive elements of a row, as they lie in global memory
// (f32: 16 bytes; bf16: 8 bytes), and their f32 values.
template <typename T> struct Raw4;
template <> struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ float4 f() const { return v; }
};
template <> struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ float4 f() const {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b),
                       __high2float(b));
  }
};

// Elements c..c+3 of `row` (d elements), zero past d or when !ok. VEC:
// d % 4 == 0 and the tensors aligned for one vector load (f32 16 bytes,
// bf16 8); else element by element. The guarded reads compile to
// predicated loads, no branch.
template <typename T, bool VEC>
__device__ __forceinline__ Raw4<T> load4(const T* row, int c, int d,
                                         bool ok) {
  Raw4<T> r;
  if constexpr (VEC) {
    const bool live = ok && c < d;
    if constexpr (std::is_same<T, float>::value) {
      r.v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) r.v = __ldg(reinterpret_cast<const float4*>(row + c));
    } else {
      r.v = make_uint2(0u, 0u);
      if (live) r.v = __ldg(reinterpret_cast<const uint2*>(row + c));
    }
  } else {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = ok && c + i < d ? to_f32(__ldg(row + c + i)) : 0.f;
    if constexpr (std::is_same<T, float>::value) {
      r.v = make_float4(e[0], e[1], e[2], e[3]);
    } else {
      const __nv_bfloat162 a = __floats2bfloat162_rn(e[0], e[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(e[2], e[3]);
      r.v.x = *reinterpret_cast<const uint32_t*>(&a);
      r.v.y = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  return r;
}

// The kv row that V^T's logical k holds within an 8-row slice: k = t
// <- kv 2t, k = t + 4 <- kv 2t + 1 (see the header).
__device__ __forceinline__ int k_to_kv(int k) {
  return k < 4 ? 2 * k : 2 * (k - 4) + 1;
}

// ------------------------------------------------------------ the kernel
// T: f32 or bf16. DP: the head dim padded (32, 64, 128). NW: warpgroups
// (64 q rows each). ROUND_P: B7's p.astype(v.dtype).
template <typename T, int DP, int NW, bool ROUND_P>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int NT = 128 * NW;     // threads
  static constexpr int BQ = 64 * NW;      // q rows per CTA
  static constexpr int NPV = F32 ? 3 : (ROUND_P ? 1 : 2);  // for P.V
  static constexpr int KV_PARTS = F32 ? 2 : 1;  // big (and small) K, V
  // head dims up to 64 overlap the next tile's global reads with this
  // tile's products (two K/V buffers); 128 has room for one
  static constexpr bool PREFETCH = DP <= 64;
  static constexpr int NBUF = PREFETCH ? 2 : 1;
  static constexpr int CH = BK * DP / 4 / NT;  // 4-element chunks/thread
  static constexpr int Q_FLOATS = BQ * DP;
  static constexpr int KV_FLOATS = BK * DP;
  static constexpr int BUF_FLOATS = 2 * KV_PARTS * KV_FLOATS;
  static constexpr int SMEM_BYTES =
      4 * (2 * Q_FLOATS + NBUF * BUF_FLOATS) + 1024;  // + alignment
  // CTAs an SM holds by shared memory (228 KB, 1 KB reserved per CTA),
  // at most as many as leave each thread 128 registers: the register
  // budget the compiler is held to
  static constexpr int BY_SMEM = 233472 / (SMEM_BYTES + 1024);
  static constexpr int BY_REGS = 65536 / (128 * NT);
  static constexpr int MIN_BLOCKS = BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS;
  static_assert(CH * NT * 4 == BK * DP, "tile split");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

// VEC (see load4) is a template parameter, not a runtime flag, so that
// no branch on it sits between a wgmma and its wait.
template <typename T, int DP, int NW, bool ROUND_P, bool VEC>
__global__ void __launch_bounds__(128 * NW,
                                  (Tile<T, DP, NW, ROUND_P>::MIN_BLOCKS))
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int tq,
                      int tk, int d, int causal, float sm_scale) {
  using C = Tile<T, DP, NW, ROUND_P>;
  constexpr int NT = C::NT, BQ = C::BQ, CH = C::CH;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* qb_s = sm;                      // Q big   (BQ x DP, K-major)
  float* qs_s = sm + C::Q_FLOATS;        // Q small
  float* kv_s = sm + 2 * C::Q_FLOATS;    // NBUF x [K big, K small,
                                         //         V^T big, V^T small]

  const int64_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qg = q + bh * tq * d;
  const T* kg = k + bh * tk * d;
  const T* vg = v + bh * tk * d;

  // -- tiles the CTA, and this warpgroup, must see (causal pruning)
  const int off = tk - tq;  // causal diagonal offset (0 when square)
  const int all_tiles = (tk + BK - 1) / BK;
  auto tiles_upto = [&](int row_end) {  // tiles seen by rows < row_end
    if (!causal) return all_tiles;
    const int last = row_end - 1 + off;
    const int seen = last < 0 ? 0 : last / BK + 1;
    return seen < all_tiles ? seen : all_tiles;
  };
  const int n_tiles = tiles_upto(min(q0 + BQ, tq));
  const int r0 = q0 + 64 * wg;  // this warpgroup's first q row
  const int wg_tiles = r0 >= tq ? 0 : tiles_upto(min(r0 + 64, tq));

  // -- K/V tiles: read (global -> registers), then split into a buffer.
  // K: chunk i of the tile is row i / (DP/4), columns 4(i % (DP/4))...,
  // stored as float4 (a quarter warp covers one 128-byte row: no bank
  // conflict). V: a warp takes 16 consecutive logical k of 8 head dims,
  // lane l logical k (l >> 1), dims 4(l & 1)..+3, so that the transposed
  // scalar stores of each component hit 32 distinct banks.
  Raw4<T> kr[CH], vr[CH];
  auto load_tile = [&](int kt, bool live) {  // !live: zeros, no reads
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int i = tid + NT * j;
      const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const int kv = kt * BK + r;
      kr[j] = load4<T, VEC>(kg + (int64_t)kv * d, c, d, live && kv < tk);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int u = warp + (NT / 32) * j;  // unit: 16 k x 8 dims
      const int kk = (u & 3) * 16 + (lane >> 1);
      const int r = (kk & ~7) | k_to_kv(kk & 7);
      const int c = (u >> 2) * 8 + (lane & 1) * 4;
      const int kv = kt * BK + r;
      vr[j] = load4<T, VEC>(vg + (int64_t)kv * d, c, d, live && kv < tk);
    }
  };
  auto store_tile = [&](int buf) {
    float* kb_s = kv_s + buf * C::BUF_FLOATS;
    float* ks_s = kb_s + C::KV_FLOATS;
    float* vb_s = kb_s + C::KV_PARTS * C::KV_FLOATS;
    float* vs_s = vb_s + C::KV_FLOATS;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int i = tid + NT * j;
      const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const float4 x = kr[j].f();
      if constexpr (C::F32) {
        const float4 b =
            make_float4(tf32r(x.x), tf32r(x.y), tf32r(x.z), tf32r(x.w));
        *reinterpret_cast<float4*>(kb_s + swz<BK>(r, c)) = b;
        *reinterpret_cast<float4*>(ks_s + swz<BK>(r, c)) =
            make_float4(tf32r(x.x - b.x), tf32r(x.y - b.y),
                        tf32r(x.z - b.z), tf32r(x.w - b.w));
      } else {
        *reinterpret_cast<float4*>(kb_s + swz<BK>(r, c)) = x;
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int u = warp + (NT / 32) * j;
      const int kk = (u & 3) * 16 + (lane >> 1);
      const int c = (u >> 2) * 8 + (lane & 1) * 4;
      const float4 x = vr[j].f();
      const float xe[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = swz<DP>(c + e, kk);
        if constexpr (C::F32) {
          const float b = tf32r(xe[e]);
          vb_s[at] = b;
          vs_s[at] = tf32r(xe[e] - b);
        } else {
          vb_s[at] = xe[e];
        }
      }
    }
  };

  // -- Q: scaled in f32, split, staged once (tile 0's reads first, so
  // that their latency overlaps Q's)
  if (C::PREFETCH && n_tiles > 0) load_tile(0, true);
#pragma unroll
  for (int j = 0; j < BQ * DP / 4 / NT; ++j) {
    const int i = tid + NT * j;
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const float4 x =
        load4<T, VEC>(qg + (int64_t)(q0 + r) * d, c, d, q0 + r < tq).f();
    const float xs[4] = {x.x * sm_scale, x.y * sm_scale, x.z * sm_scale,
                         x.w * sm_scale};
    float b[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[e] = tf32r(xs[e]);
      s[e] = tf32r(xs[e] - b[e]);
    }
    *reinterpret_cast<float4*>(qb_s + swz<BQ>(r, c)) =
        make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(qs_s + swz<BQ>(r, c)) =
        make_float4(s[0], s[1], s[2], s[3]);
  }

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row_base = r0 + 16 * (warp & 3) + g;  // rows of acc[4j + {0,1}]
  const float* qb_w = qb_s + 64 * wg * 32;         // this warpgroup's rows
  const float* qs_w = qs_s + 64 * wg * 32;

  if (n_tiles > 0) {
    if (!C::PREFETCH) load_tile(0, true);
    store_tile(0);
  }
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = C::PREFETCH ? (kt & 1) : 0;
    if (!C::PREFETCH && kt > 0) {
      load_tile(kt, true);
      store_tile(0);
      fence_async_smem();
      __syncthreads();
    }
    const float* kb_s = kv_s + buf * C::BUF_FLOATS;
    const float* ks_s = kb_s + C::KV_FLOATS;
    const float* vb_s = kb_s + C::KV_PARTS * C::KV_FLOATS;
    const float* vs_s = vb_s + C::KV_FLOATS;
    float sacc[32];
    float psm[32];  // p's small part (NPV >= 2)
    if (kt < wg_tiles) {  // else every row of the warpgroup is masked
      // ---- S = (q * scale) . K^T, 3 products per 8-wide k-step
      // (2 in bf16: K has no small part)
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int s = 0; s < DP / 8; ++s) {
        const uint64_t qb = kstep<BQ>(qb_w, s), qs = kstep<BQ>(qs_w, s);
        const uint64_t kb = kstep<BK>(kb_s, s);
        mma_ss_n64(sacc, qs, kb, s > 0);
        if constexpr (C::F32) mma_ss_n64(sacc, qb, kstep<BK>(ks_s, s), 1);
        mma_ss_n64(sacc, qb, kb, 1);
      }
      wg_commit();
      // the next tile's reads, issued while S multiplies (issued before
      // the wgmma.fence, the fence would wait for them). Past the last
      // tile they read nothing and leave zeros for the idle buffer.
      if (C::PREFETCH) load_tile(kt + 1, kt + 1 < n_tiles);
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) pin(sacc[i]);

      // ---- online softmax on the fragments: rows row_base (+8). A
      // tile that every row of the warp sees whole takes the copy
      // without masks.
      const int kv0 = kt * BK + 2 * t4;
      auto softmax = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lim = causal ? min(tk, row_base + 8 * h + off + 1) : tk;
          float x[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            x[i] = sacc[4 * (i >> 1) + 2 * h + (i & 1)];
            if (MASK) x[i] = kv0 + 8 * (i >> 1) + (i & 1) < lim ? x[i] : NEG_INF;
          }
          float mx = tree_max16(x);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[h], mx);
          const float corr = expf(m[h] - m_new);
          m[h] = m_new;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            float p = expf(x[i] - m_new);
            if (MASK) p = kv0 + 8 * (i >> 1) + (i & 1) < lim ? p : 0.f;
            x[i] = p;
            const float pv = ROUND_P ? to_f32(from_f32<T>(p)) : p;
            const float b = tf32r(pv);
            sacc[4 * (i >> 1) + 2 * h + (i & 1)] = b;
            psm[4 * (i >> 1) + 2 * h + (i & 1)] = tf32r(pv - b);
          }
          l[h] = l[h] * corr + tree_sum16(x);
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            oacc[4 * j + 2 * h] *= corr;
            oacc[4 * j + 2 * h + 1] *= corr;
          }
        }
      };
      const int warp_row0 = r0 + 16 * (warp & 3);
      if (kt * BK + BK <= tk && (!causal || kt * BK + BK - 1 <= warp_row0 + off))
        softmax(std::false_type{});
      else
        softmax(std::true_type{});

      // ---- O += P . V, NPV products per 8-wide k-step, P from registers
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) pin(oacc[i]);
      wg_fence();
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        const uint64_t vb = kstep<DP>(vb_s, s);
        const uint32_t b0 = __float_as_uint(sacc[4 * s]),
                       b1 = __float_as_uint(sacc[4 * s + 2]),
                       b2 = __float_as_uint(sacc[4 * s + 1]),
                       b3 = __float_as_uint(sacc[4 * s + 3]);
        if constexpr (C::NPV >= 2)
          mma_rs<DP>(oacc, __float_as_uint(psm[4 * s]),
                     __float_as_uint(psm[4 * s + 2]),
                     __float_as_uint(psm[4 * s + 1]),
                     __float_as_uint(psm[4 * s + 3]), vb);
        if constexpr (C::NPV == 3)
          mma_rs<DP>(oacc, b0, b1, b2, b3, kstep<DP>(vs_s, s));
        mma_rs<DP>(oacc, b0, b1, b2, b3, vb);
      }
      wg_commit();
      if (C::PREFETCH) store_tile(buf ^ 1);  // overlaps the P.V products
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) pin(oacc[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        pin(sacc[i]);
        if constexpr (C::NPV >= 2) pin(psm[i]);
      }
    } else if (C::PREFETCH) {
      load_tile(kt + 1, kt + 1 < n_tiles);
      store_tile(buf ^ 1);
    }
    fence_async_smem();
    __syncthreads();
  }

  // -- out: acc / max(l, 1e-30), rounded once to T
  T* og = o + bh * tq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int row = row_base + 8 * h;
    if (row >= tq) continue;
    T* orow = og + (int64_t)row * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        if (c < d) orow[c] = from_f32<T>(oacc[4 * j + 2 * h + e] * inv);
      }
  }
}

template <typename T, int DP, int NW, bool ROUND_P, bool VEC>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o,
                      int bh, int tq, int tk, int d, int causal,
                      float sm_scale, cudaStream_t s) {
  using C = Tile<T, DP, NW, ROUND_P>;
  auto kern = flash_attn_kernel<T, DP, NW, ROUND_P, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)bh, (unsigned)((tq + C::BQ - 1) / C::BQ));
  kern<<<grid, C::NT, C::SMEM_BYTES, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, d, causal,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, int DP, int NW, bool ROUND_P>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int tq, int tk, int d, int causal,
                   float sm_scale, cudaStream_t s) {
  const uintptr_t align = sizeof(T) * 4;
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % align == 0 &&
      reinterpret_cast<uintptr_t>(k) % align == 0 &&
      reinterpret_cast<uintptr_t>(v) % align == 0)
    return launch_as<T, DP, NW, ROUND_P, true>(q, k, v, o, bh, tq, tk, d,
                                               causal, sm_scale, s);
  return launch_as<T, DP, NW, ROUND_P, false>(q, k, v, o, bh, tq, tk, d,
                                              causal, sm_scale, s);
}

template <typename T, bool ROUND_P>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int bh, int tq, int tk, int d, int causal,
                       float sm_scale, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32, 2, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal,
                                     sm_scale, s);
  if (d <= 64)
    return launch<T, 64, 2, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal,
                                     sm_scale, s);
  return launch<T, 128, 1, ROUND_P>(q, k, v, o, bh, tq, tk, d, causal,
                                    sm_scale, s);
}

// The common C entry: checks, then dispatch on dtype (0 = f32, 1 = bf16).
template <bool ROUND_P>
int flash_entry(const void* q, const void* k, const void* v, void* o, int bh,
                int tq, int tk, int d, int causal, float sm_scale, int dtype,
                void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (tq + 63) / 64 > 65535)
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
