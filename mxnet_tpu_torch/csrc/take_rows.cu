// Row gather with clipped ids for Hopper (sm_90a).
//
// Replaces mxnet_tpu/kernels/take.py `_gather_kernel` (mxk_take_rows):
// out[i, :] = table[clip(ids[i], 0, V - 1), :] for a (V, D) table and a
// flat vector of L int32 ids. Pure data movement: the result is bitwise
// the table's row, whatever the element type, so the kernel copies bytes.
//
// Bound: memory bandwidth. Each output row is read once from the table
// and written once; there is no arithmetic. Design: one block per output
// row; the block clips its id once, then its threads copy the row in
// 16-byte vectors when the row's byte width and both base addresses allow
// it, else in 4- or 2-byte words. The TPU kernel prefetches the id
// vector to SMEM and lets a BlockSpec index_map DMA row ids[i] in lane
// chunks of block_d (which is why its guard wants D % 128 == 0); here a
// block reads its own id, and any D is copied.
//
// C interface for ctypes: mxk_take_rows launches on the caller's stream
// and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__global__ void take_rows_kernel(const W* __restrict__ table,
                                 const int32_t* __restrict__ ids,
                                 W* __restrict__ out, int64_t vocab,
                                 int64_t words_per_row) {
  const int64_t row = blockIdx.x;
  int64_t id = __ldg(ids + row);
  id = id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
  const W* src = table + id * words_per_row;
  W* dst = out + row * words_per_row;
  for (int64_t w = threadIdx.x; w < words_per_row; w += blockDim.x)
    dst[w] = __ldg(src + w);
}

template <typename W>
void launch(const void* table, const int32_t* ids, void* out, int64_t vocab,
            int64_t n_ids, int64_t row_bytes, int threads, cudaStream_t s) {
  take_rows_kernel<W><<<(unsigned)n_ids, threads, 0, s>>>(
      static_cast<const W*>(table), ids, static_cast<W*>(out), vocab,
      row_bytes / (int64_t)sizeof(W));
}

}  // namespace

// table: vocab rows of row_bytes bytes each; ids: n_ids int32; out: n_ids
// rows of row_bytes. row_bytes must be even (2-byte elements at least).
extern "C" int mxk_take_rows(const void* table, const int32_t* ids,
                             void* out, long long vocab, long long n_ids,
                             long long row_bytes, int threads, void* stream) {
  if (vocab <= 0 || n_ids <= 0 || n_ids > 0x7fffffffLL || row_bytes <= 0 ||
      row_bytes % 2 != 0 || threads <= 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    launch<uint4>(table, ids, out, vocab, n_ids, row_bytes, threads, s);
  else if (row_bytes % 4 == 0 && align % 4 == 0)
    launch<uint32_t>(table, ids, out, vocab, n_ids, row_bytes, threads, s);
  else
    launch<uint16_t>(table, ids, out, vocab, n_ids, row_bytes, threads, s);
  return (int)cudaGetLastError();
}

extern "C" const char* mxk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
