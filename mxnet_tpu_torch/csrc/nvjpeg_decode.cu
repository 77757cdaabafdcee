// A thin C binding of nvJPEG (the CUDA toolkit's JPEG decoder).
//
// Replaces no TPU kernel. The JAX package decodes its records on the
// host with OpenCV (mxnet_tpu/io/image_record_iter.py `_decode_part`,
// cv2.imdecode); the port decodes them on the card, so that the decoded
// pixels never cross the host-to-device link. It is a library call, as
// cv2 is on the JAX side; the kernels written here are the ones that
// follow it: jpeg_color.cu (the planes to B, G, R) and image_aug.cu (the
// augment pass).
//
// The output is the planes as stored in the JPEG (NVJPEG_OUTPUT_YUV: Y at
// full size, Cb and Cr at their subsampled size). nvJPEG's own
// conversion to interleaved BGR upsamples 4:2:0 chroma otherwise than
// libjpeg-turbo does (cv2's decoder), so the port ends the decode in its
// own kernel with libjpeg-turbo's arithmetic.
//
// Decode path: one nvjpegDecodeBatched() call a batch, on a handle with
// the GPU_HYBRID backend (Huffman decode on the card for batches of more
// than 50 baseline JPEGs, on the host below that), on the caller's
// stream. Measured on an H100 while ResNet-50 trained on another stream:
// the simple per-image nvjpegDecode() waits for the whole card on every
// image (55 images/s on 4 threads), and the decoupled per-image API,
// which does not, still puts some five small copies and kernels an image
// between the step's kernels and slowed the step by a fifth; a batched
// call launches a few large ones a batch, and copies only the JPEG bytes.
// Nothing here waits beyond the caller's stream:
//   - device memory comes from cudaMallocAsync/cudaFreeAsync on the
//     stream nvJPEG names (the V2 allocator);
//   - pinned memory is never freed: a freed block goes back to a pool
//     with an event recorded on its stream, and is handed out again
//     only once that event has completed.
// One nvJPEG handle per process, created at first use and never
// destroyed. A batched-decode state belongs to its caller (one a
// pipeline, used by one thread at a time), who destroys it only once
// the work of its last decode has run: a state freed with decodes in
// flight would hand their buffers to the next allocation.
//
// C interface for ctypes. mxj_image_info parses a header on the host;
// mxj_state_create/mxj_state_destroy make and free a state;
// mxj_decode_batch decodes n images with a state on the caller's
// stream; mxj_counts reports the allocator's calls. The functions that
// return an int return 0, an nvjpegStatus_t, or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <atomic>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

// allocator calls: device allocations and frees, pinned blocks made and
// pinned blocks handed out again
std::atomic<long long> g_counts[4];

int dev_malloc(void*, void** ptr, size_t size, cudaStream_t s) {
  g_counts[0]++;
  return cudaMallocAsync(ptr, size ? size : 1, s) == cudaSuccess ? 0 : 1;
}

int dev_free(void*, void* ptr, size_t, cudaStream_t s) {
  g_counts[1]++;
  return cudaFreeAsync(ptr, s) == cudaSuccess ? 0 : 1;
}

struct PinnedBlock {
  void* ptr;
  size_t size;
  cudaEvent_t ready;
};

std::mutex g_pinned_mu;
std::vector<PinnedBlock> g_pinned_free;
std::unordered_map<void*, size_t> g_pinned_size;

int pinned_malloc(void*, void** ptr, size_t size, cudaStream_t) {
  size_t want = 4096;
  while (want < size) want <<= 1;
  std::lock_guard<std::mutex> lock(g_pinned_mu);
  for (size_t i = 0; i < g_pinned_free.size(); ++i) {
    PinnedBlock& b = g_pinned_free[i];
    if (b.size == want && cudaEventQuery(b.ready) == cudaSuccess) {
      *ptr = b.ptr;
      cudaEventDestroy(b.ready);
      g_pinned_free.erase(g_pinned_free.begin() + i);
      g_counts[3]++;
      return 0;
    }
  }
  cudaGetLastError();  // a pending query is not an error
  if (cudaHostAlloc(ptr, want, cudaHostAllocDefault) != cudaSuccess) return 1;
  g_pinned_size[*ptr] = want;
  g_counts[2]++;
  return 0;
}

int pinned_free(void*, void* ptr, size_t, cudaStream_t s) {
  std::lock_guard<std::mutex> lock(g_pinned_mu);
  cudaEvent_t ev;
  if (cudaEventCreateWithFlags(&ev, cudaEventDisableTiming) != cudaSuccess ||
      cudaEventRecord(ev, s) != cudaSuccess)
    return 1;
  g_pinned_free.push_back({ptr, g_pinned_size[ptr], ev});
  return 0;
}

nvjpegDevAllocatorV2_t g_dev_alloc = {dev_malloc, dev_free, nullptr};
nvjpegPinnedAllocatorV2_t g_pinned_alloc = {pinned_malloc, pinned_free,
                                            nullptr};

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;

int get_handle(nvjpegHandle_t* h) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_handle == nullptr) {
    nvjpegStatus_t st = nvjpegCreateExV2(NVJPEG_BACKEND_GPU_HYBRID, &g_dev_alloc,
                                         &g_pinned_alloc, 0, &g_handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return (int)st;
    }
  }
  *h = g_handle;
  return 0;
}

struct BatchState {
  nvjpegJpegState_t state = nullptr;
  int batch = 0;
};

}  // namespace

// info[0] components, info[1] nvjpegChromaSubsampling_t, info[2 + c]
// and info[6 + c] the width and height of component c (0..3).
extern "C" int mxj_image_info(const unsigned char* data, long long length,
                              int* info) {
  nvjpegHandle_t h;
  int rc = get_handle(&h);
  if (rc != 0) return rc;
  int n = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t st = nvjpegGetImageInfo(h, data, (size_t)length, &n, &ss,
                                         widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) return (int)st;
  info[0] = n;
  info[1] = (int)ss;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    info[2 + c] = widths[c];
    info[6 + c] = heights[c];
  }
  return 0;
}

extern "C" int mxj_state_create(void** out) {
  nvjpegHandle_t h;
  int rc = get_handle(&h);
  if (rc != 0) return rc;
  BatchState* st = new BatchState();
  if ((rc = nvjpegJpegStateCreate(h, &st->state))) {
    delete st;
    return rc;
  }
  *out = st;
  return 0;
}

extern "C" int mxj_state_destroy(void* state) {
  BatchState* st = static_cast<BatchState*>(state);
  int rc = st->state ? (int)nvjpegJpegStateDestroy(st->state) : 0;
  delete st;
  return rc;
}

// Decode n JPEGs into their planes on the caller's stream: image i to
// planes[3 i] (Y, rows of pitch[3 i] bytes), planes[3 i + 1] and
// planes[3 i + 2] (Cb and Cr, rows of pitch[3 i + 1] and pitch[3 i + 2]
// bytes).
extern "C" int mxj_decode_batch(void* state, int n,
                                const unsigned char* const* data,
                                const long long* length,
                                unsigned char* const* planes,
                                const int* pitch, void* stream) {
  if (n <= 0) return (int)NVJPEG_STATUS_INVALID_PARAMETER;
  BatchState* st = static_cast<BatchState*>(state);
  nvjpegHandle_t h;
  int rc = get_handle(&h);
  if (rc != 0) return rc;
  if (st->batch != n) {
    if ((rc = nvjpegDecodeBatchedInitialize(h, st->state, n, 1,
                                            NVJPEG_OUTPUT_YUV)))
      return rc;
    st->batch = n;
  }
  std::vector<nvjpegImage_t> img(n);
  std::vector<size_t> len(n);
  for (int i = 0; i < n; ++i) {
    std::memset(&img[i], 0, sizeof(nvjpegImage_t));
    for (int c = 0; c < 3; ++c) {
      img[i].channel[c] = planes[3 * i + c];
      img[i].pitch[c] = (unsigned int)pitch[3 * i + c];
    }
    len[i] = (size_t)length[i];
  }
  rc = nvjpegDecodeBatched(h, st->state, data, len.data(), img.data(),
                           static_cast<cudaStream_t>(stream));
  if (rc != 0) {
    st->batch = 0;  // a failed batch leaves the state to reinitialize
    return rc;
  }
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + (int)e;
}

extern "C" void mxj_counts(long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = g_counts[i];
}

extern "C" const char* mxj_status_string(int code) {
  if (code >= 1000)
    return cudaGetErrorString(static_cast<cudaError_t>(code - 1000));
  switch (code) {
    case NVJPEG_STATUS_SUCCESS: return "success";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "bad or unsupported JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "architecture mismatch";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "implementation not supported";
    default: return "unknown nvJPEG status";
  }
}
