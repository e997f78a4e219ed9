// JPEG decode and encode on the card through nvJPEG, the CUDA toolkit's
// codec library (linked with -lnvjpeg).
//
// Not a port of a TPU kernel: the JAX package decodes its shards' frames on
// the host (cv2, or libjpeg in native/tario.cc) and uploads the pixels. Here
// a batch of JPEG byte strings is decoded straight into one device buffer
// [n, height, width, 3] of interleaved RGB (NVJPEG_OUTPUT_RGBI), so that full
// frames never cross PCIe as pixels: a 480 x 640 frame is ~30-150 KB of JPEG
// against 900 KB of pixels. The encoder writes the shards that chip_smoke.py
// makes on a machine without a host JPEG library.
//
// The library's IDCT and chroma upsampling are not libjpeg's: its pixels
// differ from cv2's by a few levels (see data/jpeg.py).
//
// Every entry returns 0 or an error code: a CUDA error as is, an nvJPEG
// status as kNvjpegBase + status, a size mismatch as kSizeMismatch.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstring>
#include <vector>

namespace {

constexpr int kNvjpegBase = 1000;
constexpr int kSizeMismatch = 2000;
constexpr int kBufferTooSmall = 2001;

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = 0;  // the batch size the batched decode was last initialised for
};

struct Encoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

#define HMV_NVJPEG(call)                                          \
  do {                                                            \
    const nvjpegStatus_t status_ = (call);                        \
    if (status_ != NVJPEG_STATUS_SUCCESS)                         \
      return kNvjpegBase + static_cast<int>(status_);             \
  } while (0)

#define HMV_CUDA(call)                                            \
  do {                                                            \
    const cudaError_t err_ = (call);                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_);       \
  } while (0)

const char* nvjpeg_status_string(int status) {
  switch (status) {
    case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: not supported on this device";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "nvJPEG: implementation not supported";
    default: return "nvJPEG: unknown status";
  }
}

}  // namespace

extern "C" {

const char* hmv_error_string(int code) {
  if (code == kSizeMismatch) return "the JPEG images of a batch differ in size";
  if (code == kBufferTooSmall) return "the encoded JPEG exceeds the output buffer";
  if (code >= kNvjpegBase) return nvjpeg_status_string(code - kNvjpegBase);
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// backend: an nvjpegBackend_t value. On the current device.
int hmv_jpeg_decoder_create(int backend, void** out) {
  Decoder* d = new Decoder();
  nvjpegStatus_t status = nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend), nullptr,
                                         nullptr, 0, &d->handle);
  if (status == NVJPEG_STATUS_SUCCESS) status = nvjpegJpegStateCreate(d->handle, &d->state);
  if (status != NVJPEG_STATUS_SUCCESS) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    return kNvjpegBase + static_cast<int>(status);
  }
  *out = d;
  return 0;
}

void hmv_jpeg_decoder_destroy(void* decoder) {
  Decoder* d = static_cast<Decoder*>(decoder);
  if (d == nullptr) return;
  if (d->state) nvjpegJpegStateDestroy(d->state);
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

// The luma size of one JPEG, from its header.
int hmv_jpeg_image_size(void* decoder, const unsigned char* data, size_t length, int* height,
                        int* width) {
  Decoder* d = static_cast<Decoder*>(decoder);
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  HMV_NVJPEG(nvjpegGetImageInfo(d->handle, data, length, &components, &subsampling, widths,
                                heights));
  *height = heights[0];
  *width = widths[0];
  return 0;
}

// Decode n JPEGs (host buffers data[i] of lengths[i] bytes), each height x
// width, into out: contiguous device uint8 [n, height, width, 3] RGB. One
// nvjpegDecodeBatched call on `stream`; returns after the stream has drained,
// so the host buffers and the decoder state are free again when it returns.
//
// The stream is drained before the decode too. On an H100 (CUDA 12.8,
// GPU_HYBRID backend), training with the decode on the training step's
// stream while the step was still queued there (chip_smoke.py phase 9,
// device_prefetch=False) failed a few steps in: NaN sample points, an
// out-of-bounds gather, then CUDNN_STATUS_EXECUTION_FAILED. With the stream
// drained first it has not failed since. Why a busy stream breaks it is not
// known: the decode's writes to `out` do wait for the stream's queued work.
int hmv_jpeg_decode(void* decoder, int n, const unsigned char* const* data,
                    const size_t* lengths, unsigned char* out, int height, int width,
                    void* stream) {
  Decoder* d = static_cast<Decoder*>(decoder);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) {
    int h = 0, w = 0;
    const int code = hmv_jpeg_image_size(decoder, data[i], lengths[i], &h, &w);
    if (code != 0) return code;
    if (h != height || w != width) return kSizeMismatch;
  }
  if (d->batch != n) {
    HMV_NVJPEG(nvjpegDecodeBatchedInitialize(d->handle, d->state, n, 1, NVJPEG_OUTPUT_RGBI));
    d->batch = n;
  }
  std::vector<nvjpegImage_t> dst(n);
  const size_t frame = static_cast<size_t>(height) * width * 3;
  for (int i = 0; i < n; ++i) {
    std::memset(&dst[i], 0, sizeof(nvjpegImage_t));
    dst[i].channel[0] = out + frame * i;
    dst[i].pitch[0] = static_cast<size_t>(width) * 3;
  }
  HMV_CUDA(cudaStreamSynchronize(s));
  HMV_NVJPEG(nvjpegDecodeBatched(d->handle, d->state, data, lengths, dst.data(), s));
  HMV_CUDA(cudaStreamSynchronize(s));
  return static_cast<int>(cudaGetLastError());
}

// quality: 1..100; chroma 4:2:0 (cv2.imencode's default). On the current device.
int hmv_jpeg_encoder_create(int quality, void** out) {
  Encoder* e = new Encoder();
  nvjpegStatus_t status = nvjpegCreateSimple(&e->handle);
  if (status == NVJPEG_STATUS_SUCCESS)
    status = nvjpegEncoderStateCreate(e->handle, &e->state, nullptr);
  if (status == NVJPEG_STATUS_SUCCESS)
    status = nvjpegEncoderParamsCreate(e->handle, &e->params, nullptr);
  if (status == NVJPEG_STATUS_SUCCESS)
    status = nvjpegEncoderParamsSetQuality(e->params, quality, nullptr);
  if (status == NVJPEG_STATUS_SUCCESS)
    status = nvjpegEncoderParamsSetSamplingFactors(e->params, NVJPEG_CSS_420, nullptr);
  if (status != NVJPEG_STATUS_SUCCESS) {
    if (e->params) nvjpegEncoderParamsDestroy(e->params);
    if (e->state) nvjpegEncoderStateDestroy(e->state);
    if (e->handle) nvjpegDestroy(e->handle);
    delete e;
    return kNvjpegBase + static_cast<int>(status);
  }
  *out = e;
  return 0;
}

void hmv_jpeg_encoder_destroy(void* encoder) {
  Encoder* e = static_cast<Encoder*>(encoder);
  if (e == nullptr) return;
  if (e->params) nvjpegEncoderParamsDestroy(e->params);
  if (e->state) nvjpegEncoderStateDestroy(e->state);
  if (e->handle) nvjpegDestroy(e->handle);
  delete e;
}

// Encode one contiguous device uint8 [height, width, 3] RGB image into the
// host buffer out of `capacity` bytes; *length gets the JPEG's size. Drains
// the stream first, as the decode does, and returns after it has drained.
int hmv_jpeg_encode(void* encoder, const unsigned char* rgb, int height, int width,
                    unsigned char* out, size_t capacity, size_t* length, void* stream) {
  Encoder* e = static_cast<Encoder*>(encoder);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HMV_CUDA(cudaStreamSynchronize(s));
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(rgb);
  src.pitch[0] = static_cast<size_t>(width) * 3;
  HMV_NVJPEG(nvjpegEncodeImage(e->handle, e->state, e->params, &src, NVJPEG_INPUT_RGBI, width,
                               height, s));
  size_t size = 0;
  HMV_NVJPEG(nvjpegEncodeRetrieveBitstream(e->handle, e->state, nullptr, &size, s));
  HMV_CUDA(cudaStreamSynchronize(s));
  *length = size;
  if (size > capacity) return kBufferTooSmall;
  HMV_NVJPEG(nvjpegEncodeRetrieveBitstream(e->handle, e->state, out, &size, s));
  HMV_CUDA(cudaStreamSynchronize(s));
  *length = size;
  return 0;
}

}  // extern "C"
