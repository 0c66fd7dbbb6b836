// JPEG decode through the CUDA toolkit's nvJPEG: built where jpeglib.h is
// missing and nvjpeg.h is found. A decoder owns one nvJPEG handle and
// decoder state, a non-blocking stream, and a device and a pinned host
// buffer. The pipeline makes one decoder per worker and keeps it for its
// whole life, so nothing is created or freed at an epoch's end. An image
// is decoded on the card (nvjpegDecode: Huffman decoding on the host,
// the rest on the device) to interleaved RGB (or Y for one channel),
// copied back on the decoder's stream and synchronised, so the augmenting
// code after it sees an HWC uint8 image as the libjpeg codec gives it,
// up to the two decoders' rounding and chroma upsampling. Nothing here
// touches the stream of the caller's CUDA work.
//
// A stream nvJPEG rejects as corrupt or unsupported is a bad image; any
// other failure (no device, an allocation, a launch, a copy) is a decoder
// fault, which the pipeline raises.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include "jpeg_codec.h"

namespace {

// The buffers a decoder starts with: an RGB image of up to 4 MiB (about
// 1.4 megapixels, above most photographs in an image dataset), so that
// growing them is rare.
constexpr size_t kInitialBytes = size_t{4} << 20;

std::string cuda_fault(const char* what, cudaError_t e) {
  return std::string("nvjpeg codec: ") + what + ": " + cudaGetErrorString(e);
}

std::string nvjpeg_fault(const char* what, nvjpegStatus_t s) {
  return std::string("nvjpeg codec: ") + what + " returned nvjpegStatus " +
         std::to_string(static_cast<int>(s));
}

// The statuses that say the bitstream is at fault, not the decoder.
bool bad_stream(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_BAD_JPEG ||
         s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
         s == NVJPEG_STATUS_INCOMPLETE_BITSTREAM;
}

}  // namespace

struct JpegDecoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  uint8_t* host = nullptr;
  size_t cap = 0;
  // outgrown buffers, freed only with the decoder: cudaFree and
  // cudaFreeHost synchronise the whole device
  std::vector<std::pair<uint8_t*, uint8_t*>> retired;

  ~JpegDecoder() {
    retired.emplace_back(dev, host);
    for (auto& b : retired) {
      if (b.first) cudaFree(b.first);
      if (b.second) cudaFreeHost(b.second);
    }
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
    if (handle) nvjpegDestroy(handle);
  }

  bool reserve(size_t bytes, std::string* err) {
    if (bytes <= cap) return true;
    const size_t want = std::max(bytes, 2 * cap);
    uint8_t* d = nullptr;
    uint8_t* hb = nullptr;
    cudaError_t e = cudaMalloc(reinterpret_cast<void**>(&d), want);
    if (e != cudaSuccess) {
      if (err) *err = cuda_fault(("cudaMalloc of " + std::to_string(want) +
                                  " bytes").c_str(), e);
      return false;
    }
    e = cudaMallocHost(reinterpret_cast<void**>(&hb), want);
    if (e != cudaSuccess) {
      cudaFree(d);
      if (err) *err = cuda_fault(("cudaMallocHost of " +
                                  std::to_string(want) + " bytes").c_str(),
                                 e);
      return false;
    }
    if (dev) retired.emplace_back(dev, host);
    dev = d;
    host = hb;
    cap = want;
    return true;
  }
};

JpegDecoder* jpeg_decoder_create(std::string* err) {
  JpegDecoder* d = new JpegDecoder();
  nvjpegStatus_t s = nvjpegCreateSimple(&d->handle);
  if (s == NVJPEG_STATUS_SUCCESS) {
    s = nvjpegJpegStateCreate(d->handle, &d->state);
    if (s != NVJPEG_STATUS_SUCCESS && err)
      *err = nvjpeg_fault("nvjpegJpegStateCreate", s);
  } else if (err) {
    *err = nvjpeg_fault("nvjpegCreateSimple", s);
  }
  if (s == NVJPEG_STATUS_SUCCESS) {
    cudaError_t e =
        cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking);
    if (e != cudaSuccess) {
      d->stream = nullptr;
      if (err) *err = cuda_fault("cudaStreamCreateWithFlags", e);
      s = NVJPEG_STATUS_EXECUTION_FAILED;
    }
  }
  if (s != NVJPEG_STATUS_SUCCESS || !d->reserve(kInitialBytes, err)) {
    delete d;
    return nullptr;
  }
  return d;
}

void jpeg_decoder_destroy(JpegDecoder* d) { delete d; }

JpegStatus jpeg_decode(JpegDecoder* d, const uint8_t* buf, size_t len,
                       int want_channels, std::vector<uint8_t>* out, int* w,
                       int* h, std::string* err) {
  if (len == 0) return kJpegBadImage;
  int ncomp = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t s =
      nvjpegGetImageInfo(d->handle, buf, len, &ncomp, &sub, ws, hs);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (bad_stream(s)) return kJpegBadImage;
    if (err) *err = nvjpeg_fault("nvjpegGetImageInfo", s);
    return kJpegDecoderFault;
  }
  const int c = want_channels == 1 ? 1 : 3;
  const size_t pitch = static_cast<size_t>(ws[0]) * c;
  const size_t bytes = pitch * static_cast<size_t>(hs[0]);
  if (bytes == 0) return kJpegBadImage;
  if (!d->reserve(bytes, err)) return kJpegDecoderFault;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = d->dev;
  img.pitch[0] = static_cast<unsigned int>(pitch);
  s = nvjpegDecode(d->handle, d->state, buf, len,
                   c == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img,
                   d->stream);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (bad_stream(s)) return kJpegBadImage;
    if (err) *err = nvjpeg_fault("nvjpegDecode", s);
    return kJpegDecoderFault;
  }
  cudaError_t e = cudaMemcpyAsync(d->host, d->dev, bytes,
                                  cudaMemcpyDeviceToHost, d->stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(d->stream);
  if (e != cudaSuccess) {
    if (err) *err = cuda_fault("copying the decoded image", e);
    return kJpegDecoderFault;
  }
  out->assign(d->host, d->host + bytes);
  *w = ws[0];
  *h = hs[0];
  return kJpegOk;
}

const char* jpeg_codec_name() { return "nvjpeg"; }
