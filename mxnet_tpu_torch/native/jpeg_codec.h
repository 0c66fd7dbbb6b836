// The JPEG codec behind the image pipeline: one of jpeg_libjpeg.cc and
// jpeg_nvjpeg.cc is linked into the library, chosen when it is built.

#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

// What a decode ends in. A bad image is the record's fault: the pipeline
// counts it and zeroes its slot, as the JAX package's does. A decoder
// fault (a CUDA or nvJPEG call that failed, memory that could not be
// had) is not the record's: the pipeline stops and the caller raises.
enum JpegStatus {
  kJpegOk = 0,
  kJpegBadImage = 1,
  kJpegDecoderFault = 2,
};

// One decoder's state (for nvJPEG: its handle, stream and buffers). The
// pipeline makes one per worker when it is created and keeps them until
// it is destroyed, so an epoch's end or a reset rebuilds none.
struct JpegDecoder;

// A new decoder, or nullptr with *err saying what failed.
JpegDecoder* jpeg_decoder_create(std::string* err);
void jpeg_decoder_destroy(JpegDecoder* d);

// Decodes `len` bytes to HWC uint8 with `want_channels` channels (1: gray,
// else RGB). On kJpegDecoderFault, *err says what failed.
JpegStatus jpeg_decode(JpegDecoder* d, const uint8_t* buf, size_t len,
                       int want_channels, std::vector<uint8_t>* out, int* w,
                       int* h, std::string* err);

// The codec's name, as the Python side reports it.
const char* jpeg_codec_name();
