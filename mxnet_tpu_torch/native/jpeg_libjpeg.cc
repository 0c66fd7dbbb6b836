// JPEG decode through libjpeg (or libjpeg-turbo's libjpeg interface), the
// codec of the JAX package's pipeline: built where jpeglib.h is found.
// Errors longjmp back out of the library: a corrupt record is a bad
// image, never an exit; only running out of memory is a decoder fault.
// The decoder holds no state.

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

#include <jpeglib.h>
#include <jerror.h>

#include "jpeg_codec.h"

struct JpegDecoder {};

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

}  // namespace

JpegDecoder* jpeg_decoder_create(std::string*) { return new JpegDecoder(); }

void jpeg_decoder_destroy(JpegDecoder* d) { delete d; }

JpegStatus jpeg_decode(JpegDecoder*, const uint8_t* buf, size_t len,
                       int want_channels, std::vector<uint8_t>* out, int* w,
                       int* h, std::string* err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    const bool oom = jerr.pub.msg_code == JERR_OUT_OF_MEMORY;
    jpeg_destroy_decompress(&cinfo);
    if (!oom) return kJpegBadImage;
    if (err) *err = "libjpeg: out of memory";
    return kJpegDecoderFault;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return kJpegBadImage;
  }
  cinfo.out_color_space = want_channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  int c = cinfo.output_components;
  out->resize(static_cast<size_t>(*w) * *h * c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
        static_cast<size_t>(cinfo.output_scanline) * *w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kJpegOk;
}

const char* jpeg_codec_name() { return "libjpeg"; }
