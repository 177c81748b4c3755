// JPEG codec of the port's data stack on a host with libjpeg(-turbo):
// decode into a caller's buffer, decode of a crop window, and encode.
// data/codec.py picks this source when <jpeglib.h> is found, else
// jpeg_codec_nvjpeg.cc (the same C ABI over nvJPEG), and binds it with
// ctypes. Port of the JAX package's native jpeg decoder, plus an encoder
// so the port writes records without PIL.
//
// C ABI (every function returns 0 on success, negative on failure):
//   t2r_decode_jpeg(data, len, out, out_capacity, &h, &w)
//     decodes the whole buffer in one call straight into `out` as RGB
//     (whatever the file's subsampling or colour space); h and w are set
//     once the header is read, so a -3 reports the frame's size.
//   t2r_decode_jpeg_roi(data, len, out, out_capacity, crop_y, crop_x,
//                       crop_h, crop_w, &full_h, &full_w)
//     decodes only the crop window into `out` (crop_h x crop_w x 3),
//     bit-identical to a full decode followed by the same crop. With
//     libjpeg-turbo's scanline API (T2R_HAVE_JPEG_ROI, probed at build
//     time) rows above the window are skipped before IDCT/upsampling,
//     rows below are never read and columns are trimmed at iMCU
//     granularity; a progressive source, or a libjpeg without that API,
//     decodes the whole frame into scratch and copies the window.
//   t2r_encode_jpeg(pixels, h, w, channels, quality, out, out_capacity,
//                   &out_len)
//     baseline JPEG at `quality` with libjpeg's defaults (4:2:0 chroma for
//     RGB, standard Huffman tables, ISLOW DCT); -3 with out_len set when
//     `out` is too small.
//
// Codes: -1 bad args, -2 decode error, -3 buffer too small, -4 bad
// channel count, -5 crop outside the image, -8 out of memory.
//
// libjpeg's default error handler calls exit(); a setjmp-based handler
// turns errors into return codes. Warnings (e.g. premature end of data)
// are silenced, as in the JAX package: libjpeg then fills the missing
// rows and the decode succeeds.

#include <csetjmp>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
  std::longjmp(mgr->jump, 1);
}

void emit_message(j_common_ptr, int) {}

void read_rows(jpeg_decompress_struct* cinfo, unsigned char* out,
               size_t row_stride) {
  while (cinfo->output_scanline < cinfo->output_height) {
    JSAMPROW rows[4];
    unsigned int n = 0;
    for (; n < 4 && cinfo->output_scanline + n < cinfo->output_height; ++n) {
      rows[n] = out + (cinfo->output_scanline + n) * row_stride;
    }
    jpeg_read_scanlines(cinfo, rows, n);
  }
}

// Full RGB decode; `*scratch` receives a malloc'd frame when `out` is
// null (the caller frees it).
int decode_rgb(const unsigned char* data, size_t len, unsigned char* out,
               size_t out_capacity, int* height, int* width,
               unsigned char** scratch) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.emit_message = emit_message;
  unsigned char* volatile owned = nullptr;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(owned);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const size_t row_stride =
      static_cast<size_t>(cinfo.output_width) * cinfo.output_components;
  const size_t need = row_stride * static_cast<size_t>(cinfo.output_height);
  *height = static_cast<int>(cinfo.output_height);
  *width = static_cast<int>(cinfo.output_width);
  if (out == nullptr) {
    owned = static_cast<unsigned char*>(std::malloc(need ? need : 1));
    if (owned == nullptr) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -8;
    }
    out = owned;
  } else if (need > out_capacity) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  read_rows(&cinfo, out, row_stride);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (scratch != nullptr) *scratch = owned;
  return 0;
}

// ROI by full decode into scratch, then a copy of the window.
int decode_roi_by_crop(const unsigned char* data, size_t len,
                       unsigned char* out, int crop_y, int crop_x,
                       int crop_h, int crop_w, int* full_height,
                       int* full_width) {
  unsigned char* frame = nullptr;
  int rc = decode_rgb(data, len, nullptr, 0, full_height, full_width, &frame);
  if (rc != 0) return rc;
  if (crop_y + crop_h > *full_height || crop_x + crop_w > *full_width) {
    std::free(frame);
    return -5;
  }
  const size_t src_stride = static_cast<size_t>(*full_width) * 3;
  const size_t dst_stride = static_cast<size_t>(crop_w) * 3;
  for (int r = 0; r < crop_h; ++r) {
    std::memcpy(out + r * dst_stride,
                frame + (crop_y + r) * src_stride + crop_x * 3, dst_stride);
  }
  std::free(frame);
  return 0;
}

}  // namespace

extern "C" {

const char* t2r_jpeg_codec_name() { return "libjpeg"; }

int t2r_decode_jpeg(const unsigned char* data, size_t len, unsigned char* out,
                    size_t out_capacity, int* height, int* width) {
  if (data == nullptr || out == nullptr || len == 0) return -1;
  return decode_rgb(data, len, out, out_capacity, height, width, nullptr);
}

int t2r_decode_jpeg_roi(const unsigned char* data, size_t len,
                        unsigned char* out, size_t out_capacity, int crop_y,
                        int crop_x, int crop_h, int crop_w, int* full_height,
                        int* full_width) {
  if (data == nullptr || out == nullptr || len == 0) return -1;
  if (crop_y < 0 || crop_x < 0 || crop_h <= 0 || crop_w <= 0) return -5;
  if (static_cast<size_t>(crop_w) * 3 * static_cast<size_t>(crop_h) >
      out_capacity) {
    return -3;
  }
#ifndef T2R_HAVE_JPEG_ROI
  return decode_roi_by_crop(data, len, out, crop_y, crop_x, crop_h, crop_w,
                            full_height, full_width);
#else
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.emit_message = emit_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  if (cinfo.progressive_mode) {
    // Progressive decode buffers whole passes anyway: skipping rows buys
    // nothing there.
    jpeg_destroy_decompress(&cinfo);
    return decode_roi_by_crop(data, len, out, crop_y, crop_x, crop_h, crop_w,
                              full_height, full_width);
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *full_height = static_cast<int>(cinfo.output_height);
  *full_width = static_cast<int>(cinfo.output_width);
  if (crop_y + crop_h > *full_height || crop_x + crop_w > *full_width) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -5;
  }
  const size_t out_stride = static_cast<size_t>(crop_w) * 3;

  // Fancy upsampling (libjpeg's default, and what a full decode uses)
  // reads neighbouring chroma samples and replicates edges at the ends
  // of a cropped span, which a full decode does only at the true image
  // edges. So a margin of 2 pixels around the window, widened to the
  // iMCU grid and clamped to the image, is decoded and the exact window
  // is sliced out: at most one extra iMCU row and column of work.
  const int mcu_w = cinfo.max_h_samp_factor * DCTSIZE;
  const int mcu_h = cinfo.max_v_samp_factor * DCTSIZE;
  const int margin = 2;
  const int left = crop_x > margin ? (crop_x - margin) / mcu_w * mcu_w : 0;
  const int right = crop_x + crop_w + margin < *full_width
                        ? crop_x + crop_w + margin
                        : *full_width;
  JDIMENSION xoff = static_cast<JDIMENSION>(left);
  JDIMENSION xw = static_cast<JDIMENSION>(right - left);
  jpeg_crop_scanline(&cinfo, &xoff, &xw);
  if (static_cast<JDIMENSION>(crop_x) < xoff ||
      static_cast<JDIMENSION>(crop_x + crop_w) > xoff + xw) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const size_t lead = (static_cast<size_t>(crop_x) - xoff) * 3;
  const JDIMENSION span_stride = xw * 3;

  // Scratch rows from libjpeg's image pool, freed by
  // jpeg_destroy_decompress on every exit path (longjmp included).
  const JDIMENSION n_scratch = 4;
  JSAMPARRAY scratch = (*cinfo.mem->alloc_sarray)(
      reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE, span_stride,
      n_scratch);

  // Rows above the window: skip whole iMCU rows up to the margin-padded
  // start (entropy decode still walks them; IDCT, upsampling and colour
  // conversion do not), then decode and drop the margin rows so the
  // upsampler enters the window with a full decode's context.
  const JDIMENSION target = static_cast<JDIMENSION>(crop_y);
  const JDIMENSION y_start = static_cast<JDIMENSION>(
      crop_y > margin ? (crop_y - margin) / mcu_h * mcu_h : 0);
  while (cinfo.output_scanline < y_start) {
    if (jpeg_skip_scanlines(&cinfo, y_start - cinfo.output_scanline) == 0) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -2;
    }
  }
  while (cinfo.output_scanline < target) {
    JDIMENSION want = target - cinfo.output_scanline;
    if (want > n_scratch) want = n_scratch;
    if (jpeg_read_scanlines(&cinfo, scratch, want) == 0) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -2;
    }
  }
  const JDIMENSION end = target + static_cast<JDIMENSION>(crop_h);
  while (cinfo.output_scanline < end) {
    JDIMENSION want = end - cinfo.output_scanline;
    if (want > n_scratch) want = n_scratch;
    JDIMENSION got = jpeg_read_scanlines(&cinfo, scratch, want);
    if (got == 0) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return -2;
    }
    for (JDIMENSION r = 0; r < got; ++r) {
      const size_t out_row = cinfo.output_scanline - got + r - target;
      std::memcpy(out + out_row * out_stride, scratch[r] + lead, out_stride);
    }
  }
  // Rows below the window are never decoded: abort instead of finish.
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
#endif  // T2R_HAVE_JPEG_ROI
}

int t2r_encode_jpeg(const unsigned char* pixels, int height, int width,
                    int channels, int quality, unsigned char* out,
                    size_t out_capacity, size_t* out_len) {
  if (pixels == nullptr || out_len == nullptr || height <= 0 || width <= 0) {
    return -1;
  }
  if (channels != 1 && channels != 3) return -4;
  jpeg_compress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.emit_message = emit_message;
  unsigned char* volatile buffer = nullptr;
  unsigned long size = 0;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::free(buffer);
    return -2;
  }
  jpeg_create_compress(&cinfo);
  unsigned char* dest = nullptr;
  jpeg_mem_dest(&cinfo, &dest, &size);
  cinfo.image_width = static_cast<JDIMENSION>(width);
  cinfo.image_height = static_cast<JDIMENSION>(height);
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t row_stride = static_cast<size_t>(width) * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(pixels) +
                   cinfo.next_scanline * row_stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  buffer = dest;
  jpeg_destroy_compress(&cinfo);
  *out_len = size;
  int rc = 0;
  if (out == nullptr || size > out_capacity) {
    rc = -3;
  } else {
    std::memcpy(out, buffer, size);
  }
  std::free(buffer);
  return rc;
}

}  // extern "C"
