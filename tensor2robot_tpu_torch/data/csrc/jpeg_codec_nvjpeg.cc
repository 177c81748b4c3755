// JPEG codec of the port's data stack on a host without libjpeg: nvJPEG
// from the CUDA toolkit, under the same C ABI as jpeg_codec.cc (see
// there for the functions and return codes). data/codec.py picks this
// source when <jpeglib.h> is missing and <nvjpeg.h> is present, builds it
// with g++ (host code only: nvJPEG launches its own kernels) and binds it
// with ctypes.
//
// Decode: nvjpegDecode (the hybrid backend: Huffman decode on the host,
// IDCT, upsampling and colour conversion on the card) into a device
// buffer as interleaved RGB, then one copy of the frame, or of just the
// crop window (gathered into a contiguous device buffer first), into the
// caller's host buffer. A window is therefore a
// full decode followed by the crop, bit for bit. The pixels are nvJPEG's,
// not libjpeg's: its IDCT and chroma upsampling differ, so a frame
// decoded here is not byte-equal to the same frame decoded by
// jpeg_codec.cc; within one codec every path (fast parser, oracle, ROI)
// gives the same bytes.
// Encode: nvjpegEncodeImage (RGB) or nvjpegEncodeYUV (grey) at the given
// quality with 4:2:0 chroma and standard Huffman tables.
//
// Each call takes a context (an nvJPEG handle, decoder and encoder
// state, a stream, device buffers) from a pool, so concurrent calls from
// parse threads share nothing and the pool holds one context per
// concurrent caller. Calls synchronise their own stream before returning. Codes as
// jpeg_codec.cc, plus -9 for a CUDA or nvJPEG failure outside decoding.

#include <cstddef>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t decoder = nullptr;
  nvjpegEncoderState_t encoder = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* device = nullptr;
  size_t device_bytes = 0;
  unsigned char* window = nullptr;  // a crop, made contiguous on the card
  size_t window_bytes = 0;
};

std::mutex pool_mutex;
std::vector<Context*> pool;

Context* acquire() {
  {
    std::lock_guard<std::mutex> lock(pool_mutex);
    if (!pool.empty()) {
      Context* ctx = pool.back();
      pool.pop_back();
      return ctx;
    }
  }
  // A handle per context: calls through one shared handle serialise.
  Context* ctx = new Context();
  if (nvjpegCreateSimple(&ctx->handle) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&ctx->stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      nvjpegJpegStateCreate(ctx->handle, &ctx->decoder) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderStateCreate(ctx->handle, &ctx->encoder, ctx->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsCreate(ctx->handle, &ctx->params, ctx->stream) !=
          NVJPEG_STATUS_SUCCESS) {
    // Partially built contexts are leaked rather than torn down: this
    // only happens when the card is unusable, and the caller raises.
    return nullptr;
  }
  return ctx;
}

void release(Context* ctx) {
  std::lock_guard<std::mutex> lock(pool_mutex);
  pool.push_back(ctx);
}

bool reserve(unsigned char** buffer, size_t* capacity, size_t bytes) {
  if (*capacity >= bytes) return true;
  if (*buffer != nullptr) cudaFree(*buffer);
  *buffer = nullptr;
  *capacity = 0;
  if (cudaMalloc(buffer, bytes) != cudaSuccess) return false;
  *capacity = bytes;
  return true;
}

// Decodes the whole frame into ctx->device as interleaved RGB.
int decode_to_device(Context* ctx, const unsigned char* data, size_t len,
                     int* height, int* width) {
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(ctx->handle, data, len, &components, &subsampling,
                         widths, heights) != NVJPEG_STATUS_SUCCESS) {
    return -2;
  }
  if (widths[0] <= 0 || heights[0] <= 0) return -2;
  const size_t frame = static_cast<size_t>(widths[0]) * heights[0] * 3;
  if (!reserve(&ctx->device, &ctx->device_bytes, frame)) return -8;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = ctx->device;
  image.pitch[0] = static_cast<unsigned int>(widths[0]) * 3;
  if (nvjpegDecode(ctx->handle, ctx->decoder, data, len, NVJPEG_OUTPUT_RGBI, &image,
                   ctx->stream) != NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(ctx->stream);
    return -2;
  }
  *height = heights[0];
  *width = widths[0];
  return 0;
}

// Copies a (rows x cols) RGB window at (y, x) of the device frame to
// host: a crop is first gathered into a contiguous device buffer, so the
// host copy is one contiguous transfer rather than a row per transfer.
int copy_window(Context* ctx, int frame_width, int y, int x, int rows,
                int cols, unsigned char* out) {
  const size_t src_pitch = static_cast<size_t>(frame_width) * 3;
  const size_t dst_pitch = static_cast<size_t>(cols) * 3;
  const size_t bytes = dst_pitch * rows;
  const unsigned char* src = ctx->device + y * src_pitch + static_cast<size_t>(x) * 3;
  if (cols != frame_width) {
    if (!reserve(&ctx->window, &ctx->window_bytes, bytes)) return -8;
    if (cudaMemcpy2DAsync(ctx->window, dst_pitch, src, src_pitch, dst_pitch,
                          rows, cudaMemcpyDeviceToDevice,
                          ctx->stream) != cudaSuccess) {
      return -9;
    }
    src = ctx->window;
  }
  if (cudaMemcpyAsync(out, src, bytes, cudaMemcpyDeviceToHost, ctx->stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(ctx->stream) != cudaSuccess) {
    return -9;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* t2r_jpeg_codec_name() { return "nvjpeg"; }

int t2r_decode_jpeg(const unsigned char* data, size_t len, unsigned char* out,
                    size_t out_capacity, int* height, int* width) {
  if (data == nullptr || out == nullptr || len == 0) return -1;
  Context* ctx = acquire();
  if (ctx == nullptr) return -9;
  int h = 0, w = 0;
  int rc = decode_to_device(ctx, data, len, &h, &w);
  if (rc == 0) {
    *height = h;
    *width = w;
    rc = static_cast<size_t>(h) * w * 3 > out_capacity
             ? -3
             : copy_window(ctx, w, 0, 0, h, w, out);
  }
  release(ctx);
  return rc;
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
  Context* ctx = acquire();
  if (ctx == nullptr) return -9;
  int h = 0, w = 0;
  int rc = decode_to_device(ctx, data, len, &h, &w);
  if (rc == 0) {
    *full_height = h;
    *full_width = w;
    if (crop_y + crop_h > h || crop_x + crop_w > w) {
      rc = -5;
    } else {
      rc = copy_window(ctx, w, crop_y, crop_x, crop_h, crop_w, out);
    }
  }
  release(ctx);
  return rc;
}

int t2r_encode_jpeg(const unsigned char* pixels, int height, int width,
                    int channels, int quality, unsigned char* out,
                    size_t out_capacity, size_t* out_len) {
  if (pixels == nullptr || out_len == nullptr || height <= 0 || width <= 0) {
    return -1;
  }
  if (channels != 1 && channels != 3) return -4;
  Context* ctx = acquire();
  if (ctx == nullptr) return -9;
  const size_t frame = static_cast<size_t>(height) * width * channels;
  int rc = 0;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.pitch[0] = static_cast<unsigned int>(width) * channels;
  nvjpegStatus_t status = NVJPEG_STATUS_SUCCESS;
  size_t length = 0;
  if (!reserve(&ctx->device, &ctx->device_bytes, frame)) {
    rc = -8;
  } else if (cudaMemcpyAsync(ctx->device, pixels, frame,
                             cudaMemcpyHostToDevice, ctx->stream) !=
             cudaSuccess) {
    rc = -9;
  } else {
    image.channel[0] = ctx->device;  // after reserve() may have moved it
    status = nvjpegEncoderParamsSetQuality(ctx->params, quality, ctx->stream);
    if (status == NVJPEG_STATUS_SUCCESS) {
      status = nvjpegEncoderParamsSetOptimizedHuffman(ctx->params, 0,
                                                      ctx->stream);
    }
    if (status == NVJPEG_STATUS_SUCCESS) {
      status = nvjpegEncoderParamsSetSamplingFactors(
          ctx->params, channels == 3 ? NVJPEG_CSS_420 : NVJPEG_CSS_GRAY,
          ctx->stream);
    }
    if (status == NVJPEG_STATUS_SUCCESS) {
      status = channels == 3
                   ? nvjpegEncodeImage(ctx->handle, ctx->encoder, ctx->params,
                                       &image, NVJPEG_INPUT_RGBI, width,
                                       height, ctx->stream)
                   : nvjpegEncodeYUV(ctx->handle, ctx->encoder, ctx->params, &image,
                                     NVJPEG_CSS_GRAY, width, height,
                                     ctx->stream);
    }
    if (status == NVJPEG_STATUS_SUCCESS) {
      status = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->encoder, nullptr,
                                             &length, ctx->stream);
      if (cudaStreamSynchronize(ctx->stream) != cudaSuccess) {
        status = NVJPEG_STATUS_EXECUTION_FAILED;
      }
    }
    if (status != NVJPEG_STATUS_SUCCESS) {
      rc = -2;
    } else {
      *out_len = length;
      if (out == nullptr || length > out_capacity) {
        rc = -3;
      } else if (nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->encoder, out,
                                               &length, ctx->stream) !=
                 NVJPEG_STATUS_SUCCESS) {
        rc = -2;
      }
    }
  }
  if (cudaStreamSynchronize(ctx->stream) != cudaSuccess && rc == 0) rc = -9;
  release(ctx);
  return rc;
}

}  // extern "C"
