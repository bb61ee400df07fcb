// Composite + quantize + RGBA pack of full-resolution float mattes:
//   rgb_c = f_c * a + bg_c * (1 - a)   (color, shared image, per-frame image)
//         | f_c * a                    (no background: premultiplied)
//   word  = round(clip(rgb_r) * 255) | G << 8 | B << 16
//           | round(clip(a) * 255) << 24
// The RGB term uses alpha as given (unclipped), as the TPU kernel does;
// rounding is half to even (__float2int_rn, as jnp.round).
//
// Replaces the TPU kernel vidmat/ops/pallas/composite_kernel.py
// composite_rgba_packed (_composite_kernel), all four of its modes. The
// TPU kernel packs with integer shifts on planar (C, th, W) tiles to avoid
// lane padding; here one thread owns one pixel of the NHWC inputs and
// writes its word.
//
// Bound: bytes. At 1088x1920 without a background image: 25.1 MB of fgr
// and 8.4 MB of alpha read, 8.4 MB of words written.
//
// Built with --fmad=false: f * a + bg * (1 - a) is four rounded operations,
// as in the plain version. The quantization and the color background are
// refine_common.cuh's, shared with the fused packed tail.

#include "refine_common.cuh"

namespace {

using refine::Bg;
using refine::quant;

// bg_img: null (color mode) or an (h, w, 3) float32 image per frame,
// bg_frame_stride floats apart (0: one image shared by every frame).
__global__ void composite_kernel(const float* __restrict__ fgr,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ bg_img,
                                 long long bg_frame_stride, Bg bg,
                                 uint32_t* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;
  const long long pix = ((long long)b * h + y) * w + x;
  const float a = alpha[pix];
  const float* f = fgr + pix * 3;
  const float* bgp =
      bg_img ? bg_img + b * bg_frame_stride + ((long long)y * w + x) * 3
             : nullptr;
  uint32_t word = quant(a) << 24;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rgb;
    if (bgp)
      rgb = f[c] * a + bgp[c] * (1.0f - a);
    else
      rgb = bg.use ? f[c] * a + bg.rgb[c] * (1.0f - a) : f[c] * a;
    word |= quant(rgb) << (8 * c);
  }
  out[pix] = word;
}

}  // namespace

// fgr: (n, h, w, 3) f32; alpha: (n, h, w) f32; out: (n, h, w) uint32.
// bg_color: host [r, g, b] or null; bg_img: device (h, w, 3) f32 image
// (bg_per_frame 0) or (n, h, w, 3) images (bg_per_frame 1), or null.
// Both null: premultiplied output.
extern "C" int vm_composite_rgba_packed(const void* fgr, const void* alpha,
                                        const float* bg_color,
                                        const void* bg_img, int bg_per_frame,
                                        void* out, int n, int h, int w,
                                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535 || h > 65535 ||
      (bg_color && bg_img))
    return (int)cudaErrorInvalidValue;
  Bg bg;
  bg.use = bg_color != nullptr;
  for (int c = 0; c < 3; ++c) bg.rgb[c] = bg_color ? bg_color[c] : 0.0f;
  const long long stride = bg_per_frame ? (long long)h * w * 3 : 0;
  const int threads = 256;
  const dim3 grid((w + threads - 1) / threads, h, n);
  composite_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)fgr, (const float*)alpha, (const float*)bg_img, stride,
      bg, (uint32_t*)out, h, w);
  return (int)cudaGetLastError();
}
