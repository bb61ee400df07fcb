// Fused guided refine + composite + RGBA pack at full resolution:
//   A, B   = bilinear (half-pixel, edge-clamped) x pool upsample of the
//            coarse coefficient grids mean_a, mean_b ([alpha, r, g, b])
//   guide  = (0.299 R + 0.587 G + 0.114 B) / 255 of the uint8 frame
//   alpha  = clip(A0 * guide + B0), fgr_c = clip(Ac * guide + Bc)
//   rgb_c  = fgr_c * alpha + bg_c * (1 - alpha), bg_c one of
//              color   a constant
//              image   bg[y, x, c] of an (h, w, 3) float image, unclipped
//              coarse  clip(upsample(bg_lr)[y, x, c]): an (hl, wl, 3) grid
//                      per frame, upsampled exactly as the coefficients
//          | fgr_c * alpha                        (no background)
//   word   = R | G << 8 | B << 16 | A << 24, each round(clip(v) * 255)
//            with round-half-to-even (__float2int_rn, as jnp.round)
//
// Replaces the TPU kernel vidmat/ops/pallas/refine_kernel.py
// fused_refine_composite (_refine_kernel), all four background modes. The
// TPU kernel upsamples with banded matmuls over VMEM-resident coefficient
// grids; here one thread owns one output pixel and reads the four
// coefficient taps it needs (float4 per tap and grid; neighbouring threads
// share taps, which the caches serve). The upsample and the guide are
// refine_common.cuh's, shared with refine_float.cu; the coarse background
// takes upsample3, the same source indices and lerp order on 3 channels,
// so the full-resolution background of the portrait-blur path exists only
// in registers.
//
// Bound: bytes. At 1088x1920 from a 272x480 grid: 6.3 MB of frame and
// 4.2 MB of coefficients read, 8.4 MB of packed words written; an image
// adds 25.1 MB read, a coarse background 1.6 MB.
//
// Arithmetic order follows the TPU kernel: the row lerp, then the column
// lerp; built with --fmad=false so each product and sum is rounded.

#include "refine_common.cuh"

namespace {

using refine::Bg;

// The background mode is a template parameter, so the color / none path
// carries none of the other modes' code or registers.
enum Mode { kColor, kImage, kCoarse };

// bg: the color (kColor; bg.use 0: premultiplied). bg_img (kImage): an
// (h, w, 3) float image per frame, bg_img_stride floats apart (0: one
// image shared by every frame). bg_lr (kCoarse): an (n, hl, wl, 3) coarse
// background.
template <int MODE>
__global__ void refine_composite_kernel(
    const uint8_t* __restrict__ frame, const float4* __restrict__ ma,
    const float4* __restrict__ mb, uint32_t* __restrict__ out, int h, int w,
    int hl, int wl, float pool, Bg bg, const float* __restrict__ bg_img,
    long long bg_img_stride, const float* __restrict__ bg_lr) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;
  const float4 v =
      refine::guided_apply(frame, ma, mb, b, y, x, h, w, hl, wl, pool);
  const float alpha = v.x;
  const float fgr[3] = {v.y, v.z, v.w};
  float bgc[3];
  bool use_bg = true;
  if constexpr (MODE == kImage) {
    const float* p = bg_img + b * bg_img_stride + ((long long)y * w + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) bgc[c] = p[c];
  } else if constexpr (MODE == kCoarse) {
    int y0, y1, x0, x1;
    float fy, fx;
    refine::src_index(y, hl, pool, &y0, &y1, &fy);
    refine::src_index(x, wl, pool, &x0, &x1, &fx);
    refine::upsample3(bg_lr + (long long)b * hl * wl * 3, wl, y0, y1, fy, x0,
                      x1, fx, bgc);
#pragma unroll
    for (int c = 0; c < 3; ++c) bgc[c] = refine::clip01(bgc[c]);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) bgc[c] = bg.rgb[c];
    use_bg = bg.use;
  }
  uint32_t word = refine::quant(alpha) << 24;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rgb = use_bg ? fgr[c] * alpha + bgc[c] * (1.0f - alpha)
                             : fgr[c] * alpha;
    word |= refine::quant(rgb) << (8 * c);
  }
  out[((long long)b * h + y) * w + x] = word;
}

}  // namespace

// frame: (n, h, w, 3) uint8; mean_a, mean_b: (n, h/pool, w/pool, 4) f32;
// out: (n, h, w) uint32. At most one background:
//   bg_color   host array [r, g, b]
//   bg_img     device (h, w, 3) f32 image (bg_img_per_frame 0) or
//              (n, h, w, 3) images (bg_img_per_frame 1)
//   bg_coarse  device (n, h/pool, w/pool, 3) f32
// None: premultiplied output.
extern "C" int vm_refine_composite(const void* frame, const void* mean_a,
                                   const void* mean_b, void* out, int n,
                                   int h, int w, int pool, const float* bg,
                                   const void* bg_img, int bg_img_per_frame,
                                   const void* bg_coarse, void* stream) {
  if (n <= 0 || pool < 1 || h % pool || w % pool || n > 65535 || h > 65535 ||
      (bg != nullptr) + (bg_img != nullptr) + (bg_coarse != nullptr) > 1)
    return (int)cudaErrorInvalidValue;
  Bg b;
  b.use = bg != nullptr;
  for (int c = 0; c < 3; ++c) b.rgb[c] = bg ? bg[c] : 0.0f;
  const long long stride = bg_img_per_frame ? (long long)h * w * 3 : 0;
  const int threads = 256;
  const dim3 grid((w + threads - 1) / threads, h, n);
  auto kernel = bg_img      ? refine_composite_kernel<kImage>
                : bg_coarse ? refine_composite_kernel<kCoarse>
                            : refine_composite_kernel<kColor>;
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frame, (const float4*)mean_a, (const float4*)mean_b,
      (uint32_t*)out, h, w, h / pool, w / pool, (float)pool, b,
      (const float*)bg_img, stride, (const float*)bg_coarse);
  return (int)cudaGetLastError();
}
