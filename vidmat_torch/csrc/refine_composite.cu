// Fused guided refine + composite + RGBA pack at full resolution:
//   A, B   = bilinear (half-pixel, edge-clamped) x pool upsample of the
//            coarse coefficient grids mean_a, mean_b ([alpha, r, g, b])
//   guide  = (0.299 R + 0.587 G + 0.114 B) / 255 of the uint8 frame
//   alpha  = clip(A0 * guide + B0), fgr_c = clip(Ac * guide + Bc)
//   rgb_c  = fgr_c * alpha + bg_c * (1 - alpha)   (color background)
//          | fgr_c * alpha                        (no background)
//   word   = R | G << 8 | B << 16 | A << 24, each round(clip(v) * 255)
//            with round-half-to-even (__float2int_rn, as jnp.round)
//
// Replaces the TPU kernel vidmat/ops/pallas/refine_kernel.py
// fused_refine_composite (_refine_kernel), color / no-background modes.
// The TPU kernel upsamples with banded matmuls over VMEM-resident
// coefficient grids; here one thread owns one output pixel and reads the
// four coefficient taps it needs (float4 per tap and grid; neighbouring
// threads share taps, which the caches serve). The upsample and the guide
// are refine_common.cuh's, shared with refine_float.cu.
//
// Bound: bytes. At 1088x1920 from a 272x480 grid: 6.3 MB of frame and
// 4.2 MB of coefficients read, 8.4 MB of packed words written.
//
// Arithmetic order follows the TPU kernel: the row lerp, then the column
// lerp; built with --fmad=false so each product and sum is rounded.

#include "refine_common.cuh"

namespace {

using refine::Bg;

__global__ void refine_composite_kernel(const uint8_t* __restrict__ frame,
                                        const float4* __restrict__ ma,
                                        const float4* __restrict__ mb,
                                        uint32_t* __restrict__ out, int h,
                                        int w, int hl, int wl, float pool,
                                        Bg bg) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;
  const float4 v =
      refine::guided_apply(frame, ma, mb, b, y, x, h, w, hl, wl, pool);
  const float alpha = v.x;
  const float fgr[3] = {v.y, v.z, v.w};
  uint32_t word = refine::quant(alpha) << 24;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rgb = bg.use ? fgr[c] * alpha + bg.rgb[c] * (1.0f - alpha)
                             : fgr[c] * alpha;
    word |= refine::quant(rgb) << (8 * c);
  }
  out[((long long)b * h + y) * w + x] = word;
}

}  // namespace

// frame: (n, h, w, 3) uint8; mean_a, mean_b: (n, h/pool, w/pool, 4) f32;
// out: (n, h, w) uint32; bg: host array [r, g, b] or null (premultiplied).
extern "C" int vm_refine_composite(const void* frame, const void* mean_a,
                                   const void* mean_b, void* out, int n,
                                   int h, int w, int pool, const float* bg,
                                   void* stream) {
  if (n <= 0 || pool < 1 || h % pool || w % pool || n > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  Bg b;
  b.use = bg != nullptr;
  for (int c = 0; c < 3; ++c) b.rgb[c] = bg ? bg[c] : 0.0f;
  const int threads = 256;
  const dim3 grid((w + threads - 1) / threads, h, n);
  refine_composite_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frame, (const float4*)mean_a, (const float4*)mean_b,
      (uint32_t*)out, h, w, h / pool, w / pool, (float)pool, b);
  return (int)cudaGetLastError();
}
