// Shared prologue of the two refine tails (refine_composite.cu,
// refine_float.cu), as the TPU kernels share _tail_prologue
// (vidmat/ops/pallas/refine_kernel.py): the half-pixel, edge-clamped
// bilinear x pool upsample of the coarse coefficient grids, rows then
// columns, and the luma guide of the uint8 frame. Both tails must agree on
// these; one implementation keeps them from diverging. The quantization
// and the color background are shared with composite.cu too, so every
// packed word rounds the same way.
//
// Built with --fmad=false so each product and sum is rounded on its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace refine {

// The background of a packed word's RGB term, passed by value to a kernel.
struct Bg {
  float rgb[3];
  int use;  // 1: composite over rgb; 0: premultiplied fgr * alpha
};

// Source row (or column) of output index j for a x pool upsample of n
// coarse samples: lower and upper tap and the weight of the upper one.
__device__ __forceinline__ void src_index(int j, int n, float pool, int* lo,
                                          int* hi, float* frac) {
  float s = ((float)j + 0.5f) / pool - 0.5f;
  s = fminf(fmaxf(s, 0.0f), (float)(n - 1));
  const float l = floorf(s);
  *frac = s - l;
  *lo = (int)l;
  *hi = min(*lo + 1, n - 1);
}

__device__ __forceinline__ float4 lerp4(float4 p, float4 q, float f) {
  const float g = 1.0f - f;
  return make_float4(g * p.x + f * q.x, g * p.y + f * q.y,
                     g * p.z + f * q.z, g * p.w + f * q.w);
}

// The coefficient grid (hl x wl of float4 [alpha, r, g, b]) at one output
// pixel: the row lerp of both columns' taps, then the column lerp.
__device__ __forceinline__ float4 upsample(const float4* __restrict__ grid,
                                           int wl, int y0, int y1, float fy,
                                           int x0, int x1, float fx) {
  const float4 r0 = lerp4(grid[y0 * wl + x0], grid[y1 * wl + x0], fy);
  const float4 r1 = lerp4(grid[y0 * wl + x1], grid[y1 * wl + x1], fy);
  return lerp4(r0, r1, fx);
}

__device__ __forceinline__ float lerp1(float p, float q, float f) {
  return (1.0f - f) * p + f * q;
}

// A 3-channel coarse grid (hl x wl x 3 floats, not float4-aligned) at one
// output pixel, in upsample()'s order: the row lerp of both columns' taps,
// then the column lerp. The coarse background of the portrait-blur tail.
__device__ __forceinline__ void upsample3(const float* __restrict__ grid,
                                          int wl, int y0, int y1, float fy,
                                          int x0, int x1, float fx,
                                          float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float r0 = lerp1(grid[(y0 * wl + x0) * 3 + c],
                           grid[(y1 * wl + x0) * 3 + c], fy);
    const float r1 = lerp1(grid[(y0 * wl + x1) * 3 + c],
                           grid[(y1 * wl + x1) * 3 + c], fy);
    out[c] = lerp1(r0, r1, fx);
  }
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// round(clip(v) * 255), half to even (__float2int_rn, as jnp.round).
__device__ __forceinline__ uint32_t quant(float v) {
  return (uint32_t)__float2int_rn(clip01(v) * 255.0f);
}

// (0.299 R + 0.587 G + 0.114 B) / 255 of one uint8 RGB pixel.
__device__ __forceinline__ float luma(const uint8_t* px) {
  return (0.299f * (float)px[0] + 0.587f * (float)px[1] +
          0.114f * (float)px[2]) * (1.0f / 255.0f);
}

// clip(A * guide + B) for the four channels [alpha, r, g, b] of pixel
// (y, x) of frame b: the guided apply both tails start from.
__device__ __forceinline__ float4 guided_apply(
    const uint8_t* __restrict__ frame, const float4* __restrict__ ma,
    const float4* __restrict__ mb, int b, int y, int x, int h, int w, int hl,
    int wl, float pool) {
  int y0, y1, x0, x1;
  float fy, fx;
  src_index(y, hl, pool, &y0, &y1, &fy);
  src_index(x, wl, pool, &x0, &x1, &fx);
  const long long grid_off = (long long)b * hl * wl;
  const float4 A = upsample(ma + grid_off, wl, y0, y1, fy, x0, x1, fx);
  const float4 B = upsample(mb + grid_off, wl, y0, y1, fy, x0, x1, fx);
  const float g = luma(frame + (((long long)b * h + y) * w + x) * 3);
  return make_float4(clip01(A.x * g + B.x), clip01(A.y * g + B.y),
                     clip01(A.z * g + B.z), clip01(A.w * g + B.w));
}

}  // namespace refine
