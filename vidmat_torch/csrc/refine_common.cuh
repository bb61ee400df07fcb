// Pieces of the two refine tails (refine_composite.cu, refine_float.cu),
// as the TPU kernels share _tail_prologue
// (vidmat/ops/pallas/refine_kernel.py): the half-pixel, edge-clamped
// source index and lerps of the bilinear x pool upsample of the coarse
// coefficient grids, rows then columns, and the luma guide of the uint8
// frame. Both tails have a warp-strip body at pool 4 (a lane row-lerps one
// coarse column and takes the next from its neighbour: next_lane; its
// frame bytes come as 32-bit words: strip_luma) and a per-pixel body for
// every other pool, width and alignment (the float tail's is
// guided_apply). Each computes the same values in the same order, so the
// bodies agree by test, not by sharing one: chip_smoke.py holds both
// tails to their plain twins, and planar_knockouts.py --parent holds
// their outputs to an earlier tree's. The quantization and the color
// background are shared with composite.cu, so every packed word rounds
// the same way (byte_f, add_sat, mul_sat, quant_bits, pack_rgba).
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
// A constant power-of-two pool compiles the division to the (exact)
// product with its reciprocal.
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

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// round(clip(v) * 255), half to even (__float2int_rn, as jnp.round).
__device__ __forceinline__ uint32_t quant(float v) {
  return (uint32_t)__float2int_rn(clip01(v) * 255.0f);
}

// (0.299 R + 0.587 G + 0.114 B) / 255 of one RGB pixel whose channels are
// exact small integers.
__device__ __forceinline__ float luma3(float r, float g, float b) {
  return (0.299f * r + 0.587f * g + 0.114f * b) * (1.0f / 255.0f);
}

// The same of one uint8 RGB pixel.
__device__ __forceinline__ float luma(const uint8_t* px) {
  return luma3((float)px[0], (float)px[1], (float)px[2]);
}

// Byte i (0-3, a constant) of w as a float, exactly: the byte becomes the
// low mantissa bits of 2^23 (one byte permute), then 2^23 is subtracted.
// Two full-rate instructions in place of a conversion at an eighth of
// the FMA rate; the value is (float)byte either way.
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | i)) -
         8388608.0f;
}

// The luma of pixel q (0-3, a constant) of four consecutive RGB pixels
// whose 12 bytes are bytes 2-13 of the words fw[0..3].
__device__ __forceinline__ float strip_luma(const uint32_t* fw, int q) {
  return luma3(byte_f(fw[(2 + 3 * q) / 4], (2 + 3 * q) % 4),
               byte_f(fw[(3 + 3 * q) / 4], (3 + 3 * q) % 4),
               byte_f(fw[(4 + 3 * q) / 4], (4 + 3 * q) % 4));
}

// Lane + 1's v (lane 31 gets its own).
__device__ __forceinline__ float4 next_lane(float4 v) {
  const unsigned m = 0xFFFFFFFFu;
  return make_float4(__shfl_down_sync(m, v.x, 1), __shfl_down_sync(m, v.y, 1),
                     __shfl_down_sync(m, v.z, 1), __shfl_down_sync(m, v.w, 1));
}

// clip(a + b) and clip(a * b) to [0, 1] in one instruction each: the sum
// or product is rounded, then clamped (NaN to +0), as clip01 of the
// rounded result. Only the sign of a zero may differ from clip01, which
// no quantized byte sees.
__device__ __forceinline__ float add_sat(float a, float b) {
  float d;
  asm("add.rn.sat.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float mul_sat(float a, float b) {
  float d;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// quant() of a value already in [0, 1], in the low byte of the result:
// v * 255 rounded, then + 1.5 * 2^23, whose rounding to the unit in the
// last place of that binade is round-half-to-even to an integer (1.5 *
// 2^23 is even), so the low byte is __float2int_rn(v * 255). Two FP32
// instructions in place of a conversion; --fmad=false keeps the two
// roundings apart.
__device__ __forceinline__ uint32_t quant_bits(float v01) {
  return __float_as_uint(v01 * 255.0f + 12582912.0f);
}

// R | G << 8 | B << 16 | A << 24 from the low bytes of four words.
__device__ __forceinline__ uint32_t pack_rgba(uint32_t r, uint32_t g,
                                              uint32_t b, uint32_t a) {
  return __byte_perm(__byte_perm(r, g, 0x0040u), __byte_perm(b, a, 0x0040u),
                     0x5410u);
}

// clip(A * guide + B) for the four channels [alpha, r, g, b] of pixel
// (y, x) of frame b: the float tail's guided apply.
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
