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
// threads share taps, which the caches serve).
//
// Bound: bytes. At 1088x1920 from a 272x480 grid: 6.3 MB of frame and
// 4.2 MB of coefficients read, 8.4 MB of packed words written.
//
// Arithmetic order follows the TPU kernel: the row lerp, then the column
// lerp; built with --fmad=false so each product and sum is rounded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Bg {
  float rgb[3];
  int use;  // 1: composite over rgb; 0: premultiplied fgr * alpha
};

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

__device__ __forceinline__ float4 upsample(const float4* __restrict__ grid,
                                           int wl, int y0, int y1, float fy,
                                           int x0, int x1, float fx) {
  const float4 r0 = lerp4(grid[y0 * wl + x0], grid[y1 * wl + x0], fy);
  const float4 r1 = lerp4(grid[y0 * wl + x1], grid[y1 * wl + x1], fy);
  return lerp4(r0, r1, fx);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ uint32_t quant(float v) {
  return (uint32_t)__float2int_rn(clip01(v) * 255.0f);
}

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
  int y0, y1, x0, x1;
  float fy, fx;
  src_index(y, hl, pool, &y0, &y1, &fy);
  src_index(x, wl, pool, &x0, &x1, &fx);
  const long long grid_off = (long long)b * hl * wl;
  const float4 A = upsample(ma + grid_off, wl, y0, y1, fy, x0, x1, fx);
  const float4 B = upsample(mb + grid_off, wl, y0, y1, fy, x0, x1, fx);

  const long long pix = ((long long)b * h + y) * w + x;
  const uint8_t* px = frame + pix * 3;
  const float guide = (0.299f * (float)px[0] + 0.587f * (float)px[1] +
                       0.114f * (float)px[2]) * (1.0f / 255.0f);

  const float alpha = clip01(A.x * guide + B.x);
  const float fgr[3] = {clip01(A.y * guide + B.y),
                        clip01(A.z * guide + B.z),
                        clip01(A.w * guide + B.w)};
  uint32_t word = quant(alpha) << 24;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rgb = bg.use ? fgr[c] * alpha + bg.rgb[c] * (1.0f - alpha)
                             : fgr[c] * alpha;
    word |= quant(rgb) << (8 * c);
  }
  out[pix] = word;
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
