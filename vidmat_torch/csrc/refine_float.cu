// Fused guided refine at full resolution emitting float32 planes:
//   A, B   = bilinear (half-pixel, edge-clamped) x pool upsample of the
//            coarse coefficient grids mean_a, mean_b ([alpha, r, g, b])
//   guide  = (0.299 R + 0.587 G + 0.114 B) / 255 of the uint8 frame
//   alpha  = clip(A0 * guide + B0), fgr_c = clip(Ac * guide + Bc)
// No composite, no quantization: alpha (n, h, w, 1) and fgr (n, h, w, 3)
// float32 are written as they are.
//
// Replaces the TPU kernel vidmat/ops/pallas/refine_kernel.py
// fused_refine_float (_refine_float_kernel), the tail of float-output
// serving (the streaming session, raw-foreground output). The TPU kernel
// upsamples with banded matmuls over VMEM-resident coefficient grids and
// writes planar (3, th, wc) tiles; here one thread owns one output pixel,
// reads the four coefficient taps it needs (float4 per tap and grid; the
// caches serve the taps neighbouring threads share) and writes the pixel's
// alpha and its three fgr values (a warp's 96 fgr floats are one
// contiguous run). The upsample, guide and apply are refine_common.cuh's,
// shared with refine_composite.cu.
//
// Bound: bytes. At 1088x1920 from a 272x480 grid: 6.3 MB of frame and
// 4.2 MB of coefficients read, 33.4 MB of float32 written.

#include "refine_common.cuh"

namespace {

__global__ void refine_float_kernel(const uint8_t* __restrict__ frame,
                                    const float4* __restrict__ ma,
                                    const float4* __restrict__ mb,
                                    float* __restrict__ alpha,
                                    float* __restrict__ fgr, int h, int w,
                                    int hl, int wl, float pool) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;
  const float4 v =
      refine::guided_apply(frame, ma, mb, b, y, x, h, w, hl, wl, pool);
  const long long pix = ((long long)b * h + y) * w + x;
  alpha[pix] = v.x;
  float* f = fgr + pix * 3;
  f[0] = v.y;
  f[1] = v.z;
  f[2] = v.w;
}

}  // namespace

// frame: (n, h, w, 3) uint8; mean_a, mean_b: (n, h/pool, w/pool, 4) f32;
// alpha: (n, h, w) f32; fgr: (n, h, w, 3) f32.
extern "C" int vm_refine_float(const void* frame, const void* mean_a,
                               const void* mean_b, void* alpha, void* fgr,
                               int n, int h, int w, int pool, void* stream) {
  if (n <= 0 || pool < 1 || h % pool || w % pool || n > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((w + threads - 1) / threads, h, n);
  refine_float_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frame, (const float4*)mean_a, (const float4*)mean_b,
      (float*)alpha, (float*)fgr, h, w, h / pool, w / pool, (float)pool);
  return (int)cudaGetLastError();
}
